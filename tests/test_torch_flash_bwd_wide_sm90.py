"""The bf16 wide flash backward for Hopper (csrc/flash_bwd_wide_sm90.cu), on
the CPU.

The kernels cannot run here; what is held here is what surrounds them:
  * the rule (`attention_vjp.bwd_form`): every bf16 training site of phi 'l'
    and 'x' (the neck heads of 768 to 3,584 and dark3's 256 / 2,048 and
    512 / 4,096), at 640x640 and 480x576, and phi='l''s tensor-parallel
    local shapes at tp 4 and tp 8 (2 heads and 1 head of 768 and 1,536)
    take the wide kernels ("wide_sm90"); no training site of any scale is
    left on a first-generation kernel;
  * the launch plans (`attention_vjp.bwd_wide_sm90_plan`) at every such site
    at batch 2: the two kernels' shared memory recomputed here from their
    rings within the card's 227 KB, the most stages that fit, the blocks
    covering N and every gradient column, every wgmma N a multiple of 8 and
    at most 256, the workspace stated in bytes (N padded to 128, squared,
    bf16, one matrix for dq and two for dk/dv) within
    WIDE_BWD_WORKSPACE_LIMIT a group, the groups covering every (batch,
    head) pair once and balanced; the plan refuses what the domain refuses;
  * the wrappers: off the CPU they launch or raise, never fall back, and
    `reset_launch_counts` clears their `wide_launches`;
  * the plain versions (what the wrappers run on CPU tensors) against JAX's
    `flash_bwd` in the Pallas interpreter at the new form's widths in small
    (2 heads of 448, one head of 256 / 2,048, N = 130), fp32 inputs, within
    GRAD_REL of each gradient's max|ref|;
  * the kernels' tiling, emulated in plain PyTorch: the score kernel on
    128 x 128 blocks (S over the q/k slabs, dP over the v slabs, fp32),
    P and dS rounded to bf16 and written to the workspace in wgmma's
    fragment order (64 x 64 tiles, [k16 step][thread][4 registers]), the
    GEMM kernel reading each tile's fragments back over 64-token tiles in
    order into 128 x 256 output blocks, against the Pallas backward in the
    interpreter at N = 1,100 (ragged against 64 and 128): 2 heads of 448
    and one head of 256 / 2,048 (fp32 and bf16), within MAX_REL; the
    design's faults (a token tile read twice and its neighbour never, the
    last 256-column block unwritten, a workspace row tile taken from
    another head or another query tile) miss that bar.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import transparent_object_detection_tpu.ops.attention as jattn
import transparent_object_detection_tpu.ops.attention_vjp as jvjp
from test_torch_flash_bwd_sm90 import _training_calls
from test_torch_flash_sm90 import INPUTS, PHIS, sites
from transparent_object_detection_tpu_torch.ops import attention as tattn
from transparent_object_detection_tpu_torch.ops import attention_vjp as tvjp

torch.set_num_threads(1)

GRAD_REL = 1e-3  # plain against Pallas in fp32: summation order and exp vs exp2 only
# the tiling against Pallas, relative to max|ref|: fp32 2e-4 (the port's fp32
# bar), bf16 1e-2 (P and dS rounded to bf16 against other fp32 sums, the
# gradients stored in bf16), as tests/test_torch_flash_bwd_sm90.py
MAX_REL = {"float32": 2e-4, "bfloat16": 1e-2}
WGMMA_N_MAX = 256
N_RAGGED = 1100
PALLAS_BLOCKS = (220, 100)  # (block_q, block_k): both divide 1,100
BATCH = 2
TPS = (4, 8)


def _bf16_form(dqk, dv, heads):
    return tvjp.bwd_form(dqk, dv, heads, torch.bfloat16)


def _tp_local_calls(tp):
    """phi='l''s training calls on one tensor-parallel rank at 640x640: each
    neck head count divided by tp where tp divides it (every neck site of
    phi='l' has 8 heads), dark3 as on one device."""
    out = []
    for name, (n, cq, cv, heads, _) in sites("l").items():
        if tattn.train_route(n, cq, heads, cv) == "naive":
            continue
        if name != "dark3":
            assert heads % tp == 0, (name, heads, tp)
            cq, cv, heads = cq // tp, cv // tp, heads // tp
        out.append((name, n, cq // heads, cv // heads, heads))
    return out


def _wide_sites():
    """(tag, N, q/k width, v width, heads) of every call the wide kernels
    take: phi 'l' and 'x' at both inputs, phi='l''s TP-local shapes."""
    out = [((phi, hw, name), n, dq, dv, heads) for phi in ("l", "x") for hw in INPUTS
           for name, _, n, dq, dv, heads in _training_calls(phi, hw)]
    out += [((f"tp={tp}", name), n, dq, dv, heads) for tp in TPS
            for name, n, dq, dv, heads in _tp_local_calls(tp)]
    return out


@pytest.mark.parametrize("phi", ("l", "x"))
def test_wide_form_at_every_training_site(phi):
    """Every bf16 training call of phi 'l' and 'x' (packed neck heads and
    dark3, 640x640 and 480x576) takes the wide kernels; fp32 the fp32 ones."""
    widths = {"l": (768, 1536, 256, 2048), "x": (1536, 3584, 512, 4096)}[phi]
    for hw in INPUTS:
        calls = _training_calls(phi, hw)
        assert {route for _, route, *_ in calls} == {"packed", "single"}, (phi, hw)
        for name, route, n, dq, dv, heads in calls:
            tag = (hw, name, route, dq, dv, heads)
            assert _bf16_form(dq, dv, heads) == "wide_sm90", tag
            assert tvjp.bwd_form(dq, dv, heads, torch.float32) == "f32_sm90", tag
            assert dq in widths and dv in widths, tag
            assert tvjp.kernel_supports(n, dq, dv, heads, torch.bfloat16), tag


@pytest.mark.parametrize("tp", TPS)
def test_wide_form_at_the_tp_local_shapes(tp):
    """phi='l''s local shapes of a tensor-parallel step: at tp 4 two heads
    of 1,536 (h1) and of 768 (h2, h4), at tp 8 one head each (the one-head
    kernels have no plan for them), dark3 at full width: all wide."""
    calls = {name: (dq, dv, heads) for name, _, dq, dv, heads in _tp_local_calls(tp)}
    assert calls == {"dark3": (256, 2048, 1), "h1": (1536, 1536, 8 // tp),
                     "h2": (768, 768, 8 // tp), "h4": (768, 768, 8 // tp)}
    for name, (dq, dv, heads) in calls.items():
        assert _bf16_form(dq, dv, heads) == "wide_sm90", (tp, name)
        if heads == 1:
            with pytest.raises(ValueError):
                tvjp.bwd_single_sm90_plan(dq, dv)


@pytest.mark.parametrize("phi", PHIS)
def test_no_training_site_left_on_a_template(phi):
    """Every bf16 training call of every scale takes a Hopper form: packed
    heads up to 384 "sm90", one head of phi 'n' to 'm' "single_sm90", the
    rest "wide_sm90"; the mma.sync template's source is gone."""
    for hw in INPUTS:
        for name, route, n, dq, dv, heads in _training_calls(phi, hw):
            form = _bf16_form(dq, dv, heads)
            want = ("wide_sm90" if phi in ("l", "x") else
                    "sm90" if route == "packed" else "single_sm90")
            assert form == want, (hw, name, route, dq, dv, heads, form)
    csrc = tvjp.A.__file__.rsplit("/ops/", 1)[0] + "/csrc/"
    with pytest.raises(FileNotFoundError):
        open(csrc + "flash_attn_bwd.cu").close()


def _smem(stages, stage_bytes):
    return 1024 + 1024 + stages * stage_bytes


@pytest.mark.parametrize("which", ("l", "x", "tp"))
def test_wide_plans_fit_and_state_their_workspace(which):
    """The dq and dk/dv plans at every wide site of `which` at batch 2:
    shared memory of each kernel recomputed from its ring (score stage: a
    128 x 64 bf16 slab of the rows' operand and one of the tokens', 32 KB;
    GEMM stage: two 8 KB fragment tiles and four 64 x 64 boxes, 48 KB), the
    most stages up to 8 that fit; 128-row score blocks and 64-token tiles
    covering N; 256-column GEMM blocks covering each gradient; the
    workspace a group = group x matrices x (N padded to 128)^2 x 2 bytes,
    within WIDE_BWD_WORKSPACE_LIMIT (one pair at least), the groups
    covering the pairs once and differing by at most one pair."""
    found = [s for s in _wide_sites() if (s[0][0] == which if which != "tp"
                                          else s[0][0].startswith("tp="))]
    assert found, which
    limit = tattn.SM90_SMEM_LIMIT
    for tag, n, dq, dv, heads in found:
        pairs = BATCH * heads
        plans = tvjp.bwd_wide_sm90_plan(dq, dv, n, pairs)
        for kernel, mats in (("dq", 1), ("dkv", 2)):
            plan = plans[kernel]
            t = (tag, kernel)
            assert set(tvjp.WIDE_BWD_PLAN_KEYS) <= set(plan), t
            assert (plan["tile"], plan["tok"], plan["slab"], plan["gcols"]) == (128, 64, 64, 256)
            score, gemm = 2 * 128 * 128, 2 * 64 * 128 + 4 * 64 * 128
            assert plan["smem_bytes"] == _smem(plan["stages"], score) <= limit, t
            assert plan["grad_smem_bytes"] == _smem(plan["grad_stages"], gemm) <= limit, t
            for st, unit in ((plan["stages"], score), (plan["grad_stages"], gemm)):
                assert 2 <= st <= tvjp.WIDE_BWD_MAX_STAGES, t
                assert st == tvjp.WIDE_BWD_MAX_STAGES or _smem(st + 1, unit) > limit, t
            n_pad = plan["tiles"] * 64
            assert n_pad % 128 == 0 and n_pad >= n > n_pad - 128, t
            for width in ((dq,) if kernel == "dq" else (dq, dv)):
                blocks = -(-width // plan["gcols"])
                assert blocks * plan["gcols"] >= width > (blocks - 1) * plan["gcols"], t
            assert plan["workspace_bytes"] == plan["group"] * mats * n_pad * n_pad * 2, t
            assert (plan["workspace_bytes"] <= tvjp.WIDE_BWD_WORKSPACE_LIMIT
                    or plan["group"] == 1), t
            group, groups = plan["group"], plan["groups"]
            assert (groups - 1) * group < pairs <= groups * group, t
            assert pairs - (groups - 1) * group >= group - groups, t  # balanced
            assert 128 % 8 == 0 and 256 % 8 == 0 and 256 <= WGMMA_N_MAX  # m64n128, m64n256


def test_wide_plan_workspace_at_phi_l_h2():
    """phi='l' h2 at batch 2 (8 heads of 768, N = 6,400): dq's workspace is
    1.31 GB of dS for all 16 pairs in one group; dk/dv's P^T and dS^T take
    two groups of 8 pairs, 1.31 GB each."""
    plans = tvjp.bwd_wide_sm90_plan(768, 768, 6400, 16)
    assert (plans["dq"]["group"], plans["dq"]["groups"]) == (16, 1)
    assert (plans["dkv"]["group"], plans["dkv"]["groups"]) == (8, 2)
    for kernel in ("dq", "dkv"):
        assert plans[kernel]["workspace_bytes"] == 16 * 6400 * 6400 * 2 == 1_310_720_000


def test_wide_plan_refuses_what_the_domain_refuses():
    """Widths that are not positive multiples of 8, no tokens or no pairs:
    the plan raises, as `kernel_supports` refuses them."""
    for dq, dv in ((0, 64), (60, 64), (64, 60), (-8, 8), (448, 4)):
        assert not tvjp.kernel_supports(1100, dq, dv, 2, torch.bfloat16), (dq, dv)
        with pytest.raises(ValueError, match="multiples of 8"):
            tvjp.bwd_wide_sm90_plan(dq, dv, 1100, 2)
    for n, pairs in ((0, 2), (1100, 0)):
        with pytest.raises(ValueError):
            tvjp.bwd_wide_sm90_plan(448, 448, n, pairs)


def test_wide_wrappers_never_fall_back_off_cpu():
    """flash_bwd_dq and flash_bwd_dkv on the wide route (2 packed heads of
    448, one head of 256 / 2,048) on tensors that are neither on the CPU
    nor on a card raise before any library is built; they count nothing,
    and reset_launch_counts clears `wide_launches`."""
    for fn in (tvjp.flash_bwd_dq, tvjp.flash_bwd_dkv):
        fn.wide_launches = 5
    tvjp.reset_launch_counts()
    for fn in (tvjp.flash_bwd_dq, tvjp.flash_bwd_dkv):
        assert fn.wide_launches == 0
    meta = lambda *s: torch.empty(s, dtype=torch.bfloat16, device="meta")
    for dqk, dv, heads in ((448, 448, 2), (256, 2048, 1)):
        assert _bf16_form(dqk, dv, heads) == "wide_sm90"
        n = 1600
        q, k, v, do = (meta(1, n, heads * w) for w in (dqk, dqk, dv, dv))
        stat = (1, n, 1) if heads == 1 else (1, heads, n, 1)
        lse = dcap = torch.empty(stat, dtype=torch.float32, device="meta")
        for fn in (tvjp.flash_bwd_dq, tvjp.flash_bwd_dkv):
            with pytest.raises(ValueError, match="CUDA tensor"):
                fn(q, k, v, do, lse, dcap, 0.1, heads)
    for fn in (tvjp.flash_bwd_dq, tvjp.flash_bwd_dkv):
        assert fn.wide_launches == 0 and fn.sm90_launches == 0


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _inputs(n, dqk, dv, heads, seed):
    rng = np.random.default_rng(seed)
    scale = dqk ** -0.5 if heads > 1 else 1.0
    qk_std = 0.6 if heads > 1 else 0.25
    q, k = (rng.standard_normal((1, n, heads * dqk)).astype(np.float32) * qk_std
            for _ in range(2))
    v, g = (rng.standard_normal((1, n, heads * dv)).astype(np.float32) for _ in range(2))
    return q, k, v, g, scale


def _pallas(arrs, scale, heads, blocks, dtype="float32"):
    """JAX's flash_fwd_lse, compute_dcap and flash_bwd in the Pallas
    interpreter -> (lse, D, {"dq", "dk", "dv"}) as numpy fp32."""
    jdt = getattr(jnp, dtype)
    jq, jk, jv, jg = (jnp.asarray(a).astype(jdt) for a in arrs)
    jvjp.INTERPRET = True
    jattn._diff_flash.cache_clear()
    try:
        out, lse = jvjp.flash_fwd_lse(jq, jk, jv, scale, *blocks, heads)
        dcap = jvjp.compute_dcap(out, jg, heads)
        ref = jvjp.flash_bwd(jq, jk, jv, jg, lse, dcap, scale, *blocks, heads)
    finally:
        jvjp.INTERPRET = False
        jattn._diff_flash.cache_clear()
    ref = dict(zip(("dq", "dk", "dv"), (np.asarray(r, np.float32) for r in ref)))
    return np.asarray(lse, np.float32), np.asarray(dcap, np.float32), ref


@pytest.mark.parametrize("dqk,dv,heads", [(448, 448, 2), (256, 2048, 1)])
def test_plain_matches_jax_flash_bwd_at_wide_widths(dqk, dv, heads):
    """dq, dk and dv of the plain versions (the wrappers' CPU path) against
    JAX's flash_bwd in the Pallas interpreter, both given JAX's lse and D,
    at N = 130 in fp32: within GRAD_REL (1e-3) of each gradient's
    max|ref|."""
    n = 130
    q, k, v, g, scale = _inputs(n, dqk, dv, heads, seed=5)
    lse, dcap, ref = _pallas((q, k, v, g), scale, heads, (n, n))
    args = [torch.from_numpy(np.array(a)) for a in (q, k, v, g, lse, dcap)]
    dq = tvjp.flash_bwd_dq(*args, scale, heads)
    dk, dvv = tvjp.flash_bwd_dkv(*args, scale, heads)
    for name, got in (("dq", dq), ("dk", dk), ("dv", dvv)):
        assert got.shape == ref[name].shape, name
        assert _rel(got.numpy(), ref[name]) <= GRAD_REL, (name, _rel(got.numpy(), ref[name]))


# ---------------------------------------------------------------- tiling
def _fragment_map():
    """(4, 128, 8) -> (row, column) in a 64 x 64 tile: k16 step kk, thread
    t, element e of its four 32-bit registers (two bf16 each) of wgmma's A
    fragment (m64k16): rows r0 = 16 (t // 32) + (t % 32) // 4 and r0 + 8,
    columns 16 kk + 2 (t % 4) + {0, 1} and + 8; registers (r0, c), (r0 + 8,
    c), (r0, c + 8), (r0 + 8, c + 8)."""
    kk, t, e = np.meshgrid(np.arange(4), np.arange(128), np.arange(8), indexing="ij")
    lane = t % 32
    row = 16 * (t // 32) + lane // 4 + 8 * ((e // 2) % 2)
    col = 16 * kk + 2 * (lane % 4) + e % 2 + 8 * (e // 4)
    return torch.from_numpy(row), torch.from_numpy(col)


FRAG_ROW, FRAG_COL = _fragment_map()


def _to_workspace(x, tiles):
    """(B, H, Np, Np) bf16 -> the workspace's fragment tiles (B, H, R, T, 4,
    128, 8): tile (R, T) holds rows 64R.. and tokens 64T.. in fragment order."""
    b, h = x.shape[:2]
    t = x.reshape(b, h, tiles, 64, tiles, 64).permute(0, 1, 2, 4, 3, 5)
    return t[..., FRAG_ROW, FRAG_COL]


def _from_tile(frags):
    """A fragment tile (..., 4, 128, 8) -> the 64 x 64 tile it holds (the
    GEMM kernel's consumers read their A operand so)."""
    out = frags.new_zeros(*frags.shape[:-3], 64, 64)
    out[..., FRAG_ROW, FRAG_COL] = frags
    return out


def _wide_tiled(q, k, v, do, lse, dcap, scale, fault=None):
    """dq, dk, dv as csrc/flash_bwd_wide_sm90.cu forms them, (B, H, N, d)
    operands, lse and D (B, H, N, 1): N padded to 128 (zeros); the score
    kernel on 128 x 128 blocks, S over q/k's 64-column slabs and dP over
    v's (fp32), P = exp2(S scale log2 e - lse log2 e) set to 0 past N, dS =
    P (dP - D) scale; rows are queries for dq (dS) and keys for dk/dv (P^T,
    dS^T), written to the workspace in bf16 fragment order; the GEMM kernel
    on 128-row x 256-column blocks over 64-token tiles in order, reading
    each tile's fragments back. `fault`: "token_tile_twice" (the GEMM reads
    token tile 1's fragments and operand rows again in place of tile 2's),
    "last_column_block_unwritten", "ws_row_tile_from_other" (row tile 1's
    fragments taken from the next head's, or, with one head, from row tile
    2's)."""
    b, h, n, dqk = q.shape
    dvw = v.shape[-1]
    n_pad = -(-n // 128) * 128
    tiles = n_pad // 64
    pad = lambda t: torch.nn.functional.pad(t.float(), (0, 0, 0, n_pad - n))
    qf, kf, vf, dof = (pad(t) for t in (q, k, v, do))
    lsef, df = pad(lse), pad(dcap)
    valid = torch.arange(n_pad) < n
    mask = valid[:, None] & valid[None, :]

    def scores(rows_first, rows_second, toks_first, toks_second, stat_rows):
        s = torch.zeros(b, h, n_pad, n_pad)
        dp = torch.zeros(b, h, n_pad, n_pad)
        for c in range(0, rows_first.shape[-1], 64):  # the first contraction's slabs
            s += rows_first[..., c:c + 64] @ toks_first[..., c:c + 64].transpose(-1, -2)
        for c in range(0, rows_second.shape[-1], 64):
            dp += rows_second[..., c:c + 64] @ toks_second[..., c:c + 64].transpose(-1, -2)
        lse_b = lsef if stat_rows else lsef.transpose(-1, -2)
        d_b = df if stat_rows else df.transpose(-1, -2)
        p = torch.where(mask, torch.exp2(s * (scale * tattn.LOG2E) - lse_b * tattn.LOG2E), 0.0)
        return p, p * (dp - d_b) * scale

    def gemm(ws, y, width):
        if fault == "ws_row_tile_from_other":
            ws = ws.clone()
            ws[:, :, 1] = torch.roll(ws, -1, dims=1)[:, :, 1] if h > 1 else ws[:, :, 2]
        out = torch.zeros(b, h, n_pad, width)
        order = list(range(tiles))
        if fault == "token_tile_twice":
            order[2] = 1
        for t in order:
            a = _from_tile(ws[:, :, :, t]).float().reshape(b, h, n_pad, 64)
            out += a @ y[..., 64 * t:64 * t + 64, :]
        if fault == "last_column_block_unwritten":
            out[..., (width - 1) // 256 * 256:] = 0
        return out[..., :n, :]

    _, ds = scores(qf, dof, kf, vf, True)  # dq: rows are queries
    dq = gemm(_to_workspace(ds.to(q.dtype), tiles), kf, dqk)
    pt, dst = scores(kf, vf, qf, dof, False)  # dk/dv: rows are keys
    dk = gemm(_to_workspace(dst.to(q.dtype), tiles), qf, dqk)
    dv = gemm(_to_workspace(pt.to(do.dtype), tiles), dof, dvw)
    return {"dq": dq, "dk": dk, "dv": dv}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dqk,dv,heads", [(448, 448, 2), (256, 2048, 1)])
def test_wide_tiling_matches_pallas_bwd(dqk, dv, heads, dtype):
    """dq, dk and dv of the wide kernels' tiling and workspace round trip
    against the Pallas backward in the interpreter (both given JAX's lse
    and D) at N = 1,100, within MAX_REL of each gradient's max|ref|; each
    fault of the design misses that bar in the gradients it touches."""
    q, k, v, g, scale = _inputs(N_RAGGED, dqk, dv, heads, seed=7)
    lse, dcap, ref = _pallas((q, k, v, g), scale, heads, PALLAS_BLOCKS, dtype)
    tdt = getattr(torch, dtype)
    split = lambda a: tvjp._split_heads(torch.from_numpy(np.array(a, np.float32)).to(tdt), heads)
    stats = lambda a: tvjp._stats4(torch.from_numpy(np.array(a)), heads)
    args = [split(a) for a in (q, k, v, g)] + [stats(lse), stats(dcap)]
    last = lambda t: tattn._heads_last(t.to(tdt)).float().numpy()
    bar = MAX_REL[dtype]
    sound = {name: last(t) for name, t in _wide_tiled(*args, scale).items()}
    for name, val in sound.items():
        assert val.shape == ref[name].shape, name
        assert _rel(val, ref[name]) <= bar, (name, _rel(val, ref[name]))
    for fault in ("token_tile_twice", "last_column_block_unwritten", "ws_row_tile_from_other"):
        got = {name: last(t) for name, t in _wide_tiled(*args, scale, fault).items()}
        for name, val in got.items():
            assert _rel(val, ref[name]) > bar, (fault, name, _rel(val, ref[name]))
