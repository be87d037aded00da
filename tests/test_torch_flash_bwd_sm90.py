"""The bf16 packed flash backward for Hopper (csrc/flash_bwd_sm90.cu), on the
CPU.

The kernels cannot run here; what is held here is what surrounds them:
  * the rule (`attention_vjp.bwd_form`): at every scale (phi 'n' to 'x')
    and at 640x640 and 480x576, every packed bf16 training site of phi 'n',
    's' and 'm' (heads of 128, 256 and 384) takes the sm90 kernels, the
    wider packed heads of phi 'l' and 'x' take csrc/flash_bwd_wide_sm90.cu
    (tests/test_torch_flash_bwd_wide_sm90.py), the
    single-head and folded sites of phi 'n' to 'm' take
    csrc/flash_bwd_single_sm90.cu (tests/test_torch_flash_bwd_single_sm90.py),
    fp32 takes csrc/flash_bwd_f32_sm90.cu
    (tests/test_torch_flash_bwd_f32_sm90.py); widths off the grid follow the
    rule (equal multiples of 64 up to 384, two heads or more);
  * the launch plans (`attention_vjp.bwd_sm90_plan`), computed in Python
    and handed to the launcher, at every sm90 site: they fit the card's 227
    KB of dynamic shared memory (recomputed here), the ring holds a whole
    query or key tile, the blocks cover every row and the warpgroups' output slabs every
    column, and every wgmma N (64) is a multiple of 8 and at most 256;
  * the kernels' tiling, emulated in plain PyTorch at the plans' tiles (64
    keys and 64 queries; dk/dv key tile by key tile from S^T = K Q^T and
    dP^T = V dO^T, query tile after query tile; dq key tile after key
    tile), P and dS cast to the input type where the kernels cast them,
    against the Pallas backward (flash_bwd) in the Pallas interpreter, at N
    = 1,100 (ragged against every tile), 2 heads of 128 and of 256, in fp32
    and bf16, with bars relative to max|ref| (MAX_REL) that a query or key
    tile left out or read twice misses;
  * the wrappers: off the CPU on the sm90 route they launch or raise, never
    fall back, and `reset_launch_counts` clears their sm90 counters.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import transparent_object_detection_tpu.ops.attention as jattn
import transparent_object_detection_tpu.ops.attention_vjp as jvjp
from test_torch_flash_sm90 import INPUTS, PHIS, sites
from transparent_object_detection_tpu_torch.ops import attention as tattn
from transparent_object_detection_tpu_torch.ops import attention_vjp as tvjp

torch.set_num_threads(1)

# bars relative to max|ref| of each gradient: fp32 2e-4 (the port's fp32
# bar: summation order and exp vs exp2 only; measured under 5e-6); bf16
# 1e-2 (P and dS rounded to bf16 against other fp32 sums, and the gradients
# stored in bf16: 2.4e-3 to 5.4e-3 measured). At these shapes a tile left
# out moves a gradient by 0.23-0.32 of max|ref|, a tile read twice by
# 0.30-0.43, dS^T from the previous query tile's P^T moves dk by 0.49-0.52.
MAX_REL = {"float32": 2e-4, "bfloat16": 1e-2}
WGMMA_N_MAX = 256
TILE = 64  # keys and queries a tile of both kernels
# (block_q, block_k) of the Pallas kernels, which take only blocks that
# divide N: 1,100 = 5 x 220 = 11 x 100
PALLAS_BLOCKS = (220, 100)
N_RAGGED = 1100


def _training_calls(phi, hw):
    """(site, route, N, q/k head width, v head width, heads) of each
    training kernel call: folded heads as the fold copy hands them over
    (single heads, widths padded to a multiple of 8)."""
    out = []
    for name, (n, cq, cv, heads, _) in sites(phi, hw).items():
        route = tattn.train_route(n, cq, heads, cv)
        if route == "naive":
            continue
        if route == "folded":
            pad = lambda d: -(-d // heads // 8) * 8
            out.append((name, route, n, pad(cq), pad(cv), 1))
        else:
            out.append((name, route, n, cq // heads, cv // heads, heads))
    return out


def _sm90_sites():
    return [(phi, hw, *call) for phi in PHIS for hw in INPUTS
            for call in _training_calls(phi, hw)
            if tvjp.bwd_form(call[3], call[4], call[5], torch.bfloat16) == "sm90"]


@pytest.mark.parametrize("phi", PHIS)
def test_bwd_form_at_every_training_site(phi):
    """Packed bf16 heads of phi 'n', 's' and 'm' (128, 256, 384) take the
    sm90 kernels; phi 'l' and 'x' packed heads (768 and wider) take the
    wide kernels; dark3 and the folded heads of phi 'n', 's' and 'm' take
    the one-head kernels (tests/test_torch_flash_bwd_single_sm90.py), dark3
    of phi 'l' and 'x' the wide kernels; every fp32 call takes the fp32
    Hopper backward."""
    widths = {"n": 128, "s": 256, "m": 384}
    for hw in INPUTS:
        calls = _training_calls(phi, hw)
        assert calls, (phi, hw)
        for name, route, n, dq, dv, heads in calls:
            form = tvjp.bwd_form(dq, dv, heads, torch.bfloat16)
            if route == "packed" and phi in widths:
                assert (dq, dv, form) == (widths[phi], widths[phi], "sm90"), (hw, name)
            elif route != "packed" and phi in widths:
                assert (heads, form) == (1, "single_sm90"), (hw, name, route, dq, dv)
            else:
                assert form == "wide_sm90", (hw, name, route, dq, dv)
            assert tvjp.bwd_form(dq, dv, heads, torch.float32) == "f32_sm90", (hw, name)
            assert tvjp.kernel_supports(n, dq, dv, heads, torch.bfloat16), (hw, name)


def test_bwd_form_off_the_routed_widths():
    """The rule off the routed grid: two heads of 64, 192 and 320 take the
    sm90 kernels; 448, 72 and unequal widths do not (the wide kernels), nor
    does one head (phi='s' dark3's widths the one-head kernels, other
    one-head widths the wide kernels); the plan refuses what the rule
    refuses."""
    for d in (64, 192, 320):
        assert tvjp.bwd_form(d, d, 2, torch.bfloat16) == "sm90"
        assert tvjp.bwd_sm90_plan(d)["dq"]["split"] == int(d >= 320)
    for dq, dv, heads in ((448, 448, 2), (72, 72, 2), (128, 256, 2), (256, 128, 2),
                          (256, 256, 1), (64, 512, 1)):
        assert tvjp.bwd_form(dq, dv, heads, torch.bfloat16) == \
            ("single_sm90" if (dq, dv, heads) == (64, 512, 1) else "wide_sm90"), (dq, dv, heads)
    for d in (448, 72, 0):
        with pytest.raises(ValueError, match="multiples of 64 up to 384"):
            tvjp.bwd_sm90_plan(d)


@pytest.mark.parametrize("phi", ("n", "s", "m"))
def test_launch_plans_fit_and_cover_every_sm90_site(phi):
    """The dq and dk/dv plans of every sm90 site of `phi`: 64-wide slabs,
    shared memory recomputed here within 227 KB and with the most ring
    stages (operand tiles, up to 24) that fit, at least one query or key
    tile's two; the
    blocks' rows cover N and the warpgroups' output slabs cover the head
    width, the second starting inside it; wgmma N a multiple of 8, at most
    256."""
    found = [s for s in _sm90_sites() if s[0] == phi]
    assert found, phi
    slab_bytes, xchg = 64 * 64 * 2, 64 * 64 * 4
    for _, hw, name, _, n, d, _, heads in found:
        plans = tvjp.bwd_sm90_plan(d)
        slabs, split = d // 64, d >= 320
        for kernel, plan in plans.items():
            tag = (hw, name, kernel)
            assert set(plan) == set(tvjp.SM90_BWD_PLAN_KEYS), tag
            assert plan["slab"] == 64 and plan["split"] == int(split), tag
            rows = plan["rows"]
            assert rows == (64 if kernel == "dkv" or split else 128), tag
            blocks = -(-n // rows)
            assert blocks * rows >= n and (blocks - 1) * rows < n, tag
            if kernel == "dq":
                resident = 2 * slabs * (rows // 64) * slab_bytes + (2 * xchg if split else 0)
            else:
                resident = 2 * slabs * slab_bytes + (2 if split else 1) * xchg
            tile = (6 if split else slabs) * slab_bytes  # a ring stage: one operand tile
            smem = 2048 + resident + plan["stages"] * tile
            assert plan["smem_bytes"] == smem <= tattn.SM90_SMEM_LIMIT, tag
            assert 2 <= plan["stages"] <= tvjp.SM90_BWD_MAX_STAGES, tag
            assert plan["stages"] == tvjp.SM90_BWD_MAX_STAGES or \
                smem + tile > tattn.SM90_SMEM_LIMIT, tag
            # output slabs: one warpgroup all of them, or three each of two
            owned = [range(slabs)] if not split else [range(0, 3), range(3, min(6, slabs))]
            assert sorted(c for r in owned for c in r) == list(range(slabs)), tag
            assert all(len(r) <= (3 if split else 4) for r in owned), tag  # <= 128 registers
            assert not split or owned[1].start < slabs, tag
            assert 64 % 8 == 0 and 64 <= WGMMA_N_MAX, tag  # every product is m64n64k16


# ---------------------------------------------------------------- tiling
def _inputs(dh, heads=2, n=N_RAGGED, seed=3):
    rng = np.random.default_rng(seed)
    c = heads * dh
    scale = dh ** -0.5
    qk = rng.standard_normal((2, 1, n, c)).astype(np.float32) * 0.6
    v, g = (rng.standard_normal((1, n, c)).astype(np.float32) for _ in range(2))
    return qk[0], qk[1], v, g, heads, scale


def _dkv_tiled(q, k, v, do, lse, dcap, scale, fault=None):
    """dk, dv as csrc/flash_bwd_sm90.cu's dk/dv kernel forms them: per key
    tile of 64, query tile after query tile, S^T = K Q^T and dP^T = V dO^T
    in fp32, P^T = exp2(S^T * scale * log2 e - lse * log2 e), dS^T = P^T *
    (dP^T - D) * scale, P^T and dS^T cast to the input type before dV +=
    P^T dO and dK += dS^T Q (fp32 sums). (B, H, N, d) operands, lse and D
    (B, H, N, 1). `fault`: "tile_dropped" skips query tile 1,
    "tile_twice" reads query tile 1 again in place of tile 2,
    "stale_p" forms dS^T from the P^T of the previous query tile."""
    n = q.shape[-2]
    tiles = list(range(-(-n // TILE)))
    if fault == "tile_dropped":
        tiles.remove(1)
    dk, dv = torch.zeros_like(k, dtype=torch.float32), torch.zeros_like(v, dtype=torch.float32)
    for k0 in range(0, n, TILE):
        kb, vb = k[..., k0:k0 + TILE, :].float(), v[..., k0:k0 + TILE, :].float()
        prev = None
        for t in tiles:
            src = 1 if (fault == "tile_twice" and t == 2) else t
            rows = slice(src * TILE, (src + 1) * TILE)
            qb, dob = q[..., rows, :], do[..., rows, :]
            st = kb @ qb.float().transpose(-1, -2)
            pt = torch.exp2(st * (scale * tattn.LOG2E)
                            - lse[..., rows, :].transpose(-1, -2) * tattn.LOG2E)
            dpt = vb @ dob.float().transpose(-1, -2)
            p_ds = prev[..., :pt.shape[-1]] if (fault == "stale_p" and prev is not None) else pt
            dst = p_ds * (dpt - dcap[..., rows, :].transpose(-1, -2)) * scale
            prev = pt
            dv[..., k0:k0 + TILE, :] += pt.to(do.dtype).float() @ dob.float()
            dk[..., k0:k0 + TILE, :] += dst.to(q.dtype).float() @ qb.float()
    return dk, dv


def _dq_tiled(q, k, v, do, lse, dcap, scale, fault=None):
    """dq as the dq kernel forms it: key tile after key tile of 64, S = Q
    K^T and dP = dO V^T in fp32, dS = P * (dP - D) * scale cast to the
    input type before dQ += dS K. `fault`: "tile_dropped" skips key tile 1,
    "tile_twice" reads key tile 1 again in place of tile 2."""
    n = q.shape[-2]
    tiles = list(range(-(-n // TILE)))
    if fault == "tile_dropped":
        tiles.remove(1)
    qf, dof = q.float(), do.float()
    dq = torch.zeros_like(q, dtype=torch.float32)
    for t in tiles:
        src = 1 if (fault == "tile_twice" and t == 2) else t
        keys = slice(src * TILE, (src + 1) * TILE)
        kb, vb = k[..., keys, :].float(), v[..., keys, :].float()
        s = qf @ kb.transpose(-1, -2)
        p = torch.exp2(s * (scale * tattn.LOG2E) - lse * tattn.LOG2E)
        ds = p * (dof @ vb.transpose(-1, -2) - dcap) * scale
        dq += ds.to(k.dtype).float() @ kb
    return dq


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dh", [128, 256])
def test_kernel_tiling_matches_pallas_bwd(dh, dtype):
    """dq, dk and dv of the kernels' tiling against the Pallas backward in
    the Pallas interpreter (both given JAX's lse and D) at N = 1,100, 2
    heads, within MAX_REL of each gradient's max|ref|; a query tile (dk/dv)
    or key tile (dq) left out or read twice misses that bar, and so does
    dS^T formed with the previous query tile's P^T (a missing barrier in the
    warpgroups' hand-over)."""
    q, k, v, g, heads, scale = _inputs(dh)
    c = q.shape[-1]
    jdt = getattr(jnp, dtype)
    jq, jk, jv, jg = (jnp.asarray(a).astype(jdt) for a in (q, k, v, g))
    jvjp.INTERPRET = True
    jattn._diff_flash.cache_clear()
    try:
        out, lse = jvjp.flash_fwd_lse(jq, jk, jv, scale, *PALLAS_BLOCKS, heads)
        dcap = jvjp.compute_dcap(out, jg, heads)
        ref = jvjp.flash_bwd(jq, jk, jv, jg, lse, dcap, scale, *PALLAS_BLOCKS, heads)
    finally:
        jvjp.INTERPRET = False
        jattn._diff_flash.cache_clear()
    ref = dict(zip(("dq", "dk", "dv"), (np.asarray(r, np.float32) for r in ref)))
    tdt = getattr(torch, dtype)
    split = lambda a: tvjp._split_heads(torch.from_numpy(np.array(a, np.float32)).to(tdt), heads)
    tq, tk, tv, tg = (split(a) for a in (q, k, v, g))
    tlse = torch.from_numpy(np.array(lse, np.float32))
    tdcap = torch.from_numpy(np.array(dcap, np.float32))
    assert tuple(tlse.shape) == (1, heads, N_RAGGED, 1)
    bar = MAX_REL[dtype]
    last = lambda t: tattn._heads_last(t.to(tdt)).float().numpy()

    def grads(fault=None):
        dk, dv = _dkv_tiled(tq, tk, tv, tg, tlse, tdcap, scale, fault)
        got = {"dk": last(dk), "dv": last(dv)}
        if fault != "stale_p":
            got["dq"] = last(_dq_tiled(tq, tk, tv, tg, tlse, tdcap, scale, fault))
        return got

    sound = grads()
    for name, val in sound.items():
        assert val.shape == (1, N_RAGGED, c), name
        assert _rel(val, ref[name]) <= bar, (name, _rel(val, ref[name]))
    for fault in ("tile_dropped", "tile_twice", "stale_p"):
        for name, val in grads(fault).items():
            if fault == "stale_p" and name == "dv":
                continue  # dV takes warpgroup 0's own P^T
            assert _rel(val, ref[name]) > bar, (fault, name, _rel(val, ref[name]))
    # the wrappers' CPU path (the plain versions) within the same bar
    pq, pk, pv = (torch.from_numpy(np.array(a, np.float32)).to(tdt) for a in (jq, jk, jv))
    pg = torch.from_numpy(np.array(jg, np.float32)).to(tdt)
    wdq = tvjp.flash_bwd_dq(pq, pk, pv, pg, tlse, tdcap, scale, heads)
    wdk, wdv = tvjp.flash_bwd_dkv(pq, pk, pv, pg, tlse, tdcap, scale, heads)
    for name, val in (("dq", wdq), ("dk", wdk), ("dv", wdv)):
        assert _rel(val.float().numpy(), ref[name]) <= bar, name


def test_bwd_wrappers_never_fall_back_off_cpu():
    """flash_bwd_dq and flash_bwd_dkv on tensors that are neither on the CPU
    nor on a card raise before any library is built, on the sm90 route
    (packed heads of 256) and on the wide kernels' (packed heads of 448);
    they count nothing, and reset_launch_counts clears both counters of
    each."""
    for fn in (tvjp.flash_bwd_dq, tvjp.flash_bwd_dkv):
        fn.wide_launches = fn.sm90_launches = 5
    tvjp.reset_launch_counts()
    for fn in (tvjp.flash_bwd_dq, tvjp.flash_bwd_dkv):
        assert fn.wide_launches == 0 and fn.sm90_launches == 0
    for d, form in ((256, "sm90"), (448, "wide_sm90")):
        c = 2 * d
        qkv = torch.empty((1, 2048, 3 * c), dtype=torch.bfloat16, device="meta")
        q, k, v = qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:]
        do = torch.empty((1, 2048, c), dtype=torch.bfloat16, device="meta")
        lse = dcap = torch.empty((1, 2, 2048, 1), dtype=torch.float32, device="meta")
        assert tvjp.bwd_form(d, d, 2, torch.bfloat16) == form
        for fn in (tvjp.flash_bwd_dq, tvjp.flash_bwd_dkv):
            with pytest.raises(ValueError, match="CUDA tensor"):
                fn(q, k, v, do, lse, dcap, 0.1, 2)
    for fn in (tvjp.flash_bwd_dq, tvjp.flash_bwd_dkv):
        assert fn.wide_launches == 0 and fn.sm90_launches == 0
