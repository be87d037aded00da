"""The fp32 flash backward for Hopper (csrc/flash_bwd_f32_sm90.cu), on the
CPU.

The kernels cannot run here; what is held here is what surrounds them:
  * the form rule (`attention_vjp.bwd_form`): at every scale (phi 'n' to
    'x') and at 640x640 and 480x576, every fp32 training site, packed,
    single-head or folded, takes the fp32 Hopper backward ("f32_sm90"); no
    fp32 site is left on another form, and no source holds the CUDA-core
    FFMA kernel;
  * the launch plans (`attention_vjp.bwd_f32_sm90_plan`) at every site: the
    shared memory recomputed here within the card's 227 KB, every wgmma N a
    multiple of 8 and at most 256, the output passes and the warpgroups'
    columns covering each gradient exactly once, every TMA row stride a
    multiple of 16 bytes;
  * the kernels' arithmetic, emulated in plain PyTorch: tf32 by clearing the
    13 low mantissa bits through `view(torch.int32)`, the 3xTF32 split of
    all five products (S, dP, and dQ, dK, dV), the plan's tiling (64-column
    tiles, output passes, each warpgroup's columns, each tile's gradient
    product into a fresh accumulator added in fp32), and
    dS, P^T and dS^T handed to the gradient products through the A fragments
    built thread by thread from the score accumulator (in the register order
    the kernel source names) against transposed copies in the token order
    the pre-pass writes; held against the Pallas backward (flash_bwd) in the
    Pallas interpreter at N = 1,100 under the fp32 bar (1e-4 of |ref| + 1e-4
    of max|ref| per element, and 1e-4 in norm, PERF.md); the same emulation
    with the low parts dropped from dS.K or P^T.dO, a transposed copy in
    the natural token order, or a key or query tile read twice must fail it;
  * the wrappers: off the CPU they launch or raise, never fall back, and
    `reset_launch_counts` clears the new counters.
"""
from __future__ import annotations

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import transparent_object_detection_tpu.ops.attention as jattn
import transparent_object_detection_tpu.ops.attention_vjp as jvjp
from test_torch_flash_bwd_sm90 import PALLAS_BLOCKS, _training_calls
from test_torch_flash_f32_sm90 import _fragment_keys, _split
from test_torch_flash_sm90 import INPUTS, PHIS
from transparent_object_detection_tpu_torch.ops import attention as tattn
from transparent_object_detection_tpu_torch.ops import attention_vjp as tvjp

torch.set_num_threads(1)

CSRC = Path(tattn.__file__).resolve().parents[1] / "csrc"
KERNEL_SRC = CSRC / "flash_bwd_f32_sm90.cu"
# the fp32 bar of PERF.md section 2: per element, and in norm
RTOL, ATOL_OF_MAX, NORM_RTOL = 1e-4, 1e-4, 1e-4
WGMMA_N_MAX = 256
SMEM_LIMIT = 232448
N = 1100
GRADS = ("dq", "dk", "dv")


def _fp32_sites():
    return [(phi, hw, *call) for phi in PHIS for hw in INPUTS
            for call in _training_calls(phi, hw)]


@pytest.mark.parametrize("phi", PHIS)
def test_bwd_form_every_fp32_training_site(phi):
    """Every fp32 training call of `phi` (640x640 and 480x576: packed,
    single-head and folded) takes the fp32 Hopper backward, whatever its
    widths; bf16 keeps its own three forms; no backward source holds the
    FFMA kernel or its fp32 flag (the mma.sync template that held them is
    deleted)."""
    calls = [s for s in _fp32_sites() if s[0] == phi]
    assert {s[3] for s in calls} >= {"packed", "single"}, phi
    for _, hw, name, route, n, dqk, dv, heads in calls:
        assert tvjp.bwd_form(dqk, dv, heads, torch.float32) == "f32_sm90", (hw, name)
        assert tvjp.bwd_form(dqk, dv, heads, torch.bfloat16) in (
            "sm90", "single_sm90", "wide_sm90"), (hw, name)
        assert tvjp.kernel_supports(n, dqk, dv, heads, torch.float32), (hw, name)
    assert not (CSRC / "flash_attn_bwd.cu").exists()
    for path in CSRC.glob("flash_bwd_*.cu"):
        src = path.read_text()
        assert "flash_bwd_f32_kernel" not in src and "int f32" not in src, path.name


def _smem(kernel, plan) -> int:
    """Shared memory of a plan from its parts: 1 KB alignment slack, 1 KB of
    barriers; dq: `stages` stages of its one ring, a stage a 16-column slab
    of the 128 rows and of the 64 columns, hi and lo, 64 bytes a row (24
    KB); dk/dv: two fp32 64 x 64 P^T buffers (16 KB each) and `stages`
    stages of each warpgroup's ring, a stage the larger of a slab of the 64
    rows and of the 64 columns (16 KB) and a chunk of 16 tokens x the
    warpgroup's N rows, hi and lo."""
    box = 64 * 64
    if kernel == "dq":
        return 2048 + plan["stages"] * (2 * 128 * 64 + 2 * box)
    units = [max(4 * box, n_w * 16 * 4 * 2) for n_w in (plan["n0"], plan["n1"])]
    return 2048 + 2 * 64 * 64 * 4 + plan["stages"] * sum(units)


def _columns(kernel, plan, dqk, dv):
    """{gradient: sorted columns} the plan's passes compute: dq, both
    warpgroups the same n0 columns a pass (each on its own 64 rows); dk/dv,
    warpgroup 0 dV (n0 a pass), warpgroup 1 dK (n1 a pass); columns past
    the width dropped."""
    got = {}
    for p in range(plan["passes"]):
        if kernel == "dq":
            ranges = [("dq", p * plan["n0"], plan["n0"], dqk)]
        else:
            ranges = [("dv", p * plan["n0"], plan["n0"], dv), ("dk", p * plan["n1"], plan["n1"],
                                                               dqk)]
        for name, c0, width, total in ranges:
            got.setdefault(name, []).extend(c for c in range(c0, c0 + width) if c < total)
    return {name: sorted(cols) for name, cols in got.items()}


@pytest.mark.parametrize("phi", PHIS)
def test_launch_plans_fit_and_cover_every_site(phi):
    """The dq and dk/dv plans of every fp32 training site of `phi`: blocks
    of 128 query rows (dq) or 64 keys (dk/dv), 64-column tiles, 16-column
    slabs; n0, n1 a pair the library is built for; the passes cover each
    gradient's columns exactly once, and no pass is wholly past them;
    shared memory recomputed here within 227 KB with the most stages (2-8)
    that fit; every wgmma N (64 for S and dP, n0 and n1) a multiple of 8
    and at most 256; the TMA row strides (the pre-pass's row and transposed
    copies, the packed qkv) multiples of 16 bytes."""
    found = [s for s in _fp32_sites() if s[0] == phi]
    assert found, phi
    for _, hw, name, route, n, dqk, dv, heads in found:
        plans = tvjp.bwd_f32_sm90_plan(dqk, dv)
        for kernel, plan in plans.items():
            tag = (hw, name, kernel)
            assert set(plan) == set(tvjp.F32_BWD_PLAN_KEYS), tag
            rows = 128 if kernel == "dq" else 64
            assert (plan["rows"], plan["keys"], plan["slab"]) == (rows, 64, 16), tag
            assert (plan["n0"], plan["n1"]) in tvjp.F32_BWD_WIDTHS[kernel], tag
            cols = _columns(kernel, plan, dqk, dv)
            widths = {"dq": dqk} if kernel == "dq" else {"dk": dqk, "dv": dv}
            assert cols == {g: list(range(w)) for g, w in widths.items()}, tag
            if kernel == "dq":
                assert (plan["passes"] - 1) * plan["n0"] < dqk, tag
            else:
                assert (plan["passes"] - 1) * plan["n0"] < dv or \
                    (plan["passes"] - 1) * plan["n1"] < dqk, tag
            smem = _smem(kernel, plan)
            assert plan["smem_bytes"] == smem <= SMEM_LIMIT, tag
            assert 2 <= plan["stages"] <= 8, tag
            more = dict(plan, stages=plan["stages"] + 1)
            assert plan["stages"] == 8 or _smem(kernel, more) > SMEM_LIMIT, tag
            for n_mma in (64, plan["n0"], plan["n1"]):
                assert n_mma % 8 == 0 and 8 <= n_mma <= WGMMA_N_MAX, tag
            n_pad = -(-n // 64) * 64
            strides = [heads * dqk * 4, heads * dv * 4, n_pad * 4]
            if route == "packed":
                strides.append((2 * dqk + dv) * heads * 4)
            assert all(st % 16 == 0 for st in strides), tag


def test_launch_plan_choices():
    """The plans of the phi 'n', 's' and 'm' sites: heads of 128 in one pass
    (dq 128 columns a warpgroup, 8 stages; dk/dv dV and dK 128 each, 6
    stages); dark3 with dq 64 wide and dk/dv as dV 128 and dK 64 in two
    passes (four at phi='s'); wider heads in 128-column passes; widths that
    are not multiples of 8 refused."""
    expect = {  # (dqk, dv): {kernel: (n0, n1, passes, stages)}
        (128, 128): {"dq": (128, 128, 1, 8), "dkv": (128, 128, 1, 6)},
        (32, 256): {"dq": (64, 64, 1, 8), "dkv": (128, 64, 2, 6)},
        (288, 288): {"dq": (128, 128, 3, 8), "dkv": (128, 128, 3, 6)},
        (384, 384): {"dq": (128, 128, 3, 8), "dkv": (128, 128, 3, 6)},
        (256, 256): {"dq": (128, 128, 2, 8), "dkv": (128, 128, 2, 6)},
        (64, 512): {"dq": (64, 64, 1, 8), "dkv": (128, 64, 4, 6)},
    }
    for widths, want in expect.items():
        plans = tvjp.bwd_f32_sm90_plan(*widths)
        for kernel, fields in want.items():
            plan = plans[kernel]
            got = tuple(plan[key] for key in ("n0", "n1", "passes", "stages"))
            assert got == fields, (widths, kernel, got)
    for bad in ((0, 64), (12, 64), (64, 100)):
        with pytest.raises(ValueError, match="multiples of 8"):
            tvjp.bwd_f32_sm90_plan(*bad)


# ---------------------------------------------------------------------------
# the kernels' arithmetic, emulated
# ---------------------------------------------------------------------------


def _kernel_orders():
    """The kernels' choices, read from their sources: the accumulator
    register (4i + e) each A-fragment register of k8 step i takes, and the
    token each position of a group of 8 holds in a transposed copy."""
    src = KERNEL_SRC.read_text()
    m = re.search(r"const float v\[4\] = \{x\[4 \* i\], x\[4 \* i \+ (\d)\], "
                  r"x\[4 \* i \+ (\d)\], x\[4 \* i \+ (\d)\]\};", src)
    order = (0, *(int(g) for g in m.groups()))
    assert sorted(order) == [0, 1, 2, 3]
    assert re.search(r"\(p < 4 \? 2 \* p : 2 \* p - 7\)", (CSRC / "tf32_split.cuh").read_text())
    perm = tuple(2 * p if p < 4 else 2 * p - 7 for p in range(8))
    return order, perm


def _prod3(a, b, lo=True):
    """a @ b^T as the kernels take it: hi.hi + (hi.lo + lo.hi), or hi.hi alone."""
    ah, al = _split(a)
    bh, bl = _split(b)
    out = ah @ bh.transpose(-1, -2)
    if lo:
        out = out + (ah @ bl.transpose(-1, -2) + al @ bh.transpose(-1, -2))
    return out


def _grad_tile(x, y_t, key_of, perm, lo=True, natural=False):
    """One tile's gradient product into a fresh accumulator: X (G, R, 64)
    handed over as the A fragments (column pos holds X's column key_of[row,
    pos]) against the transposed copy's chunk (G, cols, 64 tokens), stored
    with each group of 8 tokens in the pre-pass's order (or, `natural`, as
    they come); hi.hi + hi.lo + lo.hi (or hi.hi alone)."""
    pos = torch.arange(64)
    token = (pos // 8) * 8 + (pos % 8 if natural else torch.tensor(perm)[pos % 8])
    a = x.gather(-1, key_of)
    return _prod3(a, y_t[..., token], lo)


def emulate(kernel, q, k, v, do, lse, dcap, scale, plan, fault=None):
    """csrc/flash_bwd_f32_sm90.cu's arithmetic on one-head operands q, k (G,
    N, dqk), v, do (G, N, dv), lse and dcap (G, N), fp32; -> {gradient:
    (G, N, width)}. `kernel` "dq": rows are queries, S = Q K^T and dP = dO
    V^T on 64-key tiles (keys past N: P set to 0), dS = P (dP - D) scale,
    dQ of each warpgroup's columns += dS K^T-chunk; "dkv": rows are keys,
    S^T = K Q^T, dP^T = V dO^T on 64-query tiles (queries past N: P^T set
    to 0), dS^T = P^T (dP^T - D) scale, dV += P^T dO^T-chunk, dK += dS^T
    Q^T-chunk. Each output pass recomputes the scores (the same values) and
    computes its warpgroups' columns only. `fault`: "grad_lo_dropped" (hi.hi
    alone in dQ, or in dV), "natural_token_order" (the transposed copies
    unpermuted), "tile_read_twice" (column tile 1 read again in place of
    tile 2)."""
    g, n, dqk = q.shape
    dv = v.shape[-1]
    n_pad = -(-n // 64) * 64
    pad = lambda t: torch.nn.functional.pad(t, (0, 0, 0, n_pad - n))
    q, k, v, do = (pad(t) for t in (q, k, v, do))
    lse2, d = (torch.nn.functional.pad(t, (0, n_pad - n)) for t in (lse * tattn.LOG2E, dcap))
    order, perm = _kernel_orders()
    key_of = _fragment_keys(order).repeat(n_pad // 64, 1).expand(g, -1, -1)
    s_scale = scale * tattn.LOG2E
    lo = fault != "grad_lo_dropped"
    natural = fault == "natural_token_order"
    if kernel == "dq":
        rows1, rows2, cols1, cols2, ys = q, do, k, v, {"dq": k}
    else:
        rows1, rows2, cols1, cols2, ys = k, v, q, do, {"dv": do, "dk": q}
    out = {name: torch.zeros(g, n_pad, y.shape[-1]) for name, y in ys.items()}
    done = {name: torch.zeros(y.shape[-1], dtype=torch.long) for name, y in ys.items()}
    for p in range(plan["passes"]):
        if kernel == "dq":  # both warpgroups these columns, each on its own rows
            wgs = [("dq", p * plan["n0"], plan["n0"])]
        else:
            wgs = [("dv", p * plan["n0"], plan["n0"]), ("dk", p * plan["n1"], plan["n1"])]
        acc = {i: torch.zeros(g, n_pad, width) for i, (_, _, width) in enumerate(wgs)}
        for t in range(n_pad // 64):
            src = 1 if (fault == "tile_read_twice" and t == 2) else t
            cs = slice(src * 64, (src + 1) * 64)
            s = _prod3(rows1, cols1[:, cs])
            dp = _prod3(rows2, cols2[:, cs])
            valid = torch.arange(src * 64, (src + 1) * 64) < n
            if kernel == "dq":
                pr = torch.exp2(s * s_scale - lse2[..., None])
                pr = torch.where(valid, pr, torch.zeros(()))
                x = {"dq": pr * (dp - d[..., None]) * scale}
            else:
                pr = torch.exp2(s * s_scale - lse2[:, None, cs])
                pr = torch.where(valid, pr, torch.zeros(()))
                x = {"dv": pr, "dk": pr * (dp - d[:, None, cs]) * scale}
            for i, (name, c0, width) in enumerate(wgs):
                y = ys[name]
                cols = torch.arange(c0, c0 + width)
                y_t = torch.nn.functional.pad(y, (0, max(0, c0 + width - y.shape[-1])))
                y_t = y_t[..., cols].transpose(1, 2)[..., cs]  # (G, width, 64 tokens)
                wrong = name == ("dq" if kernel == "dq" else "dv")
                acc[i] = acc[i] + _grad_tile(x[name], y_t, key_of, perm, lo or not wrong,
                                             natural)
        for i, (name, c0, width) in enumerate(wgs):
            real = min(width, out[name].shape[-1] - c0)
            if real > 0:
                out[name][..., c0:c0 + real] = acc[i][..., :real]
                done[name][c0:c0 + real] += 1
    assert all(bool((cnt == 1).all()) for cnt in done.values()), done
    return {name: t[:, :n] for name, t in out.items()}


def _readings(got, ref):
    """(bar used per element, norm error over its bar) of each gradient."""
    out = {}
    for name, val in got.items():
        a, b = val.double().numpy(), np.asarray(ref[name], np.float64)
        elem = float((np.abs(a - b) / (RTOL * np.abs(b) + ATOL_OF_MAX * np.abs(b).max())).max())
        out[name] = max(elem, float(np.linalg.norm(a - b) / np.linalg.norm(b)) / NORM_RTOL)
    return out


FAULTS = ("grad_lo_dropped", "natural_token_order", "tile_read_twice")


@pytest.mark.parametrize("heads,dqk,dv,score_std", [(2, 128, 128, 4.0), (1, 32, 256, 1.0),
                                                    (1, 288, 288, 4.0)])
def test_emulation_matches_pallas_bwd(heads, dqk, dv, score_std):
    """dq, dk and dv of the emulated kernels against the Pallas backward in
    the Pallas interpreter (both given JAX's lse and D), fp32, N = 1,100
    (ragged against every tile): packed heads of 128 (phi='n' h2), one
    head of 32/256 (dark3 of phi='n': dk/dv in two passes, the second
    without dK columns) and of 288 (the folded h1 of phi='n': dq and dk/dv
    in three passes), within the fp32 bar; each planted fault
    fails it on the gradient it touches."""
    rng = np.random.default_rng(dqk + dv)
    scale = dqk ** -0.5 if heads > 1 else 1.0
    std = (score_std / (scale * dqk ** 0.5)) ** 0.5
    q, k = (rng.standard_normal((1, N, heads * dqk)).astype(np.float32) * std for _ in range(2))
    v, g = (rng.standard_normal((1, N, heads * dv)).astype(np.float32) for _ in range(2))
    jvjp.INTERPRET = True
    jattn._diff_flash.cache_clear()
    try:
        jq, jk, jv, jg = (jnp.asarray(a) for a in (q, k, v, g))
        out, lse = jvjp.flash_fwd_lse(jq, jk, jv, scale, *PALLAS_BLOCKS, heads)
        dcap = jvjp.compute_dcap(out, jg, heads)
        ref = jvjp.flash_bwd(jq, jk, jv, jg, lse, dcap, scale, *PALLAS_BLOCKS, heads)
    finally:
        jvjp.INTERPRET = False
        jattn._diff_flash.cache_clear()
    heads_first = lambda a: tattn._heads_first(torch.from_numpy(np.array(a)), heads).reshape(
        heads, N, -1)
    ref = {name: heads_first(r).numpy() for name, r in zip(GRADS, ref)}
    stat = lambda a: torch.from_numpy(np.array(a, np.float32)).reshape(heads, N)
    args = (*(heads_first(a) for a in (q, k, v, g)), stat(lse), stat(dcap), scale)
    plans = tvjp.bwd_f32_sm90_plan(dqk, dv)

    def grads(fault=None):
        return {**emulate("dq", *args, plans["dq"], fault),
                **emulate("dkv", *args, plans["dkv"], fault)}

    sound = _readings(grads(), ref)
    assert max(sound.values()) <= 1.0, sound
    touched = {"grad_lo_dropped": ("dq", "dv"), "natural_token_order": GRADS,
               "tile_read_twice": GRADS}
    for fault in FAULTS:
        used = _readings(grads(fault), ref)
        for name in touched[fault]:
            assert used[name] > 1.0, (fault, name, used)


def test_wrappers_never_fall_back_off_cpu():
    """fp32 operands that are neither on the CPU nor on a card: flash_bwd_dq
    and flash_bwd_dkv raise before any library is built, packed heads and
    one head, and count nothing; reset_launch_counts clears the f32
    counters; on the CPU the wrappers run the plain versions, uncounted."""
    for fn in (tvjp.flash_bwd_dq, tvjp.flash_bwd_dkv):
        fn.f32_launches = 3
    tvjp.reset_launch_counts()
    counters = lambda: [fn.f32_launches for fn in (tvjp.flash_bwd_dq, tvjp.flash_bwd_dkv)]
    assert counters() == [0, 0]
    qkv = torch.empty((1, 2048, 3 * 256), dtype=torch.float32, device="meta")
    q, k, v = qkv[..., :256], qkv[..., 256:512], qkv[..., 512:]
    do = torch.empty((1, 2048, 256), dtype=torch.float32, device="meta")
    for heads in (2, 1):
        shape = (1, heads, 2048, 1) if heads > 1 else (1, 2048, 1)
        lse = dcap = torch.empty(shape, dtype=torch.float32, device="meta")
        assert tvjp.bwd_form(256 // heads, 256 // heads, heads, torch.float32) == "f32_sm90"
        for fn in (tvjp.flash_bwd_dq, tvjp.flash_bwd_dkv):
            with pytest.raises(ValueError, match="CUDA tensor"):
                fn(q, k, v, do, lse, dcap, 0.1, heads)
    assert counters() == [0, 0]
    gen = torch.Generator().manual_seed(0)
    x = [torch.randn(1, 100, 16, generator=gen) for _ in range(4)]
    out, lse = tvjp.flash_fwd_lse_plain(*x[:3], 0.25, 2)
    dcap = tvjp.compute_dcap(out, x[3], 2)
    args = (*x, lse, dcap, 0.25, 2)
    assert torch.equal(tvjp.flash_bwd_dq(*args), tvjp.flash_bwd_dq_plain(*args))
    got, want = tvjp.flash_bwd_dkv(*args), tvjp.flash_bwd_dkv_plain(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert counters() == [0, 0]
