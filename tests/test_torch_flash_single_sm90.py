"""The one-head bf16 flash forward for Hopper (the one-head form of
csrc/flash_fwd_sm90.cu: flash_single, and flash_fwd_lse with one head), on
the CPU.

The kernel cannot run here; what is held here is what surrounds it:
  * the rule (`attention.single_fwd_form`, `attention_vjp.lse_fwd_form`):
    at every scale (phi 'n' to 'x') and at 640x640 and 480x576, every
    one-head serving and training site (dark3; the folded heads as the fold
    copy pads them) takes the one-head form in bf16 and the fp32 Hopper
    kernel (csrc/flash_fwd_f32_sm90.cu) in fp32; packed heads keep their own
    rule;
  * the launch plan (`attention.single_sm90_plan`) at every such site: the
    split form exactly where q/k is wider than 128 and v wider than 256 but
    at most 640 (the folded heads), else v in slices of at most 256 across
    blocks of 128 rows (dark3); shared memory recomputed here within 227 KB
    with the most stages that fit; 64-column slabs covering q/k (the last
    reaching past the width by less than a slab); v slices or warpgroup
    halves covering v with none starting past it; the split form's Q
    resident beside two V stages, else one (600), else streamed; every
    wgmma N a multiple of 8 and at most 256 (the 320-column half as an N
    256 and an N 64 product); TMA boxes of 128-byte rows on operands whose
    strides are multiples of 16 bytes;
  * the kernel's tiling, emulated in plain PyTorch at each plan's key tile,
    v slices or halves and zero-filled columns, at N = 1,100 (ragged
    against every tile) for dark3's widths of phi 'n' (32/256) and 's'
    (64/512) and the folded heads of 288 (283 real) and 600 (599 real), in
    fp32 and bf16, within MAX_REL of max|ref| and lse within LSE_ABS: the
    lse form against `_fwd_lse_kernel` (flash_fwd_lse with one head) in the
    Pallas interpreter, the serving form against the function
    flash_attention_pallas computes (softmax(q k^T scale) v in fp32; the
    launcher has no interpret flag); each fault of the design misses the
    bar: a key tile read twice (its neighbour never), a q/k slab left out of
    S, the zero-filled columns past the width made nonzero (the next row's,
    as a map of the rounded-up width would read them), a v slice or half
    written from another one's P V;
  * the wrappers: off the CPU they launch or raise, never fall back, and
    `reset_launch_counts` clears the new counters.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import transparent_object_detection_tpu.ops.attention as jattn
import transparent_object_detection_tpu.ops.attention_vjp as jvjp
from test_torch_flash_sm90 import INPUTS, LSE_ABS, MAX_REL, PALLAS_BLOCKS, PHIS, WGMMA_N_MAX, \
    _rel, sites
from transparent_object_detection_tpu_torch.ops import attention as tattn
from transparent_object_detection_tpu_torch.ops import attention_vjp as tvjp

torch.set_num_threads(1)

SLAB = 64
N_RAGGED = 1100
pad8 = lambda d: -(-d // 8) * 8


def _one_head_calls(phi, hw):
    """(site, kind, N, q/k width, v width) of every one-head forward call of
    one serving forward and one training step: kind "serving" (flash_single)
    or "training" (flash_fwd_lse with one head); folded heads as the fold
    copy hands them over (widths padded to a multiple of 8)."""
    out = []
    for name, (n, cq, cv, heads, packed) in sites(phi, hw).items():
        serve = tattn.serving_route(n, cq, heads, cv, packed=packed)[0]
        train = tattn.train_route(n, cq, heads, cv)
        for kind, route in (("serving", serve), ("training", train)):
            if route in ("single", "folded"):
                out.append((name, kind, n, pad8(cq // heads), pad8(cv // heads)))
    return out


@pytest.mark.parametrize("phi", PHIS)
def test_single_form_at_every_one_head_site(phi):
    """Every one-head serving and training call of `phi` (dark3 at every
    scale, the folded h1 of phi 'n' and 'm') takes the one-head form of the
    sm90 kernel in bf16 and the fp32 Hopper kernel in fp32; packed heads
    keep `packed_fwd_form`."""
    dark3 = {"n": (32, 256), "s": (64, 512), "m": (128, 1024), "l": (256, 2048),
             "x": (512, 4096)}
    calls = _one_head_calls(phi, (640, 640)) + _one_head_calls(phi, (480, 576))
    assert {kind for _, kind, *_ in calls} == {"serving", "training"}, phi
    for name, kind, n, dqk, dv in calls:
        tag = (phi, name, kind, n, dqk, dv)
        if name == "dark3":
            assert (dqk, dv) == dark3[phi], tag
        else:
            assert (name, phi, dqk, dv) in (("h1", "n", 288, 288), ("h1", "m", 600, 600)), tag
        assert tattn.single_fwd_form(dqk, dv, torch.bfloat16) == "single_sm90", tag
        assert tvjp.lse_fwd_form(dqk, dv, 1, torch.bfloat16) == "single_sm90", tag
        assert tattn.single_fwd_form(dqk, dv, torch.float32) == "f32_sm90", tag
        assert tvjp.lse_fwd_form(dqk, dv, 1, torch.float32) == "f32_sm90", tag
    # packed heads keep their rule: the sm90 kernel at multiples of 64, the
    # template off that grid
    assert tvjp.lse_fwd_form(128, 128, 8, torch.bfloat16) == "sm90"
    assert tvjp.lse_fwd_form(72, 72, 4, torch.bfloat16) == "mma_sync"


def test_single_form_refuses_widths_off_the_kernel_grid():
    """Widths that are not multiples of 8 (the wrappers pad them first) have
    no plan, and the rule raises rather than answering another kernel."""
    for dqk, dv in ((60, 64), (64, 100), (0, 64)):
        with pytest.raises(ValueError, match="multiples of 8"):
            tattn.single_sm90_plan(dqk, dv)
        with pytest.raises(ValueError, match="multiples of 8"):
            tattn.single_fwd_form(dqk, dv, torch.bfloat16)


def _check_plan(dqk, dv, plan, tag):
    """The properties every one-head plan holds (see the module docstring)."""
    assert set(plan) == set(tattn.SM90_PLAN_KEYS), tag
    split = plan["wg_split"]
    half = -(-dv // (2 * SLAB)) * SLAB
    assert split == int(dqk > 128 and 256 < dv and half <= 320), tag
    rows, keys, vs, splits = plan["rows"], plan["keys"], plan["v_slice"], plan["dv_splits"]
    assert plan["slab"] == SLAB and rows == (64 if split else 128), tag
    # [columns] q/k slabs: the last reaches past the width by less than a slab
    slabs = -(-dqk // SLAB)
    assert slabs * SLAB >= dqk > (slabs - 1) * SLAB, tag
    # v: slices (sliced) or two halves (split) covering v, none starting past it
    cover = (2 if split else 1) * vs
    assert splits * cover >= dv > (splits - 1) * cover, tag
    starts = [s * cover + h * vs for s in range(splits) for h in range(2 if split else 1)]
    assert all(c0 < dv for c0 in starts), tag
    assert vs % SLAB == 0 and vs <= (320 if split else 256), tag
    if split:
        assert splits == 1 and keys == 64 and vs == half, tag
    else:
        assert splits == -(-dv // 256), tag
        assert keys == (128 if vs <= 128 else 64), tag
    # wgmma N: the key tile of S = Q K^T, the v columns of O += P V (320:
    # an N 256 and an N 64 product)
    for n_mma in (keys, *((256, 64) if vs == 320 else (vs,))):
        assert n_mma % 8 == 0 and 8 <= n_mma <= WGMMA_N_MAX, tag
    # shared memory, recomputed: slack and barriers, Q (resident), the K
    # ring (with Q slabs when Q streams), the V stages, P (split)
    q_bytes = 2 * rows * slabs * SLAB if plan["q_resident"] else 0
    stage = 2 * SLAB * (keys + (0 if plan["q_resident"] else rows))
    smem = (2048 + q_bytes + plan["stages"] * stage + plan["v_stages"] * 2 * keys * cover
            + (2 * 2 * 64 * keys if split else 0))
    assert plan["smem_bytes"] == smem <= tattn.SM90_SMEM_LIMIT, tag
    assert 1 <= plan["stages"] <= tattn.SM90_MAX_STAGES, tag
    assert plan["stages"] == tattn.SM90_MAX_STAGES or smem + stage > tattn.SM90_SMEM_LIMIT, tag
    if split:  # Q resident beside two V stages where two K stages fit, else
        # beside one, else streamed
        fits = lambda v_stages: (2048 + 2 * 64 * slabs * SLAB + 2 * 2 * SLAB * keys
                                 + v_stages * 2 * keys * cover
                                 + 2 * 2 * 64 * keys) <= tattn.SM90_SMEM_LIMIT
        want = (1, 2) if fits(2) else (1, 1) if fits(1) else (0, 2)
        assert (plan["q_resident"], plan["v_stages"]) == want, tag
    else:
        assert plan["q_resident"] == int(2 * 128 * slabs * SLAB <= 96 * 1024), tag
        assert plan["v_stages"] == 2, tag
    # TMA: boxes of 64 columns (128 bytes, the swizzle's width); the
    # operands' rows (contiguous, or the fold copy's) 16-byte multiples
    for width in (dqk, dv):
        assert (2 * width) % 16 == 0 and SLAB * 2 == 128, tag


@pytest.mark.parametrize("phi", PHIS)
def test_single_plan_fits_and_covers_every_site(phi):
    """The plan of every one-head site of `phi` at both inputs: the split
    form at the folded heads, slices at dark3, and the properties of
    `_check_plan`."""
    for name, kind, _, dqk, dv in _one_head_calls(phi, (640, 640)) + _one_head_calls(
            phi, (480, 576)):
        plan = tattn.single_sm90_plan(dqk, dv)
        _check_plan(dqk, dv, plan, (phi, name, kind))
        assert plan["wg_split"] == int(name != "dark3"), (phi, name)


def test_single_plan_over_the_width_grid():
    """The plan at every pair of widths that are multiples of 8 up to 1,024
    (q/k) and 4,096 (v) on a coarse grid, and at odd sizes around the split
    form's edges: each exists and holds `_check_plan`."""
    widths = sorted({8, 16, 32, 56, 64, 72, 128, 136, 192, 256, 264, 288, 320, 384, 512, 600,
                     640, 648, 1024})
    for dqk in widths:
        for dv in sorted(set(widths) | {2048, 4096}):
            _check_plan(dqk, dv, tattn.single_sm90_plan(dqk, dv), (dqk, dv))


# ---------------------------------------------------------------- tiling
def _next_row_columns(t, width):
    """(N, d) -> (N, width): each row continued past d by the next row's
    first columns (zeros past the last), as a map of the rounded-up width
    would read a contiguous array."""
    n, d = t.shape[-2:]
    flat = torch.cat([t.reshape(-1), torch.zeros(width, dtype=t.dtype)])
    return flat[torch.arange(n)[:, None] * d + torch.arange(width)[None, :]]


def _single_tiling(q, k, v, scale, plan, fault=None):
    """out, lse as the one-head form computes them for one image ((N, d)
    operands): q and k in 64-column slabs zero-filled past the width, the
    keys in tiles of the plan's `keys`, v in the plan's slices (sliced) or
    warpgroup halves (split), each computed on the same S and stored over
    its columns, lse from the first. `fault`: "tile_twice" (key tile 1 read
    again in place of tile 2), "slab_dropped" (q/k slab 1, or the only one,
    left out of S), "pad_nonzero" (the columns past the widths the next
    row's), "slice_from_other" (the second v slice or half written from the
    first one's P V)."""
    n, dqk = q.shape
    dv = v.shape[-1]
    keys, vs = plan["keys"], plan["v_slice"]
    cols = -(-dqk // SLAB) * SLAB
    parts = (2 if plan["wg_split"] else 1) * plan["dv_splits"]
    if fault == "pad_nonzero":
        qp, kp = _next_row_columns(q, cols), _next_row_columns(k, cols)
    else:
        qp, kp = (torch.nn.functional.pad(t, (0, cols - dqk)) for t in (q, k))
    vp = torch.nn.functional.pad(v, (0, parts * vs - dv))
    if fault == "slab_dropped":
        s0 = SLAB if cols > SLAB else 0
        qp = qp.clone()
        qp[:, s0:s0 + SLAB] = 0
    if fault == "tile_twice":
        kp, vp = kp.clone(), vp.clone()
        kp[2 * keys:3 * keys], vp[2 * keys:3 * keys] = kp[keys:2 * keys], vp[keys:2 * keys]
    outs, lse = [], None
    for j in range(parts):
        c0 = (0 if fault == "slice_from_other" and j == 1 else j) * vs
        o, l_j = tattn._online_softmax(qp, kp, vp[:, c0:c0 + vs], scale, block_k=keys)
        outs.append(o)
        lse = l_j if lse is None else lse
    return torch.cat(outs, dim=-1)[:, :dv], lse


# (q/k width, v width, real width of the folded head or None)
TILING_CASES = {"phi=n dark3": (32, 256, None), "phi=s dark3": (64, 512, None),
                "phi=n h1 folded": (288, 288, 283), "phi=m h1 folded": (600, 600, 599)}
FAULTS = ("tile_twice", "slab_dropped", "pad_nonzero", "slice_from_other")


def _case_inputs(case, dtype):
    dqk, dv, real = TILING_CASES[case]
    d = real or dqk
    scale = d ** -0.5 if real else 1.0
    rng = np.random.default_rng(7)
    std = (2.0 / (scale * d ** 0.5)) ** 0.5
    q, k = (rng.standard_normal((1, N_RAGGED, dqk)).astype(np.float32) * std for _ in range(2))
    v = rng.standard_normal((1, N_RAGGED, dv)).astype(np.float32)
    if real:  # the fold copy's zero columns
        for a in (q, k, v):
            a[..., real:] = 0
    j = [jnp.asarray(a).astype(dtype) for a in (q, k, v)]
    t = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(getattr(torch, dtype)) for a in j]
    return j, t, scale, real


def _applies(fault, plan, dqk, dv):
    """Faults that a plan can commit: zero-filled columns only past a width
    that is not a multiple of 64, another slice's P V only with two."""
    if fault == "pad_nonzero":
        return dqk % SLAB != 0
    if fault == "slice_from_other":
        return (2 if plan["wg_split"] else 1) * plan["dv_splits"] > 1
    return True


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(TILING_CASES))
def test_single_tiling_matches_pallas_lse(case, dtype):
    """The training form (out and lse) of the one-head plan's tiling against
    flash_fwd_lse with one head in the Pallas interpreter at N = 1,100:
    out within MAX_REL of max|ref|, lse within LSE_ABS; each fault the plan
    can commit misses one of the two bars."""
    j, t, scale, _ = _case_inputs(case, dtype)
    dqk, dv = TILING_CASES[case][:2]
    jvjp.INTERPRET = True
    jattn._diff_flash.cache_clear()
    try:
        ref_out, ref_lse = jvjp.flash_fwd_lse(*j, scale, *PALLAS_BLOCKS, 1)
    finally:
        jvjp.INTERPRET = False
        jattn._diff_flash.cache_clear()
    ref_out, ref_lse = np.asarray(ref_out, np.float32)[0], np.asarray(ref_lse)[0]
    bar, lse_bar = MAX_REL[dtype], LSE_ABS[dtype]
    plan = tattn.single_sm90_plan(dqk, dv)
    q, k, v = (x[0] for x in t)
    out, lse = _single_tiling(q, k, v, scale, plan)
    assert out.shape == (N_RAGGED, dv) and tuple(lse.shape) == ref_lse.shape == (N_RAGGED, 1)
    assert _rel(out.float().numpy(), ref_out) <= bar
    assert float(np.abs(lse.numpy() - ref_lse).max()) <= lse_bar
    tried = 0
    for fault in FAULTS:
        if not _applies(fault, plan, dqk, dv):
            continue
        tried += 1
        fout, flse = _single_tiling(q, k, v, scale, plan, fault)
        missed = (_rel(fout.float().numpy(), ref_out) > bar
                  or float(np.abs(flse.numpy() - ref_lse).max()) > lse_bar)
        assert missed, fault
    assert tried >= 2, case
    # the wrapper's CPU path: the plain version, the same layout
    wout, wlse = tvjp.flash_fwd_lse(*t, scale, 1)
    assert _rel(wout[0].float().numpy(), ref_out) <= bar
    assert float((wlse[0] - lse).abs().max()) <= lse_bar


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(TILING_CASES))
def test_single_tiling_matches_jax_serving(case, dtype):
    """The serving form of the same tiling against the function
    flash_attention_pallas computes, JAX's softmax(q k^T scale) v in fp32 on
    the same (rounded) inputs, at N = 1,100 within MAX_REL; each fault the
    plan can commit misses the bar on out (the key tile read twice and the
    other slice's P V on the serving output; the rest as above)."""
    j, t, scale, real = _case_inputs(case, dtype)
    dqk, dv = TILING_CASES[case][:2]
    ref = np.asarray(jattn.reference_attention(*(x.astype(jnp.float32) for x in j), scale),
                     np.float32)[0]
    bar = MAX_REL[dtype]
    plan = tattn.single_sm90_plan(dqk, dv)
    q, k, v = (x[0] for x in t)
    out = _single_tiling(q, k, v, scale, plan)[0]
    assert _rel(out.float().numpy(), ref) <= bar
    for fault in FAULTS:
        if _applies(fault, plan, dqk, dv):
            fout = _single_tiling(q, k, v, scale, plan, fault)[0]
            assert _rel(fout.float().numpy(), ref) > bar, fault
    # the wrapper's CPU path, through the route that reaches it: the folded
    # heads at their real width (padded by the wrapper), dark3 as it is
    if real:
        sl = [x[..., :real].contiguous() for x in t]
        wout = tattn.flash_single(*sl, scale)
        assert _rel(wout[0].float().numpy(), ref[:, :real]) <= bar
    else:
        assert _rel(tattn.flash_single(*t, scale)[0].float().numpy(), ref) <= bar


def test_single_wrappers_never_fall_back_off_cpu():
    """flash_single and flash_fwd_lse with one head (dark3 of phi 's', the
    folded 600) on tensors that are neither on the CPU nor on a card raise
    before any library is built; they count nothing, and
    reset_launch_counts clears the one-head counters."""
    tattn.flash_single.sm90_launches = 5
    tvjp.flash_fwd_lse.single_launches = 5
    tattn.reset_launch_counts()
    tvjp.reset_launch_counts()
    counters = lambda: (tattn.flash_single.sm90_launches, tvjp.flash_fwd_lse.single_launches,
                        tvjp.flash_fwd_lse.launches)
    assert counters() == (0, 0, 0)
    for dqk, dv in ((64, 512), (600, 600)):
        assert tattn.single_fwd_form(dqk, dv, torch.bfloat16) == "single_sm90"
        meta = lambda w: torch.empty((1, 1600, w), dtype=torch.bfloat16, device="meta")
        q, k, v = meta(dqk), meta(dqk), meta(dv)
        with pytest.raises(ValueError, match="CUDA tensor"):
            tattn.flash_single(q, k, v, 1.0)
        with pytest.raises(ValueError, match="CUDA tensor"):
            tvjp.flash_fwd_lse(q, k, v, 1.0, 1)
    assert counters() == (0, 0, 0)
    # the CPU path is the plain version, uncounted
    x = torch.randn(1, 1100, 64).bfloat16()
    y = torch.randn(1, 1100, 512).bfloat16()
    assert torch.equal(tattn.flash_single(x, x, y, 1.0), tattn.flash_single_plain(x, x, y, 1.0))
    assert counters() == (0, 0, 0)
