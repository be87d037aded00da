"""The bf16 one-head flash backward for Hopper
(csrc/flash_bwd_single_sm90.cu), on the CPU.

The kernels cannot run here; what is held here is what surrounds them:
  * the rule (`attention_vjp.bwd_form`): at every scale (phi 'n' to 'x')
    and at 640x640 and 480x576, every bf16 one-head training site of phi
    'n', 's' and 'm' (dark3, q/k 32 to 128 and v 256 to 1,024; the folded
    heads of 288 and 600) takes the one-head kernels, dark3 of phi 'l' and
    'x' keeps the template, packed heads keep their own kernels, fp32 the
    fp32 kernels;
  * the launch plans (`attention_vjp.bwd_single_sm90_plan`) at every such
    site: shared memory recomputed here within 227 KB with the most ring
    stages that fit (three at least on tiles of 128 tokens), the blocks'
    rows covering N, the two warpgroups' contraction slabs (q/k's, then
    v's) covering both widths with all of q/k's on warpgroup 0, their
    output slabs and the dv slices covering the gradients' columns (at most
    five slabs, 160 registers, a warpgroup), every wgmma N a multiple of 8
    up to 256, the TMA boxes and strides;
  * the kernels' tiling, emulated in plain PyTorch at the plans' tiles (64
    rows a block, tiles of the plan's 64 or 128 tokens, 64-column slabs
    zero-filled past the width, the contraction's two parts added in the
    kernel's order, dk/dv as a DK block and the DV slices' blocks), against
    the Pallas backward (flash_bwd with one head) in the Pallas interpreter
    at N = 1,100 (ragged against every tile) and the widths of dark3 at phi
    'n' and 's' and of the folded h1 of phi 'n', within MAX_REL of each
    gradient's max|ref|;
    each fault of the design misses that bar: a key tile read twice in dq
    and a query tile read twice in dk/dv (each neighbour never read), one v
    slab left out of dP^T, a dV column slice built from another slice's dO
    columns, the zero-filled columns past the width made nonzero (the next
    row's, as a map of the rounded-up width would read them), dS^T formed
    with the previous query tile's P^T;
  * the wrappers: off the CPU on the new route they launch or raise, never
    fall back, and `reset_launch_counts` clears their counters.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import transparent_object_detection_tpu.ops.attention as jattn
import transparent_object_detection_tpu.ops.attention_vjp as jvjp
from test_torch_flash_bwd_sm90 import MAX_REL, N_RAGGED, PALLAS_BLOCKS, WGMMA_N_MAX, _rel, \
    _training_calls
from test_torch_flash_sm90 import INPUTS, PHIS
from transparent_object_detection_tpu_torch.ops import attention as tattn
from transparent_object_detection_tpu_torch.ops import attention_vjp as tvjp

torch.set_num_threads(1)

SLAB = 64
SLAB_BYTES = SLAB * SLAB * 2
MAX_OUT_SLABS = 5  # output slabs a warpgroup accumulates (160 fp32 registers)


def _single_sites():
    return [(phi, hw, *call) for phi in PHIS for hw in INPUTS
            for call in _training_calls(phi, hw) if call[5] == 1]


@pytest.mark.parametrize("phi", PHIS)
def test_single_form_at_every_training_site(phi):
    """bf16 one-head sites of phi 'n', 's' and 'm' (dark3 and the folded
    heads) take the one-head kernels; dark3 of phi 'l' and 'x' takes the
    wide kernels; packed heads the packed sm90 kernels or the wide ones;
    fp32 takes the fp32 kernels."""
    dark3 = {"n": (32, 256), "s": (64, 512), "m": (128, 1024), "l": (256, 2048),
             "x": (512, 4096)}
    folded = {"n": 288, "m": 600}
    for hw in INPUTS:
        for name, route, n, dq, dv, heads in _training_calls(phi, hw):
            form = tvjp.bwd_form(dq, dv, heads, torch.bfloat16)
            tag = (hw, name, route, dq, dv, heads)
            if route == "single":
                assert (dq, dv) == dark3[phi], tag
                assert form == ("wide_sm90" if phi in ("l", "x") else "single_sm90"), tag
            elif route == "folded":
                assert (dq, dv, heads) == (folded[phi], folded[phi], 1), tag
                assert form == "single_sm90", tag
            else:
                assert heads > 1 and form in ("sm90", "wide_sm90"), tag
            assert tvjp.bwd_form(dq, dv, heads, torch.float32) == "f32_sm90", tag


def test_single_form_off_the_routed_widths():
    """Widths that share the forms of the training sites (dark3's of phi
    'n' to 'm', the folded heads') take the one-head kernels with one head
    only; v narrower than q/k, plans that do not fit (phi 'l' dark3) or
    that the library has no instantiation for take the wide kernels; the
    plan refuses what the rule refuses."""
    for dq, dv in ((64, 256), (128, 512), (296, 296), (576, 576), (640, 640)):
        assert tvjp.bwd_form(dq, dv, 1, torch.bfloat16) == "single_sm90", (dq, dv)
        assert tvjp.bwd_form(dq, dv, 2, torch.bfloat16) != "single_sm90", (dq, dv)
    for dq, dv in ((648, 648), (256, 128), (256, 2048), (64, 320), (0, 64), (60, 64),
                   (8, 8), (256, 256)):
        assert tvjp.bwd_form(dq, dv, 1, torch.bfloat16) == "wide_sm90", (dq, dv)
        with pytest.raises(ValueError):
            tvjp.bwd_single_sm90_plan(dq, dv)


@pytest.mark.parametrize("phi", ("n", "s", "m"))
def test_single_plans_fit_and_cover_every_site(phi):
    """The dq and dk/dv plans of every one-head site of `phi`: shared memory
    recomputed here within 227 KB with the most stages (2 to 8 a ring) that
    fit; 64-row blocks covering N; the contraction split giving warpgroup 0
    every q/k slab and warpgroup 1 the rest of v's; output slabs and dv
    slices covering each gradient's columns once, at most five slabs a
    warpgroup; every product m64n64k16; 64 x 64 TMA boxes of 128-byte rows on
    maps whose strides are multiples of 16 bytes."""
    found = [s for s in _single_sites() if s[0] == phi]
    assert found, phi
    for _, hw, name, route, n, dqk, dv, _ in found:
        plans = tvjp.bwd_single_sm90_plan(dqk, dv)
        qs, vs = -(-dqk // SLAB), -(-dv // SLAB)
        for kernel, plan in plans.items():
            tag = (hw, name, kernel)
            assert set(plan) == set(tvjp.SINGLE_BWD_PLAN_KEYS), tag
            assert plan["rows"] == plan["slab"] == SLAB, tag
            assert (plan["qk_slabs"], plan["v_slabs"]) == (qs, vs), tag
            # [columns] the last slab reaches past the width by less than a slab
            assert qs * SLAB >= dqk > (qs - 1) * SLAB and vs * SLAB >= dv > (vs - 1) * SLAB, tag
            blocks = -(-n // SLAB)
            assert blocks * SLAB >= n > (blocks - 1) * SLAB, tag
            tile = plan["tile"]
            assert tile in (64, 128), tag
            entry = tile * SLAB * 2  # a ring entry: tile rows of one slab
            smem = 3072 + (qs + vs) * SLAB_BYTES + 64 * tile * 4 + 2 * plan["stages"] * entry
            assert plan["smem_bytes"] == smem <= tattn.SM90_SMEM_LIMIT, tag
            assert 2 <= plan["stages"] <= tvjp.SINGLE_BWD_MAX_STAGES, tag
            assert plan["stages"] == tvjp.SINGLE_BWD_MAX_STAGES or \
                smem + 2 * entry > tattn.SM90_SMEM_LIMIT, tag
            assert tile == 64 or plan["stages"] >= 3, tag
            # contraction: warpgroup 0 slabs [0, split) hold all of q/k's,
            # warpgroup 1 [split, qs + vs) is not empty
            assert qs <= plan["split"] < qs + vs, tag
            # output slabs of dQ or dK, two halves, the first the larger
            g = plan["out_slabs"]
            halves = [range(0, g), range(g, qs)]
            assert sorted(c for r in halves for c in r) == list(range(qs)), tag
            assert all(len(r) <= MAX_OUT_SLABS for r in halves), tag
            if kernel == "dkv":  # dV: slices of equal slabs, each in two halves
                slices, sw = plan["slices"], plan["slice_slabs"]
                assert slices * sw >= vs > (slices - 1) * sw, tag
                cover = []
                for s in range(slices):
                    s0, sn = s * sw, min(sw, vs - s * sw)
                    h = -(-sn // 2)
                    assert max(h, sn - h) <= MAX_OUT_SLABS, tag
                    cover += list(range(s0, s0 + sn))
                assert cover == list(range(vs)), tag
            else:
                assert plan["slices"] == plan["slice_slabs"] == 0, tag
            assert SLAB % 8 == 0 and SLAB <= WGMMA_N_MAX, tag  # every product is m64n64k16
        # TMA: boxes of 64 columns (128 bytes, the swizzle's span) x 64 rows;
        # the operands' rows (the fold copy's, or dark3's contiguous ones)
        # 16-byte multiples
        for width in (dqk, dv):
            assert (width * 2) % 16 == 0 and SLAB * 2 == 128, (hw, name, width)


# ---------------------------------------------------------------- tiling
def _slabbed(t, slabs, pad_fault=False):
    """(N, d) -> (N, slabs * 64) as a 64 x 64 TMA box lands it: zero-filled
    past d, or (`pad_fault`) holding the next row's first columns, as a map
    of the rounded-up width would read a contiguous array."""
    n, d = t.shape
    width = slabs * SLAB
    if width == d:
        return t
    if not pad_fault:
        return torch.nn.functional.pad(t, (0, width - d))
    flat = torch.cat([t.reshape(-1), torch.zeros(width, dtype=t.dtype)])
    return flat[torch.arange(n)[:, None] * d + torch.arange(width)[None, :]]


def _tiles(n, tile, fault):
    tiles = list(range(-(-n // tile)))
    if fault == "tile_twice":  # tile 1 read again in place of tile 2
        tiles[2] = 1
    return tiles


def _probs(s, lse, scale):
    return torch.exp2(s * (scale * tattn.LOG2E) - lse * tattn.LOG2E)


def _dq_single(q, k, v, do, lse, dcap, scale, plan, fault=None):
    """dq as flash_bwd_dq_single_kernel forms it for one image ((N, d)
    operands, lse and D (N, 1)): per key tile (the plan's), S = Q K^T on the q/k
    slabs, dP = dO V^T as warpgroup 0's v slabs [0, split - qs) plus
    warpgroup 1's rest, dS = P (dP - D) scale cast to the input type, dQ +=
    dS K. `fault`: "tile_twice", "pad_nonzero"."""
    n, dqk = q.shape
    qs, vs, split = plan["qk_slabs"], plan["v_slabs"], plan["split"]
    pad = fault == "pad_nonzero"
    qp, kp = (_slabbed(t, qs, pad).float() for t in (q, k))
    vp, dop = (_slabbed(t, vs, pad).float() for t in (v, do))
    cy, tile = (split - qs) * SLAB, plan["tile"]
    dq = torch.zeros(n, qs * SLAB)
    for t in _tiles(n, tile, fault):
        keys = slice(t * tile, (t + 1) * tile)
        kb, vb = kp[keys], vp[keys]
        s = qp @ kb.T
        dp = dop[:, cy:] @ vb[:, cy:].T
        if cy:
            dp = dop[:, :cy] @ vb[:, :cy].T + dp
        ds = _probs(s, lse, scale) * (dp - dcap) * scale
        dq += ds.to(q.dtype).float() @ kb
    return dq[:, :dqk]


def _dkv_single(q, k, v, do, lse, dcap, scale, plan, fault=None):
    """dk, dv as flash_bwd_dkv_single_kernel forms them for one image: per
    key block of 64, the DK block (S^T = K Q^T on the q/k slabs, dP^T = V dO^T
    in two parts as in dq, dS^T cast, dK += dS^T Q) and one DV block a
    slice of v (S^T again, as warpgroup 0's q/k slabs [0, qs / 2) plus
    warpgroup 1's rest; P^T cast; dV[:, slice] += P^T dO[:, slice]), query
    tile (the plan's) after query tile. `fault`: "tile_twice", "pad_nonzero",
    "v_slab_dropped" (v's slab 1 out of dP^T), "dv_slice_from_other" (the
    second slice, or with one slice warpgroup 1's half, from the first
    one's dO columns), "stale_p" (dS^T from the previous tile's P^T)."""
    n, dqk = q.shape
    dvw = v.shape[1]
    qs, vs, split = plan["qk_slabs"], plan["v_slabs"], plan["split"]
    slices, sw = plan["slices"], plan["slice_slabs"]
    pad = fault == "pad_nonzero"
    qp, kp = (_slabbed(t, qs, pad).float() for t in (q, k))
    vp, dop = (_slabbed(t, vs, pad).float() for t in (v, do))
    vd = vp.clone()
    if fault == "v_slab_dropped":
        vd[:, SLAB:2 * SLAB] = 0
    cy, cx, tile = (split - qs) * SLAB, qs // 2 * SLAB, plan["tile"]
    tiles = _tiles(n, tile, fault)
    dk, dv = torch.zeros(n, qs * SLAB), torch.zeros(n, vs * SLAB)
    # dV's column ranges: (written, read) per slice half
    halves = []
    for s in range(slices):
        s0, sn = s * sw, min(sw, vs - s * sw)
        h = -(-sn // 2)
        halves += [((s0, s0 + h), (s0, s0 + h)), ((s0 + h, s0 + sn), (s0 + h, s0 + sn))]
    if fault == "dv_slice_from_other":
        if slices > 1:
            (w0, w1), _ = halves[2]
            halves[2] = ((w0, w1), (0, w1 - w0))
        else:
            (w0, w1), _ = halves[1]
            halves[1] = ((w0, w1), (0, w1 - w0))
    for k0 in range(0, n, SLAB):
        kb, vb, vdb = kp[k0:k0 + SLAB], vp[k0:k0 + SLAB], vd[k0:k0 + SLAB]
        prev = None
        for t in tiles:  # the DK block
            rows = slice(t * tile, (t + 1) * tile)
            qb, dob = qp[rows], dop[rows]
            pt = _probs(kb @ qb.T, lse[rows].T, scale)
            dpt = vdb[:, cy:] @ dob[:, cy:].T
            if cy:
                dpt = vdb[:, :cy] @ dob[:, :cy].T + dpt
            p_ds = prev if (fault == "stale_p" and prev is not None) else pt
            prev = pt
            dst = p_ds[:, :pt.shape[1]] * (dpt - dcap[rows].T) * scale
            dk[k0:k0 + SLAB] += dst.to(q.dtype).float() @ qb
        for t in tiles:  # the DV blocks (every slice recomputes S^T alike)
            rows = slice(t * tile, (t + 1) * tile)
            qb, dob = qp[rows], dop[rows]
            st = kb[:, cx:] @ qb[:, cx:].T
            if cx:
                st = kb[:, :cx] @ qb[:, :cx].T + st
            pt = _probs(st, lse[rows].T, scale).to(do.dtype).float()
            for (w0, w1), (r0, r1) in halves:
                if w1 > w0:
                    dv[k0:k0 + SLAB, w0 * SLAB:w1 * SLAB] += pt @ dob[:, r0 * SLAB:r1 * SLAB]
    return dk[:, :dqk], dv[:, :dvw]


# (q/k width, v width, real width of the folded head or None, scale)
TILING_CASES = {"phi=n dark3": (32, 256, None), "phi=s dark3": (64, 512, None),
                "phi=n h1 folded": (288, 288, 283)}
FAULTS = {"dq": ("tile_twice", "pad_nonzero"),
          "dkv": ("tile_twice", "pad_nonzero", "v_slab_dropped", "dv_slice_from_other",
                  "stale_p")}


@pytest.mark.parametrize("case", sorted(TILING_CASES))
def test_single_tiling_matches_pallas_bwd(case):
    """dq, dk and dv of the kernels' tiling (bf16) against the Pallas
    backward with one head in the Pallas interpreter (both given JAX's lse
    and D) at N = 1,100, within MAX_REL of each gradient's max|ref|; each
    fault of the design misses that bar on a gradient it touches (the
    zero-fill fault where a width is not a multiple of 64)."""
    dqk, dv, real = TILING_CASES[case]
    d = real or dqk
    scale = d ** -0.5 if real else 1.0
    rng = np.random.default_rng(5)
    std = (1.5 / (scale * d ** 0.5)) ** 0.5
    q, k = (rng.standard_normal((1, N_RAGGED, dqk)).astype(np.float32) * std for _ in range(2))
    v, g = (rng.standard_normal((1, N_RAGGED, dv)).astype(np.float32) for _ in range(2))
    if real:  # the fold copy's zero columns
        for a in (q, k, v, g):
            a[..., real:] = 0
    jq, jk, jv, jg = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v, g))
    jvjp.INTERPRET = True
    jattn._diff_flash.cache_clear()
    try:
        out, lse = jvjp.flash_fwd_lse(jq, jk, jv, scale, *PALLAS_BLOCKS, 1)
        dcap = jvjp.compute_dcap(out, jg, 1)
        ref = jvjp.flash_bwd(jq, jk, jv, jg, lse, dcap, scale, *PALLAS_BLOCKS, 1)
    finally:
        jvjp.INTERPRET = False
        jattn._diff_flash.cache_clear()
    ref = dict(zip(("dq", "dk", "dv"), (np.asarray(r, np.float32)[0] for r in ref)))
    tq, tk, tv, tg = (torch.from_numpy(np.array(a, np.float32)[0]).bfloat16()
                      for a in (jq, jk, jv, jg))
    tlse = torch.from_numpy(np.array(lse, np.float32)[0])
    tdcap = torch.from_numpy(np.array(dcap, np.float32)[0])
    assert tuple(tlse.shape) == (N_RAGGED, 1)
    plans = tvjp.bwd_single_sm90_plan(dqk, dv)
    bar = MAX_REL["bfloat16"]
    cast = lambda t: t.bfloat16().float().numpy()

    def grads(fault=None):
        got = {}
        if fault in FAULTS["dq"] or fault is None:
            got["dq"] = cast(_dq_single(tq, tk, tv, tg, tlse, tdcap, scale, plans["dq"], fault))
        if fault in FAULTS["dkv"] or fault is None:
            dk, dvv = _dkv_single(tq, tk, tv, tg, tlse, tdcap, scale, plans["dkv"], fault)
            got["dk"], got["dv"] = cast(dk), cast(dvv)
        return got

    for name, val in grads().items():
        assert val.shape == ref[name].shape, name
        assert _rel(val, ref[name]) <= bar, (name, _rel(val, ref[name]))
    padded = dqk % SLAB or dv % SLAB
    for fault in sorted(set(FAULTS["dq"]) | set(FAULTS["dkv"])):
        if fault == "pad_nonzero" and not padded:
            continue
        got = grads(fault)
        for kernel, names in (("dq", ("dq",)), ("dkv", ("dk", "dv"))):
            if fault in FAULTS[kernel]:
                worst = max(_rel(got[name], ref[name]) for name in names)
                assert worst > bar, (fault, kernel, worst)
    # the wrappers' CPU path (the plain versions) within the same bar
    wdq = tvjp.flash_bwd_dq(tq[None], tk[None], tv[None], tg[None], tlse[None], tdcap[None],
                            scale)
    wdk, wdv = tvjp.flash_bwd_dkv(tq[None], tk[None], tv[None], tg[None], tlse[None],
                                  tdcap[None], scale)
    for name, val in (("dq", wdq), ("dk", wdk), ("dv", wdv)):
        assert _rel(val[0].float().numpy(), ref[name]) <= bar, name


def test_single_dv_slices_against_plain():
    """phi='m' dark3's widths (q/k 128, v 1,024: two dv slices, warpgroup 0
    in five of dP's sixteen v slabs) at N = 200: the tiling against the
    plain backward within MAX_REL, and a dV slice built from the other
    slice's dO columns, or a v slab left out of dP^T, misses it."""
    gen = torch.Generator().manual_seed(11)
    n, dqk, dv = 200, 128, 1024
    q, k = ((torch.randn(1, n, dqk, generator=gen) * 0.3).bfloat16() for _ in range(2))
    v, do = (torch.randn(1, n, dv, generator=gen).bfloat16() for _ in range(2))
    out, lse = tvjp.flash_fwd_lse_plain(q, k, v, 1.0)
    dcap = tvjp.compute_dcap(out, do)
    ref = {"dq": tvjp.flash_bwd_dq_plain(q, k, v, do, lse, dcap, 1.0)}
    ref["dk"], ref["dv"] = tvjp.flash_bwd_dkv_plain(q, k, v, do, lse, dcap, 1.0)
    plans = tvjp.bwd_single_sm90_plan(dqk, dv)
    assert (plans["dkv"]["slices"], plans["dkv"]["slice_slabs"], plans["dq"]["split"]) == \
        (2, 8, 7)
    args = (q[0], k[0], v[0], do[0], lse[0], dcap[0], 1.0)
    bar = MAX_REL["bfloat16"]
    got = {"dq": _dq_single(*args, plans["dq"])}
    got["dk"], got["dv"] = _dkv_single(*args, plans["dkv"])
    rel = lambda a, name: _rel(a.bfloat16().float().numpy(), ref[name][0].float().numpy())
    for name, val in got.items():
        assert rel(val, name) <= bar, (name, rel(val, name))
    assert rel(_dkv_single(*args, plans["dkv"], "dv_slice_from_other")[1], "dv") > bar
    assert rel(_dkv_single(*args, plans["dkv"], "v_slab_dropped")[0], "dk") > bar


def test_single_wrappers_never_fall_back_off_cpu():
    """flash_bwd_dq and flash_bwd_dkv with one head on the new route (dark3
    of phi 's', the folded 600) on tensors that are neither on the CPU nor
    on a card raise before any library is built; they count nothing, and
    reset_launch_counts clears their one-head counters."""
    for fn in (tvjp.flash_bwd_dq, tvjp.flash_bwd_dkv):
        fn.single_launches = 5
    tvjp.reset_launch_counts()
    for fn in (tvjp.flash_bwd_dq, tvjp.flash_bwd_dkv):
        assert fn.single_launches == 0
    for dqk, dv in ((64, 512), (600, 600)):
        assert tvjp.bwd_form(dqk, dv, 1, torch.bfloat16) == "single_sm90"
        meta = lambda w: torch.empty((1, 1600, w), dtype=torch.bfloat16, device="meta")
        q, k, v, do = meta(dqk), meta(dqk), meta(dv), meta(dv)
        lse = dcap = torch.empty((1, 1600, 1), dtype=torch.float32, device="meta")
        for fn in (tvjp.flash_bwd_dq, tvjp.flash_bwd_dkv):
            with pytest.raises(ValueError, match="CUDA tensor"):
                fn(q, k, v, do, lse, dcap, 1.0, 1)
    for fn in (tvjp.flash_bwd_dq, tvjp.flash_bwd_dkv):
        assert fn.single_launches == 0 and fn.wide_launches == 0
