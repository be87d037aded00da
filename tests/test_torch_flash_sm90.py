"""The bf16 packed forward for Hopper (csrc/flash_fwd_sm90.cu), on the CPU.

The kernel cannot run here; what is held here is what surrounds it:
  * the dispatch rule (`attention.packed_fwd_form`, `attention_vjp.
    lse_fwd_form`): at every scale (phi 'n' to 'x') and at 640x640 and
    480x576, every packed serving and training site takes the sm90 kernel
    in bf16 and the fp32 Hopper kernel (csrc/flash_fwd_f32_sm90.cu) in
    fp32; widths that are multiples of 8 but not of 64 stay on the mma_sync
    template; single-head and folded sites keep their routes and, in bf16
    training, the one-head form of the sm90 kernel
    (tests/test_torch_flash_single_sm90.py);
  * the launch plan (`attention.sm90_plan`), computed in Python and handed
    to the launcher, at every routed site: it fits the card's 227 KB of
    dynamic shared memory, its slabs cover q/k exactly and its v slices (or
    warpgroup halves) cover v with none starting past it, and every wgmma N
    is a multiple of 8 and at most 256;
  * the kernel's tiling: the plain versions run with the plan's key tile
    against the Pallas kernels in the Pallas interpreter, at N = 1,100
    (ragged against every tile), 2 heads of 128 and of 256, in fp32 and
    bf16, with bars relative to max|ref| (MAX_REL, LSE_ABS) that a key tile
    left out or read twice misses.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import transparent_object_detection_tpu.ops.attention as jattn
import transparent_object_detection_tpu.ops.attention_vjp as jvjp
from transparent_object_detection_tpu_torch.config import SCALE_TABLE
from transparent_object_detection_tpu_torch.models import blocks as tb
from transparent_object_detection_tpu_torch.ops import attention as tattn
from transparent_object_detection_tpu_torch.ops import attention_vjp as tvjp

torch.set_num_threads(1)

PHIS = ("n", "s", "m", "l", "x")
INPUTS = ((640, 640), (480, 576))
# bars relative to max|ref|: fp32 2e-4 (the port's fp32 bar: summation order
# and exp vs exp2 only); bf16 1e-2 (p and the output rounded to bf16 at other
# points: 3.0e-3 measured). A key tile left out or read twice moves the
# output by 0.44-0.72 of max|ref| at these shapes. lse: 1e-4 in fp32 (the
# attention_vjp tests' bar), 1e-3 in bf16.
MAX_REL = {"float32": 2e-4, "bfloat16": 1e-2}
LSE_ABS = {"float32": 1e-4, "bfloat16": 1e-3}
WGMMA_N_MAX = 256
# (block_q, block_k) of the Pallas kernels, which take only blocks that
# divide N: 1,100 = 5 x 220 = 11 x 100
PALLAS_BLOCKS = (220, 100)


def sites(phi: str, hw=(640, 640)):
    """{site: (N, q/k width, v width, heads, packed qkv input)} of the
    attention calls of one forward (the neck's heads as the TEB picks them),
    as tests/test_torch_scales.py builds them."""
    c, _, mul = SCALE_TABLE[phi]
    c5 = int(c * 16 * mul)
    h, w = hw
    n8, n16, n32 = (h // 8) * (w // 8), (h // 16) * (w // 16), (h // 32) * (w // 32)
    out = {"dark3": (n8, max(4 * c // 8, 1), 4 * c, 1, False)}
    for name, n, ch in (("h1", n16, c5 + 8 * c), ("h2", n8, 12 * c), ("h4", n16, 12 * c),
                        ("h6", n32, 8 * c + c5)):
        out[name] = (n, ch, ch, tb._pick_num_heads(ch, 8), True)
    return out


def _packed_sites(phi):
    """(tag, N, q/k head width, v head width, heads) of every site a packed
    route reaches at `phi`, serving or training, at both inputs."""
    out = []
    for hw in INPUTS:
        for name, (n, cq, cv, heads, packed) in sites(phi, hw).items():
            serving = packed and tattn.serving_route(n, cq, heads, cv, packed=True)[0] == "packed"
            training = tattn.train_route(n, cq, heads, cv) == "packed"
            if serving or training:
                out.append((f"{hw} {name}", n, cq // heads, cv // heads, heads))
    return out


@pytest.mark.parametrize("phi", PHIS)
def test_dispatch_rule_routes_every_packed_site(phi):
    """Every packed site takes the sm90 kernel in bf16 and the fp32 Hopper
    kernel (f32_sm90) in fp32, serving and training; the single-head and
    folded sites keep their routes and, in bf16 training, the one-head form
    of the sm90 kernel (single_sm90)."""
    packed = _packed_sites(phi)
    assert packed, f"phi={phi}: no packed site"
    for tag, _, dqk, dv, heads in packed:
        assert dqk % tattn.PACKED_HEAD_MULTIPLE == 0, tag
        assert tattn.packed_fwd_form(dqk, torch.bfloat16) == "sm90", tag
        assert tattn.packed_fwd_form(dqk, torch.float32) == "f32_sm90", tag
        assert tvjp.lse_fwd_form(dqk, dv, heads, torch.bfloat16) == "sm90", tag
        assert tvjp.lse_fwd_form(dqk, dv, heads, torch.float32) == "f32_sm90", tag
    for hw in INPUTS:
        for name, (n, cq, cv, heads, packed_in) in sites(phi, hw).items():
            route = tattn.train_route(n, cq, heads, cv)
            if route in ("single", "folded"):
                # one head a call: the fold copy pads the width to a multiple of 8
                d = -(-cq // heads // 8) * 8
                dvh = -(-cv // heads // 8) * 8
                assert tvjp.lse_fwd_form(d, dvh, 1, torch.bfloat16) == "single_sm90", (hw, name)
                assert tattn.serving_route(n, cq, heads, cv, packed=packed_in)[0] == route, \
                    (hw, name)


def test_dispatch_rule_widths_off_the_sm90_grid():
    """Widths that are multiples of 8 but not of 64 stay on the mma_sync
    template, in serving and training; the packed kernel's contract (any
    multiple of 8) is unchanged; the sm90 plan refuses them."""
    for dh in (8, 40, 72, 136, 200, 283 + 5):
        assert tattn.packed_kernel_supports(4 * dh, 4)
        assert tattn.packed_fwd_form(dh, torch.bfloat16) == "mma_sync"
        assert tvjp.lse_fwd_form(dh, dh, 4, torch.bfloat16) == "mma_sync"
    assert tvjp.lse_fwd_form(128, 72, 4, torch.bfloat16) == "mma_sync"  # v off the grid
    assert tattn.packed_fwd_form(64, torch.bfloat16) == "sm90"
    with pytest.raises(ValueError, match="multiples of 64"):
        tattn.sm90_plan(72, 72)
    with pytest.raises(ValueError, match="multiples of 64"):
        tattn.sm90_plan(128, 72)
    # heads wider than two warpgroups' v (512) slice v across blocks
    assert tattn.sm90_plan(768, 768)["wg_split"] == 0
    assert tattn.sm90_plan(256, 256)["wg_split"] == 0  # one warpgroup holds 256


@pytest.mark.parametrize("phi", PHIS)
def test_launch_plan_fits_and_covers_every_site(phi):
    """The plan of every routed site: 64-column q/k slabs that cover q/k
    exactly; v either in slices (multiples of 64, at most 256) across blocks
    of 128 rows (128-key tiles for slices up to 128, else 64), or, for heads
    wider than 256 up to 512 (phi='m' 384), split between the two
    warpgroups of a 64-row block with 64-key tiles,
    covering v with the last slice or half starting inside it; every wgmma
    N a multiple of 8 and at most 256; 1-8 K stages, the most that fit; and
    the shared memory it names (recomputed here) within 227 KB."""
    for tag, _, dqk, dv, _ in _packed_sites(phi):
        plan = tattn.sm90_plan(dqk, dv)
        assert set(plan) == set(tattn.SM90_PLAN_KEYS), tag
        split = plan["wg_split"]
        assert split == int(256 < dv <= 512), tag  # the rule, measured at 384 (PERF.md)
        assert plan["rows"] == (64 if split else 128), tag
        v_slice, splits = plan["v_slice"], plan["dv_splits"]
        keys = plan["keys"]  # 128-key tiles for sliced v slices up to 128
        assert keys == (128 if not split and v_slice <= 128 else 64), tag
        assert plan["slab"] == 64, tag
        assert (dqk // plan["slab"]) * plan["slab"] == dqk, tag
        assert v_slice in (tattn.SM90_SPLIT_V_SLICES if split else tattn.SM90_V_SLICES), tag
        cover = (2 if split else 1) * v_slice  # v columns one block covers
        assert splits * cover >= dv and (splits - 1) * cover < dv, tag
        assert not split or (splits == 1 and v_slice < dv and plan["q_resident"]), tag
        # wgmma N: the key tile for S = Q K^T, the v slice for O += P V
        for n_mma in (keys, v_slice):
            assert n_mma % 8 == 0 and 8 <= n_mma <= WGMMA_N_MAX, tag
        assert 1 <= plan["stages"] <= tattn.SM90_MAX_STAGES, tag
        rows = plan["rows"]
        q_bytes = 2 * rows * dqk if plan["q_resident"] else 0
        stage = 2 * 64 * (keys + (0 if plan["q_resident"] else rows))
        p_bytes = 2 * 2 * 64 * keys if split else 0
        smem = 2048 + q_bytes + plan["stages"] * stage + 2 * 2 * keys * cover + p_bytes
        assert plan["smem_bytes"] == smem <= tattn.SM90_SMEM_LIMIT, tag
        assert plan["stages"] == tattn.SM90_MAX_STAGES or tattn.sm90_smem_bytes(
            dqk, v_slice, plan["stages"] + 1, plan["q_resident"], split, keys) > \
            tattn.SM90_SMEM_LIMIT, tag


def _qkv(seed=0, b=1, n=1100, heads=2, dh=128):
    arr = np.random.default_rng(seed).standard_normal((b, n, 3 * heads * dh)).astype(np.float32)
    return arr, heads, dh ** -0.5


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _tile_faults(k, v, keys):
    """(k, v) with one key tile left out, and with a tile read twice and its
    neighbour never: what a kernel whose ring lost or reused a stage sees."""
    kept = torch.cat([torch.arange(keys), torch.arange(2 * keys, k.shape[-2])])
    k2, v2 = k.clone(), v.clone()
    k2[..., 2 * keys:3 * keys, :], v2[..., 2 * keys:3 * keys, :] = \
        k[..., keys:2 * keys, :], v[..., keys:2 * keys, :]
    return {"tile_dropped": (k[..., kept, :], v[..., kept, :]), "tile_used_twice": (k2, v2)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dh", [128, 256])
def test_kernel_tiling_matches_pallas_packed(monkeypatch, dh, dtype):
    """The serving form's arithmetic at the plan's key tile (128 keys for
    heads of 128, 64 for heads of 256) against flash_attention_mha_packed
    in the Pallas interpreter: N = 1,100 (ragged against every tile), 2
    heads; the bar (relative to max|ref|) rejects a key tile left out or
    read twice."""
    monkeypatch.setattr(jattn, "INTERPRET", True)
    bar = MAX_REL[dtype]
    arr, heads, scale = _qkv(dh=dh)
    c = arr.shape[-1] // 3
    jq = jnp.asarray(arr).astype(dtype)
    tq = torch.from_numpy(arr).to(getattr(torch, dtype))
    ref = np.asarray(jattn.flash_attention_mha_packed(jq, heads, scale, *PALLAS_BLOCKS),
                     np.float32)
    keys = tattn.sm90_plan(c // heads, c // heads)["keys"]
    q, k, v = (tattn._heads_first(t, heads) for t in tq.chunk(3, dim=-1))
    attend = lambda k, v: tattn._heads_last(
        tattn._online_softmax_attention(q, k, v, scale, block_k=keys)).float().numpy()
    out = attend(k, v)
    assert out.shape == (1, 1100, c)
    assert _rel(out, ref) <= bar
    for fault, (fk, fv) in _tile_faults(k, v, keys).items():
        assert _rel(attend(fk, fv), ref) > bar, fault
    # the wrapper's CPU path is the same function at its default tiling
    assert _rel(tattn.flash_mha_packed(tq, heads, scale).float().numpy(), ref) <= bar


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dh", [128, 256])
def test_kernel_tiling_matches_pallas_lse(dh, dtype):
    """The training form's out and lse at the plan's key tile against
    flash_fwd_lse in the Pallas interpreter, same shapes and bars; lse
    within LSE_ABS, which a key tile left out or read twice misses."""
    jvjp.INTERPRET = True
    jattn._diff_flash.cache_clear()
    try:
        arr, heads, scale = _qkv(seed=1, dh=dh)
        c = arr.shape[-1] // 3
        jq = jnp.asarray(arr).astype(dtype)
        ref_out, ref_lse = jvjp.flash_fwd_lse(jq[..., :c], jq[..., c:2 * c], jq[..., 2 * c:],
                                              scale, *PALLAS_BLOCKS, heads)
    finally:
        jvjp.INTERPRET = False
        jattn._diff_flash.cache_clear()
    bar, lse_bar = MAX_REL[dtype], LSE_ABS[dtype]
    ref_out, ref_lse = np.asarray(ref_out, np.float32), np.asarray(ref_lse)
    tq = torch.from_numpy(arr).to(getattr(torch, dtype))
    keys = tattn.sm90_plan(c // heads, c // heads)["keys"]
    q, k, v = (tattn._heads_first(t, heads) for t in tq.chunk(3, dim=-1))
    out, lse = tattn._online_softmax(q, k, v, scale, block_k=keys)
    assert tuple(lse.shape) == ref_lse.shape == (1, heads, 1100, 1)
    assert _rel(tattn._heads_last(out).float().numpy(), ref_out) <= bar
    assert float(np.abs(lse.numpy() - ref_lse).max()) <= lse_bar
    for fault, (fk, fv) in _tile_faults(k, v, keys).items():
        fout, flse = tattn._online_softmax(q, fk, fv, scale, block_k=keys)
        assert _rel(tattn._heads_last(fout).float().numpy(), ref_out) > bar, fault
        assert float(np.abs(flse.numpy() - ref_lse).max()) > lse_bar, fault
    # the wrapper's CPU path: the plain version, the same lse layout
    wout, wlse = tvjp.flash_fwd_lse(tq[..., :c], tq[..., c:2 * c], tq[..., 2 * c:], scale, heads)
    assert float((wlse - lse).abs().max()) <= lse_bar
    assert _rel(wout.float().numpy(), ref_out) <= bar


def test_lse_wrapper_never_falls_back_off_cpu():
    """flash_fwd_lse on a tensor that is neither on the CPU nor on a card
    raises before any library is built, with packed heads the sm90 kernel
    takes and with one head; it counts nothing, and reset_launch_counts
    clears both of its counters."""
    tvjp.flash_fwd_lse.launches = tvjp.flash_fwd_lse.sm90_launches = 5
    tvjp.reset_launch_counts()
    assert tvjp.flash_fwd_lse.launches == 0 and tvjp.flash_fwd_lse.sm90_launches == 0
    qkv = torch.empty((1, 2048, 3 * 256), dtype=torch.bfloat16, device="meta")
    q, k, v = qkv[..., :256], qkv[..., 256:512], qkv[..., 512:]
    with pytest.raises(ValueError, match="CUDA tensor"):
        tvjp.flash_fwd_lse(q, k, v, 0.1, 2)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tvjp.flash_fwd_lse(q, k, v, 0.1, 1)
    assert tvjp.flash_fwd_lse.launches == 0 and tvjp.flash_fwd_lse.sm90_launches == 0
