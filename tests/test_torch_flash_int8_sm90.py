"""The int8 flash forward for Hopper (csrc/flash_int8_sm90.cu), on the CPU.

The kernel cannot run here; what is held here is what surrounds it:
  * the form rule (`attention_int8.int8_fwd_form`, one per entry point): at
    every int8 site of phi 'n' to 'x' at 640x640 and 480x576 (the route
    table's widths and `pick_blocks`'s key blocks) all three entry points
    take the sm90 kernel, the phi 'l'/'x' neck heads (q/k 768 to 3,584) and
    the int8 outputs at v past 512 included; there is no other kernel;
  * the launch plan (`attention_int8.int8_sm90_plan`) at every site and over
    the whole domain: its shared memory (recomputed here) within the card's
    227 KB, legal wgmma N, v slices that cover v, key tiles that cover each
    key block with the tail the kernel masks, the int8 Q tile resident where
    it fits and streamed beside K where it does not (the neck heads of phi
    'l' and 'x'), an int8 output's slices one cluster of at most 8;
  * the integer max of pass 1: the largest __fmul_rn(float(S), rs) of a
    block is __fmul_rn(float(max S), rs), on random int32 scores with
    scales down to the quantizers' floors; and pass 2's exact conversions
    through the fp32 adder (float(S) at q/k up to 256, rint(p));
  * V's key-major layout (`vq_key_major`) and the kernel's accumulator-to-A
    mapping, emulated thread by thread: P V from the packed fragments and
    the permuted layout equals the plain int32 P V bit for bit;
  * the kernel's tiling: an emulation of its passes at the plan's key tile
    (integer max per tile, p masked past each block's end, pv summed tile
    by tile) against `flash_attention_mha_int8` in the Pallas interpreter,
    at N = 1,216 in two key blocks of 608 (a tail tile in each), with the
    int8 tests' fp32 bar (5e-3 of max|ref|), which a key tile left out, a
    tile read twice or a tail tile's next-block keys left unmasked misses;
    the sliced form of dark3 (q/k 32 zero-padded to 64, v 1,024 in the
    plan's slices of 512, S recomputed for each, two key blocks) against the
    same interpreter, which a v slice from another slice's columns, the
    second key block's acc dropped, the zero-filled q/k columns made
    nonzero or the tail key tile read twice misses; and the wide form (q/k
    768 summed over its 128-column slabs, v 768 in three slices of a
    cluster, the int8 outputs quantized on the amax the cluster exchanges)
    against all three Pallas kernels in the interpreter under the int8 bars
    of PERF.md, which a q/k slab left out, a cluster peer's amax ignored, a
    slice's P from another query tile or a tail tile's next-block keys
    unmasked misses;
  * the wrappers raise off the CPU before anything launches, and
    reset_launch_counts clears the counter of every entry point.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import transparent_object_detection_tpu.ops.attention_int8 as a8
from transparent_object_detection_tpu_torch.config import SCALE_TABLE
from transparent_object_detection_tpu_torch.models import blocks as tb
from transparent_object_detection_tpu_torch.ops import attention as tattn
from transparent_object_detection_tpu_torch.ops import attention_int8 as t8

torch.set_num_threads(1)

PHIS = ("n", "s", "m", "l", "x")
INPUTS = ((640, 640), (480, 576))
FP32_REL = 5e-3  # tests/test_torch_attention_int8.py's fp32 bar
WGMMA_S8_N = (8, 16, 24, 32, 48, 64, 80, 96, 112, 128, 144, 160, 176, 192, 208, 224, 240, 256)
# the int8 bars of PERF.md: payloads equal but for +-1 on <= 1e-3 of the
# elements, scales <= 1e-5 relative, values <= 1e-2 |ref| + 1e-3 max|ref|
PAYLOAD_FLIPS, SCALE_RTOL, RTOL8, ATOL8_OF_MAX = 1e-3, 1e-5, 1e-2, 1e-3
# the int8 sites of phi 'l' and 'x' (the neck heads beside dark3)
WIDE_SITES = {("l", "dark3"), ("l", "h1"), ("l", "h2"), ("l", "h4"), ("x", "dark3"),
              ("x", "h1"), ("x", "h2"), ("x", "h4")}


def sites(phi: str, hw=(640, 640)):
    """{site: (N, q/k width, v width, heads, packed qkv input)}, as
    tests/test_torch_scales.py builds them."""
    c, _, mul = SCALE_TABLE[phi]
    c5 = int(c * 16 * mul)
    h, w = hw
    n8, n16, n32 = (h // 8) * (w // 8), (h // 16) * (w // 16), (h // 32) * (w // 32)
    out = {"dark3": (n8, max(4 * c // 8, 1), 4 * c, 1, False)}
    for name, n, ch in (("h1", n16, c5 + 8 * c), ("h2", n8, 12 * c), ("h4", n16, 12 * c),
                        ("h6", n32, 8 * c + c5)):
        out[name] = (n, ch, ch, tb._pick_num_heads(ch, 8), True)
    return out


def int8_sites(phi: str):
    """(hw, name, N, dq, dv, bk) of every int8 site of `phi` at both inputs."""
    out = []
    for hw in INPUTS:
        for name, (n, cq, cv, heads, packed) in sites(phi, hw).items():
            route, bk = tattn.serving_route(n, cq, heads, cv, True, packed)
            if route == "int8":
                out.append((hw, name, n, cq // heads, cv // heads, bk))
    return out


@pytest.mark.parametrize("phi", PHIS)
def test_form_rule_routes_every_int8_site(phi):
    """One kernel for every int8 site and entry point: flash_mha_int8,
    flash_mha_int8_qout and flash_int8_handoff take the sm90 kernel at every
    int8 site of every scale and input (dark3 of 'n' at q/k 32 and of 'm',
    'l', 'x' at v 1,024 to 4,096; the phi 'l'/'x' neck heads at q/k 768 to
    3,584, the int8 outputs there at v past 512), each a shape
    `kernel_supports` admits for that entry point; outside the domain the
    rule raises (no other route)."""
    found = int8_sites(phi)
    assert found, phi
    for hw, name, n, dq, dv, bk in found:
        for entry in ("flash_mha_int8",) + t8.INT8_OUT_ENTRIES:
            assert t8.int8_fwd_form(dq, dv, entry) == "sm90", (hw, name, entry)
            assert t8.kernel_supports(n, dq, dv, bk, entry) and n % bk == 0, (hw, name, entry)
    if phi in ("l", "x"):  # the wide sites, at both inputs
        assert {(phi, name) for _, name, *_ in found} == {s for s in WIDE_SITES if s[0] == phi}
        assert max(dq for *_, dq, _, _ in found) == (1536 if phi == "l" else 3584)
    with pytest.raises(ValueError, match="entry point"):
        t8.int8_fwd_form(64, 128, "flash_single")
    for dq, dv in ((48, 256), (64, 200)):
        assert not t8.kernel_supports(64, dq, dv, 32)
        with pytest.raises(ValueError, match="multiples of 32"):
            t8.int8_fwd_form(dq, dv)
    # an int8 output on v in more slices than a cluster holds (31 of 128)
    assert t8.kernel_supports(64, 128, 3968, 32)
    assert not t8.kernel_supports(64, 128, 3968, 32, "flash_mha_int8_qout")
    with pytest.raises(ValueError, match="slices"):
        t8.int8_fwd_form(128, 3968, "flash_int8_handoff")


def _plan_checks(tag, dq, dv, nk, bk, slice_cols=None, int8_out=False):
    plan = t8.int8_sm90_plan(dq, dv, nk, slice_cols, int8_out)
    assert set(plan) == set(t8.SM90_PLAN_KEYS), tag
    split, keys = plan["split"], plan["keys"]
    block_v = (2 if split else 1) * plan["v_cols"]  # a block's v slice
    if slice_cols is None:  # no slices up to 512; past it 512, else 256, else 128
        assert block_v == (dv if dv <= 512 else next(w for w in (512, 256, 128) if dv % w == 0)), tag
    else:
        assert block_v == slice_cols, tag
    assert split == int(block_v > 256) and plan["rows"] == (64 if split else 128), tag
    assert keys == (128 if block_v <= 128 else 64), tag
    assert plan["swq"] == (64 if dq <= 64 else 128), tag
    # wgmma N: the key tile for S = Q K^T, a warpgroup's v columns for P V;
    # together the warpgroups cover a slice, the slices v, nothing left over
    assert keys in WGMMA_S8_N and plan["v_cols"] in WGMMA_S8_N, tag
    assert plan["slices"] * block_v == dv, tag
    # an int8 output's slices are one cluster (its amax exchange), at most 8
    assert plan["cluster"] == (plan["slices"] if int8_out else 1) <= t8.SM90_MAX_CLUSTER, tag
    # key tiles cover each block; the last one's keys past bk are masked
    tiles = -(-bk // keys)
    assert (tiles - 1) * keys < bk <= tiles * keys, tag
    assert plan["multi"] == int(nk > 1), tag
    assert 1 <= plan["stages"] <= t8.SM90_MAX_STAGES and plan["v_stages"] in (1, 2), tag
    slabs = -(-dq // plan["swq"])
    q_slab = plan["rows"] * plan["swq"]
    # Q resident (all its slabs), or one slab a ring stage beside K's
    q_bytes, stage = ((0, keys * plan["swq"] + q_slab) if plan["q_stream"]
                      else (slabs * q_slab, keys * plan["swq"]))
    smem = (2048 + q_bytes + plan["stages"] * stage + plan["v_stages"] * block_v * keys
            + (2 * 64 * plan["v_cols"] * 4 if nk > 1 else 0))
    assert plan["smem_bytes"] == smem <= t8.SM90_SMEM_LIMIT, tag
    if plan["q_stream"]:  # only where no resident plan fits
        resident = 2048 + slabs * q_slab + keys * plan["swq"] + block_v * keys + (
            2 * 64 * plan["v_cols"] * 4 if nk > 1 else 0)
        assert resident > t8.SM90_SMEM_LIMIT and plan["swq"] == 128, tag
    return plan, tiles


def test_launch_plan_fits_every_sm90_site():
    """Every int8 site of every scale and input, for flash_mha_int8 and the
    int8-output entries, and the rule's whole domain (q/k 32 to 3,584, v
    128 to 4,096, one or several key blocks): the plan fits, its products
    are legal, its slices cover v and its tiles the block, an int8 output's
    slices are one cluster; the tail tiles of the routed sites are those the
    kernel masks (1,600 in 128-key tiles: 64; 4,320, 3,200 and 1,440 in
    64-key tiles: 32, 0 and 32). phi='m' dark3 (v 1,024 in two slices of 512
    in the split form, two key blocks: the fp32 acc of 128 KB in shared
    memory) keeps two V stages and three K stages; its alternative forms
    (slices of 128 or 256 in the rows form) fit too, with at least two K
    stages; phi='n' dark3 (q/k 32) takes 64-byte q/k boxes. The phi 'l'/'x'
    neck heads: h4 of 'l' (768, one key block) keeps Q resident at 128
    rows, h2 (768, four key blocks) and every head of 1,536 and 3,584 stream
    it; 768 in three slices of 256 (rows form), 1,536 in three of 512 and
    3,584 in seven (split form), a cluster of as many for the int8 outputs."""
    tails, plans = {}, {}
    for phi in PHIS:
        for hw, name, n, dq, dv, bk in int8_sites(phi):
            plan, tiles = _plan_checks((phi, hw, name), dq, dv, n // bk, bk)
            tails[phi, hw, name] = bk - (tiles - 1) * plan["keys"]
            plans[phi, hw, name] = plan
            if name != "dark3":  # the int8-output entries at the neck heads
                plans[phi, hw, name, "out"] = _plan_checks((phi, hw, name, "out"), dq, dv,
                                                           n // bk, bk, int8_out=True)[0]
    assert tails["n", (640, 640), "h4"] == 64  # 1,600 keys in 128-key tiles
    assert tails["s", (480, 576), "h2"] == 32  # 4,320 in 64-key tiles
    assert tails["m", (640, 640), "h2"] == 64  # 3,200 in 64-key tiles: whole
    assert tails["m", (480, 576), "dark3"] == 32  # 1,440 in 64-key tiles
    m3 = plans["m", (640, 640), "dark3"]
    assert (m3["slices"], m3["split"], m3["v_cols"], m3["multi"], m3["v_stages"]) == (2, 1, 256,
                                                                                      1, 2)
    assert m3["stages"] >= 2 and m3["stages"] == 3
    n3 = plans["n", (640, 640), "dark3"]
    assert (n3["swq"], n3["slices"], n3["v_cols"], n3["multi"]) == (64, 1, 256, 0)
    assert plans["l", (640, 640), "dark3"]["slices"] == 4
    assert plans["x", (640, 640), "dark3"]["slices"] == 8
    wide = lambda key: tuple(plans[key][k] for k in ("slices", "split", "q_stream", "multi"))
    assert wide(("l", (640, 640), "h4")) == (3, 0, 0, 0)
    assert wide(("l", (640, 640), "h2")) == wide(("l", (480, 576), "h2")) == (3, 0, 1, 1)
    assert wide(("l", (640, 640), "h1")) == (3, 1, 1, 1)
    assert wide(("x", (640, 640), "h1")) == (7, 1, 1, 1)
    for name in ("h2", "h4"):
        assert wide(("x", (640, 640), name)) == (3, 1, 1, 1)
    assert plans["x", (640, 640), "h1", "out"]["cluster"] == 7
    assert plans["l", (640, 640), "h2", "out"]["cluster"] == 3
    assert all(p["cluster"] == 1 for k, p in plans.items() if k[-1] != "out")
    for phi in ("n", "s", "m"):  # no slice, and no cluster, at the narrower necks
        assert all(p["cluster"] == 1 and not p["q_stream"] for k, p in plans.items()
                   if k[0] == phi), phi
    for slice_cols in (128, 256, 512):  # the forms measured at phi='m' dark3
        alt, _ = _plan_checks(("m dark3", slice_cols), 128, 1024, 2, 3200, slice_cols)
        assert alt["stages"] >= 2, slice_cols
    for dq in (*range(32, 513, 32), 544, 640, 768, 1024, 1536, 2048, 3584):
        for dv in (128, 256, 384, 512, 640, 768, 1024, 1536, 2048, 3584, 4096):
            for nk, bk in ((1, 1216), (2, 608)):
                _plan_checks((dq, dv, nk), dq, dv, nk, bk)
                _plan_checks((dq, dv, nk, "out"), dq, dv, nk, bk, int8_out=True)
    with pytest.raises(ValueError, match="multiples of 32"):
        t8.int8_sm90_plan(48, 256, 1)
    with pytest.raises(ValueError, match="no sm90 int8 form"):
        t8.int8_sm90_plan(128, 1024, 2, slice_cols=384)
    with pytest.raises(ValueError, match="slices"):  # 31 slices of 128: no cluster
        t8.int8_sm90_plan(128, 3968, 1, int8_out=True)


def test_integer_max_identity():
    """Pass 1's integer max: for random int32 scores (up to dq * 127^2 at
    dq 512, either sign) and positive row scales from the quantizers'
    floors (1e-12 / 127 per side) to large ones, the largest float32
    product over a block equals the product of the largest score."""
    rng = np.random.default_rng(0)
    sl2 = np.float32(0.0625 * 1.4426950408889634)
    floor = np.float32(1e-12 / 127)
    for trial in range(200):
        s = rng.integers(-512 * 127 ** 2, 512 * 127 ** 2, size=(8, 608), dtype=np.int64)
        if trial % 4 == 0:  # many ties and near-ties at the top
            s = np.clip(s, None, s.max(axis=1, keepdims=True) - rng.integers(0, 3, s.shape))
        qs = np.where(rng.random((8, 1)) < 0.3, floor,
                      rng.random((8, 1)).astype(np.float32) * 4).astype(np.float32)
        ks = floor if trial % 2 else np.float32(rng.random() * 0.05 + 1e-3)
        rs = (qs * (np.float32(ks) * sl2)).astype(np.float32)
        sf = s.astype(np.float32)
        assert (sf == s).all() or np.abs(s).max() >= 2 ** 24  # the conversion, as cvt.rn
        per_key = (sf * rs).astype(np.float32).max(axis=1)
        once = (s.max(axis=1).astype(np.float32) * rs[:, 0]).astype(np.float32)
        np.testing.assert_array_equal(per_key, once)


def test_adder_conversions_exact():
    """Pass 2's conversions through the fp32 adder ([conversions]): the bit
    pattern of 1.5 * 2^23 plus an int s, less 1.5 * 2^23, is float(s) for
    every |s| <= 2^22 (all scores at q/k up to 256: 256 * 128^2 = 2^22;
    checked at both ends and on a sample between); x + 1.5 * 2^23, its bits
    less the pattern's, is rint(x) (ties to even) for every p the kernel
    rounds, 0 to 127, the half-integers included."""
    magic_bits = np.int32(0x4B400000)
    magic = np.float32(12582912.0)
    assert 256 * 128 ** 2 == 2 ** 22
    rng = np.random.default_rng(4)
    s = np.concatenate([np.arange(-2 ** 22, -2 ** 22 + 4096), np.arange(2 ** 22 - 4096, 2 ** 22 + 1),
                        rng.integers(-2 ** 22, 2 ** 22, 1 << 20)]).astype(np.int32)
    as_float = (magic_bits + s).view(np.float32) - magic
    np.testing.assert_array_equal(as_float, s.astype(np.float32))
    x = np.concatenate([np.arange(0, 128, 0.5), rng.random(1 << 20) * 128,
                        np.nextafter(np.arange(0.5, 128, 1.0), 0),
                        np.nextafter(np.arange(0.5, 128, 1.0), 200)]).astype(np.float32)
    as_int = (x + magic).view(np.int32) - magic_bits
    np.testing.assert_array_equal(as_int, np.rint(x).astype(np.int32))


def _key_major_reference(vq: np.ndarray, heads: int) -> np.ndarray:
    """(B, N, H * dv) -> (B, H, dv, N), key 16h + 8c + 2t + e of each 32-key
    group at position 16h + 4t + 2c + e, written out index by index."""
    b, n, cv = vq.shape
    dv = cv // heads
    out = np.empty((b, heads, dv, n), vq.dtype)
    for pos in range(32):
        half, t, c, e = pos >> 4, (pos >> 2) & 3, (pos >> 1) & 1, pos & 1
        key = 16 * half + 8 * c + 2 * t + e
        out[..., pos::32] = vq[:, key::32, :].reshape(b, n // 32, heads, dv).transpose(0, 2, 3, 1)
    return out


@pytest.mark.parametrize("keys", [64, 128])
def test_key_major_layout_and_fragment_mapping(keys):
    """vq_key_major against the index-by-index layout; then P V emulated as
    the kernel forms it: each thread packs its accumulator values (rows g
    and g + 8 of its warp's 16, keys 8c + 2t + e) into the k32 A registers
    (register 2h + row, byte 2c' + e for chunk c = 4kk + 2h + c'), the
    hardware's A layout places them (register 0: row g, positions 4t..4t+3;
    1: row g + 8; 2 and 3: positions 16 + 4t..), and B is the permuted
    layout's k32 slice: the int32 sums equal P V exactly."""
    rng = np.random.default_rng(1)
    b, n, heads, dv = 1, 256, 2, 64
    vq = rng.integers(-127, 128, size=(b, n, heads * dv), dtype=np.int8)
    vt = t8.vq_key_major(torch.from_numpy(vq), heads).numpy()
    np.testing.assert_array_equal(vt, _key_major_reference(vq, heads))
    p = rng.integers(0, 128, size=(64, keys), dtype=np.int64)  # rint(p127) of one tile
    v_tile = vq[0, :keys, :dv].astype(np.int64)  # head 0's first `keys` keys
    b_pos = vt[0, 0, :, :keys].astype(np.int64).T  # (positions, dv)
    a_pos = np.zeros((64, keys), np.int64)  # A as the hardware reads it, by position
    for warp in range(4):
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            for kk in range(keys // 32):
                regs = [0] * 4
                for cl in range(4):
                    c = 4 * kk + cl
                    for e in range(4):
                        row, key = 16 * warp + g + 8 * (e >> 1), 8 * c + 2 * t + (e & 1)
                        regs[(cl >> 1) * 2 + (e >> 1)] |= int(p[row, key]) << (
                            8 * ((cl & 1) * 2 + (e & 1)))
                for j in range(4):
                    row = 16 * warp + g + 8 * (j & 1)
                    for byte in range(4):
                        a_pos[row, 32 * kk + 16 * (j >> 1) + 4 * t + byte] = \
                            (regs[j] >> (8 * byte)) & 0xFF
    np.testing.assert_array_equal(a_pos @ b_pos, p @ v_tile)
    # V in its natural key order under the same fragments gives other sums
    assert not np.array_equal(a_pos @ v_tile, p @ v_tile)


def _tiled(q, k, v, heads, scale, bk, keys, fault=None, slice_cols=None, pad_to=None):
    """The kernel's passes at its key tile, in plain torch: per key block,
    pass 1 takes the integer max of q.k^T tile by tile (keys past the
    block's end masked), pass 2 forms p127 against the block max, rounds it,
    sums l and pv tile by tile (int64, exact). With `slice_cols`, v in
    slices of that width, each computed on its own with S recomputed, as the
    sliced form's blocks do; with `pad_to`, q and k zero-padded to that
    width after quantization, as the zero-filled TMA box holds them. Faults:
    a key tile left out ("tile_dropped"), a tile read in place of its
    successor, which is never read ("tile_read_twice"), the tail tile's keys
    past the block's end left unmasked ("tail_unmasked": the next block's
    keys; past N zero-filled), the tail tile read twice ("tail_tile_twice"),
    the second key block's pv left out of acc ("second_block_acc_dropped"),
    slice 1 written from slice 0's v columns ("v_slice_from_other"), the
    padded q/k columns nonzero ("pad_nonzero": a copy of the real ones)."""
    b, n, _ = k.shape
    kq, ks = t8.quantize_kv(k, heads, bk)
    vq, vs = t8.quantize_kv(v, heads, bk)
    qq, qs = t8._quantize_q(t8._split_heads(q, heads))
    kh, vh = t8._split_heads(kq, heads).long(), t8._split_heads(vq, heads).long()
    qq = qq.long()
    if pad_to is not None:
        extra = pad_to - qq.shape[-1]
        fill = (lambda t: t) if fault == "pad_nonzero" else torch.zeros_like
        qq = torch.cat([qq, fill(qq)[..., :extra]], -1)
        kh = torch.cat([kh, fill(kh)[..., :extra]], -1)
    sl2 = np.float32(scale * t8.LOG2E)
    tiles = -(-bk // keys)
    dv = vh.shape[-1]
    width = slice_cols or dv
    outs = []
    for sl in range(dv // width):
        src = sl - 1 if fault == "v_slice_from_other" and sl == 1 else sl
        vhs = vh[..., src * width:(src + 1) * width]
        shape = (b, heads, n, width)
        for j in range(n // bk):
            rs = qs.float() * (ks[:, :, j] * torch.tensor(sl2))[..., None, None]  # (B, H, N, 1)
            spans = []
            for t in range(tiles):
                src_t = t - 1 if fault == "tile_read_twice" and t == 2 else t
                if fault == "tile_dropped" and t == 1:
                    continue
                lo = j * bk + src_t * keys
                hi = lo + keys if fault == "tail_unmasked" else min(lo + keys, (j + 1) * bk)
                spans.append((lo, hi))
            if fault == "tail_tile_twice":
                spans.append(spans[-1])

            def scores(lo, hi):
                idx = torch.arange(lo, hi)
                kt = torch.zeros(b, heads, hi - lo, kh.shape[-1], dtype=torch.long)
                kt[:, :, idx < n] = kh[:, :, idx[idx < n]]
                vt = torch.zeros(b, heads, hi - lo, width, dtype=torch.long)
                vt[:, :, idx < n] = vhs[:, :, idx[idx < n]]
                return qq @ kt.transpose(-1, -2), vt

            imax = torch.stack([scores(lo, hi)[0].amax(-1, keepdim=True)
                                for lo, hi in spans]).amax(0)
            if j == 0:
                m = torch.full(rs.shape, -1e30)
                l = torch.zeros(rs.shape)
                acc = torch.zeros(shape)
            m_new = torch.maximum(m, imax.float() * rs)
            corr = torch.exp2(m - m_new)
            lsum = torch.zeros(rs.shape)
            pv = torch.zeros(shape, dtype=torch.long)
            for lo, hi in spans:
                s32, vt = scores(lo, hi)
                p127 = torch.exp2(s32.float() * rs - (m_new - t8.LOG2_127))
                lsum = lsum + p127.sum(-1, keepdim=True)
                pv = pv + torch.round(p127).long() @ vt
            if fault == "second_block_acc_dropped" and j == 1:
                pv = torch.zeros_like(pv)
            l = l * corr + lsum
            acc = acc * corr + pv.float() * vs[:, :, j][..., None, None]
            m = m_new
        outs.append(acc * (1.0 / l))
    return t8._merge_heads(torch.cat(outs, -1))


@pytest.mark.parametrize("dh", [128, 256])
def test_kernel_tiling_matches_pallas(monkeypatch, dh):
    """The kernel's passes at the plan's key tile (128 keys for heads of
    128, 64 for heads of 256) against flash_attention_mha_int8 in the Pallas
    interpreter: fp32, 2 heads, N = 1,216 in two key blocks of 608, so
    each block ends in a partial tile (608 = 4 x 128 + 96 = 9 x 64 + 32) and
    the first block's tail tile runs into the second block; the bar (5e-3 of
    max|ref|) rejects a key tile left out, a tile read twice and the tail
    keys left unmasked."""
    monkeypatch.setattr(a8, "INTERPRET", True)
    b, n, heads, bk = 1, 1216, 2, 608
    c = heads * dh
    rng = np.random.default_rng(2)
    q, k, v = (rng.standard_normal((b, n, c)).astype(np.float32) * s for s in (1.5, 1.5, 1.0))
    scale = dh ** -0.5
    ref = np.asarray(a8.flash_attention_mha_int8(*(jnp.asarray(a) for a in (q, k, v)), heads,
                                                 scale, 64, bk), np.float32)
    keys = t8.int8_sm90_plan(dh, dh, n // bk)["keys"]
    assert bk % keys  # a tail tile
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    rel = lambda out: float(np.abs(out.numpy() - ref).max() / np.abs(ref).max())
    assert rel(_tiled(tq, tk, tv, heads, scale, bk, keys)) <= FP32_REL
    for fault in ("tile_dropped", "tile_read_twice", "tail_unmasked"):
        assert rel(_tiled(tq, tk, tv, heads, scale, bk, keys, fault)) > FP32_REL, fault
    # the wrapper's CPU path computes the same function
    kq, ks = t8.quantize_kv(tk, heads, bk)
    vq, vs = t8.quantize_kv(tv, heads, bk)
    assert rel(t8.flash_mha_int8(tq, kq, ks, vq, vs, heads, scale)) <= FP32_REL


def test_sliced_form_matches_pallas(monkeypatch):
    """dark3's sliced form (phi='n''s q/k of 32 beside phi='m''s v of
    1,024): q and k zero-padded to the 64-byte box, v in the plan's two
    slices of 512 with S recomputed for each, two key blocks of 608 (a
    partial tail tile in each), emulated against flash_attention_mha_int8
    in the Pallas interpreter at N = 1,216 under the fp32 bar (5e-3 of
    max|ref|); a v slice from another slice's columns, the second key
    block's acc dropped, the zero-filled q/k columns made nonzero and the
    tail key tile read twice miss it. The wrapper's CPU path agrees."""
    monkeypatch.setattr(a8, "INTERPRET", True)
    b, n, dq, dv, bk = 1, 1216, 32, 1024, 608
    plan = t8.int8_sm90_plan(dq, dv, n // bk)
    assert (plan["swq"], plan["slices"], plan["v_cols"], plan["split"]) == (64, 2, 256, 1)
    rng = np.random.default_rng(3)
    q, k = (rng.standard_normal((b, n, dq)).astype(np.float32) * 1.5 for _ in range(2))
    v = rng.standard_normal((b, n, dv)).astype(np.float32)
    ref = np.asarray(a8.flash_attention_mha_int8(*(jnp.asarray(a) for a in (q, k, v)), 1, 1.0,
                                                 64, bk), np.float32)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    rel = lambda out: float(np.abs(out.numpy() - ref).max() / np.abs(ref).max())
    form = dict(slice_cols=plan["v_cols"] * (1 + plan["split"]), pad_to=plan["swq"])
    assert rel(_tiled(tq, tk, tv, 1, 1.0, bk, plan["keys"], **form)) <= FP32_REL
    for fault in ("v_slice_from_other", "second_block_acc_dropped", "pad_nonzero",
                  "tail_tile_twice"):
        assert rel(_tiled(tq, tk, tv, 1, 1.0, bk, plan["keys"], fault, **form)) > FP32_REL, fault
    kq, ks = t8.quantize_kv(tk, 1, bk)
    vq, vs = t8.quantize_kv(tv, 1, bk)
    assert rel(t8.flash_mha_int8(tq, kq, ks, vq, vs, 1, 1.0)) <= FP32_REL


def _wide_form(qq, qs, kq, ks, vq, vs, heads, scale, plan, bk, fault=None, int8_out=False):
    """csrc/flash_int8_sm90.cu's form for wide heads in plain torch, from
    quantized operands: qq (B, H, N, dq) int8 with scales qs (B, H, N, 1), kq
    and vq (B, N, H * d) int8 with scales (B, H, N / bk). Each v slice of the
    plan (one block of the cluster) computes, for its query tile, S summed
    over the q/k slabs of `swq` columns (int64, exact), pass 1's integer max
    over the key block's tiles (keys past the block's end masked), pass 2's
    p127, l and pv tile by tile; with `int8_out` the output is quantized per
    (row, head) on the amax the cluster exchanges (each slice's rows' amax,
    the largest over the slices), the head's first slice writing the scale.
    Faults: "slab_dropped" (q/k slab 1 left out of S), "other_tile" (slice 1
    from the next query tile's Q rows and scales: P of another tile),
    "peer_amax_ignored" (each slice quantized on its own amax),
    "tail_unmasked" (the tail tile's next-block keys scored; zero keys past
    N). Returns fp32 (B, N, H * dv), or int8 (B, N, H * dv) and (B, N, H)."""
    b, h, n, dq = qq.shape
    kh, vh = t8._split_heads(kq, heads).long(), t8._split_heads(vq, heads).long()
    width = plan["v_cols"] * (2 if plan["split"] else 1)
    rows, keys, swq = plan["rows"], plan["keys"], plan["swq"]
    sl2 = torch.tensor(np.float32(scale * t8.LOG2E))
    tiles = -(-bk // keys)
    outs = []
    for sl in range(plan["slices"]):
        q_sl, qs_sl = qq.long(), qs
        if fault == "other_tile" and sl == 1:
            q_sl, qs_sl = torch.roll(q_sl, -rows, dims=2), torch.roll(qs, -rows, dims=2)
        cols = slice(sl * width, (sl + 1) * width)

        def scores(lo, hi):
            idx = torch.arange(lo, hi)
            valid = idx < n
            kt = torch.zeros(b, h, hi - lo, dq, dtype=torch.long)
            kt[:, :, valid] = kh[:, :, idx[valid]]
            vt = torch.zeros(b, h, hi - lo, width, dtype=torch.long)
            vt[:, :, valid] = vh[:, :, idx[valid], cols]
            s32 = torch.zeros(b, h, n, hi - lo, dtype=torch.long)
            for c in range(-(-dq // swq)):  # the slabs that stream through the ring
                if fault == "slab_dropped" and c == 1:
                    continue
                slab = slice(c * swq, (c + 1) * swq)
                s32 = s32 + q_sl[..., slab] @ kt[..., slab].transpose(-1, -2)
            return s32, vt

        m = torch.full(qs.shape, -1e30)
        l = torch.zeros(qs.shape)
        acc = torch.zeros(b, h, n, width)
        for j in range(ks.shape[-1]):
            rs = qs_sl.float() * (ks[:, :, j] * sl2)[..., None, None]
            spans = []
            for t in range(tiles):
                lo = j * bk + t * keys
                spans.append((lo, lo + keys if fault == "tail_unmasked"
                              else min(lo + keys, (j + 1) * bk)))
            imax = torch.stack([scores(lo, hi)[0].amax(-1, keepdim=True)
                                for lo, hi in spans]).amax(0)
            m_new = torch.maximum(m, imax.float() * rs)
            corr = torch.exp2(m - m_new)
            lsum = torch.zeros(qs.shape)
            pv = torch.zeros(b, h, n, width, dtype=torch.long)
            for lo, hi in spans:
                s32, vt = scores(lo, hi)
                p127 = torch.exp2(s32.float() * rs - (m_new - t8.LOG2_127))
                lsum = lsum + p127.sum(-1, keepdim=True)
                pv = pv + torch.round(p127).long() @ vt
            l = l * corr + lsum
            acc = acc * corr + pv.float() * vs[:, :, j][..., None, None]
            m = m_new
        outs.append(acc * (1.0 / l))
    if not int8_out:
        return t8._merge_heads(torch.cat(outs, -1))
    amax = [o.abs().amax(-1, keepdim=True) for o in outs]  # each slice's rows
    if fault != "peer_amax_ignored":  # the cluster's exchange
        amax = [torch.stack(amax).amax(0)] * len(outs)
    amax = [torch.clamp(a, min=1e-30) for a in amax]
    payload = torch.cat([torch.round(o * (torch.full_like(a, 127.0) / a)).to(torch.int8)
                         for o, a in zip(outs, amax)], -1)
    return t8._merge_heads(payload), (amax[0][..., 0] * (1.0 / 127.0)).transpose(1, 2)


def _int8_bar(out, ref) -> float:
    """The largest share of the int8 bars of PERF.md that `out` uses against
    `ref` (numpy): values, or an int8 payload with its scales."""
    if isinstance(out, tuple):
        diff = np.abs(out[0].numpy().astype(np.int32) - np.asarray(ref[0], np.int32))
        flips = float((diff > 0).mean()) / PAYLOAD_FLIPS
        rel = np.abs(out[1].numpy() - np.asarray(ref[1])) / np.abs(np.asarray(ref[1]))
        return max(flips, float(diff.max()) if diff.max() > 1 else 0.0,
                   float(rel.max()) / SCALE_RTOL)
    ref = np.asarray(ref, np.float32)
    bar = RTOL8 * np.abs(ref) + ATOL8_OF_MAX * np.abs(ref).max()
    return float((np.abs(out.numpy() - ref) / bar).max())


@pytest.mark.parametrize("entry", ["flash_mha_int8", "flash_mha_int8_qout", "flash_int8_handoff"])
@pytest.mark.parametrize("dq,dv", [(768, 768), (640, 1024)])
def test_wide_form_matches_pallas(monkeypatch, entry, dq, dv):
    """The form of the phi 'l'/'x' neck heads against the Pallas kernel of
    `entry` in the interpreter (two heads, N = 192 in two key blocks of 96,
    each ending in a partial 64-key tile that runs into the next block; two
    query tiles): q/k 768 streamed beside K (four key blocks' worth of acc
    would not fit beside a resident Q at phi='l' h2) in 128-column slabs, v
    768 in three slices of 256 (rows form, a cluster of three for the int8
    outputs); q/k 640 resident, v 1,024 in two slices of 512 (split form).
    Under the int8 bars of PERF.md; a q/k slab left out of S, one slice's P
    from another query tile and the tail tile's next-block keys scored miss
    them, and for the int8 outputs a cluster peer's amax ignored. The
    wrapper's CPU path (the plain version) agrees."""
    monkeypatch.setattr(a8, "INTERPRET", True)
    b, n, heads, bk = 1, 192, 2, 96
    int8_out = entry != "flash_mha_int8"
    plan = t8.int8_sm90_plan(dq, dv, n // bk, int8_out=int8_out)
    assert plan["slices"] > 1 and plan["cluster"] == (plan["slices"] if int8_out else 1)
    assert n > plan["rows"] and bk % plan["keys"]  # another query tile; a tail tile
    if (dq, dv) == (768, 768):
        assert plan["split"] == 0 and t8.int8_sm90_plan(dq, dv, 4)["q_stream"] == 1
    rng = np.random.default_rng(11)
    q, k = (rng.standard_normal((b, n, heads * dq)).astype(np.float32) * 1.5 for _ in range(2))
    v = rng.standard_normal((b, n, heads * dv)).astype(np.float32)
    scale = dq ** -0.5
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    kq, ks = t8.quantize_kv(tk, heads, bk)
    vq, vs = t8.quantize_kv(tv, heads, bk)
    qq, qs = t8._quantize_q(t8._split_heads(tq, heads))
    j = lambda t: jnp.asarray(t.numpy())
    if entry == "flash_mha_int8":
        ref = a8.flash_attention_mha_int8(j(tq), j(tk), j(tv), heads, scale, 64, bk)
        cpu = t8.flash_mha_int8(tq, kq, ks, vq, vs, heads, scale)
    elif entry == "flash_mha_int8_qout":
        ref = a8.flash_attention_mha_int8_qout(j(tq), j(tk), j(tv), heads, scale, 64, bk)
        cpu = t8.flash_mha_int8_qout(tq, kq, ks, vq, vs, heads, scale)
    else:  # q as an int8 payload read in place, with its (row, head) scale table
        payload = t8._merge_heads(qq).contiguous()
        table = qs[..., 0].transpose(1, 2).contiguous()
        ref = a8.flash_attention_int8_handoff(j(payload), j(table), j(kq), j(ks), j(vq), j(vs),
                                              heads, scale, 64, bk, quant_out=True)
        cpu = t8.flash_int8_handoff(payload, table, kq, ks, vq, vs, heads, scale, True)
    form = lambda fault=None: _wide_form(qq, qs, kq, ks, vq, vs, heads, scale, plan, bk, fault,
                                         int8_out)
    assert _int8_bar(form(), ref) <= 1.0
    assert _int8_bar(cpu, ref) <= 1.0
    faults = ("slab_dropped", "other_tile", "tail_unmasked") + (
        ("peer_amax_ignored",) if int8_out else ())
    for fault in faults:
        assert _int8_bar(form(fault), ref) > 1.0, fault


def test_wrappers_raise_off_cpu_and_counters_clear():
    """All three entry points at a kernel shape, on a tensor that is neither
    on the CPU nor on a card: each raises before anything is built and
    counts nothing; reset_launch_counts clears the counter of each (the
    kernel's `sm90_launches`, the only one)."""
    for fn in t8.ENTRY_POINTS:
        fn.sm90_launches = 4
    t8.reset_launch_counts()
    assert all(fn.sm90_launches == 0 and not hasattr(fn, "launches") for fn in t8.ENTRY_POINTS)
    b, n, heads, d = 1, 1600, 2, 256
    meta = lambda *s, dt=torch.bfloat16: torch.empty(*s, dtype=dt, device="meta")
    q, kq, vq = meta(b, n, heads * d), meta(b, n, heads * d, dt=torch.int8), \
        meta(b, n, heads * d, dt=torch.int8)
    ks = vs = meta(b, heads, 1, dt=torch.float32)
    assert t8.int8_fwd_form(d, d) == "sm90"
    with pytest.raises(ValueError, match="CUDA tensor"):
        t8.flash_mha_int8(q, kq, ks, vq, vs, heads, 0.1)
    with pytest.raises(ValueError, match="CUDA tensor"):
        t8.flash_mha_int8_qout(q, kq, ks, vq, vs, heads, 0.1)
    payload = meta(b, n, 3 * heads * d, dt=torch.int8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        t8.flash_int8_handoff(payload, meta(b, n, heads, dt=torch.float32), kq, ks, vq, vs,
                              heads, 0.1, True)
    assert all(fn.sm90_launches == 0 for fn in t8.ENTRY_POINTS)
    # an int8 output takes one amax over the head's whole v: its v slices
    # one cluster, which a plan without the cluster breaks
    wide = meta(b, n, 1024, dt=torch.int8)
    plan = t8.int8_sm90_plan(128, 1024, 1, int8_out=True)
    assert (plan["slices"], plan["cluster"]) == (2, 2)
    with pytest.raises(ValueError, match="one cluster"):
        t8._launch_sm90(meta(b, n, 128), None, meta(b, n, 128, dt=torch.int8), ks, wide, vs, 1,
                        1.0, torch.int8, plan={**plan, "cluster": 1})
