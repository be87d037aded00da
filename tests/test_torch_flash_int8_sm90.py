"""The int8 flash forward for Hopper (csrc/flash_int8_sm90.cu), on the CPU.

The kernel cannot run here; what is held here is what surrounds it:
  * the form rule (`attention_int8.int8_fwd_form`, one per entry point): at
    every int8 site of phi 'n' to 'x' at 640x640 and 480x576 (the route
    table's widths and `pick_blocks`'s key blocks), heads whose q/k width is
    a multiple of 32 up to 512 take the sm90 kernel, flash_mha_int8 at any
    v (every serving site of phi 'n', 's', 'm', dark3 included; dark3 of
    'l' and 'x'), the int8-output entries at v up to 512; the rest the
    mma.sync template;
  * the launch plan (`attention_int8.int8_sm90_plan`) at every sm90 site and
    over the whole domain: its shared memory (recomputed here) within the
    card's 227 KB, at least two K stages at phi='m' dark3 (v in two slices
    of 512 beside the fp32 acc of two key blocks), legal wgmma N, v slices
    that cover v, key tiles that cover each key block with the tail the
    kernel masks;
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
    and the sliced form of dark3 (q/k 32 zero-padded to 64, v 1,024 in the
    plan's slices of 512, S recomputed for each, two key blocks) against the
    same interpreter, which a v slice from another slice's columns, the
    second key block's acc dropped, the zero-filled q/k columns made
    nonzero or the tail key tile read twice misses;
  * the wrappers raise off the CPU before anything launches, and
    reset_launch_counts clears both counters of every entry point.
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
# the sites the rule sends to the sm90 kernel for flash_mha_int8 (every
# serving site of phi 'n', 's', 'm'; dark3 of 'l' and 'x'); the template
# keeps the phi 'l'/'x' neck heads (q/k wider than 512)
SM90_SITES = {("n", "dark3"), ("n", "h2"), ("n", "h4"), ("s", "dark3"), ("s", "h1"), ("s", "h2"),
              ("s", "h4"), ("m", "dark3"), ("m", "h2"), ("m", "h4"), ("l", "dark3"),
              ("x", "dark3")}


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
    """The rule per entry point: flash_mha_int8 takes the sm90 kernel
    wherever q/k is a multiple of 32 up to 512, at any v: every int8 site
    of phi 'n', 's', 'm', dark3 of 'n' (q/k 32) and 'm' (v 1,024) included,
    and dark3 of 'l', 'x' (v 2,048, 4,096); flash_mha_int8_qout and
    flash_int8_handoff (an int8 output, one amax over the head's whole v)
    only at v up to 512, so at v past 512 they keep the template; the phi
    'l'/'x' neck heads (q/k 768 to 3,584) keep it for every entry. Every
    such site is one `pick_blocks` tiles and the kernels take."""
    found = int8_sites(phi)
    assert found, phi
    for hw, name, n, dq, dv, bk in found:
        form = t8.int8_fwd_form(dq, dv)
        assert form == ("sm90" if dq % 32 == 0 and dq <= 512 else "mma_sync"), (hw, name)
        assert form == ("sm90" if (phi, name) in SM90_SITES else "mma_sync"), (hw, name, form)
        assert t8.int8_fwd_form(dq, dv, "flash_mha_int8") == form
        for entry in t8.INT8_OUT_ENTRIES:
            assert t8.int8_fwd_form(dq, dv, entry) == (
                "sm90" if form == "sm90" and dv <= 512 else "mma_sync"), (hw, name, entry)
        assert t8.kernel_supports(n, dq, dv, bk) and n % bk == 0, (hw, name)
    if phi in ("n", "s", "m"):  # no serving site of these scales on the template
        assert all(t8.int8_fwd_form(dq, dv) == "sm90" for _, _, _, dq, dv, _ in found)
    if phi in ("l", "x"):
        for _, name, _, dq, dv, _ in found:
            assert (t8.int8_fwd_form(dq, dv) == "sm90") == (name == "dark3"), name
            assert all(t8.int8_fwd_form(dq, dv, e) == "mma_sync" for e in t8.INT8_OUT_ENTRIES)
    with pytest.raises(ValueError, match="entry point"):
        t8.int8_fwd_form(64, 128, "flash_single")


def _plan_checks(tag, dq, dv, nk, bk, slice_cols=None):
    plan = t8.int8_sm90_plan(dq, dv, nk, slice_cols)
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
    # key tiles cover each block; the last one's keys past bk are masked
    tiles = -(-bk // keys)
    assert (tiles - 1) * keys < bk <= tiles * keys, tag
    assert plan["multi"] == int(nk > 1), tag
    assert 1 <= plan["stages"] <= t8.SM90_MAX_STAGES and plan["v_stages"] in (1, 2), tag
    slabs = -(-dq // plan["swq"])
    smem = (2048 + plan["rows"] * slabs * plan["swq"] + plan["stages"] * keys * plan["swq"]
            + plan["v_stages"] * block_v * keys + (2 * 64 * plan["v_cols"] * 4 if nk > 1 else 0))
    assert plan["smem_bytes"] == smem <= t8.SM90_SMEM_LIMIT, tag
    return plan, tiles


def test_launch_plan_fits_every_sm90_site():
    """Every sm90 site of every scale and input, and the rule's whole
    domain (q/k 32 to 512, v 128 to 4,096, one or several key blocks): the
    plan fits, its products are legal, its slices cover v and its tiles the
    block; the tail tiles of the routed sites are those the kernel masks
    (1,600 in 128-key tiles: 64; 4,320, 3,200 and 1,440 in 64-key tiles:
    32, 0 and 32). phi='m' dark3 (v 1,024 in two slices of 512 in the split
    form, two key blocks: the fp32 acc of 128 KB in shared memory) keeps two
    V stages and three K stages; its alternative forms (slices of 128 or
    256 in the rows form) fit too, with at least two K stages; phi='n'
    dark3 (q/k 32) takes 64-byte q/k boxes."""
    tails, plans = {}, {}
    for phi in PHIS:
        for hw, name, n, dq, dv, bk in int8_sites(phi):
            if t8.int8_fwd_form(dq, dv) != "sm90":
                continue
            plan, tiles = _plan_checks((phi, hw, name), dq, dv, n // bk, bk)
            tails[phi, hw, name] = bk - (tiles - 1) * plan["keys"]
            plans[phi, hw, name] = plan
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
    for slice_cols in (128, 256, 512):  # the forms measured at phi='m' dark3
        alt, _ = _plan_checks(("m dark3", slice_cols), 128, 1024, 2, 3200, slice_cols)
        assert alt["stages"] >= 2, slice_cols
    for dq in range(32, 513, 32):
        for dv in (128, 256, 384, 512, 640, 1024, 2048, 4096):
            for nk, bk in ((1, 1216), (2, 608)):
                _plan_checks((dq, dv, nk), dq, dv, nk, bk)
    with pytest.raises(ValueError, match="multiples of 32"):
        t8.int8_sm90_plan(48, 256, 1)
    with pytest.raises(ValueError, match="multiples of 32"):
        t8.int8_sm90_plan(544, 256, 1)
    with pytest.raises(ValueError, match="no sm90 int8 form"):
        t8.int8_sm90_plan(128, 1024, 2, slice_cols=384)


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


def test_wrappers_raise_off_cpu_and_counters_clear():
    """All three entry points at an sm90 shape, on a tensor that is neither
    on the CPU nor on a card: each raises before anything is built and
    counts nothing; reset_launch_counts clears both counters of each."""
    for fn in t8.ENTRY_POINTS:
        fn.launches, fn.sm90_launches = 3, 4
    t8.reset_launch_counts()
    assert all(fn.launches == 0 and fn.sm90_launches == 0 for fn in t8.ENTRY_POINTS)
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
    assert all(fn.launches == 0 and fn.sm90_launches == 0 for fn in t8.ENTRY_POINTS)
    # an int8 output takes one amax over the head's whole v: no sliced plan
    wide = meta(b, n, 1024, dt=torch.int8)
    with pytest.raises(ValueError, match="whole v"):
        t8._launch_sm90(meta(b, n, 128), None, meta(b, n, 128, dt=torch.int8), ks, wide, vs, 1,
                        1.0, torch.int8)
