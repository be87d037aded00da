"""The int8 GEMM for Hopper (csrc/qmm_sm90.cu), on the CPU.

The kernel cannot run here; what is held here is what surrounds it:
  * the launch plan (`quant_matmul.qmm_sm90_plan`) at every qmm launch of the
    int8, A, B and fp32-int8 forwards of phi 'n', 's', 'm' at batch 1, 2
    and 32 and of the phi 'l' / 'x' kernel phases: shared memory (recomputed
    here) within the card's 227 KB, a legal wgmma width, tiles that cover
    M and N, the grid persistent exactly where tiles outnumber the SMs, K
    padded to 16; and the mma.sync GEMM gone from csrc/quant_matmul.cu;
  * the requantize's arithmetic (`requant4`: floats built and rounded by
    magic numbers, no conversion instruction) against `_requant`'s
    rint(x * ratio), over every int8 value and a spread of ratios;
  * the kernel's tiling: an emulation of its requantize pre-pass (G > 1:
    each 4-byte word by its group's ratio, into rows padded to 16), its tile
    raster, 128-byte K slabs (zero-filled past K and the padded K), the
    int32 sum slab by slab and the epilogue's order (the consumers' acc x
    row scale, then the epilogue warpgroup's x w_scale, + bias, activation,
    + residual) equals `qmm_plain` bit for bit at ragged M, N and K, odd N,
    G = 1, 4 and 16; each planted fault of the design (a K slab read twice,
    a K slab dropped, a group requantized with its neighbour's ratio, the
    second consumer warpgroup's rows unwritten, the last column tile shifted
    by one) moves it past the int8 bar;
  * the weights padded once (`prepare_weights`, `pad_k`): the originals
    plus zero columns, `qmm_plain`'s output unchanged at K = 849 and 4,792,
    and the wrapper's operands pass them through without a copy;
  * the wrappers raise off the CPU before anything launches, and
    reset_launch_counts clears the counters.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from transparent_object_detection_tpu_torch.config import SCALE_TABLE
from transparent_object_detection_tpu_torch.models import blocks as tb
from transparent_object_detection_tpu_torch.ops import quant_matmul as tq

torch.set_num_threads(1)

CSRC = Path(tq.__file__).resolve().parents[1] / "csrc"
PHIS = ("n", "s", "m")
BATCHES = (1, 2, 32)
WGMMA_S8_N = (64, 128)  # the SS widths csrc/qmm_sm90.cu instantiates
# int8 bars (chip_smoke.py's): payloads +-1 on at most 1e-3 of the
# elements, scales 1e-5 relative, values 1e-2 |ref| + 1e-3 max|ref|
PAYLOAD_FLIP_SHARE, SCALE_RTOL, RTOL8, ATOL8_OF_MAX = 1e-3, 1e-5, 1e-2, 1e-3


def teb_sites(phi: str, hw=(640, 640)):
    """{site: (tokens, channels, heads)} of the neck TEBs, as
    tests/test_torch_scales.py builds them."""
    c, _, mul = SCALE_TABLE[phi]
    c5 = int(c * 16 * mul)
    h, w = hw
    n8, n16, n32 = (h // 8) * (w // 8), (h // 16) * (w // 16), (h // 32) * (w // 32)
    out = {}
    for name, n, ch in (("h1", n16, c5 + 8 * c), ("h2", n8, 12 * c), ("h4", n16, 12 * c),
                        ("h6", n32, 8 * c + c5)):
        out[name] = (n, ch, tb._pick_num_heads(ch, 8))
    return out


def qmm_launches(phi: str, batch: int):
    """(M, K, N, G) of every qmm launch an int8 TEB of the int8, A, B and
    fp32-int8 forwards can make at `phi` and `batch`: qkv and mlp1 on one
    scale a row, attn_out on one or on one a head (the A handoff's and B's
    quant-out attention), mlp2 on the groups of mlp1's quant_out (bf16 rows,
    or the LN handoff's payload) or on one (w4a4)."""
    out = set()
    for n, c, heads in teb_sites(phi).values():
        m = batch * n
        out |= {(m, c, 3 * c, 1), (m, c, c, 1), (m, c, 4 * c, 1), (m, 4 * c, c, 1)}
        if (c // heads) % 128 == 0:  # the int8 attention's output per (row, head)
            out.add((m, c, c, heads))
        for groups_in in (0, 1):
            g = tq.quant_out_group_width(m, c, 4 * c, groups_in)
            out.add((m, 4 * c, c, 4 * c // g))
    return sorted(out)


def _check_plan(m, k, n, groups, sms=tq.H100_SMS):
    plan = tq.qmm_sm90_plan(m, n, k, groups, sms)
    bn = plan["bn"]
    assert plan["bm"] == 128 and bn in WGMMA_S8_N, (m, k, n, groups, plan)
    assert plan["tiles"] == -(-m // 128) * -(-n // bn)
    assert plan["grid"] == min(plan["tiles"], sms) and plan["persistent"] == (plan["tiles"] > sms)
    smem = 1024 + plan["stages"] * (128 + bn) * 128 + 128 * (bn + 8) * 4 + 256
    assert plan["smem_bytes"] == smem <= tq.QMM_SM90_SMEM_LIMIT
    assert 1 <= plan["stages"] <= tq.QMM_SM90_MAX_STAGES
    # no more stages would fit
    assert (plan["stages"] == tq.QMM_SM90_MAX_STAGES
            or smem + (128 + bn) * 128 > tq.QMM_SM90_SMEM_LIMIT)
    return plan


@pytest.mark.parametrize("phi", PHIS)
def test_plan_fits_every_serving_launch(phi):
    """Every qmm launch of the int8 forwards of `phi` at batch 1, 2 and 32
    gets a plan that fits; with one scale group the large launches take
    128-column tiles, and a plan of fewer tiles than SMs is one that
    narrower tiles could not fill in one wave either."""
    for batch in BATCHES:
        for m, k, n, groups in qmm_launches(phi, batch):
            assert tq.kernel_supports(m, k, n, groups), (m, k, n, groups)
            plan = _check_plan(m, k, n, groups)
            if groups == 1 and m >= 12800:
                assert plan["bn"] == 128, (m, k, n, plan)
            if plan["tiles"] < tq.H100_SMS and plan["bn"] > 64:
                assert -(-m // 128) * -(-n // 64) > tq.H100_SMS, (m, k, n, plan)


def test_plan_small_launches_and_kernel_phases():
    """The launches 128 x 128 tiles would leave most SMs idle take
    narrower tiles (phi='s' h6 at batch 1: 128 tiles of 64 columns, not 64
    of 128); the phi 'l' / 'x' kernel-phase launches (256 rows, full
    widths) and odd shapes plan as well; K is padded to 16 for TMA."""
    plan = _check_plan(400, 2048, 2048, 1)
    assert plan["bn"] == 64 and plan["tiles"] == 128 and not plan["persistent"]
    assert _check_plan(800, 2048, 2048, 1)["bn"] == 128
    assert _check_plan(3200, 8192, 2048, 16)["bn"] == 128  # G: the pre-pass's, not the tiles'
    for phi in ("l", "x"):
        c = teb_sites(phi)["h1"][1]
        for k, n in ((c, 3 * c), (c, c)):
            _check_plan(256, k, n, 1)
    for m, k, n, g in ((1, 1, 1, 1), (77, 48, 33, 4), (3200, 849, 2547, 1), (3200, 3396, 849, 1),
                       (3200, 4792, 14376, 1), (12800, 19168, 4792, 1)):
        _check_plan(m, k, n, g)
        assert (k + (-k % tq.K_MULTIPLE)) % 16 == 0
    with pytest.raises(ValueError, match="multiple of 4"):
        tq.qmm_sm90_plan(128, 128, 96, 16)  # groups of 6 columns


def test_mma_sync_gemm_deleted():
    """csrc/quant_matmul.cu keeps quant_rows and the row pass only; the
    GEMM is csrc/qmm_sm90.cu's, which the wrapper loads."""
    src = (CSRC / "quant_matmul.cu").read_text()
    assert "mma.sync" not in src and "mma_s8" not in src and "int qmm(" not in src
    assert "int quant_rows(" in src and "int qmm_rows_out(" in src
    sm90 = (CSRC / "qmm_sm90.cu").read_text()
    assert "wgmma_ss<BN>" in sm90 and "requant_rows_kernel" in sm90 and "mma.sync." not in sm90
    assert "qmm_sm90" in tq._sm90_lib.__code__.co_consts


# ---------------------------------------------------------------------------
# the requantize's arithmetic
# ---------------------------------------------------------------------------


def _requant4(x: torch.Tensor, ratio: torch.Tensor) -> torch.Tensor:
    """csrc/qmm_sm90.cu::requant4 in fp32 tensor arithmetic: x + 128 in the
    mantissa of 2^23 less 2^23 + 128, times ratio, plus 1.5 * 2^23, the low
    byte of the bits as int8."""
    u = (x.to(torch.int32) + 128) | 0x4B000000
    xf = u.view(torch.float32) - torch.tensor(8388736.0)
    t = xf * ratio + torch.tensor(12582912.0)
    low = t.view(torch.int32) & 0xFF
    return ((low ^ 0x80) - 0x80).to(torch.int8)


def test_requant_arithmetic_matches_rint():
    """Every int8 value against ratios across (0, 1] (the quantizers'
    scale ratios, 1 included): the magic-number requantize equals
    rint(x * ratio) rounded half to even, as `_requant` computes it."""
    rng = np.random.default_rng(0)
    x = torch.arange(-128, 128, dtype=torch.int8)[:, None]
    ratio = torch.from_numpy(np.concatenate([
        rng.uniform(0.0, 1.0, 500), rng.uniform(0.99, 1.0, 100), [1.0, 0.5, 0.25, 1e-8],
        np.arange(1, 128) / 127.0]).astype(np.float32))[None, :]
    ref = torch.round(x.float() * ratio).to(torch.int8)
    assert torch.equal(_requant4(x.expand(-1, ratio.shape[1]), ratio), ref)


# ---------------------------------------------------------------------------
# the kernel's tiling
# ---------------------------------------------------------------------------

SLAB = 128
GROUP_M = 8


def _tile_of(t, tiles_m, tiles_n):
    """csrc/qmm_sm90.cu::tile_of: groups of 8 row tiles, column by column."""
    per_group = GROUP_M * tiles_n
    first = (t // per_group) * GROUP_M
    rows = min(tiles_m - first, GROUP_M)
    r = t % per_group
    return first + r % rows, r // rows


def _prepass(xq, xs, kp, fault=None):
    """The requantize pre-pass (G > 1): each 4-byte word of a row by the
    ratio of its group, s_g / max(max_g s_g, 1e-30), into a row of kp
    bytes, zeros past K."""
    m, k = xq.shape
    groups = xs.shape[1]
    smax = xs.amax(1).clamp(min=1e-30)
    g = torch.arange(k) // 4 * 4 // (k // groups)
    if fault == "group_neighbour_ratio":
        g = (g + 1) % groups
    out = _requant4(xq, xs[:, g] / smax[:, None])
    return F.pad(out, (0, kp - k))


def _emulate(xq, xs, wq, ws, bias, act, res, out_dtype, bn, fault=None):
    """The kernel's arithmetic tile by tile: A requantized by the pre-pass
    (G > 1) or zero-padded to wq's row length (the wrapper), both operands
    zero-filled to whole 128-byte slabs (TMA); per tile, slab by slab, the
    int32 sum; then phase 1 __fmul_rn(float(acc), row scale) and phase 2
    x w_scale, + bias, activation, + residual, stored in out_dtype."""
    m, k = xq.shape
    n, kp = wq.shape
    groups = xs.shape[1]
    slabs = -(-kp // SLAB)
    a_all = _prepass(xq, xs, kp, fault) if groups > 1 else F.pad(xq, (0, kp - k))
    a_all = F.pad(a_all, (0, slabs * SLAB - kp))
    b_all = F.pad(wq, (0, slabs * SLAB - kp))
    smax = xs.amax(1).clamp(min=1e-30) if groups > 1 else xs[:, 0]
    tiles_m, tiles_n = -(-m // 128), -(-n // bn)
    out = torch.zeros((m, n), dtype=torch.float32)
    seen = set()
    for t in range(tiles_m * tiles_n):
        mt, nt = _tile_of(t, tiles_m, tiles_n)
        seen.add((mt, nt))
        r0, c0 = mt * 128, nt * bn
        a_t = torch.zeros((128, slabs * SLAB), dtype=torch.int8)
        b_t = torch.zeros((bn, slabs * SLAB), dtype=torch.int8)
        a_t[:min(128, m - r0)] = a_all[r0:r0 + 128]
        b_t[:min(bn, n - c0)] = b_all[c0:c0 + bn]
        acc = torch.zeros((128, bn), dtype=torch.int64)
        for s in range(slabs):
            if fault == "slab_dropped" and s == 1:
                continue
            src = 0 if fault == "slab_read_twice" and s == 1 else s
            acc += (a_t[:, src * SLAB:(src + 1) * SLAB].long()
                    @ b_t[:, src * SLAB:(src + 1) * SLAB].long().T)
        rs = torch.zeros(128)
        rows_in = min(128, m - r0)
        rs[:rows_in] = smax[r0:r0 + rows_in]
        staged = acc.float() * rs[:, None]                      # phase 1
        cols_in = min(bn, n - c0)
        v = staged[:rows_in, :cols_in] * ws[c0:c0 + cols_in]    # phase 2
        if bias is not None:
            v = v + bias[c0:c0 + cols_in]
        if act == "gelu":
            v = F.gelu(v, approximate="tanh")
        elif act == "silu":
            v = v * torch.sigmoid(v)
        if res is not None:
            v = v + res[r0:r0 + rows_in, c0:c0 + cols_in].float()
        if fault == "second_warpgroup_rows_unwritten":
            v[64:] = 0.0
        if fault == "last_column_tile_shifted" and nt == tiles_n - 1:
            v = torch.cat([v[:, :1], v[:, :-1]], dim=1)
        out[r0:r0 + rows_in, c0:c0 + cols_in] = v
    assert len(seen) == tiles_m * tiles_n  # the raster is a bijection
    return out.to(out_dtype)


def _bar_used(out, ref) -> float:
    if out.dtype == torch.int8:
        diff = (out.int() - ref.int()).abs()
        share = float((diff > 0).float().mean())
        return max(float(diff.max()) if int(diff.max()) > 1 else 0.0, share / PAYLOAD_FLIP_SHARE)
    diff = (out.float() - ref.float()).abs()
    mag = ref.float().abs()
    return float((diff / (RTOL8 * mag + ATOL8_OF_MAX * mag.max())).max())


def _case(m, k, n, groups, act, res_dtype, out_dtype, seed=0):
    rng = np.random.default_rng(seed)
    t = torch.from_numpy
    xq = t(rng.integers(-127, 128, (m, k)).astype(np.int8))
    xs = t(rng.uniform(0.01, 0.06, (m, groups)).astype(np.float32))
    w = t((rng.standard_normal((n, k)) / np.sqrt(k)).astype(np.float32))
    bias = t((rng.standard_normal(n) * 0.1).astype(np.float32))
    wts = tq.prepare_weights(w, bias)
    res = None if res_dtype is None else t(rng.standard_normal((m, n)).astype(np.float32)).to(
        res_dtype)
    return xq, xs, wts, res


TILING_CASES = (  # (M, K, N, G, act, residual, out)
    (200, 320, 201, 1, None, None, torch.bfloat16),      # ragged M, odd N
    (200, 300, 200, 1, "gelu", torch.bfloat16, torch.bfloat16),  # K % 16 != 0
    (200, 320, 200, 4, None, torch.bfloat16, torch.bfloat16),
    (130, 320, 129, 16, "silu", torch.float32, torch.float32),
    (256, 400, 136, 4, None, None, torch.float32),        # groups of 100 columns straddle slabs
)


@pytest.mark.parametrize("bn", WGMMA_S8_N)
@pytest.mark.parametrize("case", range(len(TILING_CASES)))
def test_kernel_tiling_matches_plain(case, bn):
    """The emulated kernel equals qmm_plain bit for bit, at every tile
    width the plan can pick."""
    m, k, n, groups, act, res_dtype, out_dtype = TILING_CASES[case]
    xq, xs, wts, res = _case(m, k, n, groups, act, res_dtype, out_dtype)
    ref = tq.qmm_plain(xq, xs, wts["wq"], wts["w_scale"], wts["bias"], act, res,
                       out_dtype=out_dtype)
    out = _emulate(xq, xs, wts["wq"], wts["w_scale"], wts["bias"], act, res, out_dtype, bn)
    assert torch.equal(out, ref)


PLANTED = ("slab_read_twice", "slab_dropped", "group_neighbour_ratio",
           "second_warpgroup_rows_unwritten", "last_column_tile_shifted")


@pytest.mark.parametrize("fault", PLANTED)
def test_planted_faults_miss_the_int8_bar(fault):
    """Each fault of the design moves the output past the int8 bar (the
    group fault, in the pre-pass, at G = 16; the others at G = 1 and 16),
    bf16 and quant_out outputs alike."""
    cases = [(256, 320, 200, 16, None, torch.bfloat16, torch.bfloat16)]
    if fault != "group_neighbour_ratio":
        cases.append((256, 320, 200, 1, "gelu", None, torch.bfloat16))
    for m, k, n, groups, act, res_dtype, out_dtype in cases:
        xq, xs, wts, res = _case(m, k, n, groups, act, res_dtype, out_dtype, seed=1)
        bn = tq.qmm_sm90_plan(m, n, k, groups)["bn"]
        args = (xq, xs, wts["wq"], wts["w_scale"], wts["bias"], act, res, torch.float32, bn)
        ref = _emulate(*args)
        bad = _emulate(*args, fault=fault)
        assert _bar_used(bad.bfloat16(), ref.bfloat16()) > 1.0, (fault, groups)
        # the quantized outputs' payload, from the same fp32 workspace
        qref, _ = tq._output_plain(ref, torch.bfloat16, n // 8 if n % 8 == 0 else n, None)
        qbad, _ = tq._output_plain(bad, torch.bfloat16, n // 8 if n % 8 == 0 else n, None)
        assert _bar_used(qbad, qref) > 1.0, (fault, groups)


# ---------------------------------------------------------------------------
# weights padded once
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", (849, 4792))
def test_padded_weights_leave_plain_unchanged(k):
    """prepare_weights pads K to 16 once: the originals plus zero columns;
    qmm_plain on them gives the bits it gives on the unpadded weights."""
    rng = np.random.default_rng(k)
    m, n = 64, 48
    w = torch.from_numpy((rng.standard_normal((n, k)) / np.sqrt(k)).astype(np.float32))
    bias = torch.from_numpy((rng.standard_normal(n) * 0.1).astype(np.float32))
    wts = tq.prepare_weights(w, bias)
    wq, w_scale = tq.quantize_weights(w)
    kp = k + (-k % 16)
    assert tuple(wts["wq"].shape) == (n, kp) and kp % 16 == 0
    assert torch.equal(wts["wq"][:, :k], wq) and not wts["wq"][:, k:].any()
    assert torch.equal(tq.pad_k(wq), wts["wq"]) and tq.pad_k(wts["wq"]) is wts["wq"]
    xq = torch.from_numpy(rng.integers(-127, 128, (m, k)).astype(np.int8))
    xs = torch.from_numpy(rng.uniform(0.01, 0.05, (m, 1)).astype(np.float32))
    res = torch.from_numpy(rng.standard_normal((m, n)).astype(np.float32)).bfloat16()
    for kw in ({}, {"act": "gelu", "residual": res}, {"quant_out_group": n}):
        a = tq.qmm_plain(xq, xs, wts["wq"], w_scale, wts["bias"], **kw)
        b = tq.qmm_plain(xq, xs, wq, w_scale, wts["bias"], **kw)
        for x, y in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
            assert torch.equal(x, y)
    w4 = tq.prepare_weights4(w, bias)["wq"]
    assert tuple(w4.shape) == (n, kp) and not w4[:, k:].any()


def test_qmm_passes_prepared_weights_through():
    """At K = 849 the GEMM's operands are the prepared wq itself (no
    per-call copy) and xq padded with zero columns to 864; weights that
    were not padded are refused, not copied."""
    rng = np.random.default_rng(5)
    k, n, m = 849, 40, 24
    w = torch.from_numpy(rng.standard_normal((n, k)).astype(np.float32))
    wq = tq.prepare_weights(w)["wq"]
    xq = torch.from_numpy(rng.integers(-127, 128, (m, k)).astype(np.int8))
    xp, wp, xr = tq._sm90_operands(xq, wq)
    assert wp is wq and wp.data_ptr() == wq.data_ptr() and xr is None
    assert tuple(xp.shape) == (m, 864) and torch.equal(xp[:, :k], xq) and not xp[:, k:].any()
    x16 = xq[:, :848].contiguous()
    assert tq._sm90_operands(x16, wq[:, :848].contiguous())[0] is x16  # K % 16 == 0: no copy
    # G > 1: xq as it is, and the pre-pass's padded workspace
    x4 = xq[:, :848].contiguous()
    xp, wp, xr = tq._sm90_operands(x4, wq[:, :848].contiguous(), groups=4)
    assert xp is x4 and tuple(xr.shape) == (m, 848) and xr.dtype == torch.int8
    with pytest.raises(ValueError, match="prepare_weights pads it once"):
        tq._sm90_operands(xq, tq.quantize_weights(w)[0])


def test_wrappers_raise_off_cpu_and_counters_clear():
    """qmm and quant_rows on a tensor that is neither on the CPU nor on a
    card raise before anything is built and count nothing;
    reset_launch_counts clears every counter."""
    tq.qmm.launches, tq.quant_rows.launches, tq.quant_rows.launches_int4 = 3, 4, 5
    tq.reset_launch_counts()
    assert tq.qmm.launches == tq.quant_rows.launches == tq.quant_rows.launches_int4 == 0
    meta = lambda *s, dt=torch.int8: torch.empty(*s, dtype=dt, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        tq.qmm(meta(256, 864), meta(256, 1, dt=torch.float32), meta(128, 864),
               meta(128, dt=torch.float32))
    with pytest.raises(ValueError, match="CUDA tensor"):
        tq.quant_rows(meta(256, 849, dt=torch.bfloat16), True)
    assert tq.qmm.launches == tq.quant_rows.launches == 0


def _plant(monkeypatch, fault, bn):
    """The design's faults planted in qmm_plain's own steps, as
    chip_smoke.py plants them: the int8 dot (K slabs), the requantize (a
    group's ratio) and the epilogue (rows and columns of the tiles)."""
    if fault in ("slab_read_twice", "slab_dropped"):
        real = tq._int_dot

        def faulty(a, b):
            a, b = a.clone(), b.clone()
            if fault == "slab_dropped":
                a[..., 128:256] = 0
            else:
                a[..., 128:256], b[..., 128:256] = a[..., :128], b[..., :128]
            return real(a, b)
        monkeypatch.setattr(tq, "_int_dot", faulty)
    elif fault == "group_neighbour_ratio":
        def faulty(xq, x_scales):
            smax = torch.clamp(x_scales.amax(dim=-1, keepdim=True), min=1e-30)
            ratio = (torch.roll(x_scales, -1, dims=-1) / smax)[..., None]
            x3 = xq.reshape(*xq.shape[:-1], x_scales.shape[-1], -1).float()
            return torch.round(x3 * ratio).reshape(xq.shape).to(torch.int8), smax
        monkeypatch.setattr(tq, "_requant", faulty)
    else:
        real = tq._epilogue_plain

        def faulty(acc, *args):
            out = real(acc, *args)
            if fault == "second_warpgroup_rows_unwritten":
                rows = torch.arange(out.shape[0])
                return torch.where(((rows % 128) >= 64)[:, None], torch.zeros_like(out), out)
            c0 = (out.shape[-1] - 1) // bn * bn
            return torch.cat([out[:, :c0 + 1], out[:, c0:-1]], dim=1)
        monkeypatch.setattr(tq, "_epilogue_plain", faulty)


@pytest.mark.parametrize("fault", PLANTED)
def test_planted_faults_move_qmm_plain(monkeypatch, fault):
    """Each fault planted in qmm_plain itself moves its output past the
    int8 bar, at the phi='n' h1 qkv shape (K = 849, odd N) and at G = 16."""
    cases = [(256, 320, 200, 16, None)]
    if fault != "group_neighbour_ratio":
        cases.append((256, 849, 2547 // 3, 1, "gelu"))
    for m, k, n, groups, act in cases:
        xq, xs, wts, _ = _case(m, k, n, groups, act, None, torch.bfloat16, seed=2)
        args = (xq, xs, wts["wq"], wts["w_scale"], wts["bias"], act)
        ref = tq.qmm_plain(*args)
        with monkeypatch.context() as mp:
            _plant(mp, fault, tq.qmm_sm90_plan(m, n, k, groups)["bn"])
            bad = tq.qmm_plain(*args)
        assert _bar_used(bad, ref) > 1.0, (fault, groups)
