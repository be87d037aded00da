"""int8 dense projections of the serving path: [LayerNorm ->] per-row int8
quantize -> int8 x int8 -> int32 GEMM -> dequant epilogue, with two CUDA
kernels written for Hopper and their plain PyTorch versions.

Counterpart of transparent_object_detection_tpu/ops/quant_matmul.py. Layouts
are PyTorch's: a weight is a `Linear.weight` (N, K), so the per-output-channel
weight scale is a max over dim 1 (the JAX kernel's (K, N) axis 0).

The function (the JAX kernel's, on its TPU dispatch):
  * weights: LN affine folded in (`fold_ln`), then per-output-channel
    symmetric int8, `round(w / (amax / 127))` (a divide);
  * activations: per row, `d = x - mean` when LN runs, `var = max(E[x^2] -
    mean^2, 0)`, payload `round(d * (127 / amax|d|))` (a reciprocal
    multiply), scale `amax / 127 * rsqrt(var + eps)` (rsqrt rides the scale);
  * int32 accumulation to the end, then `acc * row_scale * w_scale (+ bias)
    (gelu tanh | silu) (+ residual, in fp32)`;
  * outputs: bf16; or `quant_out`, int8 + one scale per (row, group of
    `group` columns), `round(v * (127 / amax))`, taken from the fp32 value;
    or `ln_out`, bf16 plus the LN-normalized int8 payload of the fp32 value
    and its per-row scale (the attn_out -> mlp1 handoff).
  * Rounding is half to even throughout, as `jnp.round` rounds.

Kernels: `quant_rows` (csrc/quant_matmul.cu; replaces `_quant_rows_kernel`)
quantizes bf16 or fp32 rows of any width, each row read once into registers
by a team of threads (`quant_rows_team`); `qmm` (csrc/qmm_sm90.cu, int8
wgmma fed by a TMA ring, on the tiles of `qmm_sm90_plan`; replaces
`_qmm_kernel`) takes int8 rows with 1 or G > 1 scale groups (G > 1: each
group is requantized onto the row's largest scale first, the JAX prologue,
in a pre-pass of the same source), any M, N and K, and writes bf16 or fp32
(with a bf16 or fp32 residual); its quantized outputs add the row pass of
csrc/quant_matmul.cu. A bf16 or fp32 input runs as quant_rows then qmm, the
JAX split route (`_pquant_call`) on every shape. Where the JAX dispatch
leaves its kernel for `_qmm_reference` (K not a multiple of 128, N not of
256: phi='n' and 'm' h1 / h6, every fp32-compute model's odd widths), that
reference computes the same function with one quant_out scale a row;
`quant_out_group_width` says G = 1 there, and the kernels compute it.

Weights are int8 (N, K) rows padded with zero columns to K % 16 = 0 once,
in `prepare_weights` (TMA reads rows of 16-byte multiples); the plain
version reads their first K columns.

The quant_out group width is part of the numbers: the consumer (mlp2, or
attention in the qkv handoff) sees G = N / group scale groups.
`quant_out_group_width` is the port's copy of the integer rules by which the
JAX dispatch on a TPU picks it (`_pick_blocks` with its `align` rule,
`_pick_layout_prequant`), kept as a numerics contract, not as a tuning.

w4a4 (`quant_matmul_w4a4`, the TOD_W4A4_MLP1 mlp1): weights per output
channel and rows onto the int4 range [-7, 7] (scale amax / 7), stored int8:
the same integers on Hopper's int8 tensor cores as an int4 MMA would give.
On the card `quant_rows(qmax=7)` (the JAX `_w4a4_call` launch of
`_quant_rows_kernel`) then `qmm`.

Each wrapper launches its kernel for CUDA tensors (or raises) and runs its
plain version for CPU tensors; the front ends reach them through their
registered operators (`torch.ops.focus.*`, ops/library.py; `qmm_op` picks
the operator of qmm's output form). `impl="plain"` runs the plain versions
on any device, for comparison only.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from transparent_object_detection_tpu_torch.config import Int8Variants

ACTS = (None, "gelu", "silu")
IMPLS = (None, "plain")
_VMEM_BUDGET = 15 * 1024 * 1024 + 512 * 1024
K_MULTIPLE = 16  # qmm's rows are read by TMA: row strides of 16-byte multiples


# ---------------------------------------------------------------------------
# weights and routing rules
# ---------------------------------------------------------------------------


def fold_ln(w: torch.Tensor, bias: Optional[torch.Tensor], ln_scale: torch.Tensor,
            ln_bias: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """LN(x) @ W^T + b == z @ W_eff^T + b_eff for normalized z. w (N, K)
    fp32; the matrix-vector product runs in fp32 with TF32 off."""
    w = w.float()
    w_eff = w * ln_scale.float()[None, :]
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        bias_eff = torch.mv(w, ln_bias.float())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    if bias is not None:
        bias_eff = bias_eff + bias.float()
    return w_eff, bias_eff


def pad_k(wq: torch.Tensor) -> torch.Tensor:
    """int8 (N, K) -> (N, K rounded up to K_MULTIPLE), the new columns 0:
    the row stride the GEMM kernel's TMA loads need. Leaves every dot
    product unchanged."""
    pad = -wq.shape[-1] % K_MULTIPLE
    return F.pad(wq, (0, pad)) if pad else wq


def quantize_weights(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 (N, K) -> (int8 (N, K), f32 (N,) per-output-channel scale)."""
    w = w.float()
    w_scale = w.abs().amax(dim=1) / 127.0
    wq = torch.round(w / torch.clamp(w_scale, min=1e-12)[:, None]).to(torch.int8)
    return wq, w_scale


def dequantize(payload: torch.Tensor, scales: torch.Tensor,
               dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """(..., N) int8 + (..., G) f32 -> (..., N) values."""
    g = payload.shape[-1] // scales.shape[-1]
    p3 = payload.reshape(*payload.shape[:-1], scales.shape[-1], g)
    return (p3.float() * scales[..., None]).reshape(payload.shape).to(dtype)


def prefer_split(m: int, k: int, n: int, ln: bool, act, residual) -> bool:
    """Where the JAX dispatch takes its split route (quant pass + plain int8
    GEMM): the qkv projections from 51,200 rows. The port runs every bf16
    input that way (same function as the fused kernel); the rule says which
    JAX kernel a launch stands for (quant_rows replaces _quant_rows_kernel
    only there)."""
    return (ln and act is None and residual is None
            and n == 3 * k and m >= 51200 and m % 512 == 0)


def _pick_blocks(m: int, k: int, n: int, residual: bool = True, x_bytes: int = 2,
                 out_bytes: int = 2, align: Optional[Tuple[int, int]] = None,
                 full_width_only: bool = False) -> Optional[Tuple[int, int]]:
    """(bm, bn) of the JAX kernel's bf16-input dispatch (v5e VMEM model);
    only bn matters here, as the quant_out group width. `align=(section,
    dh)`: a tile narrower than n must tile the section and cover whole
    heads (the qkv -> attention handoff)."""
    def vmem(bm: int, bn: int) -> int:
        chunk = min(bm, 256)
        resident = bn == n
        return (2 * bm * k * x_bytes + bm * k + chunk * k * 4
                + (1 if resident else 2) * k * bn + 2 * bm * bn * out_bytes
                + (2 * bm * bn * 2 if residual else 0) + bm * bn * 4)

    def bn_ok(bn: int) -> bool:
        if align is None or bn == n:
            return True
        section, dh = align
        return section % bn == 0 and bn % dh == 0

    resident_bms = (1024, 512, 256) if x_bytes == 2 and out_bytes == 2 else (1024, 512, 256, 128)
    for bm in resident_bms:
        if m % bm == 0 and vmem(bm, n) <= _VMEM_BUDGET:
            return bm, n
    if full_width_only:
        return None
    if n <= 1536 and k <= 2048:
        for bm in (1024, 512, 256, 128):
            if m % bm:
                continue
            for bn in (768, 512, 256):
                if n % bn == 0 and bn_ok(bn) and vmem(bm, bn) <= _VMEM_BUDGET:
                    return bm, bn
    else:
        for bn in (768, 512, 256):
            if n % bn or not bn_ok(bn):
                continue
            for bm in (512, 256, 128):
                if m % bm == 0 and vmem(bm, bn) <= _VMEM_BUDGET:
                    return bm, bn
    return None


def _pick_layout_prequant(m: int, k: int, n: int, groups: int,
                          residual: bool) -> Optional[Tuple[bool, int, int]]:
    """(m_inner, bm, bn) of the JAX kernel's int8-input dispatch."""
    g = k // groups

    def vmem(bm: int, bn: int, m_in: bool) -> int:
        resident = (not m_in) and bn == n
        scratch = 0 if groups == 1 else bm * k + bm * 128 * 4
        temp = 0 if groups == 1 else bm * g * 4
        return (2 * bm * k + scratch + temp + (1 if resident else 2) * k * bn
                + 2 * bm * bn * 2 + (2 * bm * bn * 2 if residual else 0) + bm * bn * 4)

    best = None
    for bm in (1024, 512, 256, 128):
        if m % bm:
            continue
        for bn in dict.fromkeys((n, 768, 512, 256)):
            if n % bn:
                continue
            for m_in in (False, True):
                if (m_in and bn == n) or vmem(bm, bn, m_in) > _VMEM_BUDGET:
                    continue
                if m_in:
                    traffic = (n // bn) * m * k + k * n
                else:
                    traffic = m * k + (k * n if bn == n else (m // bm) * k * n)
                key = (traffic, -bm)
                if best is None or key < best[0]:
                    best = (key, m_in, bm, bn)
    return None if best is None else best[1:]


def _tiles_on_tpu(k: int, n: int, groups_in: int) -> bool:
    """Shapes on which the JAX dispatch runs its kernel at all."""
    return (k % 128 == 0 and n % 256 == 0
            and (groups_in == 0 or (k % groups_in == 0 and (k // groups_in) % 128 == 0)))


def quant_out_group_width(m: int, k: int, n: int, groups_in: int, residual: bool = False,
                          align: Optional[Tuple[int, int]] = None) -> int:
    """Scale-group width of a quant_out projection's output, as the JAX
    dispatch on a TPU gives it: the kernel's n-tile where the kernel runs,
    n (one scale per row) where it falls back. `groups_in` is the input's
    mode: 0 for bf16 rows, G >= 1 for int8 rows with G scale groups.
    `align=(section, dh)` (bf16 rows only, as in JAX): groups that tile
    the section and cover whole heads of width dh."""
    if not _tiles_on_tpu(k, n, groups_in):
        return n
    if groups_in == 0:
        blocks = _pick_blocks(m, k, n, residual=residual, out_bytes=1, align=align)
        return n if blocks is None else blocks[1]
    layout = _pick_layout_prequant(m, k, n, groups_in, residual)
    return n if layout is None else layout[2]


def ln_handoff(m: int, c: int, min_rows: int = Int8Variants.ln_handoff_min_rows) -> bool:
    """Whether the int8 TEB hands attn_out's LN2-normalized payload to mlp1
    (JAX blocks.py: the row floor, then ln_quant_out_supported on a TPU);
    the TEB also needs `Int8Variants.ln_handoff` on and w4a4 off."""
    if m < min_rows:
        return False
    if c % 256:
        return True  # the JAX dispatch falls back for the whole call
    return _pick_blocks(m, c, c, residual=True, out_bytes=3, full_width_only=True) is not None


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _int_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int8 (M, K) x int8 (N, K)^T as float64 (every partial sum of
    int8 products below 2^53 is exact), on any device."""
    return torch.matmul(a.double(), b.double().transpose(-1, -2))


def _row_quant(d: torch.Tensor, floor: float,
               qmax: int = 127) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric quantize of fp32 rows d (..., K) onto [-qmax, qmax]
    (stored int8): payload and amax / qmax."""
    amax = torch.clamp(d.abs().amax(dim=-1, keepdim=True), min=floor)
    q = torch.round(d * (torch.full_like(amax, float(qmax)) / amax)).to(torch.int8)
    return q, amax * (1.0 / qmax)


def _ln_stats(xf: torch.Tensor, eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x - mean, rsqrt(max(E[x^2] - mean^2, 0) + eps)) over the last axis."""
    mu = xf.mean(dim=-1, keepdim=True)
    m2 = (xf * xf).mean(dim=-1, keepdim=True)
    var = torch.clamp(m2 - mu * mu, min=0.0)
    return xf - mu, torch.rsqrt(var + eps)


def quant_rows_plain(x: torch.Tensor, ln: bool, eps: float = 1e-6, qmax: int = 127):
    """(M, K) -> int8 (M, K), f32 (M, 1): [LN-normalize +] per-row quantize
    onto [-qmax, qmax] (127: int8; 7: the int4 range of w4a4)."""
    xf = x.float()
    if ln:
        d, rstd = _ln_stats(xf, eps)
    else:
        d, rstd = xf, 1.0
    q, s = _row_quant(d, 1e-12, qmax)
    return q, s * rstd


def _requant(xq: torch.Tensor, x_scales: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(row, group) int8 onto the row's largest scale (G > 1)."""
    groups = x_scales.shape[-1]
    if groups == 1:
        return xq, x_scales
    smax = torch.clamp(x_scales.amax(dim=-1, keepdim=True), min=1e-30)
    ratio = (x_scales / smax)[..., None]
    x3 = xq.reshape(*xq.shape[:-1], groups, -1).float()
    return torch.round(x3 * ratio).reshape(xq.shape).to(torch.int8), smax


def _epilogue_plain(acc, row_scale, w_scale, bias, act, residual):
    out = acc.float() * row_scale * w_scale
    if bias is not None:
        out = out + bias
    if act == "gelu":
        out = F.gelu(out, approximate="tanh")
    elif act == "silu":
        out = out * torch.sigmoid(out)
    if residual is not None:
        out = out + residual.float()
    return out


def _output_plain(out, out_dtype, quant_out_group, ln_out_eps):
    if quant_out_group is not None:
        n = out.shape[-1]
        o3 = out.reshape(*out.shape[:-1], n // quant_out_group, quant_out_group)
        amax = torch.clamp(o3.abs().amax(dim=-1, keepdim=True), min=1e-30)
        payload = torch.round(o3 * (torch.full_like(amax, 127.0) / amax)).to(torch.int8)
        return payload.reshape(out.shape), amax[..., 0] * (1.0 / 127.0)
    if ln_out_eps is not None:
        d, rstd = _ln_stats(out, ln_out_eps)
        q, s = _row_quant(d, 1e-12)
        return out.to(out_dtype), q, s * rstd
    return out.to(out_dtype)


def qmm_plain(xq, x_scales, wq, w_scale, bias=None, act=None, residual=None,
              quant_out_group=None, ln_out_eps=None, out_dtype=torch.bfloat16):
    """Plain version of `qmm` (the JAX `_qmm_reference` on pre-quantized x);
    wq (N, K) or padded (`pad_k`): its first K columns."""
    wq = wq[:, :xq.shape[-1]]
    xq, row_scale = _requant(xq, x_scales)
    out = _epilogue_plain(_int_dot(xq, wq), row_scale, w_scale, bias, act, residual)
    return _output_plain(out, out_dtype, quant_out_group, ln_out_eps)


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------


_LIBS: Dict[str, ctypes.CDLL] = {}  # loaded once: quant_rows' launches are a few microseconds


def _lib():
    lib = _LIBS.get("quant_matmul")
    if lib is not None:
        return lib
    from transparent_object_detection_tpu_torch.kernels import _build

    lib = _build.load("quant_matmul")
    if not getattr(lib, "_argtypes_set", False):
        vp, ci, cl, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        lib.quant_rows.argtypes = [vp, vp, vp, cl, ci, ci, ci, ci, cf, cf, cf, ci, vp]
        lib.quant_rows.restype = ci
        lib.qmm_rows_out.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, cf, vp]
        lib.qmm_rows_out.restype = ci
        lib._argtypes_set = True
    _LIBS["quant_matmul"] = lib
    return lib


def _sm90_lib():
    from transparent_object_detection_tpu_torch.kernels import _build

    lib = _build.load("qmm_sm90")
    if not getattr(lib, "_argtypes_set", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.qmm_sm90.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci,
                                 ci, vp, vp]
        lib.qmm_sm90.restype = ci
        lib._argtypes_set = True
    return lib


def _check(name: str, t: torch.Tensor, dtype, shape=None) -> None:
    dtypes = dtype if isinstance(dtype, tuple) else (dtype,)
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name}: the kernel takes {dtypes}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")


_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)  # CUDA builds only


def _stream(t: torch.Tensor) -> int:
    """The raw handle of t's device's current stream (where the build has
    the call the stream object wraps: a few microseconds less host time a
    launch)."""
    if _RAW_STREAM is not None:
        return _RAW_STREAM(t.device.index)
    return torch.cuda.current_stream(t.device).cuda_stream


QMAX = (127, 7)
FLOAT_DTYPES = (torch.bfloat16, torch.float32)


def quant_rows(x: torch.Tensor, ln: bool, eps: float = 1e-6, qmax: int = 127):
    """[LN-normalize +] per-row quantize onto [-qmax, qmax]: bf16 or fp32
    (M, K), any K -> int8 (M, K), f32 (M, 1). Port of
    ops/quant_matmul.py::_quant_rows_kernel,
    which JAX launches with qmax 127 (`_pquant_call`; counted on
    `quant_rows.launches`) and with qmax 7 (`_w4a4_call`; counted on
    `quant_rows.launches_int4`). A CUDA tensor launches csrc/quant_matmul.cu
    (one kernel for both input types: a team of threads a row, the row read
    once, `quant_rows_team` says how); a CPU tensor runs
    `quant_rows_plain`."""
    if qmax not in QMAX:
        raise ValueError(f"quant_rows takes qmax in {QMAX}, got {qmax}")
    if x.device.type == "cpu":
        return quant_rows_plain(x, ln, eps, qmax)
    m, k = x.shape
    _check("x", x, FLOAT_DTYPES)
    xq = torch.empty((m, k), dtype=torch.int8, device=x.device)
    xs = torch.empty((m, 1), dtype=torch.float32, device=x.device)
    err = _lib().quant_rows(x.data_ptr(), xq.data_ptr(), xs.data_ptr(), m, k,
                            *quant_rows_team(k, x.element_size()), int(ln), eps, float(qmax),
                            1.0 / qmax, int(x.dtype == torch.float32), _stream(x))
    _raise_on(err, "quant_rows")
    if qmax == 127:
        quant_rows.launches += 1
    else:
        quant_rows.launches_int4 += 1
    return xq, xs


QR_UNIT = 16  # elements a thread of csrc/quant_matmul.cu's quant_rows takes at a time
QR_THREADS = 256


@functools.lru_cache(maxsize=None)
def quant_rows_team(k: int, elem_bytes: int) -> Tuple[int, int]:
    """(threads a row, 16-element units a thread) with which
    csrc/quant_matmul.cu's quant_rows takes rows of k elements of
    `elem_bytes` bytes (the library checks that they cover the row): units
    aligned in the flattened array (a row off the 16-element grid spans one
    more); 4 units a thread in bf16, 2 in fp32 (32 registers of row), on the
    smallest team of 8 to 256 threads that covers the row; past 256 threads
    more units (up to 8 bf16, 4 fp32: 64 registers of row); (256, 0) where
    none holds it (streamed from memory). Measured against the other teams
    and units at every launch shape of the phi n/s/m int8 forwards
    (`kernels/time_serving.py --int8`, PERF.md)."""
    units = -(-k // QR_UNIT) + (1 if k % QR_UNIT else 0)
    upt, upt_max = (2, 4) if elem_bytes == 4 else (4, 8)
    team = 8
    while team < QR_THREADS and team * upt < units:
        team *= 2
    while team * upt < units and upt < upt_max:
        upt *= 2
    if team * upt < units:
        return QR_THREADS, 0
    return team, upt


_ACT_CODE = {None: 0, "gelu": 1, "silu": 2}


def kernel_supports(m: int, k: int, n: int, groups: int = 1) -> bool:
    """Shapes `qmm` takes: any M, N and K; G > 1 input scale groups of a
    multiple of 4 columns (every producer's: quant_out tiles of 256 and up,
    one group a head of a multiple of 128)."""
    return (min(m, k, n, groups) >= 1 and k % groups == 0
            and (groups == 1 or (k // groups) % 4 == 0))


# csrc/qmm_sm90.cu's tiles: 128 rows (64 a consumer warpgroup), a width of
# QMM_SM90_WIDTHS columns (the wgmma N), K slabs of 128 bytes a ring stage
QMM_SM90_ROWS = 128
QMM_SM90_SLAB = 128
QMM_SM90_WIDTHS = (128, 64)
QMM_SM90_MAX_STAGES = 8
QMM_SM90_SMEM_LIMIT = 232448  # dynamic shared memory a block may use (227 KB)
H100_SMS = 132
QMM_SM90_PLAN_KEYS = ("bm", "bn", "stages", "grid", "smem_bytes")
# Work a tile width does per column, relative to 128: 64 re-reads A from
# shared memory for fewer columns (m64n64k32 reads 4 KB for 32 clocks of
# tensor-core work). No 256: see csrc/qmm_sm90.cu, [grid].
_WIDTH_RATE = {128: 1.0, 64: 0.8}


def qmm_sm90_smem_bytes(bn: int, stages: int) -> int:
    """Dynamic shared memory of csrc/qmm_sm90.cu: alignment slack (1 KB),
    the ring, each stage A (128 x 128 bytes) and B (bn x 128 bytes), the
    epilogue's staging tile (128 x (bn + 8) floats), the barriers (256
    bytes)."""
    return (1024 + stages * (QMM_SM90_ROWS + bn) * QMM_SM90_SLAB
            + QMM_SM90_ROWS * (bn + 8) * 4 + 256)


@functools.lru_cache(maxsize=None)
def qmm_sm90_plan(m: int, n: int, k: int, groups: int = 1, sms: int = H100_SMS) -> dict:
    """Launch plan of csrc/qmm_sm90.cu for an (M, K) x (K, N) qmm with G
    input scale groups on a card of `sms` SMs: 128-row tiles of the width
    `bn` whose waves of `sms` tiles cost least (waves x bn over the width's
    relative rate, `_WIDTH_RATE`; ties to the wider): 128 at the large
    launches (M = 12,800 to 204,800: 1,200 to 153,600 tiles), 64 where 128
    would leave most SMs idle (the small-M launches: phi='s' h6 attn_out at
    batch 1, M = 400, N = 2,048, is 64 tiles of 128 columns but 128 of 64;
    at batch 2, M = 800, 112 tiles of 128 beat two waves of 64). The most
    ring stages (up to 8) that fit 227 KB: 4 at 128, 7 at 64. With more
    tiles than SMs the grid is persistent (`sms` blocks walking the tiles,
    the next tile's loads and products under this one's epilogue), else
    one block a tile. G only decides the requantize pre-pass, not the tiles.
    Cached: a forward repeats a few shapes, and its small launches take
    tens of microseconds on the card, beside the wrapper's host time."""
    if not kernel_supports(m, k, n, groups):
        raise ValueError(f"qmm takes groups of a multiple of 4 columns, got M={m} K={k} N={n} "
                         f"G={groups}")
    tiles_m = -(-m // QMM_SM90_ROWS)
    best = None
    for bn in QMM_SM90_WIDTHS:
        tiles = tiles_m * -(-n // bn)
        cost = -(-tiles // sms) * bn / _WIDTH_RATE[bn]
        if best is None or cost < best[0]:
            best = (cost, bn, tiles)
    _, bn, tiles = best
    stages = max(st for st in range(1, QMM_SM90_MAX_STAGES + 1)
                 if qmm_sm90_smem_bytes(bn, st) <= QMM_SM90_SMEM_LIMIT)
    return {"bm": QMM_SM90_ROWS, "bn": bn, "stages": stages, "tiles": tiles,
            "persistent": tiles > sms, "grid": min(tiles, sms),
            "smem_bytes": qmm_sm90_smem_bytes(bn, stages)}


@functools.lru_cache(maxsize=None)
def _plan_arg(m: int, n: int, k: int, groups: int, device: int):
    """The plan of `qmm_sm90_plan` on this card as the library takes it:
    (the int array, a pointer to it), made once a shape."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    plan = qmm_sm90_plan(m, n, k, groups, sms)
    arr = (ctypes.c_int * len(QMM_SM90_PLAN_KEYS))(*(plan[key] for key in QMM_SM90_PLAN_KEYS))
    return arr, ctypes.cast(arr, ctypes.c_void_p)


def _sm90_operands(xq: torch.Tensor, wq: torch.Tensor,
                   groups: int = 1) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """The GEMM's int8 operands as csrc/qmm_sm90.cu's TMA reads them: rows
    of K rounded up to 16 bytes. wq must arrive so (`prepare_weights` pads
    it once) and passes through as it is. With one scale group xq (M, K)
    is padded with zero columns in a copy where K % 16 != 0 (phi 'n' and
    'm' h1 / h6); with G > 1 it passes as it is, beside the (M, K rounded
    up) workspace the requantize pre-pass writes. Returns (xq, wq, xr)."""
    k = xq.shape[1]
    kp = k + (-k % K_MULTIPLE)
    if wq.shape[1] != kp:
        raise ValueError(f"wq must have K rounded up to {K_MULTIPLE} columns ({kp} for K={k}; "
                         f"prepare_weights pads it once), got {wq.shape[1]}")
    if groups > 1:
        return xq, wq, torch.empty((xq.shape[0], kp), dtype=torch.int8, device=xq.device)
    if kp != k:
        xq = F.pad(xq, (0, kp - k))
    return xq, wq, None


def qmm(xq, x_scales, wq, w_scale, bias=None, act=None, residual=None,
        quant_out_group=None, ln_out_eps=None, out_dtype=torch.bfloat16):
    """int8 GEMM with the dequant epilogue. xq int8 (M, K) with x_scales f32
    (M, G); wq int8 (N, K rounded up to 16: `pad_k`, as `prepare_weights`
    gives it), w_scale f32 (N,); bias f32 (N,); residual bf16 or fp32
    (M, N). Returns (M, N) in out_dtype (bf16 or fp32); with
    `quant_out_group`, int8 (M, N) and f32 (M, N / group); with
    `ln_out_eps`, the value (M, N) in out_dtype, int8 (M, N), f32 (M, 1).
    Any M, N and K (G > 1: groups of a multiple of 4 columns).

    Port of ops/quant_matmul.py::_qmm_kernel. A CUDA tensor launches
    csrc/qmm_sm90.cu on the plan of `qmm_sm90_plan` (G > 1: its requantize
    pre-pass first; the quant_out and ln_out outputs as the GEMM into an
    fp32 workspace plus the row pass of csrc/quant_matmul.cu; the launches
    of one call counted as one; xq zero-padded in a copy where K % 16 != 0,
    which leaves every dot product unchanged) or raises; a CPU tensor runs
    `qmm_plain`."""
    if act not in ACTS:
        raise ValueError(f"unknown act {act!r}; choose from {ACTS}")
    if quant_out_group is not None and ln_out_eps is not None:
        raise ValueError("quant_out and ln_out are exclusive")
    if xq.device.type == "cpu":
        return qmm_plain(xq, x_scales, wq, w_scale, bias, act, residual, quant_out_group,
                         ln_out_eps, out_dtype)
    if out_dtype not in FLOAT_DTYPES:
        raise ValueError(f"the qmm kernel writes {FLOAT_DTYPES}, not {out_dtype}")
    m, k = xq.shape
    n = wq.shape[0]
    groups = x_scales.shape[-1]
    _check("xq", xq, torch.int8)
    _check("x_scales", x_scales, torch.float32, (m, groups))
    _check("wq", wq, torch.int8)
    _check("w_scale", w_scale, torch.float32, (n,))
    if bias is not None:
        _check("bias", bias, torch.float32, (n,))
    if residual is not None:
        _check("residual", residual, FLOAT_DTYPES, (m, n))
    if quant_out_group is not None and (quant_out_group < 1 or n % quant_out_group):
        raise ValueError(f"quant_out group {quant_out_group} does not tile N={n}")
    _, plan = _plan_arg(m, n, k, groups, xq.device.index)  # raises outside kernel_supports
    xq, wq, xr = _sm90_operands(xq, wq, groups)
    rows_out = quant_out_group is not None or ln_out_eps is not None
    dev = xq.device
    out_f32 = rows_out or out_dtype == torch.float32
    out = torch.empty((m, n), dtype=torch.float32 if out_f32 else torch.bfloat16, device=dev)
    null = lambda t: 0 if t is None else t.data_ptr()
    err = _sm90_lib().qmm_sm90(
        xq.data_ptr(), x_scales.data_ptr(), wq.data_ptr(), w_scale.data_ptr(), null(bias),
        null(residual), out.data_ptr(), null(xr), m, n, k, wq.shape[1], groups, _ACT_CODE[act],
        int(out_f32), int(residual is not None and residual.dtype == torch.float32),
        plan, _stream(xq))
    _raise_on(err, "qmm_sm90")
    if rows_out:
        lib = _lib()
        payload = torch.empty((m, n), dtype=torch.int8, device=dev)
        if quant_out_group is not None:
            scales = torch.empty((m, n // quant_out_group), dtype=torch.float32, device=dev)
            err = lib.qmm_rows_out(out.data_ptr(), payload.data_ptr(), scales.data_ptr(), None,
                                   m, n, quant_out_group, 0, 0.0, _stream(xq))
            result = (payload, scales)
        else:
            scales = torch.empty((m, 1), dtype=torch.float32, device=dev)
            # an fp32 value is the workspace itself; the row pass writes bf16
            value = (out if out_dtype == torch.float32
                     else torch.empty((m, n), dtype=torch.bfloat16, device=dev))
            err = lib.qmm_rows_out(out.data_ptr(), payload.data_ptr(), scales.data_ptr(),
                                   None if value is out else value.data_ptr(), m, n, n, 1,
                                   ln_out_eps, _stream(xq))
            result = (value, payload, scales)
        _raise_on(err, "qmm row pass")
        out = result
    qmm.launches += 1
    return out


quant_rows.launches = 0
quant_rows.launches_int4 = 0
qmm.launches = 0


def reset_launch_counts() -> None:
    quant_rows.launches = 0
    quant_rows.launches_int4 = 0
    qmm.launches = 0


def qmm_op(xq, x_scales, wq, w_scale, bias=None, act=None, residual=None,
           quant_out_group=None, ln_out_eps=None, out_dtype=torch.bfloat16):
    """`qmm` through its registered operator of the output form asked for
    (ops/library.py: focus::qmm, qmm_quant_out, qmm_ln_out): the kernel for
    CUDA tensors, `qmm_plain` for CPU ones."""
    ops = torch.ops.focus
    if quant_out_group is not None:
        return ops.qmm_quant_out(xq, x_scales, wq, w_scale, bias, act, residual,
                                 quant_out_group, out_dtype)
    if ln_out_eps is not None:
        return ops.qmm_ln_out(xq, x_scales, wq, w_scale, bias, act, residual, ln_out_eps,
                              out_dtype)
    return ops.qmm(xq, x_scales, wq, w_scale, bias, act, residual, out_dtype)


# ---------------------------------------------------------------------------
# front end
# ---------------------------------------------------------------------------


def prepare_weights(w: torch.Tensor, bias: Optional[torch.Tensor] = None,
                    ln_scale: Optional[torch.Tensor] = None,
                    ln_bias: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """The weight side of a projection: LN affine folded in, then int8,
    the rows padded to K % 16 = 0 (`pad_k`) here, once, and not per call."""
    if ln_scale is not None:
        w, bias = fold_ln(w, bias, ln_scale, ln_bias)
    wq, w_scale = quantize_weights(w)
    return {"wq": pad_k(wq), "w_scale": w_scale,
            "bias": None if bias is None else bias.float().contiguous()}


def quant_matmul(x: Optional[torch.Tensor], weights: Dict[str, torch.Tensor], ln: bool = False,
                 ln_eps: float = 1e-6, act: Optional[str] = None,
                 residual: Optional[torch.Tensor] = None, out_dtype=torch.bfloat16,
                 quant_out: bool = False, quant_out_align: Optional[Tuple[int, int]] = None,
                 x_quant: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                 x_quant_normalized: bool = False, ln_quant_out: bool = False,
                 impl: Optional[str] = None):
    """[LayerNorm ->] int8 quantize -> int8 GEMM -> [bias/act/residual], on
    (..., K) rows; `weights` from `prepare_weights` (LN affine folded in when
    `ln`). Counterpart of JAX quant_matmul (without its mesh branch):

      * `quant_out`: returns (int8 (..., N), f32 (..., N / g)) with g from
        `quant_out_group_width` for this call's shapes (and
        `quant_out_align`, for bf16 rows);
      * `x_quant=(payload, scales)`: int8 input with G scale groups (pass
        x=None); with `x_quant_normalized`, the payload is a producer's
        LN-normalized ln_quant_out (the LN affine is in `weights`);
      * `ln_quant_out`: returns (value, LN-normalized int8 payload, per-row
        scale), ln_eps being the output LN's epsilon.
    """
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; choose from {IMPLS}")
    assert not (quant_out and ln_quant_out)
    if x_quant is not None:
        assert x is None, "x_quant is exclusive with x"
        assert ln == x_quant_normalized, (
            "x_quant + LN requires x_quant_normalized=True (the payload must be a "
            "producer's ln_quant_out)")
        x, x_scales = x_quant
        groups = x_scales.shape[-1]
    else:
        groups = 0
    lead = x.shape[:-1]
    k = x.shape[-1]
    m = x.numel() // k
    wq = weights["wq"]
    n = wq.shape[0]
    plain = impl == "plain"
    if groups == 0:
        rows = quant_rows_plain if plain else torch.ops.focus.quant_rows
        xq, scales = rows(x.reshape(m, k).contiguous(), ln, ln_eps, 127)
    else:
        xq, scales = x.reshape(m, k).contiguous(), x_scales.reshape(m, groups).contiguous()
    group = (quant_out_group_width(m, k, n, groups, residual is not None, quant_out_align)
             if quant_out else None)
    res2d = None if residual is None else residual.reshape(m, n).contiguous()
    out = (qmm_plain if plain else qmm_op)(
        xq, scales, wq, weights["w_scale"], weights["bias"], act, res2d, group,
        ln_eps if ln_quant_out else None, out_dtype)
    if quant_out:
        payload, s = out
        return payload.reshape(*lead, n), s.reshape(*lead, n // group)
    if ln_quant_out:
        value, payload, s = out
        return value.reshape(*lead, n), payload.reshape(*lead, n), s.reshape(*lead, 1)
    return out.reshape(*lead, n)


# ---------------------------------------------------------------------------
# w4a4: int4-range weights and activations (the mlp1 variant)
# ---------------------------------------------------------------------------


def quantize_weights4(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 (N, K) -> (int8 (N, K) holding [-7, 7], f32 (N,) per-output-
    channel scale amax / 7), a divide as JAX `quantize_weights4`."""
    w = w.float()
    w_scale = w.abs().amax(dim=1) / 7.0
    wq = torch.round(w / torch.clamp(w_scale, min=1e-12)[:, None]).to(torch.int8)
    return wq, w_scale


def prepare_weights4(w: torch.Tensor, bias: Optional[torch.Tensor] = None,
                     ln_scale: Optional[torch.Tensor] = None,
                     ln_bias: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """`prepare_weights` for w4a4: LN affine folded in, then int4-range,
    padded as there."""
    if ln_scale is not None:
        w, bias = fold_ln(w, bias, ln_scale, ln_bias)
    wq, w_scale = quantize_weights4(w)
    return {"wq": pad_k(wq), "w_scale": w_scale,
            "bias": None if bias is None else bias.float().contiguous()}


def w4a4_supported(m: int, k: int, n: int) -> bool:
    """Shapes of JAX `w4a4_supported` (without its TPU backend test)."""
    return k % 128 == 0 and n % 128 == 0 and m % 128 == 0


def quant_matmul_w4a4(x: torch.Tensor, weights4: Dict[str, torch.Tensor], ln: bool = False,
                      ln_eps: float = 1e-6, act: Optional[str] = None,
                      out_dtype=torch.bfloat16, quant_out: bool = False,
                      impl: Optional[str] = None):
    """[LayerNorm ->] per-row int4-range quantize -> int GEMM -> bias/act
    [-> int8 quant_out, one scale per row], on (..., K) rows; `weights4` from
    `prepare_weights4`. Counterpart of JAX `quant_matmul_w4a4`: activations
    `round(d * (7 / amax))` with scale `amax / 7 * rstd`, weights
    `round(w / (amax / 7))` per output channel. Hopper has no int4 MMA;
    int4-range values in int8 containers give the same integers on the int8
    tensor cores, so the card runs `quant_rows(qmax=7)` then `qmm` (G = 1,
    quant_out group = N, as `_w4a4_call` gives it)."""
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; choose from {IMPLS}")
    lead, k = x.shape[:-1], x.shape[-1]
    m = x.numel() // k
    n = weights4["wq"].shape[0]
    plain = impl == "plain"
    xq, xs = (quant_rows_plain if plain else torch.ops.focus.quant_rows)(
        x.reshape(m, k).contiguous(), ln, ln_eps, 7)
    out = (qmm_plain if plain else qmm_op)(
        xq, xs, weights4["wq"], weights4["w_scale"], weights4["bias"], act, None,
        n if quant_out else None, None, out_dtype)
    if quant_out:
        payload, s = out
        return payload.reshape(*lead, n), s.reshape(*lead, 1)
    return out.reshape(*lead, n)
