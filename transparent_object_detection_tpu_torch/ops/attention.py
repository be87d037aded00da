"""Attention for the detector's spatial token maps: the naive route, two
flash-attention kernels written in CUDA for Hopper, their plain PyTorch
versions, and the dispatcher that routes by shape.

Counterpart of transparent_object_detection_tpu/ops/attention.py. Layouts are
the JAX package's: tokens (B, N, C) with heads packed in C, and the fused qkv
projection output (B, N, 3C) with sections [q | k | v].

Serving routes (`serving_route`, used by `attention` / `attention_qkv`), as
the JAX dispatch (`_auto_impl`, `attention_qkv`, `attention`) routes on a
TPU:
  * N <= 1024: "naive", a plain matmul + softmax + matmul
    (`reference_attention`); the N x N scores are small enough.
  * int8=True: "int8", the int8 flash route of ops/attention_int8.py where
    N > 1024 and its `pick_blocks` tiles the shape (q/k head width a
    multiple of 32, v head width a multiple of 128, N and the key block
    multiples of 32), with JAX's key block.
  * "packed": multi-head attention read in place out of the qkv array
    (`flash_mha_packed`) when the head width is a multiple of 128 (the JAX
    rule).
  * "single": the single-head kernel (`flash_single`) for the dark3
    SelfAttention, whose q/k width C/8 differs from its v width C; "folded":
    the same kernel on the other multi-head shapes, heads folded into the
    batch axis (phi='n' h1: 3 heads of 283; phi='m' h1: 8 of 599), their
    odd widths zero-padded to a multiple of 8 in the fold copy.
Training routes (`train_route`, used with train=True), as JAX's
`attention` (the training path's front end, `_diff_flash`) routes on a TPU:
N > 1024 goes to the differentiable flash route of ops/attention_vjp.py
(forward with logsumexp, flash backward): "packed" heads whose width is a
multiple of 128 (q/k/v read in place, packed qkv input or not), "single"
(one head) or "folded" (heads folded into the batch axis in one copy, odd
widths zero-padded to a multiple of 8, the padded gradient columns cut off
by that copy's backward); N <= 1024 stays naive.
At 640x640 this sends neck nodes h1, h2, h4 and dark3 to the kernels at
every scale and node h6 (N=400) to the naive route. One difference of
route is kept on purpose, in serving and in training: where the TPU's VMEM
fit fails (phi='l' h1, phi='x' h1 and h4) JAX falls to its bf16-scored
`chunked` route; the port keeps its kernels, which score in fp32 (ROADMAP
section 3).
The kernels take bf16 or fp32 (the fp32 models: fp32-accurate products, as
the Pallas kernel computes on fp32 inputs). A call takes one of three
kernels, by two rules (`packed_fwd_form` for packed heads,
`single_fwd_form` for one head): bf16 packed heads whose widths are
multiples of 64 (every packed site a route reaches) the Hopper kernel of
csrc/flash_fwd_sm90.cu (wgmma fed by a TMA ring, launched with the plan of
`sm90_plan`), bf16 with one head (dark3, the folded heads) the one-head
form of the same kernel (the plan of `single_sm90_plan`), other packed
bf16 widths the mma.sync template of csrc/flash_attn_fwd.cu, fp32 at every
width and head count the Hopper kernel of csrc/flash_fwd_f32_sm90.cu
(3xTF32 wgmma fed by a TMA ring after a pre-pass, the plan of
`f32_sm90_plan`).

Each kernel wrapper launches its CUDA kernel for a CUDA tensor (or raises),
and runs its plain version only for a CPU tensor. The dispatch reaches the
kernels through their registered operators (`torch.ops.focus.*`,
ops/library.py), whose implementations on either device are these
wrappers. `impl="plain"` runs the
plain versions on any device, so the same model can be compared on the card
with and without the kernels; it is never the default.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from transparent_object_detection_tpu_torch.ops import attention_int8

LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
# Largest token count that takes the naive route (JAX: attention.py _auto_impl).
NAIVE_MAX_TOKENS = 1024
# Head widths that take the packed route are multiples of this (JAX rule).
PACKED_HEAD_MULTIPLE = 128
# The CUDA kernels take q/k and v widths that are multiples of this (16-byte
# rows); the single-head wrapper zero-pads other widths in its input copy.
KERNEL_WIDTH_MULTIPLE = 8
KERNEL_DTYPES = (torch.bfloat16, torch.float32)
IMPLS = (None, "plain")
# The Hopper kernel (csrc/flash_fwd_sm90.cu) and the launch plans it is built
# for: 64-column q/k slabs through a ring of 1-8 stages, v through a ring of
# 1-4 (the packed plans: 2), and either 128 query rows a block with v in
# one slice of 64-256 columns a block (sliced; 128-key tiles for slices up
# to 128, else 64), or 64 rows a block with v split between its two consumer
# warpgroups, 192 or 256 columns each (wg_split; 64-key tiles; the one-head
# form also 320); shared memory within the card's 227 KB.
SM90_WIDTH_MULTIPLE = 64
SM90_ROWS, SM90_SLAB = 128, 64
SM90_V_SLICES = (64, 128, 192, 256)
SM90_MAX_STAGES = 8
SM90_SMEM_LIMIT = 232448
SM90_Q_RESIDENT_BYTES = 96 * 1024  # q heads up to 384 wide stay in shared memory
SM90_SPLIT_V_SLICES = (192, 256)
SM90_PLAN_KEYS = ("rows", "keys", "slab", "v_slice", "stages", "q_resident", "dv_splits",
                  "wg_split", "v_stages", "smem_bytes")
# The one-head form of the same kernel (`single_sm90_plan`): q/k and v
# widths that are multiples of 8 in 64-column slabs, the last one
# zero-filled past the width; the split form for v of 257 to 640 columns
# where q/k is wider than 128 (S dear: the folded heads of 288 and 600), up
# to 320 columns a warpgroup and with Q resident beside one V stage where
# two do not fit; else v in slices across 128-row blocks (dark3).
SINGLE_SM90_SPLIT_MIN_QK = 129
SINGLE_SM90_SPLIT_MIN_V = 257
SINGLE_SM90_SPLIT_MAX_V_SLICE = 320
# The fp32 Hopper kernel (csrc/flash_fwd_f32_sm90.cu) and its plans: 64-key
# tiles, 16-column (64-byte) q/k slabs through a ring of 2-8 stages, each
# operand as tf32 hi and lo, Q resident or streamed with K; either 128 query
# rows a block with v in slices of 64-256 columns across blocks and two
# 32-key (128-byte) V^T chunks a tile (sliced), or, for v wider than 256
# and q/k wider than 128, 64 rows a block whose two consumer warpgroups
# split 2 x 192 or 2 x 256 columns of v and share one S, V^T in 16-key
# chunks through a ring of 2-4 stages (wg_split); shared memory within the
# card's 227 KB.
F32_SM90_KEYS, F32_SM90_SLAB = 64, 16
F32_SM90_V_CHUNK, F32_SM90_SPLIT_V_CHUNK = 32, 16
F32_SM90_V_SLICES = (64, 128, 192, 256)
F32_SM90_SPLIT_V_SLICES = (192, 256)
F32_SM90_MAX_V_STAGES = 4
# the split form's hand-over of P's fragments, the row rescale and row sums
F32_SM90_XCHG_BYTES = (64 // 8) * 2 * 128 * 16 + 2 * 128 * 8
# the split form is offered where q/k is wider than this: measured faster
# than the sliced form at heads of 288, 384 and 600, slower at dark3's q/k
# of 64 and 128 (v 512, 1,024), whose S is cheap beside twice the K and V
# reads of 64-row blocks (PERF.md)
F32_SM90_SPLIT_MIN_QK = 129
F32_SM90_PLAN_KEYS = ("rows", "keys", "slab", "v_slice", "stages", "q_resident", "dv_splits",
                      "wg_split", "v_stages", "smem_bytes")


# ---------------------------------------------------------------------------
# naive route and plain versions
# ---------------------------------------------------------------------------


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float = 1.0) -> torch.Tensor:
    """Naive attention (JAX reference_attention): scores in the input type,
    softmax in fp32, probabilities cast back before the value product.
    q, k (..., N, dq); v (..., N, dv) -> (..., N, dv)."""
    scores = torch.matmul(q, k.transpose(-1, -2)).float() * scale
    attn = torch.softmax(scores, dim=-1)
    return torch.matmul(attn.to(v.dtype), v)


def _online_softmax(q, k, v, scale: float, block_k: int = 1024):
    """The flash kernels' arithmetic in plain PyTorch: q.k^T accumulated in
    fp32, exp2-domain online softmax over kv blocks with the running max
    starting at -1e30, p cast to the input type before the value product,
    fp32 l/acc, output acc * (1 / l) in the input type. Also returns the
    natural-log logsumexp of the scaled scores, (m + log2 l) * ln 2, fp32.
    q, k (..., N, dq); v (..., N, dv) -> (..., N, dv), (..., N, 1)."""
    n = k.shape[-2]
    s_scale = scale * LOG2E
    qf = q.float()
    m = torch.full(q.shape[:-1] + (1,), -1e30, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(q.shape[:-1] + (v.shape[-1],), dtype=torch.float32, device=q.device)
    for j in range(0, n, block_k):
        kb = k[..., j:j + block_k, :].float()
        vb = v[..., j:j + block_k, :]
        s = torch.matmul(qf, kb.transpose(-1, -2)) * s_scale
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp2(s - m_new)
        corr = torch.exp2(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.matmul(p.to(v.dtype).float(), vb.float())
        m = m_new
    return (acc * (1.0 / l)).to(v.dtype), (m + torch.log2(l)) * LN2


def _online_softmax_attention(q, k, v, scale: float, block_k: int = 1024):
    """`_online_softmax` without the logsumexp (the serving kernels)."""
    return _online_softmax(q, k, v, scale, block_k)[0]


def _heads_first(t: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, N, H*d) -> (B, H, N, d)."""
    b, n, c = t.shape
    return t.reshape(b, n, heads, c // heads).transpose(1, 2)


def _heads_last(t: torch.Tensor) -> torch.Tensor:
    """(B, H, N, d) -> (B, N, H*d)."""
    b, h, n, d = t.shape
    return t.transpose(1, 2).reshape(b, n, h * d)


def flash_mha_packed_plain(qkv: torch.Tensor, num_heads: int, scale: float) -> torch.Tensor:
    """Plain version of the packed multi-head kernel: (B, N, 3C) -> (B, N, C)."""
    q, k, v = (_heads_first(t, num_heads) for t in qkv.chunk(3, dim=-1))
    return _heads_last(_online_softmax_attention(q, k, v, scale))


def flash_single_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       scale: float) -> torch.Tensor:
    """Plain version of the single-head kernel: (B, N, dq) x2, (B, N, dv)."""
    return _online_softmax_attention(q, k, v, scale)


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------


def _lib():
    from transparent_object_detection_tpu_torch.kernels import _build

    lib = _build.load("flash_attn_fwd")
    if not getattr(lib, "_argtypes_set", False):
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_mha_packed.argtypes = [vp, vp, ci, ci, ci, ci, cf, vp]
        lib.flash_mha_packed.restype = ci
        lib._argtypes_set = True
    return lib


def _check_cuda_operand(name: str, t: torch.Tensor, dtype: torch.dtype) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype not in KERNEL_DTYPES or t.dtype != dtype:
        raise ValueError(f"{name}: the flash kernel takes bfloat16 or float32 operands of one "
                         f"type, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def packed_kernel_supports(c: int, num_heads: int) -> bool:
    """Head layouts the packed kernel reads in place: any head width that is
    a multiple of 8."""
    return (num_heads >= 1 and c % num_heads == 0 and c // num_heads > 0
            and (c // num_heads) % KERNEL_WIDTH_MULTIPLE == 0)


def single_kernel_supports(dq: int, dv: int) -> bool:
    """Widths `flash_single` takes: any (widths that are not a multiple of 8
    are zero-padded in the wrapper's input copy)."""
    return dq > 0 and dv > 0


def packed_fwd_form(dh: int, dtype: torch.dtype, dv: Optional[int] = None) -> str:
    """The kernel of a packed multi-head forward (serving, or training with
    lse) on heads of q/k width `dh` and v width `dv` (default `dh`):
    "f32_sm90" for fp32 at every width (csrc/flash_fwd_f32_sm90.cu, which
    the single-head forms take too); "sm90" for bf16 when both widths are
    multiples of 64, which every packed site a route reaches is
    (csrc/flash_fwd_sm90.cu); "mma_sync" for the other bf16 widths that are
    multiples of 8 (csrc/flash_attn_fwd.cu)."""
    dv = dh if dv is None else dv
    if dtype == torch.float32:
        return "f32_sm90"
    if dh % SM90_WIDTH_MULTIPLE == 0 and dv % SM90_WIDTH_MULTIPLE == 0:
        return "sm90"
    return "mma_sync"


def sm90_smem_bytes(dqk: int, v_slice: int, stages: int, q_resident: bool,
                    wg_split: bool = False, keys: int = 64, v_stages: int = 2) -> int:
    """Dynamic shared memory of an sm90 plan (as csrc/flash_fwd_sm90.cu
    computes it): 1024 bytes of alignment slack, 1024 of barriers, q's
    64-column slabs when resident, the K ring (each stage a 64-key x
    64-column slab, plus the q slab when q streams), `v_stages` v stages of
    `keys` keys x the v the block covers, and with wg_split two 64-row bf16
    P tiles."""
    rows = 64 if wg_split else SM90_ROWS
    cols = -(-dqk // SM90_SLAB) * SM90_SLAB
    stage = 2 * SM90_SLAB * (keys + (0 if q_resident else rows))
    return (2048 + (2 * rows * cols if q_resident else 0) + stages * stage
            + v_stages * 2 * keys * v_slice * (2 if wg_split else 1)
            + (2 * 2 * 64 * keys if wg_split else 0))


def _sm90_stages(dqk: int, v_slice: int, q_resident: bool, wg_split: bool,
                 keys: int = 64, least: int = 1, v_stages: int = 2) -> int:
    """The most K stages (up to 8, at least `least`) whose plan fits the
    shared memory, or 0."""
    return next((st for st in range(SM90_MAX_STAGES, least - 1, -1)
                 if sm90_smem_bytes(dqk, v_slice, st, q_resident, wg_split, keys, v_stages)
                 <= SM90_SMEM_LIMIT), 0)


def sm90_split_fits(dqk: int, dv: int) -> bool:
    """Whether the wg_split plan takes these widths: v wider than one
    warpgroup's 256 columns but not than two, q resident at 64 rows, and
    the shared memory fits."""
    v_slice = -(-dv // (2 * SM90_SLAB)) * SM90_SLAB
    return (SM90_V_SLICES[-1] < dv <= 2 * SM90_V_SLICES[-1] and v_slice in SM90_SPLIT_V_SLICES
            and 2 * 64 * dqk <= SM90_Q_RESIDENT_BYTES
            and _sm90_stages(dqk, v_slice, True, True) > 0)


def _sm90_layout(dqk: int, dv: int, wg_split: bool) -> dict:
    """The plan of one form (the library is built for both): sliced, v in
    the fewest slices of at most 256 columns, each a multiple of 64 (384:
    two of 192), one a block of 128 rows, q resident while 128 rows of it
    fit in 96 KB, 128-key tiles for slices up to 128 (at 192 and 256 the S
    accumulator no longer fits beside O), else 64; or wg_split, one 64-row
    block a head's rows, v split between its two consumer warpgroups, 64-key
    tiles. The most K stages (up to 8) that fit the shared memory."""
    if wg_split:
        splits, rows, q_resident, keys = 1, 64, True, 64
        v_slice = -(-dv // (2 * SM90_SLAB)) * SM90_SLAB
    else:
        splits, rows = -(-dv // SM90_V_SLICES[-1]), SM90_ROWS
        v_slice = -(-dv // (splits * SM90_SLAB)) * SM90_SLAB
        q_resident = 2 * SM90_ROWS * dqk <= SM90_Q_RESIDENT_BYTES
        keys = 128 if v_slice <= 128 else 64
    stages = _sm90_stages(dqk, v_slice, q_resident, wg_split, keys)
    if not stages:
        raise ValueError(f"no sm90 plan fits q/k {dqk}, v {dv}")
    return {"rows": rows, "keys": keys, "slab": SM90_SLAB, "v_slice": v_slice,
            "stages": stages, "q_resident": int(q_resident), "dv_splits": splits,
            "wg_split": int(wg_split), "v_stages": 2,
            "smem_bytes": sm90_smem_bytes(dqk, v_slice, stages, q_resident, wg_split, keys)}


def single_sm90_plan(dqk: int, dv: int) -> dict:
    """Launch plan of the one-head form of csrc/flash_fwd_sm90.cu (bf16
    flash_single, and flash_fwd_lse with one head) for q/k width `dqk` and v
    width `dv` (multiples of 8), a function of the widths alone that the
    library recomputes and holds the call to (`single_plan` there): q/k in
    ceil(dqk / 64) slabs of 64 columns, the last zero-filled past dqk.
      * The split form (wg_split) where q/k is wider than 128 and v wider
        than 256 but at most 640: 64-row blocks whose two consumer
        warpgroups share one S and each take `v_slice` = ceil(dv / 128) * 64
        columns of v (192 at 288, 320 at 600); 64-key tiles; Q resident
        beside two V stages where two K stages fit, else beside one V stage
        (600: six K stages), else streamed with K. These are the folded
        heads, where S costs as much as P.V and slices would recompute it
        (PERF.md: slices, and at 600 Q streamed beside two V stages,
        measured slower).
      * Else the sliced form: 128-row blocks, v in the fewest slices of at
        most 256 columns (multiples of 64), one a block, the two
        warpgroups sharing each K/V tile; Q resident while its 128 rows fit
        in 96 KB; 128-key tiles for slices up to 128, else 64. These are
        dark3's (q/k 32 to 512 against v 256 to 4,096: S is cheap beside
        the K and V reads that 64-row blocks would double).
    Two V stages but there; the most K stages (up to 8) that fit the
    shared memory."""
    if dqk <= 0 or dv <= 0 or dqk % KERNEL_WIDTH_MULTIPLE or dv % KERNEL_WIDTH_MULTIPLE:
        raise ValueError(f"the one-head sm90 kernel takes widths that are multiples of "
                         f"{KERNEL_WIDTH_MULTIPLE}, got q/k {dqk}, v {dv}")
    v_slice = -(-dv // (2 * SM90_SLAB)) * SM90_SLAB  # a warpgroup's half
    if not (dqk >= SINGLE_SM90_SPLIT_MIN_QK and dv >= SINGLE_SM90_SPLIT_MIN_V
            and v_slice <= SINGLE_SM90_SPLIT_MAX_V_SLICE):
        return _sm90_layout(dqk, dv, False)  # 128 rows of q fit in 96 KB as 64-column slabs too
    # Q resident beside two V stages, else beside one, else streamed
    q_resident, v_stages = next(((True, vst) for vst in (2, 1)
                                 if _sm90_stages(dqk, v_slice, True, True, least=2, v_stages=vst)),
                                (False, 2))
    stages = _sm90_stages(dqk, v_slice, q_resident, True, v_stages=v_stages)
    return {"rows": 64, "keys": 64, "slab": SM90_SLAB, "v_slice": v_slice, "stages": stages,
            "q_resident": int(q_resident), "dv_splits": 1, "wg_split": 1, "v_stages": v_stages,
            "smem_bytes": sm90_smem_bytes(dqk, v_slice, stages, q_resident, True, 64, v_stages)}


def single_fwd_form(dqk: int, dv: int, dtype: torch.dtype) -> str:
    """The kernel of a one-head forward (serving `flash_single`, or training
    `flash_fwd_lse` with one head) of q/k width `dqk` and v width `dv`
    (multiples of 8): "f32_sm90" for fp32 (csrc/flash_fwd_f32_sm90.cu);
    "single_sm90" for bf16 wherever `single_sm90_plan` has a plan, which is
    every such width (the one-head form of csrc/flash_fwd_sm90.cu)."""
    if dtype == torch.float32:
        return "f32_sm90"
    single_sm90_plan(dqk, dv)  # raises where there is none
    return "single_sm90"


def sm90_plan(dqk: int, dv: int) -> dict:
    """Launch plan of csrc/flash_fwd_sm90.cu for q/k width `dqk` and v width
    `dv` (multiples of 64): the wg_split form wherever it fits (heads wider
    than 256 and up to 512: S computed once, not once a 256-column v slice;
    measured at phi='m' heads of 384, PERF.md), else the sliced form."""
    if dqk <= 0 or dv <= 0 or dqk % SM90_WIDTH_MULTIPLE or dv % SM90_WIDTH_MULTIPLE:
        raise ValueError(f"the sm90 kernel takes widths that are multiples of "
                         f"{SM90_WIDTH_MULTIPLE}, got q/k {dqk}, v {dv}")
    return _sm90_layout(dqk, dv, sm90_split_fits(dqk, dv))


def f32_sm90_smem_bytes(dqk: int, v_slice: int, stages: int, q_resident: bool,
                        wg_split: bool = False, v_stages: int = 2) -> int:
    """Dynamic shared memory of an f32_sm90 plan (as csrc/flash_fwd_f32_sm90.cu
    computes it): 1024 bytes of alignment slack, 1024 of barriers, the split
    form's hand-over, Q hi and lo (the block's rows of every 16-column slab)
    when resident, the ring of q/k stages (K hi and lo of 64 keys, and Q hi
    and lo when Q streams) and the V ring (sliced: two 32-key V^T chunks of
    the slice; split: `v_stages` 16-key chunks of both warpgroups' halves;
    hi and lo); 4 bytes an element."""
    rows = 64 if wg_split else 128
    slabs = -(-dqk // F32_SM90_SLAB)
    row = 4 * F32_SM90_SLAB
    q_slab = 2 * rows * row
    stage = 2 * F32_SM90_KEYS * row + (0 if q_resident else q_slab)
    v_stage = (2 if wg_split else 1) * 2 * v_slice * 4 * (
        F32_SM90_SPLIT_V_CHUNK if wg_split else F32_SM90_V_CHUNK)
    return (2048 + (F32_SM90_XCHG_BYTES if wg_split else 0)
            + (slabs * q_slab if q_resident else 0) + stages * stage + v_stages * v_stage)


def _f32_sm90_layout(dqk: int, dv: int, v_slice: int, q_resident: bool, wg_split: bool):
    """The plan of one (form, v slice, Q residency) choice, or None if fewer
    than two q/k stages fit; two V stages."""
    stages = next((st for st in range(SM90_MAX_STAGES, 1, -1)
                   if f32_sm90_smem_bytes(dqk, v_slice, st, q_resident, wg_split)
                   <= SM90_SMEM_LIMIT), 0)
    if not stages:
        return None
    return {"rows": 64 if wg_split else 128, "keys": F32_SM90_KEYS, "slab": F32_SM90_SLAB,
            "v_slice": v_slice, "stages": stages, "q_resident": int(q_resident),
            "dv_splits": -(-dv // ((2 if wg_split else 1) * v_slice)),
            "wg_split": int(wg_split), "v_stages": 2,
            "smem_bytes": f32_sm90_smem_bytes(dqk, v_slice, stages, q_resident, wg_split)}


def f32_sm90_plan(dqk: int, dv: int) -> dict:
    """Launch plan of csrc/flash_fwd_f32_sm90.cu for q/k width `dqk` and v
    width `dv` (multiples of 8): of the forms (sliced; for v wider than 256
    and q/k of F32_SM90_SPLIT_MIN_QK or more also wg_split), the v slices
    and the two ways of holding Q (resident, or
    streamed with K from L2 every key tile) whose shared memory fits two q/k
    stages or more, the one whose work for 128 rows costs least, splits *
    (q/k slab columns, twice when Q streams + the columns a block covers):
    every block recomputes S for its rows, a streamed Q is read again each
    tile, and wg_split blocks cover twice the slice with one S; ties to
    fewer slices, then to Q resident, then to the sliced form. The most q/k
    stages (up to 8) that fit."""
    if dqk <= 0 or dv <= 0 or dqk % KERNEL_WIDTH_MULTIPLE or dv % KERNEL_WIDTH_MULTIPLE:
        raise ValueError(f"the f32_sm90 kernel takes widths that are multiples of "
                         f"{KERNEL_WIDTH_MULTIPLE}, got q/k {dqk}, v {dv}")
    cols = -(-dqk // F32_SM90_SLAB) * F32_SM90_SLAB
    forms = [(False, v) for v in F32_SM90_V_SLICES]
    if dv > F32_SM90_V_SLICES[-1] and dqk >= F32_SM90_SPLIT_MIN_QK:
        forms += [(True, v) for v in F32_SM90_SPLIT_V_SLICES]
    best = None
    for wg_split, v_slice in forms:
        for q_resident in (True, False):
            plan = _f32_sm90_layout(dqk, dv, v_slice, q_resident, wg_split)
            if plan is None:
                continue
            cover = (2 if wg_split else 1) * v_slice
            cost = (plan["dv_splits"] * (cols * (1 if q_resident else 2) + cover),
                    plan["dv_splits"], not q_resident, wg_split)
            if best is None or cost < best[0]:
                best = (cost, plan)
    return best[1]


def _f32_sm90_lib():
    from transparent_object_detection_tpu_torch.kernels import _build

    lib = _build.load("flash_fwd_f32_sm90")
    if not getattr(lib, "_argtypes_set", False):
        vp, ci, cl, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        lib.flash_fwd_f32_sm90.argtypes = [vp] * 11 + [ci] * 6 + [cl] * 6 + [cf, vp, vp]
        lib.flash_fwd_f32_sm90.restype = ci
        lib._argtypes_set = True
    return lib


def launch_f32_sm90(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
                    scale: float, lse: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One call of csrc/flash_fwd_f32_sm90.cu (its pre-pass, then the
    attention kernel) on checked fp32 CUDA operands: q, k (B, N, H*dqk) and
    v (B, N, H*dv), each a view whose last axis is contiguous and whose row
    and batch strides are multiples of 8, widths multiples of 8, with
    `f32_sm90_plan`'s plan; writes lse (B, H, N[, 1]) fp32 when given.
    Allocates the pre-pass's scratch (q and k hi and lo, V^T hi and lo with
    the keys padded to 64). Returns out (B, N, H*dv). Raises if the launch
    fails; never falls back."""
    b, n, cq = q.shape
    cv = v.shape[-1]
    dqk, dv = cq // num_heads, cv // num_heads
    plan = f32_sm90_plan(dqk, dv)
    plan_arr = (ctypes.c_int * len(F32_SM90_PLAN_KEYS))(*(plan[key] for key in F32_SM90_PLAN_KEYS))
    n_pad = -(-n // F32_SM90_KEYS) * F32_SM90_KEYS
    empty = lambda *shape: torch.empty(shape, dtype=torch.float32, device=q.device)
    scratch = (empty(b, n, cq), empty(b, n, cq), empty(b, n, cq), empty(b, n, cq),
               empty(b, num_heads, dv, n_pad), empty(b, num_heads, dv, n_pad))
    out = empty(b, n, cv)
    err = _f32_sm90_lib().flash_fwd_f32_sm90(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), *(t.data_ptr() for t in scratch),
        b, n, num_heads, dqk, dv, n_pad, q.stride(0), q.stride(1), k.stride(0), k.stride(1),
        v.stride(0), v.stride(1), scale, ctypes.cast(plan_arr, ctypes.c_void_p),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _raise_on(err, "flash_fwd_f32_sm90")
    return out


def _sm90_lib():
    from transparent_object_detection_tpu_torch.kernels import _build

    lib = _build.load("flash_fwd_sm90")
    if not getattr(lib, "_argtypes_set", False):
        vp, ci, cl, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        lib.flash_fwd_sm90.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci, ci,
                                       cl, cl, cl, cl, cl, cl, cf, vp, vp]
        lib.flash_fwd_sm90.restype = ci
        lib.flash_fwd_single_sm90.argtypes = [vp] * 5 + [ci] * 4 + [cl] * 6 + [cf, vp, vp]
        lib.flash_fwd_single_sm90.restype = ci
        lib._argtypes_set = True
    return lib


def _launch_sm90_plan(q, k, v, num_heads: int, scale: float, lse, plan: dict) -> torch.Tensor:
    b, n, cq = q.shape
    plan_arr = (ctypes.c_int * len(SM90_PLAN_KEYS))(*(plan[key] for key in SM90_PLAN_KEYS))
    out = torch.empty((b, n, v.shape[-1]), dtype=v.dtype, device=v.device)
    err = _sm90_lib().flash_fwd_sm90(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), b, n, num_heads, cq // num_heads,
        v.shape[-1] // num_heads, q.stride(0), q.stride(1), k.stride(0), k.stride(1),
        v.stride(0), v.stride(1), scale, ctypes.cast(plan_arr, ctypes.c_void_p),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _raise_on(err, "flash_fwd_sm90")
    return out


def launch_sm90(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
                scale: float, lse: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One launch of csrc/flash_fwd_sm90.cu on checked bf16 CUDA operands: q,
    k (B, N, H*dqk) and v (B, N, H*dv), each a view whose last axis is
    contiguous and whose row and batch strides are multiples of 8 (the
    sections of a packed qkv array are such views), with `sm90_plan`'s plan
    (the library refuses one it was not built for); writes lse (B, H, N[,
    1]) fp32 when given. Returns out (B, N, H*dv). Raises if the launch
    fails; never falls back."""
    plan = sm90_plan(q.shape[-1] // num_heads, v.shape[-1] // num_heads)
    return _launch_sm90_plan(q, k, v, num_heads, scale, lse, plan)


def launch_single_sm90(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                       lse: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One launch of the one-head form of csrc/flash_fwd_sm90.cu on checked
    bf16 CUDA operands: q, k (B, N, dqk) and v (B, N, dv), views whose last
    axis is contiguous and whose row and batch strides are multiples of 8,
    widths multiples of 8, with `single_sm90_plan`'s plan (the library
    recomputes it and refuses any other); writes lse (B, N[, 1]) fp32 when
    given. Returns out (B, N, dv). Raises if the launch fails; never falls
    back."""
    b, n, dqk = q.shape
    dv = v.shape[-1]
    plan = single_sm90_plan(dqk, dv)
    plan_arr = (ctypes.c_int * len(SM90_PLAN_KEYS))(*(plan[key] for key in SM90_PLAN_KEYS))
    out = torch.empty((b, n, dv), dtype=v.dtype, device=v.device)
    err = _sm90_lib().flash_fwd_single_sm90(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), b, n, dqk, dv, q.stride(0), q.stride(1),
        k.stride(0), k.stride(1), v.stride(0), v.stride(1), scale,
        ctypes.cast(plan_arr, ctypes.c_void_p), torch.cuda.current_stream(q.device).cuda_stream,
    )
    _raise_on(err, "flash_fwd_single_sm90")
    return out


def _padded(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy (or t itself) whose last axis is zero-padded to a
    multiple of KERNEL_WIDTH_MULTIPLE: padded q/k columns leave q.k^T
    unchanged, padded v columns are sliced off the output."""
    pad = -t.shape[-1] % KERNEL_WIDTH_MULTIPLE
    return torch.nn.functional.pad(t, (0, pad)) if pad else t.contiguous()


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")


def flash_mha_packed(qkv: torch.Tensor, num_heads: int, scale: float) -> torch.Tensor:
    """Packed multi-head flash attention: (B, N, 3C) -> (B, N, C).

    Port of ops/attention.py::_mha_flash_kernel via flash_attention_mha_packed
    (JAX). A CUDA tensor launches the kernel of `packed_fwd_form`; a CPU
    tensor runs `flash_mha_packed_plain`. `launches` counts launches of
    csrc/flash_attn_fwd.cu, `sm90_launches` those of csrc/flash_fwd_sm90.cu,
    `f32_launches` those of csrc/flash_fwd_f32_sm90.cu."""
    if qkv.device.type == "cpu":
        return flash_mha_packed_plain(qkv, num_heads, scale)
    b, n, c3 = qkv.shape
    c = c3 // 3
    _check_cuda_operand("qkv", qkv, qkv.dtype)
    if c3 % 3 or not packed_kernel_supports(c, num_heads):
        raise ValueError(f"packed flash kernel does not take C={c} with {num_heads} heads")
    form = packed_fwd_form(c // num_heads, qkv.dtype)
    views = (qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:])
    if form == "sm90":
        out = launch_sm90(*views, num_heads, scale)
        flash_mha_packed.sm90_launches += 1
        return out
    if form == "f32_sm90":
        out = launch_f32_sm90(*views, num_heads, scale)
        flash_mha_packed.f32_launches += 1
        return out
    out = torch.empty((b, n, c), dtype=qkv.dtype, device=qkv.device)
    err = _lib().flash_mha_packed(
        qkv.data_ptr(), out.data_ptr(), b, n, num_heads, c // num_heads, scale,
        torch.cuda.current_stream(qkv.device).cuda_stream,
    )
    _raise_on(err, "flash_mha_packed")
    flash_mha_packed.launches += 1
    return out


def flash_single(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 scale: float) -> torch.Tensor:
    """Single-head flash attention with q/k width dq and v width dv:
    q, k (B, N, dq), v (B, N, dv) -> (B, N, dv), bf16 or fp32.

    Port of ops/attention.py::_flash_kernel (flash_attention_pallas, JAX).
    A CUDA tensor launches, on contiguous copies (widths not a multiple of 8
    zero-padded; the folded route hands over padded contiguous heads), the
    kernel of `single_fwd_form`: the one-head form of
    csrc/flash_fwd_sm90.cu in bf16 (counted in `sm90_launches`) or
    csrc/flash_fwd_f32_sm90.cu in fp32 (`f32_launches`); a CPU tensor runs
    `flash_single_plain`."""
    if q.device.type == "cpu":
        return flash_single_plain(q, k, v, scale)
    b, n, dq = q.shape
    dv = v.shape[-1]
    if k.shape != q.shape or v.shape[:2] != (b, n) or not single_kernel_supports(dq, dv):
        raise ValueError(f"single-head flash kernel does not take q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    q, k, v = _padded(q), _padded(k), _padded(v)
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_cuda_operand(name, t, q.dtype)
    dvp = v.shape[-1]
    if single_fwd_form(q.shape[-1], dvp, q.dtype) == "f32_sm90":
        out = launch_f32_sm90(q, k, v, 1, scale)
        flash_single.f32_launches += 1
    else:
        out = launch_single_sm90(q, k, v, scale)
        flash_single.sm90_launches += 1
    return out if dvp == dv else out[..., :dv]


def reset_launch_counts() -> None:
    flash_mha_packed.launches = 0
    flash_mha_packed.sm90_launches = 0
    flash_mha_packed.f32_launches = 0
    flash_single.sm90_launches = 0
    flash_single.f32_launches = 0


reset_launch_counts()


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------


def _check_impl(impl: Optional[str]) -> None:
    if impl not in IMPLS:
        raise ValueError(f"unknown attention impl {impl!r}; choose from {IMPLS}")


def _packed_heads(c: int, num_heads: int) -> bool:
    """Head layouts that take the packed kernels (the JAX rule)."""
    return c % num_heads == 0 and (c // num_heads) % PACKED_HEAD_MULTIPLE == 0


def serving_route(n: int, cq: int, num_heads: int = 1, cv: Optional[int] = None,
                  int8: bool = False, packed: bool = False) -> Tuple[str, Optional[int]]:
    """(route, key block) of a serving attention call on (B, n, cq) q/k and
    (B, n, cv) v with `num_heads` heads packed in the channels, as the JAX
    dispatch routes it on a TPU: "naive" (n <= 1024), "int8" (with
    `pick_blocks`'s key block, the k/v scale granularity), "packed" (a packed
    qkv input, `packed`, whose head width is a multiple of 128), "single"
    (one head) or "folded" (heads folded into the batch axis, then the
    single-head kernel)."""
    cv = cq if cv is None else cv
    if n <= NAIVE_MAX_TOKENS:
        return "naive", None
    if int8:
        blocks = attention_int8.pick_blocks(n, cq, num_heads, cv=cv)
        if blocks is not None:
            return "int8", blocks[1]
    if packed and cq == cv and _packed_heads(cq, num_heads):
        return "packed", None
    return ("single" if num_heads == 1 else "folded"), None


def train_route(n: int, cq: int, num_heads: int = 1, cv: Optional[int] = None) -> str:
    """Route of a training attention call on (B, n, cq) q/k and (B, n, cv)
    v with `num_heads` heads packed in the channels, as JAX's `attention`
    routes it on a TPU: "naive" (n <= 1024), "packed" (a head width that is
    a multiple of 128; the differentiable multi-head flash route, from a
    packed qkv array or from q, k, v), "single" (one head) or "folded"
    (heads folded into the batch axis, then the single-head route)."""
    if n <= NAIVE_MAX_TOKENS:
        return "naive"
    if num_heads == 1:
        return "single"
    cv = cq if cv is None else cv
    return "packed" if _packed_heads(cq, num_heads) and cv % num_heads == 0 else "folded"


def _fold_heads(t: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, N, H*d) -> (B*H, N, d + pad) in one copy, d zero-padded to a
    multiple of KERNEL_WIDTH_MULTIPLE. Differentiable: the backward cuts the
    padded gradient columns off and unfolds the heads."""
    b, n, c = t.shape
    pad = -(c // num_heads) % KERNEL_WIDTH_MULTIPLE
    t4 = _heads_first(t, num_heads)
    return (torch.nn.functional.pad(t4, (0, pad)) if pad else t4).reshape(b * num_heads, n, -1)


def _train_folded(q, k, v, scale: float, num_heads: int, impl: Optional[str]) -> torch.Tensor:
    """The "folded" training route: heads folded into the batch axis (odd
    widths zero-padded: padded q/k columns leave q.k^T unchanged, padded v
    columns are cut off the output), then the single-head flash route."""
    from transparent_object_detection_tpu_torch.ops import attention_vjp

    b, n, _ = q.shape
    dv = v.shape[-1] // num_heads
    out = attention_vjp.flash_attention(_fold_heads(q, num_heads), _fold_heads(k, num_heads),
                                        _fold_heads(v, num_heads), scale, 1, impl)
    return _heads_last(out[..., :dv].reshape(b, num_heads, n, dv))


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float = 1.0,
              impl: Optional[str] = None, num_heads: int = 1, int8: bool = False,
              train: bool = False) -> torch.Tensor:
    """Dispatching front end on (B, N, C) tokens, heads packed in C.

    impl None: the routes of `serving_route`, with the kernels.
    impl "plain": the same routing with the kernels' plain versions.
    train: the routes of `train_route`, through the differentiable flash
    route (ops/attention_vjp.py) for N > 1024; int8 is ignored. N <= 1024
    stays naive and autograd differentiates it."""
    _check_impl(impl)
    b, n, c = q.shape
    route = train_route(n, c, num_heads, v.shape[-1]) if train else None
    if route == "packed" or (route == "single" and not (c % KERNEL_WIDTH_MULTIPLE
                                                        or v.shape[-1] % KERNEL_WIDTH_MULTIPLE)):
        from transparent_object_detection_tpu_torch.ops import attention_vjp

        return attention_vjp.flash_attention(q, k, v, scale, num_heads, impl)
    if route in ("single", "folded"):  # padded in the fold copy
        return _train_folded(q, k, v, scale, num_heads, impl)
    route, bk = serving_route(n, c, num_heads, v.shape[-1], int8 and not train)
    if route == "int8":
        return attention_int8.attention_int8(q, k, v, scale, num_heads, bk, impl=impl)
    if num_heads > 1:
        # "folded": the heads on the batch axis in one copy that also pads odd
        # widths for the kernel (the padded output columns are cut off)
        fold = _fold_heads if route == "folded" else (
            lambda t, h: _heads_first(t, h).reshape(b * h, n, -1))
        dv = v.shape[-1] // num_heads
        out = attention(fold(q, num_heads), fold(k, num_heads), fold(v, num_heads), scale, impl,
                        train=train)
        return _heads_last(out[..., :dv].reshape(b, num_heads, n, dv))
    if n <= NAIVE_MAX_TOKENS:
        return reference_attention(q, k, v, scale)
    if impl == "plain":
        return flash_single_plain(q, k, v, scale)
    # the registered operator (ops/library.py): the kernel on CUDA, which
    # copies (and pads) other views once
    return torch.ops.focus.flash_single(q, k, v, scale)


def attention_qkv(qkv: torch.Tensor, scale: float = 1.0, impl: Optional[str] = None,
                  num_heads: int = 1, int8: bool = False, train: bool = False) -> torch.Tensor:
    """Packed front end: one (B, N, 3C) array straight from the fused qkv
    projection -> (B, N, C). With int8 (serving), large maps that
    `pick_blocks` tiles take the int8 flash kernel, q read in place and k/v
    quantized from views. Otherwise large maps whose head width is a
    multiple of PACKED_HEAD_MULTIPLE read q/k/v in place (with train, through
    the differentiable flash route, whose gradient is one packed array);
    everything else splits and goes through `attention`."""
    _check_impl(impl)
    n, c = qkv.shape[1], qkv.shape[2] // 3
    if train and train_route(n, c, num_heads) == "packed":
        from transparent_object_detection_tpu_torch.ops import attention_vjp

        return attention_vjp.flash_attention_qkv(qkv, scale, num_heads, impl)
    route, bk = (None, None) if train else serving_route(n, c, num_heads, c, int8, packed=True)
    if route == "int8":
        return attention_int8.attention_int8(
            qkv, qkv[..., c:2 * c], qkv[..., 2 * c:], scale, num_heads, bk, q_width=c,
            impl=impl)
    if route == "packed":
        if impl == "plain":
            return flash_mha_packed_plain(qkv, num_heads, scale)
        return torch.ops.focus.flash_mha_packed(qkv.contiguous(), num_heads, scale)
    q, k, v = qkv.chunk(3, dim=-1)
    return attention(q, k, v, scale, impl, num_heads, int8 and not train, train)
