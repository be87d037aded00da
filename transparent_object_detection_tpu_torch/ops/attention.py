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
The kernels take bf16 or fp32 (the fp32 models: fp32 products on the CUDA
cores, as the Pallas kernel computes on fp32 inputs).

Each kernel wrapper launches its CUDA kernel for a CUDA tensor (or raises),
and runs its plain version only for a CPU tensor. `impl="plain"` runs the
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
        lib.flash_mha_packed.argtypes = [vp, vp, ci, ci, ci, ci, cf, ci, vp]
        lib.flash_mha_packed.restype = ci
        lib.flash_single.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, cf, ci, vp]
        lib.flash_single.restype = ci
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
    (JAX). A CUDA tensor launches csrc/flash_attn_fwd.cu; a CPU tensor runs
    `flash_mha_packed_plain`."""
    if qkv.device.type == "cpu":
        return flash_mha_packed_plain(qkv, num_heads, scale)
    b, n, c3 = qkv.shape
    c = c3 // 3
    _check_cuda_operand("qkv", qkv, qkv.dtype)
    if c3 % 3 or not packed_kernel_supports(c, num_heads):
        raise ValueError(f"packed flash kernel does not take C={c} with {num_heads} heads")
    out = torch.empty((b, n, c), dtype=qkv.dtype, device=qkv.device)
    err = _lib().flash_mha_packed(
        qkv.data_ptr(), out.data_ptr(), b, n, num_heads, c // num_heads, scale,
        int(qkv.dtype == torch.float32), torch.cuda.current_stream(qkv.device).cuda_stream,
    )
    _raise_on(err, "flash_mha_packed")
    flash_mha_packed.launches += 1
    return out


def flash_single(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 scale: float) -> torch.Tensor:
    """Single-head flash attention with q/k width dq and v width dv:
    q, k (B, N, dq), v (B, N, dv) -> (B, N, dv), bf16 or fp32.

    Port of ops/attention.py::_flash_kernel (flash_attention_pallas, JAX).
    A CUDA tensor launches csrc/flash_attn_fwd.cu on contiguous copies
    (widths not a multiple of 8 zero-padded; views such as folded heads are
    copied once here); a CPU tensor runs `flash_single_plain`."""
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
    dqp, dvp = q.shape[-1], v.shape[-1]
    out = torch.empty((b, n, dvp), dtype=v.dtype, device=v.device)
    err = _lib().flash_single(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, n, dqp, dvp, scale,
        int(q.dtype == torch.float32), torch.cuda.current_stream(q.device).cuda_stream,
    )
    _raise_on(err, "flash_single")
    flash_single.launches += 1
    return out if dvp == dv else out[..., :dv]


flash_mha_packed.launches = 0
flash_single.launches = 0


def reset_launch_counts() -> None:
    flash_mha_packed.launches = 0
    flash_single.launches = 0


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
        out = attention(
            _heads_first(q, num_heads).reshape(b * num_heads, n, -1),
            _heads_first(k, num_heads).reshape(b * num_heads, n, -1),
            _heads_first(v, num_heads).reshape(b * num_heads, n, -1),
            scale, impl, train=train,
        )
        return _heads_last(out.reshape(b, num_heads, n, -1))
    if n <= NAIVE_MAX_TOKENS:
        return reference_attention(q, k, v, scale)
    if impl == "plain":
        return flash_single_plain(q, k, v, scale)
    return flash_single(q, k, v, scale)  # copies (and pads) the views once


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
        return flash_mha_packed(qkv.contiguous(), num_heads, scale)
    q, k, v = qkv.chunk(3, dim=-1)
    return attention(q, k, v, scale, impl, num_heads, int8 and not train, train)
