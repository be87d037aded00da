"""Flash attention for training: the forward with logsumexp and the flash
backward as CUDA kernels for Hopper, their plain PyTorch versions, and the
autograd Function that joins them.

Counterpart of transparent_object_detection_tpu/ops/attention_vjp.py and of
`_diff_flash` in its ops/attention.py. Layouts are the JAX package's: q, k
(B, N, H*dqk) and v (B, N, H*dv) with the heads packed in the channel axis;
lse and D = rowsum(dO * O) are (B, N, 1) fp32 for one head and (B, H, N, 1)
for packed heads. q/k/v may be column views of one packed (B, N, 3C) qkv
array (last axis contiguous): the kernels read them in place, and the
Function given the packed array writes one packed (B, N, 3C) gradient.

  flash_fwd_lse  replaces _fwd_lse_kernel (csrc/flash_attn_fwd.cu)
  flash_bwd_dq   replaces _bwd_dq_kernel  (csrc/flash_attn_bwd.cu, 1 launch)
  flash_bwd_dkv  replaces _bwd_dkv_kernel (csrc/flash_attn_bwd.cu, 2 launches:
                 the dk pass and the dv pass; counted once, as the TPU kernel)

Each wrapper launches its kernel for CUDA tensors (or raises) and runs its
plain version only for CPU tensors; `launches` counts kernel launches. The
kernels take the Pallas kernels' whole domain (`kernel_supports`): any q/k
and v head widths that are multiples of 8 (the folded odd heads are
zero-padded by ops/attention.py), any N, bf16 (tensor cores) or fp32 (CUDA
cores, nothing cast, as the Pallas kernels compute on fp32 inputs).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from transparent_object_detection_tpu_torch.ops import attention as A

MODE_DQ, MODE_DK, MODE_DV = 0, 1, 2


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _split_heads(t: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, N, H*d) -> (B, H, N, d)."""
    b, n, c = t.shape
    return t.reshape(b, n, num_heads, c // num_heads).transpose(1, 2)


def _stats4(t: torch.Tensor, num_heads: int) -> torch.Tensor:
    """lse or D in its public layout -> (B, H, N, 1)."""
    return t[:, None] if num_heads == 1 else t


def _stat_shape(b: int, n: int, num_heads: int) -> Tuple[int, ...]:
    return (b, n, 1) if num_heads == 1 else (b, num_heads, n, 1)


def flash_fwd_lse_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                        num_heads: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward with logsumexp: the serving kernels'
    arithmetic (exp2-domain online softmax) and lse = (m + log2 l) * ln 2.
    -> out (B, N, H*dv) in v's type, lse fp32."""
    h = num_heads
    out, lse = A._online_softmax(_split_heads(q, h), _split_heads(k, h), _split_heads(v, h),
                                 scale)
    return A._heads_last(out), (lse[:, 0] if h == 1 else lse)


def compute_dcap(o: torch.Tensor, do: torch.Tensor, num_heads: int = 1) -> torch.Tensor:
    """D = rowsum(dO * O) in fp32, contiguous: (B, N, 1), or (B, H, N, 1) for
    packed heads."""
    prod = do.float() * o.float()
    if num_heads == 1:
        return prod.sum(dim=-1, keepdim=True)
    b, n, c = o.shape
    per_head = prod.reshape(b, n, num_heads, c // num_heads).sum(dim=-1)
    return per_head.transpose(1, 2).contiguous()[..., None]


def _bwd_plain(q, k, v, do, lse, dcap, scale: float, num_heads: int, want: Tuple[str, ...],
               block_q: int = 1024):
    """The backward kernels' arithmetic in plain PyTorch, query block by
    query block: S = q.k^T (fp32), P = exp2(S * scale * log2 e - lse * log2 e),
    dP = dO.v^T, dS = P * (dP - D) * scale; dS and P cast to the input type
    before dq = dS.k, dk = dS^T.q, dv = P^T.dO (fp32 sums). Returns the
    gradients named in `want`, in the inputs' types."""
    h = num_heads
    qh, kh, vh, doh = (_split_heads(t, h) for t in (q, k, v, do))
    lse4, d4 = _stats4(lse, h).float(), _stats4(dcap, h).float()
    kf, vf = kh.float(), vh.float()
    s_scale = scale * A.LOG2E
    n = q.shape[1]
    grads = {"dq": torch.empty(qh.shape, dtype=torch.float32, device=q.device),
             "dk": torch.zeros_like(kf), "dv": torch.zeros_like(vf)}
    for i in range(0, n, block_q):
        rows = slice(i, i + block_q)
        qb, dob = qh[..., rows, :].float(), doh[..., rows, :].float()
        s = torch.matmul(qb, kf.transpose(-1, -2))
        p = torch.exp2(s * s_scale - lse4[..., rows, :] * A.LOG2E)
        if "dv" in want:
            grads["dv"] += torch.matmul(p.to(do.dtype).float().transpose(-1, -2), dob)
        if "dq" in want or "dk" in want:
            dp = torch.matmul(dob, vf.transpose(-1, -2))
            ds = p * (dp - d4[..., rows, :]) * scale
            if "dq" in want:
                grads["dq"][..., rows, :] = torch.matmul(ds.to(k.dtype).float(), kf)
            if "dk" in want:
                grads["dk"] += torch.matmul(ds.to(q.dtype).float().transpose(-1, -2), qb)
    dtypes = {"dq": q.dtype, "dk": k.dtype, "dv": v.dtype}
    return tuple(A._heads_last(grads[name]).to(dtypes[name]) for name in want)


def flash_bwd_dq_plain(q, k, v, do, lse, dcap, scale: float, num_heads: int = 1) -> torch.Tensor:
    """Plain version of the dq kernel."""
    return _bwd_plain(q, k, v, do, lse, dcap, scale, num_heads, ("dq",))[0]


def flash_bwd_dkv_plain(q, k, v, do, lse, dcap, scale: float,
                        num_heads: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the dk/dv kernel."""
    return _bwd_plain(q, k, v, do, lse, dcap, scale, num_heads, ("dk", "dv"))


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------


def _fwd_lib():
    from transparent_object_detection_tpu_torch.kernels import _build

    lib = _build.load("flash_attn_fwd")
    if not getattr(lib, "_lse_argtypes_set", False):
        vp, ci, cl, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        lib.flash_fwd_lse.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci, ci,
                                      cl, ci, cl, ci, cl, ci, cf, ci, vp]
        lib.flash_fwd_lse.restype = ci
        lib._lse_argtypes_set = True
    return lib


def _bwd_lib():
    from transparent_object_detection_tpu_torch.kernels import _build

    lib = _build.load("flash_attn_bwd")
    if not getattr(lib, "_argtypes_set", False):
        vp, ci, cl, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        lib.flash_bwd.argtypes = [ci, vp, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci,
                                  cl, ci, cl, ci, cl, ci, cl, ci, cl, ci, cf, ci, vp]
        lib.flash_bwd.restype = ci
        lib._argtypes_set = True
    return lib


def kernel_supports(n: int, dqk: int, dv: int, heads: int, dtype: torch.dtype) -> bool:
    """The domain of the training kernels: any N, q/k and v head widths that
    are multiples of 8 (16-byte rows), packed heads or one, bf16 or fp32."""
    return (n >= 1 and heads >= 1 and dqk > 0 and dv > 0
            and dqk % A.KERNEL_WIDTH_MULTIPLE == 0 and dv % A.KERNEL_WIDTH_MULTIPLE == 0
            and dtype in A.KERNEL_DTYPES)


def _check_view(name: str, t: torch.Tensor, dtype: torch.dtype) -> None:
    """A (B, N, C) CUDA operand of the call's type whose rows the kernel
    reads with 16-byte copies: last axis contiguous, row and batch strides
    multiples of 8."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype not in A.KERNEL_DTYPES or t.dtype != dtype:
        raise ValueError(f"{name}: the flash kernels take bfloat16 or float32 operands of one "
                         f"type, got {t.dtype}")
    if t.dim() != 3 or t.stride(-1) != 1 or t.stride(1) % 8 or t.stride(0) % 8:
        raise ValueError(f"{name} must be (B, N, C) with a contiguous last axis and row and "
                         f"batch strides that are multiples of 8, got strides {t.stride()}")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _check_stat(name: str, t: torch.Tensor, shape) -> None:
    if t.device.type != "cuda" or t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous float32 CUDA tensor")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")


def _widths(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int):
    """(b, n, dqk, dv) of a kernel call; raises on shapes the kernels do not take."""
    b, n, c = q.shape
    cv = v.shape[-1]
    if (k.shape != q.shape or v.shape[:2] != (b, n) or num_heads < 1 or c % num_heads
            or cv % num_heads
            or not kernel_supports(n, c // num_heads, cv // num_heads, num_heads, q.dtype)):
        raise ValueError(f"flash training kernels do not take q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} with {num_heads} heads")
    return b, n, c // num_heads, cv // num_heads


def flash_fwd_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                  num_heads: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash forward with logsumexp: -> out (B, N, H*dv), lse (B, N, 1) or
    (B, H, N, 1) fp32. Port of ops/attention_vjp.py::_fwd_lse_kernel
    (flash_fwd_lse, JAX). A CUDA tensor launches csrc/flash_attn_fwd.cu; a CPU
    tensor runs `flash_fwd_lse_plain`."""
    if q.device.type == "cpu":
        return flash_fwd_lse_plain(q, k, v, scale, num_heads)
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_view(name, t, q.dtype)
    b, n, dqk, dv = _widths(q, k, v, num_heads)
    out = torch.empty((b, n, v.shape[-1]), dtype=v.dtype, device=v.device)
    lse = torch.empty(_stat_shape(b, n, num_heads), dtype=torch.float32, device=q.device)
    err = _fwd_lib().flash_fwd_lse(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        b, n, num_heads, dqk, dv, q.stride(0), q.stride(1), k.stride(0), k.stride(1),
        v.stride(0), v.stride(1), scale, int(q.dtype == torch.float32),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    A._raise_on(err, "flash_fwd_lse")
    flash_fwd_lse.launches += 1
    return out, lse


def _check_bwd(q, k, v, do, lse, dcap, num_heads):
    for name, t in (("q", q), ("k", k), ("v", v), ("do", do)):
        _check_view(name, t, q.dtype)
    b, n, dqk, dv = _widths(q, k, v, num_heads)
    if do.shape != v.shape:
        raise ValueError(f"do has shape {tuple(do.shape)}, expected {tuple(v.shape)}")
    for name, t in (("lse", lse), ("dcap", dcap)):
        _check_stat(name, t, _stat_shape(b, n, num_heads))
    return b, n, dqk, dv


def _out(t: Optional[torch.Tensor], like: torch.Tensor, name: str) -> torch.Tensor:
    if t is None:
        return torch.empty(like.shape, dtype=like.dtype, device=like.device)
    _check_view(name, t, like.dtype)
    if t.shape != like.shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(like.shape)}")
    return t


def _bwd_launch(mode: int, q, k, v, do, lse, dcap, out, scale: float, num_heads: int,
                widths) -> None:
    b, n, dqk, dv = widths
    err = _bwd_lib().flash_bwd(
        mode, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        dcap.data_ptr(), out.data_ptr(), b, n, num_heads, dqk, dv,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
        do.stride(0), do.stride(1), out.stride(0), out.stride(1), scale,
        int(q.dtype == torch.float32), torch.cuda.current_stream(q.device).cuda_stream,
    )
    A._raise_on(err, ("flash_bwd dq", "flash_bwd dk", "flash_bwd dv")[mode])


def flash_bwd_dq(q, k, v, do, lse, dcap, scale: float, num_heads: int = 1,
                 dq: Optional[torch.Tensor] = None) -> torch.Tensor:
    """dq of the flash backward, written into `dq` (e.g. a column view of a
    packed gradient) when given. Port of ops/attention_vjp.py::_bwd_dq_kernel
    (JAX). A CUDA tensor launches csrc/flash_attn_bwd.cu; a CPU tensor runs
    `flash_bwd_dq_plain`."""
    if q.device.type == "cpu":
        res = flash_bwd_dq_plain(q, k, v, do, lse, dcap, scale, num_heads)
        return res if dq is None else dq.copy_(res)
    widths = _check_bwd(q, k, v, do, lse, dcap, num_heads)
    dq = _out(dq, q, "dq")
    _bwd_launch(MODE_DQ, q, k, v, do, lse, dcap, dq, scale, num_heads, widths)
    flash_bwd_dq.launches += 1
    return dq


def flash_bwd_dkv(q, k, v, do, lse, dcap, scale: float, num_heads: int = 1,
                  dk: Optional[torch.Tensor] = None,
                  dv: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """dk and dv of the flash backward (into `dk`/`dv` when given). Port of
    ops/attention_vjp.py::_bwd_dkv_kernel (JAX): on the card two launches of
    csrc/flash_attn_bwd.cu (the dk pass and the dv pass), counted as one; a
    CPU tensor runs `flash_bwd_dkv_plain`."""
    if q.device.type == "cpu":
        rk, rv = flash_bwd_dkv_plain(q, k, v, do, lse, dcap, scale, num_heads)
        return (rk if dk is None else dk.copy_(rk)), (rv if dv is None else dv.copy_(rv))
    widths = _check_bwd(q, k, v, do, lse, dcap, num_heads)
    dk, dv = _out(dk, k, "dk"), _out(dv, v, "dv")
    _bwd_launch(MODE_DK, q, k, v, do, lse, dcap, dk, scale, num_heads, widths)
    _bwd_launch(MODE_DV, q, k, v, do, lse, dcap, dv, scale, num_heads, widths)
    flash_bwd_dkv.launches += 1
    return dk, dv


flash_fwd_lse.launches = 0
flash_bwd_dq.launches = 0
flash_bwd_dkv.launches = 0


def reset_launch_counts() -> None:
    flash_fwd_lse.launches = 0
    flash_bwd_dq.launches = 0
    flash_bwd_dkv.launches = 0


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------


def _qkv_views(qkv: torch.Tensor):
    c = qkv.shape[-1] // 3
    return qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:]


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention, the counterpart of `_diff_flash`: the
    forward is `flash_fwd_lse` and saves q, k, v, out and lse; the backward
    is `compute_dcap` and then the dq and dk/dv kernels. Inputs are q, k, v,
    or one packed (B, N, 3C) qkv (then the gradient is one packed array).
    `plain` runs the plain versions on any device; on CPU tensors the
    backward runs them too, all three gradients in one pass."""

    @staticmethod
    def forward(ctx, scale: float, num_heads: int, plain: bool, *inputs):
        q, k, v = _qkv_views(inputs[0]) if len(inputs) == 1 else inputs
        fwd = flash_fwd_lse_plain if plain else flash_fwd_lse
        out, lse = fwd(q, k, v, scale, num_heads)
        ctx.save_for_backward(*inputs, out, lse)
        ctx.scale, ctx.num_heads, ctx.plain = scale, num_heads, plain
        return out

    @staticmethod
    def backward(ctx, g):
        *inputs, out, lse = ctx.saved_tensors
        scale, h = ctx.scale, ctx.num_heads
        packed = len(inputs) == 1
        q, k, v = _qkv_views(inputs[0]) if packed else inputs
        g = g.contiguous()
        dcap = compute_dcap(out, g, h)
        args = (q, k, v, g, lse, dcap, scale, h)
        if ctx.plain or q.device.type == "cpu":  # the plain versions, in one pass
            grads = _bwd_plain(*args, ("dq", "dk", "dv"))
            return (None, None, None) + ((torch.cat(grads, dim=-1),) if packed else grads)
        dqkv = torch.empty_like(inputs[0]) if packed else None
        dq, dk, dv = _qkv_views(dqkv) if packed else (None, None, None)
        dq = flash_bwd_dq(*args, dq=dq)
        dk, dv = flash_bwd_dkv(*args, dk=dk, dv=dv)
        return (None, None, None) + ((dqkv,) if packed else (dq, dk, dv))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                    num_heads: int = 1, impl: Optional[str] = None) -> torch.Tensor:
    """Differentiable flash attention on q, k, v (B, N, C), heads packed in C."""
    return FlashAttention.apply(scale, num_heads, impl == "plain", q, k, v)


def flash_attention_qkv(qkv: torch.Tensor, scale: float, num_heads: int,
                        impl: Optional[str] = None) -> torch.Tensor:
    """Differentiable packed multi-head flash attention on the (B, N, 3C) qkv
    projection output; its gradient is one (B, N, 3C) array."""
    return FlashAttention.apply(scale, num_heads, impl == "plain", qkv)
