"""int8 flash attention of the serving path: a CUDA kernel written for
Hopper, its plain PyTorch version, the k/v quantize pre-pass and the block
rule that sets the k/v scale granularity.

Counterpart of transparent_object_detection_tpu/ops/attention_int8.py
(`flash_attention_mha_int8`, the `_mha_flash_int8_kernel` path). Layouts are
the JAX package's: head-packed (B, N, H*d) tokens; q may be read in place out
of the packed (B, N, 3C) qkv projection output (`q_width`).

The function, per (batch, head, query row):
  * q: per (row, head) int8, `round(q * (127 / amax))`, scale amax / 127;
  * k, v: int8 with one scale per (batch, head, block of bk keys),
    `round(x / (amax / 127))` (a divide), from `quantize_kv` (plain PyTorch:
    an XLA pre-pass in JAX, not a Pallas kernel);
  * per key block: s = int32(qq . kq) * (q_scale * (k_scale * scale * log2 e));
    m_new = max(m, max over the WHOLE block of s) (m starts at -1e30);
    p127 = exp2(s - (m_new - log2 127)); l = l * exp2(m - m_new) + sum p127
    (unrounded); pv = int32 sum over the block of round(p127) * vq;
    acc = acc * exp2(m - m_new) + float(pv) * v_scale;
  * out = acc * (1 / l), in the input type.
p is rounded against the maximum of its whole key block, so weights below
1/254 of the block's largest round to 0. A kernel that rounded against the
running maximum of smaller tiles would compute another function.

bk comes from `pick_blocks` (the JAX rule): the full N up to 6,400 on the
serving path, so k and v get one scale per (batch, head).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

LOG2E = 1.4426950408889634
LOG2_127 = 6.988684686772166
# q/k widths the CUDA kernel is instantiated for (dark3 64, neck heads 256),
# the v column slice one block accumulates, and the key tile of its loop.
KERNEL_DQ = (64, 256)
KERNEL_DV_TILE = 256
KERNEL_KEY_TILE = 64
_VMEM_BUDGET = 15 * 1024 * 1024 + 512 * 1024


def _block32(n: int, preferred: int) -> Optional[int]:
    """Largest multiple of 32 <= preferred dividing n."""
    for b in range(min(preferred, n) // 32 * 32, 31, -32):
        if n % b == 0:
            return b
    return None


def pick_blocks(n: int, cq: int, num_heads: int, block_q: Optional[int] = None,
                block_k: Optional[int] = None,
                cv: Optional[int] = None) -> Optional[Tuple[int, int]]:
    """(bq, bk) of the JAX int8 route, or None where it does not apply (the
    caller takes the bf16 route). bk is the k/v scale granularity and so
    part of the function; bq is not. The JAX package's rule, kept verbatim."""
    if cv is None:
        cv = cq
    if (num_heads < 1 or cq % num_heads or cv % num_heads
            or (cv // num_heads) % 128 or (cq // num_heads) % 32):
        return None
    dq, dv = cq // num_heads, cv // num_heads
    if block_k is None:
        block_k = n if n <= 6400 else 6400
    if block_q is None:
        block_q = 320 if block_k >= 3200 else 512
    bq = _block32(n, block_q)
    bk = _block32(n, block_k)
    if bq is None or bk is None:
        return None

    def vmem(bq_, bk_):
        return (2 * bk_ * (dq + dv) + bq_ * (2 * dq + dq + 4 * dv) + 4 * 3 * bq_ * 128
                + bq_ * bk_ * 4)

    while bk and bk > 128 and 2 * bk * (dq + dv) > _VMEM_BUDGET // 2:
        bk = _block32(n, bk - 32)
    while bq and bk and vmem(bq, bk) > _VMEM_BUDGET and bq > 32:
        bq = _block32(n, bq - 32)
    while bq and bk and vmem(bq, bk) > _VMEM_BUDGET and bk > 128:
        bk = _block32(n, bk - 32)
    if not bq or not bk or bq < 32 or vmem(bq, bk) > _VMEM_BUDGET:
        return None
    return bq, bk


def quantize_kv(x: torch.Tensor, num_heads: int, block_k: int):
    """(B, N, H*d) -> (int8 (B, N, H*d), f32 (B, H, N / bk) scales): absmax
    over each (key block, head) slab / 127, then a divide."""
    b, n, c = x.shape
    d = c // num_heads
    xf = x.float().reshape(b, n // block_k, block_k, num_heads, d)
    s = torch.clamp(xf.abs().amax(dim=(2, 4)) / 127.0, min=1e-12)  # (B, nk, H)
    xq = torch.round(xf / s[:, :, None, :, None]).to(torch.int8)
    return xq.reshape(b, n, c), s.transpose(1, 2).contiguous()


def _quantize_q(q: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row int8 of (..., d) rows: payload and amax / 127."""
    qf = q.float()
    amax = torch.clamp(qf.abs().amax(dim=-1, keepdim=True), min=1e-12)
    qq = torch.round(qf * (torch.full_like(amax, 127.0) / amax)).to(torch.int8)
    return qq, amax * (1.0 / 127.0)


def _split_heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    b, n, c = t.shape
    return t.reshape(b, n, heads, c // heads).transpose(1, 2)


def flash_mha_int8_plain(q, kq, ks, vq, vs, num_heads: int, scale: float,
                         q_width: Optional[int] = None) -> torch.Tensor:
    """Plain version of `flash_mha_int8`, block by block as the kernel goes.
    q (B, N, Cq) or packed (B, N, 3C) with q_width = C; kq (B, N, Cq) and
    vq (B, N, Cv) int8 with scales (B, H, N / bk) -> (B, N, Cv)."""
    cq = kq.shape[-1]
    b, n = kq.shape[:2]
    nk = ks.shape[-1]
    bk = n // nk
    qq, qs = _quantize_q(_split_heads(q[..., :cq], num_heads))  # (B, H, N, dq)
    kh, vh = _split_heads(kq, num_heads), _split_heads(vq, num_heads)
    sl2 = scale * LOG2E
    outs = []
    for bi in range(b):  # one image at a time bounds the (H, N, bk) score tensors
        qd = qq[bi].double()
        m = torch.full(qs[bi].shape, -1e30, dtype=torch.float32, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros(vh.shape[1:2] + (n, vh.shape[-1]), dtype=torch.float32,
                          device=q.device)
        for j in range(nk):
            blk = slice(j * bk, (j + 1) * bk)
            s32 = torch.matmul(qd, kh[bi, :, blk].double().transpose(-1, -2))  # exact
            row_scale = qs[bi] * (ks[bi, :, j] * sl2)[:, None, None]
            s = s32.float() * row_scale
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p127 = torch.exp2(s - (m_new - LOG2_127))
            corr = torch.exp2(m - m_new)
            l = l * corr + p127.sum(dim=-1, keepdim=True)
            pv32 = torch.matmul(torch.round(p127).double(), vh[bi, :, blk].double())
            acc = acc * corr + pv32.float() * vs[bi, :, j][:, None, None]
            m = m_new
        outs.append((acc * (1.0 / l)).to(q.dtype))
    out = torch.stack(outs)  # (B, H, N, dv)
    return out.transpose(1, 2).reshape(b, n, -1)


# ---------------------------------------------------------------------------
# CUDA kernel wrapper
# ---------------------------------------------------------------------------


def _lib():
    from transparent_object_detection_tpu_torch.kernels import _build

    lib = _build.load("flash_attn_int8")
    if not getattr(lib, "_argtypes_set", False):
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_mha_int8.argtypes = [vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, ci,
                                       cf, vp]
        lib.flash_mha_int8.restype = ci
        lib._argtypes_set = True
    return lib


def _check(name: str, t: torch.Tensor, dtype: torch.dtype) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: the int8 flash kernel takes {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def kernel_supports(n: int, dq: int, dv: int, bk: int) -> bool:
    return (dq in KERNEL_DQ and dv % KERNEL_DV_TILE == 0 and n % KERNEL_KEY_TILE == 0
            and bk % KERNEL_KEY_TILE == 0)


def flash_mha_int8(q, kq, ks, vq, vs, num_heads: int, scale: float,
                   q_width: Optional[int] = None) -> torch.Tensor:
    """int8 flash attention: q bf16 (B, N, Cq), or the packed (B, N, 3C) qkv
    with q_width = C (q read in place); kq (B, N, Cq), vq (B, N, Cv) int8
    with f32 scales (B, H, N / bk) -> bf16 (B, N, Cv).

    Port of ops/attention_int8.py::_mha_flash_int8_kernel. A CUDA tensor
    launches csrc/flash_attn_int8.cu; a CPU tensor runs
    `flash_mha_int8_plain`."""
    if q.device.type == "cpu":
        return flash_mha_int8_plain(q, kq, ks, vq, vs, num_heads, scale, q_width)
    b, n, cq = kq.shape
    cv = vq.shape[-1]
    nk = ks.shape[-1]
    _check("q", q, torch.bfloat16)
    for name, t, dt in (("kq", kq, torch.int8), ("vq", vq, torch.int8),
                        ("ks", ks, torch.float32), ("vs", vs, torch.float32)):
        _check(name, t, dt)
    q_row = q.shape[-1]
    dq, dv = cq // num_heads, cv // num_heads
    if (q.shape[:2] != (b, n) or q_row != (cq if q_width is None else 3 * q_width)
            or (q_width is not None and q_width != cq) or vq.shape[:2] != (b, n)
            or tuple(ks.shape) != (b, num_heads, nk) or ks.shape != vs.shape
            or n % nk or cq % num_heads or cv % num_heads
            or not kernel_supports(n, dq, dv, n // nk)):
        raise ValueError(f"int8 flash kernel does not take q {tuple(q.shape)}, "
                         f"kq {tuple(kq.shape)}, vq {tuple(vq.shape)}, scales "
                         f"{tuple(ks.shape)} with {num_heads} heads")
    out = torch.empty((b, n, cv), dtype=torch.bfloat16, device=q.device)
    err = _lib().flash_mha_int8(
        q.data_ptr(), kq.data_ptr(), ks.data_ptr(), vq.data_ptr(), vs.data_ptr(),
        out.data_ptr(), b, n, num_heads, dq, dv, q_row, n // nk, nk, scale * LOG2E,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_mha_int8: CUDA launch failed with cudaError_t {err}")
    flash_mha_int8.launches += 1
    return out


flash_mha_int8.launches = 0


def reset_launch_counts() -> None:
    flash_mha_int8.launches = 0


def attention_int8(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                   num_heads: int, block_k: int, q_width: Optional[int] = None,
                   impl: Optional[str] = None) -> torch.Tensor:
    """k/v quantize pre-pass, then the int8 flash kernel (or, impl="plain",
    its plain version). k and v may be views into the packed qkv array."""
    kq, ks = quantize_kv(k, num_heads, block_k)
    vq, vs = quantize_kv(v, num_heads, block_k)
    if impl == "plain":
        return flash_mha_int8_plain(q, kq, ks, vq, vs, num_heads, scale, q_width)
    return flash_mha_int8(q.contiguous(), kq, ks, vq, vs, num_heads, scale, q_width)
