"""int8 flash attention of the serving path: two CUDA kernels written for
Hopper, their plain PyTorch version, the k/v quantize pre-pass and the block
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

bk comes from `pick_blocks` (the JAX rule): the full N up to 6,400 at
phi='s' 640x640, so k and v get one scale per (batch, head); half or a
quarter of it at the wider heads of phi='m', 'l', 'x' (3,200, 1,600, 800,
320). The kernels take every shape `pick_blocks` tiles: q/k head widths
that are multiples of 32, v head widths multiples of 128, N and bk multiples
of 32 (a ragged last key tile is masked), q in bf16 or fp32 (the output in
q's type); the int8 output at v up to 8 slices (4,096 columns in slices
of 512).

One kernel serves every shape of that domain for all three entry points
(`int8_fwd_form` answers "sm90" throughout): csrc/flash_int8_sm90.cu, int8
wgmma fed by a TMA ring, launched with the plan of `int8_sm90_plan`, V
reaching it as the key-major copy of `vq_key_major`. v wider than 512 goes
in slices across blocks, each recomputing S for its query tile (dark3 of
phi 'm', 'l', 'x'; the phi 'l'/'x' neck heads of 768 to 3,584); an int8
output whose v is sliced exchanges each row's amax across a thread-block
cluster of the head's slices (at most 8: `kernel_supports`). q/k wider than
the resident Q tile allows (the phi 'l'/'x' neck heads) streams Q beside K
through the ring, S summed over the q/k slabs.

The int8 TEB's handoff variants (`config.Int8Variants`) run the same
function with other ends:
  * `attention_int8_quant_out` (TOD_ATTN_QOUT; kernel
    `flash_mha_int8_qout`, replaces `_mha_flash_int8_qout_kernel`): the
    output quantized per (row, head), `round(o * (127 / amax))` with amax
    over the head's columns (floor 1e-30), scales (B, N, H), for attn_out's
    x_quant input;
  * `teb_attention_handoff` (TOD_ATTN_HANDOFF; kernel `flash_int8_handoff`,
    replaces `_mha_flash_int8_handoff_kernel`): q is the int8 qkv payload
    of a quant_out projection, read in place and not re-rounded, with its
    (row, group) scale picked per head; k and v are that payload
    requantized onto per-(batch, head, key block) scalars by
    `requantize_section` (plain PyTorch: XLA in JAX); the output int8 as
    above or bf16.
The front ends reach the kernels through their registered operators
(`torch.ops.focus.*`, ops/library.py).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

LOG2E = 1.4426950408889634
LOG2_127 = 6.988684686772166
# The kernels' domain, that of `pick_blocks`: q/k head widths, v head widths,
# N and key blocks multiples of these.
KERNEL_DQ_MULTIPLE = 32
KERNEL_DV_MULTIPLE = 128
KERNEL_N_MULTIPLE = 32
Q_DTYPES = (torch.bfloat16, torch.float32)
# The Hopper kernel (csrc/flash_int8_sm90.cu): v past SM90_MAX_WIDTH in
# slices across blocks (SM90_SLICE columns, else 256 or 128), an int8
# output's slices one thread-block cluster of at most SM90_MAX_CLUSTER
# blocks; and the launch plans it is built for (`int8_sm90_plan`).
SM90_MAX_WIDTH = 512
SM90_SLICE = 512
SM90_SLICE_WIDTHS = (128, 256, 384, 512)  # rows form 128 / 256, split form 384 / 512
SM90_MAX_STAGES = 8
SM90_MAX_CLUSTER = 8  # the portable cluster size
SM90_SMEM_LIMIT = 232448
SM90_PLAN_KEYS = ("rows", "keys", "swq", "v_cols", "split", "stages", "v_stages", "multi",
                  "slices", "q_stream", "cluster", "smem_bytes")
INT8_OUT_ENTRIES = ("flash_mha_int8_qout", "flash_int8_handoff")
OUT_MODES = {torch.bfloat16: 0, torch.float32: 1, torch.int8: 2}
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


def _flash_plain_core(qq, qs, kq, ks, vq, vs, num_heads: int, scale: float) -> torch.Tensor:
    """The int8 flash function block by block as the kernel goes, from
    quantized q: qq int8 (B, H, N, dq) with scales qs (B, H, N, 1); kq
    (B, N, Cq) and vq (B, N, Cv) int8 with scales (B, H, N / bk). Returns
    o = acc / l in fp32, (B, H, N, dv)."""
    b, n = kq.shape[:2]
    nk = ks.shape[-1]
    bk = n // nk
    kh, vh = _split_heads(kq, num_heads), _split_heads(vq, num_heads)
    sl2 = scale * LOG2E
    outs = []
    for bi in range(b):  # one image at a time bounds the (H, N, bk) score tensors
        qd = qq[bi].double()
        m = torch.full(qs[bi].shape, -1e30, dtype=torch.float32, device=kq.device)
        l = torch.zeros_like(m)
        acc = torch.zeros(vh.shape[1:2] + (n, vh.shape[-1]), dtype=torch.float32,
                          device=kq.device)
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
        outs.append(acc * (1.0 / l))
    return torch.stack(outs)


def _merge_heads(o: torch.Tensor) -> torch.Tensor:
    b, h, n, d = o.shape
    return o.transpose(1, 2).reshape(b, n, h * d)


def _quantize_heads(o: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 (B, H, N, dv) -> int8 (B, N, H * dv) and f32 (B, N, H): one
    scale per (row, head), `round(o * (127 / amax))`, amax floored at 1e-30."""
    amax = torch.clamp(o.abs().amax(dim=-1, keepdim=True), min=1e-30)
    payload = torch.round(o * (torch.full_like(amax, 127.0) / amax)).to(torch.int8)
    return _merge_heads(payload), (amax[..., 0] * (1.0 / 127.0)).transpose(1, 2).contiguous()


def flash_mha_int8_plain(q, kq, ks, vq, vs, num_heads: int, scale: float,
                         q_width: Optional[int] = None) -> torch.Tensor:
    """Plain version of `flash_mha_int8`, block by block as the kernel goes.
    q (B, N, Cq) or packed (B, N, 3C) with q_width = C; kq (B, N, Cq) and
    vq (B, N, Cv) int8 with scales (B, H, N / bk) -> (B, N, Cv)."""
    qq, qs = _quantize_q(_split_heads(q[..., :kq.shape[-1]], num_heads))  # (B, H, N, dq)
    o = _flash_plain_core(qq, qs, kq, ks, vq, vs, num_heads, scale)
    return _merge_heads(o.to(q.dtype))


def flash_mha_int8_qout_plain(q, kq, ks, vq, vs, num_heads: int, scale: float,
                              q_width: Optional[int] = None):
    """Plain version of `flash_mha_int8_qout`: the function of
    `flash_mha_int8_plain` with its fp32 output quantized per (row, head):
    int8 (B, N, Cv) and f32 scales (B, N, H)."""
    qq, qs = _quantize_q(_split_heads(q[..., :kq.shape[-1]], num_heads))
    return _quantize_heads(_flash_plain_core(qq, qs, kq, ks, vq, vs, num_heads, scale))


def flash_int8_handoff_plain(payload, qs, kq, ks, vq, vs, num_heads: int, scale: float,
                             quant_out: bool, out_dtype=torch.bfloat16):
    """Plain version of `flash_int8_handoff`: q is the leading Cq columns of
    the int8 qkv payload (B, N, >= Cq), used as it is (no re-rounding), with
    per-(row, head) scales qs (B, N, H); kq, vq from `requantize_section`.
    Returns int8 (B, N, Cv) and f32 (B, N, H) with quant_out, else
    (B, N, Cv) in out_dtype."""
    qq = _split_heads(payload[..., :kq.shape[-1]], num_heads)
    o = _flash_plain_core(qq, qs.transpose(1, 2)[..., None], kq, ks, vq, vs, num_heads, scale)
    return _quantize_heads(o) if quant_out else _merge_heads(o.to(out_dtype))


def _head_scales(scales: torch.Tensor, col0: int, dh: int, g: int,
                 num_heads: int) -> torch.Tensor:
    """fp32 scales (B, N, H) of each head's covering group of per-(row,
    group) scales (B, N, G), head hh's first column at col0 + hh * dh. The
    index is made on the scales' device: a host list would be a copy to the
    card, which a CUDA graph capture refuses."""
    idx = torch.div(col0 + torch.arange(num_heads, device=scales.device) * dh, g,
                    rounding_mode="floor")
    return scales.float().index_select(-1, idx)


def requantize_section(payload: torch.Tensor, scales: torch.Tensor, col0: int, c: int,
                       num_heads: int, block_k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Columns [col0, col0 + c) of an int8 qkv payload (B, N, Ctot) with
    per-(row, group) scales (B, N, G) -> int8 (B, N, c) with one scale per
    (batch, head, key block), (B, H, N / bk): each head's row scale (its
    covering group's) over the block's largest, `round(x * ratio)`. Needs
    G == 1 or groups that cover whole heads (the caller checks). Plain
    PyTorch on every device: an XLA pre-pass in JAX, not a Pallas kernel."""
    b, n, ctot = payload.shape
    groups = scales.shape[-1]
    g = ctot // groups
    dh = c // num_heads
    nk = n // block_k
    if groups == 1:
        s_head = scales.float().expand(b, n, num_heads)
    else:
        s_head = _head_scales(scales, col0, dh, g, num_heads)
    s4 = s_head.reshape(b, nk, block_k, num_heads)
    s_blk = s4.amax(dim=2)  # (B, nk, H)
    ratio = s4 / torch.clamp(s_blk[:, :, None, :], min=1e-30)
    sec = payload[..., col0:col0 + c].reshape(b, nk, block_k, num_heads, dh).float()
    xq = torch.round(sec * ratio[..., None]).to(torch.int8)
    return xq.reshape(b, n, c), s_blk.transpose(1, 2).contiguous()


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------


def _check(name: str, t: torch.Tensor, dtype) -> None:
    dtypes = dtype if isinstance(dtype, tuple) else (dtype,)
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name}: the int8 flash kernel takes {dtypes}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _slice_cols(dv: int) -> int:
    """The rule's v slice: all of v up to 512, past it slices of 512 in the
    split form (256, then 128, where 512 does not divide v; measured 4%
    faster than slices of 256 and 30% faster than slices of 128 at phi='m'
    dark3, PERF.md)."""
    if dv <= SM90_MAX_WIDTH:
        return dv
    return next(w for w in (SM90_SLICE, 256, KERNEL_DV_MULTIPLE) if dv % w == 0)


def kernel_supports(n: int, dq: int, dv: int, bk: int, entry: str = "flash_mha_int8") -> bool:
    """Shapes the int8 kernel takes: those `pick_blocks` tiles (q/k widths
    multiples of 32, v of 128, N and bk of 32); for the two entries with an
    int8 output, v in at most SM90_MAX_CLUSTER slices (the cluster that
    exchanges each row's amax: v up to 4,096 in slices of 512)."""
    return (dq > 0 and dq % KERNEL_DQ_MULTIPLE == 0 and dv > 0
            and dv % KERNEL_DV_MULTIPLE == 0 and n > 0 and n % KERNEL_N_MULTIPLE == 0
            and bk > 0 and bk % KERNEL_N_MULTIPLE == 0 and n % bk == 0
            and (entry not in INT8_OUT_ENTRIES or dv // _slice_cols(dv) <= SM90_MAX_CLUSTER))


def _check_kv(q, q_dtype, q_row_expected: int, kq, ks, vq, vs, num_heads: int,
              entry: str) -> Tuple[int, int, int, int, int, int]:
    """Device, type and shape checks shared by the three wrappers; returns
    (b, n, dq, dv, nk, q_row)."""
    b, n, cq = kq.shape
    cv = vq.shape[-1]
    nk = ks.shape[-1]
    _check("q", q, q_dtype)
    for name, t, dt in (("kq", kq, torch.int8), ("vq", vq, torch.int8),
                        ("ks", ks, torch.float32), ("vs", vs, torch.float32)):
        _check(name, t, dt)
    q_row = q.shape[-1]
    dq, dv = cq // num_heads, cv // num_heads
    if (q.shape[:2] != (b, n) or q_row != q_row_expected or vq.shape[:2] != (b, n)
            or tuple(ks.shape) != (b, num_heads, nk) or ks.shape != vs.shape
            or n % nk or cq % num_heads or cv % num_heads
            or not kernel_supports(n, dq, dv, n // nk, entry)):
        raise ValueError(f"int8 flash kernel does not take q {tuple(q.shape)}, "
                         f"kq {tuple(kq.shape)}, vq {tuple(vq.shape)}, scales "
                         f"{tuple(ks.shape)} with {num_heads} heads")
    return b, n, dq, dv, nk, q_row


def _q_workspace(b: int, n: int, cq: int, num_heads: int, device):
    """The quantized q the kernel's first launch writes: int8 (B, N, Cq) and
    per-(row, head) scales (B, N, H)."""
    return (torch.empty((b, n, cq), dtype=torch.int8, device=device),
            torch.empty((b, n, num_heads), dtype=torch.float32, device=device))


def int8_fwd_form(dq: int, dv: int, entry: str = "flash_mha_int8") -> str:
    """The kernel of an int8 attention call of entry point `entry` on heads of
    q/k width `dq` and v width `dv`: "sm90" (csrc/flash_int8_sm90.cu) for
    every width of the domain of `kernel_supports`, all three entry points;
    raises outside it. One kernel, no other route: the phi 'l'/'x' neck heads
    stream Q through the ring, an int8 output on sliced v exchanges its amax
    across a cluster (`int8_sm90_plan`)."""
    if entry not in ("flash_mha_int8",) + INT8_OUT_ENTRIES:
        raise ValueError(f"no int8 attention entry point {entry!r}")
    if not kernel_supports(KERNEL_N_MULTIPLE, dq, dv, KERNEL_N_MULTIPLE, entry):
        raise ValueError(f"the int8 kernel takes q/k widths that are multiples of 32 and v "
                         f"widths that are multiples of 128 ({entry}: in at most "
                         f"{SM90_MAX_CLUSTER} slices), got q/k {dq}, v {dv}")
    return "sm90"


def int8_sm90_smem_bytes(plan: dict, dq: int) -> int:
    """Dynamic shared memory of an sm90 plan (as csrc/flash_int8_sm90.cu
    computes it): 1024 bytes of alignment slack, 1024 of barriers, the int8
    Q tile where it is resident, the ring (each stage one `swq`-byte slab of
    `keys` keys, and with `q_stream` the same slab of the block's `rows` q
    rows before it), the V ring (stages of `keys` keys x the v columns a
    block covers), and with several key blocks the fp32 acc of both
    warpgroups."""
    slabs = -(-dq // plan["swq"])
    q_slab = plan["rows"] * plan["swq"]
    return (2048 + (0 if plan["q_stream"] else slabs * q_slab)
            + plan["stages"] * (plan["keys"] * plan["swq"] + (q_slab if plan["q_stream"] else 0))
            + plan["v_stages"] * (2 if plan["split"] else 1) * plan["v_cols"] * plan["keys"]
            + (2 * 64 * plan["v_cols"] * 4 if plan["multi"] else 0))


@functools.lru_cache(maxsize=None)
def int8_sm90_plan(dq: int, dv: int, nk: int, slice_cols: Optional[int] = None,
                   int8_out: bool = False) -> dict:
    """Launch plan of csrc/flash_int8_sm90.cu for heads of q/k width `dq`
    and v width `dv` (the domain of `kernel_supports`) in `nk` key blocks.
    v is cut into `slices` slices of `slice_cols` columns (`_slice_cols`'s
    rule; another width of SM90_SLICE_WIDTHS for measurement), one a block,
    each block recomputing S for its query tile: 2 * slices q.k^T products
    and one P.V where the bound counts two and one (PERF.md). With
    `int8_out` (the int8-output entries) the slices of a head are one
    thread-block cluster (`cluster` = slices, at most 8) that exchanges each
    row's amax over distributed shared memory. A slice up to 256: 128 rows a
    block, each consumer warpgroup on 64 of them with all the slice's
    columns (key tiles of 128 at 128 columns, else 64). 384 or 512: split,
    64 rows a block, both warpgroups on the same rows, each computing S and
    P.V on its half (192 or 256 columns) on 64-key tiles (measured faster
    than sharing one S at phi='m' h2, h4 and phi='s' dark3, PERF.md). q/k
    boxes of 64 bytes at q/k up to 64 (q/k 32 zero-filled past its width),
    else 128. The int8 Q tile resident where a plan with it fits; else
    (`q_stream`: the phi 'l'/'x' neck heads) each ring stage carries the Q
    slab beside the K slab. Two V stages where at least two ring stages fit
    beside them, else one; the most ring stages (up to 8) that fit the
    card's 227 KB. Cached, as each launch asks for its plan: the dict is
    shared and not to be changed."""
    int8_fwd_form(dq, dv, INT8_OUT_ENTRIES[0] if int8_out else "flash_mha_int8")  # the domain
    if nk < 1:
        raise ValueError(f"no sm90 int8 plan for {nk} key blocks")
    slice_cols = _slice_cols(dv) if slice_cols is None else slice_cols
    if slice_cols not in SM90_SLICE_WIDTHS or dv % slice_cols:
        raise ValueError(f"no sm90 int8 form takes v {dv} in slices of {slice_cols}")
    split = slice_cols > 256
    slices = dv // slice_cols
    if int8_out and slices > SM90_MAX_CLUSTER:
        raise ValueError(f"an int8 output takes v in at most {SM90_MAX_CLUSTER} slices (one "
                         f"cluster), got {slices} slices of {slice_cols}")
    plan = {"rows": 64 if split else 128, "keys": 128 if slice_cols <= 128 else 64,
            "swq": 64 if dq <= 64 else 128, "v_cols": slice_cols // 2 if split else slice_cols,
            "split": int(split), "multi": int(nk > 1), "slices": slices,
            "cluster": slices if int8_out else 1}
    for q_stream, v_stages, least in ((0, 2, 2), (0, 1, 1), (1, 2, 2), (1, 1, 1)):
        trial = {**plan, "q_stream": q_stream, "v_stages": v_stages}
        fits = [st for st in range(SM90_MAX_STAGES, 0, -1)
                if int8_sm90_smem_bytes({**trial, "stages": st}, dq) <= SM90_SMEM_LIMIT]
        if fits and fits[0] >= least:
            plan = {**trial, "stages": fits[0]}
            plan["smem_bytes"] = int8_sm90_smem_bytes(plan, dq)
            return plan
    raise ValueError(f"no sm90 int8 plan fits q/k {dq}, v {dv}, {nk} key blocks")


def vq_key_major(vq: torch.Tensor, num_heads: int) -> torch.Tensor:
    """The key-major copy of vq that the sm90 kernel's P.V product reads
    (8-bit wgmma takes both operands K-major): (B, N, H * dv) ->
    (B, H, dv, N), one pass over B * N * Cv bytes. Within each 32-key group
    key 16h + 8c + 2t + e lands at position 16h + 4t + 2c + e (h, c, e in
    {0, 1}, t in 0..3): the order in which the s32 accumulator of q.k^T
    holds a thread's keys, so the accumulator is the int8 A fragment of the
    product as it stands (csrc/flash_int8_sm90.cu, [P layout]); pv is an
    exact int32 sum, so the order changes no bit. N is a multiple of 32."""
    b, n, cv = vq.shape
    dv = cv // num_heads
    grouped = vq.reshape(b, n // 32, 2, 2, 4, 2, num_heads, dv)  # (.., h, c, t, e, H, dv)
    return grouped.permute(0, 6, 7, 1, 2, 4, 3, 5).reshape(b, num_heads, dv, n).contiguous()


def _sm90_lib():
    from transparent_object_detection_tpu_torch.kernels import _build

    lib = _build.load("flash_int8_sm90")
    if not getattr(lib, "_argtypes_set", False):
        vp, ci, cl, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        lib.flash_int8_sm90.argtypes = [vp, ci, vp, vp, vp, vp, vp, vp, vp, vp, vp, ci, ci, ci,
                                        ci, ci, ci, cl, ci, ci, cf, vp, vp]
        lib.flash_int8_sm90.restype = ci
        lib._argtypes_set = True
    return lib


def _launch_sm90(q, qs, kq, ks, vq, vs, num_heads: int, scale: float, out_dtype,
                 vt: Optional[torch.Tensor] = None, plan: Optional[dict] = None):
    """One launch of csrc/flash_int8_sm90.cu with the plan of
    `int8_sm90_plan` (`plan`: another of its plans, for measurement) on
    checked CUDA operands: q bf16 or fp32 (quantized per (row, head) into a
    workspace first) or the int8 qkv payload with its scale table qs; V as
    `vq_key_major(vq)` (`vt`: that layout made by the caller, which
    chip_smoke.py's planted fault replaces). Returns out in out_dtype (bf16,
    fp32, or int8 with its (B, N, H) scales; an int8 output on sliced v
    takes a plan whose cluster spans the slices). Raises if the launch
    fails; never falls back."""
    b, n, cq = kq.shape
    cv = vq.shape[-1]
    nk = ks.shape[-1]
    dq, dv = cq // num_heads, cv // num_heads
    int8_out = out_dtype == torch.int8
    plan = int8_sm90_plan(dq, dv, nk, int8_out=int8_out) if plan is None else plan
    if int8_out and plan["cluster"] != plan["slices"]:
        raise ValueError(f"an int8 output takes one amax over the head's whole v: its "
                         f"{plan['slices']} v slices must be one cluster, got {plan['cluster']}")
    vt = vq_key_major(vq, num_heads) if vt is None else vt
    q_kind = 2 if q.dtype == torch.int8 else int(q.dtype == torch.float32)
    q8, q_scales = (None, None) if q_kind == 2 else _q_workspace(b, n, cq, num_heads, q.device)
    out = torch.empty((b, n, cv), dtype=out_dtype, device=q.device)
    out_scales = (torch.empty((b, n, num_heads), dtype=torch.float32, device=q.device)
                  if int8_out else None)
    plan_arr = (ctypes.c_int * len(SM90_PLAN_KEYS))(*(plan[key] for key in SM90_PLAN_KEYS))
    ptr = lambda t: None if t is None else t.data_ptr()
    err = _sm90_lib().flash_int8_sm90(
        q.data_ptr(), q_kind, ptr(qs), kq.data_ptr(), ks.data_ptr(), vt.data_ptr(),
        vs.data_ptr(), ptr(q8), ptr(q_scales), out.data_ptr(), ptr(out_scales),
        OUT_MODES[out_dtype], b, n, num_heads, dq, dv, q.shape[-1], n // nk, nk, scale * LOG2E,
        ctypes.cast(plan_arr, ctypes.c_void_p), _stream(q))
    _raise_on(err, "flash_int8_sm90")
    return (out, out_scales) if int8_out else out


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def flash_mha_int8(q, kq, ks, vq, vs, num_heads: int, scale: float,
                   q_width: Optional[int] = None) -> torch.Tensor:
    """int8 flash attention: q bf16 or fp32 (B, N, Cq), or the packed
    (B, N, 3C) qkv with q_width = C (q read in place); kq (B, N, Cq), vq
    (B, N, Cv) int8 with f32 scales (B, H, N / bk) -> (B, N, Cv) in q's type.

    Port of ops/attention_int8.py::_mha_flash_int8_kernel. A CUDA tensor
    quantizes q per (row, head) into a workspace, then runs
    csrc/flash_int8_sm90.cu (two launches counted as one in
    `sm90_launches`). A CPU tensor runs `flash_mha_int8_plain`."""
    if q.device.type == "cpu":
        return flash_mha_int8_plain(q, kq, ks, vq, vs, num_heads, scale, q_width)
    cq = kq.shape[-1]
    if q_width is not None and q_width != cq:
        raise ValueError(f"q_width {q_width} is not the q/k width {cq}")
    _check_kv(q, Q_DTYPES, cq if q_width is None else 3 * cq, kq, ks, vq, vs, num_heads,
              "flash_mha_int8")
    out = _launch_sm90(q, None, kq, ks, vq, vs, num_heads, scale, q.dtype)
    flash_mha_int8.sm90_launches += 1
    return out


def flash_mha_int8_qout(q, kq, ks, vq, vs, num_heads: int, scale: float,
                        q_width: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """`flash_mha_int8` with its output quantized per (row, head): int8
    (B, N, Cv) and f32 scales (B, N, H), for attn_out's x_quant input.

    Port of ops/attention_int8.py::_mha_flash_int8_qout_kernel. A CUDA
    tensor runs csrc/flash_int8_sm90.cu, the quantization in its epilogue
    (`sm90_launches`); a CPU tensor runs `flash_mha_int8_qout_plain`."""
    if q.device.type == "cpu":
        return flash_mha_int8_qout_plain(q, kq, ks, vq, vs, num_heads, scale, q_width)
    cq = kq.shape[-1]
    if q_width is not None and q_width != cq:
        raise ValueError(f"q_width {q_width} is not the q/k width {cq}")
    _check_kv(q, Q_DTYPES, cq if q_width is None else 3 * cq, kq, ks, vq, vs, num_heads,
              "flash_mha_int8_qout")
    out = _launch_sm90(q, None, kq, ks, vq, vs, num_heads, scale, torch.int8)
    flash_mha_int8_qout.sm90_launches += 1
    return out


def flash_int8_handoff(payload, qs, kq, ks, vq, vs, num_heads: int, scale: float,
                       quant_out: bool, out_dtype=torch.bfloat16):
    """int8 flash attention on the int8 qkv payload: q is its leading Cq
    columns, read in place (row stride = the payload's width) and used
    as it is, with per-(row, head) scales qs (B, N, H); kq, vq from
    `requantize_section`. Returns int8 (B, N, Cv) and f32 (B, N, H) with
    quant_out, else (B, N, Cv) in out_dtype (bf16 or fp32).

    Port of ops/attention_int8.py::_mha_flash_int8_handoff_kernel (both its
    output forms count as launches of it). A CUDA tensor runs
    csrc/flash_int8_sm90.cu (`sm90_launches`); a CPU tensor runs
    `flash_int8_handoff_plain`."""
    if payload.device.type == "cpu":
        return flash_int8_handoff_plain(payload, qs, kq, ks, vq, vs, num_heads, scale,
                                        quant_out, out_dtype)
    if not quant_out and out_dtype not in Q_DTYPES:
        raise ValueError(f"the int8 handoff kernel writes {Q_DTYPES} or int8, not {out_dtype}")
    b, n, _, _, _, q_row = _check_kv(payload, torch.int8, payload.shape[-1], kq, ks, vq, vs,
                                     num_heads, "flash_int8_handoff")
    _check("qs", qs, torch.float32)
    if tuple(qs.shape) != (b, n, num_heads) or q_row < kq.shape[-1] or q_row % 16:
        raise ValueError(f"int8 handoff kernel does not take payload {tuple(payload.shape)} "
                         f"with q scales {tuple(qs.shape)}")
    out = _launch_sm90(payload, qs, kq, ks, vq, vs, num_heads, scale,
                       torch.int8 if quant_out else out_dtype)
    flash_int8_handoff.sm90_launches += 1
    return out


ENTRY_POINTS = (flash_mha_int8, flash_mha_int8_qout, flash_int8_handoff)


def reset_launch_counts() -> None:
    for fn in ENTRY_POINTS:
        fn.sm90_launches = 0


reset_launch_counts()


# ---------------------------------------------------------------------------
# front ends
# ---------------------------------------------------------------------------


def attention_int8(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                   num_heads: int, block_k: int, q_width: Optional[int] = None,
                   impl: Optional[str] = None) -> torch.Tensor:
    """k/v quantize pre-pass, then the int8 flash kernel (or, impl="plain",
    its plain version). k and v may be views into the packed qkv array."""
    kq, ks = quantize_kv(k, num_heads, block_k)
    vq, vs = quantize_kv(v, num_heads, block_k)
    if impl == "plain":
        return flash_mha_int8_plain(q, kq, ks, vq, vs, num_heads, scale, q_width)
    return torch.ops.focus.flash_mha_int8(q.contiguous(), kq, ks, vq, vs, num_heads, scale,
                                          q_width)


def attention_int8_quant_out(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                             num_heads: int, q_width: Optional[int] = None,
                             impl: Optional[str] = None
                             ) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """The quant_out attention variant (JAX `attention_int8_quant_out`):
    (int8 (B, N, Cv), f32 per-(row, head) scales (B, N, H)) for attn_out's
    x_quant input, or None where `pick_blocks` does not tile the shapes (the
    caller takes the bf16-output route). q may be the packed (B, N, 3C) qkv
    with q_width = C and k, v views into it, read in place."""
    cq = k.shape[-1]
    blocks = pick_blocks(q.shape[1], cq, num_heads, cv=v.shape[-1])
    if blocks is None:
        return None
    kq, ks = quantize_kv(k, num_heads, blocks[1])
    vq, vs = quantize_kv(v, num_heads, blocks[1])
    if impl == "plain":
        return flash_mha_int8_qout_plain(q, kq, ks, vq, vs, num_heads, scale, q_width)
    return torch.ops.focus.flash_mha_int8_qout(q.contiguous(), kq, ks, vq, vs, num_heads,
                                               scale, q_width)


def q_scale_table(scales: torch.Tensor, c: int, num_heads: int) -> torch.Tensor:
    """Per-(row, head) q scales (B, N, H) of a qkv payload's per-(row, group)
    scales (B, N, G): each head's covering group (G == 1: the row's)."""
    b, n, groups = scales.shape
    if groups == 1:
        return scales.float().expand(b, n, num_heads).contiguous()
    g, dh = 3 * c // groups, c // num_heads
    return _head_scales(scales, 0, dh, g, num_heads).contiguous()


def teb_attention_handoff(payload: torch.Tensor, scales: torch.Tensor, num_heads: int,
                          scale: float, quant_out: bool = True, out_dtype=torch.bfloat16,
                          impl: Optional[str] = None):
    """Attention over a quant_out qkv projection (JAX
    `teb_attention_handoff`): payload int8 (B, N, 3C) with per-(row, group)
    scales (B, N, G). Returns (int8 (B, N, C), f32 (B, N, H)) with quant_out
    (for attn_out's x_quant input), else (B, N, C) in out_dtype; None where
    the handoff does not apply (C not divisible by the heads, scale groups
    that do not cover whole heads, shapes `pick_blocks` rejects): the caller
    then dequantizes and takes the bf16 route."""
    b, n, c3 = payload.shape
    c = c3 // 3
    h = num_heads
    if c % h:
        return None
    dh = c // h
    groups = scales.shape[-1]
    g = c3 // groups
    aligned = groups == 1 or (c % g == 0 and g % dh == 0)
    blocks = pick_blocks(n, c, h, cv=c)
    if not aligned or blocks is None:
        return None
    bk = blocks[1]
    qs = q_scale_table(scales, c, h)
    kq, ks = requantize_section(payload, scales, c, c, h, bk)
    vq, vs = requantize_section(payload, scales, 2 * c, c, h, bk)
    if impl == "plain":
        return flash_int8_handoff_plain(payload, qs, kq, ks, vq, vs, h, scale, quant_out,
                                        out_dtype)
    args = (payload.contiguous(), qs, kq, ks, vq, vs, h, scale)
    if quant_out:
        return torch.ops.focus.flash_int8_handoff_qout(*args)
    return torch.ops.focus.flash_int8_handoff(*args, out_dtype)
