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

  flash_fwd_lse  replaces _fwd_lse_kernel (csrc/flash_fwd_sm90.cu for bf16
                 packed heads whose widths are multiples of 64, the rule
                 of attention.packed_fwd_form, and, in its one-head form,
                 for every bf16 call with one head (dark3, the folded
                 heads; attention.single_fwd_form);
                 csrc/flash_fwd_f32_sm90.cu for fp32 at every width,
                 packed heads or one; csrc/flash_attn_fwd.cu for packed
                 bf16 heads of other widths, which no route reaches)
  flash_bwd_dq   replaces _bwd_dq_kernel  (csrc/flash_bwd_sm90.cu for bf16
                 packed heads of equal widths that are multiples of 64 up to
                 384, the rule of `bwd_form`; csrc/flash_bwd_single_sm90.cu
                 for bf16 with one head: dark3 of phi 'n', 's' and 'm', the
                 folded heads;
                 csrc/flash_bwd_f32_sm90.cu for fp32 at every width, packed
                 heads or one; csrc/flash_attn_bwd.cu for the other bf16
                 calls: dark3 of phi 'l' and 'x', packed heads of 448 and
                 wider, other widths)
  flash_bwd_dkv  replaces _bwd_dkv_kernel (the same four sources: on the
                 bf16 sm90 kernel one launch up to heads of 256 and two, a dv
                 and a dk launch, at 320 and 384; on the one-head and fp32
                 kernels one launch; on the template two, the dk pass and the
                 dv pass; counted once, as the TPU kernel)

Each wrapper launches its kernel for CUDA tensors (or raises) and runs its
plain version only for CPU tensors; `launches` counts kernel launches. The
kernels take the Pallas kernels' whole domain (`kernel_supports`): any q/k
and v head widths that are multiples of 8 (the folded odd heads are
zero-padded by ops/attention.py), any N, bf16 or fp32 (nothing cast, as the
Pallas kernels compute on fp32 inputs: forward and backward as 3xTF32 on
the tensor cores).
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
                                      cl, ci, cl, ci, cl, ci, cf, vp]
        lib.flash_fwd_lse.restype = ci
        lib._lse_argtypes_set = True
    return lib


def _bwd_lib():
    from transparent_object_detection_tpu_torch.kernels import _build

    lib = _build.load("flash_attn_bwd")
    if not getattr(lib, "_argtypes_set", False):
        vp, ci, cl, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        lib.flash_bwd.argtypes = [ci, vp, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci,
                                  cl, ci, cl, ci, cl, ci, cl, ci, cl, ci, cf, vp]
        lib.flash_bwd.restype = ci
        lib._argtypes_set = True
    return lib


# The Hopper backward (csrc/flash_bwd_sm90.cu): heads up to six 64-column
# slabs wide, streamed as operand tiles through one ring; from five slabs
# (320) the split forms.
SM90_BWD_SLAB = 64
SM90_BWD_MAX_WIDTH = 384
SM90_BWD_SPLIT_FROM = 320
SM90_BWD_MAX_STAGES = 24
SM90_BWD_PLAN_KEYS = ("rows", "slab", "stages", "split", "smem_bytes")


def bwd_form(dqk: int, dv: int, num_heads: int, dtype: torch.dtype) -> str:
    """The kernel of a flash backward (dq and dk/dv alike): "f32_sm90"
    (csrc/flash_bwd_f32_sm90.cu) for every fp32 call, packed heads or one;
    "sm90" (csrc/flash_bwd_sm90.cu) for bf16 packed heads (num_heads > 1)
    whose q/k and v widths are equal multiples of 64 up to 384, which every
    packed training site of phi 'n', 's' and 'm' is; "single_sm90"
    (csrc/flash_bwd_single_sm90.cu) for bf16 with one head where
    `bwd_single_sm90_plan` has a plan: dark3 of phi 'n', 's' and 'm' (q/k
    32 to 128, v 256 to 1,024), the folded heads (288, 600) and widths
    that share their forms; else "mma_sync", csrc/flash_attn_bwd.cu (bf16:
    dark3 of phi 'l' and 'x', packed heads of 448 and wider, other
    widths)."""
    if dtype == torch.float32:
        return "f32_sm90"
    if (num_heads > 1 and dqk == dv and dqk % SM90_BWD_SLAB == 0
            and 0 < dqk <= SM90_BWD_MAX_WIDTH):
        return "sm90"
    if num_heads == 1:
        try:
            bwd_single_sm90_plan(dqk, dv)
            return "single_sm90"
        except ValueError:
            pass
    return "mma_sync"


def bwd_sm90_smem_bytes(kernel: str, d: int, stages: int) -> int:
    """Dynamic shared memory of a plan, as csrc/flash_bwd_sm90.cu computes
    it: 1024 bytes of alignment slack and 1024 of barriers; dq: Q and dO
    resident (128 rows, or 64 in the split form) and, split, the fp32 P and
    dP tiles the warpgroups trade (16 KB each); dkv: K and V resident (64
    keys) and the fp32 P^T handed over (split: also dP^T, the DK launch's);
    then the ring: `stages` operand tiles of 64 rows by the head's width
    (the split forms: 384, the columns past 320 zero)."""
    slabs = d // SM90_BWD_SLAB
    split = d >= SM90_BWD_SPLIT_FROM
    slab_bytes, xchg = SM90_BWD_SLAB * SM90_BWD_SLAB * 2, 64 * 64 * 4
    if kernel == "dq":
        fixed = 2 * slabs * (1 if split else 2) * slab_bytes + (2 * xchg if split else 0)
    else:
        fixed = 2 * slabs * slab_bytes + (2 if split else 1) * xchg
    tile = (SM90_BWD_MAX_WIDTH // SM90_BWD_SLAB if split else slabs) * slab_bytes
    return 2048 + fixed + stages * tile


def bwd_sm90_plan(d: int) -> dict:
    """Launch plans of csrc/flash_bwd_sm90.cu for heads of width `d` (q/k and
    v alike; a multiple of 64 up to 384): {"dq": plan, "dkv": plan}, each
    with `rows` (query rows a dq block: 128, two warpgroups of 64, or 64 in
    the split form; keys a dk/dv block: 64), `slab` (64), `split` (heads of
    320 and 384: dq's warpgroups share 64 rows and split dQ's columns; dk/dv
    takes two launches, each splitting its columns between the warpgroups),
    `stages` (the most ring stages, one operand tile each, up to 24, that
    fit; at least one query or key tile's two) and `smem_bytes`. The
    library refuses any other plan."""
    if d <= 0 or d % SM90_BWD_SLAB or d > SM90_BWD_MAX_WIDTH:
        raise ValueError(f"the sm90 backward takes head widths that are multiples of "
                         f"{SM90_BWD_SLAB} up to {SM90_BWD_MAX_WIDTH}, got {d}")
    split = int(d >= SM90_BWD_SPLIT_FROM)
    out = {}
    for kernel, rows in (("dq", 64 if split else 128), ("dkv", 64)):
        stages = next(st for st in range(SM90_BWD_MAX_STAGES, 0, -1)
                      if bwd_sm90_smem_bytes(kernel, d, st) <= A.SM90_SMEM_LIMIT)
        if stages < 2:
            raise ValueError(f"no sm90 backward plan fits heads of {d}")
        out[kernel] = {"rows": rows, "slab": SM90_BWD_SLAB, "stages": stages, "split": split,
                       "smem_bytes": bwd_sm90_smem_bytes(kernel, d, stages)}
    return out


# The fp32 Hopper backward (csrc/flash_bwd_f32_sm90.cu): 64-column tiles,
# 16-column score slabs and 16-token chunks of the transposed copies, every
# operand as tf32 hi and lo, streamed through rings of 2-8 stages; dq on
# blocks of 128 query rows (64 a warpgroup, N0 = N1 gradient columns each),
# dk/dv on blocks of 64 keys (dV N0 columns on one warpgroup, dK N1 on the
# other); wider gradients in output passes. The (N0, N1) pairs are those
# the library is built for.
F32_BWD_ROWS = {"dq": 128, "dkv": 64}
F32_BWD_KEYS, F32_BWD_SLAB = 64, 16
F32_BWD_BOX = 64 * 16 * 4  # one of hi, lo of a 64-row slab
# a stage of a slab: dq the 128 rows and the 64 columns, dk/dv the 64 rows
# and the 64 columns, each hi and lo
F32_BWD_SLAB_STAGE = {"dq": 6 * F32_BWD_BOX, "dkv": 4 * F32_BWD_BOX}
F32_BWD_XCHG_BYTES = 64 * 64 * 4  # an fp32 64 x 64 P^T tile handed between the warpgroups
F32_BWD_WIDTHS = {"dq": ((64, 64), (128, 128)), "dkv": ((128, 128), (128, 64))}
F32_BWD_MAX_STAGES = 8
F32_BWD_PLAN_KEYS = ("rows", "keys", "slab", "n0", "n1", "passes", "stages", "smem_bytes")


def bwd_f32_sm90_smem_bytes(kernel: str, n0: int, n1: int, stages: int) -> int:
    """Dynamic shared memory of an f32_sm90 backward plan (as
    csrc/flash_bwd_f32_sm90.cu computes it): 1024 bytes of alignment slack,
    1024 of barriers, then dq: `stages` slab stages of its one ring; dk/dv:
    two P^T buffers and `stages` stages of each warpgroup's ring, a stage
    the larger of a slab stage and a chunk of 16 tokens x n_w rows of a
    transposed copy (hi and lo, 4 bytes an element)."""
    if kernel == "dq":
        return 2048 + stages * F32_BWD_SLAB_STAGE["dq"]
    unit = lambda n_w: max(F32_BWD_SLAB_STAGE["dkv"], n_w * 16 * 4 * 2)
    return 2048 + 2 * F32_BWD_XCHG_BYTES + stages * (unit(n0) + unit(n1))


def _f32_bwd_passes(kernel: str, dqk: int, dv: int, n0: int, n1: int) -> int:
    if kernel == "dq":  # each warpgroup all n0 columns of a pass, on its own rows
        return -(-dqk // n0)
    return max(-(-dv // n0), -(-dqk // n1))  # dV on warpgroup 0, dK on warpgroup 1


def bwd_f32_sm90_plan(dqk: int, dv: int) -> dict:
    """Launch plans of csrc/flash_bwd_f32_sm90.cu for q/k width `dqk` and v
    width `dv` (multiples of 8): {"dq": plan, "dkv": plan}, each with `rows`
    (dq 128, dk/dv 64), `keys` (64 columns a tile), `slab` (16), `n0`, `n1`
    (the gradient columns of warpgroups 0 and 1: of the pairs the library
    is built for, the one whose slower warpgroup does least work, passes x
    (its score columns + its gradient columns), ties to the narrower),
    `passes` (output passes, each recomputing S and dP), `stages` (the
    most, up to 8, that fit) and `smem_bytes`. The library refuses any
    other plan."""
    if dqk <= 0 or dv <= 0 or dqk % A.KERNEL_WIDTH_MULTIPLE or dv % A.KERNEL_WIDTH_MULTIPLE:
        raise ValueError(f"the f32_sm90 backward takes widths that are multiples of "
                         f"{A.KERNEL_WIDTH_MULTIPLE}, got q/k {dqk}, v {dv}")
    s0, s1 = (-(-d // F32_BWD_SLAB) * F32_BWD_SLAB for d in (dqk, dv))
    out = {}
    for kernel in ("dq", "dkv"):
        def cost(pair):
            n0, n1 = pair
            per_pass = s0 + s1 + n0 if kernel == "dq" else max(s0 + n0, s1 + n1)
            return _f32_bwd_passes(kernel, dqk, dv, n0, n1) * per_pass, n0 + n1
        n0, n1 = min(F32_BWD_WIDTHS[kernel], key=cost)
        stages = next(st for st in range(F32_BWD_MAX_STAGES, 1, -1)
                      if bwd_f32_sm90_smem_bytes(kernel, n0, n1, st) <= A.SM90_SMEM_LIMIT)
        out[kernel] = {"rows": F32_BWD_ROWS[kernel], "keys": F32_BWD_KEYS,
                       "slab": F32_BWD_SLAB, "n0": n0, "n1": n1,
                       "passes": _f32_bwd_passes(kernel, dqk, dv, n0, n1), "stages": stages,
                       "smem_bytes": bwd_f32_sm90_smem_bytes(kernel, n0, n1, stages)}
    return out


def _bwd_f32_sm90_lib():
    from transparent_object_detection_tpu_torch.kernels import _build

    lib = _build.load("flash_bwd_f32_sm90")
    if not getattr(lib, "_argtypes_set", False):
        vp, ci, cl, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        lib.flash_bwd_dq_f32_sm90.argtypes = [vp] * 8 + [ci] * 6 + [cl] * 10 + [cf, vp, vp]
        lib.flash_bwd_dq_f32_sm90.restype = ci
        lib.flash_bwd_dkv_f32_sm90.argtypes = [vp] * 9 + [ci] * 6 + [cl] * 12 + [cf, vp, vp]
        lib.flash_bwd_dkv_f32_sm90.restype = ci
        lib._argtypes_set = True
    return lib


def _f32_bwd_launch(kernel: str, q, k, v, do, lse, dcap, outs, scale: float, num_heads: int,
                    widths) -> None:
    """One call of csrc/flash_bwd_f32_sm90.cu (`kernel` "dq" or "dkv": its
    pre-pass, then the kernel) with the plan of `bwd_f32_sm90_plan`.
    Allocates the pre-pass's scratch: hi and lo of q, k, v and dO in their
    row form, and of the kernel's transposed copies (dq: K^T; dk/dv: dO^T
    and Q^T) with the tokens padded to 64. Raises if the launch fails, never
    falls back."""
    b, n, dqk, dv = widths
    plan = bwd_f32_sm90_plan(dqk, dv)[kernel]
    plan_arr = (ctypes.c_int * len(F32_BWD_PLAN_KEYS))(*(plan[key] for key in F32_BWD_PLAN_KEYS))
    n_pad = -(-n // F32_BWD_KEYS) * F32_BWD_KEYS
    h = num_heads
    empty = lambda *shape: torch.empty(shape, dtype=torch.float32, device=q.device)
    scratch = [empty(b, n, w) for w in (h * dqk,) * 4 + (h * dv,) * 4]
    transposed = (dqk,) if kernel == "dq" else (dv, dqk)
    scratch += [empty(b, h, w, n_pad) for w in transposed for _ in range(2)]
    ptrs = (ctypes.c_void_p * len(scratch))(*(t.data_ptr() for t in scratch))
    lib = _bwd_f32_sm90_lib()
    fn = lib.flash_bwd_dq_f32_sm90 if kernel == "dq" else lib.flash_bwd_dkv_f32_sm90
    strides = [s for t in (q, k, v, do, *outs) for s in (t.stride(0), t.stride(1))]
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
             dcap.data_ptr(), *(t.data_ptr() for t in outs), ctypes.cast(ptrs, ctypes.c_void_p),
             b, n, h, dqk, dv, n_pad, *strides, scale, ctypes.cast(plan_arr, ctypes.c_void_p),
             torch.cuda.current_stream(q.device).cuda_stream)
    A._raise_on(err, f"flash_bwd_{kernel}_f32_sm90")


# The one-head Hopper backward (csrc/flash_bwd_single_sm90.cu): blocks of 64
# rows, 64-column slabs (the last one zero-filled past a width that is not a
# multiple of 64), tiles of 64 tokens (128 where the library has the form
# and three ring stages fit), the contraction slabs (q/k's, then v's) split
# between the two consumer warpgroups at `split`, the output slabs in two
# (at most five a warpgroup), dk/dv's v in slices of at most ten slabs, each
# warpgroup its own ring of 2 to 8 stages. The instantiations the library
# is built for, by (output slabs a warpgroup, warpgroup 0 also in v's
# slabs, tile): dq (g, y0, tile), dk/dv (dK's g, dV's g, y0, tile), the
# forms of the training sites (dark3 of phi 'n' and 's' on tiles of 128,
# of phi 'm' on 64; the folded heads of 288 and 600).
SINGLE_BWD_SLAB = 64
SINGLE_BWD_MAX_STAGES = 8
SINGLE_BWD_SLICE_SLABS = 10
SINGLE_BWD_FORMS = {
    "dq": ((1, False, 128), (1, True, 128), (2, True, 64), (3, False, 64), (5, False, 64)),
    "dkv": ((1, 2, False, 128), (1, 4, True, 128), (2, 4, True, 64), (3, 3, False, 64),
            (5, 5, False, 64)),
}
SINGLE_BWD_PLAN_KEYS = ("rows", "slab", "qk_slabs", "v_slabs", "split", "out_slabs", "slices",
                        "slice_slabs", "stages", "tile", "smem_bytes")


def bwd_single_smem_bytes(qk_slabs: int, v_slabs: int, stages: int, tile: int = 64) -> int:
    """Dynamic shared memory of a one-head plan, as
    csrc/flash_bwd_single_sm90.cu computes it: 1024 bytes of alignment
    slack and 2048 of barriers and statistics, the block's resident rows
    (q/k's and v's slabs, 8 KB each), the hand-over between the warpgroups
    (64 x tile fp32), and two rings of `stages` entries (tile rows of one
    64-column slab)."""
    slab = SINGLE_BWD_SLAB * SINGLE_BWD_SLAB * 2
    return (3072 + (qk_slabs + v_slabs) * slab + 64 * tile * 4
            + 2 * stages * tile * SINGLE_BWD_SLAB * 2)


def single_out_slabs(qk_slabs: int) -> int:
    """dQ's or dK's output slabs of warpgroup 0: all of them up to two (then
    warpgroup 1 has none and runs ahead into its next tile's contraction),
    else the larger half."""
    return qk_slabs if qk_slabs <= 2 else -(-qk_slabs // 2)


def single_split(qk_slabs: int, v_slabs: int) -> int:
    """Contraction slabs (q/k's, then v's) that warpgroup 0 of a dq or DK
    block sums: all of q/k's, and half of the rest less what its extra work
    is worth (its elementwise pass, about one slab, and the output slabs it
    has more than warpgroup 1); warpgroup 1 sums the others."""
    g0 = single_out_slabs(qk_slabs)
    g1 = qk_slabs - g0
    return max(qk_slabs, (qk_slabs + v_slabs - 1 - (g0 - g1)) // 2)


def bwd_single_sm90_plan(dqk: int, dv: int) -> dict:
    """Launch plans of csrc/flash_bwd_single_sm90.cu for one head of q/k
    width `dqk` and v width `dv` (multiples of 8, v's slabs at least q/k's):
    {"dq": plan, "dkv": plan}, each with `rows` (64 a block), `slab` (64),
    `qk_slabs` and `v_slabs` (ceil(width / 64)), `split` (the contraction
    slabs, q/k's then v's, that warpgroup 0 sums: `single_split`),
    `out_slabs` (dQ's or dK's slabs of warpgroup 0: `single_out_slabs`, at
    most 5), `slices` and `slice_slabs` (dk/dv: v in ceil(v_slabs / 10)
    slices of equal slabs, a DV block each; dq: 0), `tile` (tokens a
    streamed tile: 128 where the library has that form and three stages a
    ring fit, else 64 where it has that one), `stages` (each ring's: the
    most, up to 8, that fit, at least 2) and `smem_bytes`. Raises
    ValueError where no instantiation or no plan fits; the library refuses
    any other plan."""
    if dqk <= 0 or dv <= 0 or dqk % A.KERNEL_WIDTH_MULTIPLE or dv % A.KERNEL_WIDTH_MULTIPLE:
        raise ValueError(f"the one-head sm90 backward takes widths that are multiples of "
                         f"{A.KERNEL_WIDTH_MULTIPLE}, got q/k {dqk}, v {dv}")
    qs, vs = -(-dqk // SINGLE_BWD_SLAB), -(-dv // SINGLE_BWD_SLAB)
    split, g = single_split(qs, vs), single_out_slabs(qs)
    slices = -(-vs // SINGLE_BWD_SLICE_SLABS)
    slice_slabs = -(-vs // slices)
    y0 = split > qs
    stages_of = lambda tile: next((st for st in range(SINGLE_BWD_MAX_STAGES, 1, -1)
                                   if bwd_single_smem_bytes(qs, vs, st, tile)
                                   <= A.SM90_SMEM_LIMIT), 0)
    forms = {"dq": (g, y0), "dkv": (g, -(-slice_slabs // 2), y0)}
    tiles = {k: next((t for t, least in ((128, 3), (64, 2))
                      if forms[k] + (t,) in SINGLE_BWD_FORMS[k] and stages_of(t) >= least), None)
             for k in forms}
    if vs < qs or None in tiles.values():
        raise ValueError(f"no one-head sm90 backward plan for q/k {dqk}, v {dv}")
    out = {}
    for kernel in ("dq", "dkv"):
        dkv = kernel == "dkv"
        tile = tiles[kernel]
        stages = stages_of(tile)
        out[kernel] = {"rows": SINGLE_BWD_SLAB, "slab": SINGLE_BWD_SLAB, "qk_slabs": qs,
                       "v_slabs": vs, "split": split, "out_slabs": g,
                       "slices": slices if dkv else 0, "slice_slabs": slice_slabs if dkv else 0,
                       "stages": stages, "tile": tile,
                       "smem_bytes": bwd_single_smem_bytes(qs, vs, stages, tile)}
    return out


def _bwd_single_lib():
    from transparent_object_detection_tpu_torch.kernels import _build

    lib = _build.load("flash_bwd_single_sm90")
    if not getattr(lib, "_argtypes_set", False):
        vp, ci, cl, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        lib.flash_bwd_dq_single_sm90.argtypes = [vp] * 7 + [ci] * 4 + [vp] + [cl] * 2 + [
            cf, vp, vp]
        lib.flash_bwd_dq_single_sm90.restype = ci
        lib.flash_bwd_dkv_single_sm90.argtypes = [vp] * 8 + [ci] * 4 + [vp] + [cl] * 4 + [
            cf, vp, vp]
        lib.flash_bwd_dkv_single_sm90.restype = ci
        lib._argtypes_set = True
    return lib


def _bwd_sm90_lib():
    from transparent_object_detection_tpu_torch.kernels import _build

    lib = _build.load("flash_bwd_sm90")
    if not getattr(lib, "_argtypes_set", False):
        vp, ci, cl, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        lib.flash_bwd_dq_sm90.argtypes = [vp] * 7 + [ci] * 4 + [cl] * 10 + [cf, vp, vp]
        lib.flash_bwd_dq_sm90.restype = ci
        lib.flash_bwd_dkv_sm90.argtypes = [vp] * 8 + [ci] * 4 + [cl] * 12 + [cf, vp, vp]
        lib.flash_bwd_dkv_sm90.restype = ci
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


def lse_fwd_form(dqk: int, dv: int, num_heads: int, dtype: torch.dtype) -> str:
    """The kernel of a forward with logsumexp: with one head (dark3, the
    folded heads) `attention.single_fwd_form` ("single_sm90" in bf16, the
    one-head form of csrc/flash_fwd_sm90.cu; "f32_sm90" in fp32); packed
    heads `attention.packed_fwd_form` ("f32_sm90" for fp32; "sm90" for bf16
    widths that are multiples of 64; else "mma_sync", csrc/flash_attn_fwd.cu)."""
    if num_heads == 1:
        return A.single_fwd_form(dqk, dv, dtype)
    return A.packed_fwd_form(dqk, dtype, dv)


def flash_fwd_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                  num_heads: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash forward with logsumexp: -> out (B, N, H*dv), lse (B, N, 1) or
    (B, H, N, 1) fp32. Port of ops/attention_vjp.py::_fwd_lse_kernel
    (flash_fwd_lse, JAX). A CUDA tensor launches the kernel of
    `lse_fwd_form`; a CPU tensor runs `flash_fwd_lse_plain`. `launches`
    counts launches of csrc/flash_attn_fwd.cu, `sm90_launches` those of
    csrc/flash_fwd_sm90.cu on packed heads, `single_launches` those of its
    one-head form, `f32_launches` those of csrc/flash_fwd_f32_sm90.cu."""
    if q.device.type == "cpu":
        return flash_fwd_lse_plain(q, k, v, scale, num_heads)
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_view(name, t, q.dtype)
    b, n, dqk, dv = _widths(q, k, v, num_heads)
    lse = torch.empty(_stat_shape(b, n, num_heads), dtype=torch.float32, device=q.device)
    form = lse_fwd_form(dqk, dv, num_heads, q.dtype)
    if form == "sm90":
        out = A.launch_sm90(q, k, v, num_heads, scale, lse)
        flash_fwd_lse.sm90_launches += 1
        return out, lse
    if form == "single_sm90":
        out = A.launch_single_sm90(q, k, v, scale, lse)
        flash_fwd_lse.single_launches += 1
        return out, lse
    if form == "f32_sm90":
        out = A.launch_f32_sm90(q, k, v, num_heads, scale, lse)
        flash_fwd_lse.f32_launches += 1
        return out, lse
    out = torch.empty((b, n, v.shape[-1]), dtype=v.dtype, device=v.device)
    err = _fwd_lib().flash_fwd_lse(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        b, n, num_heads, dqk, dv, q.stride(0), q.stride(1), k.stride(0), k.stride(1),
        v.stride(0), v.stride(1), scale, torch.cuda.current_stream(q.device).cuda_stream,
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
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    A._raise_on(err, ("flash_bwd dq", "flash_bwd dk", "flash_bwd dv")[mode])


def _sm90_bwd_launch(kernel: str, q, k, v, do, lse, dcap, outs, scale: float,
                     num_heads: int, widths) -> None:
    """One call of csrc/flash_bwd_sm90.cu (`kernel` "dq" or "dkv") with the
    plan of `bwd_sm90_plan`; raises if the launch fails, never falls back."""
    b, n, d, _ = widths
    plan = bwd_sm90_plan(d)[kernel]
    keys = SM90_BWD_PLAN_KEYS
    plan_arr = (ctypes.c_int * len(keys))(*(plan[key] for key in keys))
    lib = _bwd_sm90_lib()
    fn = lib.flash_bwd_dq_sm90 if kernel == "dq" else lib.flash_bwd_dkv_sm90
    strides = [s for t in (q, k, v, do) for s in (t.stride(0), t.stride(1))]
    strides += [s for t in outs for s in (t.stride(0), t.stride(1))]
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
             dcap.data_ptr(), *(t.data_ptr() for t in outs), b, n, num_heads, d, *strides,
             scale, ctypes.cast(plan_arr, ctypes.c_void_p),
             torch.cuda.current_stream(q.device).cuda_stream)
    A._raise_on(err, f"flash_bwd_{kernel}_sm90")


def _single_bwd_launch(kernel: str, q, k, v, do, lse, dcap, outs, scale: float,
                       widths) -> None:
    """One call of csrc/flash_bwd_single_sm90.cu (`kernel` "dq" or "dkv")
    with the plan of `bwd_single_sm90_plan`; raises if the launch fails,
    never falls back."""
    b, n, dqk, dv = widths
    plan = bwd_single_sm90_plan(dqk, dv)[kernel]
    keys = SINGLE_BWD_PLAN_KEYS
    plan_arr = (ctypes.c_int * len(keys))(*(plan[key] for key in keys))
    strides = (ctypes.c_longlong * 8)(*(s for t in (q, k, v, do)
                                        for s in (t.stride(0), t.stride(1))))
    lib = _bwd_single_lib()
    fn = lib.flash_bwd_dq_single_sm90 if kernel == "dq" else lib.flash_bwd_dkv_single_sm90
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
             dcap.data_ptr(), *(t.data_ptr() for t in outs), b, n, dqk, dv,
             ctypes.cast(strides, ctypes.c_void_p),
             *(s for t in outs for s in (t.stride(0), t.stride(1))), scale,
             ctypes.cast(plan_arr, ctypes.c_void_p),
             torch.cuda.current_stream(q.device).cuda_stream)
    A._raise_on(err, f"flash_bwd_{kernel}_single_sm90")


def flash_bwd_dq(q, k, v, do, lse, dcap, scale: float, num_heads: int = 1,
                 dq: Optional[torch.Tensor] = None) -> torch.Tensor:
    """dq of the flash backward, written into `dq` (e.g. a column view of a
    packed gradient) when given. Port of ops/attention_vjp.py::_bwd_dq_kernel
    (JAX). A CUDA tensor launches the kernel of `bwd_form`
    (csrc/flash_bwd_sm90.cu, counted in `sm90_launches`;
    csrc/flash_bwd_single_sm90.cu, in `single_launches`;
    csrc/flash_bwd_f32_sm90.cu, in `f32_launches`; or csrc/flash_attn_bwd.cu,
    in `launches`); a CPU tensor runs `flash_bwd_dq_plain`."""
    if q.device.type == "cpu":
        res = flash_bwd_dq_plain(q, k, v, do, lse, dcap, scale, num_heads)
        return res if dq is None else dq.copy_(res)
    widths = _check_bwd(q, k, v, do, lse, dcap, num_heads)
    dq = _out(dq, q, "dq")
    form = bwd_form(widths[2], widths[3], num_heads, q.dtype)
    if form == "sm90":
        _sm90_bwd_launch("dq", q, k, v, do, lse, dcap, (dq,), scale, num_heads, widths)
        flash_bwd_dq.sm90_launches += 1
    elif form == "single_sm90":
        _single_bwd_launch("dq", q, k, v, do, lse, dcap, (dq,), scale, widths)
        flash_bwd_dq.single_launches += 1
    elif form == "f32_sm90":
        _f32_bwd_launch("dq", q, k, v, do, lse, dcap, (dq,), scale, num_heads, widths)
        flash_bwd_dq.f32_launches += 1
    else:
        _bwd_launch(MODE_DQ, q, k, v, do, lse, dcap, dq, scale, num_heads, widths)
        flash_bwd_dq.launches += 1
    return dq


def flash_bwd_dkv(q, k, v, do, lse, dcap, scale: float, num_heads: int = 1,
                  dk: Optional[torch.Tensor] = None,
                  dv: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """dk and dv of the flash backward (into `dk`/`dv` when given). Port of
    ops/attention_vjp.py::_bwd_dkv_kernel (JAX). A CUDA tensor launches the
    kernel of `bwd_form`: csrc/flash_bwd_sm90.cu (one launch for heads up to
    256, a dv and a dk launch at 320 and 384; counted once in
    `sm90_launches`), csrc/flash_bwd_single_sm90.cu (bf16 one head: dark3
    of phi 'n' to 'm', the folded heads; one launch, `single_launches`),
    csrc/flash_bwd_f32_sm90.cu (every fp32 call, one launch after its
    pre-pass; `f32_launches`) or csrc/flash_attn_bwd.cu, which keeps the
    other bf16 calls (dark3 of phi 'l' and 'x', packed heads of 448 and
    wider, other widths; the dk pass and the dv pass, counted once in
    `launches`); a CPU tensor runs `flash_bwd_dkv_plain`."""
    if q.device.type == "cpu":
        rk, rv = flash_bwd_dkv_plain(q, k, v, do, lse, dcap, scale, num_heads)
        return (rk if dk is None else dk.copy_(rk)), (rv if dv is None else dv.copy_(rv))
    widths = _check_bwd(q, k, v, do, lse, dcap, num_heads)
    dk, dv = _out(dk, k, "dk"), _out(dv, v, "dv")
    form = bwd_form(widths[2], widths[3], num_heads, q.dtype)
    if form == "sm90":
        _sm90_bwd_launch("dkv", q, k, v, do, lse, dcap, (dk, dv), scale, num_heads, widths)
        flash_bwd_dkv.sm90_launches += 1
    elif form == "single_sm90":
        _single_bwd_launch("dkv", q, k, v, do, lse, dcap, (dk, dv), scale, widths)
        flash_bwd_dkv.single_launches += 1
    elif form == "f32_sm90":
        _f32_bwd_launch("dkv", q, k, v, do, lse, dcap, (dk, dv), scale, num_heads, widths)
        flash_bwd_dkv.f32_launches += 1
    else:
        _bwd_launch(MODE_DK, q, k, v, do, lse, dcap, dk, scale, num_heads, widths)
        _bwd_launch(MODE_DV, q, k, v, do, lse, dcap, dv, scale, num_heads, widths)
        flash_bwd_dkv.launches += 1
    return dk, dv


def reset_launch_counts() -> None:
    for fn in (flash_fwd_lse, flash_bwd_dq, flash_bwd_dkv):
        fn.launches = fn.sm90_launches = fn.single_launches = fn.f32_launches = 0


reset_launch_counts()


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
