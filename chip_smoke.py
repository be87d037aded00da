#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

1. Builds every kernel in transparent_object_detection_tpu_torch/csrc/ with
   nvcc (all eleven sources at once) and prints the card's name and power
   limit.
2. Kernel phase: holds each flash-attention kernel against its plain PyTorch
   version on the card, in bf16, at the shapes the phi='s' 640x640 serving
   forward gives it (batch 2) and at a ragged N, with near-flat (score std 1)
   and peaked (score std 4) inputs. An element passes when
   |kernel - plain| <= RTOL * |plain| + ATOL_OF_MAX * max|plain|, a bar set
   from the output's own scale; the same bar must reject the plain version
   with a planted fault (one kv tile of 64 keys left out, or the softmax
   scale 2% off), else the check would be blind to such a kernel. The
   packed sites run csrc/flash_fwd_sm90.cu (TMA ring, wgmma): each input
   twice, for the same bits, and with the faults its ring can commit (a key
   tile read twice and its neighbour never; on a ragged N, with scores
   shifted well below 0, the zero-filled keys past N scored 0), and at
   widths off the routed grid (64, 192, 320, 448 on the sm90 kernel; 72 on
   the mma_sync template, which the rule keeps for widths that are not
   multiples of 64), serving and lse forms; and the backward at the same
   widths on the kernels `bwd_form` names (two heads of 64, 192 and 320 on
   csrc/flash_bwd_sm90.cu, twice for the same bits; 448 and 72 on the
   template), within the gradient bar, every planted fault of phase 8
   rejected. Times kernel (the packed sites at batch 2 and batch 1), plain
   version, and as a yardstick only F.scaled_dot_product_attention (which
   the port never calls).
3. Slice phase: builds FocusModel at phi='s' 640x640 (bf16, seeded random
   weights, dark3 gamma 0.5 so the attention output reaches the detections,
   class biases set so that about CANDIDATES_PER_IMAGE anchors an image pass
   the 0.5 confidence), runs Predictor.detect_raw_batch on 4 non-square
   uint8 images with the launch counts reset just before and read just
   after. Compares `decoded` and the detection sets against the same model
   with the plain attention versions, and reads the same differences for
   the plain versions with each planted fault: the limits lie between the
   two readings. Times batch-1 latency (and its NMS share) and batch-32
   throughput, and profiles one batch-32 forward by kernel class.
4. int8 kernel phase: quant_rows, qmm and flash_mha_int8 against their
   plain versions on synthetic inputs at the int8 path's shapes (batch 2,
   and batch 32's split qkv and LN-handoff shapes), with the int8 bars
   (payloads equal but for +-1 on a tiny share, scales, values) and planted
   faults each bar must reject: a K slab of 32 dropped and a halved
   quant_out group width (qmm; every qmm runs csrc/qmm_sm90.cu, int8
   wgmma fed by a TMA ring, twice for the same bits, and must also reject
   the faults of its design: a 128-byte K slab read twice and its
   neighbour never, one dropped, a group requantized with its neighbour's
   ratio, the second consumer warpgroup's rows unwritten, the last column
   tile of the plan's width shifted by one), p rounded against a running
   64-key max and
   k/v scales per 64 keys (flash_mha_int8). Every phi='s' int8 attention
   site runs csrc/flash_int8_sm90.cu (int8 wgmma fed by a TMA ring; its
   launches counted in each entry point's `sm90_launches`): each case
   launches twice for the same bits and must also reject the faults of its
   ring and layout (a key tile read twice and its neighbour never, a tail
   tile's next-block keys left unmasked in 8 key blocks of 800, V's key
   order not matched to P's fragments: the kernel launched on V in its
   natural key order).
5. int8 slice phase: the same weights as ModelConfig(int8_dense=True,
   int8_attn=True) through Predictor.detect_raw_batch with every count
   reset before and read after; `decoded` and detection sets against the
   same model on plain versions (limits between the sound reading and a
   planted fault's); every launch of one batch-2 forward against its plain
   version, timed beside its bound and a library yardstick (qmm: each
   launch twice for the same bits, its GEMM and row pass apart, beside
   torch._int_mm alone and with the epilogue, on zero-padded copies where
   K or N is not a multiple of 8); launches per forward at batch 1 and 32;
   timings beside the bf16 run's; a profile.
6. Variant kernel phase: flash_mha_int8_qout, flash_int8_handoff (int8 and
   bf16 output; q scale tables of one group a row and of groups of 512
   columns) and quant_rows(qmax=7) with the w4a4 qmm, against their plain
   versions at the neck's shapes (batch 2) and a 4-key-block case, score
   std 1 and 4, with the int8 bars and planted faults each must reject (a
   q scale from the wrong head, the k/v requantize ratio dropped, one
   output scale a row instead of a (row, head), p rounded against a
   running 64-key max, qmax 127 in place of 7, a K slab dropped), the
   sm90 kernel's outputs twice for the same bits; timed at batch 2 and 1
   beside bound (three int8 products; two beside it), plain version and
   bf16 SDPA.
7. Variant slice: the int8 model's weights under configuration A
   (attn_handoff + w4a4_mlp1) and B (attn_qout) through
   Predictor.detect_raw_batch at batch 32 and 1 with every count reset
   before and read after, the counts asserted; `decoded` and detection sets
   against the same configuration on plain versions (limits a planted
   fault breaks); every launch of a batch-2 forward against its plain
   version, timed; timings beside the bf16 and default int8 runs; a
   profile.
8. Training kernel phase: flash_fwd_lse (out and lse), flash_bwd_dq and
   flash_bwd_dkv against their plain versions at the phi='s' training
   path's shapes (batch 2) and a ragged N, near-flat and peaked inputs, with
   the kernel bar plus a norm bar on the gradients; planted faults each bar
   must reject (a kv tile dropped, the scale 2% off, a query tile unwritten;
   a key tile skipped in the dq loop, a query tile skipped in the dk/dv
   loop, the -D term dropped, lse off by 0.01, the scale missing from dS;
   at the packed sites, which run csrc/flash_bwd_sm90.cu, and at dark3,
   which runs csrc/flash_bwd_single_sm90.cu, also a key tile read twice in
   dq, a query tile read twice in dk/dv, each with its neighbour never
   read, and dS^T formed with the previous query tile's P^T; at dark3 also
   one v slab left out of dP^T and a dV column slice built from another
   slice's dO columns); two runs of the backward must give the same bits.
   Times kernel, plain version and SDPA forward / backward.
9. Training slice: make_train_step on FocusModel phi='s' 640x640 bf16
   (SGD nesterov, EMA), synthetic batches like the JAX bench_train.py's. One
   batch-2 step with the launch counts reset before and read after
   (fwd-lse 3 sm90 + 1, dq and dk/dv 3 sm90 + 1 single_sm90 each, no
   serving kernel; every launch of the one-head backward again for the
   same bits),
   held against the same step
   on the plain versions from the same weights (gradients, parameters, BN
   statistics, EMA, losses), and the plain step with planted faults; then
   timed steps at batch 16 (launches per step asserted) and a profile.
10. Scale kernel phase: rows 1-8 at every attention site and int8 TEB
   projection of phi 'n', 'm', 'l' and 'x' 640x640 (the widths and key
   blocks the JAX dispatch gives them: folded heads of 283 and 599, heads
   of 128 to 3,584, dark3 q/k 32 to 512 and v 256 to 4,096, key blocks of
   320 to 6,400; qmm K = 849 and 4,792 and one quant_out scale a row where
   JAX takes its reference route), at the 480x576 input (N = 4,320, key
   blocks of 4,320 and 1,440) and in fp32, each against its plain version
   with the bars above; each planted fault (those above, a q/k slab of the
   width loop dropped, the tail key tile dropped, an int8 output quantized
   per 256-column slice or, on the sm90 kernel, per warpgroup half, the K
   tail of qmm dropped; and at the sm90 kernel's int8 sites its ring and
   layout faults, each launch twice for the same bits) rejected on some
   input spread. Every fp32 flash site (phi='m' h2, h4, dark3 and the
   folded h1 of 600; phi='n' h2, dark3 and the folded h1 of 288) runs
   csrc/flash_fwd_f32_sm90.cu (3xTF32 wgmma fed by a TMA ring, after a
   pre-pass): each launch twice for the same bits, and the faults of its
   ring, split and layout rejected on some spread too (a key tile read
   twice and its neighbour never; the low parts dropped from S, or from
   P.V; V^T's keys left in natural order, not P's fragment order).
11. phi='m' 640x640 slice at full width (1.354 B parameters, seeded random
   weights): bf16, int8, configurations A and B through
   Predictor.detect_raw_batch at batch 32 and 1 with every count reset
   before and read after, asserted against the route table
   (`expected_launches`); `decoded` and the detection sets against the same
   configuration on plain versions under the limits above (which must
   reject their planted fault); every launch of a batch-2 forward against
   its plain version, timed beside bound, plain and library; batch-1
   latency, batch-32 throughput, a profile. Then one fp32 forward at batch
   2, counted (the f32_sm90 counters), against plain, every fp32 flash
   launch against its plain version, twice for the same bits, and timed
   beside its bound (three tf32 products), plain and SDPA.
12. phi='n' slice: bf16 and int8 at batch 2, counted, against plain; one
   fp32 int8 forward at batch 2, counted, against plain and timed (its
   fp32 flash launches, the folded h1, as in 11).
13. Serve matrix: phi 'n', 's', 'm' in bf16 and fp32 compute, each in
   bf16, int8, A and B: one counted batch-1 detection each, launches
   asserted against the route table.
14. Train scale kernel phase: rows 9-11 (flash_fwd_lse, flash_bwd_dq,
   flash_bwd_dkv) at every training site of phi 'n', 'm', 'l' and 'x'
   640x640 (packed heads of 128 to 1,536 and 3,584, dark3 q/k 32 to 512 and
   v 256 to 4,096, folded heads of 283 and 599 as the fold copy pads them),
   at 480x576 (N = 4,320) and in fp32, batch 2, near-flat and peaked
   inputs, with the bars of phase 8 (fp32: 1e-4) and a bit-identical
   forward and backward (packed bf16 heads of 128 to 384 on
   csrc/flash_bwd_sm90.cu; every fp32 forward on csrc/flash_fwd_f32_sm90.cu,
   with its faults as in 10 and lse written from the running max of the
   tile before the last; every fp32 backward on csrc/flash_bwd_f32_sm90.cu,
   its f32 counters asserted at every site, with the sm90 backward's ring
   and hand-over faults and its own: the low parts dropped from dS.K, dS^T.Q
   or P^T.dO, each transposed copy's token order undone, lse or D read one
   row off; every bf16 one-head site of phi 'n' and 'm' (dark3, the folded
   288 and 600) on csrc/flash_bwd_single_sm90.cu, with the ring and
   hand-over faults and its own: one v slab left out of dP^T, a dV column
   slice built from another slice's dO columns, the zero-filled columns
   past 288 or 600 (or dark3's q/k of 32) made nonzero);
   the phi='s' faults (with the sm90 kernels' own where they run) and those
   of the width loop (a q/k slab left out of S, a v/dO slab left out of dP,
   the last dv pass unwritten, the tail key tile left out) each rejected on
   some input spread; phi='m' (bf16), phi='n' (fp32) and phi='n' bf16's
   one-head sites timed beside bound, plain and SDPA.
   Then the folded route through attention(..., train=True) at phi 'n' and
   'm' h1 against plain, and a padded fold column leaking into dq rejected.
15. phi='m' 640x640 training at full width with remat (1.354 B parameters):
   the counted batch-2 step (forward 7 launches: the neck's three rerun in
   the recompute), against the same step on plain versions within the
   phi='s' limits, every launch against its plain version; timed steps at
   batch 16 if it fits on the card, else 8 (the choice printed), peak
   memory and step time with and without remat at that batch, a profile.
16. phi='n' training, bf16 and fp32 compute: a counted batch-2 step each
   against plain within the same limits (the planted faults' readings
   printed), every launch against its plain version (the fp32 kernels'
   twice for the same bits).
   The sm90 kernel's sites everywhere above run twice for the same bits and
   hold its ring's faults.
17. Prints each phase's seconds and the smoke's total time, the card's name
   and power limit, a JSON line of the kernels (the phi='s' entries: row 1
   on the sm90 kernel, rows 2-11 with rows 9-11's single-head site, rows
   3-5 on csrc/flash_int8_sm90.cu, then rows 9-11's packed sites on the
   sm90 kernels; then the phi='m' and fp32 forms, rows 3-5 split by
   kernel: the sm90 one's sites and the mma_sync template's (dark3), rows
   9-11 at phi='m' (split likewise: rows 10 and 11 at dark3 and the
   folded h1 under csrc/flash_bwd_single_sm90.cu, each site's time, bound,
   plain and SDPA backward apart in `sites`), rows 10 and 11 at the one-head
   sites of phi='n', and in fp32 last; the fp32 forms of
   rows 1, 2 and 9 under csrc/flash_fwd_f32_sm90.cu and of rows 10 and 11
   under csrc/flash_bwd_f32_sm90.cu, their bound three tf32 products at 495
   TFLOP/s), then {"ok": true,
   "device": ...} last.
   Every int8 attention launch of a counted forward is timed at batch 2
   and 1 beside its bound (three int8 products, and two), plain version
   and bf16 SDPA.

Any failed check exits non-zero before the last line. TF32 is off for
matmuls and convolutions wherever numbers are compared.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import subprocess
import sys
import time

PEAK_BF16_FLOPS = 989e12  # H100 SXM data sheet, dense bf16
PEAK_BYTES = 3.35e12      # H100 SXM HBM3
SEED = 0
# Kernel bar, per element: one bf16 ulp of a value is at most 2^-7 = 7.8e-3
# of it, and kernel and plain version round p to bf16 against the running
# maxima of different kv tilings. On an H100 the kernels read 0.22-0.33 of
# it and the planted faults 1.37-66 times it (PERF.md).
RTOL, ATOL_OF_MAX = 1e-2, 1e-2
SCORE_STDS = (1.0, 4.0)  # std of the softmax logits: near flat, and peaked
# Slice limits on `decoded` with kernels against plain versions, between the
# sound reading (0.128 px, 7.6e-5) and that of the planted fault in
# SLICE_REJECTS (0.367 px, 2.6e-3) on an H100 (PERF.md). The subtle faults
# move `decoded` no more than bf16 rounding does; the kernel bar is what
# sees them.
BOX_LIMIT_PX = 0.25
SCORE_LIMIT = 5e-4
SLICE_REJECTS = ("query_tile_unwritten",)
CANDIDATES_PER_IMAGE = 50


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def timed_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def bar_used(out, ref) -> float:
    """Largest |out - ref| / (RTOL * |ref| + ATOL_OF_MAX * max|ref|); an
    output passes at <= 1."""
    diff = (out.float() - ref.float()).abs()
    mag = ref.float().abs()
    return float((diff / (RTOL * mag + ATOL_OF_MAX * mag.max())).max())


def _kv_tile_dropped(attend):
    def faulty(q, k, v, scale, block_k=1024):
        import torch

        keep = torch.ones(k.shape[-2], dtype=torch.bool, device=k.device)
        keep[64:128] = False
        return attend(q, k[..., keep, :], v[..., keep, :], scale, block_k)
    return faulty


def _scale_off(attend):
    return lambda q, k, v, scale, block_k=1024: attend(q, k, v, scale * 1.02, block_k)


def _query_tile_unwritten(attend):
    def faulty(q, k, v, scale, block_k=1024):
        out = attend(q, k, v, scale, block_k)
        out[..., 64:128, :] = 0
        return out
    return faulty


PLANTED_FAULTS = {"kv_tile_dropped": _kv_tile_dropped, "softmax_scale_x1.02": _scale_off,
                  "query_tile_unwritten": _query_tile_unwritten}


def _qk_slab_dropped(attend):
    """The width loop skipping one q/k slab: columns 128..255 of wide heads,
    the upper half of heads of 128 columns or fewer."""
    def faulty(q, k, v, scale, block_k=1024):
        d = q.shape[-1]
        lo, hi = (128, 256) if d > 128 else (d // 2, d)
        q, k = q.clone(), k.clone()
        q[..., lo:hi] = 0
        k[..., lo:hi] = 0
        return attend(q, k, v, scale, block_k)
    return faulty


def _tail_key_tile_dropped(attend):
    """The last key tile skipped: the last 32 keys where N is an odd
    multiple of 32, else the last 64."""
    def faulty(q, k, v, scale, block_k=1024):
        n = k.shape[-2]
        cut = n - (32 if n % 64 else 64)
        return attend(q, k[..., :cut, :], v[..., :cut, :], scale, block_k)
    return faulty


# faults of the width loop and the key tail, held in the scale kernel phase
SCALE_FAULTS = {"qk_slab_dropped": _qk_slab_dropped,
                "tail_key_tile_dropped": _tail_key_tile_dropped}


def _pad_keys(t, tile=64):
    """t with zero rows appended on its key axis (-2) to a multiple of `tile`."""
    import torch

    pad = -t.shape[-2] % tile
    return torch.nn.functional.pad(t, (0, 0, 0, pad)) if pad else t


def _keys_past_n_scored_zero(attend):
    """The TMA zero-fill trap of csrc/flash_fwd_sm90.cu: the keys past N up
    to the next 64-key tile read as zeros and scored 0 instead of -inf. Only
    a ragged N shows it, and only where a row's own scores lie well below 0
    (SHIFTED_SPREAD)."""
    return lambda q, k, v, scale, block_k=1024: attend(q, _pad_keys(k), _pad_keys(v), scale,
                                                       block_k)


def _tile_twice(t, lo=64, hi=128):
    """t with key tile [hi, 2 hi - lo) replaced by tile [lo, hi): a ring stage
    reused one tile early, the tile read twice and its neighbour never."""
    t = t.clone()
    t[..., hi:2 * hi - lo, :] = t[..., lo:hi, :]
    return t


def _key_tile_used_twice(attend):
    return lambda q, k, v, scale, block_k=1024: attend(q, _tile_twice(k), _tile_twice(v), scale,
                                                       block_k)


# faults the TMA ring of the sm90 kernel can commit
RING_FAULTS = {"keys_past_n_scored_zero": _keys_past_n_scored_zero,
               "key_tile_used_twice": _key_tile_used_twice}
# Input spread that shows the zero-fill trap: score std 1 around a mean of
# -8 (natural log), so that one key scored 0 outweighs e^8 of the row's own.
# Held only against that fault: a uniform shift cancels in the softmax.
SHIFTED_SPREAD = (1.0, -8.0)


def _score_shift(q, k, scale, mean, d):
    """q + a and k - a (a = sqrt(-mean / (scale * d)) on every column), which
    moves every score scale * q.k of heads `d` wide by `mean`, cross terms
    aside; q, k (..., heads * d) in place."""
    a = (-mean / (scale * d)) ** 0.5
    q.add_(a)
    k.sub_(a)


def _tf32(t):
    """t in fp32 with the 13 low mantissa bits cleared: the tf32 value the
    tensor core multiplies (a copy, contiguous)."""
    import torch

    return (t.float().contiguous().view(torch.int32) & -8192).view(torch.float32)


def _online_softmax_pv_tf32(q, k, v, scale, block_k=1024):
    """attention._online_softmax with P.V taken as one tf32 product (p and v
    truncated, l summed from the full p): csrc/flash_fwd_f32_sm90.cu with
    the low parts dropped from P.V. -> (out, lse)"""
    import torch

    from transparent_object_detection_tpu_torch.ops import attention as A

    s_scale = scale * A.LOG2E
    qf = q.float()
    m = torch.full(q.shape[:-1] + (1,), -1e30, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(q.shape[:-1] + (v.shape[-1],), dtype=torch.float32, device=q.device)
    for j in range(0, k.shape[-2], block_k):
        s = torch.matmul(qf, k[..., j:j + block_k, :].float().transpose(-1, -2)) * s_scale
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp2(s - m_new)
        corr = torch.exp2(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.matmul(_tf32(p), _tf32(v[..., j:j + block_k, :]))
        m = m_new
    return (acc * (1.0 / l)).to(v.dtype), (m + torch.log2(l)) * A.LN2


# The pre-pass of csrc/flash_fwd_f32_sm90.cu stores each group of 8 keys of
# V^T in the order [0, 2, 4, 6, 1, 3, 5, 7], P's fragment order; with V^T
# left in natural order the kernel would weigh key j's p against the v of
# key 8 (j // 8) + V_KEY_ORDER_INVERSE[j % 8].
V_KEY_ORDER_INVERSE = (0, 4, 1, 5, 2, 6, 3, 7)


def _v_key_order_undone_of(v):
    """v (keys on axis -2) as that kernel would meet it (keys past N zero)."""
    import torch

    n = v.shape[-2]
    pad = -n % 8
    vp = torch.nn.functional.pad(v, (0, 0, 0, pad)) if pad else v
    idx = torch.arange(n + pad, device=v.device)
    idx = idx // 8 * 8 + torch.tensor(V_KEY_ORDER_INVERSE, device=v.device)[idx % 8]
    return vp[..., idx, :][..., :n, :]


def _s_lo_dropped(attend):
    """S = q.k^T as one tf32 product (q and k truncated)."""
    return lambda q, k, v, scale, block_k=1024: attend(_tf32(q), _tf32(k), v, scale, block_k)


def _pv_lo_dropped(attend):
    return lambda q, k, v, scale, block_k=1024: _online_softmax_pv_tf32(q, k, v, scale,
                                                                        block_k)[0]


def _v_key_order_undone(attend):
    return lambda q, k, v, scale, block_k=1024: attend(q, k, _v_key_order_undone_of(v), scale,
                                                       block_k)


# faults of the fp32 Hopper kernel's split and layout (on top of RING_FAULTS)
F32_FAULTS = {"s_lo_terms_dropped": _s_lo_dropped, "pv_lo_terms_dropped": _pv_lo_dropped,
              "v_key_order_undone": _v_key_order_undone}


@contextlib.contextmanager
def planted(fault: str):
    """The plain attention versions with a planted fault: what a kernel that
    made that mistake would return."""
    from transparent_object_detection_tpu_torch.ops import attention as A

    real = A._online_softmax_attention
    A._online_softmax_attention = {**PLANTED_FAULTS, **SCALE_FAULTS, **RING_FAULTS,
                                   **F32_FAULTS}[fault](real)
    try:
        yield
    finally:
        A._online_softmax_attention = real


def hold_against_plain(kernel, plain, what: str, faults_must_fail: bool = True,
                       faults=tuple(PLANTED_FAULTS), bar=None, twice: bool = False) -> dict:
    """Kernel output against its plain version, and the plain version with
    each planted fault in `faults` against the same bar (by default the
    kernel bar above; which, on synthetic inputs, must reject every fault
    when `faults_must_fail`). With `twice`, a second launch must give the
    same bits (a missing wgmma fence or a barrier phase flipped once too
    often is right on most runs only)."""
    import torch

    bar = bar or bar_used
    out, ref = kernel(), plain()
    again = kernel() if twice else out
    torch.cuda.synchronize()
    check(torch.equal(out, again), f"{what}: two launches gave different bits")
    check(bool(torch.isfinite(out.float()).all()), f"{what}: non-finite output")
    diff = float((out.float() - ref.float()).abs().max())
    ref_max = float(ref.float().abs().max())
    reading = {"max_abs_err": diff, "max_rel_err": diff / ref_max, "ref_max_abs": ref_max,
               "bar_used": bar(out, ref), "bitwise_repeat": twice, "fault_bar_used": {}}
    for fault in faults:
        with planted(fault):
            reading["fault_bar_used"][fault] = bar(plain(), ref)
    print(json.dumps({"check": what, **reading}), flush=True)
    check(reading["bar_used"] <= 1.0,
          f"{what}: kernel off by {reading['bar_used']:.3g}x its bar (max abs {diff})")
    for fault, used in reading["fault_bar_used"].items():
        check(used > 1.0 or not faults_must_fail,
              f"{what}: the bar does not reject the planted fault {fault} ({used:.3g}x the bar)")
    return reading


def _packed_timing(qkv, h, scale, plain: bool = True) -> dict:
    """ms of flash_mha_packed (its rule's kernel), of the plain version and
    of SDPA (the yardstick, never called by the port), beside the bound."""
    import torch.nn.functional as F

    from transparent_object_detection_tpu_torch.ops import attention as A

    b, n, c3 = qkv.shape
    c = c3 // 3
    q, k, v = (A._heads_first(t, h).contiguous() for t in qkv.chunk(3, dim=-1))
    bnd, by = bound_ms(2.0 * b * n * n * (c + c), 2.0 * (b * n * 3 * c + b * n * c))
    row = dict(ms=timed_ms(lambda: A.flash_mha_packed(qkv, h, scale), 20),
               library_ms=timed_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=scale),
                                   20),
               bound_ms=bnd, bound_by=by)
    if plain:
        row["plain_ms"] = timed_ms(lambda: A.flash_mha_packed_plain(qkv, h, scale), 3, 1)
    return row


# (B, N, C, heads) of packed widths no route reaches, each on a ragged N: the
# sm90 kernel's plans that no routed site takes (v in one slice of 64 on
# 128-key tiles, one slice of 192; the warpgroup split with its second half
# running past v at 320 and 448), and heads of 72, which the rule keeps on
# the mma_sync template
OFF_GRID = ((1, 1300, 128, 2), (1, 1100, 384, 2), (1, 1100, 640, 2), (1, 1300, 896, 2),
            (1, 1100, 144, 2))


def off_grid_phase(randn, qk_std) -> None:
    """flash_mha_packed and flash_fwd_lse at the OFF_GRID widths against
    their plain versions: the kernel bar, lse within LSE_ATOL, and (the
    sm90 kernel) a second launch's bits; each launch counted on the kernel
    the rule names. Then the backward there (`off_grid_backward`)."""
    import torch

    from transparent_object_detection_tpu_torch.ops import attention as A
    from transparent_object_detection_tpu_torch.ops import attention_vjp as V

    for b, n, c, h in OFF_GRID:
        d, scale = c // h, (c // h) ** -0.5
        form = A.packed_fwd_form(d, torch.bfloat16)
        check(form == ("mma_sync" if d % 64 else "sm90"), f"heads of {d}: form {form}")
        for score_std in SCORE_STDS:
            qkv = randn(b, n, 3 * c)
            qkv[..., :2 * c] *= qk_std(score_std, scale, d)
            qkv = qkv.to(torch.bfloat16)
            q, k, v = qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:]
            what = f"off grid {h} x {d} n={n} score_std {score_std} ({form})"
            A.reset_launch_counts()
            V.reset_launch_counts()
            r = hold_against_plain(lambda: A.flash_mha_packed(qkv, h, scale),
                                   lambda: A.flash_mha_packed_plain(qkv, h, scale),
                                   f"flash_mha_packed {what}", faults=(), twice=form == "sm90")
            out, lse = V.flash_fwd_lse(q, k, v, scale, h)
            out2, lse2 = V.flash_fwd_lse(q, k, v, scale, h)
            pout, plse = V.flash_fwd_lse_plain(q, k, v, scale, h)
            torch.cuda.synchronize()
            sm90 = form == "sm90"
            counts = (A.flash_mha_packed.sm90_launches if sm90 else A.flash_mha_packed.launches,
                      V.flash_fwd_lse.sm90_launches if sm90 else V.flash_fwd_lse.launches)
            check(counts == (2 if sm90 else 1, 2), f"{what}: launches {counts} on {form}")
            check(not sm90 or (torch.equal(out, out2) and torch.equal(lse, lse2)),
                  f"flash_fwd_lse {what}: two runs gave different bits")
            lse_err = float((lse - plse).abs().max())
            used = bar_used(out, pout)
            check(used <= 1.0 and lse_err <= LSE_ATOL,
                  f"flash_fwd_lse {what}: {used:.3g}x the bar, lse {lse_err:.3g}")
            print(json.dumps({"off_grid": what, "bar_used": r["bar_used"],
                              "lse_bar_used": used, "lse_max_abs_err": lse_err}), flush=True)
    off_grid_backward(randn, qk_std)


def off_grid_backward(randn, qk_std) -> None:
    """flash_bwd_dq and flash_bwd_dkv at the OFF_GRID widths, each launch
    counted on the kernel `bwd_form` names (two heads of 64, 192 and 320 on
    the sm90 kernels, 448 and 72 on the template): against their plain
    versions within the gradient bar, twice for the same bits, each planted
    fault of `_bwd_faults` (with the sm90 kernels' own) rejected on some
    input spread."""
    import torch

    from transparent_object_detection_tpu_torch.ops import attention_vjp as V

    for b, n, c, h in OFF_GRID:
        d, scale = c // h, (c // h) ** -0.5
        form = V.bwd_form(d, d, h, torch.bfloat16)
        check(form == ("sm90" if d % 64 == 0 and d <= 384 else "mma_sync"),
              f"backward, heads of {d}: form {form}")
        sm90 = form == "sm90"
        rejected = {}
        for score_std in SCORE_STDS:
            qkv = randn(b, n, 3 * c)
            qkv[..., :2 * c] *= qk_std(score_std, scale, d)
            qkv = qkv.to(torch.bfloat16)
            q, k, v = qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:]
            do = randn(b, n, c).to(torch.bfloat16)
            pout, plse = V.flash_fwd_lse_plain(q, k, v, scale, h)
            args = (q, k, v, do, plse, V.compute_dcap(pout, do, h), scale, h)
            what = f"off grid {h} x {d} n={n} score_std {score_std} ({form} backward)"
            V.reset_launch_counts()
            got = {"dq": V.flash_bwd_dq(*args)}
            got["dk"], got["dv"] = V.flash_bwd_dkv(*args)
            again = {"dq": V.flash_bwd_dq(*args)}
            again["dk"], again["dv"] = V.flash_bwd_dkv(*args)
            torch.cuda.synchronize()
            counts = ((V.flash_bwd_dq.sm90_launches, V.flash_bwd_dkv.sm90_launches) if sm90
                      else (V.flash_bwd_dq.launches, V.flash_bwd_dkv.launches))
            check(counts == (2, 2), f"{what}: launches {counts}")
            check(all(torch.equal(got[g], again[g]) for g in got),
                  f"{what}: two runs gave different bits")
            ref = {"dq": V.flash_bwd_dq_plain(*args)}
            ref["dk"], ref["dv"] = V.flash_bwd_dkv_plain(*args)
            reading = {g: grad_reading(got[g], ref[g]) for g in got}
            for g, r in reading.items():
                check(r["bar_used"] <= 1.0, f"{what} {g}: {r}")
            for fault, fg in _bwd_faults(V, *args).items():
                used = max(grad_reading(fg[g], ref[g])["bar_used"] for g in fg)
                rejected[fault] = max(rejected.get(fault, 0.0), used)
            print(json.dumps({"off_grid_backward": what,
                              **{g: r["bar_used"] for g, r in reading.items()}}), flush=True)
        print(json.dumps({"off_grid_backward_faults": f"{h} x {d}", "rejected_by": rejected}),
              flush=True)
        for fault, used in rejected.items():
            check(used > 1.0, f"backward {h} x {d}: the bar rejects {fault} on no spread")


def kernel_phase():
    import torch
    import torch.nn.functional as F

    from transparent_object_detection_tpu_torch.ops import attention as A

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    randn = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    # std of q and k for softmax logits of std `score_std`: scale^2 * d * std^4
    qk_std = lambda score_std, scale, d: (score_std / (scale * d ** 0.5)) ** 0.5
    mha_rows, single_rows = [], []

    # packed multi-head: (B, N, C, heads); neck h1, h2, h4 at 640x640, then
    # ragged. The sm90 kernel (the form every bf16 packed site takes) twice
    # on every input, with the ring's faults; the zero-fill trap on a ragged
    # N with scores shifted well below 0
    for name, (b, n, c, h) in (("h1", (2, 1600, 2048, 8)), ("h2", (2, 6400, 1536, 6)),
                               ("h4", (2, 1600, 1536, 6)), ("ragged", (2, 3600, 1536, 6))):
        scale = (c // h) ** -0.5
        check(A.packed_fwd_form(c // h, torch.bfloat16) == "sm90",
              f"flash_mha_packed {name}: heads of {c // h} do not take the sm90 kernel")
        readings = []
        spreads = [(std, 0.0) for std in SCORE_STDS] + ([SHIFTED_SPREAD] if n % 64 else [])
        for score_std, mean in spreads:
            qkv = randn(b, n, 3 * c)
            qkv[..., :2 * c] *= qk_std(score_std, scale, c // h)
            if mean:
                _score_shift(qkv[..., :c], qkv[..., c:2 * c], scale, mean, c // h)
            qkv = qkv.to(torch.bfloat16)
            faults = (("keys_past_n_scored_zero",) if mean
                      else (*PLANTED_FAULTS, "key_tile_used_twice"))
            readings.append({"score_std": score_std, "score_mean": mean, **hold_against_plain(
                lambda: A.flash_mha_packed(qkv, h, scale),
                lambda: A.flash_mha_packed_plain(qkv, h, scale),
                f"flash_mha_packed sm90 {name} score_std {score_std} mean {mean}",
                faults=faults, twice=True)})
        mha_rows.append(dict(node=name, b=b, n=n, c=c, heads=h, form="sm90", readings=readings,
                             **_packed_timing(qkv, h, scale)))
        if name != "ragged":  # batch 1: the latency path's grid
            mha_rows[-1]["batch1"] = _packed_timing(qkv[:1].contiguous(), h, scale, plain=False)
        print(json.dumps({"kernel": "flash_mha_packed", **mha_rows[-1]}), flush=True)
    off_grid_phase(randn, qk_std)

    # single head, dq = C/8, dv = C, scale 1.0: dark3 at 640x640, then ragged
    for name, (b, n, dq, dv) in (("dark3", (2, 6400, 64, 512)), ("ragged", (2, 3600, 64, 512))):
        readings = []
        for score_std in SCORE_STDS:
            std = qk_std(score_std, 1.0, dq)
            q = (randn(b, n, dq) * std).to(torch.bfloat16)
            k = (randn(b, n, dq) * std).to(torch.bfloat16)
            v = randn(b, n, dv).to(torch.bfloat16)
            readings.append({"score_std": score_std, **hold_against_plain(
                lambda: A.flash_single(q, k, v, 1.0),
                lambda: A.flash_single_plain(q, k, v, 1.0),
                f"flash_single {name} score_std {score_std}")})
        flops = 2.0 * b * n * n * (dq + dv)
        bnd, by = bound_ms(flops, 2.0 * (b * n * (2 * dq + dv) + b * n * dv))
        single_rows.append(dict(
            node=name, b=b, n=n, dq=dq, dv=dv, readings=readings,
            ms=timed_ms(lambda: A.flash_single(q, k, v, 1.0), 20),
            plain_ms=timed_ms(lambda: A.flash_single_plain(q, k, v, 1.0), 3, 1),
            library_ms=timed_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=1.0), 20),
            bound_ms=bnd, bound_by=by,
        ))
        print(json.dumps({"kernel": "flash_single", **single_rows[-1]}), flush=True)
    return mha_rows, single_rows


def kernel_entry(name, source, replaces, rows, launches):
    """One line of the kernels report: the main path's shapes summed (one
    forward's or training step's worth of this kernel's launches at batch
    2), the ragged shapes kept in `shapes` and in the error."""
    main = [r for r in rows if not r["node"].startswith("ragged")]
    total = lambda key: sum(r[key] for r in main)
    entry = {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches,
        "max_abs_err": max(x["max_abs_err"] for r in rows for x in r["readings"]),
        "ms": total("ms"), "plain_ms": total("plain_ms"), "bound_ms": total("bound_ms"),
        "bound_by": "operations" if all(r["bound_by"] == "operations" for r in main) else "bytes",
        "library_ms": total("library_ms"),
    }
    if main and all("batch1" in r for r in main):
        entry["batch1"] = {k: sum(r["batch1"][k] for r in main)
                           for k in ("ms", "library_ms", "bound_ms")}
    return {**entry, "shapes": rows}


KERNEL_CLASSES = (  # first match wins: convolutions run as implicit GEMMs
    ("flash attention (ours)", ("flash_fwd_",)),   # bf16 and fp32 forms
    ("flash attention backward (ours)", ("flash_bwd_",)),  # sm90, template and fp32 forms
    ("optimizer and EMA (foreach)", ("multi_tensor", "foreach")),
    ("int8 flash attention (ours)", ("flash_int8_kernel", "flash_int8_sm90_kernel")),
    ("int8 GEMM (ours)", ("qmm_sm90_kernel", "rows_out_kernel")),
    ("int8 row quantize (ours)", ("quant_rows_kernel",)),
    ("batch/layer norm", ("bn_fw", "batch_norm", "layer_norm")),
    ("convolution", ("conv", "implicit", "winograd", "fprop", "dgrad", "wgrad")),
    ("matmul", ("gemm", "xmma", "cutlass", "nvjet", "Kernel2")),
    ("reduction", ("reduce", "softmax")),
    ("elementwise and copies", ("elementwise", "vectorized", "unrolled", "copy", "fill",
                                "cat", "Memcpy", "Memset")),
)


def profile_forward(model, images) -> dict:
    """`profile_call` of one forward."""
    return profile_call(lambda: model(images), int(images.shape[0]))


def profile_call(fn, batch: int) -> dict:
    """Device time of one call by kernel class and the top kernels, from
    torch.profiler, and the device's idle share of the call's wall time
    (profiler overhead included)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device kernels only: operator rows (aten::, autograd Functions) repeat
    # their kernels' time, and "Command Buffer Full" marks a full launch queue
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
               and e.key != "Command Buffer Full"]
    busy = sum(t for _, t, _ in kernels)
    classes = {}
    for name, t, _ in kernels:
        cls = next((c for c, keys in KERNEL_CLASSES
                    if any(k.lower() in name.lower() for k in keys)), "other")
        classes[cls] = classes.get(cls, 0.0) + t
    top = sorted(kernels, key=lambda r: -r[1])[:12]
    reading = {"profile_batch": batch, "wall_ms": wall_ms,
               "device_busy_ms": busy, "idle_share": (1 - busy / wall_ms) if busy else None,
               "by_class_ms": classes,
               "top_kernels": [{"name": n[:90], "ms": t, "count": c} for n, t, c in top]}
    print(json.dumps(reading), flush=True)
    return reading


def match_detections(da, db, pcfg, margin: float) -> dict:
    """Detections of run a that score above the confidence by more than
    `margin`, the largest score difference between the runs (so they are
    candidates in run b too), and how many of them
    run b keeps at IoU >= 0.9 with the same class (`identical`) or has no
    same-class detection for at IoU >= 0.75 * nms_iou, neither the box itself
    nor the one that suppressed it (`unmatched`)."""
    import torch

    from transparent_object_detection_tpu_torch.ops.geometry import pairwise_iou

    sel = da["valid"] & (da["scores"] > pcfg.confidence + margin)
    same = (da["classes"][:, :, None] == db["classes"][:, None, :]) & db["valid"][:, None, :]
    iou = pairwise_iou(da["boxes"].float(), db["boxes"].float())
    best = torch.where(same, iou, torch.zeros_like(iou)).amax(dim=-1)
    return {"compared": int(sel.sum()), "identical": int((sel & (best >= 0.9)).sum()),
            "unmatched": int((sel & (best < 0.75 * pcfg.nms_iou)).sum())}


def slice_phase(card: str):
    import numpy as np
    import torch

    from transparent_object_detection_tpu_torch.config import ModelConfig, PredictConfig
    from transparent_object_detection_tpu_torch.inference import Predictor
    from transparent_object_detection_tpu_torch.models.detector import (
        build_model,
        set_attention_impl,
    )
    from transparent_object_detection_tpu_torch.ops import attention as A
    from transparent_object_detection_tpu_torch.ops.geometry import xywh2xyxy
    from transparent_object_detection_tpu_torch.ops.nms import batched_nms
    from transparent_object_detection_tpu_torch.ops.preprocess import letterbox_batch

    cfg, pcfg = ModelConfig(), PredictConfig()  # phi='s', 640x640, bf16, int8 off
    model = build_model(cfg, device="cuda", seed=SEED)
    n_params = sum(p.numel() for p in model.parameters())
    predictor = Predictor(model, cfg, pcfg, device="cuda")

    rng = np.random.default_rng(SEED)
    raw = rng.integers(0, 256, size=(4, 480, 640, 3), dtype=np.uint8)
    shapes = np.tile(np.array([[480, 640]], np.float32), (4, 1))
    images = letterbox_batch(torch.as_tensor(raw, device="cuda").float() / 255.0,
                             cfg.input_shape)

    # random weights: dark3 gamma 0.5, else its attention never reaches the
    # output; class biases so that about CANDIDATES_PER_IMAGE anchors an image
    # pass the confidence, as a trained detector's few dozen would (the prior
    # bias passes none, a zero bias puts every score at 0.5)
    with torch.no_grad():
        model.backbone.dark3_attn.gamma.fill_(0.5)
        towers = [getattr(model.head, f"cls{i}") for i in range(3)]
        for t in towers:
            t.out.bias.zero_()
        logits = torch.logit(model(images)["decoded"][..., 4:].amax(-1), eps=1e-6).flatten()
        shift = float(logits.topk(CANDIDATES_PER_IMAGE * len(raw)).values[-1])
        for t in towers:
            t.out.bias.fill_(-shift)
    print(json.dumps({"cls_logits_at_zero_bias": {
        "p50": float(logits.median()), "p99": float(logits.quantile(0.99)),
        "max": float(logits.max()), "bias_set": -shift}}), flush=True)

    # the main path, counted: counts to 0 just before, read just after
    A.reset_launch_counts()
    dets = predictor.detect_raw_batch(raw, shapes)
    torch.cuda.synchronize()
    launches = {"flash_mha_packed": A.flash_mha_packed.launches,
                "flash_mha_packed_sm90": A.flash_mha_packed.sm90_launches,
                "flash_single": A.flash_single.launches}
    print(json.dumps({"main_path_launches": launches}), flush=True)
    check(launches == {"flash_mha_packed": 0, "flash_mha_packed_sm90": 3, "flash_single": 1},
          f"expected 3 packed launches of the sm90 kernel and 1 single-head launch per "
          f"forward, got {launches}")
    nd = dets["num_detections"].cpu()
    check(dets["boxes"].shape == (4, pcfg.max_detections, 4),
          f"boxes shape {tuple(dets['boxes'].shape)}")
    check(bool(torch.isfinite(dets["boxes"]).all()), "non-finite boxes")
    check(bool((nd > 0).all()), f"empty detections: {nd.tolist()}")

    # the same images with the plain attention versions: sound, and with each
    # planted fault
    def run_plain():
        set_attention_impl(model, "plain")
        try:
            return model(images)["decoded"], predictor.detect_raw_batch(raw, shapes)
        finally:
            set_attention_impl(model, None)

    with torch.inference_mode():
        dec_k = model(images)["decoded"]
        dec_p, dets_p = run_plain()
        faulty = {}
        for fault in PLANTED_FAULTS:
            with planted(fault):
                faulty[fault] = run_plain()
    check(dec_k.shape == (4, cfg.num_anchors, 4 + cfg.num_classes),
          f"decoded shape {tuple(dec_k.shape)}")
    check(bool(torch.isfinite(dec_k).all()), "non-finite decoded")

    def against_plain(dec, d):
        score_diff = float((dec[..., 4:] - dec_p[..., 4:]).abs().max())
        return {"decoded_box_max_abs_px": float((dec[..., :4] - dec_p[..., :4]).abs().max()),
                "decoded_score_max_abs": score_diff,
                "num_detections": d["num_detections"].cpu().tolist(),
                "matched_in_plain": match_detections(d, dets_p, pcfg, score_diff),
                "plain_matched_here": match_detections(dets_p, d, pcfg, score_diff)}

    sound = against_plain(dec_k, dets)
    faults = {f: against_plain(*faulty[f]) for f in faulty}
    print(json.dumps({"slice_parity": {
        "kernels": sound, "num_detections_plain": dets_p["num_detections"].cpu().tolist(),
        "planted_faults": faults,
        "limits": {"box_px": BOX_LIMIT_PX, "score": SCORE_LIMIT}}}), flush=True)
    check(sound["decoded_box_max_abs_px"] <= BOX_LIMIT_PX,
          f"decoded boxes differ from the plain run by {sound['decoded_box_max_abs_px']} px")
    check(sound["decoded_score_max_abs"] <= SCORE_LIMIT,
          f"decoded scores differ from the plain run by {sound['decoded_score_max_abs']}")
    for d in (dets, dets_p):
        check(bool((d["num_detections"] < pcfg.max_detections).all()),
              "max_detections cut the detections; the sets are not comparable")
    for key in ("matched_in_plain", "plain_matched_here"):
        m = sound[key]
        check(m["compared"] > 0 and m["unmatched"] == 0, f"detection sets differ: {key} {m}")
    for fault in SLICE_REJECTS:
        r = faults[fault]
        check(r["decoded_box_max_abs_px"] > BOX_LIMIT_PX or
              r["decoded_score_max_abs"] > SCORE_LIMIT,
              f"the slice limits do not reject the planted fault {fault}: {r}")

    # each kernel launch of one forward against its plain version on the
    # same activations, with the kernel bar (uncounted: not the main path's run)
    calls, real = [], (A.flash_mha_packed, A.flash_single)

    def recording(kernel, plain):
        def launch(*args):
            out = kernel(*args)
            calls.append((kernel.__name__, args, out, plain))
            return out
        # the wrapper counts on the name it is bound to
        launch.launches = launch.sm90_launches = launch.f32_launches = 0
        return launch

    A.flash_mha_packed = recording(real[0], A.flash_mha_packed_plain)
    A.flash_single = recording(real[1], A.flash_single_plain)
    try:
        with torch.inference_mode():
            model(images[:2])
    finally:
        A.flash_mha_packed, A.flash_single = real
    check(len(calls) == 4, f"expected 4 kernel launches in one forward, got {len(calls)}")
    for i, (name, args, out, plain) in enumerate(calls):
        with torch.inference_mode():
            hold_against_plain(lambda: out, lambda: plain(*args),
                               f"{name} launch {i} on the path's activations",
                               faults_must_fail=False)

    # timing: batch-1 latency (end to end and forward only), batch-32 throughput
    with torch.inference_mode():
        one, one_shape = raw[:1], shapes[:1]
        lat = []
        for _ in range(3):
            predictor.detect_raw_batch(one, one_shape)
        torch.cuda.synchronize()
        for _ in range(40):  # p75 has 10 samples beyond it
            t0 = time.perf_counter()
            predictor.detect_raw_batch(one, one_shape)["num_detections"].cpu()
            lat.append((time.perf_counter() - t0) * 1e3)
        lat.sort()
        img1 = images[:1]
        fwd1 = timed_ms(lambda: model(img1), 20, 3)

        raw32 = rng.integers(0, 256, size=(32, 480, 640, 3), dtype=np.uint8)
        shapes32 = np.tile(np.array([[480, 640]], np.float32), (32, 1))
        torch.cuda.reset_peak_memory_stats()
        predictor.detect_raw_batch(raw32, shapes32)["num_detections"].cpu()
        t0 = time.perf_counter()
        iters = 3
        for _ in range(iters):
            predictor.detect_raw_batch(raw32, shapes32)["num_detections"].cpu()
        b32_s = (time.perf_counter() - t0) / iters
        img32 = letterbox_batch(torch.as_tensor(raw32, device="cuda").float() / 255.0,
                                cfg.input_shape)
        fwd32 = timed_ms(lambda: model(img32), 3, 1)
        dec1 = model(img1)["decoded"]
        nms1 = timed_ms(lambda: batched_nms(xywh2xyxy(dec1[..., :4]),
                                            dec1[..., 4:])["valid"].cpu(), 5, 1)
        profile_forward(model, img32)
    perf = {
        "card": card, "model": "phi=s 640x640 bf16", "params": n_params,
        "batch1_latency_samples": len(lat),
        "batch1_latency_ms_p50": lat[len(lat) // 2],
        "batch1_latency_ms_p75": lat[3 * len(lat) // 4],
        "batch1_latency_ms_min": lat[0],
        "batch1_forward_ms": fwd1,
        "batch1_nms_ms": nms1,
        "batch32_imgs_per_s": 32 / b32_s, "batch32_step_ms": b32_s * 1e3,
        "batch32_forward_ms": fwd32,
        "peak_mem_gib_batch32": torch.cuda.max_memory_allocated() / 2**30,
        "input": "uint8 480x640 letterboxed on device; NMS exact, confidence 0.5, "
                 f"class biases set for ~{CANDIDATES_PER_IMAGE} candidates an image",
    }
    print(json.dumps({"slice_perf": perf}), flush=True)
    return launches, model, perf


# ---------------------------------------------------------------------------
# int8 serving: quant_rows, qmm and flash_mha_int8
# ---------------------------------------------------------------------------

PEAK_INT8_OPS = 1979e12  # H100 SXM data sheet, dense int8
DEVICE = "cuda"
# int8 bars. Payloads: the same integers, except that a value on a rounding
# boundary may land one step away (sums in another order, another exp2 or
# tanh): |diff| <= 1 on at most PAYLOAD_FLIP_SHARE of the elements. Scales:
# SCALE_RTOL relative. Values (bf16 or fp32): |diff| <= RTOL8 * |plain| + ATOL8_OF_MAX
# * max|plain|, one bf16 ulp of a value plus a little; the kernels compute
# the plain versions' integers, so this is tighter than the bf16 bar. On the
# CPU, the planted attention faults read 9-74 times it (phi='s' shapes at
# N = 1,600) and the plain version's own reference 1.5e-5 of it.
PAYLOAD_FLIP_SHARE = 1e-3
SCALE_RTOL = 1e-5
RTOL8, ATOL8_OF_MAX = 1e-2, 1e-3
# Slice limits of the int8 model with kernels against the same model on plain
# versions, set between the sound reading (0.218 px, 1.7e-4) and that of the
# planted fault in INT8_SLICE_REJECTS (0.599 px, 5.8e-4) on an H100 (PERF.md).
INT8_BOX_LIMIT_PX = 0.35
INT8_SCORE_LIMIT = 3e-4
# Candidates an image for the int8 run's class biases: the int8 kernels move
# scores by ~1.7e-4 against the plain versions, as much as the score spread
# of this random head's top 50 anchors an image, so the detection sets are
# compared over more of them.
INT8_CANDIDATES_PER_IMAGE = 200
INT8_SLICE_REJECTS = ("qmm_k_slab_dropped",)


def _component_reading(out, ref, scales: bool = False) -> dict:
    """Bar use (<= 1 passes) of one output component against its plain
    version: int8 payload, f32 scales (`scales`) or bf16 / fp32 values."""
    import torch

    check(tuple(out.shape) == tuple(ref.shape),
          f"shape {tuple(out.shape)} against the plain version's {tuple(ref.shape)}")
    if out.dtype == torch.int8:
        diff = (out.int() - ref.int()).abs()
        share = float((diff > 0).float().mean())
        return {"kind": "payload", "max_step": int(diff.max()), "flip_share": share,
                "bar_used": max(float(diff.max()) / 1.0 if int(diff.max()) > 1 else 0.0,
                                share / PAYLOAD_FLIP_SHARE)}
    if scales:
        rel = float(((out - ref).abs() / ref.abs().clamp(min=1e-30)).max())
        return {"kind": "scales", "max_rel": rel, "bar_used": rel / SCALE_RTOL}
    diff = (out.float() - ref.float()).abs()
    mag = ref.float().abs()
    used = float((diff / (RTOL8 * mag + ATOL8_OF_MAX * mag.max())).max())
    return {"kind": "values", "max_abs_err": float(diff.max()),
            "ref_max_abs": float(mag.max()), "bar_used": used}


def int8_reading(out, ref) -> dict:
    """Bar use of a kernel's outputs against its plain version's, and the
    largest absolute error of the values they stand for (a payload with its
    scales dequantized)."""
    from transparent_object_detection_tpu_torch.ops.quant_matmul import dequantize

    import torch

    outs = out if isinstance(out, tuple) else (out,)
    refs = ref if isinstance(ref, tuple) else (ref,)
    # an f32 component right after an int8 payload is its scales; any other
    # f32 component is a value (the fp32 models' outputs)
    parts = [_component_reading(o, r, scales=i > 0 and o.dtype == torch.float32
                                and outs[i - 1].dtype == torch.int8)
             for i, (o, r) in enumerate(zip(outs, refs))]
    errs = [p["max_abs_err"] for p in parts if p["kind"] == "values"]
    if len(outs) >= 2 and parts[-2]["kind"] == "payload" and parts[-1]["kind"] == "scales":
        deq = lambda t: dequantize(t[-2], t[-1], outs[-1].dtype)
        errs.append(float((deq(outs) - deq(refs)).abs().max()))
    return {"bar_used": max(p["bar_used"] for p in parts),
            "max_abs_err": max(errs) if errs else 0.0, "parts": parts}


@contextlib.contextmanager
def _patched(module, name, value):
    real = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, real)


def _k_slab_dropped(qm):
    real = qm._int_dot

    def faulty(a, b):
        a = a.clone()
        a[..., 32:64] = 0
        return real(a, b)
    return _patched(qm, "_int_dot", faulty)


def _group_halved(qm):
    real = qm._output_plain

    def faulty(out, out_dtype, group, ln_out_eps):
        if group is None:
            return real(out, out_dtype, group, ln_out_eps)
        payload, scales = real(out, out_dtype, group // 2, ln_out_eps)
        return payload, scales.reshape(*scales.shape[:-1], -1, 2).amax(-1)
    return _patched(qm, "_output_plain", faulty)


def _k_tail_dropped(qm):
    """The last K slab of the int8 dot left out: the K % 64 columns past the
    last whole 64-byte slab (a whole slab of 64 where K is a multiple)."""
    real = qm._int_dot

    def faulty(a, b):
        k = a.shape[-1]
        a = a.clone()
        a[..., k - (k % 64 or 64):] = 0
        return real(a, b)
    return _patched(qm, "_int_dot", faulty)


QMM_FAULTS = {"qmm_k_slab_dropped": _k_slab_dropped, "qmm_group_width_halved": _group_halved,
              "qmm_k_tail_dropped": _k_tail_dropped}


# The faults of csrc/qmm_sm90.cu's design, planted in the plain version: its
# 128-byte K slabs (a ring stage read twice and its neighbour never, or one
# dropped), the per-tile requantize (a group's words on the next group's
# ratio), its two consumer warpgroups (the second's 64 rows of every 128-row
# tile left unwritten: zeros here) and the last column tile of the plan's
# width written one column to the right. Each takes (module, plan).
def _slab_read_twice(qm, plan):
    real = qm._int_dot

    def faulty(a, b):
        a, b = a.clone(), b.clone()
        a[..., 128:256] = a[..., :128]
        b[..., 128:256] = b[..., :128]
        return real(a, b)
    return _patched(qm, "_int_dot", faulty)


def _slab128_dropped(qm, plan):
    real = qm._int_dot

    def faulty(a, b):
        a = a.clone()
        a[..., 128:256] = 0
        return real(a, b)
    return _patched(qm, "_int_dot", faulty)


def _group_neighbour_ratio(qm, plan):
    import torch

    real = qm._requant

    def faulty(xq, x_scales):
        groups = x_scales.shape[-1]
        if groups == 1:
            return real(xq, x_scales)
        smax = torch.clamp(x_scales.amax(dim=-1, keepdim=True), min=1e-30)
        ratio = (torch.roll(x_scales, -1, dims=-1) / smax)[..., None]
        x3 = xq.reshape(*xq.shape[:-1], groups, -1).float()
        return torch.round(x3 * ratio).reshape(xq.shape).to(torch.int8), smax
    return _patched(qm, "_requant", faulty)


def _second_warpgroup_rows(qm, plan):
    import torch

    real = qm._epilogue_plain

    def faulty(acc, *args):
        out = real(acc, *args)
        rows = torch.arange(out.shape[0], device=out.device)
        return torch.where(((rows % 128) >= 64)[:, None], torch.zeros_like(out), out)
    return _patched(qm, "_epilogue_plain", faulty)


def _last_tile_shifted(qm, plan):
    import torch

    real = qm._epilogue_plain

    def faulty(acc, *args):
        out = real(acc, *args)
        n = out.shape[-1]
        c0 = (n - 1) // plan["bn"] * plan["bn"]
        return torch.cat([out[:, :c0 + 1], out[:, c0:n - 1]], dim=1)
    return _patched(qm, "_epilogue_plain", faulty)


QMM_SM90_FAULTS = {"qmm_slab_read_twice": _slab_read_twice,
                   "qmm_slab128_dropped": _slab128_dropped,
                   "qmm_group_neighbour_ratio": _group_neighbour_ratio,
                   "qmm_second_warpgroup_rows_unwritten": _second_warpgroup_rows,
                   "qmm_last_column_tile_shifted": _last_tile_shifted}


def int8_attention_reference(q, k, v, heads, scale, scale_tile, max_tile, out_dtype=None,
                             key_keep=None):
    """The int8 attention function with the k/v scales taken per
    `scale_tile` keys and p rounded against the running maximum over
    `max_tile`-key tiles (float64 sums), output in out_dtype (q's by
    default). At scale_tile = max_tile = bk it is the plain version's
    function; smaller tiles plant the two faults a tiled kernel could make.
    `key_keep` (N,) bool leaves the other keys out of the max, the sum and
    p.v (a skipped key tile), their k/v scales unchanged."""
    import torch

    from transparent_object_detection_tpu_torch.ops import attention_int8 as A8

    b, n, _ = k.shape
    kq, ks = A8.quantize_kv(k, heads, scale_tile)
    vq, vs = A8.quantize_kv(v, heads, scale_tile)
    outs = []
    for bi in range(b):
        qq, qs = A8._quantize_q(A8._split_heads(q[bi:bi + 1], heads))
        kh, vh = A8._split_heads(kq[bi:bi + 1], heads)[0], A8._split_heads(vq[bi:bi + 1], heads)[0]
        rep = lambda t: t[bi].repeat_interleave(scale_tile, dim=-1)  # (H, N)
        s32 = torch.matmul(qq[0].double(), kh.double().transpose(-1, -2))
        s = s32.float() * (qs[0] * (rep(ks) * (scale * A8.LOG2E))[:, None, :])
        if key_keep is not None:
            s = s.masked_fill(~key_keep, float("-inf"))
        vv = vh.double() * rep(vs).double()[..., None]
        m = torch.full(qs[0].shape, -1e30, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros(heads, n, vh.shape[-1], dtype=torch.float64, device=q.device)
        for j in range(0, n, max_tile):
            sb = s[..., j:j + max_tile]
            m_new = torch.maximum(m, sb.amax(-1, keepdim=True))
            p127 = torch.exp2(sb - (m_new - A8.LOG2_127))
            corr = torch.exp2(m - m_new)
            l = l * corr + p127.sum(-1, keepdim=True)
            acc = acc * corr.double() + torch.round(p127).double() @ vv[:, j:j + max_tile]
            m = m_new
        outs.append((acc / l.double()).to(out_dtype or q.dtype))
    return torch.stack(outs).transpose(1, 2).reshape(b, n, -1)


SM90_RING_FAULTS = ("key_tile_read_twice", "tail_keys_unmasked", "v_key_order_unmatched")


def int8_tiled_reference(q, k, v, heads, scale, bk, keys, fault, out_dtype=None):
    """The int8 attention function as csrc/flash_int8_sm90.cu computes it
    with one of the faults its ring could commit (float64 sums): each key
    block read in tiles of `keys`, "key_tile_read_twice" reading its tile 1
    in place of tile 2 (never read), "tail_keys_unmasked" reading its last
    tile whole, the next block's keys scored with this block's scales (zero
    keys past N). The block's k/v scales apply to every key it reads, as in
    the kernel."""
    import torch

    from transparent_object_detection_tpu_torch.ops import attention_int8 as A8

    b, n, _ = k.shape
    kq, ks = A8.quantize_kv(k, heads, bk)
    vq, vs = A8.quantize_kv(v, heads, bk)
    kh = torch.cat([A8._split_heads(kq, heads).double(),
                    torch.zeros(b, heads, keys, kq.shape[-1] // heads, dtype=torch.float64,
                                device=q.device)], 2)  # the zero-filled keys past N
    vh = torch.cat([A8._split_heads(vq, heads).double(),
                    torch.zeros(b, heads, keys, vq.shape[-1] // heads, dtype=torch.float64,
                                device=q.device)], 2)
    tiles = -(-bk // keys)
    outs = []
    for bi in range(b):
        qq, qs = A8._quantize_q(A8._split_heads(q[bi:bi + 1], heads))
        qd = qq[0].double()
        m = torch.full(qs[0].shape, -1e30, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros(heads, n, vh.shape[-1], dtype=torch.float64, device=q.device)
        for j in range(n // bk):
            idx = torch.arange(j * bk, (j + 1) * bk, device=q.device)
            if fault == "key_tile_read_twice" and tiles > 2:
                idx[2 * keys:min(3 * keys, bk)] = idx[keys:keys + min(keys, bk - 2 * keys)]
            elif fault == "tail_keys_unmasked":
                idx = torch.arange(j * bk, j * bk + tiles * keys, device=q.device).clamp(max=n)
            s32 = qd @ kh[bi][:, idx].transpose(-1, -2)
            s = s32.float() * (qs[0] * (ks[bi, :, j] * (scale * A8.LOG2E))[:, None, None])
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p127 = torch.exp2(s - (m_new - A8.LOG2_127))
            corr = torch.exp2(m - m_new)
            l = l * corr + p127.sum(-1, keepdim=True)
            pv = torch.round(p127).double() @ vh[bi][:, idx]
            acc = acc * corr.double() + pv * vs[bi, :, j].double()[:, None, None]
            m = m_new
        outs.append((acc / l.double()).to(out_dtype or q.dtype))
    return torch.stack(outs).transpose(1, 2).reshape(b, n, -1)


def sm90_ring_faults(q, kq, ks, vq, vs, heads, scale, k, v, bk, quant=None):
    """{fault: thunk} of the int8 sm90 kernel's own faults at these inputs
    (q bf16 or fp32, possibly the packed qkv; k, v before quantization):
    the tiled reference with a key tile read twice (three tiles or more a
    block) or the tail keys unmasked (several blocks that are not multiples
    of the key tile: a tail tile then holds the next block's keys), and the
    kernel itself launched on V in its natural key
    order (a layout that does not match P's fragments). With `quant` (the
    per-(row, head) quantizer) the int8 output of flash_mha_int8_qout."""
    import torch

    from transparent_object_detection_tpu_torch.ops import attention_int8 as A8

    keys = A8.int8_sm90_plan(kq.shape[-1] // heads, vq.shape[-1] // heads, ks.shape[-1])["keys"]
    qc = q[..., :kq.shape[-1]]
    out_dtype = None if quant is None else torch.float32
    tiled = lambda fault: (quant or (lambda o: o))(
        int8_tiled_reference(qc, k, v, heads, scale, bk, keys, fault, out_dtype))
    faults = {}
    if -(-bk // keys) > 2:
        faults["key_tile_read_twice"] = lambda: tiled("key_tile_read_twice")
    if bk % keys and ks.shape[-1] > 1:  # a tail tile that runs into the next block
        faults["tail_keys_unmasked"] = lambda: tiled("tail_keys_unmasked")
    natural = A8._split_heads(vq, heads).transpose(-1, -2).contiguous()  # (B, H, dv, N)
    faults["v_key_order_unmatched"] = lambda: A8._launch_sm90(
        q, None, kq, ks, vq, vs, heads, scale, torch.int8 if quant else q.dtype, vt=natural)
    return faults


def twice_same_bits(kernel, out, what: str) -> None:
    """A second launch on the same inputs gives the same bits: a missing
    wgmma wait or an mbarrier parity error shows as a run-to-run
    difference."""
    import torch

    again = kernel()
    torch.cuda.synchronize()
    outs = out if isinstance(out, tuple) else (out,)
    agains = again if isinstance(again, tuple) else (again,)
    check(all(torch.equal(a, b) for a, b in zip(outs, agains)),
          f"{what}: a second launch gave other bits")


def _qmm_case(name, x, xs, m, k, n, groups, act, residual, group=None, ln_out=False, ln=None,
              qmax=127, dtype="bfloat16"):
    """One synthetic qmm (and, for bf16 or fp32 x, quant_rows) check with
    faults; qmax=7: the w4a4 pair (int4-range rows and weights), and
    quant_rows' bar must reject qmax 127 in place of 7. `dtype`: the
    residual's and output's type (bf16, or fp32 as the fp32 models run)."""
    import torch

    from transparent_object_detection_tpu_torch.ops import quant_matmul as QM

    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    w = torch.randn(n, k, generator=gen, device=DEVICE) / k ** 0.5
    bias = torch.randn(n, generator=gen, device=DEVICE) * 0.1
    wts = (QM.prepare_weights4 if qmax == 7 else QM.prepare_weights)(w, bias)
    dt = getattr(torch, dtype)
    res = (torch.randn(m, n, generator=gen, device=DEVICE).to(dt) if residual else None)
    readings = {}
    if ln is not None:  # bf16 rows: quant_rows first
        xq, xsk = QM.quant_rows(x, ln, qmax=qmax)
        xq_p, xs_p = QM.quant_rows_plain(x, ln, qmax=qmax)
        readings["quant_rows"] = int8_reading((xq, xsk), (xq_p, xs_p))
        check(readings["quant_rows"]["bar_used"] <= 1.0, f"quant_rows {name}: {readings}")
        if qmax == 7:
            used = int8_reading(QM.quant_rows_plain(x, ln, qmax=127), (xq_p, xs_p))["bar_used"]
            readings["quant_rows_faults_bar_used"] = {"qmax_127_for_7": used}
            check(used > 1.0, f"quant_rows {name}: the bar does not reject qmax 127 for 7")
        x, xs = xq_p, xs_p
    eps = 1e-6 if ln_out else None
    kern = lambda: QM.qmm(x, xs, wts["wq"], wts["w_scale"], wts["bias"], act, res, group, eps,
                          dt)
    plain = lambda: QM.qmm_plain(x, xs, wts["wq"], wts["w_scale"], wts["bias"], act, res, group,
                                 eps, dt)
    out = kern()
    torch.cuda.synchronize()
    if x.is_cuda:  # csrc/qmm_sm90.cu: a second launch, the same bits
        twice_same_bits(kern, out, f"qmm {name}")
    ref = plain()
    readings["qmm"] = int8_reading(out, ref)
    plan = QM.qmm_sm90_plan(m, n, k, xs.shape[-1])
    faults = {}
    for fault, plant in QMM_FAULTS.items():
        if fault == "qmm_group_width_halved" and group is None:
            continue
        with plant(QM):
            faults[fault] = int8_reading(plain(), ref)["bar_used"]
    for fault, plant in QMM_SM90_FAULTS.items():
        if fault == "qmm_group_neighbour_ratio" and xs.shape[-1] == 1:
            continue
        with plant(QM, plan):
            faults[fault] = int8_reading(plain(), ref)["bar_used"]
    readings["qmm_faults_bar_used"] = faults
    print(json.dumps({"check": f"qmm {name}", "m": m, "k": k, "n": n, "groups": groups,
                      "act": act, "residual": residual, "group": group, "ln_out": ln_out,
                      "dtype": dtype, "plan": {key: plan[key] for key in ("bn", "stages", "grid")},
                      **readings}), flush=True)
    check(readings["qmm"]["bar_used"] <= 1.0, f"qmm {name}: kernel off the bar {readings['qmm']}")
    for fault, used in faults.items():
        check(used > 1.0, f"qmm {name}: the bar does not reject {fault} ({used:.3g}x)")
    return readings, out


def int8_kernel_phase(shrink: int = 1) -> dict:
    """quant_rows, qmm and flash_mha_int8 against their plain versions on
    synthetic inputs at the serving path's shapes (batch 2, and batch 32's
    split qkv and LN-handoff shapes), each bar also held against the planted
    faults. Returns the largest value error per kernel. `shrink` divides
    the row and token counts (a rehearsal on the CPU)."""
    import torch

    from transparent_object_detection_tpu_torch.ops import attention_int8 as A8
    from transparent_object_detection_tpu_torch.ops import quant_matmul as QM

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
    rows = lambda m, c: (torch.randn(m, c, generator=gen, device=DEVICE) * 2 + 0.5).bfloat16()
    payload = lambda m, c, g: (
        torch.randint(-127, 128, (m, c), generator=gen, device=DEVICE, dtype=torch.int8),
        torch.rand(m, g, generator=gen, device=DEVICE) * 0.05 + 0.01)
    err = {"quant_rows": 0.0, "qmm": 0.0, "flash_mha_int8": 0.0}

    def run(*args, **kw):
        r, out = _qmm_case(*args, **kw)
        for name in ("quant_rows", "qmm"):
            if name in r:
                err[name] = max(err[name], r[name]["max_abs_err"])
        return out

    # batch 2: h2 qkv (LN, bias), h2 attn_out (residual), h1 mlp1 (gelu,
    # quant_out in groups of 512) and h1 mlp2 on that payload (G = 16)
    m2, m1, m32 = 12800 // shrink, 3200 // shrink, 51200 // shrink
    run("h2 qkv batch 2", rows(m2, 1536), None, m2, 1536, 4608, 0, None, False, ln=True)
    run("h2 attn_out batch 2", rows(m2, 1536), None, m2, 1536, 1536, 0, None, True, ln=False)
    g = QM.quant_out_group_width(m1, 2048, 8192, 0)
    z8 = run("h1 mlp1 batch 2", rows(m1, 2048), None, m1, 2048, 8192, 0, "gelu", False,
             group=g, ln=True)
    run("h1 mlp2 batch 2", z8[0], z8[1], m1, 8192, 2048, 8192 // g, None, True)
    # batch 32: h4's split qkv, attn_out with ln_out, mlp1 on the LN payload
    # (G = 1, groups of 6,144); h1's mlp2 on groups of 512 (G = 16)
    run("h4 qkv batch 32 (split)", rows(m32, 1536), None, m32, 1536, 4608, 0, None, False,
        ln=True)
    ln8 = run("h4 attn_out batch 32 (ln_out)", rows(m32, 1536), None, m32, 1536, 1536, 0,
              None, True, ln_out=True, ln=False)
    g = QM.quant_out_group_width(m32, 1536, 6144, 1)
    run("h4 mlp1 batch 32 (LN payload)", ln8[1], ln8[2], m32, 1536, 6144, 1, "gelu", False,
        group=g)
    g = QM.quant_out_group_width(m32, 2048, 8192, 1)
    p, s = payload(m32, 8192, 8192 // g)
    run("h1 mlp2 batch 32", p, s, m32, 8192, 2048, 8192 // g, None, True)

    # int8 attention, batch 2: h1, h2, h4 (packed q), dark3 (dq 64, dv 512)
    randn = lambda *s: torch.randn(*s, generator=gen, device=DEVICE)
    qk_std = lambda score_std, scale, d: (score_std / (scale * d ** 0.5)) ** 0.5
    faults = {"p_rounded_on_running_64_key_max": lambda q, k, v, h, sc, bk:
              int8_attention_reference(q, k, v, h, sc, bk, 64),
              "kv_scales_per_64_keys": lambda q, k, v, h, sc, bk:
              int8_attention_reference(q, k, v, h, sc, 64, bk)}
    for name, (b, n, cq, cv, h) in (("h1", (2, 1600, 2048, 2048, 8)),
                                    ("h2", (2, 6400, 1536, 1536, 6)),
                                    ("h4", (2, 1600, 1536, 1536, 6)),
                                    ("dark3", (2, 6400, 64, 512, 1))):
        n //= shrink
        scale = (cq // h) ** -0.5 if h > 1 else 1.0
        bk = A8.pick_blocks(n, cq, h, cv=cv)[1]
        rejected = {}
        for score_std in SCORE_STDS:
            std = qk_std(score_std, scale, cq // h)
            if h > 1:  # packed (B, N, 3C) as the TEB hands it over
                qkv = randn(b, n, 3 * cq)
                qkv[..., :2 * cq] *= std
                qkv = qkv.bfloat16()
                q, k, v, q_width = qkv, qkv[..., cq:2 * cq], qkv[..., 2 * cq:], cq
            else:
                q, k = ((randn(b, n, cq) * std).bfloat16() for _ in range(2))
                v, q_width = randn(b, n, cv).bfloat16(), None
            kq, ks = A8.quantize_kv(k, h, bk)
            vq, vs = A8.quantize_kv(v, h, bk)
            kern = lambda: A8.flash_mha_int8(q, kq, ks, vq, vs, h, scale, q_width)
            out = kern()
            torch.cuda.synchronize()
            sm90 = q.is_cuda and A8.int8_fwd_form(cq // h, cv // h) == "sm90"
            if sm90:
                twice_same_bits(kern, out, f"flash_mha_int8 {name}")
            ref = A8.flash_mha_int8_plain(q, kq, ks, vq, vs, h, scale, q_width)
            qc = q[..., :cq]
            reading = int8_reading(out, ref)
            reading["reference_bar_used"] = int8_reading(
                int8_attention_reference(qc, k, v, h, scale, bk, bk), ref)["bar_used"]
            reading["faults_bar_used"] = {
                f: int8_reading(fn(qc, k, v, h, scale, bk), ref)["bar_used"]
                for f, fn in faults.items()}
            if sm90:  # and the faults of the sm90 kernel's ring and layout
                reading["faults_bar_used"].update(
                    (f, int8_reading(fn(), ref)["bar_used"])
                    for f, fn in sm90_ring_faults(q, kq, ks, vq, vs, h, scale, k, v, bk).items())
            for f, used in reading["faults_bar_used"].items():
                rejected[f] = rejected.get(f, False) or used > 1.0
            print(json.dumps({"check": f"flash_mha_int8 {name} score_std {score_std}",
                              "b": b, "n": n, "cq": cq, "cv": cv, "heads": h, "bk": bk,
                              **reading}), flush=True)
            check(reading["bar_used"] <= 1.0, f"flash_mha_int8 {name}: off the bar {reading}")
            check(reading["reference_bar_used"] <= 1.0,
                  f"flash_mha_int8 {name}: the fault reference is not the plain function")
            err["flash_mha_int8"] = max(err["flash_mha_int8"], reading["max_abs_err"])
        for f, ok in rejected.items():
            check(ok, f"flash_mha_int8 {name}: the bar rejects {f} on no input spread")
    # several key blocks (pick_blocks gives bk < N past 6,400 tokens), of
    # 800 keys, not a multiple of the key tile: the fp32 acc in shared
    # memory, each block's tail tile running into the next block
    n, h, cq = 6400 // shrink, 6, 1536
    bk = n // 8
    scale = (cq // h) ** -0.5
    qkv = randn(1, n, 3 * cq)
    qkv[..., :2 * cq] *= qk_std(4.0, scale, cq // h)
    qkv = qkv.bfloat16()
    k, v = qkv[..., cq:2 * cq], qkv[..., 2 * cq:]
    kq, ks = A8.quantize_kv(k, h, bk)
    vq, vs = A8.quantize_kv(v, h, bk)
    args = (qkv, kq, ks, vq, vs, h, scale, cq)
    out = A8.flash_mha_int8(*args)
    torch.cuda.synchronize()
    ref = A8.flash_mha_int8_plain(*args)
    reading = int8_reading(out, ref)
    if qkv.is_cuda:
        twice_same_bits(lambda: A8.flash_mha_int8(*args), out, "flash_mha_int8 8 key blocks")
        reading["faults_bar_used"] = {
            f: int8_reading(fn(), ref)["bar_used"]
            for f, fn in sm90_ring_faults(qkv, kq, ks, vq, vs, h, scale, k, v, bk).items()}
    print(json.dumps({"check": "flash_mha_int8 h2 widths, 8 key blocks", "n": n, "bk": bk,
                      **reading}), flush=True)
    check(reading["bar_used"] <= 1.0, f"flash_mha_int8 with 8 key blocks: {reading}")
    check(set(reading.get("faults_bar_used", SM90_RING_FAULTS)) == set(SM90_RING_FAULTS),
          "flash_mha_int8 with 8 key blocks: not every sm90 fault planted")
    for f, used in reading.get("faults_bar_used", {}).items():
        check(used > 1.0, f"flash_mha_int8 with 8 key blocks: the bar does not reject {f} "
                          f"({used:.3g}x)")
    return err


def _qmm_cost(args, out):
    """(operations, bytes) of one qmm call: each input read once, each
    output written once."""
    xq, xs, wq, ws, bias, act, res = args[:7]
    m, k = xq.shape
    n = wq.shape[0]
    outs = out if isinstance(out, tuple) else (out,)
    nbytes = (xq.numel() + xs.numel() * 4 + wq.numel() + ws.numel() * 4
              + (0 if bias is None else n * 4)
              + (0 if res is None else res.numel() * res.element_size())
              + sum(o.numel() * o.element_size() for o in outs))
    return 2.0 * m * k * n, nbytes


def _library_qmm(args):
    """The yardstick of qmm, two ways: one torch._int_mm (cuBLASLt's int8
    GEMM) alone, and with the epilogue in PyTorch ops (per-row x scales;
    the G > 1 requantize is left out). _int_mm takes K and N in multiples
    of 8: other shapes (phi 'n' and 'm' h1 / h6, K = 849, 4,792, N =
    2,547) run on copies zero-padded to them, made beforehand."""
    import torch
    import torch.nn.functional as F

    xq, xs, wq, ws, bias, act, res = args[:7]
    k, n = xq.shape[1], wq.shape[0]
    k8, n8 = k + (-k % 8), n + (-n % 8)
    a = F.pad(xq, (0, k8 - k)) if k8 != k else xq
    b = F.pad(wq[:, :k8], (0, k8 - min(k8, wq.shape[1]), 0, n8 - n)).t()
    rs = xs if xs.shape[-1] == 1 else xs.amax(-1, keepdim=True)

    def alone():
        return torch._int_mm(a, b)

    def with_epilogue():
        out = torch._int_mm(a, b)[:, :n].float() * rs * ws
        if bias is not None:
            out = out + bias
        if act == "gelu":
            out = F.gelu(out, approximate="tanh")
        if res is not None:
            out = out + res.float()
        return out.bfloat16()
    return alone, with_epilogue


def int8_path_calls(model, images) -> dict:
    """Every int8 kernel launch of one forward, recorded with its arguments,
    then held against its plain version on the same activations and timed
    beside its plain version, its bound and a library yardstick."""
    import torch

    from transparent_object_detection_tpu_torch.ops import attention_int8 as A8
    from transparent_object_detection_tpu_torch.ops import quant_matmul as QM

    calls = []
    real = {"quant_rows": (QM, QM.quant_rows, QM.quant_rows_plain),
            "qmm": (QM, QM.qmm, QM.qmm_plain),
            "flash_mha_int8": (A8, A8.flash_mha_int8, A8.flash_mha_int8_plain),
            "flash_mha_int8_qout": (A8, A8.flash_mha_int8_qout, A8.flash_mha_int8_qout_plain),
            "flash_int8_handoff": (A8, A8.flash_int8_handoff, A8.flash_int8_handoff_plain)}

    def recording(name, kernel):
        def launch(*args, **kw):
            out = kernel(*args, **kw)
            calls.append((name, args, kw, out))
            return out
        # the wrapper counts on its own name
        launch.launches = launch.launches_int4 = launch.sm90_launches = 0
        return launch

    for name, (mod, kernel, _) in real.items():
        setattr(mod, name, recording(name, kernel))
    try:
        with torch.inference_mode():
            model(images)
    finally:
        for name, (mod, kernel, _) in real.items():
            setattr(mod, name, kernel)
    rows = {name: [] for name in (*real, "quant_rows_int4")}
    for i, (name, args, kw, out) in enumerate(calls):
        mod, kernel, plain = real[name]
        if name == "quant_rows" and kw.get("qmax", args[3] if len(args) > 3 else 127) == 7:
            name = "quant_rows_int4"  # the same kernel as JAX's _w4a4_call launches it
        with torch.inference_mode():
            reading = int8_reading(out, plain(*args, **kw))
            check(reading["bar_used"] <= 1.0,
                  f"{name} launch {i} on the path's activations: {reading}")
            ms = timed_ms(lambda: kernel(*args, **kw), 10, 2)
            plain_ms = timed_ms(lambda: plain(*args, **kw), 2, 1)
            if name == "qmm":
                # csrc/qmm_sm90.cu: a second launch, the same bits
                twice_same_bits(lambda: kernel(*args, **kw), out, f"qmm launch {i}")
                bnd, by = _bound(*_qmm_cost(args, out))
                alone, with_epilogue = _library_qmm(args)
                library_ms = timed_ms(with_epilogue, 5, 1)
                rows_out = args[7] is not None or args[8] is not None
                m, k, n = args[0].shape[0], args[0].shape[1], args[2].shape[0]
                # the GEMM alone: the same call writing its fp32 workspace
                # and no row pass
                gemm_ms = (timed_ms(lambda: kernel(*args[:7], None, None, torch.float32), 5, 1)
                           if rows_out else ms)
                plan = QM.qmm_sm90_plan(m, n, k, args[1].shape[-1])
                shape = {"m": m, "k": k, "n": n, "groups": args[1].shape[-1], "act": args[5],
                         "out": ("quant_out" if args[7] is not None
                                 else "ln_out" if args[8] is not None else "bf16"),
                         "bn": plan["bn"], "gemm_ms": gemm_ms, "row_pass_ms": ms - gemm_ms,
                         "int_mm_ms": timed_ms(alone, 5, 1)}
            elif name in ("quant_rows", "quant_rows_int4"):
                x = args[0]
                nbytes = x.numel() * (x.element_size() + 1) + x.shape[0] * 4
                library_ms, bnd, by = None, nbytes / PEAK_BYTES * 1e3, "bytes"
                shape = {"m": x.shape[0], "k": x.shape[1], "ln": bool(args[1])}
            else:  # the int8 attention entry points
                handoff = name == "flash_int8_handoff"
                kq, vq, h, scale = (args[2], args[4], args[6], args[7]) if handoff else (
                    args[1], args[3], args[5], args[6])
                b, n, cq = kq.shape
                cv = vq.shape[-1]
                int8_out = isinstance(out, tuple)
                q_bytes = 1 if handoff else args[0].element_size()
                out_bytes = 1 if int8_out else out.element_size()
                ops, nbytes = _attention_cost(b, n, cq, cv, h, q_bytes, out_bytes)
                bnd, by = _bound(ops, nbytes)
                library_ms = _sdpa_ms(b, n, cq, cv, h, scale)
                one = _int8_attention_batch1(name, args)
                shape = {"b": b, "n": n, "cq": cq, "cv": cv, "heads": h,
                         "bk": n // args[3 if handoff else 2].shape[-1],
                         "form": A8.int8_fwd_form(cq // h, cv // h), "int8_out": int8_out,
                         "packed_q": not handoff and len(args) > 7 and args[7] is not None,
                         "bound2_ms": _bound(_two_product_ops(b, n, cq, cv), nbytes)[0],
                         "ms_b1": timed_ms(lambda: kernel(*one, **kw), 10, 2),
                         "bound_b1_ms": _bound(*_attention_cost(1, n, cq, cv, h, q_bytes,
                                                                out_bytes))[0],
                         "library_b1_ms": _sdpa_ms(1, n, cq, cv, h, scale)}
        rows[name].append({"launch": i, **shape, "bar_used": reading["bar_used"],
                           "max_abs_err": reading["max_abs_err"], "ms": ms,
                           "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by,
                           "library_ms": library_ms})
        print(json.dumps({"int8_path_call": name, **rows[name][-1]}), flush=True)
    return rows


COUNTED = ("flash_mha_packed", "flash_mha_packed_sm90", "flash_mha_packed_f32", "flash_single",
           "flash_single_f32", "flash_mha_int8",
           "flash_mha_int8_sm90", "flash_mha_int8_qout", "flash_mha_int8_qout_sm90",
           "flash_int8_handoff", "flash_int8_handoff_sm90", "qmm", "quant_rows",
           "quant_rows_int4")


def reset_counts() -> None:
    from transparent_object_detection_tpu_torch.ops import attention as A
    from transparent_object_detection_tpu_torch.ops import attention_int8 as A8
    from transparent_object_detection_tpu_torch.ops import quant_matmul as QM

    for mod in (A, A8, QM):
        mod.reset_launch_counts()


def read_counts() -> dict:
    """Launches of every serving kernel since the last `reset_counts`."""
    from transparent_object_detection_tpu_torch.ops import attention as A
    from transparent_object_detection_tpu_torch.ops import attention_int8 as A8
    from transparent_object_detection_tpu_torch.ops import quant_matmul as QM

    return {"flash_mha_packed": A.flash_mha_packed.launches,
            "flash_mha_packed_sm90": A.flash_mha_packed.sm90_launches,
            "flash_mha_packed_f32": A.flash_mha_packed.f32_launches,
            "flash_single": A.flash_single.launches,
            "flash_single_f32": A.flash_single.f32_launches,
            **{name + sm90: getattr(getattr(A8, name), "sm90_launches" if sm90 else "launches")
               for name in ("flash_mha_int8", "flash_mha_int8_qout", "flash_int8_handoff")
               for sm90 in ("", "_sm90")},
            "qmm": QM.qmm.launches, "quant_rows": QM.quant_rows.launches,
            "quant_rows_int4": QM.quant_rows.launches_int4}


def int8_slice_phase(card: str, bf16_model, bf16_perf: dict):
    """The int8 model (int8_dense + int8_attn) at phi='s' 640x640 with the
    bf16 model's weights, through Predictor.detect_raw_batch; launch counts,
    parity with the same model on plain versions, timings and profile."""
    import numpy as np
    import torch

    from transparent_object_detection_tpu_torch.config import (
        Int8Variants,
        ModelConfig,
        PredictConfig,
    )
    from transparent_object_detection_tpu_torch.inference import Predictor
    from transparent_object_detection_tpu_torch.models.detector import (
        build_model,
        set_attention_impl,
    )
    from transparent_object_detection_tpu_torch.ops import quant_matmul as QM
    from transparent_object_detection_tpu_torch.ops.preprocess import letterbox_batch

    cfg, pcfg = ModelConfig(int8_dense=True, int8_attn=True), PredictConfig()
    # every variant at its JAX default, whatever the environment says
    model = build_model(cfg, device="cuda", seed=SEED, int8_variants=Int8Variants())
    model.load_state_dict(bf16_model.state_dict())  # the bf16 run's weights and biases
    predictor = Predictor(model, cfg, pcfg, device="cuda")
    rng = np.random.default_rng(SEED)
    raw = rng.integers(0, 256, size=(4, 480, 640, 3), dtype=np.uint8)
    shapes = np.tile(np.array([[480, 640]], np.float32), (4, 1))
    images = letterbox_batch(torch.as_tensor(raw, device="cuda").float() / 255.0,
                             cfg.input_shape)
    with torch.inference_mode():  # int8 against bf16 on the same weights: printed only
        dec8, dec16 = model(images)["decoded"], bf16_model(images)["decoded"]
        vs_bf16 = {"decoded_box_max_abs_px": float((dec8[..., :4] - dec16[..., :4]).abs().max()),
                   "decoded_box_mean_abs_px": float((dec8[..., :4] - dec16[..., :4]).abs().mean()),
                   "decoded_score_max_abs": float((dec8[..., 4:] - dec16[..., 4:]).abs().max())}
    with torch.no_grad():  # class biases for INT8_CANDIDATES_PER_IMAGE, as in the bf16 run
        towers = [getattr(model.head, f"cls{i}") for i in range(3)]
        for t in towers:
            t.out.bias.zero_()
        logits = torch.logit(model(images)["decoded"][..., 4:].amax(-1), eps=1e-6).flatten()
        shift = float(logits.topk(INT8_CANDIDATES_PER_IMAGE * len(raw)).values[-1])
        for t in towers:
            t.out.bias.fill_(-shift)

    # the main path, counted: counts to 0 just before, read just after
    reset_counts()
    dets = predictor.detect_raw_batch(raw, shapes)
    torch.cuda.synchronize()
    launches = read_counts()
    print(json.dumps({"int8_main_path_launches": launches}), flush=True)
    # batch 4: 4 TEBs x (qkv, attn_out, mlp1, mlp2), 3 quant_rows each (no
    # TEB reaches the LN handoff's 51,200 rows); int8 attention at h1, h2, h4
    # and dark3, naive bf16 at h6 (N = 400); no variant kernel
    expected = {**dict.fromkeys(COUNTED, 0), "flash_mha_int8_sm90": 4, "qmm": 16,
                "quant_rows": 12}
    check(launches == expected, f"int8 launches {launches}, expected {expected}")
    nd = dets["num_detections"].cpu()
    check(bool(torch.isfinite(dets["boxes"]).all()), "int8: non-finite boxes")
    check(bool((nd > 0).all()), f"int8: empty detections {nd.tolist()}")

    def run_plain():
        set_attention_impl(model, "plain")
        try:
            return model(images)["decoded"], predictor.detect_raw_batch(raw, shapes)
        finally:
            set_attention_impl(model, None)

    with torch.inference_mode():
        dec_k = model(images)["decoded"]
        dec_p, dets_p = run_plain()
        faulty = {}
        for fault in INT8_SLICE_REJECTS + ("qmm_group_width_halved",):
            with QMM_FAULTS[fault](QM):
                faulty[fault] = run_plain()
    check(dec_k.shape == (4, cfg.num_anchors, 4 + cfg.num_classes), "int8 decoded shape")
    check(bool(torch.isfinite(dec_k).all()), "int8: non-finite decoded")

    def against_plain(dec, d):
        score_diff = float((dec[..., 4:] - dec_p[..., 4:]).abs().max())
        return {"decoded_box_max_abs_px": float((dec[..., :4] - dec_p[..., :4]).abs().max()),
                "decoded_score_max_abs": score_diff,
                "num_detections": d["num_detections"].cpu().tolist(),
                "matched_in_plain": match_detections(d, dets_p, pcfg, score_diff),
                "plain_matched_here": match_detections(dets_p, d, pcfg, score_diff)}

    sound = against_plain(dec_k, dets)
    faults = {f: against_plain(*faulty[f]) for f in faulty}
    print(json.dumps({"int8_slice_parity": {
        "kernels": sound, "num_detections_plain": dets_p["num_detections"].cpu().tolist(),
        "planted_faults": faults, "int8_vs_bf16_not_bounded": vs_bf16,
        "limits": {"box_px": INT8_BOX_LIMIT_PX, "score": INT8_SCORE_LIMIT}}}), flush=True)
    check(sound["decoded_box_max_abs_px"] <= INT8_BOX_LIMIT_PX,
          f"int8 decoded boxes differ from the plain run by {sound['decoded_box_max_abs_px']}")
    check(sound["decoded_score_max_abs"] <= INT8_SCORE_LIMIT,
          f"int8 decoded scores differ from the plain run by {sound['decoded_score_max_abs']}")
    for key in ("matched_in_plain", "plain_matched_here"):
        m = sound[key]
        check(m["compared"] > 0 and m["unmatched"] == 0, f"int8 detection sets differ: {m}")
    for fault in INT8_SLICE_REJECTS:
        r = faults[fault]
        check(r["decoded_box_max_abs_px"] > INT8_BOX_LIMIT_PX or
              r["decoded_score_max_abs"] > INT8_SCORE_LIMIT,
              f"the int8 slice limits do not reject {fault}: {r}")

    rows = int8_path_calls(model, images[:2])

    # launches per forward at batch 1 and 32 (batch 32 reaches the LN handoff)
    per_batch = {}
    with torch.inference_mode():
        for b in (1, 32):
            img = images[:1].expand(b, -1, -1, -1).contiguous()
            reset_counts()
            model(img)
            per_batch[b] = read_counts()
    print(json.dumps({"int8_launches_per_forward": per_batch}), flush=True)

    perf = {"card": card, "model": "phi=s 640x640 int8_dense + int8_attn",
            **serving_timing(model, predictor, raw, shapes, images, rng),
            "bf16_same_run": {k: bf16_perf[k] for k in PERF_KEYS}}
    print(json.dumps({"int8_slice_perf": perf}), flush=True)
    return launches, rows, perf


PERF_KEYS = ("batch1_latency_ms_p50", "batch1_latency_ms_p75", "batch32_imgs_per_s",
             "batch32_forward_ms")


def serving_timing(model, predictor, raw, shapes, images, rng, iters: int = 3) -> dict:
    """Batch-1 latency (40 calls after 3 warm-ups, host clock) and forward;
    batch-32 throughput (`iters` calls after 1, host clock), forward and
    peak memory; a profile of one batch-32 forward, as the bf16 slice."""
    import numpy as np
    import torch

    from transparent_object_detection_tpu_torch.ops.preprocess import letterbox_batch

    with torch.inference_mode():
        one, one_shape = raw[:1], shapes[:1]
        for _ in range(3):
            predictor.detect_raw_batch(one, one_shape)
        torch.cuda.synchronize()
        lat = []
        for _ in range(40):
            t0 = time.perf_counter()
            predictor.detect_raw_batch(one, one_shape)["num_detections"].cpu()
            lat.append((time.perf_counter() - t0) * 1e3)
        lat.sort()
        fwd1 = timed_ms(lambda: model(images[:1]), 20, 3)
        raw32 = rng.integers(0, 256, size=(32, 480, 640, 3), dtype=np.uint8)
        shapes32 = np.tile(np.array([[480, 640]], np.float32), (32, 1))
        torch.cuda.reset_peak_memory_stats()
        predictor.detect_raw_batch(raw32, shapes32)["num_detections"].cpu()
        t0 = time.perf_counter()
        for _ in range(iters):
            predictor.detect_raw_batch(raw32, shapes32)["num_detections"].cpu()
        b32_s = (time.perf_counter() - t0) / iters
        img32 = letterbox_batch(torch.as_tensor(raw32, device="cuda").float() / 255.0,
                                predictor.model_cfg.input_shape)
        fwd32 = timed_ms(lambda: model(img32), iters, 1)
        peak = torch.cuda.max_memory_allocated() / 2**30
        profile = profile_forward(model, img32)
    return {"batch1_latency_ms_p50": lat[len(lat) // 2],
            "batch1_latency_ms_p75": lat[3 * len(lat) // 4],
            "batch1_latency_ms_min": lat[0], "batch1_forward_ms": fwd1,
            "batch32_imgs_per_s": 32 / b32_s, "batch32_step_ms": b32_s * 1e3,
            "batch32_forward_ms": fwd32, "peak_mem_gib_batch32": peak,
            "profile": {k: profile[k] for k in ("device_busy_ms", "idle_share",
                                                "by_class_ms")}}


def int8_kernel_entry(name, source, replaces, rows, launches, max_err):
    """One line of the kernels report: one batch-2 forward's launches of
    this kernel summed."""
    total = lambda key: sum(r[key] for r in rows)
    lib = [r["library_ms"] for r in rows]
    entry = {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches, "max_abs_err": max(max_err, max(r["max_abs_err"] for r in rows)),
        "ms": total("ms"), "plain_ms": total("plain_ms"), "bound_ms": total("bound_ms"),
        "bound_by": ("operations" if all(r["bound_by"] == "operations" for r in rows)
                     else "bytes" if all(r["bound_by"] == "bytes" for r in rows) else "mixed"),
        "library_ms": None if any(x is None for x in lib) else sum(lib),
    }
    # qmm: its GEMM and row pass apart, and torch._int_mm alone
    for key in ("gemm_ms", "row_pass_ms", "int_mm_ms"):
        if rows and all(key in r for r in rows):
            entry[key] = total(key)
    return {**entry, "shapes": rows}


I8_SRC = "transparent_object_detection_tpu_torch/csrc/flash_attn_int8.cu"
I8_SM90_SRC = "transparent_object_detection_tpu_torch/csrc/flash_int8_sm90.cu"


def int8_attention_entries(name, label, rows, launches, max_err, replaces):
    """The kernels-line entries of one int8 attention entry point: one for
    each kernel its launches took (`int8_fwd_form`): the sm90 kernel's rows
    and counter under csrc/flash_int8_sm90.cu, the mma_sync template's under
    csrc/flash_attn_int8.cu."""
    out = []
    for form, source, counter, tag in (("sm90", I8_SM90_SRC, name + "_sm90", ""),
                                       ("mma_sync", I8_SRC, name, " mma_sync")):
        mine = [r for r in rows if r["form"] == form]
        if mine:
            out.append(int8_kernel_entry(f"{name}{tag}{label}", source, replaces, mine,
                                         launches[counter], max_err))
    return out


# ---------------------------------------------------------------------------
# the int8 TEB's handoff variants: flash_mha_int8_qout, flash_int8_handoff,
# quant_rows with qmax 7 (w4a4)
# ---------------------------------------------------------------------------

# The neck's attention shapes (B, N, C, heads) at batch 2, phi='s' 640x640.
VARIANT_SHAPES = (("h1", (2, 1600, 2048, 8)), ("h2", (2, 6400, 1536, 6)),
                  ("h4", (2, 1600, 1536, 6)))
# Configuration A reaches the handoff and w4a4, B the attention quant_out.
VARIANT_CONFIGS = {
    "A": {"attn_handoff": True, "w4a4_mlp1": True},
    "B": {"attn_qout": True},
}
# Launches per forward, from the routing (models/blocks.py): the three neck
# TEBs with N > 1,024 take the variant's attention; w4a4 opens where B * N
# and the widths are multiples of 128 (batch 1: h2 only; batch 2: h1, h2, h4;
# batch 32: all four TEBs) and turns the LN handoff off; the LN handoff
# opens at batch 32 on h1, h2, h4 (B only). Each TEB runs 4 qmm; a bf16 input
# to qkv, attn_out or mlp1 runs quant_rows first.
VARIANT_EXPECTED = {
    "A": {1: dict(quant_rows=8, quant_rows_int4=1, qmm=16, flash_int8_handoff_sm90=3),
          2: dict(quant_rows=6, quant_rows_int4=3, qmm=16, flash_int8_handoff_sm90=3),
          32: dict(quant_rows=5, quant_rows_int4=4, qmm=16, flash_int8_handoff_sm90=3)},
    "B": {1: dict(quant_rows=9, qmm=16, flash_mha_int8_qout_sm90=3),
          2: dict(quant_rows=9, qmm=16, flash_mha_int8_qout_sm90=3),
          32: dict(quant_rows=6, qmm=16, flash_mha_int8_qout_sm90=3)},
}
# Slice limits of each configuration with kernels against the same
# configuration on plain versions, between the sound reading and those of
# the planted faults in VARIANT_SLICE_REJECTS on an H100 (PERF.md). B: the
# int8 limits. A: its int4-range steps are 18 times the int8 ones, so the
# last-bit differences kernel and plain carry from earlier layers move more
# activations across a rounding boundary: its scores read 3.7e-4 (0.259 px)
# against plain; a dropped K slab 1.27e-3 (0.591 px), the k/v requantize
# ratio dropped 9.3e-4 (0.375 px).
VARIANT_BOX_LIMIT_PX = {"A": 0.35, "B": 0.35}
VARIANT_SCORE_LIMIT = {"A": 6e-4, "B": 3e-4}
VARIANT_SLICE_REJECTS = ("qmm_k_slab_dropped",)


def match_per_anchor(dec_a, dec_b, pcfg) -> dict:
    """Detection sets of two runs' `decoded` (NMS as detect_step runs it,
    in letterboxed pixels), compared detection by detection: a detection
    of run a counts when its score clears the confidence by more than its
    own anchor's score difference between the runs (so it is a candidate in
    run b too), and is matched when run b keeps a same-class box at IoU >=
    0.75 * nms_iou with it (itself, or the box that suppressed it). The
    global largest difference, the margin of `match_detections`, can exceed
    every detection's clearance: then nothing would be compared."""
    import torch

    from transparent_object_detection_tpu_torch.ops.geometry import pairwise_iou, xywh2xyxy
    from transparent_object_detection_tpu_torch.ops.nms import batched_nms

    def nms(dec):
        return batched_nms(xywh2xyxy(dec[..., :4]), dec[..., 4:], conf_thres=pcfg.confidence,
                           iou_thres=pcfg.nms_iou, max_detections=pcfg.max_detections,
                           pre_nms_topk=pcfg.pre_nms_topk, mode=pcfg.nms_mode,
                           class_agnostic=pcfg.class_agnostic)

    da, db = nms(dec_a), nms(dec_b)
    boxes_a = xywh2xyxy(dec_a[..., :4])  # (B, A, 4)
    cls_a = da["classes"].clamp(min=0)
    # each detection's anchor: the one whose box and class score it carries
    score_at = torch.gather(dec_a[..., 4:], 2, cls_a[:, None, :].expand(-1, dec_a.shape[1], -1))
    dist = ((boxes_a[:, :, None, :] - da["boxes"][:, None, :, :]).abs().sum(-1)
            + (score_at - da["scores"][:, None, :]).abs())  # (B, A, D)
    anchor = dist.argmin(dim=1)  # (B, D)
    cls_scores = lambda dec: torch.gather(
        torch.gather(dec[..., 4:], 1, anchor[..., None].expand(-1, -1, dec.shape[-1] - 4)),
        2, cls_a[..., None])[..., 0]
    margin = (cls_scores(dec_a) - cls_scores(dec_b)).abs()
    sel = da["valid"] & (da["scores"] > pcfg.confidence + margin)
    same = (da["classes"][:, :, None] == db["classes"][:, None, :]) & db["valid"][:, None, :]
    iou = pairwise_iou(da["boxes"].float(), db["boxes"].float())
    best = torch.where(same, iou, torch.zeros_like(iou)).amax(dim=-1)
    return {"detections": da["num_detections"].tolist(),
            "compared": int(sel.sum()), "identical": int((sel & (best >= 0.9)).sum()),
            "unmatched": int((sel & (best < 0.75 * pcfg.nms_iou)).sum()),
            "anchor_found_exactly": bool((dist.amin(dim=1)[da["valid"]] == 0).all())}


def _quant_per_head(o, heads):
    """fp32 (B, N, C) -> the int8 per-(row, head) output of the variants."""
    from transparent_object_detection_tpu_torch.ops import attention_int8 as A8

    return A8._quantize_heads(A8._split_heads(o.float(), heads))


def _out_scale_per_row(o, heads):
    """Planted fault: one output scale per row over all heads, written into
    every head's column."""
    import torch

    amax = torch.clamp(o.float().abs().amax(-1, keepdim=True), min=1e-30)
    payload = torch.round(o.float() * (torch.full_like(amax, 127.0) / amax)).to(torch.int8)
    return payload, (amax * (1.0 / 127.0)).expand(*o.shape[:2], heads).contiguous()


def _requantize_ratio_dropped(payload, scales, col0, c, heads, bk, requantize=None):
    """Planted fault: the k/v section kept as it is, under the block's
    largest row scale (the requantize ratio dropped)."""
    from transparent_object_detection_tpu_torch.ops import attention_int8 as A8

    _, s_blk = (requantize or A8.requantize_section)(payload, scales, col0, c, heads, bk)
    return payload[..., col0:col0 + c].contiguous(), s_blk


def _qkv_payload(gen, b, n, c, qk_std, group):
    """A qkv projection's int8 output as the handoff gets it: random values
    (q and k at std qk_std) quantized per (row, group of `group` columns)."""
    import torch

    from transparent_object_detection_tpu_torch.ops import quant_matmul as QM

    qkv = torch.randn(b, n, 3 * c, generator=gen, device=DEVICE)
    qkv[..., :2 * c] *= qk_std
    return QM._output_plain(qkv, None, group, None)


def _attention_cost(b, n, cq, cv, h, q_bytes, out_bytes):
    """(operations, bytes) of one int8 attention call: the three int8
    products the function needs (q.k^T for the block max, again for p, and
    p.v: the max comes before any p), q (int8 plus its scale table, or bf16),
    k/v int8 and their scales read once, the output (int8 plus scales, or
    bf16) written once. `_two_product_ops` counts a bf16 flash's two."""
    ops = 2.0 * b * n * n * (2 * cq + cv)
    scales = 4 * b * n * h if q_bytes == 1 else 0
    out_scales = 4 * b * n * h if out_bytes == 1 else 0
    nbytes = (b * n * cq * q_bytes + scales + b * n * (cq + cv) + 8 * b * h
              + b * n * cv * out_bytes + out_scales)
    return ops, nbytes


def _two_product_ops(b, n, cq, cv):
    return 2.0 * b * n * n * (cq + cv)


def _int8_attention_batch1(name, args):
    """The arguments of an int8 attention call cut to its first image."""
    first = 6 if name == "flash_int8_handoff" else 5
    return tuple(a[:1] for a in args[:first]) + tuple(args[first:])


def _bound(ops, nbytes):
    """(ms, what bounds it) of int8 work: operations at the int8 peak or
    bytes at the memory rate."""
    t_ops, t_bytes = ops / PEAK_INT8_OPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def _sdpa_ms(b, n, cq, cv, h, scale):
    """bf16 SDPA on the same shapes: the yardstick (never called by the port)."""
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    q, k = (torch.randn(b, h, n, cq // h, generator=gen, device=DEVICE).bfloat16()
            for _ in range(2))
    v = torch.randn(b, h, n, cv // h, generator=gen, device=DEVICE).bfloat16()
    return timed_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=scale), 10, 2)


def _hold(what, out, ref, faults: dict, record: dict, spread_faults=()) -> dict:
    """The int8 bars on a kernel's outputs against its plain version's; each
    planted fault's output must break them (those in `spread_faults` on at
    least one input spread: the caller checks). Prints the reading."""
    reading = int8_reading(out, ref)
    reading["faults_bar_used"] = {f: int8_reading(fn(), ref)["bar_used"] for f, fn in faults.items()}
    print(json.dumps({"check": what, **record, **reading}), flush=True)
    check(reading["bar_used"] <= 1.0, f"{what}: kernel off the bar {reading}")
    for f, used in reading["faults_bar_used"].items():
        check(used > 1.0 or f in spread_faults,
              f"{what}: the bar does not reject {f} ({used:.3g}x)")
    return reading


def variant_kernel_phase(shrink: int = 1) -> dict:
    """flash_mha_int8_qout, flash_int8_handoff (quant_out and bf16 out, G = 1
    and G = 12 scale tables) and quant_rows(qmax=7) against their plain
    versions on synthetic inputs at the neck's shapes at batch 2, plus one
    4-key-block case each, at score std 1 and 4, with the int8 bars and
    planted faults they must reject. Times each beside its bound, its plain
    version and bf16 SDPA. Returns per kernel the largest value error and
    prints the timing rows. `shrink` divides the token and row counts."""
    import torch

    from transparent_object_detection_tpu_torch.ops import attention_int8 as A8
    from transparent_object_detection_tpu_torch.ops import quant_matmul as QM

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 3)
    err = {"flash_mha_int8_qout": 0.0, "flash_int8_handoff": 0.0, "quant_rows_int4": 0.0}
    rows = {k: [] for k in err}
    qk_std = lambda score_std, scale, d: (score_std / (scale * d ** 0.5)) ** 0.5
    cases = [(name, shape, None) for name, shape in VARIANT_SHAPES]
    cases.append(("h2 widths, 4 key blocks", (1, 6400, 1536, 6), 4))
    for name, (b, n, c, h), nk in cases:
        n //= shrink
        scale = (c // h) ** -0.5
        bk = A8.pick_blocks(n, c, h)[1] if nk is None else n // nk
        rejected = False  # p on a running 64-key max, on some input spread
        for score_std in SCORE_STDS:
            record = {"b": b, "n": n, "c": c, "heads": h, "bk": bk, "score_std": score_std}
            # qout: bf16 q read in place from the packed qkv, k/v quantized per block
            qkv = torch.randn(b, n, 3 * c, generator=gen, device=DEVICE)
            qkv[..., :2 * c] *= qk_std(score_std, scale, c // h)
            qkv = qkv.bfloat16()
            k, v = qkv[..., c:2 * c], qkv[..., 2 * c:]
            kq, ks = A8.quantize_kv(k, h, bk)
            vq, vs = A8.quantize_kv(v, h, bk)
            args = (qkv, kq, ks, vq, vs, h, scale, c)
            out = A8.flash_mha_int8_qout(*args)
            torch.cuda.synchronize()
            if A8.int8_fwd_form(c // h, c // h) == "sm90":
                twice_same_bits(lambda: A8.flash_mha_int8_qout(*args), out,
                                f"flash_mha_int8_qout {name}")
            ref = A8.flash_mha_int8_qout_plain(*args)
            qc = qkv[..., :c]
            faults = {
                "out_scale_per_row": lambda: _out_scale_per_row(
                    int8_attention_reference(qc, k, v, h, scale, bk, bk, torch.float32), h),
                "p_rounded_on_running_64_key_max": lambda: _quant_per_head(
                    int8_attention_reference(qc, k, v, h, scale, bk, 64, torch.float32), h),
            }
            r = _hold(f"flash_mha_int8_qout {name}", out, ref, faults, record,
                      spread_faults=("p_rounded_on_running_64_key_max",))
            rejected |= r["faults_bar_used"]["p_rounded_on_running_64_key_max"] > 1.0
            reference = int8_reading(_quant_per_head(int8_attention_reference(
                qc, k, v, h, scale, bk, bk, torch.float32), h), ref)["bar_used"]
            check(reference <= 1.0, f"flash_mha_int8_qout {name}: the fault reference is "
                                    f"not the plain function ({reference})")
            err["flash_mha_int8_qout"] = max(err["flash_mha_int8_qout"], r["max_abs_err"])
            if score_std == SCORE_STDS[-1] and nk is None:
                ops, nbytes = _attention_cost(b, n, c, c, h, 2, 1)
                bnd, by = _bound(ops, nbytes)
                one = _int8_attention_batch1("flash_mha_int8_qout", args)
                rows["flash_mha_int8_qout"].append(dict(
                    node=name, **record, form=A8.int8_fwd_form(c // h, c // h),
                    ms=timed_ms(lambda: A8.flash_mha_int8_qout(*args), 10),
                    ms_b1=timed_ms(lambda: A8.flash_mha_int8_qout(*one), 10),
                    plain_ms=timed_ms(lambda: A8.flash_mha_int8_qout_plain(*args), 2, 1),
                    bound_ms=bnd, bound_by=by,
                    bound2_ms=_bound(_two_product_ops(b, n, c, c), nbytes)[0],
                    library_ms=_sdpa_ms(b, n, c, c, h, scale), max_abs_err=r["max_abs_err"]))

            # handoff: the int8 qkv payload with one scale group per row (G = 1) or
            # per 512 columns (G = 12 at C = 2,048; 1,536 columns hold 3 groups)
            path_group = QM.quant_out_group_width(b * n * shrink, c, 3 * c, 0,
                                                  align=(c, c // h))
            for group in (3 * c, 512):
                payload, scales = _qkv_payload(gen, b, n, c, qk_std(score_std, scale, c // h),
                                               group)
                g_rec = {**record, "groups": scales.shape[-1]}
                qs = A8.q_scale_table(scales, c, h)
                kq, ks = A8.requantize_section(payload, scales, c, c, h, bk)
                vq, vs = A8.requantize_section(payload, scales, 2 * c, c, h, bk)
                wrong_qs = qs.roll(1, dims=-1)
                k_fault = _requantize_ratio_dropped(payload, scales, c, c, h, bk)
                for quant_out in (True, False):
                    hargs = (payload, qs, kq, ks, vq, vs, h, scale, quant_out)
                    out = A8.flash_int8_handoff(*hargs)
                    torch.cuda.synchronize()
                    if A8.int8_fwd_form(c // h, c // h) == "sm90":
                        twice_same_bits(lambda: A8.flash_int8_handoff(*hargs), out,
                                        f"flash_int8_handoff {name} quant_out={quant_out}")
                    ref = A8.flash_int8_handoff_plain(*hargs)
                    faults = {
                        "kv_requantize_ratio_dropped": lambda: A8.flash_int8_handoff_plain(
                            payload, qs, *k_fault, vq, vs, h, scale, quant_out),
                    }
                    if group < 3 * c:  # with one scale a row every head has the same
                        faults["q_scale_from_wrong_head"] = lambda: A8.flash_int8_handoff_plain(
                            payload, wrong_qs, kq, ks, vq, vs, h, scale, quant_out)
                    if quant_out:
                        faults["out_scale_per_row"] = lambda: _out_scale_per_row(
                            A8.flash_int8_handoff_plain(payload, qs, kq, ks, vq, vs, h, scale,
                                                        False, torch.float32), h)
                    r = _hold(f"flash_int8_handoff {name} quant_out={quant_out}", out, ref,
                              faults, {**g_rec, "quant_out": quant_out})
                    err["flash_int8_handoff"] = max(err["flash_int8_handoff"], r["max_abs_err"])
                    if (score_std == SCORE_STDS[-1] and nk is None and quant_out
                            and group == path_group):  # as the TEB route runs it
                        ops, nbytes = _attention_cost(b, n, c, c, h, 1, 1)
                        bnd, by = _bound(ops, nbytes)
                        one = _int8_attention_batch1("flash_int8_handoff", hargs)
                        rows["flash_int8_handoff"].append(dict(
                            node=name, **g_rec, form=A8.int8_fwd_form(c // h, c // h),
                            ms=timed_ms(lambda: A8.flash_int8_handoff(*hargs), 10),
                            ms_b1=timed_ms(lambda: A8.flash_int8_handoff(*one), 10),
                            plain_ms=timed_ms(lambda: A8.flash_int8_handoff_plain(*hargs), 2, 1),
                            bound_ms=bnd, bound_by=by,
                            bound2_ms=_bound(_two_product_ops(b, n, c, c), nbytes)[0],
                            library_ms=_sdpa_ms(b, n, c, c, h, scale),
                            max_abs_err=r["max_abs_err"]))
        check(rejected or shrink > 1, f"flash_mha_int8_qout {name}: the bar rejects p rounded "
                                      "on a running 64-key max on no input spread")

    # quant_rows(qmax=7) and the w4a4 qmm at the mlp1 shapes (LN, gelu,
    # quant_out one scale per row): h1, h2, h4 at batch 2
    for name, (b, n, c, h) in VARIANT_SHAPES:
        m = b * n // shrink
        x = (torch.randn(m, c, generator=gen, device=DEVICE) * 2 + 0.5).bfloat16()
        readings, _ = _qmm_case(f"{name} w4a4 mlp1 batch 2", x, None, m, c, 4 * c, 0, "gelu",
                                False, group=4 * c, ln=True, qmax=7)
        err["quant_rows_int4"] = max(err["quant_rows_int4"],
                                     readings["quant_rows"]["max_abs_err"])
        bnd, by = _bound(0.0, x.numel() * 3 + m * 4)
        rows["quant_rows_int4"].append(dict(
            node=name, m=m, k=c, ln=True,
            ms=timed_ms(lambda: QM.quant_rows(x, True, qmax=7), 10),
            plain_ms=timed_ms(lambda: QM.quant_rows_plain(x, True, qmax=7), 2, 1),
            bound_ms=bnd, bound_by=by, library_ms=None,
            max_abs_err=readings["quant_rows"]["max_abs_err"]))
    for key, rs in rows.items():
        for r in rs:
            print(json.dumps({"variant_kernel": key, **r}), flush=True)
    return err


def variant_slice_phase(card: str, bf16_model, same_run: dict) -> dict:
    """Configurations A and B (VARIANT_CONFIGS) of the int8 model with the
    bf16 model's weights through Predictor.detect_raw_batch: launches per
    forward counted at batch 32 and 1 (the main path) and asserted; `decoded`
    and the detection sets against the same configuration on plain versions,
    with limits a planted fault must break; every launch of one batch-2
    forward against its plain version, timed; timings beside the default int8
    and bf16 paths of this run (`same_run`); a profile at batch 32."""
    import numpy as np
    import torch

    from transparent_object_detection_tpu_torch.config import (
        Int8Variants,
        ModelConfig,
        PredictConfig,
    )
    from transparent_object_detection_tpu_torch.inference import Predictor
    from transparent_object_detection_tpu_torch.models.detector import (
        build_model,
        set_attention_impl,
    )
    from transparent_object_detection_tpu_torch.ops import attention_int8 as A8
    from transparent_object_detection_tpu_torch.ops import quant_matmul as QM
    from transparent_object_detection_tpu_torch.ops.preprocess import letterbox_batch

    cfg, pcfg = ModelConfig(int8_dense=True, int8_attn=True), PredictConfig()
    rng = np.random.default_rng(SEED)
    raw = rng.integers(0, 256, size=(4, 480, 640, 3), dtype=np.uint8)
    shapes = np.tile(np.array([[480, 640]], np.float32), (4, 1))
    raw32 = rng.integers(0, 256, size=(32, 480, 640, 3), dtype=np.uint8)
    shapes32 = np.tile(np.array([[480, 640]], np.float32), (32, 1))
    images = letterbox_batch(torch.as_tensor(raw, device=DEVICE).float() / 255.0,
                             cfg.input_shape)
    # the planted fault of each configuration's own route, read besides
    variant_fault = {
        "A": ("kv_requantize_ratio_dropped", A8, "requantize_section",
              lambda real: lambda *args: _requantize_ratio_dropped(*args, requantize=real)),
        "B": ("out_scale_per_row", A8, "_quantize_heads",
              lambda real: lambda o: _out_scale_per_row(A8._merge_heads(o), o.shape[1])),
    }
    results, failed = {}, []
    for tag, fields in VARIANT_CONFIGS.items():
        variants = Int8Variants(**fields)
        model = build_model(cfg, device=DEVICE, seed=SEED, int8_variants=variants)
        model.load_state_dict(bf16_model.state_dict())
        predictor = Predictor(model, cfg, pcfg, device=DEVICE)
        with torch.no_grad():  # class biases as the int8 slice sets them
            towers = [getattr(model.head, f"cls{i}") for i in range(3)]
            for t in towers:
                t.out.bias.zero_()
            logits = torch.logit(model(images)["decoded"][..., 4:].amax(-1), eps=1e-6).flatten()
            shift = float(logits.topk(INT8_CANDIDATES_PER_IMAGE * len(raw)).values[-1])
            for t in towers:
                t.out.bias.fill_(-shift)

        # the main path, counted: counts to 0 just before, read just after
        launches = {}
        for b, (r, sh) in ((32, (raw32, shapes32)), (1, (raw[:1], shapes[:1]))):
            reset_counts()
            dets_b = predictor.detect_raw_batch(r, sh)
            torch.cuda.synchronize()
            launches[b] = read_counts()
            expected = {**dict.fromkeys(COUNTED, 0), "flash_mha_int8_sm90": 1,
                        **VARIANT_EXPECTED[tag][b]}
            check(launches[b] == expected,
                  f"configuration {tag} batch {b}: launches {launches[b]}, expected {expected}")
            check(bool(torch.isfinite(dets_b["boxes"]).all()), f"{tag}: non-finite boxes")
        print(json.dumps({"variant_main_path_launches": {"config": tag, **variants.__dict__,
                                                         "per_forward": launches}}), flush=True)

        def run_plain():
            set_attention_impl(model, "plain")
            try:
                return model(images)["decoded"], predictor.detect_raw_batch(raw, shapes)
            finally:
                set_attention_impl(model, None)

        with torch.inference_mode():
            dets = predictor.detect_raw_batch(raw, shapes)
            dec_k = model(images)["decoded"]
            dec_p, dets_p = run_plain()
            faulty = {}
            for fault in VARIANT_SLICE_REJECTS:
                with QMM_FAULTS[fault](QM):
                    faulty[fault] = run_plain()
            name, mod, attr, make = variant_fault[tag]
            with _patched(mod, attr, make(getattr(mod, attr))):
                faulty[name] = run_plain()
        check(bool((dets["num_detections"] > 0).all()),  # the images the biases were set on
              f"{tag}: empty detections {dets['num_detections'].tolist()}")
        if not bool((dets["num_detections"] < pcfg.max_detections).all()):
            failed.append(f"{tag}: max_detections cut the detections; the sets are not "
                          f"comparable: {dets['num_detections'].tolist()}")
        check(dec_k.shape == (4, cfg.num_anchors, 4 + cfg.num_classes), f"{tag}: decoded shape")
        check(bool(torch.isfinite(dec_k).all()), f"{tag}: non-finite decoded")

        def against_plain(dec, d):
            return {"decoded_box_max_abs_px": float((dec[..., :4] - dec_p[..., :4]).abs().max()),
                    "decoded_score_max_abs": float((dec[..., 4:] - dec_p[..., 4:]).abs().max()),
                    "num_detections": d["num_detections"].cpu().tolist(),
                    "matched_in_plain": match_per_anchor(dec, dec_p, pcfg),
                    "plain_matched_here": match_per_anchor(dec_p, dec, pcfg)}

        sound = against_plain(dec_k, dets)
        faults = {f: against_plain(*faulty[f]) for f in faulty}
        limits = {"box_px": VARIANT_BOX_LIMIT_PX[tag], "score": VARIANT_SCORE_LIMIT[tag]}
        print(json.dumps({"variant_slice_parity": {
            "config": tag, "kernels": sound,
            "num_detections_plain": dets_p["num_detections"].cpu().tolist(),
            "planted_faults": faults, "limits": limits}}), flush=True)
        # read both configurations before failing on a limit
        if sound["decoded_box_max_abs_px"] > limits["box_px"]:
            failed.append(f"{tag}: decoded boxes differ from plain by "
                          f"{sound['decoded_box_max_abs_px']}")
        if sound["decoded_score_max_abs"] > limits["score"]:
            failed.append(f"{tag}: decoded scores differ from plain by "
                          f"{sound['decoded_score_max_abs']}")
        for key in ("matched_in_plain", "plain_matched_here"):
            m = sound[key]
            if not (m["compared"] > 0 and m["unmatched"] == 0):
                failed.append(f"{tag}: detection sets differ: {key} {m}")
        for fault in VARIANT_SLICE_REJECTS:
            r = faults[fault]
            if not (r["decoded_box_max_abs_px"] > limits["box_px"] or
                    r["decoded_score_max_abs"] > limits["score"]):
                failed.append(f"{tag}: the slice limits do not reject {fault}: {r}")
        del dec_k, dec_p, dets_p, faulty

        # every launch of one batch-2 forward against its plain version, timed
        rows = int8_path_calls(model, images[:2])
        got = {k: len(v) for k, v in rows.items() if v}
        want = {k.removesuffix("_sm90"): v for k, v in
                {"flash_mha_int8": 1, **VARIANT_EXPECTED[tag][2]}.items() if v}
        check(got == want, f"{tag}: batch-2 launches {got}, expected {want}")

        perf = {"card": card, "model": f"phi=s 640x640 int8_dense + int8_attn, config {tag}",
                "variants": variants.__dict__,
                **serving_timing(model, predictor, raw, shapes, images, rng),
                "same_run": same_run}
        print(json.dumps({"variant_slice_perf": perf}), flush=True)
        results[tag] = {"launches": launches, "rows": rows, "perf": perf}
        del model, predictor
        torch.cuda.empty_cache()
    check(not failed, "; ".join(failed))
    return results


# ---------------------------------------------------------------------------
# training: flash_fwd_lse, flash_bwd_dq, flash_bwd_dkv and the train step
# ---------------------------------------------------------------------------

# Gradient bar: the kernel bar per element, and besides it
# ||kernel - plain|| / ||plain|| <= TRAIN_NORM_RTOL. Kernels and plain
# versions round P and dS to bf16 at the same points, so their sums differ in
# order only; a fault that scales a gradient by 1% everywhere (lse off by
# 0.01) stays under a per-element bar a bf16 ulp wide but not under this one.
TRAIN_NORM_RTOL = 2e-3
LSE_ATOL = 1e-3  # lse is fp32; kernel and plain sum l in another order
# name -> (B, N, q/k width, v width, heads): the training path at batch 2
TRAIN_SHAPES = {"h1": (2, 1600, 2048, 2048, 8), "h2": (2, 6400, 1536, 1536, 6),
                "h4": (2, 1600, 1536, 1536, 6), "dark3": (2, 6400, 64, 512, 1),
                "ragged": (2, 3600, 1536, 1536, 6), "ragged_single": (2, 3600, 64, 512, 1)}
TRAIN_BATCH = 16  # the JAX bench_train.py default
TRAIN_LR = 1e-3
# Limits of one batch-2 train step with kernels against the same step with
# the plain versions, from the same weights (global relative errors, see
# compare_steps). The gradient and update limits lie between the sound
# reading (gradients 0.364, parameter and EMA change 0.359) and that of the
# planted fault in TRAIN_SLICE_REJECTS (3.99, 1.095) on an H100 (PERF.md);
# no planted backward fault moves the losses or the BatchNorm statistics,
# whose limits sit above the sound reading (1.2e-3, 6.4e-3).
TRAIN_GRAD_LIMIT = 1.0
TRAIN_UPDATE_LIMIT = 0.6
TRAIN_LOSS_LIMIT = 1e-2
TRAIN_STATS_LIMIT = 0.05
TRAIN_SLICE_REJECTS = ("D_term_dropped",)
TRAIN_SLICE_FAULTS = ("D_term_dropped", "lse_off_by_0.01")


def grad_reading(out, ref, f32: bool = False) -> dict:
    """The gradient bar: the kernel bar per element (fp32: the fp32 bar) and
    the norm of the difference (fp32: F32_TRAIN_NORM_RTOL)."""
    diff = (out.float() - ref.float())
    norm_rel = float(diff.norm() / ref.float().norm().clamp(min=1e-30))
    per_elem = _f32_bar_used(out, ref) if f32 else bar_used(out, ref)
    tol = F32_TRAIN_NORM_RTOL if f32 else TRAIN_NORM_RTOL
    return {"bar_used": max(per_elem, norm_rel / tol), "elem_bar_used": per_elem,
            "norm_rel": norm_rel, "max_abs_err": float(diff.abs().max())}


def _train_inputs(gen, b, n, cq, cv, h, score_std):
    """q, k, v (column views of one packed qkv when h > 1) and dO, bf16."""
    import torch

    randn = lambda *s: torch.randn(*s, generator=gen, device=DEVICE)
    scale = (cq // h) ** -0.5 if h > 1 else 1.0
    std = (score_std / (scale * (cq // h) ** 0.5)) ** 0.5
    if h > 1:
        qkv = randn(b, n, 3 * cq)
        qkv[..., :2 * cq] *= std
        qkv = qkv.bfloat16()
        q, k, v = qkv[..., :cq], qkv[..., cq:2 * cq], qkv[..., 2 * cq:]
    else:
        q, k = ((randn(b, n, cq) * std).bfloat16() for _ in range(2))
        v = randn(b, n, cv).bfloat16()
    return q, k, v, randn(b, n, cv).bfloat16(), scale


def _drop_rows(t, lo=64, hi=128):
    """t without rows lo..hi-1 of its token axis (-2 for (.., N, 1) stats)."""
    import torch

    axis = 1 if t.dim() == 3 and t.shape[-1] != 1 else t.dim() - 2
    keep = torch.ones(t.shape[axis], dtype=torch.bool, device=t.device)
    keep[lo:hi] = False
    return t[(slice(None),) * axis + (keep,)]


def _fwd_faults(V, q, k, v, scale, h):
    """The plain forward with a planted fault: what a kernel that made that
    mistake would return (out, lse). The faults of the sm90 kernel's TMA
    ring too: a key tile read twice and its neighbour never, and (ragged N
    only) the zero-filled keys past N scored 0, which lse shows at any
    spread."""
    out_tile = V.flash_fwd_lse_plain(q, k, v, scale, h)
    out_tile[0][:, 64:128] = 0
    out_tile[1][..., 64:128, :] = 0
    faults = {
        "kv_tile_dropped": V.flash_fwd_lse_plain(q, _drop_rows(k), _drop_rows(v), scale, h),
        "softmax_scale_x1.02": V.flash_fwd_lse_plain(q, k, v, scale * 1.02, h),
        "query_tile_unwritten": out_tile,
        "key_tile_used_twice": V.flash_fwd_lse_plain(q, _tile_twice(k), _tile_twice(v), scale,
                                                     h)}
    if q.shape[1] % 64:  # (B, N, C): keys on axis -2
        faults["keys_past_n_scored_zero"] = V.flash_fwd_lse_plain(q, _pad_keys(k), _pad_keys(v),
                                                                   scale, h)
    if V.lse_fwd_form(q.shape[-1] // h, v.shape[-1] // h, h, q.dtype) == "f32_sm90":
        faults.update(_f32_fwd_faults(V, q, k, v, scale, h))
    return faults


def _last_tile_max_gain(V, q, k, scale, h, tile=64):
    """Per query row, how far the exp2-domain row max rises in the last key
    tile: max over all keys less max over the keys before the last tile,
    shaped like lse."""
    import torch

    qh, kh = (V._split_heads(t, h).float() for t in (q, k))
    n = k.shape[1]
    last = (n - 1) // tile * tile
    gain = torch.empty(qh.shape[:-1] + (1,), device=q.device)
    for i in range(0, n, 1024):
        s = torch.matmul(qh[..., i:i + 1024, :], kh.transpose(-1, -2)) * (scale * V.A.LOG2E)
        gain[..., i:i + 1024, :] = (s.amax(-1, keepdim=True)
                                    - s[..., :last].amax(-1, keepdim=True))
    return gain if h > 1 else gain[:, 0]


def _f32_fwd_faults(V, q, k, v, scale, h):
    """The faults of csrc/flash_fwd_f32_sm90.cu in (out, lse): the low parts
    dropped from S or from P.V, V^T's key order undone, and lse written
    with the running max of the tile before the last."""
    real = V.A._online_softmax
    V.A._online_softmax = _online_softmax_pv_tf32
    try:
        pv = V.flash_fwd_lse_plain(q, k, v, scale, h)
    finally:
        V.A._online_softmax = real
    out, lse = V.flash_fwd_lse_plain(q, k, v, scale, h)
    return {"s_lo_terms_dropped": V.flash_fwd_lse_plain(_tf32(q), _tf32(k), v, scale, h),
            "pv_lo_terms_dropped": pv,
            "v_key_order_undone": V.flash_fwd_lse_plain(q, k, _v_key_order_undone_of(v), scale,
                                                        h),
            "lse_from_previous_tile_max": (out, lse - _last_tile_max_gain(V, q, k, scale, h)
                                           * V.A.LN2)}


def _stale_p_dk(V, q, k, v, do, lse, dcap, scale, h, tile=64):
    """dk of the plain backward with each query tile's dS^T formed from the
    P^T of the tile before it (the first tile its own): what the sm90 dk/dv
    kernel computes if the hand-over of P^T between its warpgroups lost a
    barrier."""
    import torch

    qh, kh, vh, doh = (V._split_heads(t, h).float() for t in (q, k, v, do))
    lse4, d4 = V._stats4(lse, h).float(), V._stats4(dcap, h).float()
    s_scale, n = scale * V.A.LOG2E, q.shape[1]
    dk = torch.zeros_like(kh)
    for i in range(0, n, 1024):
        rows = torch.arange(i, min(i + 1024, n), device=q.device)
        prev = torch.where(rows >= tile, rows - tile, rows)
        p_prev = torch.exp2(qh[..., prev, :] @ kh.transpose(-1, -2) * s_scale
                            - lse4[..., prev, :] * V.A.LOG2E)
        dp = doh[..., rows, :] @ vh.transpose(-1, -2)
        ds = p_prev * (dp - d4[..., rows, :]) * scale
        dk += ds.to(q.dtype).float().transpose(-1, -2) @ qh[..., rows, :]
    return V.A._heads_last(dk).to(k.dtype)


def _bwd_faults(V, q, k, v, do, lse, dcap, scale, h):
    """The plain backward with a planted fault -> {fault: {grad: value}}.
    Where `bwd_form` sends the call to the sm90 kernels, also the faults
    their ring and hand-over can commit: a key tile read twice in dq and a
    query tile read twice in dk/dv, each with its neighbour never read, and
    dS^T formed with the previous query tile's P^T."""
    import torch

    dq = lambda *a: {"dq": V.flash_bwd_dq_plain(*a, scale, h)}
    dkv = lambda *a: dict(zip(("dk", "dv"), V.flash_bwd_dkv_plain(*a, scale, h)))
    both = lambda *a: {**dq(*a), **dkv(*a)}
    faults = {
        "key_tile_skipped_in_dq": dq(q, _drop_rows(k), _drop_rows(v), do, lse, dcap),
        "query_tile_skipped_in_dkv": dkv(_drop_rows(q), k, v, _drop_rows(do), _drop_rows(lse),
                                         _drop_rows(dcap)),
        "D_term_dropped": both(q, k, v, do, lse, torch.zeros_like(dcap)),
        "lse_off_by_0.01": both(q, k, v, do, lse + 0.01, dcap),
    }
    if h > 1:  # dark3's scale is 1
        sound = both(q, k, v, do, lse, dcap)
        faults["scale_missing_from_dS"] = {"dq": sound["dq"] / scale, "dk": sound["dk"] / scale}
    form = V.bwd_form(q.shape[-1] // h, v.shape[-1] // h, h, q.dtype)
    if form in ("sm90", "f32_sm90", "single_sm90"):  # the same ring and hand-over
        tiles = (64, 64)
        if form == "single_sm90":  # its plans' token tiles
            plans = V.bwd_single_sm90_plan(q.shape[-1], v.shape[-1])
            tiles = (plans["dq"]["tile"], plans["dkv"]["tile"])
        faults.update(_sm90_bwd_faults(V, q, k, v, do, lse, dcap, scale, h, *tiles))
    if form == "f32_sm90":
        faults.update(_f32_bwd_faults(V, q, k, v, do, lse, dcap, scale, h))
    if form == "single_sm90":
        faults.update(_single_bwd_faults(V, q, k, v, do, lse, dcap, scale, h))
    return faults


def _next_row_columns(t, width):
    """(B, N, d) -> (B, N, width): each row continued past d by the next
    row's first columns (zeros past the last), as a tensor map of the
    rounded-up width would read a contiguous array."""
    import torch

    b, n, d = t.shape
    flat = torch.cat([t.reshape(b, n * d), t.new_zeros(b, width)], dim=1)
    idx = (torch.arange(n, device=t.device)[:, None] * d
           + torch.arange(width, device=t.device)[None, :])
    return flat[:, idx]


def _single_bwd_faults(V, q, k, v, do, lse, dcap, scale, h):
    """The faults of csrc/flash_bwd_single_sm90.cu's design (with those of
    `_sm90_bwd_faults`): one v slab (columns 64..127) left out of the DK
    block's dP^T; a dV column slice built from another slice's dO columns
    (the second slice from the first one's, or with one slice warpgroup 1's
    half from warpgroup 0's columns); where a width is not a multiple of
    64, the zero-filled columns past it made nonzero (the next row's)."""
    dqk, dv = q.shape[-1], v.shape[-1]
    plan = V.bwd_single_sm90_plan(dqk, dv)["dkv"]
    vf = _bwd_variant(q, k, v, do, lse, dcap, scale, h, v_cols=(64, 128))
    faults = {"v_slab_left_out_of_dPT": {"dk": vf["dk"]}}
    sw = plan["slice_slabs"]
    w0 = 64 * (sw if plan["slices"] > 1 else -(-sw // 2))
    w1 = min(dv, w0 + 64 * sw)
    other = do.clone()
    other[..., w0:w1] = do[..., :w1 - w0]
    faults["dv_slice_from_other_slices_dO"] = {
        "dv": V.flash_bwd_dkv_plain(q, k, v, other, lse, dcap, scale, h)[1]}
    if dqk % 64 or dv % 64:
        wq, wv = -(-dqk // 64) * 64, -(-dv // 64) * 64
        qp, kp = (_next_row_columns(t, wq) for t in (q, k))
        vp, dop = (_next_row_columns(t, wv) for t in (v, do))
        dq = V.flash_bwd_dq_plain(qp, kp, vp, dop, lse, dcap, scale, h)
        dk, dvv = V.flash_bwd_dkv_plain(qp, kp, vp, dop, lse, dcap, scale, h)
        faults["zero_filled_columns_nonzero"] = {"dq": dq[..., :dqk], "dk": dk[..., :dqk],
                                                 "dv": dvv[..., :dv]}
    return faults


def _sm90_bwd_faults(V, q, k, v, do, lse, dcap, scale, h, key_tile=64, query_tile=64):
    """The sm90 backward's own faults (see `_bwd_faults`), on key tiles of
    `key_tile` tokens in dq and query tiles of `query_tile` in dk/dv."""
    tk = lambda t: _tile_twice(t, key_tile, 2 * key_tile)
    tq = lambda t: _tile_twice(t, query_tile, 2 * query_tile)
    return {
        "key_tile_read_twice_in_dq": {"dq": V.flash_bwd_dq_plain(q, tk(k), tk(v), do, lse, dcap,
                                                                 scale, h)},
        "query_tile_read_twice_in_dkv": dict(zip(("dk", "dv"), V.flash_bwd_dkv_plain(
            tq(q), k, v, tq(do), tq(lse), tq(dcap), scale, h))),
        "dS_from_previous_P": {"dk": _stale_p_dk(V, q, k, v, do, lse, dcap, scale, h,
                                                 query_tile)},
    }


def _bwd_f32_variant(V, q, k, v, do, lse, dcap, scale, h, lo_dropped=(), order_undone=(),
                     stat_off=None):
    """The plain backward's arithmetic (fp32) with a planted fault of
    csrc/flash_bwd_f32_sm90.cu -> {"dq", "dk", "dv"}: the gradient products
    named in `lo_dropped` taken as one tf32 product (both factors
    truncated); those in `order_undone` read from a transposed copy left in
    the natural token order (K for dq, Q for dk, dO for dv, as the kernel
    would meet them against P's fragments); `stat_off` "lse" or "D" read one
    row (token) off."""
    import torch

    qh, kh, vh, doh = (V._split_heads(t, h).float() for t in (q, k, v, do))
    lse4, d4 = V._stats4(lse, h).float(), V._stats4(dcap, h).float()
    if stat_off == "lse":
        lse4 = torch.roll(lse4, -1, dims=-2)
    if stat_off == "D":
        d4 = torch.roll(d4, -1, dims=-2)
    y = {"dq": kh, "dk": qh, "dv": doh}
    y = {g: _v_key_order_undone_of(t) if g in order_undone else t for g, t in y.items()}
    mm = lambda g, a, b: (torch.matmul(_tf32(a), _tf32(b)) if g in lo_dropped
                          else torch.matmul(a, b))
    s_scale = scale * V.A.LOG2E
    dq = torch.empty_like(qh)
    dk, dv = torch.zeros_like(kh), torch.zeros_like(vh)
    for i in range(0, qh.shape[-2], 1024):
        rows = slice(i, i + 1024)
        s = torch.matmul(qh[..., rows, :], kh.transpose(-1, -2))
        p = torch.exp2(s * s_scale - lse4[..., rows, :] * V.A.LOG2E)
        ds = p * (torch.matmul(doh[..., rows, :], vh.transpose(-1, -2)) - d4[..., rows, :]) * scale
        dq[..., rows, :] = mm("dq", ds, y["dq"])
        dk += mm("dk", ds.transpose(-1, -2), y["dk"][..., rows, :])
        dv += mm("dv", p.transpose(-1, -2), y["dv"][..., rows, :])
    return {g: V.A._heads_last(t) for g, t in (("dq", dq), ("dk", dk), ("dv", dv))}


def _f32_bwd_faults(V, q, k, v, do, lse, dcap, scale, h):
    """The fp32 Hopper backward's own faults (see `_bwd_faults`): the low
    parts dropped from each gradient product, each transposed copy's token
    order undone, lse or D read one row off. (P left unmasked in the tail
    tile at a ragged N is no fault there: the zero-filled K, V, Q and dO
    past N give it nothing to weigh.)"""
    f = lambda **kw: _bwd_f32_variant(V, q, k, v, do, lse, dcap, scale, h, **kw)
    faults = {}
    for g, op in (("dq", "dS.K"), ("dk", "dS^T.Q"), ("dv", "P^T.dO")):
        faults[f"lo_terms_dropped_from_{op}"] = {g: f(lo_dropped=(g,))[g]}
    for g, copy in (("dq", "K^T"), ("dk", "Q^T"), ("dv", "dO^T")):
        faults[f"{copy}_token_order_undone"] = {g: f(order_undone=(g,))[g]}
    faults["lse_read_one_row_off"] = f(stat_off="lse")
    d_off = f(stat_off="D")
    faults["D_read_one_row_off"] = {"dq": d_off["dq"], "dk": d_off["dk"]}
    return faults


def _train_costs(b, n, cq, cv, h):
    """(operations, bytes) of fwd-lse, dq and dkv at one shape; cq, cv summed
    over heads. Each input read once, each output written once."""
    stats = 4 * b * h * n  # one fp32 per (batch, head, query)
    qkv = 2 * b * n * (2 * cq + cv)
    return {"flash_fwd_lse": (2.0 * b * n * n * (cq + cv), qkv + 2 * b * n * cv + stats),
            "flash_bwd_dq": (2.0 * b * n * n * (2 * cq + cv),
                             qkv + 2 * b * n * cv + 2 * stats + 2 * b * n * cq),
            "flash_bwd_dkv": (2.0 * b * n * n * (2 * cq + 2 * cv),
                              qkv + 2 * b * n * cv + 2 * stats + 2 * b * n * (cq + cv))}


def train_kernel_phase(shapes=TRAIN_SHAPES) -> dict:
    """fwd-lse, dq and dk/dv against their plain versions at the training
    path's shapes (batch 2) and a ragged N, near-flat and peaked inputs; each
    planted fault must be rejected; the backward must give the same bits
    twice. Times kernel, plain version and SDPA (forward; backward)."""
    import torch
    import torch.nn.functional as F

    from transparent_object_detection_tpu_torch.ops import attention_vjp as V

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 2)
    rows = {name: [] for name in ("flash_fwd_lse", "flash_bwd_dq", "flash_bwd_dkv")}
    for node, (b, n, cq, cv, h) in shapes.items():
        readings = {name: [] for name in rows}
        zero_fill = {}
        for score_std in SCORE_STDS:
            q, k, v, do, scale = _train_inputs(gen, b, n, cq, cv, h, score_std)
            out, lse = V.flash_fwd_lse(q, k, v, scale, h)
            out2, lse2 = V.flash_fwd_lse(q, k, v, scale, h)
            torch.cuda.synchronize()
            check(torch.equal(out, out2) and torch.equal(lse, lse2),
                  f"flash_fwd_lse {node}: two runs gave different bits")
            pout, plse = V.flash_fwd_lse_plain(q, k, v, scale, h)
            fwd = {"score_std": score_std, "bar_used": bar_used(out, pout),
                   "max_abs_err": float((out.float() - pout.float()).abs().max()),
                   "lse_max_abs_err": float((lse - plse).abs().max())}
            fwd["faults_rejected_by"] = {
                f: max(bar_used(fo, pout), float((fl - plse).abs().max()) / LSE_ATOL)
                for f, (fo, fl) in _fwd_faults(V, q, k, v, scale, h).items()}
            readings["flash_fwd_lse"].append(fwd)
            check(fwd["bar_used"] <= 1.0 and fwd["lse_max_abs_err"] <= LSE_ATOL,
                  f"flash_fwd_lse {node}: {fwd}")
            for f, used in fwd["faults_rejected_by"].items():
                zero_fill[f] = max(zero_fill.get(f, 0.0), used)
                # the zero-filled keys weigh nothing against peaked rows: that
                # fault is held on some spread (below), every other on each
                check(used > 1.0 or f == "keys_past_n_scored_zero",
                      f"flash_fwd_lse {node}: the bar does not reject {f}")

            dcap = V.compute_dcap(pout, do, h)
            dq = V.flash_bwd_dq(q, k, v, do, plse, dcap, scale, h)
            dk, dv = V.flash_bwd_dkv(q, k, v, do, plse, dcap, scale, h)
            dq2 = V.flash_bwd_dq(q, k, v, do, plse, dcap, scale, h)
            dk2, dv2 = V.flash_bwd_dkv(q, k, v, do, plse, dcap, scale, h)
            torch.cuda.synchronize()
            check(torch.equal(dq, dq2) and torch.equal(dk, dk2) and torch.equal(dv, dv2),
                  f"flash backward {node}: two runs gave different bits")
            got = {"dq": dq, "dk": dk, "dv": dv}
            ref = {"dq": V.flash_bwd_dq_plain(q, k, v, do, plse, dcap, scale, h)}
            ref["dk"], ref["dv"] = V.flash_bwd_dkv_plain(q, k, v, do, plse, dcap, scale, h)
            faults = _bwd_faults(V, q, k, v, do, plse, dcap, scale, h)
            for name, grads in (("flash_bwd_dq", ("dq",)), ("flash_bwd_dkv", ("dk", "dv"))):
                r = {"score_std": score_std, "bitwise_repeat": True}
                for gname in grads:
                    r[gname] = grad_reading(got[gname], ref[gname])
                    check(r[gname]["bar_used"] <= 1.0, f"{name} {node} {gname}: {r[gname]}")
                r["bar_used"] = max(r[gname]["bar_used"] for gname in grads)
                r["max_abs_err"] = max(r[gname]["max_abs_err"] for gname in grads)
                r["faults_rejected_by"] = {
                    f: max(grad_reading(fg[gname], ref[gname])["bar_used"]
                           for gname in grads if gname in fg)
                    for f, fg in faults.items() if any(gname in fg for gname in grads)}
                for f, used in r["faults_rejected_by"].items():
                    check(used > 1.0, f"{name} {node}: the bar does not reject {f} ({used:.3g}x)")
                readings[name].append(r)
        check(zero_fill.get("keys_past_n_scored_zero", 2.0) > 1.0,
              f"flash_fwd_lse {node}: the bars reject keys_past_n_scored_zero on no spread")
        # timing on the last (peaked) inputs
        costs = _train_costs(b, n, cq, cv, h)
        dcap = V.compute_dcap(pout, do, h)
        kern = {"flash_fwd_lse": lambda: V.flash_fwd_lse(q, k, v, scale, h),
                "flash_bwd_dq": lambda: V.flash_bwd_dq(q, k, v, do, plse, dcap, scale, h),
                "flash_bwd_dkv": lambda: V.flash_bwd_dkv(q, k, v, do, plse, dcap, scale, h)}
        plain = {"flash_fwd_lse": lambda: V.flash_fwd_lse_plain(q, k, v, scale, h),
                 "flash_bwd_dq": lambda: V.flash_bwd_dq_plain(q, k, v, do, plse, dcap, scale, h),
                 "flash_bwd_dkv": lambda: V.flash_bwd_dkv_plain(q, k, v, do, plse, dcap, scale,
                                                                h)}
        qh, kh, vh, doh = (V._split_heads(t, h).detach().contiguous() for t in (q, k, v, do))
        qh, kh, vh = (t.requires_grad_() for t in (qh, kh, vh))
        sdpa_fwd = timed_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=scale), 10)

        def sdpa_fwd_bwd():
            F.scaled_dot_product_attention(qh, kh, vh, scale=scale).backward(doh)
        sdpa_bwd = max(timed_ms(sdpa_fwd_bwd, 10) - sdpa_fwd, 0.0)
        library = {"flash_fwd_lse": sdpa_fwd, "flash_bwd_dq": sdpa_bwd, "flash_bwd_dkv": sdpa_bwd}
        form = V.lse_fwd_form(cq // h, cv // h, h, q.dtype)
        bwd = V.bwd_form(cq // h, cv // h, h, q.dtype)
        for name in rows:
            ops, nbytes = costs[name]
            bnd, by = bound_ms(ops, nbytes)
            extra = {"form": form if name == "flash_fwd_lse" else bwd}
            rows[name].append(dict(
                node=node, b=b, n=n, cq=cq, cv=cv, heads=h, readings=readings[name],
                ms=timed_ms(kern[name], 10), plain_ms=timed_ms(plain[name], 2, 1),
                library_ms=library[name], bound_ms=bnd, bound_by=by, **extra))
            print(json.dumps({"kernel": name, **rows[name][-1]}), flush=True)
    return rows


def _model_snapshot(model, state):
    """Copies of everything a train step changes."""
    clone = lambda d: {k: v.detach().clone() for k, v in d.items()}
    return (clone(model.state_dict()), {k: clone(v) for k, v in state.opt_state.items()},
            clone(state.ema_params), clone(state.ema_batch_stats), state.ema_updates, state.step)


def _restore(model, state, snap):
    import torch

    sd, opt, ema_p, ema_b, upd, step = snap
    with torch.no_grad():
        model.load_state_dict(sd)
        for key, tensors in opt.items():
            for n, t in tensors.items():
                state.opt_state[key][n].copy_(t)
        for d, src in ((state.ema_params, ema_p), (state.ema_batch_stats, ema_b)):
            for n, t in src.items():
                d[n].copy_(t)
    state.ema_updates, state.step = upd, step


def _step_record(model, state, comps=None):
    """What a step produced (or, without comps, the state before it), copied
    to the host: three records of phi='m' (1.35 B parameters: parameters,
    gradients and EMA, 16 GB each) do not fit beside the model on the card."""
    import torch

    host = lambda t: t.detach().to("cpu", copy=True)
    params = dict(model.named_parameters())
    rec = {"params": {n: host(p) for n, p in params.items()},
           "stats": {n: host(b) for n, b in model.named_buffers()},
           "ema": {n: host(t) for n, t in state.ema_params.items()}}
    if comps is not None:
        rec["comps"] = {k: float(v) for k, v in comps.items()}
        rec["grads"] = {n: host(p.grad) for n, p in params.items()}
        rec["finite"] = all(bool(torch.isfinite(p.grad).all()) for p in params.values())
    return rec


def _global_rel(num: dict, den: dict, names) -> float:
    """sqrt(sum of num / sum of den) over the named leaves."""
    return (sum(num[n] for n in names) / max(sum(den[n] for n in names), 1e-300)) ** 0.5


def _sq_sums(a: dict, b: dict, c: dict = None):
    """Per leaf, on the card: ||a - b||^2 and ||b - c||^2 (||b||^2 without
    c), in float64."""
    num, den = {}, {}
    for n in b:
        x, y = a[n].to(DEVICE).double(), b[n].to(DEVICE).double()
        num[n] = float((x - y).square().sum())
        den[n] = float((y if c is None else y - c[n].to(DEVICE).double()).square().sum())
    return num, den


def compare_steps(got, ref, old) -> dict:
    """One step against another from the same state: the losses' relative
    errors, and the global relative error (over all leaves of a group, as
    sqrt(sum of squared differences / sum of squared reference values)) of
    the gradients, of the parameters' change, of the EMA's change and of the
    BatchNorm statistics' change. The worst single leaf (error over the
    leaf's largest magnitude) is reported, not bounded: the bf16 gradient of
    this random-weight model is a small difference of large terms (the
    classification loss pushes every anchor alike and training-mode
    BatchNorm removes that mean), so single leaves are noisy."""
    names = list(ref["grads"])
    groups = {g: [n for n in names if n.startswith(g + ".")] for g in ("backbone", "neck", "head")}
    num, den = _sq_sums(got["grads"], ref["grads"])
    out = {"grads": {g: _global_rel(num, den, ns) for g, ns in groups.items()}}
    out["grads"]["all"] = _global_rel(num, den, names)
    out["param_change"] = _global_rel(*_sq_sums(got["params"], ref["params"], old["params"]),
                                      names)
    out["ema_change"] = _global_rel(*_sq_sums(got["ema"], ref["ema"], old["ema"]), names)
    out["bn_stats_change"] = _global_rel(*_sq_sums(got["stats"], ref["stats"], old["stats"]),
                                         list(ref["stats"]))
    out["loss_rel"] = {k: abs(got["comps"][k] - ref["comps"][k]) / max(abs(ref["comps"][k]), 1e-30)
                       for k in ("loss", "loss_iou", "loss_cls", "loss_dfl")}
    out["num_fg"] = (got["comps"]["num_fg"], ref["comps"]["num_fg"])
    leaf = lambda n: float((got["grads"][n].to(DEVICE).float() - ref["grads"][n].to(DEVICE).float())
                           .abs().max() / ref["grads"][n].to(DEVICE).float().abs().max()
                           .clamp(min=1e-30))
    errs = {n: leaf(n) for n in names}
    worst = max(errs, key=errs.get)
    out["worst_leaf"] = (worst, errs[worst])
    return out


@contextlib.contextmanager
def planted_train_fault(fault: str):
    """The plain backward with a planted fault (the D term dropped, or lse
    off by 0.01 in the recompute)."""
    import torch

    from transparent_object_detection_tpu_torch.ops import attention_vjp as V

    real = V._bwd_plain

    def faulty(q, k, v, do, lse, dcap, *args, **kw):
        if fault == "D_term_dropped":
            dcap = torch.zeros_like(dcap)
        else:
            lse = lse + 0.01
        return real(q, k, v, do, lse, dcap, *args, **kw)
    V._bwd_plain = faulty
    try:
        yield
    finally:
        V._bwd_plain = real


def train_path_calls(step, state, batch, restore, expected_counts) -> None:
    """Every training-kernel launch of one step (uncounted), recorded with
    its arguments and held against its plain version on the same
    activations: the forward's out with the kernel bar and its lse within
    LSE_ATOL, the gradients with the gradient bar."""
    import torch

    from transparent_object_detection_tpu_torch.ops import attention_vjp as V

    calls = []
    real = {n: getattr(V, n) for n in ("flash_fwd_lse", "flash_bwd_dq", "flash_bwd_dkv")}

    def recording(name):
        def launch(*args, **kw):
            out = real[name](*args, **kw)
            kept = tuple(o.clone() for o in out) if isinstance(out, tuple) else out.clone()
            calls.append((name, args, kw, kept))
            return out
        # the wrapper counts on the name it is bound to
        launch.launches = launch.sm90_launches = launch.f32_launches = 0
        launch.single_launches = 0
        return launch

    for name in real:
        setattr(V, name, recording(name))
    try:
        restore()
        step(state, batch, TRAIN_LR)
        torch.cuda.synchronize()
    finally:
        for name, fn in real.items():
            setattr(V, name, fn)
    expected = sum(count for name, count in expected_counts.items()
                   if name.startswith(tuple(real)))  # flash_fwd_lse_sm90 too
    check(len(calls) == expected,
          f"expected {expected} training-kernel launches in a step, got {len(calls)}")
    with torch.no_grad():  # the saved inputs require grad; the plain versions need none
        for i, (name, args, kw, out) in enumerate(calls):
            kw = {k: v for k, v in kw.items() if k not in ("dq", "dk", "dv")}
            q, heads = args[0], (args[4] if name == "flash_fwd_lse" else args[7])
            f32 = q.dtype == torch.float32
            # the f32_sm90 kernels and the one-head sm90 backward: a second
            # launch, the same bits
            twice = f32 or (name != "flash_fwd_lse" and V.bwd_form(
                q.shape[-1] // heads, args[2].shape[-1] // heads, heads, q.dtype) == "single_sm90")
            if name == "flash_fwd_lse":
                if f32:  # the f32_sm90 kernel: a second launch, the same bits
                    again = real[name](*args, **kw)
                    check(torch.equal(again[0], out[0]) and torch.equal(again[1], out[1]),
                          f"{name} launch {i}: two launches gave different bits")
                pout, plse = V.flash_fwd_lse_plain(*args, **kw)
                r = {"bar_used": (_f32_bar_used if f32 else bar_used)(out[0], pout),
                     "lse_max_abs_err": float((out[1] - plse).abs().max())}
                r["bar_used"] = max(r["bar_used"], r["lse_max_abs_err"]
                                    / (F32_LSE_ATOL if f32 else LSE_ATOL))
            elif name == "flash_bwd_dq":
                if twice:
                    check(torch.equal(real[name](*args, **kw), out),
                          f"{name} launch {i}: two launches gave different bits")
                r = grad_reading(out, V.flash_bwd_dq_plain(*args, **kw), f32)
            else:
                if twice:
                    again = real[name](*args, **kw)
                    check(torch.equal(again[0], out[0]) and torch.equal(again[1], out[1]),
                          f"{name} launch {i}: two launches gave different bits")
                pk, pv = V.flash_bwd_dkv_plain(*args, **kw)
                r = {"dk": grad_reading(out[0], pk, f32), "dv": grad_reading(out[1], pv, f32)}
                r["bar_used"] = max(r["dk"]["bar_used"], r["dv"]["bar_used"])
            print(json.dumps({"train_path_call": name, "launch": i, "n": q.shape[1],
                              "q_width": q.shape[2], "heads": heads, **r}), flush=True)
            check(r["bar_used"] <= 1.0, f"{name} launch {i} on the path's activations: {r}")


def train_launch_counts():
    from transparent_object_detection_tpu_torch.ops import attention as A
    from transparent_object_detection_tpu_torch.ops import attention_int8 as A8
    from transparent_object_detection_tpu_torch.ops import attention_vjp as V
    from transparent_object_detection_tpu_torch.ops import quant_matmul as QM

    resets = (A.reset_launch_counts, A8.reset_launch_counts, QM.reset_launch_counts,
              V.reset_launch_counts)
    read = lambda: {"flash_fwd_lse": V.flash_fwd_lse.launches,
                    "flash_fwd_lse_sm90": V.flash_fwd_lse.sm90_launches,
                    "flash_fwd_lse_f32": V.flash_fwd_lse.f32_launches,
                    "flash_bwd_dq": V.flash_bwd_dq.launches,
                    "flash_bwd_dq_sm90": V.flash_bwd_dq.sm90_launches,
                    "flash_bwd_dq_f32": V.flash_bwd_dq.f32_launches,
                    "flash_bwd_dq_single": V.flash_bwd_dq.single_launches,
                    "flash_bwd_dkv": V.flash_bwd_dkv.launches,
                    "flash_bwd_dkv_sm90": V.flash_bwd_dkv.sm90_launches,
                    "flash_bwd_dkv_f32": V.flash_bwd_dkv.f32_launches,
                    "flash_bwd_dkv_single": V.flash_bwd_dkv.single_launches,
                    "flash_mha_packed": A.flash_mha_packed.launches,
                    "flash_mha_packed_sm90": A.flash_mha_packed.sm90_launches,
                    "flash_mha_packed_f32": A.flash_mha_packed.f32_launches,
                    "flash_single": A.flash_single.launches,
                    "flash_single_f32": A.flash_single.f32_launches,
                    "flash_mha_int8": A8.flash_mha_int8.launches,
                    "flash_mha_int8_sm90": A8.flash_mha_int8.sm90_launches,
                    "qmm": QM.qmm.launches, "quant_rows": QM.quant_rows.launches}
    return resets, read


def train_expected(cfg) -> dict:
    """Launches of each kernel in one training step of `cfg` (its scale and
    input, remat or not), from the training route table: one forward, dq and
    dk/dv launch a site that leaves the naive route, the forward of packed
    bf16 heads on the sm90 kernel and every fp32 forward on the f32_sm90
    kernel (`lse_fwd_form`), the backward of packed bf16 heads on the
    sm90 kernels where `bwd_form` sends it (heads of 128 to 384) and every
    fp32 backward on the f32_sm90 kernels, the bf16 one-head backward
    (dark3, folded heads) on the single_sm90 kernels where `bwd_form` sends
    it (phi 'n', 's', 'm'); with remat, every neck site's forward runs
    again in the backward's recompute; no serving kernel."""
    import torch

    from transparent_object_detection_tpu_torch.ops import attention as A
    from transparent_object_detection_tpu_torch.ops import attention_vjp as V

    counts = {"flash_fwd_lse": 0, "flash_fwd_lse_sm90": 0, "flash_fwd_lse_f32": 0,
              "flash_bwd_dq": 0, "flash_bwd_dq_sm90": 0, "flash_bwd_dq_f32": 0,
              "flash_bwd_dq_single": 0, "flash_bwd_dkv": 0, "flash_bwd_dkv_sm90": 0,
              "flash_bwd_dkv_f32": 0, "flash_bwd_dkv_single": 0, "flash_mha_packed": 0,
              "flash_mha_packed_sm90": 0,
              "flash_mha_packed_f32": 0, "flash_single": 0, "flash_single_f32": 0,
              "flash_mha_int8": 0, "flash_mha_int8_sm90": 0, "qmm": 0, "quant_rows": 0}
    dtype = getattr(torch, cfg.compute_dtype)
    for name, (n, cq, cv, heads, _) in scale_sites(cfg.phi, cfg.input_shape).items():
        route = A.train_route(n, cq, heads, cv)
        if route == "naive":
            continue
        form = V.lse_fwd_form(cq // heads, cv // heads, heads if route == "packed" else 1,
                              dtype)
        counts["flash_fwd_lse" + {"sm90": "_sm90", "f32_sm90": "_f32"}.get(form, "")] += (
            2 if cfg.remat and name != "dark3" else 1)
        # folded heads reach the backward as single heads of the widths the
        # fold copy pads to a multiple of 8
        pad8 = (lambda d: -(-d // 8) * 8) if route == "folded" else (lambda d: d)
        bwd = {"sm90": "_sm90", "f32_sm90": "_f32", "single_sm90": "_single"}.get(
            V.bwd_form(pad8(cq // heads), pad8(cv // heads), heads if route == "packed" else 1,
                       dtype), "")
        counts["flash_bwd_dq" + bwd] += 1
        counts["flash_bwd_dkv" + bwd] += 1
    return counts


def train_slice_phase(card: str, cfg=None, train_batches=(TRAIN_BATCH,),
                      faults=TRAIN_SLICE_FAULTS, rejects=TRAIN_SLICE_REJECTS,
                      timed: bool = True) -> dict:
    """The port's make_train_step on FocusModel at `cfg` (default phi='s'
    640x640 bf16; SGD, EMA on), on seeded synthetic batches like the JAX
    bench_train.py's: the counted main path (launches equal to
    `train_expected`), kernels against plain versions from the same weights
    (and, for each of `faults`, the plain step with that planted fault,
    which the limits must reject where it is in `rejects`: the limits come
    from phi='s', where the dropped D term reads 3.99 of the gradient
    limit; the kernel bars reject it at every scale), each training-kernel
    launch of a step against its plain version; then, with
    `timed`, steps at the first batch of `train_batches` that fits on the
    card (the choice printed), with remat the same batch's peak memory and
    step time without it, and a profile. Returns {"launches", "perf"}."""
    import gc

    import numpy as np
    import torch

    from transparent_object_detection_tpu_torch.config import ModelConfig, TrainConfig
    from transparent_object_detection_tpu_torch.models.detector import (
        build_model,
        set_attention_impl,
    )
    from transparent_object_detection_tpu_torch.train.optimizer import build_optimizer
    from transparent_object_detection_tpu_torch.train.trainer import (
        create_train_state,
        loss_config_from,
        make_train_step,
    )

    cfg = cfg or ModelConfig()
    label = (f"phi={cfg.phi} {cfg.input_shape[0]}x{cfg.input_shape[1]} {cfg.compute_dtype}"
             + (" remat" if cfg.remat else ""))
    expected = train_expected(cfg)
    tcfg = TrainConfig(max_boxes=64, optimizer_type="sgd", ema=True)
    t0 = time.perf_counter()
    model = build_model(cfg, device=DEVICE, seed=SEED)
    n_params = sum(p.numel() for p in model.parameters())
    print(json.dumps({"train_model": label, "params": n_params,
                      "build_s": time.perf_counter() - t0}), flush=True)
    with torch.no_grad():  # else dark3's attention gets a zero cotangent
        model.backbone.dark3_attn.gamma.fill_(0.5)
    opt = build_optimizer(tcfg, model)
    state = create_train_state(model, opt)
    step = make_train_step(model, opt, loss_config_from(cfg, tcfg), tcfg)

    def batch_of(b, seed):
        rng = np.random.default_rng(seed)
        boxes = np.zeros((b, 64, 4), np.float32)
        boxes[:, 0] = [0.5, 0.5, 0.4, 0.4]
        boxes[:, 1] = [0.25, 0.3, 0.2, 0.2]
        h, w = cfg.input_shape
        return {"image": torch.as_tensor(rng.uniform(size=(b, h, w, 3)).astype(np.float32),
                                         device=DEVICE),
                "boxes": torch.as_tensor(boxes, device=DEVICE),
                "labels": torch.zeros((b, 64), dtype=torch.long, device=DEVICE)}

    resets, read = train_launch_counts()
    batch2 = batch_of(2, SEED)
    snap = _model_snapshot(model, state)
    old = _step_record(model, state)
    # the main path, counted: counts to 0 just before, read just after
    for reset in resets:
        reset()
    state, comps = step(state, batch2, TRAIN_LR)
    torch.cuda.synchronize()
    launches = read()
    print(json.dumps({"train_main_path_launches": launches, "model": label}), flush=True)
    check(launches == expected, f"{label}: train step launches {launches}, expected {expected}")
    got = _step_record(model, state, comps)
    check(got["finite"] and all(np.isfinite(v) for v in got["comps"].values()),
          f"{label}: non-finite loss or gradient: {got['comps']}")

    def plain_step(fault=None):
        _restore(model, state, snap)
        set_attention_impl(model, "plain")
        try:
            with planted_train_fault(fault) if fault else contextlib.nullcontext():
                st, c = step(state, batch2, TRAIN_LR)
            return _step_record(model, st, c)
        finally:
            set_attention_impl(model, None)

    ref = plain_step()
    sound = compare_steps(got, ref, old)
    del got
    plain_again = compare_steps(plain_step(), ref, old) if faults else None
    fault_readings = {f: compare_steps(plain_step(f), ref, old) for f in faults}
    limits = {"grads": TRAIN_GRAD_LIMIT, "param_change": TRAIN_UPDATE_LIMIT,
              "ema_change": TRAIN_UPDATE_LIMIT, "bn_stats_change": TRAIN_STATS_LIMIT,
              "loss_rel": TRAIN_LOSS_LIMIT}
    print(json.dumps({"train_slice_parity": {
        "model": label, "kernels": sound, "plain_run_twice": plain_again,
        "planted_faults": fault_readings, "loss_plain": ref["comps"], "limits": limits}}),
        flush=True)
    readings = lambda r: {"grads": r["grads"]["all"], "param_change": r["param_change"],
                          "ema_change": r["ema_change"], "bn_stats_change": r["bn_stats_change"],
                          "loss_rel": max(r["loss_rel"].values())}
    for key, value in readings(sound).items():
        check(value <= limits[key],
              f"{label}: a train step with kernels differs from plain: {key} {value}")
    for f in rejects:
        if f in fault_readings:
            r = readings(fault_readings[f])
            check(all(r[key] > limits[key] for key in ("grads", "param_change", "ema_change")),
                  f"{label}: the train slice limits do not reject {f}: {r}")
    del ref, old, fault_readings
    train_path_calls(step, state, batch2, lambda: _restore(model, state, snap), expected)

    # launches per step at batch 1 (the routing does not depend on the batch)
    for reset in resets:
        reset()
    step(state, batch_of(1, SEED + 2), TRAIN_LR)
    torch.cuda.synchronize()
    check(read() == expected, f"{label}: launches per step at batch 1: {read()}")
    _restore(model, state, snap)
    del snap
    gc.collect()
    torch.cuda.empty_cache()
    if not timed:
        del model, state, opt, step
        gc.collect()
        torch.cuda.empty_cache()
        return {"launches": launches, "perf": None}

    def peak_gib(b):
        """Peak memory of one step at batch b (a warm-up), or None when it
        does not fit on the card."""
        try:
            torch.cuda.reset_peak_memory_stats()
            step(state, batch_of(b, SEED + 1), TRAIN_LR)
            torch.cuda.synchronize()
            return torch.cuda.max_memory_allocated() / 2**30
        except torch.cuda.OutOfMemoryError:
            return None
        finally:
            gc.collect()
            torch.cuda.empty_cache()

    tried = {}
    for b in train_batches:
        tried[b] = peak_gib(b)
        if tried[b] is not None:
            train_batch = b
            break
    else:
        raise SmokeFailure(f"{label}: no batch of {train_batches} fits on the card")
    print(json.dumps({"train_batch_choice": label, "peak_gib_by_batch": tried,
                      "chosen": train_batch}), flush=True)
    batch = batch_of(train_batch, SEED + 1)

    def timed_steps(want):
        """3 steps after a warm-up, host clock; launches per step equal to `want`."""
        nonlocal state
        losses, times = [], []
        for _ in range(3):
            for reset in resets:
                reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, comps = step(state, batch, TRAIN_LR)
            losses.append(float(comps["loss"]))  # synchronises
            times.append((time.perf_counter() - t0) * 1e3)
            check(read() == want, f"{label}: launches per step at batch {train_batch}: {read()}")
        check(all(np.isfinite(losses)), f"{label}: non-finite losses {losses}")
        return losses, times

    without_remat = ms_without_remat = None
    if cfg.remat:  # the same batch without remat: its peak and, where it fits, its step
        model.neck.remat = False
        without_remat = peak_gib(train_batch)
        if without_remat is not None:
            no_remat = dataclasses.replace(cfg, remat=False)
            ms_without_remat = sorted(timed_steps(train_expected(no_remat))[1])[1]
        model.neck.remat = True
        peak_gib(train_batch)  # warm-up with remat again

    # timing at train_batch: timed steps after the warm-up, host clock
    torch.cuda.reset_peak_memory_stats()
    losses, times = timed_steps(expected)
    peak = torch.cuda.max_memory_allocated() / 2**30
    per_step = read()
    profile = profile_call(lambda: step(state, batch, TRAIN_LR), train_batch)
    ms = sorted(times)[len(times) // 2]
    perf = {"card": card, "model": f"{label} train step (SGD nesterov, EMA)",
            "params": n_params, "batch": train_batch, "step_ms": ms, "step_ms_all": times,
            "imgs_per_s": train_batch / ms * 1e3, "peak_mem_gib": peak,
            "peak_mem_gib_without_remat": without_remat, "step_ms_without_remat": ms_without_remat,
            "losses": losses, "launches_per_step": per_step,
            "profile_idle_share": profile["idle_share"], "profile_by_class_ms":
            profile["by_class_ms"]}
    print(json.dumps({"train_slice_perf": perf}), flush=True)
    del model, state, opt, step, batch
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "perf": perf}


# ---------------------------------------------------------------------------
# every scale: the serving kernels over their whole JAX domain (phi 'n', 'm',
# 'l', 'x' widths, N = 4,320, fp32), phi='m' 640x640 serving at full width,
# phi='n' serving
# ---------------------------------------------------------------------------

PEAK_F32_FLOPS = 67e12  # H100 SXM data sheet, fp32 outside the tensor cores
PEAK_TF32_FLOPS = 495e12  # H100 SXM data sheet, dense tf32 on the tensor cores
# the fp32 flash kernels (csrc/flash_fwd_f32_sm90.cu, csrc/flash_bwd_f32_sm90.cu)
# take each fp32 product as three tf32 products: their bound is the
# operations at a third of that rate
F32_FLASH_FLOPS = PEAK_TF32_FLOPS / 3
# fp32 kernel bar, per element: kernel and plain version compute in fp32 and
# differ in summation order (and exp2) only
F32_RTOL, F32_ATOL_OF_MAX = 1e-4, 1e-4
SCALE_PHIS = ("n", "m", "l", "x")
# Slice limits of the fp32 model (every int8 flag off) with kernels against
# plain versions, between the sound reading and the planted fault in
# SLICE_REJECTS on an H100 (PERF.md).
F32_BOX_LIMIT_PX = 0.05
F32_SCORE_LIMIT = 1e-4


def scale_sites(phi: str, hw=(640, 640)) -> dict:
    """{site: (N, q/k width, v width, heads, packed qkv input)} of the
    attention calls of one forward at `phi` (dark3's SelfAttention, the
    neck's TEBs with the heads they pick)."""
    from transparent_object_detection_tpu_torch.config import SCALE_TABLE
    from transparent_object_detection_tpu_torch.models.blocks import _pick_num_heads

    c, _, mul = SCALE_TABLE[phi]
    c5 = int(c * 16 * mul)
    h, w = hw
    n8, n16, n32 = (h // 8) * (w // 8), (h // 16) * (w // 16), (h // 32) * (w // 32)
    out = {"dark3": (n8, max(4 * c // 8, 1), 4 * c, 1, False)}
    for name, n, ch in (("h1", n16, c5 + 8 * c), ("h2", n8, 12 * c), ("h4", n16, 12 * c),
                        ("h6", n32, 8 * c + c5)):
        out[name] = (n, ch, ch, _pick_num_heads(ch, 8), True)
    return out


def expected_launches(phi: str, batch: int, tag: str, f32: bool = False) -> dict:
    """Launches of every serving kernel in one forward of configuration
    `tag` ("bf16", "int8", "A", "B") at `phi` 640x640 and `batch` (`f32`:
    fp32 compute), from the route table (`serving_route`, `pick_blocks`,
    the quant_out groups, `packed_fwd_form`: bf16 packed heads take the
    sm90 kernel, fp32 calls the f32_sm90 kernel) and the int8 TEB's rules (models/blocks.py): each int8 TEB
    runs 4 qmm and a quant_rows before each projection that takes bf16
    rows."""
    import torch

    from transparent_object_detection_tpu_torch.ops import attention as A
    from transparent_object_detection_tpu_torch.ops import attention_int8 as A8
    from transparent_object_detection_tpu_torch.ops import quant_matmul as QM

    int8 = tag != "bf16"
    var = VARIANT_CONFIGS.get(tag, {})
    counts = dict.fromkeys(COUNTED, 0)
    kernel_of = {"int8": "flash_mha_int8", "packed": "flash_mha_packed",
                 "single": "flash_single", "folded": "flash_single"}

    dtype = torch.float32 if f32 else torch.bfloat16

    def sm90(kernel, dq, dv):
        """The counter of `kernel` on heads of these widths: the Hopper
        kernels' where their rules take the call."""
        if kernel == "flash_mha_packed":
            form = A.packed_fwd_form(dq, dtype)
            return kernel + {"sm90": "_sm90", "f32_sm90": "_f32"}.get(form, "")
        if kernel == "flash_single":
            return kernel + ("_f32" if f32 else "")
        if kernel.startswith(("flash_mha_int8", "flash_int8")):
            return kernel + ("_sm90" if A8.int8_fwd_form(dq, dv) == "sm90" else "")
        return kernel

    def attend(route, dq, dv):
        if route in kernel_of:
            counts[sm90(kernel_of[route], dq, dv)] += 1

    for n, cq, cv, heads, packed in scale_sites(phi).values():
        if not (packed and int8):
            attend(A.serving_route(n, cq, heads, cv, int8, packed)[0], cq // heads, cv // heads)
            continue
        c, dh, m = cq, cq // heads, batch * n
        w4a4 = var.get("w4a4_mlp1", False) and m % 128 == 0 and c % 128 == 0
        big = n > A.NAIVE_MAX_TOKENS
        tiles = A8.pick_blocks(n, c, heads, cv=c) is not None
        counts["qmm"] += 4
        counts["quant_rows"] += 1  # qkv
        x_quant = False
        if big and var.get("attn_handoff", False):
            g = QM.quant_out_group_width(m, c, 3 * c, 0, align=(c, dh))
            if tiles and (g == 3 * c or (c % g == 0 and g % dh == 0)):
                counts[sm90("flash_int8_handoff", dh, dh)] += 1
                x_quant = True
            else:  # dequantized qkv, the int8 route
                attend(A.serving_route(n, c, heads, c, True, True)[0], dh, dh)
        elif big and var.get("attn_qout", False) and dh % 128 == 0 and tiles:
            counts[sm90("flash_mha_int8_qout", dh, dh)] += 1
            x_quant = True
        else:
            attend(A.serving_route(n, c, heads, c, True, True)[0], dh, dh)
        counts["quant_rows"] += 0 if x_quant else 1  # attn_out
        if w4a4:
            counts["quant_rows_int4"] += 1
        elif not QM.ln_handoff(m, c):
            counts["quant_rows"] += 1  # mlp1 (else the LN handoff's payload)
    return counts


def check_launch_model() -> None:
    """`expected_launches` reproduces the phi='s' counts the slices assert."""
    zero = dict.fromkeys(COUNTED, 0)
    check(expected_launches("s", 4, "bf16") == {**zero, "flash_mha_packed_sm90": 3,
                                                "flash_single": 1},
          "expected_launches: phi='s' bf16")
    check(expected_launches("s", 4, "bf16", f32=True) == {**zero, "flash_mha_packed_f32": 3,
                                                          "flash_single_f32": 1},
          "expected_launches: phi='s' fp32")
    check(expected_launches("s", 4, "int8") == {**zero, "flash_mha_int8_sm90": 4, "qmm": 16,
                                                "quant_rows": 12}, "expected_launches: int8")
    for tag in VARIANT_EXPECTED:
        for b, want in VARIANT_EXPECTED[tag].items():
            got = expected_launches("s", b, tag)
            check(got == {**zero, "flash_mha_int8_sm90": 1, **want},
                  f"expected_launches: configuration {tag} batch {b}: {got}")


def _f32_bar_used(out, ref) -> float:
    diff = (out.float() - ref.float()).abs()
    mag = ref.float().abs()
    return float((diff / (F32_RTOL * mag + F32_ATOL_OF_MAX * mag.max())).max())


def _amax_per_slice(o, heads, width=256):
    """Planted fault: the int8 output quantized per `width`-column slice of
    a head (each slice on its own amax: the template's 256-column blocks, or
    the sm90 kernel's warpgroup halves without their exchange), the last
    slice's scale written."""
    import torch

    b, n, c = o.shape
    dv = c // heads
    o4 = o.float().reshape(b, n, heads, dv)
    payload = torch.empty_like(o4, dtype=torch.int8)
    scale = None
    for j in range(0, dv, width):
        sl = o4[..., j:j + width]
        amax = torch.clamp(sl.abs().amax(-1, keepdim=True), min=1e-30)
        payload[..., j:j + width] = torch.round(sl * (torch.full_like(amax, 127.0) / amax)).to(
            torch.int8)
        scale = amax[..., 0] * (1.0 / 127.0)
    return payload.reshape(b, n, c), scale.contiguous()


def scale_kernel_phase() -> dict:
    """Rows 1-8 at every site of phi 'n', 'm', 'l' and 'x' 640x640 (batch 2,
    batch 1 at 'l' and 'x'), at the 480x576 input (N = 4,320) of phi 's'
    and 'm', and in fp32: each kernel against its plain version with the
    existing bars, each planted fault rejected on some input spread (the
    phi='s' faults, a dropped q/k slab of the width loop, a dropped tail key
    tile, an int8 output quantized per 256-column slice, a dropped K tail
    in qmm). Returns per kernel form the largest value error."""
    import torch

    from transparent_object_detection_tpu_torch.ops import attention as A
    from transparent_object_detection_tpu_torch.ops import attention_int8 as A8
    from transparent_object_detection_tpu_torch.ops import quant_matmul as QM

    check_launch_model()
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 5)
    randn = lambda *s: torch.randn(*s, generator=gen, device=DEVICE)
    qk_std = lambda score_std, scale, d: (score_std / (scale * d ** 0.5)) ** 0.5
    err = {}

    def note(form, value):
        err[form] = max(err.get(form, 0.0), value)

    def flash_case(tag, b, n, cq, cv, heads, packed, dt):
        f32 = dt == torch.float32
        scale = (cq // heads) ** -0.5 if heads > 1 else 1.0
        faults = {}
        # the Hopper kernels: bf16 packed heads on flash_fwd_sm90.cu, every
        # fp32 call on flash_fwd_f32_sm90.cu (with its split's and layout's faults)
        sm90 = f32 or (packed and A._packed_heads(cq, heads)
                       and A.packed_fwd_form(cq // heads, dt) == "sm90")
        ring = ("key_tile_used_twice",) + (("keys_past_n_scored_zero",) if n % 64 else ())
        ring += tuple(F32_FAULTS) if f32 else ()
        spreads = [(std, 0.0) for std in SCORE_STDS]
        if sm90 and n % 64:  # the zero-fill trap shows on shifted scores
            spreads.append(SHIFTED_SPREAD)
        for score_std, mean in spreads:
            std = qk_std(score_std, scale, cq // heads)
            if packed:
                qkv = randn(b, n, 3 * cq)
                qkv[..., :2 * cq] *= std
                if mean:
                    _score_shift(qkv[..., :cq], qkv[..., cq:2 * cq], scale, mean, cq // heads)
                qkv = qkv.to(dt)
                if A._packed_heads(cq, heads):
                    kern = lambda: A.flash_mha_packed(qkv, heads, scale)
                    plain = lambda: A.flash_mha_packed_plain(qkv, heads, scale)
                    form = "flash_mha_packed"
                else:  # folded
                    q, k, v = qkv.chunk(3, dim=-1)
                    kern = lambda: A.attention(q, k, v, scale, num_heads=heads)
                    plain = lambda: A.attention(q, k, v, scale, impl="plain", num_heads=heads)
                    form = "flash_single"
            else:
                q, k = ((randn(b, n, cq) * std).to(dt) for _ in range(2))
                v = randn(b, n, cv).to(dt)
                kern = lambda: A.flash_single(q, k, v, scale)
                plain = lambda: A.flash_single_plain(q, k, v, scale)
                form = "flash_single"
            form += "_f32" if f32 else ""
            # every fault is held to be rejected on some input spread, below
            # (the sm90 kernel's: also the ring's, and a second launch's bits)
            r = hold_against_plain(kern, plain, f"{form} {tag} n={n} cq={cq} cv={cv} "
                                                f"heads={heads} score_std {score_std} "
                                                f"mean {mean}",
                                   faults_must_fail=False,
                                   faults=(*PLANTED_FAULTS, *SCALE_FAULTS,
                                           *(ring if sm90 else ())),
                                   bar=_f32_bar_used if f32 else bar_used, twice=sm90)
            note(form, r["max_abs_err"])
            for f, used in r["fault_bar_used"].items():
                faults[f] = max(faults.get(f, 0.0), used)
        for f, used in faults.items():
            check(used > 1.0, f"{tag}: the bar rejects {f} on no input spread ({used:.3g}x)")

    def int8_case(tag, b, n, cq, cv, heads, bk, dt, variants):
        scale = (cq // heads) ** -0.5 if heads > 1 else 1.0
        dv = cv // heads
        rejected = {}
        for score_std in SCORE_STDS:
            std = qk_std(score_std, scale, cq // heads)
            q, k = ((randn(b, n, cq) * std).to(dt) for _ in range(2))
            v = randn(b, n, cv).to(dt)
            kq, ks = A8.quantize_kv(k, heads, bk)
            vq, vs = A8.quantize_kv(v, heads, bk)
            keep = torch.ones(n, dtype=torch.bool, device=DEVICE)
            for j in range(0, n, bk):  # each block's last (partial) key tile
                keep[j + bk - (bk % 64 or 64):j + bk] = False
            lo, hi = (128, 256) if cq // heads > 128 else (cq // heads // 2, cq // heads)
            cols = torch.zeros(cq // heads, device=DEVICE)
            cols[lo:hi] = 1
            drop = lambda t: t * (1 - cols).repeat(heads).to(t.dtype)
            ref_fn = lambda od=None, **kw: (lambda: int8_attention_reference(
                q, k, v, heads, scale, bk, bk, od, **kw))
            faults = {
                "p_rounded_on_running_64_key_max": lambda od=None: int8_attention_reference(
                    q, k, v, heads, scale, bk, 64, od),
                "tail_key_tile_dropped": lambda od=None: int8_attention_reference(
                    q, k, v, heads, scale, bk, bk, od, key_keep=keep),
                "qk_slab_dropped": lambda od=None: int8_attention_reference(
                    drop(q), drop(k), v, heads, scale, bk, bk, od),
            }
            record = {"b": b, "n": n, "cq": cq, "cv": cv, "heads": heads, "bk": bk,
                      "dtype": str(dt), "score_std": score_std}
            args = (q, kq, ks, vq, vs, heads, scale)
            out = A8.flash_mha_int8(*args)
            torch.cuda.synchronize()
            sm90 = A8.int8_fwd_form(cq // heads, dv) == "sm90"
            # the width over which a faulty int8 output would take its amax:
            # the template's 256-column slices, the sm90 kernel's warpgroup halves
            slice_w = A8.int8_sm90_plan(cq // heads, dv, n // bk)["v_cols"] if sm90 else \
                A8.KERNEL_DV_TILE
            if sm90:  # the second launch's bits, and the faults of its ring and layout
                twice_same_bits(lambda: A8.flash_mha_int8(*args), out, f"flash_mha_int8 {tag}")
                faults.update((f, lambda od=None, fn=fn: fn()) for f, fn in sm90_ring_faults(
                    q, kq, ks, vq, vs, heads, scale, k, v, bk).items())
            ref = A8.flash_mha_int8_plain(*args)
            check(int8_reading(ref_fn()(), ref)["bar_used"] <= 1.0,
                  f"flash_mha_int8 {tag}: the fault reference is not the plain function")
            form = "flash_mha_int8" + ("_f32" if dt == torch.float32 else "")
            r = _hold(f"{form} {tag}", out, ref, {f: fn for f, fn in faults.items()}, record,
                      spread_faults=tuple(faults))
            note(form, r["max_abs_err"])
            for f, used in r["faults_bar_used"].items():
                rejected[f] = rejected.get(f, False) or used > 1.0
            if not variants:
                continue
            # qout: the same inputs, the output quantized per (row, head)
            out = A8.flash_mha_int8_qout(*args)
            torch.cuda.synchronize()
            if sm90:
                twice_same_bits(lambda: A8.flash_mha_int8_qout(*args), out,
                                f"flash_mha_int8_qout {tag}")
            ref = A8.flash_mha_int8_qout_plain(*args)
            o32 = lambda: int8_attention_reference(q, k, v, heads, scale, bk, bk, torch.float32)
            qfaults = {"out_scale_per_row": lambda: _out_scale_per_row(o32(), heads),
                       "p_rounded_on_running_64_key_max": lambda: _quant_per_head(
                           faults["p_rounded_on_running_64_key_max"](torch.float32), heads)}
            if dv > slice_w:
                qfaults["amax_per_slice"] = lambda: _amax_per_slice(o32(), heads, slice_w)
            r = _hold(f"flash_mha_int8_qout {tag}", out, ref, qfaults, record,
                      spread_faults=("p_rounded_on_running_64_key_max",))
            note("flash_mha_int8_qout", r["max_abs_err"])
            rejected["qout p_rounded_on_running_64_key_max"] = (
                rejected.get("qout p_rounded_on_running_64_key_max", False)
                or r["faults_bar_used"]["p_rounded_on_running_64_key_max"] > 1.0)
            # handoff: the int8 qkv payload (one scale a row, and the path's groups)
            c = cq
            path_group = QM.quant_out_group_width(2 * n, c, 3 * c, 0, align=(c, c // heads))
            for group in sorted({3 * c, path_group}):
                qkv = torch.cat([q, k, v], dim=-1).float()
                payload, scales = QM._output_plain(qkv, None, group, None)
                qs = A8.q_scale_table(scales, c, heads)
                hk = A8.requantize_section(payload, scales, c, c, heads, bk)
                hv = A8.requantize_section(payload, scales, 2 * c, c, heads, bk)
                k_fault = _requantize_ratio_dropped(payload, scales, c, c, heads, bk)
                for quant_out in (True, False):
                    hargs = (payload, qs, *hk, *hv, heads, scale, quant_out, dt)
                    out = A8.flash_int8_handoff(*hargs)
                    torch.cuda.synchronize()
                    if sm90:
                        twice_same_bits(lambda: A8.flash_int8_handoff(*hargs), out,
                                        f"flash_int8_handoff {tag} quant_out={quant_out}")
                    ref = A8.flash_int8_handoff_plain(*hargs)
                    hfaults = {"kv_requantize_ratio_dropped": lambda: A8.flash_int8_handoff_plain(
                        payload, qs, *k_fault, *hv, heads, scale, quant_out, dt)}
                    o32h = lambda: A8.flash_int8_handoff_plain(payload, qs, *hk, *hv, heads,
                                                               scale, False, torch.float32)
                    if quant_out:
                        hfaults["out_scale_per_row"] = lambda: _out_scale_per_row(o32h(), heads)
                        if dv > slice_w:
                            hfaults["amax_per_slice"] = lambda: _amax_per_slice(o32h(), heads,
                                                                                slice_w)
                    r = _hold(f"flash_int8_handoff {tag} quant_out={quant_out}", out, ref,
                              hfaults, {**record, "groups": scales.shape[-1],
                                        "quant_out": quant_out})
                    note("flash_int8_handoff", r["max_abs_err"])
        for f, ok in rejected.items():
            check(ok, f"{tag}: the int8 bar rejects {f} on no input spread")

    bf, f32 = torch.bfloat16, torch.float32
    cases = [(phi, (640, 640)) for phi in SCALE_PHIS] + [("s", (480, 576)), ("m", (480, 576))]
    for phi, hw in cases:
        b = 1 if phi in ("l", "x") else 2
        for name, (n, cq, cv, heads, packed) in scale_sites(phi, hw).items():
            # at 480x576: dark3 and h2, and every packed site (h1 and h4 at
            # N = 1,080 too) for the sm90 kernel
            packed_site = packed and A._packed_heads(cq, heads)
            other = hw != (640, 640) and name not in ("dark3", "h2")
            if n <= A.NAIVE_MAX_TOKENS or (other and not packed_site):
                continue
            tag = f"phi={phi} {hw[0]}x{hw[1]} {name}"
            if hw == (640, 640) or name == "h2" or packed_site:
                flash_case(tag, b, n, cq, cv, heads, packed, bf)
            if other:
                continue
            route, bk = A.serving_route(n, cq, heads, cv, True, packed)
            if route == "int8":
                variants = packed and (cq // heads) % 128 == 0
                int8_case(tag, b, n, cq, cv, heads, bk, bf, variants)
    # fp32 (csrc/flash_fwd_f32_sm90.cu): the packed, single-head and folded
    # forms, int8 with fp32 q
    for phi, name, b in (("m", "h4", 2), ("m", "h2", 2), ("m", "dark3", 1), ("n", "h2", 2),
                         ("n", "dark3", 2), ("n", "h1", 2), ("m", "h1", 2)):
        n, cq, cv, heads, packed = scale_sites(phi)[name]
        folded = " (folded)" if packed and not A._packed_heads(cq, heads) else ""
        flash_case(f"phi={phi} {name} fp32{folded}", b, n, cq, cv, heads, packed, f32)
    n, cq, _, heads, _ = scale_sites("m")["h4"]
    n, cq, _, heads, _ = scale_sites("m")["h4"]
    int8_case("phi=m h4 fp32", 2, n, cq, cq, heads, A8.pick_blocks(n, cq, heads)[1], f32, True)

    # qmm and quant_rows at the int8 TEB projections: (name, M, C, kinds);
    # phi='l'/'x' h1 at 256 rows, K and N at full width (phi='x' qkv and the
    # MLP, 2.5-3.3 G weights, would need 20-26 GB for the float64 plain dot)
    rows = lambda m, c, dt: (torch.randn(m, c, generator=gen, device=DEVICE) * 2 + 0.5).to(dt)
    proj = []
    for phi in ("n", "m"):
        for name in ("h1", "h2"):
            n, c = scale_sites(phi)[name][:2]
            proj.append((f"phi={phi} {name} batch 2", 2 * n, c, ("qkv", "attn_out", "mlp")))
    proj.append(("phi=l h1, 256 rows", 256, scale_sites("l")["h1"][1], ("qkv", "attn_out")))
    proj.append(("phi=x h1, 256 rows", 256, scale_sites("x")["h1"][1], ("attn_out",)))

    def run(form, *args, **kw):
        r, out = _qmm_case(*args, **kw)
        for key in ("quant_rows", "qmm"):
            if key in r:
                note(key + ("_int4" if kw.get("qmax") == 7 and key == "quant_rows" else "")
                     + ("_f32" if kw.get("dtype") == "float32" else ""), r[key]["max_abs_err"])
        return out

    for name, m, c, kinds in proj:
        if "qkv" in kinds:
            run("qmm", f"{name} qkv", rows(m, c, bf), None, m, c, 3 * c, 0, None, False,
                ln=True)
        run("qmm", f"{name} attn_out", rows(m, c, bf), None, m, c, c, 0, None, True, ln=False)
        if "mlp" not in kinds:
            continue
        g = QM.quant_out_group_width(m, c, 4 * c, 0)
        z8 = run("qmm", f"{name} mlp1", rows(m, c, bf), None, m, c, 4 * c, 0, "gelu", False,
                 group=g, ln=True)
        run("qmm", f"{name} mlp2", z8[0], z8[1], m, 4 * c, c, 4 * c // g, None, True)
        if c % 128 == 0:  # the w4a4 mlp1 (configuration A)
            run("qmm", f"{name} w4a4 mlp1", rows(m, c, bf), None, m, c, 4 * c, 0, "gelu", False,
                group=4 * c, ln=True, qmax=7)
    # fp32: quant_rows of fp32 rows, qmm with an fp32 residual and output
    name, m, c, _ = proj[2]  # phi='m' h1 (K = 4,792)
    run("qmm", f"{name} qkv fp32", rows(m, c, f32), None, m, c, 3 * c, 0, None, False, ln=True,
        dtype="float32")
    run("qmm", f"{name} attn_out fp32 ln_out", rows(m, c, f32), None, m, c, c, 0, None, True,
        ln_out=True, ln=False, dtype="float32")
    print(json.dumps({"scale_kernel_max_abs_err": err}), flush=True)
    return err


def bf16_path_calls(model, images, f32: bool = False) -> dict:
    """Every flash_mha_packed / flash_single launch of one forward, recorded
    with its arguments, held against its plain version on the same
    activations (the kernel bar; fp32: the fp32 bar) and timed beside its
    bound, its plain version and SDPA on the same shapes."""
    import torch
    import torch.nn.functional as F

    from transparent_object_detection_tpu_torch.ops import attention as A

    calls = []
    real = {"flash_mha_packed": (A.flash_mha_packed, A.flash_mha_packed_plain),
            "flash_single": (A.flash_single, A.flash_single_plain)}

    def recording(name, kernel):
        def launch(*args):
            out = kernel(*args)
            calls.append((name, args, out))
            return out
        launch.launches = launch.sm90_launches = launch.f32_launches = 0
        return launch

    for name, (kernel, _) in real.items():
        setattr(A, name, recording(name, kernel))
    try:
        with torch.inference_mode():
            model(images)
    finally:
        for name, (kernel, _) in real.items():
            setattr(A, name, kernel)
    rows = {name: [] for name in real}
    bar = _f32_bar_used if f32 else bar_used
    peak = F32_FLASH_FLOPS if f32 else PEAK_BF16_FLOPS
    for i, (name, args, out) in enumerate(calls):
        kernel, plain = real[name]
        with torch.inference_mode():
            if f32:  # the f32_sm90 kernel: a second launch, the same bits
                check(torch.equal(kernel(*args), out),
                      f"{name} launch {i}: two launches gave different bits")
            ref = plain(*args)
            used = bar(out, ref)
            check(used <= 1.0, f"{name} launch {i} on the path's activations: {used:.3g}x the bar")
            if name == "flash_mha_packed":
                qkv, h, scale = args
                b, n, c3 = qkv.shape
                cq = cv = c3 // 3
                q, k, v = (A._heads_first(t, h).contiguous() for t in qkv.chunk(3, dim=-1))
            else:
                q, k, v, scale = args
                b, n, cq = q.shape
                cv, h = v.shape[-1], 1
            ops = 2.0 * b * n * n * (cq + cv)
            nbytes = out.element_size() * (b * n * (2 * cq + cv) + b * n * cv)
            t_ops, t_bytes = ops / peak, nbytes / PEAK_BYTES
            ms = timed_ms(lambda: kernel(*args), 5, 1)
            plain_ms = timed_ms(lambda: plain(*args), 1, 1)
            lib = timed_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=scale), 5, 1)
            form = (A.packed_fwd_form(cq // h, out.dtype) if name == "flash_mha_packed"
                    else ("f32_sm90" if f32 else "mma_sync"))
        rows[name].append({"launch": i, "b": b, "n": n, "cq": cq, "cv": cv, "heads": h,
                           "form": form, "bar_used": used,
                           "max_abs_err": float((out.float() - ref.float()).abs().max()),
                           "ms": ms, "plain_ms": plain_ms,
                           "bound_ms": max(t_ops, t_bytes) * 1e3,
                           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                           "library_ms": lib})
        print(json.dumps({"path_call": name + ("_f32" if f32 else ""), **rows[name][-1]}),
              flush=True)
    return rows


def _set_class_biases(model, images, candidates):
    """Class biases so that about `candidates` anchors an image pass the 0.5
    confidence (as a trained detector's few dozen would)."""
    import torch

    with torch.no_grad():
        towers = [getattr(model.head, f"cls{i}") for i in range(3)]
        for t in towers:
            t.out.bias.zero_()
        logits = torch.logit(model(images)["decoded"][..., 4:].amax(-1), eps=1e-6).flatten()
        shift = float(logits.topk(candidates * images.shape[0]).values[-1])
        for t in towers:
            t.out.bias.fill_(-shift)


SCALE_LIMITS = {"bf16": (BOX_LIMIT_PX, SCORE_LIMIT, SLICE_REJECTS[0]),
                "int8": (INT8_BOX_LIMIT_PX, INT8_SCORE_LIMIT, INT8_SLICE_REJECTS[0]),
                "A": (VARIANT_BOX_LIMIT_PX["A"], VARIANT_SCORE_LIMIT["A"],
                      VARIANT_SLICE_REJECTS[0]),
                "B": (VARIANT_BOX_LIMIT_PX["B"], VARIANT_SCORE_LIMIT["B"],
                      VARIANT_SLICE_REJECTS[0]),
                "fp32": (F32_BOX_LIMIT_PX, F32_SCORE_LIMIT, SLICE_REJECTS[0]),
                "fp32 int8": (INT8_BOX_LIMIT_PX, INT8_SCORE_LIMIT, INT8_SLICE_REJECTS[0])}


def _parity(model, predictor, images, raw, shapes, pcfg, tag) -> dict:
    """`decoded` and the detection sets of the kernels against the same
    model on plain versions, and the plain versions with the planted fault
    that the limits must reject; returns the reading, or raises."""
    import torch

    from transparent_object_detection_tpu_torch.models.detector import set_attention_impl
    from transparent_object_detection_tpu_torch.ops import quant_matmul as QM

    box_limit, score_limit, fault = SCALE_LIMITS[tag]

    def run_plain():
        set_attention_impl(model, "plain")
        try:
            return model(images)["decoded"], predictor.detect_raw_batch(raw, shapes)
        finally:
            set_attention_impl(model, None)

    with torch.inference_mode():
        dec_k = model(images)["decoded"]
        dets = predictor.detect_raw_batch(raw, shapes)
        dec_p, dets_p = run_plain()
        with (planted(fault) if fault in PLANTED_FAULTS else QMM_FAULTS[fault](QM)):
            dec_f, _ = run_plain()
    check(bool(torch.isfinite(dec_k).all()), f"{tag}: non-finite decoded")
    diff = lambda d: {"decoded_box_max_abs_px": float((d[..., :4] - dec_p[..., :4]).abs().max()),
                      "decoded_score_max_abs": float((d[..., 4:] - dec_p[..., 4:]).abs().max())}
    sound, faulty = diff(dec_k), diff(dec_f)
    reading = {"kernels": sound, "planted_fault": {fault: faulty},
               "num_detections": dets["num_detections"].cpu().tolist(),
               "num_detections_plain": dets_p["num_detections"].cpu().tolist(),
               "matched_in_plain": match_per_anchor(dec_k, dec_p, pcfg),
               "plain_matched_here": match_per_anchor(dec_p, dec_k, pcfg),
               "limits": {"box_px": box_limit, "score": score_limit}}
    print(json.dumps({"scale_slice_parity": tag, **reading}), flush=True)
    check(sound["decoded_box_max_abs_px"] <= box_limit and
          sound["decoded_score_max_abs"] <= score_limit,
          f"{tag}: decoded differs from the plain run by {sound}")
    check(faulty["decoded_box_max_abs_px"] > box_limit or
          faulty["decoded_score_max_abs"] > score_limit,
          f"{tag}: the limits do not reject the planted fault {fault}: {faulty}")
    check(bool((dets["num_detections"] > 0).all()), f"{tag}: empty detections")
    check(bool((dets["num_detections"] < pcfg.max_detections).all()),
          f"{tag}: max_detections cut the detections; the sets are not comparable")
    for key in ("matched_in_plain", "plain_matched_here"):
        m = reading[key]
        check(m["compared"] > 0 and m["unmatched"] == 0, f"{tag}: detection sets differ: {m}")
    return reading


def scale_slice_phase(card: str, phi: str, tags, batches, timed: bool) -> dict:
    """FocusModel at `phi` 640x640, full width, seeded random weights, served
    through Predictor.detect_raw_batch in each configuration of `tags`
    ("bf16", "int8", "A", "B") from the bf16 model's weights: the launches of
    each counted batch in `batches` equal to `expected_launches`; `decoded`
    and the detection sets against the same configuration on plain versions
    (batch 4, or 2 when 2 is the largest counted batch); with `timed`, every
    launch of a batch-2 forward against its plain version and timed, batch-1
    latency, batch-32 throughput and a profile. Then one fp32 forward at
    batch 2 (every int8 flag off at phi='m', int8 at phi='n') against plain,
    its launches counted."""
    import numpy as np
    import torch

    from transparent_object_detection_tpu_torch.config import (
        Int8Variants,
        ModelConfig,
        PredictConfig,
    )
    from transparent_object_detection_tpu_torch.inference import Predictor
    from transparent_object_detection_tpu_torch.models.detector import build_model
    from transparent_object_detection_tpu_torch.ops.preprocess import letterbox_batch

    pcfg = PredictConfig()
    t0 = time.perf_counter()
    base = build_model(ModelConfig(phi=phi), device=DEVICE, seed=SEED)
    n_params = sum(p.numel() for p in base.parameters())
    print(json.dumps({"scale_model": phi, "params": n_params,
                      "build_s": time.perf_counter() - t0}), flush=True)
    rng = np.random.default_rng(SEED)
    nimg = 4 if max(batches) > 2 else 2
    raw = rng.integers(0, 256, size=(nimg, 480, 640, 3), dtype=np.uint8)
    shapes = np.tile(np.array([[480, 640]], np.float32), (nimg, 1))
    raw32 = rng.integers(0, 256, size=(32, 480, 640, 3), dtype=np.uint8)
    shapes32 = np.tile(np.array([[480, 640]], np.float32), (32, 1))
    images = letterbox_batch(torch.as_tensor(raw, device=DEVICE).float() / 255.0, (640, 640))
    with torch.no_grad():
        base.backbone.dark3_attn.gamma.fill_(0.5)

    def clone(cfg, variants=None):
        model = build_model(cfg, device=DEVICE, seed=None, int8_variants=variants)
        model.load_state_dict(base.state_dict())
        return model

    results = {}
    for tag in tags:
        int8 = tag != "bf16"
        cfg = ModelConfig(phi=phi, int8_dense=int8, int8_attn=int8)
        model = clone(cfg, Int8Variants(**VARIANT_CONFIGS.get(tag, {}))) if int8 else base
        _set_class_biases(model, images, INT8_CANDIDATES_PER_IMAGE if int8
                          else CANDIDATES_PER_IMAGE)
        predictor = Predictor(model, cfg, pcfg, device=DEVICE)
        launches = {}
        for b in batches:  # the main path, counted: counts to 0 just before, read just after
            r, sh = (raw32, shapes32) if b == 32 else (raw[:b], shapes[:b])
            reset_counts()
            dets_b = predictor.detect_raw_batch(r, sh)
            torch.cuda.synchronize()
            launches[b] = read_counts()
            want = expected_launches(phi, b, tag)
            check(launches[b] == want, f"phi={phi} {tag} batch {b}: launches {launches[b]}, "
                                       f"expected {want}")
            check(bool(torch.isfinite(dets_b["boxes"]).all()), f"phi={phi} {tag}: non-finite")
        print(json.dumps({"scale_main_path_launches": {"phi": phi, "config": tag,
                                                       "per_forward": launches}}), flush=True)
        parity = _parity(model, predictor, images, raw, shapes, pcfg, tag)
        record = {"launches": launches, "parity": parity}
        if timed:
            record["rows"] = (bf16_path_calls(model, images[:2]) if not int8
                              else int8_path_calls(model, images[:2]))
            # two timed batch-32 steps, not three: the smoke's time limit
            record["perf"] = {"card": card, "model": f"phi={phi} 640x640 {tag}",
                              "params": n_params,
                              **serving_timing(model, predictor, raw, shapes, images, rng,
                                               iters=2)}
            print(json.dumps({"scale_slice_perf": record["perf"]}), flush=True)
        results[tag] = record
        if model is not base:
            del model, predictor
            torch.cuda.empty_cache()

    # one fp32 forward at batch 2, counted, against plain
    tag = "fp32" if phi != "n" else "fp32 int8"
    int8 = tag == "fp32 int8"
    cfg = ModelConfig(phi=phi, compute_dtype="float32", int8_dense=int8, int8_attn=int8)
    model = clone(cfg, Int8Variants())
    predictor = Predictor(model, cfg, pcfg, device=DEVICE)
    reset_counts()
    with torch.inference_mode():
        model(images[:2])
    torch.cuda.synchronize()
    counts = read_counts()
    want = expected_launches(phi, 2, "int8" if int8 else "bf16", f32=True)
    check(counts == want, f"phi={phi} {tag}: launches {counts}, expected {want}")
    parity = _parity(model, predictor, images[:2], raw[:2], shapes[:2], pcfg, tag)
    rows = bf16_path_calls(model, images[:2], f32=True)  # the fp32 flash launches
    if int8:
        rows = {**int8_path_calls(model, images[:2]), "flash_single": rows["flash_single"]}
    results[tag] = {"launches": {2: counts}, "parity": parity, "rows": rows}
    del model, predictor, base
    torch.cuda.empty_cache()
    return results


def serve_matrix_phase(card: str) -> dict:
    """Every scale the card holds (phi 'n', 's', 'm') in bf16 and fp32
    compute, in each serving configuration (bf16, int8, A, B), from one set
    of seeded weights per scale: one counted batch-1
    Predictor.detect_raw_batch each, its launches equal to
    `expected_launches` and its boxes finite. Parity is held by the slices
    above."""
    import numpy as np
    import torch

    from transparent_object_detection_tpu_torch.config import (
        Int8Variants,
        ModelConfig,
        PredictConfig,
    )
    from transparent_object_detection_tpu_torch.inference import Predictor
    from transparent_object_detection_tpu_torch.models.detector import build_model

    rng = np.random.default_rng(SEED)
    raw = rng.integers(0, 256, size=(1, 480, 640, 3), dtype=np.uint8)
    shapes = np.array([[480, 640]], np.float32)
    served = {}
    for phi in ("n", "s", "m"):
        base = build_model(ModelConfig(phi=phi), device=DEVICE, seed=SEED)
        for dtype in ("bfloat16", "float32"):
            for tag in ("bf16", "int8", *VARIANT_CONFIGS):
                int8 = tag != "bf16"
                cfg = ModelConfig(phi=phi, compute_dtype=dtype, int8_dense=int8, int8_attn=int8)
                model = build_model(cfg, device=DEVICE, seed=None,
                                    int8_variants=Int8Variants(**VARIANT_CONFIGS.get(tag, {})))
                model.load_state_dict(base.state_dict())
                predictor = Predictor(model, cfg, PredictConfig(), device=DEVICE)
                reset_counts()
                with torch.inference_mode():
                    dets = predictor.detect_raw_batch(raw, shapes)
                torch.cuda.synchronize()
                counts = read_counts()
                want = expected_launches(phi, 1, tag, f32=dtype == "float32")
                what = f"phi={phi} {dtype} {tag}"
                check(counts == want, f"{what}: launches {counts}, expected {want}")
                check(bool(torch.isfinite(dets["boxes"]).all()), f"{what}: non-finite boxes")
                served[what] = {k: v for k, v in counts.items() if v}
                del model, predictor
        del base
        torch.cuda.empty_cache()
    print(json.dumps({"card": card, "served_batch1": served}), flush=True)
    return served


# ---------------------------------------------------------------------------
# training at every scale: rows 9-11 over their whole JAX domain (phi 'n',
# 'm', 'l', 'x' widths, N = 4,320, fp32), the folded route's padding, phi='m'
# 640x640 training at full width with remat, phi='n' in bf16 and fp32
# ---------------------------------------------------------------------------

F32_TRAIN_NORM_RTOL = 1e-4  # fp32: kernels and plain versions differ in summation order only
F32_LSE_ATOL = 1e-4
TRAIN_KERNELS = ("flash_fwd_lse", "flash_bwd_dq", "flash_bwd_dkv")


def train_call_sites(phi: str, hw=(640, 640)) -> dict:
    """{site: (route, N, q/k width, v width, heads, scale)} of the training
    kernel calls of one step at `phi`: the operands as the route hands them
    to the kernels (folded heads: one call on B*H single heads, each width
    zero-padded to a multiple of 8; per image, so B*H is heads * batch)."""
    from transparent_object_detection_tpu_torch.ops import attention as A

    out = {}
    for name, (n, cq, cv, heads, _) in scale_sites(phi, hw).items():
        route = A.train_route(n, cq, heads, cv)
        if route == "naive":
            continue
        scale = (cq // heads) ** -0.5 if heads > 1 else 1.0
        if route == "folded":
            pad8 = lambda d: -(-d // 8) * 8
            out[name] = (route, n, pad8(cq // heads), pad8(cv // heads), heads, scale)
        else:
            out[name] = (route, n, cq, cv, heads, scale)
    return out


def _train_call_inputs(gen, b, route, n, cq, cv, heads, scale, score_std, dtype):
    """q, k, v, dO and the call's head count of one training site at batch
    b: packed heads as column views of one packed qkv; folded heads as the
    fold copy makes them, (b * heads, N, width) with the columns past the
    head width (scale ** -2) zero."""
    import torch

    randn = lambda *s: torch.randn(*s, generator=gen, device=DEVICE)
    if route == "packed":
        std = (score_std / (scale * (cq // heads) ** 0.5)) ** 0.5
        qkv = randn(b, n, 3 * cq)
        qkv[..., :2 * cq] *= std
        qkv = qkv.to(dtype)
        return qkv[..., :cq], qkv[..., cq:2 * cq], qkv[..., 2 * cq:], randn(b, n, cv).to(dtype), \
            heads
    bb, d = (b * heads, round(scale ** -2)) if route == "folded" else (b, cq)
    std = (score_std / (scale * d ** 0.5)) ** 0.5
    q, k = (randn(bb, n, cq) * std for _ in range(2))
    v, do = randn(bb, n, cv), randn(bb, n, cv)
    if route == "folded":
        for t in (q, k):
            t[..., d:] = 0
        for t in (v, do):
            t[..., d:] = 0
    return q.to(dtype), k.to(dtype), v.to(dtype), do.to(dtype), 1


def _bwd_variant(q, k, v, do, lse, dcap, scale, h, qk_cols=None, v_cols=None, keys=None):
    """The plain backward's arithmetic (attention_vjp._bwd_plain) with a
    planted fault: q/k columns `qk_cols` (lo, hi) left out of the
    recomputed S, v/dO columns `v_cols` left out of dP, or only the first
    `keys` keys read. -> {"dq", "dk", "dv"}"""
    import torch

    from transparent_object_detection_tpu_torch.ops import attention_vjp as V

    qh, kh, vh, doh = (V._split_heads(t, h).float() for t in (q, k, v, do))
    if keys is not None:
        kh, vh = kh[..., :keys, :], vh[..., :keys, :]
    lse4, d4 = V._stats4(lse, h).float(), V._stats4(dcap, h).float()

    def without(t, cols):
        if cols is None:
            return t
        t = t.clone()
        t[..., cols[0]:cols[1]] = 0
        return t

    qs, ks = without(qh, qk_cols), without(kh, qk_cols)
    vd = without(vh, v_cols)
    s_scale = scale * V.A.LOG2E
    dq = torch.empty_like(qh)
    dk, dv = torch.zeros_like(kh), torch.zeros_like(vh)
    for i in range(0, qh.shape[-2], 1024):
        rows = slice(i, i + 1024)
        s = torch.matmul(qs[..., rows, :], ks.transpose(-1, -2))
        p = torch.exp2(s * s_scale - lse4[..., rows, :] * V.A.LOG2E)
        dob = doh[..., rows, :]
        dob_d = without(dob, v_cols)
        dv += torch.matmul(p.to(do.dtype).float().transpose(-1, -2), dob)
        ds = p * (torch.matmul(dob_d, vd.transpose(-1, -2)) - d4[..., rows, :]) * scale
        dq[..., rows, :] = torch.matmul(ds.to(k.dtype).float(), kh)
        dk += torch.matmul(ds.to(q.dtype).float().transpose(-1, -2), qh[..., rows, :])
    if keys is not None:  # the dropped keys' gradients stay unwritten
        pad = lambda t: torch.nn.functional.pad(t, (0, 0, 0, q.shape[1] - keys))
        dk, dv = pad(dk), pad(dv)
    return {name: V.A._heads_last(t).to(q.dtype)
            for name, t in (("dq", dq), ("dk", dk), ("dv", dv))}


def _scale_train_faults(q, k, v, do, lse, dcap, scale, h, sound):
    """The planted faults of the width loop and the tails, as the plain
    backward with each fault computes them -> {fault: {grad: value}}: a
    q/k slab left out of S (columns 128..255, or the upper half of widths
    up to 128), a v/dO slab left out of dP in the dq and dk passes, the last
    dv pass (columns from the last multiple of 256) unwritten, the tail key
    tile (the last 32 keys) left out."""
    d1, d2 = q.shape[-1] // h, v.shape[-1] // h
    half = lambda d: (128, 256) if d > 128 else (d // 2, d)
    n = q.shape[1]
    faults = {"qk_slab_dropped": _bwd_variant(q, k, v, do, lse, dcap, scale, h,
                                              qk_cols=half(d1))}
    vf = _bwd_variant(q, k, v, do, lse, dcap, scale, h, v_cols=half(d2))
    faults["v_slab_dropped_from_dP"] = {"dq": vf["dq"], "dk": vf["dk"]}
    last = (d2 - 1) // 256 * 256
    dv = sound["dv"].clone().reshape(*sound["dv"].shape[:2], h, d2)
    dv[..., last:] = 0
    faults["last_dv_pass_dropped"] = {"dv": dv.reshape(sound["dv"].shape)}
    tail = _bwd_variant(q, k, v, do, lse, dcap, scale, h, keys=n - (n % 32 or 32))
    faults["tail_key_tile_dropped"] = {"dq": tail["dq"]}
    return faults


TRAIN_SCALE_CASES = tuple((phi, (640, 640), "bfloat16") for phi in SCALE_PHIS) + (
    ("s", (480, 576), "bfloat16"), ("m", (480, 576), "bfloat16"),
    ("n", (640, 640), "float32"), ("n", (480, 576), "float32"))


def train_scale_kernel_phase() -> dict:
    """Rows 9-11 at every training site of phi 'n', 'm', 'l' and 'x'
    640x640, at 480x576 (N = 4,320) and in fp32, batch 2, near-flat and
    peaked inputs: the forward's out within the kernel bar (fp32: the fp32
    bar) and lse within LSE_ATOL (fp32: 1e-4), the gradients within the
    gradient bar, the backward bit-identical over two runs; each planted
    fault (those of the phi='s' phase, a q/k slab left out of S, a v/dO
    slab left out of dP, the last dv pass unwritten, the tail key tile
    left out) rejected on some input spread. Times the phi='m' sites (bf16)
    and the phi='n' sites (fp32) beside bound, plain and SDPA forward /
    backward. Returns {"rows": {form: [site rows]}, "err": {form: max abs}}."""
    import torch
    import torch.nn.functional as F

    from transparent_object_detection_tpu_torch.ops import attention_vjp as V

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 7)
    rows = {}
    err = {}
    for phi, hw, dtype in TRAIN_SCALE_CASES:
        dt = getattr(torch, dtype)
        is32 = dt == torch.float32
        sites = train_call_sites(phi, hw)
        if is32 and phi == "n" and hw == (640, 640):
            m_h4 = train_call_sites("m")["h4"]
            sites = {**sites, "phi=m h4": m_h4}
        for name, (route, n, cq, cv, heads, scale) in sites.items():
            # at 480x576: dark3, h2 and every packed site (h1, h4 at N = 1,080)
            if hw != (640, 640) and name not in ("dark3", "h2") and route != "packed":
                continue
            tag = f"phi={phi} {hw[0]}x{hw[1]} {name} {route}" + (" fp32" if is32 else "")
            bar = _f32_bar_used if is32 else bar_used
            lse_tol = F32_LSE_ATOL if is32 else LSE_ATOL
            rejected = {}
            readings = {k: [] for k in TRAIN_KERNELS}
            for score_std in SCORE_STDS:
                q, k, v, do, h = _train_call_inputs(gen, 2, route, n, cq, cv, heads, scale,
                                                    score_std, dt)
                out, lse = V.flash_fwd_lse(q, k, v, scale, h)
                out2, lse2 = V.flash_fwd_lse(q, k, v, scale, h)
                torch.cuda.synchronize()
                check(torch.equal(out, out2) and torch.equal(lse, lse2),
                      f"flash_fwd_lse {tag}: two runs gave different bits")
                pout, plse = V.flash_fwd_lse_plain(q, k, v, scale, h)
                fwd = {"score_std": score_std, "bar_used": bar(out, pout),
                       "max_abs_err": float((out.float() - pout.float()).abs().max()),
                       "lse_max_abs_err": float((lse - plse).abs().max())}
                check(fwd["bar_used"] <= 1.0 and fwd["lse_max_abs_err"] <= lse_tol,
                      f"flash_fwd_lse {tag}: {fwd}")
                for f, (fo, fl) in _fwd_faults(V, q, k, v, scale, h).items():
                    used = max(bar(fo, pout), float((fl - plse).abs().max()) / lse_tol)
                    rejected[f"fwd {f}"] = max(rejected.get(f"fwd {f}", 0.0), used)
                readings["flash_fwd_lse"].append(fwd)

                dcap = V.compute_dcap(pout, do, h)
                args = (q, k, v, do, plse, dcap, scale, h)
                V.reset_launch_counts()
                got = {"dq": V.flash_bwd_dq(*args)}
                got["dk"], got["dv"] = V.flash_bwd_dkv(*args)
                if is32:  # every fp32 backward on csrc/flash_bwd_f32_sm90.cu
                    check(V.flash_bwd_dq.f32_launches == 1 and V.flash_bwd_dkv.f32_launches == 1,
                          f"{tag}: the fp32 backward did not run the f32_sm90 kernels")
                again = {"dq": V.flash_bwd_dq(*args)}
                again["dk"], again["dv"] = V.flash_bwd_dkv(*args)
                torch.cuda.synchronize()
                check(all(torch.equal(got[g], again[g]) for g in got),
                      f"flash backward {tag}: two runs gave different bits")
                ref = {"dq": V.flash_bwd_dq_plain(*args)}
                ref["dk"], ref["dv"] = V.flash_bwd_dkv_plain(*args)
                faults = {**_bwd_faults(V, *args),
                          **_scale_train_faults(*args, sound=ref)}
                for kname, grads in (("flash_bwd_dq", ("dq",)), ("flash_bwd_dkv", ("dk", "dv"))):
                    r = {"score_std": score_std, "bitwise_repeat": True}
                    for g in grads:
                        r[g] = grad_reading(got[g], ref[g], is32)
                        check(r[g]["bar_used"] <= 1.0, f"{kname} {tag} {g}: {r[g]}")
                    r["bar_used"] = max(r[g]["bar_used"] for g in grads)
                    r["max_abs_err"] = max(r[g]["max_abs_err"] for g in grads)
                    readings[kname].append(r)
                    for f, fg in faults.items():
                        used = [grad_reading(fg[g], ref[g], is32)["bar_used"]
                                for g in grads if g in fg]
                        if used:
                            key = f"{kname} {f}"
                            rejected[key] = max(rejected.get(key, 0.0), max(used))
            for f, used in rejected.items():
                check(used > 1.0, f"{tag}: the bar rejects {f} on no input spread ({used:.3g}x)")
            print(json.dumps({"train_scale_case": tag, "n": n, "cq": cq, "cv": cv, "heads": h,
                              "readings": readings, "faults_rejected_by": rejected}), flush=True)
            suffix = " fp32" if is32 else ""
            for kname in TRAIN_KERNELS:  # by kernel: the sm90 ones' sites apart
                rule = V.lse_fwd_form if kname == "flash_fwd_lse" else V.bwd_form
                form = kname + suffix + {"sm90": " sm90", "single_sm90": " single_sm90"}.get(
                    rule(q.shape[-1] // h, v.shape[-1] // h, h, q.dtype), "")
                err[form] = max(err.get(form, 0.0),
                                max(x["max_abs_err"] for x in readings[kname]))
            # phi='m' bf16, phi='n' fp32 and phi='n' bf16's one-head sites
            timed = (phi == "m" and hw == (640, 640) and not is32) or \
                (is32 and phi == "n" and hw == (640, 640) and name != "phi=m h4") or \
                (phi == "n" and hw == (640, 640) and not is32 and route != "packed")
            if not timed:
                continue
            # time on the last (peaked) inputs
            b = q.shape[0]
            cq_all, cv_all = q.shape[-1], v.shape[-1]
            costs = _train_costs(b, n, cq_all, cv_all, h)
            kern = {"flash_fwd_lse": lambda: V.flash_fwd_lse(q, k, v, scale, h),
                    "flash_bwd_dq": lambda: V.flash_bwd_dq(*args),
                    "flash_bwd_dkv": lambda: V.flash_bwd_dkv(*args)}
            plain = {"flash_fwd_lse": lambda: V.flash_fwd_lse_plain(q, k, v, scale, h),
                     "flash_bwd_dq": lambda: V.flash_bwd_dq_plain(*args),
                     "flash_bwd_dkv": lambda: V.flash_bwd_dkv_plain(*args)}
            qh, kh, vh, doh = (V._split_heads(t, h).detach().contiguous() for t in (q, k, v, do))
            qh, kh, vh = (t.requires_grad_() for t in (qh, kh, vh))
            sdpa_fwd = timed_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=scale),
                                5, 1)

            def sdpa_fwd_bwd():
                F.scaled_dot_product_attention(qh, kh, vh, scale=scale).backward(doh)
            sdpa_bwd = max(timed_ms(sdpa_fwd_bwd, 5, 1) - sdpa_fwd, 0.0)
            library = {"flash_fwd_lse": sdpa_fwd, "flash_bwd_dq": sdpa_bwd,
                       "flash_bwd_dkv": sdpa_bwd}
            for kname in TRAIN_KERNELS:
                peak = F32_FLASH_FLOPS if is32 else PEAK_BF16_FLOPS
                ops, nbytes = costs[kname]
                nbytes *= q.element_size() / 2
                t_ops, t_bytes = ops / peak, nbytes / PEAK_BYTES
                extra = {"form": (V.lse_fwd_form if kname == "flash_fwd_lse" else V.bwd_form)(
                    cq_all // h, cv_all // h, h, q.dtype)}
                if is32:  # the FFMA kernel's bound (fp32 on the CUDA cores), beside
                    extra["bound_fp32_fma_ms"] = ops / PEAK_F32_FLOPS * 1e3
                row = dict(node=name, route=route, b=b, n=n, cq=cq_all, cv=cv_all, heads=h,
                           **extra, readings=readings[kname],
                           max_abs_err=max(x["max_abs_err"] for x in readings[kname]),
                           ms=timed_ms(kern[kname], 5, 1),
                           plain_ms=timed_ms(plain[kname], 1, 1), library_ms=library[kname],
                           bound_ms=max(t_ops, t_bytes) * 1e3,
                           bound_by="operations" if t_ops >= t_bytes else "bytes")
                rows.setdefault(kname + (" fp32 phi=n" if is32 else f" phi={phi}"), []).append(row)
                print(json.dumps({"kernel": kname + suffix, **row}), flush=True)
    print(json.dumps({"train_scale_kernel_max_abs_err": err}), flush=True)
    return {"rows": rows, "err": err}


def _leaky_fold(real_fold):
    """Planted fault: the fold copy's backward hands dq's first padded
    column back in place of its last real column (a padded fold column
    leaking into dq; q only)."""
    import torch

    class Leak(torch.autograd.Function):
        @staticmethod
        def forward(ctx, t, heads):
            ctx.heads, ctx.shape = heads, t.shape
            return real_fold(t.detach(), heads)

        @staticmethod
        def backward(ctx, g):
            b, n, c = ctx.shape
            d = c // ctx.heads
            g4 = g.reshape(b, ctx.heads, n, -1)
            cols = torch.cat([g4[..., :d - 1], g4[..., d:d + 1]], dim=-1)
            return cols.transpose(1, 2).reshape(b, n, c), None

    calls = []

    def fold(t, heads):
        calls.append(1)
        return Leak.apply(t, heads) if len(calls) % 3 == 1 else real_fold(t, heads)
    return fold


def folded_route_check() -> dict:
    """The folded training route through `attention(..., train=True)` at
    the odd-width sites (phi='n' h1, 3 heads of 283; phi='m' h1, 8 of 599;
    batch 2): output and the gradients of q, k, v with kernels against the
    plain route, and the plain route with the padded fold column leaking
    into dq, which the gradient bar must reject."""
    import torch

    from transparent_object_detection_tpu_torch.ops import attention as A

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 8)
    out = {}
    for phi in ("n", "m"):
        n, c, _, heads, _ = scale_sites(phi)["h1"]
        check(A.train_route(n, c, heads) == "folded" and (c // heads) % 8,
              f"phi={phi} h1 is not an odd-width folded site")
        scale = (c // heads) ** -0.5
        std = (2.0 / (scale * (c // heads) ** 0.5)) ** 0.5
        base = [(torch.randn(2, n, c, generator=gen, device=DEVICE) * w).bfloat16()
                for w in (std, std, 1.0)]
        g = torch.randn(2, n, c, generator=gen, device=DEVICE).bfloat16()

        def run(impl):
            leaves = [t.clone().requires_grad_() for t in base]
            o = A.attention(*leaves, scale, impl=impl, num_heads=heads, train=True)
            o.backward(g)
            return o.detach(), [t.grad for t in leaves]

        ok, gk = run(None)
        op, gp = run("plain")
        real = A._fold_heads
        A._fold_heads = _leaky_fold(real)
        try:
            _, gf = run("plain")
        finally:
            A._fold_heads = real
        r = {"out_bar_used": bar_used(ok, op),
             "grads": [grad_reading(a, b)["bar_used"] for a, b in zip(gk, gp)],
             "leak_into_dq_bar_used": grad_reading(gf[0], gp[0])["bar_used"]}
        print(json.dumps({"folded_route": f"phi={phi} h1", "n": n, "heads": heads,
                          "width": c // heads, **r}), flush=True)
        check(r["out_bar_used"] <= 1.0 and max(r["grads"]) <= 1.0,
              f"phi={phi} h1 folded route with kernels differs from plain: {r}")
        check(r["leak_into_dq_bar_used"] > 1.0,
              f"phi={phi} h1: the bar does not reject a padded column leaking into dq: {r}")
        out[phi] = r
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only", file=sys.stderr)
        return 1
    from transparent_object_detection_tpu_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    t_start = t0 = time.perf_counter()
    logs = _build.build(_build.all_sources())
    print(json.dumps({"build_s": time.perf_counter() - t0, "built": sorted(logs)}), flush=True)
    for log in logs.values():
        for line in log.splitlines():
            if "Compiling entry function" in line:  # the mangled name's template arguments
                print("  " + line.split("'")[1][-64:])
            elif "registers" in line or "spill" in line:
                print("  " + line.strip())

    phase_s = {}

    def phase(name, fn, *args, **kw):
        t = time.perf_counter()
        out = fn(*args, **kw)
        phase_s[name] = time.perf_counter() - t
        print(json.dumps({"phase": name, "s": phase_s[name]}), flush=True)
        return out

    mha_rows, single_rows = phase("kernel", kernel_phase)
    int8_err = phase("int8 kernel", int8_kernel_phase)
    variant_err = phase("variant kernel", variant_kernel_phase)
    train_rows = phase("train kernel", train_kernel_phase)
    launches, bf16_model, bf16_perf = phase("slice", slice_phase, card)
    int8_launches, int8_rows, int8_perf = phase("int8 slice", int8_slice_phase, card, bf16_model,
                                                bf16_perf)
    same_run = {"bf16": {k: bf16_perf[k] for k in PERF_KEYS},
                "int8": {k: int8_perf[k] for k in PERF_KEYS}}
    variants = phase("variant slice", variant_slice_phase, card, bf16_model, same_run)
    del bf16_model
    torch.cuda.empty_cache()
    train_launches = phase("train slice", train_slice_phase, card)["launches"]
    scale_err = phase("scale kernel", scale_kernel_phase)
    m_run = phase("phi=m slice", scale_slice_phase, card, "m", ("bf16", "int8", "A", "B"),
                  (32, 1), timed=True)
    n_run = phase("phi=n slice", scale_slice_phase, card, "n", ("bf16", "int8"), (2,),
                  timed=False)
    phase("serve matrix", serve_matrix_phase, card)
    train_scale = phase("train scale kernel", train_scale_kernel_phase)
    phase("folded route", folded_route_check)
    from transparent_object_detection_tpu_torch.config import ModelConfig

    m_train = phase("phi=m train", train_slice_phase, card, ModelConfig(phi="m", remat=True),
                    train_batches=(16, 8), faults=(), rejects=())
    n_train = phase("phi=n train", train_slice_phase, card, ModelConfig(phi="n"), rejects=(),
                    timed=False)
    n32_train = phase("phi=n fp32 train", train_slice_phase, card,
                      ModelConfig(phi="n", compute_dtype="float32"), rejects=(), timed=False)
    vsrc = "transparent_object_detection_tpu_torch/csrc/flash_attn_bwd.cu"
    jv = "transparent_object_detection_tpu/ops/attention_vjp.py"
    src = "transparent_object_detection_tpu_torch/csrc/flash_attn_fwd.cu"
    sm90_src = "transparent_object_detection_tpu_torch/csrc/flash_fwd_sm90.cu"
    f32_src = "transparent_object_detection_tpu_torch/csrc/flash_fwd_f32_sm90.cu"
    bsrc = "transparent_object_detection_tpu_torch/csrc/flash_bwd_sm90.cu"
    bf32_src = "transparent_object_detection_tpu_torch/csrc/flash_bwd_f32_sm90.cu"
    qsrc = "transparent_object_detection_tpu_torch/csrc/quant_matmul.cu"
    qmm_src = "transparent_object_detection_tpu_torch/csrc/qmm_sm90.cu"
    jq = "transparent_object_detection_tpu/ops/quant_matmul.py"
    ja8 = "transparent_object_detection_tpu/ops/attention_int8.py"
    ssrc = "transparent_object_detection_tpu_torch/csrc/flash_bwd_single_sm90.cu"
    # row 1 and rows 9-11's packed sites run the sm90 kernels; row 9's
    # single-head site (dark3) the mma_sync template, rows 10 and 11's the
    # one-head sm90 kernels
    form_rows = lambda rows, sm90: [r for r in rows if (r.get("form") == "sm90") == sm90]
    form_is = lambda rows, form: [r for r in rows if r.get("form") == form]

    def by_site(entry):  # each site's time beside its bound, plain and SDPA's backward
        entry["sites"] = {r["node"]: {k: r[k] for k in ("ms", "bound_ms", "plain_ms",
                                                        "library_ms")}
                          for r in entry["shapes"]}
        return entry
    kernels = [
        kernel_entry("flash_mha_packed", sm90_src,
                     "transparent_object_detection_tpu/ops/attention.py:239", mha_rows,
                     launches["flash_mha_packed_sm90"]),
        kernel_entry("flash_single", src,
                     "transparent_object_detection_tpu/ops/attention.py:137", single_rows,
                     launches["flash_single"]),
        *int8_attention_entries("flash_mha_int8", "", int8_rows["flash_mha_int8"],
                                int8_launches, int8_err["flash_mha_int8"], f"{ja8}:58"),
        int8_kernel_entry("qmm sm90", qmm_src, f"{jq}:80", int8_rows["qmm"],
                          int8_launches["qmm"], int8_err["qmm"]),
        int8_kernel_entry("quant_rows", qsrc, f"{jq}:408", int8_rows["quant_rows"],
                          int8_launches["quant_rows"], int8_err["quant_rows"]),
        # the variants: launches of the counted batch-32 forward, times of the
        # batch-2 forward's launches, of configuration A (handoff, w4a4) or B (qout)
        *int8_attention_entries("flash_mha_int8_qout", "",
                                variants["B"]["rows"]["flash_mha_int8_qout"],
                                variants["B"]["launches"][32],
                                variant_err["flash_mha_int8_qout"], f"{ja8}:184"),
        *int8_attention_entries("flash_int8_handoff", "",
                                variants["A"]["rows"]["flash_int8_handoff"],
                                variants["A"]["launches"][32],
                                variant_err["flash_int8_handoff"], f"{ja8}:435"),
        int8_kernel_entry("quant_rows_int4", qsrc, f"{jq}:408",
                          variants["A"]["rows"]["quant_rows_int4"],
                          variants["A"]["launches"][32]["quant_rows_int4"],
                          variant_err["quant_rows_int4"]),
        kernel_entry("flash_fwd_lse", src, f"{jv}:63",
                     form_rows(train_rows["flash_fwd_lse"], False),
                     train_launches["flash_fwd_lse"]),
        by_site(kernel_entry("flash_bwd_dq single_sm90", ssrc, f"{jv}:170",
                             form_is(train_rows["flash_bwd_dq"], "single_sm90"),
                             train_launches["flash_bwd_dq_single"])),
        by_site(kernel_entry("flash_bwd_dkv single_sm90", ssrc, f"{jv}:197",
                             form_is(train_rows["flash_bwd_dkv"], "single_sm90"),
                             train_launches["flash_bwd_dkv_single"])),
        kernel_entry("flash_fwd_lse sm90", sm90_src, f"{jv}:63",
                     form_rows(train_rows["flash_fwd_lse"], True),
                     train_launches["flash_fwd_lse_sm90"]),
        kernel_entry("flash_bwd_dq sm90", bsrc, f"{jv}:170",
                     form_rows(train_rows["flash_bwd_dq"], True),
                     train_launches["flash_bwd_dq_sm90"]),
        kernel_entry("flash_bwd_dkv sm90", bsrc, f"{jv}:197",
                     form_rows(train_rows["flash_bwd_dkv"], True),
                     train_launches["flash_bwd_dkv_sm90"]),
    ]
    # the other scales' forms: phi='m' at full width (launches of the counted
    # batch-32 forward, times of the batch-2 forward's launches), fp32
    # (phi='m' flags off, phi='n' int8: launches and times of one batch-2
    # forward); errors the largest of those launches and the scale kernel phase
    ja = "transparent_object_detection_tpu/ops/attention.py"
    forms = (("flash_mha_packed", src, f"{ja}:239"), ("flash_single", src, f"{ja}:137"),
             ("flash_mha_int8", I8_SRC, f"{ja8}:58"), ("flash_mha_int8_qout", I8_SRC, f"{ja8}:184"),
             ("flash_int8_handoff", I8_SRC, f"{ja8}:435"), ("qmm", qmm_src, f"{jq}:80"),
             ("quant_rows", qsrc, f"{jq}:408"), ("quant_rows_int4", qsrc, f"{jq}:408"))
    runs = (("phi=m", m_run, ("bf16", "int8", "A", "B"), 32, ""),
            ("fp32 phi=m", m_run, ("fp32",), 2, "_f32"),
            ("fp32 phi=n", n_run, ("fp32 int8",), 2, "_f32"))
    for label, run, tags, batch, suffix in runs:
        for name, source, replaces in forms:
            tag = next((t for t in tags if run[t].get("rows", {}).get(name)), None)
            if tag is None:
                continue
            r = run[tag]
            if name.startswith(("flash_mha_int8", "flash_int8")):  # by each call's kernel
                kernels += int8_attention_entries(name, f" {label}", r["rows"][name],
                                                  r["launches"][batch],
                                                  scale_err.get(name + suffix, 0.0), replaces)
                continue
            # bf16 packed: the sm90 kernel; fp32 flash: the f32_sm90 kernel
            sm90 = name == "flash_mha_packed" and not suffix
            f32 = suffix and name in ("flash_mha_packed", "flash_single")
            kernels.append(int8_kernel_entry(
                f"{'qmm sm90' if name == 'qmm' else name} {label}",
                sm90_src if sm90 else f32_src if f32 else source, replaces,
                r["rows"][name],
                r["launches"][batch][name + ("_sm90" if sm90 else "_f32" if f32 else "")],
                scale_err.get(name + suffix, 0.0)))
    # rows 9-11 at the other scales: phi='m' 640x640 bf16 (launches of the
    # counted batch-2 remat step, times of its four sites at batch 2),
    # phi='n' bf16's one-head backward (launches of the phi='n' bf16 step,
    # times of dark3 and the folded h1) and fp32 (launches of the phi='n'
    # fp32 step, times of its sites); errors the largest of the train scale
    # kernel phase
    for label, run, suffix in (("phi=m", m_train, ""), ("phi=n", n_train, ""),
                               ("fp32 phi=n", n32_train, " fp32")):
        for name, source, sm90_source, line in (("flash_fwd_lse", src, sm90_src, 63),
                                                ("flash_bwd_dq", vsrc, bsrc, 170),
                                                ("flash_bwd_dkv", vsrc, bsrc, 197)):
            rows = train_scale["rows"].get(f"{name}{suffix} {label.split()[-1]}", [])
            if form_rows(rows, True):  # packed bf16 sites: the sm90 kernels
                kernels.append(int8_kernel_entry(
                    f"{name} sm90 {label}", sm90_source, f"{jv}:{line}", form_rows(rows, True),
                    run["launches"][name + "_sm90"], train_scale["err"][name + suffix + " sm90"]))
                rows = form_rows(rows, False)
            if form_is(rows, "single_sm90"):  # bf16 one head: dark3 and the folded h1 apart
                kernels.append(by_site(int8_kernel_entry(
                    f"{name} single_sm90 {label}", ssrc, f"{jv}:{line}",
                    form_is(rows, "single_sm90"), run["launches"][name + "_single"],
                    train_scale["err"][name + suffix + " single_sm90"])))
                rows = [r for r in rows if r.get("form") != "single_sm90"]
            if not rows:
                continue
            # every fp32 call: the f32_sm90 kernels
            f32_source = f32_src if name == "flash_fwd_lse" else bf32_src
            kernels.append(int8_kernel_entry(
                f"{name} {label}", f32_source if suffix else source, f"{jv}:{line}", rows,
                run["launches"][name + ("_f32" if suffix else "")],
                train_scale["err"].get(name + suffix, 0.0)))
    check(all(n32_train["launches"][k + "_f32"] > 0 for k in TRAIN_KERNELS),
          f"phi='n' fp32 training missed an f32_sm90 kernel: {n32_train['launches']}")
    check(n_train["launches"]["flash_fwd_lse"] > 0, "phi='n' bf16 training ran no kernel")
    print(json.dumps({"smoke_total_s": time.perf_counter() - t_start, "phase_s": phase_s}),
          flush=True)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
