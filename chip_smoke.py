#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

1. Builds every kernel in transparent_object_detection_tpu_torch/csrc/ with
   nvcc (all ten sources at once) and prints the card's name and power
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
   multiples of 64), serving and lse forms; the single-head site (dark3, and
   a ragged N) runs the one-head form of the same kernel: each input twice,
   the ring's faults and its design's (a key tile of its plan's size read
   twice, a q/k slab left out of S, a v slice written from another slice's
   P.V; SINGLE_FAULTS), at batch 2 and 1; and the backward at the same
   widths on the kernels `bwd_form` names (two heads of 64, 192 and 320 on
   csrc/flash_bwd_sm90.cu, 448 and 72 on csrc/flash_bwd_wide_sm90.cu, each
   twice for the same bits), within the gradient bar, every planted fault
   of phase 8 (with each kernel's own) rejected. Times kernel (the packed
   sites at batch 2 and batch 1), plain version, and as a yardstick only
   F.scaled_dot_product_attention (which the port never calls).
3. Slice phase: builds FocusModel at phi='s' 640x640 (bf16, seeded random
   weights, dark3 gamma 0.5 so the attention output reaches the detections,
   class biases set so that about CANDIDATES_PER_IMAGE anchors an image pass
   the 0.5 confidence), runs Predictor.detect_raw_batch on 4 non-square
   uint8 images with the launch counts reset just before and read just
   after (3 packed launches of csrc/flash_fwd_sm90.cu, 1 of its one-head
   form; the one-head launch of the path calls again for the same bits).
   Compares `decoded` and the detection sets against the same model
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
   at dark3 the forward's one-head sm90 form with its design's faults
   (SINGLE_FAULTS), twice for the same bits;
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
   (fwd-lse, dq and dk/dv 3 sm90 + 1 single_sm90 each, no serving kernel;
   every launch of the one-head forward and backward again for the same
   bits),
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
   blocks of 4,320 and 1,440; the int8 sites of phi 'l' and 'x' there, at
   batch 1) and in fp32, each against its plain version with the bars
   above; each planted fault (those above, a q/k slab of the width loop
   dropped, the tail key tile dropped, an int8 output quantized per
   warpgroup half or per v slice of a cluster (a peer's amax ignored), one
   slice's P from another query tile, the K tail of qmm dropped; and the
   int8 kernel's ring and layout faults, each launch twice for the same
   bits) rejected on some input spread. The phi 'l'/'x' neck heads (q/k
   768 to 3,584) run csrc/flash_int8_sm90.cu's wide form: Q streamed
   beside K where a resident tile does not fit, v in slices, the int8
   outputs' slices one thread-block cluster. Every bf16 one-head site
   (dark3 at every scale, the folded h1 of phi 'n' and 'm') runs the
   one-head form of
   csrc/flash_fwd_sm90.cu: each launch twice for the same bits, the ring's
   faults and its design's (SINGLE_FAULTS: with the zero-filled columns
   past 288, 600 or dark3's q/k of 32 made nonzero) rejected on some
   spread; phi='n''s one-head sites timed (row 2 at batch 2 and 1 beside
   bound, plain and SDPA). Every fp32 flash site (phi='m' h2, h4, dark3 and the
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
   asserted against the route table. Then the phi='l' slice: phi='l'
   640x640 at full width and depth (8.33 B parameters, drawn on the card
   from the seed; the int8 models built on the meta device and given the
   bf16 model's parameter tensors, so one fp32 copy is alive), bf16, int8,
   A and B as in 11, counted at batch 2 and 1, parity at batch 2, its
   throughput at the largest of batch 32, 16 and 8 that fits (from the
   peaks of a batch-1 and a batch-2 forward), peak memory and a profile.
14. Train scale kernel phase: rows 9-11 (flash_fwd_lse, flash_bwd_dq,
   flash_bwd_dkv) at every training site of phi 'n', 'm', 'l' and 'x'
   640x640 (packed heads of 128 to 1,536 and 3,584, dark3 q/k 32 to 512 and
   v 256 to 4,096, folded heads of 283 and 599 as the fold copy pads them),
   at 480x576 (N = 4,320; phi 's', 'm', 'l') and in fp32, batch 2,
   near-flat and peaked inputs, with the bars of phase 8 (fp32: 1e-4) and
   a bit-identical forward and backward (packed bf16 heads of 128 to 384 on
   csrc/flash_bwd_sm90.cu; every fp32 forward on csrc/flash_fwd_f32_sm90.cu,
   with its faults as in 10 and lse written from the running max of the
   tile before the last; every fp32 backward on csrc/flash_bwd_f32_sm90.cu,
   its f32 counters asserted at every site, with the sm90 backward's ring
   and hand-over faults and its own: the low parts dropped from dS.K, dS^T.Q
   or P^T.dO, each transposed copy's token order undone, lse or D read one
   row off; every bf16 one-head forward (dark3 at every scale, the folded
   288 and 600) on the one-head form of csrc/flash_fwd_sm90.cu, with its
   design's faults; every bf16 one-head site of phi 'n' and 'm' (dark3, the
   folded 288 and 600) on csrc/flash_bwd_single_sm90.cu, with the ring and
   hand-over faults and its own: one v slab left out of dP^T, a dV column
   slice built from another slice's dO columns, the zero-filled columns
   past 288 or 600 (or dark3's q/k of 32) made nonzero); every bf16 site
   of phi 'l' and 'x' (the neck heads of 768 to 3,584, dark3 256 / 2,048
   and 512 / 4,096, also at 480x576) on csrc/flash_bwd_wide_sm90.cu, its
   `wide_launches` asserted at every site, with the ring faults on 64-token
   tiles and its own: the last 256-column block of a gradient unwritten, a
   workspace row tile taken from another head (or, one head, another
   query or key tile);
   the phi='s' faults (with the sm90 kernels' own where they run) and those
   of the width loop (a q/k slab left out of S, a v/dO slab left out of dP,
   the last dv pass unwritten, the tail key tile left out) each rejected on
   some input spread; phi='m' (bf16), phi='n' (fp32) and phi='n' bf16's
   one-head sites timed beside bound, plain and SDPA, and phi='l''s
   backward at every site (the wide kernels) likewise. Then rows 10 and 11
   at phi='l''s tensor-parallel local shapes (WIDE_TP_SHAPES: tp 4, two
   heads of 1,536 and 768; tp 8, one head of each; batch 2) on the wide
   kernels, checked and timed the same way (`wide_tp_phase`).
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
17. The training pipeline: Trainer.fit at phi='s' 640x640, full width, bf16
   (seeded random weights) on a synthetic set of 48 training and 16
   validation JPEGs at 480x640 and 720x1280 written from seed 0: one frozen
   epoch at batch 16, one unfrozen at batch 8, mosaic and mixup, the
   threaded DataLoader, device_prefetch, the validation loss, EvalCallback
   every epoch (the port's Predictor on the EMA weights, class biases set
   as the serving phases set them) and a CheckpointManager. The launch
   counts, reset before the fit and read after it, equal the route table's
   (rows 9-11 per step, rows 1-2 per validation and EvalCallback forward,
   all on their sm90 forms). Then the callback's forward against the plain
   versions (`decoded` within the slice limits, detection sets matched),
   its stats against the same callback on the plain versions (within
   0.01; at random weights both sides score AP near 0, so this holds the
   callback's wiring and not the kernels, which the decoded and per-anchor
   checks hold), AP 1 on the ground truths, the checkpoint
   files and the last state read back bit for bit, a fit resumed from
   epoch 1's state (its losses against the uninterrupted run's, within the
   train slice's loss limit), each epoch's imgs/s beside the bare
   make_train_step's at its batch, the loader's wait per batch, and the
   checkpoints' bytes and seconds.
18. The user surface (`api_phase`): FOCUS at phi='s' 640x640 on CUDA, bf16
   and int8 (seeded init_weights, dark3's gamma 0.5, BatchNorm statistics
   drawn from the seed, class biases as above): detect_image, predict_dir,
   predict_video (an MJPG .avi written with cv2), detect_heatmap and
   get_fps (batch 1 and 32), each call's launches equal to the route
   table's; `decoded`, the detection sets and the heatmap against the same
   FOCUS on the plain versions within the slice limits; fuse against the
   unfused model (a fold without its mean term rejected); save_weights and
   load_weights bit for bit; export of both models, each .pt2 loaded in a
   fresh interpreter and run on the card: `decoded` equal to the eager
   bits, launches equal to the route table's (the program calls the
   kernels through their focus:: operators); summary's params against
   JAX's count and its flops on CUDA against the CPU plain path; FOCUS.train
   for one epoch with evaluation on a subset of the fit set on loader
   threads; the training loader over the fit set in threads against
   processes (equal batches, each turn's seconds); the predict and summary
   drivers as subprocesses;
   and the host time the operator layer adds to a launch (quant_rows on a
   small tensor, its launcher against its operator, in turns).
19. Parallel execution (`parallel_phase`): phi='s' 640x640 at full width
   with the api phase's weights, the kernels already built. Four ranks
   share the card on gloo with CUDA tensors (`parallel/launch.py`), a world
   of one rank runs on NCCL beside them, and this process serves the same
   weights without a mesh (the references). Each rank serves a global batch
   of 4 through Predictor(mesh=...) at dp1xtp2, dp1xtp4 (h2 and h4 ragged:
   their sections all-gathered) and dp2xtp2, bf16 and int8: its launches,
   counts reset just before and read just after, equal to the TP route
   table (`tp_expected`); its parameter bytes those of its shards; the
   global `decoded` and detections against the single process (bf16: the
   slice limits, the detection sets matched; int8: JAX's TP bar of 2e-2 of
   the largest magnitude); its TP program against the same program on the
   plain versions within the slice limits, which reject one row-parallel
   all-reduce left out. Ranks 2 and 3 train data-parallel in bf16 beside
   dp1xtp2's serving on ranks 0 and 1, then 0 and 1 in fp32, on a global
   batch of 4 (each rank's rows from another range of values), each step
   against one process's step on the whole batch from the same state: one
   fp32 step within the train slice's global limits, which reject
   BatchNorm on local statistics; three bf16 steps printed beside what the
   same process's first step reads on the rows in another order (the floor
   of bf16 rounding, already at those limits), BatchNorm on local
   statistics read past both; the ranks' parameters, EMA, statistics and
   momenta equal bit for bit. The NCCL rank: the data-parallel Predictor's
   detections equal to no mesh's, one bf16 data-parallel step within the
   limits or its floor. Then rows 1, 3, 6 and 7 at their TP-local shapes
   (tp 2 and 4, batch 2) timed in this process beside bound, plain version
   and library, each launch held against plain. Last on the ranks,
   tensor-parallel training (`_parallel_tp_train`, PARALLEL_TP_TRAIN):
   make_train_step on a (data, model) mesh after shard_train_state_tp, at
   dp2xtp2 (one fp32 step, two bf16), dp1xtp4 (fp32 and bf16) and dp1xtp2
   (fp32), a clip of TP_TRAIN_CLIP that bites, each step against one
   process's step from the whole state gathered back (fp32 within the
   train slice's limits; bf16 printed beside the reordering floor); each
   rank's launches of rows 9-11 in its first step against the TP training
   route table (`tp_train_expected`), the replicated leaves equal across
   each model group, its peak memory; two planted faults rejected (the
   backward all-reduce of copy_to_model skipped, the clip without the model
   axis's sum): past a limit or with the replicated leaves differing. Then
   rows 9-11 at the bf16 TP steps' local shapes (TP_TRAIN_SHAPES) held
   against plain with the train kernel phase's faults and timed. The
   ranks' seconds are printed as those of ranks sharing one card (no
   scaling figure). `python3 chip_smoke.py parallel` runs this phase alone
   (after the build), without the result line; `python3 chip_smoke.py
   int8_1x1` the int8 1x1 phases alone (after the variant slice in the
   full run): qmm and quant_rows at the routed convs' shapes against plain
   with their planted faults; ModelConfig(int8_1x1=True) alone and with
   int8_dense + int8_attn at phi='s' on the bf16 run's weights: launches of
   the counted main path at batch 32, 16, 2 and 1 against
   `expected_launches` plus `int8_1x1_routes`; `decoded` and the detection
   sets at batch 16 against plain within the int8 slice limits, which
   reject a qmm K slab dropped; every launch of the batch-16 int8_1x1
   forward against plain, timed beside bound, plain and torch._int_mm with
   the epilogue; batch-32 imgs/s of bf16, int8, int8_1x1 and both, two
   rounds; QuantDense's launches against plain. `python3 chip_smoke.py
   wide` runs, after the build, the off-grid backward of 2, the train
   scale kernel phase of 14 and the wide TP phase alone, without the
   result line.
20. Prints each phase's seconds and the smoke's total time, the card's name
   and power limit, a JSON line of the kernels (the phi='s' entries: row 1
   on the sm90 kernel, rows 2-11 with rows 9-11's single-head site (rows 2
   and 9 on the sm90 kernel's one-head form, each site's time, bound,
   plain and SDPA apart in `sites`), rows 3-5 on csrc/flash_int8_sm90.cu,
   then rows 9-11's packed sites on the sm90 kernels; then the phi='m' and
   fp32 forms (row 2 at phi='m' and phi='n' dark3 and the folded h1 under
   the one-head form, by site), the phi='l' forms likewise (rows 3-5 at
   its dark3 and neck heads on csrc/flash_int8_sm90.cu), rows
   9-11 at phi='m' (split: row 9 at dark3 and the folded h1 under
   the one-head form of csrc/flash_fwd_sm90.cu, rows 10 and 11 under
   csrc/flash_bwd_single_sm90.cu, each site's time, bound, plain and SDPA
   apart in `sites`), rows 9-11 at the one-head sites of phi='n', rows 10
   and 11 at phi='l''s sites and its tensor-parallel local shapes on
   csrc/flash_bwd_wide_sm90.cu ("... wide_sm90 phi=l", "... tp=4", "...
   tp=8"; launches those the phase counted, one a site), and in fp32 last;
   the phi='s' entries of rows 1, 2 and 9-11 also carry the
   fit phase's launches as `fit_launches`, rows 1 and 2 the launches of
   the api phase's bf16 detect_image calls as `api_launches`; the fp32
   forms of
   rows 1, 2 and 9 under csrc/flash_fwd_f32_sm90.cu and of rows 10 and 11
   under csrc/flash_bwd_f32_sm90.cu, their bound three tf32 products at 495
   TFLOP/s; rows 1, 3, 6 and 7's phi='s' entries also carry rank 0's
   launches of each mesh of phase 19 as `parallel_launches`, and those rows
   at their TP-local shapes are entries of their own, "... tp=2" and
   "... tp=4", as are rows 9-11 at the TP training's local shapes and rows
   6 and 7 at the int8 1x1 convs ("... int8_1x1")), then {"ok": true,
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
import math
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


def device_ms(fn, iters: int = 10) -> float:
    """The device time of one call of fn: its kernels' time under
    torch.profiler over `iters` calls, after a warm-up (for calls shorter
    than the host's time to enqueue them, which CUDA events would read),
    each kernel's total over the launches the profiler recorded (late in a
    long run it may record only some of them); 0 where it recorded none."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total / e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.key != "Command Buffer Full"
               and e.count) / 1e3


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


def _pad8(d: int) -> int:
    return -(-d // 8) * 8


def _single_plan(dqk: int, dv: int) -> dict:
    """The one-head plan of csrc/flash_fwd_sm90.cu for the widths a call
    hands the kernel (padded to a multiple of 8, as the wrapper and the fold
    copy pad them)."""
    from transparent_object_detection_tpu_torch.ops import attention as A

    return A.single_sm90_plan(_pad8(dqk), _pad8(dv))


def _single_key_tile_twice(q, k, v):
    """k, v with one of the one-head plan's key tiles read twice (tile 2 the
    copy of tile 1), its neighbour never."""
    keys = _single_plan(q.shape[-1], v.shape[-1])["keys"]
    return _tile_twice(k, keys, 2 * keys), _tile_twice(v, keys, 2 * keys)


def _single_slab_left_out(q, k):
    """q, k with one 64-column slab zeroed: the second, or the only one."""
    lo = 64 if q.shape[-1] > 64 else 0
    q, k = q.clone(), k.clone()
    q[..., lo:lo + 64] = 0
    k[..., lo:lo + 64] = 0
    return q, k


def _single_pad_nonzero(q, k):
    """q, k as a map of the rounded-up width would read them: past the width
    the wrapper pads to (zeros to a multiple of 8), the next row's columns
    up to the next multiple of 64."""
    import torch

    cols = -(-_pad8(q.shape[-1]) // 64) * 64
    pad = lambda t: torch.nn.functional.pad(t, (0, _pad8(t.shape[-1]) - t.shape[-1]))
    return _next_row_columns(pad(q), cols), _next_row_columns(pad(k), cols)


def _single_v_from_other(q, v):
    """v with the second v slice (or warpgroup half) of the one-head plan
    holding the first one's columns: the output of that part written from
    the other part's P V."""
    w = _single_plan(q.shape[-1], v.shape[-1])["v_slice"]
    end = min(v.shape[-1], 2 * w)
    v = v.clone()
    v[..., w:end] = v[..., :end - w]
    return v


def single_faults(dqk: int, dv: int) -> tuple:
    """The faults of the one-head design that a plan of these widths can
    commit (SINGLE_FAULTS): a key tile of its own size read twice, a q/k
    slab left out, and where a width is not a multiple of 64 the
    zero-filled columns made nonzero, where v takes two parts or more one
    part written from another's P V."""
    plan = _single_plan(dqk, dv)
    out = ["key_tile_read_twice_at_plan_tile", "qk_slab_left_out"]
    if _pad8(dqk) % 64:
        out.append("zero_filled_columns_nonzero")
    if (2 if plan["wg_split"] else 1) * plan["dv_splits"] > 1:
        out.append("v_part_from_other_parts_PV")
    return tuple(out)


# faults of the one-head form of csrc/flash_fwd_sm90.cu (on top of
# RING_FAULTS), as the plain attention with that fault computes them
SINGLE_FAULTS = {
    "key_tile_read_twice_at_plan_tile": lambda attend: (
        lambda q, k, v, scale, block_k=1024: attend(q, *_single_key_tile_twice(q, k, v), scale,
                                                    block_k)),
    "qk_slab_left_out": lambda attend: (
        lambda q, k, v, scale, block_k=1024: attend(*_single_slab_left_out(q, k), v, scale,
                                                    block_k)),
    "zero_filled_columns_nonzero": lambda attend: (
        lambda q, k, v, scale, block_k=1024: attend(*_single_pad_nonzero(q, k), v, scale,
                                                    block_k)),
    "v_part_from_other_parts_PV": lambda attend: (
        lambda q, k, v, scale, block_k=1024: attend(q, k, _single_v_from_other(q, v), scale,
                                                    block_k)),
}


@contextlib.contextmanager
def planted(fault: str):
    """The plain attention versions with a planted fault: what a kernel that
    made that mistake would return."""
    from transparent_object_detection_tpu_torch.ops import attention as A

    real = A._online_softmax_attention
    A._online_softmax_attention = {**PLANTED_FAULTS, **SCALE_FAULTS, **RING_FAULTS,
                                   **F32_FAULTS, **SINGLE_FAULTS}[fault](real)
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
    the sm90 kernels, 448 and 72 on the wide kernels): against their plain
    versions within the gradient bar, twice for the same bits, each planted
    fault of `_bwd_faults` (with the sm90 kernels' own) rejected on some
    input spread."""
    import torch

    from transparent_object_detection_tpu_torch.ops import attention_vjp as V

    for b, n, c, h in OFF_GRID:
        d, scale = c // h, (c // h) ** -0.5
        form = V.bwd_form(d, d, h, torch.bfloat16)
        check(form == ("sm90" if d % 64 == 0 and d <= 384 else "wide_sm90"),
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
                      else (V.flash_bwd_dq.wide_launches, V.flash_bwd_dkv.wide_launches))
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

    # single head, dq = C/8, dv = C, scale 1.0: dark3 at 640x640, then
    # ragged; the one-head form of the sm90 kernel, twice on every input,
    # with the ring's faults and its design's (SINGLE_FAULTS); the zero-fill
    # trap on the ragged N with scores shifted well below 0
    for name, (b, n, dq, dv) in (("dark3", (2, 6400, 64, 512)), ("ragged", (2, 3600, 64, 512))):
        check(A.single_fwd_form(dq, dv, torch.bfloat16) == "single_sm90",
              f"flash_single {name}: widths {dq}/{dv} do not take the one-head sm90 form")
        readings = []
        spreads = [(std, 0.0) for std in SCORE_STDS] + ([SHIFTED_SPREAD] if n % 64 else [])
        for score_std, mean in spreads:
            std = qk_std(score_std, 1.0, dq)
            q, k = randn(b, n, dq) * std, randn(b, n, dq) * std
            if mean:
                _score_shift(q, k, 1.0, mean, dq)
            q, k = q.to(torch.bfloat16), k.to(torch.bfloat16)
            v = randn(b, n, dv).to(torch.bfloat16)
            faults = (("keys_past_n_scored_zero",) if mean else
                      (*PLANTED_FAULTS, "key_tile_used_twice", *single_faults(dq, dv)))
            readings.append({"score_std": score_std, "score_mean": mean, **hold_against_plain(
                lambda: A.flash_single(q, k, v, 1.0),
                lambda: A.flash_single_plain(q, k, v, 1.0),
                f"flash_single single_sm90 {name} score_std {score_std} mean {mean}",
                faults=faults, twice=True)})
        single_rows.append(dict(node=name, b=b, n=n, dq=dq, dv=dv, form="single_sm90",
                                readings=readings, **_single_timing(q, k, v, 1.0)))
        if name != "ragged":  # batch 1: the latency path's grid
            single_rows[-1]["batch1"] = _single_timing(q[:1], k[:1], v[:1], 1.0, plain=False)
        print(json.dumps({"kernel": "flash_single", **single_rows[-1]}), flush=True)
    return mha_rows, single_rows


def _single_timing(q, k, v, scale, plain: bool = True) -> dict:
    """ms of flash_single (the one-head sm90 form), of the plain version
    and of SDPA (the yardstick, never called by the port; on (B, 1, N, d)
    views, one head, which its fused kernels take), beside the bound."""
    import torch.nn.functional as F

    from transparent_object_detection_tpu_torch.ops import attention as A

    b, n, dq = q.shape
    dv = v.shape[-1]
    bnd, by = bound_ms(2.0 * b * n * n * (dq + dv), 2.0 * (b * n * (2 * dq + dv) + b * n * dv))
    row = dict(ms=timed_ms(lambda: A.flash_single(q, k, v, scale), 20),
               library_ms=timed_ms(lambda: F.scaled_dot_product_attention(
                   q[:, None], k[:, None], v[:, None], scale=scale), 20),
               bound_ms=bnd, bound_by=by)
    if plain:
        row["plain_ms"] = timed_ms(lambda: A.flash_single_plain(q, k, v, scale), 3, 1)
    return row


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
    ("flash attention backward (ours)", ("flash_bwd_", "wide_")),  # sm90, wide and fp32 forms
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


def match_detections(da, db, pcfg, margin: float, box_px: float) -> dict:
    """Detections of run a that score above the confidence by more than
    `margin`, the largest score difference between the runs (so they are
    candidates in run b too), and how many of them
    run b keeps at IoU >= 0.9 with the same class (`identical`) or has no
    same-class detection for at IoU >= 0.75 * nms_iou, neither the box itself
    nor the one that suppressed it (`unmatched`). A box of zero area (one
    clipped to the image's edge) has no IoU with anything, itself included:
    such a pair counts as identical where its corners agree within
    `box_px`, the comparison's decoded box limit (`degenerate_pairs`)."""
    import torch

    from transparent_object_detection_tpu_torch.ops.geometry import pairwise_iou

    sel = da["valid"] & (da["scores"] > pcfg.confidence + margin)
    same = (da["classes"][:, :, None] == db["classes"][:, None, :]) & db["valid"][:, None, :]
    a_box, b_box = da["boxes"].float(), db["boxes"].float()
    iou = pairwise_iou(a_box, b_box)
    linf = (a_box[:, :, None, :] - b_box[:, None, :, :]).abs().amax(-1)
    flat = lambda t: ((t[..., 2:] - t[..., :2]).amin(-1) <= 0)
    degenerate = (flat(a_box)[:, :, None] | flat(b_box)[:, None, :]) & (linf <= box_px)
    iou = torch.where(degenerate, torch.ones_like(iou), iou)
    best = torch.where(same, iou, torch.zeros_like(iou)).amax(dim=-1)
    unmatched = sel & (best < 0.75 * pcfg.nms_iou)
    # what the unmatched boxes are: their sizes and scores, and the nearest
    # same-class box of run b (L-inf distance in pixels)
    linf = torch.where(same, linf, torch.full_like(linf, float("inf"))).amin(-1)
    wh = a_box[..., 2:] - a_box[..., :2]
    return {"compared": int(sel.sum()), "identical": int((sel & (best >= 0.9)).sum()),
            "unmatched": int(unmatched.sum()),
            "degenerate_pairs": int((sel[:, :, None] & degenerate & same).any(-1).sum()),
            "unmatched_boxes": [{"box": a_box[i, j].tolist(), "wh": wh[i, j].tolist(),
                                 "score": float(da["scores"][i, j]),
                                 "nearest_linf_px": float(linf[i, j]), "iou": float(best[i, j])}
                                for i, j in unmatched.nonzero().tolist()[:8]]}


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
                "flash_single_sm90": A.flash_single.sm90_launches}
    print(json.dumps({"main_path_launches": launches}), flush=True)
    check(launches == {"flash_mha_packed": 0, "flash_mha_packed_sm90": 3, "flash_single_sm90": 1},
          f"expected 3 packed launches of the sm90 kernel and 1 launch of its one-head form "
          f"per forward, got {launches}")
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
                "matched_in_plain": match_detections(d, dets_p, pcfg, score_diff,
                                                     BOX_LIMIT_PX),
                "plain_matched_here": match_detections(dets_p, d, pcfg, score_diff,
                                                       BOX_LIMIT_PX)}

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
            # the one-head form: a second launch, the same bits
            if name == "flash_single":
                check(torch.equal(real[1](*args), out),
                      f"{name} launch {i}: two launches gave different bits")
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
    the kernel. The faults of the sliced and narrow forms:
    "tail_tile_read_twice" (each block's last tile read again: its keys
    twice in l and P V), "second_block_acc_dropped" (the second key block's
    P V left out of acc), "qk_pad_nonzero" (the zero-filled q/k columns
    past the width holding a copy of the real ones: S doubled)."""
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
            elif fault == "tail_tile_read_twice":
                idx = torch.cat([idx, idx[(tiles - 1) * keys:]])
            s32 = qd @ kh[bi][:, idx].transpose(-1, -2)
            if fault == "qk_pad_nonzero":
                s32 = 2 * s32
            s = s32.float() * (qs[0] * (ks[bi, :, j] * (scale * A8.LOG2E))[:, None, None])
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p127 = torch.exp2(s - (m_new - A8.LOG2_127))
            corr = torch.exp2(m - m_new)
            l = l * corr + p127.sum(-1, keepdim=True)
            pv = torch.round(p127).double() @ vh[bi][:, idx]
            if fault == "second_block_acc_dropped" and j == 1:
                pv = torch.zeros_like(pv)
            acc = acc * corr.double() + pv * vs[bi, :, j].double()[:, None, None]
            m = m_new
        outs.append((acc / l.double()).to(out_dtype or q.dtype))
    return torch.stack(outs).transpose(1, 2).reshape(b, n, -1)


def _v_slice_faults(o, heads, plan):
    """{fault: output} of the sliced form's two ways to write a v slice
    wrong, from the sound output o (B, N, heads * dv): slice 1 of each head
    with slice 0's columns (another slice's V), and with the rows of the
    next query tile (another tile's S)."""
    import torch

    b, n, c = o.shape
    width = plan["v_cols"] * (2 if plan["split"] else 1)
    o4 = o.reshape(b, n, heads, c // heads)
    cols = o4.clone()
    cols[..., width:2 * width] = o4[..., :width]
    rows = o4.clone()
    rows[..., width:2 * width] = torch.roll(o4[..., width:2 * width], -plan["rows"], dims=1)
    return {"v_slice_from_other_slice_columns": cols.reshape(b, n, c),
            "v_slice_from_other_tile_S": rows.reshape(b, n, c)}


def sm90_ring_faults(q, kq, ks, vq, vs, heads, scale, k, v, bk, quant=None):
    """{fault: thunk} of the int8 sm90 kernel's own faults at these inputs
    (q bf16 or fp32, possibly the packed qkv; k, v before quantization):
    the tiled reference with a key tile read twice (three tiles or more a
    block) or the tail keys unmasked (several blocks that are not multiples
    of the key tile: a tail tile then holds the next block's keys), and the
    kernel itself launched on V in its natural key
    order (a layout that does not match P's fragments). With `quant` (the
    per-(row, head) quantizer) the int8 output of flash_mha_int8_qout.
    Where the plan slices v or q/k is narrower than its box (dark3 of phi
    'n', 'm', 'l', 'x'), also the sliced and narrow forms' faults: a v slice
    from another slice's columns or another tile's S, the second key
    block's acc dropped (several blocks), the zero-filled q/k columns made
    nonzero (q/k narrower than the box), the tail key tile read twice."""
    import torch

    from transparent_object_detection_tpu_torch.ops import attention_int8 as A8

    dq, dv = kq.shape[-1] // heads, vq.shape[-1] // heads
    plan = A8.int8_sm90_plan(dq, dv, ks.shape[-1])
    keys = plan["keys"]
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
    if quant is None and (plan["slices"] > 1 or dq % plan["swq"]):
        faults["tail_tile_read_twice"] = lambda: tiled("tail_tile_read_twice")
        if ks.shape[-1] > 1:
            faults["second_block_acc_dropped"] = lambda: tiled("second_block_acc_dropped")
        if dq % plan["swq"]:
            faults["qk_pad_nonzero"] = lambda: tiled("qk_pad_nonzero")
        if plan["slices"] > 1:
            made = {}

            def sliced(name):  # both faults from one plain output
                if not made:
                    made.update(_v_slice_faults(
                        A8.flash_mha_int8_plain(qc, kq, ks, vq, vs, heads, scale), heads, plan))
                return made[name]
            for name in ("v_slice_from_other_slice_columns", "v_slice_from_other_tile_S"):
                faults[name] = lambda name=name: sliced(name)
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


def quant_rows_case(name, x, ln, qmax=127) -> dict:
    """quant_rows on synthetic rows x against its plain version, a second
    launch for the same bits, and every fault of its design rejected (with
    qmax 7 also qmax 127 in its place)."""
    from transparent_object_detection_tpu_torch.ops import quant_matmul as QM

    out = QM.quant_rows(x, ln, qmax=qmax)
    ref = QM.quant_rows_plain(x, ln, qmax=qmax)
    readings = {"quant_rows": int8_reading(out, ref)}
    check(readings["quant_rows"]["bar_used"] <= 1.0, f"quant_rows {name}: {readings}")
    if x.is_cuda:
        twice_same_bits(lambda: QM.quant_rows(x, ln, qmax=qmax), out, f"quant_rows {name}")
    faults = {f: int8_reading(o, ref)["bar_used"]
              for f, o in quant_rows_faults(x, ln, qmax=qmax).items()}
    if qmax == 7:
        faults["qmax_127_for_7"] = int8_reading(QM.quant_rows_plain(x, ln, qmax=127),
                                                ref)["bar_used"]
    readings["quant_rows_faults_bar_used"] = faults
    for f, used in faults.items():
        check(used > 1.0, f"quant_rows {name}: the bar does not reject {f} ({used:.3g}x)")
    return readings


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
        readings.update(quant_rows_case(name, x, ln, qmax))
        x, xs = QM.quant_rows_plain(x, ln, qmax=qmax)
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
            twice_same_bits(kern, out, f"flash_mha_int8 {name}")
            ref = A8.flash_mha_int8_plain(q, kq, ks, vq, vs, h, scale, q_width)
            qc = q[..., :cq]
            reading = int8_reading(out, ref)
            reading["reference_bar_used"] = int8_reading(
                int8_attention_reference(qc, k, v, h, scale, bk, bk), ref)["bar_used"]
            reading["faults_bar_used"] = {
                f: int8_reading(fn(qc, k, v, h, scale, bk), ref)["bar_used"]
                for f, fn in faults.items()}
            reading["faults_bar_used"].update(  # and those of the kernel's ring and layout
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
        elif act == "silu":
            out = F.silu(out)
        if res is not None:
            out = out + res.float()
        return out.bfloat16()
    return alone, with_epilogue


def _quant_rows_with(d, rstd, qmax, amax_of):
    """quant_rows' payload and scales of rows d with amax taken over
    `amax_of` (the payload saturated to the int8 range)."""
    import torch

    amax = torch.clamp(amax_of.abs().amax(dim=-1, keepdim=True), min=1e-12)
    q = torch.round(d * (torch.full_like(amax, float(qmax)) / amax)).clamp(-127, 127)
    return q.to(torch.int8), amax * (1.0 / qmax) * rstd


# quant_rows' faults whose reading depends on the activations' layout (they
# keep their outliers, and near-zero channels, in fixed columns): each must
# be rejected on some launch of a forward, the others on every launch; on
# the synthetic rows of `_qmm_case` every fault on every case
QR_SPREAD_FAULTS = ("amax_over_half_row", "tail_chunk_left_out")


def quant_rows_faults(x, ln, eps=1e-6, qmax=127) -> dict:
    """{fault: (payload, scales)} of csrc/quant_matmul.cu's quant_rows design
    planted in its plain version: the row's tail chunk (its last 16-byte
    load, 8 bf16 or 4 fp32 columns) left out, read as zeros; the LN
    statistics taken from the neighbouring row (LN launches); the amax
    taken over the first half of the row."""
    import torch

    from transparent_object_detection_tpu_torch.ops import quant_matmul as QM

    xf = x.float()
    k = xf.shape[-1]
    cut = xf.clone()
    cut[:, k - min(16 // x.element_size(), k):] = 0
    faults = {"tail_chunk_left_out": QM.quant_rows_plain(cut.to(x.dtype), ln, eps, qmax)}
    d, rstd = QM._ln_stats(xf, eps) if ln else (xf, 1.0)
    if ln:
        dn = xf - torch.roll(xf.mean(dim=-1, keepdim=True), -1, 0)
        faults["ln_stats_from_neighbour_row"] = _quant_rows_with(
            dn, torch.roll(rstd, -1, 0), qmax, dn)
    faults["amax_over_half_row"] = _quant_rows_with(d, rstd, qmax, d[:, :max(k // 2, 1)])
    return faults


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
    qr_rejected = {}
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
                # its design's faults rejected, and a second launch's bits
                ref_q = plain(*args, **kw)
                faults = {f: int8_reading(o, ref_q)["bar_used"]
                          for f, o in quant_rows_faults(*args, **kw).items()}
                for f, used in faults.items():  # the half-row amax: on some launch (below)
                    qr_rejected[f] = qr_rejected.get(f, False) or used > 1.0
                    check(used > 1.0 or f in QR_SPREAD_FAULTS,
                          f"{name} launch {i}: the bar does not reject {f} ({used:.3g}x)")
                twice_same_bits(lambda: kernel(*args, **kw), out, f"{name} launch {i}")
                shape = {"m": x.shape[0], "k": x.shape[1], "ln": bool(args[1]),
                         "dtype": str(x.dtype)[6:], "faults_bar_used": faults,
                         "device_ms": device_ms(lambda: kernel(*args, **kw))}
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
                         "form": A8.int8_fwd_form(cq // h, cv // h, name), "int8_out": int8_out,
                         **{key: A8.int8_sm90_plan(cq // h, cv // h,
                                                   args[3 if handoff else 2].shape[-1],
                                                   int8_out=int8_out)[key]
                            for key in ("slices", "q_stream", "cluster")},
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
    for f, ok in qr_rejected.items():
        check(ok, f"quant_rows: the bar rejects {f} on no launch of the forward")
    return rows


# every int8 attention launch is csrc/flash_int8_sm90.cu's (`sm90_launches`):
# the entry points have no other kernel and no other counter
COUNTED = ("flash_mha_packed", "flash_mha_packed_sm90", "flash_mha_packed_f32",
           "flash_single_sm90", "flash_single_f32", "flash_mha_int8_sm90",
           "flash_mha_int8_qout_sm90", "flash_int8_handoff_sm90", "qmm", "quant_rows",
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
            "flash_single_sm90": A.flash_single.sm90_launches,
            "flash_single_f32": A.flash_single.f32_launches,
            **{name + "_sm90": getattr(A8, name).sm90_launches
               for name in ("flash_mha_int8", "flash_mha_int8_qout", "flash_int8_handoff")},
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
                "matched_in_plain": match_detections(d, dets_p, pcfg, score_diff,
                                                     INT8_BOX_LIMIT_PX),
                "plain_matched_here": match_detections(dets_p, d, pcfg, score_diff,
                                                       INT8_BOX_LIMIT_PX)}

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


def serving_timing(model, predictor, raw, shapes, images, rng, iters: int = 3,
                   big: int = 32) -> dict:
    """Batch-1 latency (40 calls after 3 warm-ups, host clock) and forward;
    batch-`big` throughput (`iters` calls after 1, host clock), forward and
    peak memory; a profile of one batch-`big` forward, as the bf16 slice."""
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
        raw32 = rng.integers(0, 256, size=(big, 480, 640, 3), dtype=np.uint8)
        shapes32 = np.tile(np.array([[480, 640]], np.float32), (big, 1))
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
            f"batch{big}_imgs_per_s": big / b32_s, f"batch{big}_step_ms": b32_s * 1e3,
            f"batch{big}_forward_ms": fwd32, f"peak_mem_gib_batch{big}": peak,
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
    # qmm: its GEMM and row pass apart, and torch._int_mm alone; quant_rows:
    # its kernel's device time (a launch is shorter than the host's enqueue)
    for key in ("gemm_ms", "row_pass_ms", "int_mm_ms", "device_ms"):
        if rows and all(key in r for r in rows):
            entry[key] = total(key)
    return {**entry, "shapes": rows}


I8_SM90_SRC = "transparent_object_detection_tpu_torch/csrc/flash_int8_sm90.cu"


def int8_attention_entries(name, label, rows, launches, max_err, replaces):
    """The kernels-line entry of one int8 attention entry point: its launches
    (csrc/flash_int8_sm90.cu, the only kernel of the three entry points)
    with their rows and counter."""
    if not rows:
        return []
    return [int8_kernel_entry(f"{name}{label}", I8_SM90_SRC, replaces, rows,
                              launches[name + "_sm90"], max_err)]


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
# the int8 1x1 route (ModelConfig(int8_1x1=True)) and QuantDense
# ---------------------------------------------------------------------------

# The routed convs' qmm / quant_rows launch shapes at phi='s' 640x640,
# batch 32 (rows, K, N): dark4_c2f.cv2; dark5_c2f.cv2, dark5_sppf.cv2 and
# neck.h6.reduce; neck.h1.reduce; neck.h4.reduce (`int8_1x1_routes`)
INT8_1X1_SHAPES = (("dark4 cv2", 51200, 3072, 1024), ("dark5 cv2 / sppf cv2 / h6 reduce",
                                                     12800, 2048, 1024),
                   ("h1 reduce", 51200, 2048, 1024), ("h4 reduce", 51200, 1536, 1024))
INT8_1X1_CONFIGS = {"int8_1x1": dict(int8_1x1=True),
                    "int8_1x1+int8": dict(int8_1x1=True, int8_dense=True, int8_attn=True)}
INT8_1X1_BATCHES = (32, 16, 2, 1)
INT8_1X1_PARITY_BATCH = 16  # every routed conv takes the route (batch 4: 3 of 6)
QUANT_DENSE_SHAPE = (4096, 1024, 1024)  # rows, in, out


def int8_1x1_kernel_phase(shrink: int = 1) -> dict:
    """quant_rows and qmm (SiLU epilogue, no residual, bf16 out) at the
    routed convs' shapes (INT8_1X1_SHAPES) against their plain versions,
    every planted fault of both rejected (`_qmm_case`). Returns the largest
    value error per kernel."""
    import torch

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 5)
    err = {"quant_rows": 0.0, "qmm": 0.0}
    for name, m, k, n in INT8_1X1_SHAPES:
        m //= shrink
        x = (torch.randn(m, k, generator=gen, device=DEVICE) * 2 + 0.5).bfloat16()
        r, _ = _qmm_case(f"int8_1x1 {name}", x, None, m, k, n, 0, "silu", False, ln=False)
        for key in err:
            err[key] = max(err[key], r[key]["max_abs_err"])
    return err


def _batch_imgs_per_s(predictor, raw, shapes, iters: int = 3) -> float:
    import torch

    with torch.inference_mode():
        predictor.detect_raw_batch(raw, shapes)["num_detections"].cpu()
        t0 = time.perf_counter()
        for _ in range(iters):
            predictor.detect_raw_batch(raw, shapes)["num_detections"].cpu()
    return raw.shape[0] * iters / (time.perf_counter() - t0)


def int8_1x1_phase(card: str, bf16_model) -> dict:
    """The int8 1x1 route at phi='s' 640x640 on the bf16 run's weights, alone
    and beside int8_dense + int8_attn (INT8_1X1_CONFIGS): each model's
    counted main path (Predictor.detect_raw_batch, counts reset just before
    and read just after) at batch 32, 16, 2 and 1 against the route table
    (`expected_launches` plus one quant_rows and one qmm a conv of
    `int8_1x1_routes`: six convs from batch 16 up, none at 2 and 1);
    `decoded` and the detection sets at batch 16 against the same model on
    plain versions within the int8 slice's limits, which must reject a K
    slab dropped from qmm; every launch of the int8 1x1 model's batch-16
    forward against its plain version, timed beside its bound, plain
    version and torch._int_mm with the epilogue (`int8_path_calls`); the
    batch-32 imgs/s of bf16, int8, int8_1x1 and int8_1x1 + int8 on the same
    weights and class biases, two rounds in turned order (read, not
    claimed: JAX turned the route off after a TPU reading); QuantDense's
    one launch pair against its plain version."""
    import numpy as np
    import torch

    from transparent_object_detection_tpu_torch.config import (
        Int8Variants,
        ModelConfig,
        PredictConfig,
    )
    from transparent_object_detection_tpu_torch.inference import Predictor
    from transparent_object_detection_tpu_torch.models.blocks import QuantDense
    from transparent_object_detection_tpu_torch.models.detector import (
        build_model,
        int8_1x1_routes,
        set_attention_impl,
    )
    from transparent_object_detection_tpu_torch.ops import quant_matmul as QM
    from transparent_object_detection_tpu_torch.ops.preprocess import letterbox_batch

    pcfg = PredictConfig()
    rng = np.random.default_rng(SEED + 9)
    raw = rng.integers(0, 256, size=(32, 480, 640, 3), dtype=np.uint8)
    shapes = np.tile(np.array([[480, 640]], np.float32), (32, 1))
    models = {"bf16": bf16_model}
    for tag, flags in (("int8", dict(int8_dense=True, int8_attn=True)), *INT8_1X1_CONFIGS.items()):
        m = build_model(ModelConfig(**flags), device=DEVICE, seed=None,
                        int8_variants=Int8Variants())
        m.load_state_dict(bf16_model.state_dict())  # the bf16 run's weights and class biases
        models[tag] = m
    cfg = ModelConfig()
    preds = {tag: Predictor(m, cfg, pcfg, device=DEVICE) for tag, m in models.items()}

    # batch-32 imgs/s on the same weights and class biases, two rounds
    order = list(models)
    rates = {tag: [] for tag in order}
    for turn in (order, order[::-1]):
        for tag in turn:
            rates[tag].append(_batch_imgs_per_s(preds[tag], raw, shapes))
    perf = {"card": card, "batch32_imgs_per_s": rates}
    print(json.dumps({"int8_1x1_batch32_imgs_per_s": perf}), flush=True)

    out = {"perf": perf, "launches": {}}
    routes = {b: int8_1x1_routes(cfg, b) for b in INT8_1X1_BATCHES}
    print(json.dumps({"int8_1x1_route_table": {b: sorted(r) for b, r in routes.items()}}),
          flush=True)
    check(len(routes[32]) == len(routes[16]) == 6 and not routes[2] and not routes[1],
          f"int8_1x1 route table at phi='s': {routes}")
    for tag in INT8_1X1_CONFIGS:
        base = "int8" if tag.endswith("+int8") else "bf16"
        got = {}
        for b in INT8_1X1_BATCHES:
            reset_counts()
            preds[tag].detect_raw_batch(raw[:b], shapes[:b])
            torch.cuda.synchronize()
            got[b] = read_counts()
            want = expected_launches("s", b, base)
            want["qmm"] += len(routes[b])
            want["quant_rows"] += len(routes[b])
            check(got[b] == want, f"{tag} batch {b}: launches {got[b]}, route table {want}")
        out["launches"][tag] = got
        print(json.dumps({"int8_1x1_main_path_launches": tag, "per_batch": got}), flush=True)

    # parity at batch 16, with class biases for INT8_CANDIDATES_PER_IMAGE
    b = INT8_1X1_PARITY_BATCH
    images = letterbox_batch(torch.as_tensor(raw[:b], device=DEVICE).float() / 255.0,
                             cfg.input_shape)
    out["parity"] = {}
    for tag in INT8_1X1_CONFIGS:
        model, pred = models[tag], preds[tag]
        _set_class_biases(model, images, INT8_CANDIDATES_PER_IMAGE)

        def run_plain():
            set_attention_impl(model, "plain")
            try:
                return model(images)["decoded"], pred.detect_raw_batch(raw[:b], shapes[:b])
            finally:
                set_attention_impl(model, None)

        with torch.inference_mode():
            dec_k = model(images)["decoded"]
            dets = pred.detect_raw_batch(raw[:b], shapes[:b])
            dec_p, dets_p = run_plain()
            with QMM_FAULTS["qmm_k_slab_dropped"](QM):
                dec_f, dets_f = run_plain()
        check(bool(torch.isfinite(dec_k).all()), f"{tag}: non-finite decoded")

        def against_plain(dec, d):
            score = float((dec[..., 4:] - dec_p[..., 4:]).abs().max())
            return {"decoded_box_max_abs_px": float((dec[..., :4] - dec_p[..., :4]).abs().max()),
                    "decoded_score_max_abs": score,
                    "matched_in_plain": match_detections(d, dets_p, pcfg, score,
                                                         INT8_BOX_LIMIT_PX),
                    "plain_matched_here": match_detections(dets_p, d, pcfg, score,
                                                           INT8_BOX_LIMIT_PX)}
        sound, fault = against_plain(dec_k, dets), against_plain(dec_f, dets_f)
        out["parity"][tag] = {"kernels": sound, "qmm_k_slab_dropped": fault}
        print(json.dumps({"int8_1x1_parity": tag, **out["parity"][tag],
                          "limits": {"box_px": INT8_BOX_LIMIT_PX, "score": INT8_SCORE_LIMIT}}),
              flush=True)
        check(sound["decoded_box_max_abs_px"] <= INT8_BOX_LIMIT_PX
              and sound["decoded_score_max_abs"] <= INT8_SCORE_LIMIT,
              f"{tag}: decoded against plain {sound}")
        for key in ("matched_in_plain", "plain_matched_here"):
            check(sound[key]["compared"] > 0 and sound[key]["unmatched"] == 0,
                  f"{tag}: detection sets differ {sound[key]}")
        check(fault["decoded_box_max_abs_px"] > INT8_BOX_LIMIT_PX
              or fault["decoded_score_max_abs"] > INT8_SCORE_LIMIT,
              f"{tag}: the limits do not reject qmm_k_slab_dropped: {fault}")
    out["rows"] = int8_path_calls(models["int8_1x1"], images)

    # QuantDense: one quant_rows and one qmm launch against its plain version
    m, k, n = QUANT_DENSE_SHAPE
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 6)
    with torch.device(DEVICE):
        qd = QuantDense(k, n)
    x = torch.randn(m, k, generator=gen, device=DEVICE).bfloat16()
    with torch.inference_mode():
        reset_counts()
        y = qd(x)
        torch.cuda.synchronize()
        counts = read_counts()
        qd.attention_impl = "plain"
        y_p = qd(x)
        qd.attention_impl = None
    reading = int8_reading(y, y_p)
    out["quant_dense"] = {"m": m, "k": k, "n": n, "qmm": counts["qmm"],
                          "quant_rows": counts["quant_rows"], **reading}
    print(json.dumps({"quant_dense": out["quant_dense"]}), flush=True)
    check(counts["qmm"] == 1 and counts["quant_rows"] == 1 and reading["bar_used"] <= 1.0,
          f"QuantDense: {out['quant_dense']}")
    for tag in ("int8", *INT8_1X1_CONFIGS):
        del models[tag], preds[tag]
    torch.cuda.empty_cache()
    return out


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
# readings (phi='s' gradients 0.340, parameter and EMA change 0.337; the
# largest, phi='m' with remat, 0.483 and 0.485) and that of the planted
# fault in TRAIN_SLICE_REJECTS at phi='s' (0.709, 0.582) on an H100, the
# weights drawn as flax draws them (truncated normals; PERF.md); no planted
# backward fault moves the losses or the BatchNorm statistics, whose limits
# sit above the sound reading (1.1e-3, 8.9e-3).
TRAIN_GRAD_LIMIT = 0.6
TRAIN_UPDATE_LIMIT = 0.53
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
    spread; on the f32_sm90 and one-head sm90 forms their own."""
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
    form = V.lse_fwd_form(q.shape[-1] // h, v.shape[-1] // h, h, q.dtype)
    if form == "f32_sm90":
        faults.update(_f32_fwd_faults(V, q, k, v, scale, h))
    if form == "single_sm90":  # the one-head design's (SINGLE_FAULTS)
        fwd = lambda q, k, v: V.flash_fwd_lse_plain(q, k, v, scale, h)
        made = {"key_tile_read_twice_at_plan_tile": lambda: fwd(q, *_single_key_tile_twice(q, k, v)),
                "qk_slab_left_out": lambda: fwd(*_single_slab_left_out(q, k), v),
                "zero_filled_columns_nonzero": lambda: fwd(*_single_pad_nonzero(q, k), v),
                "v_part_from_other_parts_PV": lambda: fwd(q, k, _single_v_from_other(q, v))}
        faults.update((f, made[f]()) for f in single_faults(q.shape[-1], v.shape[-1]))
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
    dS^T formed with the previous query tile's P^T; on the wide kernels
    those on 64-token tiles (the GEMM's ring) and `_wide_bwd_faults`."""
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
    if form in ("sm90", "f32_sm90", "single_sm90", "wide_sm90"):  # the same ring and hand-over
        tiles = (64, 64)
        if form == "single_sm90":  # its plans' token tiles
            plans = V.bwd_single_sm90_plan(q.shape[-1], v.shape[-1])
            tiles = (plans["dq"]["tile"], plans["dkv"]["tile"])
        faults.update(_sm90_bwd_faults(V, q, k, v, do, lse, dcap, scale, h, *tiles))
    if form == "f32_sm90":
        faults.update(_f32_bwd_faults(V, q, k, v, do, lse, dcap, scale, h))
    if form == "single_sm90":
        faults.update(_single_bwd_faults(V, q, k, v, do, lse, dcap, scale, h))
    if form == "wide_sm90":
        faults.update(_wide_bwd_faults(V, q, k, v, do, lse, dcap, scale, h))
    return faults


def _wide_bwd_faults(V, q, k, v, do, lse, dcap, scale, h):
    """The faults of csrc/flash_bwd_wide_sm90.cu's design: the last
    256-column block of a GEMM's output unwritten (each gradient of each
    head from the last multiple of 256 on), and the workspace's row tile 1
    (rows 64..127: queries in dq, keys in dk/dv) taken from another head's
    (packed heads: the next one's P and dS against this head's K, Q, dO)
    or, with one head, from row tile 2's."""
    import torch

    sound = {"dq": V.flash_bwd_dq_plain(q, k, v, do, lse, dcap, scale, h)}
    sound["dk"], sound["dv"] = V.flash_bwd_dkv_plain(q, k, v, do, lse, dcap, scale, h)
    cut = {}
    for g, t in sound.items():
        x = t.clone().reshape(*t.shape[:2], h, t.shape[-1] // h)
        x[..., (x.shape[-1] - 1) // 256 * 256:] = 0
        cut[g] = x.reshape(t.shape)
    rows = slice(64, 128)
    if h == 1:
        other = {g: t.clone() for g, t in sound.items()}
        for g, t in other.items():
            t[:, rows] = sound[g][:, 128:192]
        return {"last_column_block_unwritten": cut, "workspace_tile_from_other": other}
    qh, kh, vh, doh = (V._split_heads(t, h).float() for t in (q, k, v, do))
    lse4, d4 = V._stats4(lse, h).float(), V._stats4(dcap, h).float()
    nxt = lambda t: torch.roll(t, -1, dims=1)
    s_scale, log2e = scale * V.A.LOG2E, V.A.LOG2E
    # dq's query rows from the next head's dS
    p = torch.exp2(nxt(qh)[..., rows, :] @ nxt(kh).transpose(-1, -2) * s_scale
                   - nxt(lse4)[..., rows, :] * log2e)
    ds = p * (nxt(doh)[..., rows, :] @ nxt(vh).transpose(-1, -2) - nxt(d4)[..., rows, :]) * scale
    got = {"dq": ds.to(q.dtype).float() @ kh}
    # dk's and dv's key rows from the next head's dS^T and P^T
    pt = torch.exp2(nxt(qh) @ nxt(kh)[..., rows, :].transpose(-1, -2) * s_scale - nxt(lse4) * log2e)
    dst = pt * (nxt(doh) @ nxt(vh)[..., rows, :].transpose(-1, -2) - nxt(d4)) * scale
    got["dk"] = dst.to(q.dtype).float().transpose(-1, -2) @ qh
    got["dv"] = pt.to(do.dtype).float().transpose(-1, -2) @ doh
    other = {}
    for g, r in got.items():
        x = V._split_heads(sound[g], h).clone()
        x[..., rows, :] = r.to(x.dtype)
        other[g] = V.A._heads_last(x)
    return {"last_column_block_unwritten": cut, "workspace_tile_from_other": other}


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
        launch.single_launches = launch.wide_launches = 0
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
            # the f32_sm90 kernels and the one-head sm90 kernels: a second
            # launch, the same bits
            rule = V.lse_fwd_form if name == "flash_fwd_lse" else V.bwd_form
            twice = f32 or rule(q.shape[-1] // heads, args[2].shape[-1] // heads, heads,
                                q.dtype) == "single_sm90"
            if name == "flash_fwd_lse":
                if twice:
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
                    "flash_fwd_lse_single": V.flash_fwd_lse.single_launches,
                    "flash_fwd_lse_f32": V.flash_fwd_lse.f32_launches,
                    "flash_bwd_dq_wide": V.flash_bwd_dq.wide_launches,
                    "flash_bwd_dq_sm90": V.flash_bwd_dq.sm90_launches,
                    "flash_bwd_dq_f32": V.flash_bwd_dq.f32_launches,
                    "flash_bwd_dq_single": V.flash_bwd_dq.single_launches,
                    "flash_bwd_dkv_wide": V.flash_bwd_dkv.wide_launches,
                    "flash_bwd_dkv_sm90": V.flash_bwd_dkv.sm90_launches,
                    "flash_bwd_dkv_f32": V.flash_bwd_dkv.f32_launches,
                    "flash_bwd_dkv_single": V.flash_bwd_dkv.single_launches,
                    "flash_mha_packed": A.flash_mha_packed.launches,
                    "flash_mha_packed_sm90": A.flash_mha_packed.sm90_launches,
                    "flash_mha_packed_f32": A.flash_mha_packed.f32_launches,
                    "flash_single_sm90": A.flash_single.sm90_launches,
                    "flash_single_f32": A.flash_single.f32_launches,
                    "flash_mha_int8_sm90": A8.flash_mha_int8.sm90_launches,
                    "qmm": QM.qmm.launches, "quant_rows": QM.quant_rows.launches}
    return resets, read


def train_expected(cfg, tp: int = 1) -> dict:
    """Launches of each kernel in one training step of `cfg` (its scale and
    input, remat or not), from the training route table: one forward, dq and
    dk/dv launch a site that leaves the naive route, the forward of packed
    bf16 heads on the sm90 kernel, of one bf16 head (dark3, folded heads)
    on its one-head form and every fp32 forward on the f32_sm90 kernel
    (`lse_fwd_form`), the backward of packed bf16 heads on the
    sm90 kernels where `bwd_form` sends it (heads of 128 to 384) and every
    fp32 backward on the f32_sm90 kernels, the bf16 one-head backward
    (dark3, folded heads) on the single_sm90 kernels where `bwd_form` sends
    it (phi 'n', 's', 'm'); with remat, every neck site's forward runs
    again in the backward's recompute; no serving kernel. With tp > 1, a
    tensor-parallel rank's: each neck TEB on heads / tp heads where tp
    divides its head count."""
    import torch

    from transparent_object_detection_tpu_torch.ops import attention as A
    from transparent_object_detection_tpu_torch.ops import attention_vjp as V

    counts = {"flash_fwd_lse": 0, "flash_fwd_lse_sm90": 0, "flash_fwd_lse_single": 0,
              "flash_fwd_lse_f32": 0,
              "flash_bwd_dq_wide": 0, "flash_bwd_dq_sm90": 0, "flash_bwd_dq_f32": 0,
              "flash_bwd_dq_single": 0, "flash_bwd_dkv_wide": 0, "flash_bwd_dkv_sm90": 0,
              "flash_bwd_dkv_f32": 0, "flash_bwd_dkv_single": 0, "flash_mha_packed": 0,
              "flash_mha_packed_sm90": 0,
              "flash_mha_packed_f32": 0, "flash_single_sm90": 0, "flash_single_f32": 0,
              "flash_mha_int8_sm90": 0, "qmm": 0, "quant_rows": 0}
    dtype = getattr(torch, cfg.compute_dtype)
    suffix = {"sm90": "_sm90", "f32_sm90": "_f32", "single_sm90": "_single",
              "wide_sm90": "_wide"}
    for name, (n, cq, cv, heads, _) in scale_sites(cfg.phi, cfg.input_shape).items():
        if tp > 1 and name != "dark3" and heads % tp == 0:  # a TP rank's local heads
            cq, cv, heads = cq // tp, cv // tp, heads // tp
        route = A.train_route(n, cq, heads, cv)
        if route == "naive":
            continue
        # folded heads reach the kernels as single heads of the widths the
        # fold copy pads to a multiple of 8
        pad8 = _pad8 if route == "folded" else (lambda d: d)
        widths = (pad8(cq // heads), pad8(cv // heads), heads if route == "packed" else 1, dtype)
        counts["flash_fwd_lse" + suffix.get(V.lse_fwd_form(*widths), "")] += (
            2 if cfg.remat and name != "dark3" else 1)
        bwd = suffix[V.bwd_form(*widths)]
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
    the quant_out groups, `packed_fwd_form` and `single_fwd_form`: bf16
    packed heads take the sm90 kernel, bf16 single and folded heads its
    one-head form, fp32 calls the f32_sm90 kernel) and the int8 TEB's rules
    (models/blocks.py): each int8 TEB
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
        if kernel == "flash_single":  # one head: the one-head sm90 form, or fp32's
            return kernel + ("_f32" if f32 else "_sm90")
        if kernel.startswith(("flash_mha_int8", "flash_int8")):  # the one int8 kernel
            check(A8.int8_fwd_form(dq, dv, kernel) == "sm90", f"{kernel}: no form")
            return kernel + "_sm90"
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
                                                "flash_single_sm90": 1},
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
    a head (each slice on its own amax: the sm90 kernel's warpgroup halves
    without their exchange, or its v slices with a cluster peer's amax
    ignored), the last slice's scale written."""
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


def _int8_out_faults(o32, heads, plan) -> dict:
    """{fault: thunk} of the int8-output form's own faults, from the sound
    fp32 output `o32()` (B, N, heads * dv) and the int8-output plan: the
    split form's warpgroup halves quantized apart (their amax not
    exchanged), the cluster's v slices quantized apart (a peer's amax
    ignored), one slice's P from another query tile (its rows those of the
    next query tile)."""
    out = {}
    if plan["split"]:
        out["amax_per_warpgroup_half"] = lambda: _amax_per_slice(o32(), heads, plan["v_cols"])
    if plan["slices"] > 1:
        width = plan["v_cols"] * (2 if plan["split"] else 1)
        out["cluster_peer_amax_ignored"] = lambda: _amax_per_slice(o32(), heads, width)
        out["slice_p_from_other_query_tile"] = lambda: _quant_per_head(
            _v_slice_faults(o32(), heads, plan)["v_slice_from_other_tile_S"], heads)
    return out


def scale_kernel_phase() -> dict:
    """Rows 1-8 at every site of phi 'n', 'm', 'l' and 'x' 640x640 (batch 2,
    batch 1 at 'l' and 'x'), at the 480x576 input (N = 4,320) of phi 's'
    and 'm' and at the int8 sites of 'l' and 'x' there, and in fp32: each
    kernel against its plain version with the existing bars, each planted
    fault rejected on some input spread (the phi='s' faults, a dropped q/k
    slab of the width loop, a dropped tail key tile; for the int8 outputs
    the warpgroup halves or a cluster's v slices quantized apart and one
    slice's P from another query tile; a dropped K tail in qmm), every int8
    form twice for the same bits. Returns per kernel form the largest value
    error."""
    import torch

    from transparent_object_detection_tpu_torch.ops import attention as A
    from transparent_object_detection_tpu_torch.ops import attention_int8 as A8
    from transparent_object_detection_tpu_torch.ops import quant_matmul as QM

    check_launch_model()
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 5)
    randn = lambda *s: torch.randn(*s, generator=gen, device=DEVICE)
    qk_std = lambda score_std, scale, d: (score_std / (scale * d ** 0.5)) ** 0.5
    err, single_rows = {}, []

    def note(form, value):
        err[form] = max(err.get(form, 0.0), value)

    def flash_case(tag, b, n, cq, cv, heads, packed, dt):
        f32 = dt == torch.float32
        scale = (cq // heads) ** -0.5 if heads > 1 else 1.0
        faults = {}
        # the Hopper kernels: bf16 packed heads on flash_fwd_sm90.cu, one
        # bf16 head (dark3, folded heads) on its one-head form (with its
        # design's faults), every fp32 call on flash_fwd_f32_sm90.cu (with
        # its split's and layout's faults)
        one_head = not (packed and A._packed_heads(cq, heads))
        sm90 = f32 or one_head or A.packed_fwd_form(cq // heads, dt) == "sm90"
        ring = ("key_tile_used_twice",) + (("keys_past_n_scored_zero",) if n % 64 else ())
        ring += tuple(F32_FAULTS) if f32 else ()
        if one_head and not f32:
            check(A.single_fwd_form(_pad8(cq // heads), _pad8(cv // heads), dt) == "single_sm90",
                  f"{tag}: not on the one-head sm90 form")
            ring += single_faults(cq // heads, cv // heads)
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
                q, k = randn(b, n, cq) * std, randn(b, n, cq) * std
                if mean:
                    _score_shift(q, k, scale, mean, cq)
                q, k = q.to(dt), k.to(dt)
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
        if one_head and not f32 and tag.startswith("phi=n 640x640"):
            single_rows.append(_one_head_timing(tag.split()[-1], q, k, v, scale, heads,
                                                packed, err[form]))

    def int8_case(tag, b, n, cq, cv, heads, bk, dt, variants):
        scale = (cq // heads) ** -0.5 if heads > 1 else 1.0
        dv = cv // heads
        # the plan of the int8-output entries: v slices as one cluster
        oplan = A8.int8_sm90_plan(cq // heads, dv, n // bk, int8_out=True) if variants else None
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
            # the second launch's bits, and the faults of the ring, the layout
            # and the v slices (one slice's P from another query tile)
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
            twice_same_bits(lambda: A8.flash_mha_int8_qout(*args), out,
                            f"flash_mha_int8_qout {tag}")
            ref = A8.flash_mha_int8_qout_plain(*args)
            o32 = lambda: int8_attention_reference(q, k, v, heads, scale, bk, bk, torch.float32)
            qfaults = {"out_scale_per_row": lambda: _out_scale_per_row(o32(), heads),
                       "p_rounded_on_running_64_key_max": lambda: _quant_per_head(
                           faults["p_rounded_on_running_64_key_max"](torch.float32), heads)}
            qfaults.update(_int8_out_faults(o32, heads, oplan))
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
                    twice_same_bits(lambda: A8.flash_int8_handoff(*hargs), out,
                                    f"flash_int8_handoff {tag} quant_out={quant_out}")
                    ref = A8.flash_int8_handoff_plain(*hargs)
                    hfaults = {"kv_requantize_ratio_dropped": lambda: A8.flash_int8_handoff_plain(
                        payload, qs, *k_fault, *hv, heads, scale, quant_out, dt)}
                    o32h = lambda: A8.flash_int8_handoff_plain(payload, qs, *hk, *hv, heads,
                                                               scale, False, torch.float32)
                    if quant_out:
                        hfaults["out_scale_per_row"] = lambda: _out_scale_per_row(o32h(), heads)
                        hfaults.update(_int8_out_faults(o32h, heads, oplan))
                    r = _hold(f"flash_int8_handoff {tag} quant_out={quant_out}", out, ref,
                              hfaults, {**record, "groups": scales.shape[-1],
                                        "quant_out": quant_out})
                    note("flash_int8_handoff", r["max_abs_err"])
        for f, ok in rejected.items():
            check(ok, f"{tag}: the int8 bar rejects {f} on no input spread")

    bf, f32 = torch.bfloat16, torch.float32
    cases = [(phi, (640, 640)) for phi in SCALE_PHIS] + [
        (phi, (480, 576)) for phi in ("s", "m", "l", "x")]
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
            # 480x576 at phi 'l' and 'x': their int8 sites (dark3, h2) alone
            if (hw == (640, 640) or name == "h2" or packed_site) and (
                    hw == (640, 640) or phi not in ("l", "x")):
                flash_case(tag, b, n, cq, cv, heads, packed, bf)
            if other:
                continue
            route, bk = A.serving_route(n, cq, heads, cv, True, packed)
            if route == "int8":
                variants = packed and (cq // heads) % 128 == 0
                int8_case(tag, b, n, cq, cv, heads, bk, bf, variants)
                if name == "dark3" and phi in ("n", "m") and hw == (640, 640):
                    # the sliced (phi='m') and narrow (phi='n') forms at batch 1 too
                    int8_case(f"{tag} batch 1", 1, n, cq, cv, heads, bk, bf, False)
    # fp32 (csrc/flash_fwd_f32_sm90.cu): the packed, single-head and folded
    # forms, int8 with fp32 q
    for phi, name, b in (("m", "h4", 2), ("m", "h2", 2), ("m", "dark3", 1), ("n", "h2", 2),
                         ("n", "dark3", 2), ("n", "h1", 2), ("m", "h1", 2)):
        n, cq, cv, heads, packed = scale_sites(phi)[name]
        folded = " (folded)" if packed and not A._packed_heads(cq, heads) else ""
        flash_case(f"phi={phi} {name} fp32{folded}", b, n, cq, cv, heads, packed, f32)
    n, cq, _, heads, _ = scale_sites("m")["h4"]
    int8_case("phi=m h4 fp32", 2, n, cq, cq, heads, A8.pick_blocks(n, cq, heads)[1], f32, True)
    n, cq, cv, heads, _ = scale_sites("n")["dark3"]  # the fp32 phi='n' model's dark3
    int8_case("phi=n dark3 fp32", 2, n, cq, cv, heads, A8.pick_blocks(n, cq, heads, cv=cv)[1],
              f32, False)

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
    # quant_rows alone past the fp32 qkv: phi='n''s K = 849 in fp32 (rows
    # starting mid-unit) with qmax 7, and rows wider than any team holds in
    # registers (streamed: 20,000 fp32, 40,000 bf16)
    for label, (m, k, dt, ln, qmax) in (("fp32 K=849 qmax 7", (256, 849, f32, True, 7)),
                                        ("fp32 K=20000 streamed", (256, 20000, f32, True, 127)),
                                        ("bf16 K=40000 streamed", (256, 40000, bf, False, 127))):
        r = quant_rows_case(label, rows(m, k, dt), ln, qmax)
        print(json.dumps({"check": f"quant_rows {label}", "team": QM.quant_rows_team(
            k, torch.empty((), dtype=dt).element_size()), **r}), flush=True)
        note("quant_rows" + ("_f32" if dt == f32 else ""), r["quant_rows"]["max_abs_err"])
    print(json.dumps({"scale_kernel_max_abs_err": err}), flush=True)
    return err, single_rows


def _one_head_timing(node, q, k, v, scale, heads, folded, max_abs_err) -> dict:
    """Row 2 at a one-head site (the last, peaked inputs of its case):
    `_single_timing` on the operands the route hands flash_single (the
    folded heads as the fold copy makes them), at batch 2 and 1."""
    from transparent_object_detection_tpu_torch.ops import attention as A

    if folded:
        q, k, v = (A._fold_heads(t, heads) for t in (q, k, v))
    half = lambda t: t[:t.shape[0] // 2]  # one image of the two (its heads, folded)
    row = {"node": node, "b": q.shape[0], "n": q.shape[1], "cq": q.shape[-1], "cv": v.shape[-1],
           "form": "single_sm90", "max_abs_err": max_abs_err, **_single_timing(q, k, v, scale),
           "batch1": _single_timing(half(q), half(k), half(v), scale, plain=False)}
    print(json.dumps({"kernel": "flash_single one-head phi=n", **row}), flush=True)
    return row


def bf16_path_calls(model, images, f32: bool = False) -> dict:
    """Every flash_mha_packed / flash_single launch of one forward, recorded
    with its arguments, held against its plain version on the same
    activations (the kernel bar; fp32: the fp32 bar; the one-head sm90 form
    and fp32 kernels twice for the same bits) and timed beside its bound,
    its plain version and SDPA on the same shapes."""
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
            if f32 or name == "flash_single":  # a second launch, the same bits
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
                scale = args[3]
                b, n, cq = args[0].shape
                cv, h = args[2].shape[-1], 1
                # SDPA on (B, 1, N, d) views, one head, which its fused kernels take
                q, k, v = (t[:, None] for t in args[:3])
            ops = 2.0 * b * n * n * (cq + cv)
            nbytes = out.element_size() * (b * n * (2 * cq + cv) + b * n * cv)
            t_ops, t_bytes = ops / peak, nbytes / PEAK_BYTES
            ms = timed_ms(lambda: kernel(*args), 5, 1)
            plain_ms = timed_ms(lambda: plain(*args), 1, 1)
            lib = timed_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=scale), 5, 1)
            form = (A.packed_fwd_form(cq // h, out.dtype) if name == "flash_mha_packed"
                    else A.single_fwd_form(_pad8(cq), _pad8(cv), out.dtype))
        # one head: dark3 (q/k narrower than v) or a folded head
        node = f"launch {i}" if name == "flash_mha_packed" else (
            "dark3" if cq < cv else "h1 folded")
        rows[name].append({"launch": i, "node": node, "b": b, "n": n, "cq": cq, "cv": cv,
                           "heads": h, "form": form, "bar_used": used,
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


def _fitting_batch(model, images, candidates, headroom_gib: float = 12.0) -> dict:
    """The largest batch of `candidates` whose forward fits the card: the
    peaks of a batch-1 and a batch-2 forward (after `reset_peak_memory_stats`)
    give the weights' and one image's share, a batch fits if its predicted
    peak leaves `headroom_gib` of the card free (the predictor's letterbox
    and NMS beside the forward, the allocator's fragmentation: phi='l' A at
    batch 32, predicted 70.9 GiB, failed on a 4.7 GiB block with 68.0 GiB
    allocated and 9.0 reserved). The allocator's cache is emptied first."""
    import torch

    torch.cuda.empty_cache()
    peaks = {}
    with torch.inference_mode():
        for b in (1, 2):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            model(images[:b])
            torch.cuda.synchronize()
            peaks[b] = torch.cuda.max_memory_allocated() / 2**30
    per_image = max(peaks[2] - peaks[1], 0.0)
    total = torch.cuda.get_device_properties(0).total_memory / 2**30
    fits = [b for b in candidates if peaks[1] + (b - 1) * per_image + headroom_gib <= total]
    check(bool(fits), f"no batch of {candidates} fits: peaks {peaks} of {total:.1f} GiB")
    reading = {"batch": max(fits), "peak_gib_batch1": peaks[1], "peak_gib_batch2": peaks[2],
               "card_gib": total, "predicted_gib": {b: peaks[1] + (b - 1) * per_image
                                                    for b in candidates}}
    print(json.dumps({"fitting_batch": reading}), flush=True)
    return reading


def scale_slice_phase(card: str, phi: str, tags, batches, timed: bool, shared: bool = False,
                      fp32: bool = True, big=(32,)) -> dict:
    """FocusModel at `phi` 640x640, full width, seeded random weights, served
    through Predictor.detect_raw_batch in each configuration of `tags`
    ("bf16", "int8", "A", "B") from the bf16 model's weights: the launches of
    each counted batch in `batches` equal to `expected_launches`; `decoded`
    and the detection sets against the same configuration on plain versions
    (batch 4, or 2 when 2 is the largest counted batch); with `timed`, every
    launch of a batch-2 forward against its plain version and timed, batch-1
    latency, throughput at the largest batch of `big` that fits, peak
    memory and a profile. With `shared` (phi='l': 33.3 GB of fp32
    parameters) the weights are drawn on the card and each int8 model takes
    the bf16 model's parameter tensors themselves (built on the meta device,
    loaded with assign): one fp32 copy at a time, each int8 model (its int8
    weight caches) freed before the next. With `fp32`, one fp32 forward at
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
    torch.cuda.reset_peak_memory_stats()
    base = build_model(ModelConfig(phi=phi), device=DEVICE, seed=SEED, init_on_device=shared)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in base.parameters())
    print(json.dumps({"scale_model": phi, "params": n_params,
                      "build_s": time.perf_counter() - t0,
                      "build_peak_gib": torch.cuda.max_memory_allocated() / 2**30}), flush=True)
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
        if shared:  # the bf16 model's parameter tensors, no copy
            model = build_model(cfg, device="meta", seed=None, int8_variants=variants)
            model.load_state_dict(base.state_dict(), assign=True)
            return model
        model = build_model(cfg, device=DEVICE, seed=None, int8_variants=variants)
        model.load_state_dict(base.state_dict())
        return model

    results = {}
    for tag in tags:
        t_tag = time.perf_counter()
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
        if int8 and not timed:  # every int8 launch held against plain, untimed forward
            record["rows"] = int8_path_calls(model, images[:2])
        if timed:
            record["rows"] = (bf16_path_calls(model, images[:2]) if not int8
                              else int8_path_calls(model, images[:2]))
            fit = _fitting_batch(model, images, big) if big != (32,) else {"batch": 32}
            # two timed big-batch steps, not three: the smoke's time limit
            record["perf"] = {"card": card, "model": f"phi={phi} 640x640 {tag}",
                              "params": n_params, "fitting_batch": fit,
                              **serving_timing(model, predictor, raw, shapes, images, rng,
                                               iters=2, big=fit["batch"])}
            print(json.dumps({"scale_slice_perf": record["perf"]}), flush=True)
        record["seconds"] = time.perf_counter() - t_tag
        results[tag] = record
        if model is not base:
            del model, predictor
            torch.cuda.empty_cache()

    if fp32:  # one fp32 forward at batch 2, counted, against plain
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
        del model, predictor
    del base
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
    ("s", (480, 576), "bfloat16"), ("m", (480, 576), "bfloat16"), ("l", (480, 576), "bfloat16"),
    ("n", (640, 640), "float32"), ("n", (480, 576), "float32"))


def train_scale_kernel_phase() -> dict:
    """Rows 9-11 at every training site of phi 'n', 'm', 'l' and 'x'
    640x640, at 480x576 (N = 4,320; phi 's', 'm' and 'l') and in fp32,
    batch 2, near-flat and peaked inputs: the forward's out within the
    kernel bar (fp32: the fp32 bar) and lse within LSE_ATOL (fp32: 1e-4),
    the gradients within the gradient bar, the backward bit-identical over two runs; each planted
    fault (those of the phi='s' phase, a q/k slab left out of S, a v/dO
    slab left out of dP, the last dv pass unwritten, the tail key tile
    left out) rejected on some input spread; the wide kernels' launches
    counted at every site of phi 'l' and 'x', with their design's faults.
    Times the phi='m' sites (bf16) and the phi='n' sites (fp32) beside
    bound, plain and SDPA forward / backward, and the backward at every
    phi='l' site (640x640, bf16). Returns {"rows": {form: [site rows]},
    "err": {form: max abs}, "wide_launches": {kernel: the wide kernels'
    counted launches at phi='l' 640x640, one a site}}."""
    import torch
    import torch.nn.functional as F

    from transparent_object_detection_tpu_torch.ops import attention_vjp as V

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 7)
    rows = {}
    err = {}
    wide_launches = {"flash_bwd_dq": 0, "flash_bwd_dkv": 0}
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
                if phi in ("l", "x") and not is32:  # every bf16 call on the wide kernels
                    check(V.bwd_form(q.shape[-1] // h, v.shape[-1] // h, h, q.dtype)
                          == "wide_sm90" and V.flash_bwd_dq.wide_launches == 1
                          and V.flash_bwd_dkv.wide_launches == 1,
                          f"{tag}: the backward did not run the wide_sm90 kernels")
                    if phi == "l" and hw == (640, 640) and score_std == SCORE_STDS[0]:
                        for kname in wide_launches:
                            wide_launches[kname] += getattr(V, kname).wide_launches
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
                form = kname + suffix + {"sm90": " sm90", "single_sm90": " single_sm90",
                                         "wide_sm90": " wide_sm90"}.get(
                    rule(q.shape[-1] // h, v.shape[-1] // h, h, q.dtype), "")
                err[form] = max(err.get(form, 0.0),
                                max(x["max_abs_err"] for x in readings[kname]))
            # phi='m' bf16, phi='n' fp32 and phi='n' bf16's one-head sites;
            # phi='l''s backward (the wide kernels)
            wide = phi == "l" and hw == (640, 640) and not is32
            timed = (phi == "m" and hw == (640, 640) and not is32) or \
                (is32 and phi == "n" and hw == (640, 640) and name != "phi=m h4") or \
                (phi == "n" and hw == (640, 640) and not is32 and route != "packed") or wide
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
            for kname in TRAIN_KERNELS[1:] if wide else TRAIN_KERNELS:
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
    print(json.dumps({"train_scale_kernel_max_abs_err": err,
                      "wide_launches_phi_l": wide_launches}), flush=True)
    return {"rows": rows, "err": err, "wide_launches": wide_launches}


# rows 10 and 11 at phi='l''s tensor-parallel local shapes (B, N, q/k, v,
# heads on a rank; the neck sites' 8 heads divided by tp): tp 4 holds two
# heads of 1,536 (h1) and of 768 (h2, h4), tp 8 one; dark3, not sharded, is
# the one-device site of the train scale kernel phase
WIDE_TP_SHAPES = {4: {"h1 tp=4": (2, 1600, 3072, 3072, 2), "h2 tp=4": (2, 6400, 1536, 1536, 2),
                      "h4 tp=4": (2, 1600, 1536, 1536, 2)},
                  8: {"h1 tp=8": (2, 1600, 1536, 1536, 1), "h2 tp=8": (2, 6400, 768, 768, 1),
                      "h4 tp=8": (2, 1600, 768, 768, 1)}}


def wide_tp_phase() -> dict:
    """flash_bwd_dq and flash_bwd_dkv at WIDE_TP_SHAPES (batch 2; the local
    heads as column views of one packed qkv, scale d ** -0.5), near-flat and
    peaked inputs: every call on the wide kernels (counted in
    `wide_launches`), twice for the same bits, within the gradient bar of
    plain, every fault of `_bwd_faults` (the wide kernels' own included) and
    of `_scale_train_faults` rejected on some input spread; timed on the
    peaked inputs beside bound, plain and SDPA's backward. -> {tp: {"rows":
    {kernel: [site rows]}, "launches": {kernel: counted launches, one a
    site}}}"""
    import torch
    import torch.nn.functional as F

    from transparent_object_detection_tpu_torch.ops import attention_vjp as V

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 9)
    kernels = TRAIN_KERNELS[1:]
    out = {}
    for tp, shapes in WIDE_TP_SHAPES.items():
        rows = {kname: [] for kname in kernels}
        launches = {kname: 0 for kname in kernels}
        for node, (b, n, cq, cv, h) in shapes.items():
            scale = (cq // h) ** -0.5
            tag = f"phi=l {node} ({h} x {cq // h})"
            check(V.bwd_form(cq // h, cv // h, h, torch.bfloat16) == "wide_sm90",
                  f"{tag}: not on the wide kernels")
            readings = {kname: [] for kname in kernels}
            rejected = {}
            for score_std in SCORE_STDS:
                q, k, v, do, _ = _train_call_inputs(gen, b, "packed", n, cq, cv, h, scale,
                                                    score_std, torch.bfloat16)
                pout, plse = V.flash_fwd_lse_plain(q, k, v, scale, h)
                args = (q, k, v, do, plse, V.compute_dcap(pout, do, h), scale, h)
                V.reset_launch_counts()
                got = {"dq": V.flash_bwd_dq(*args)}
                got["dk"], got["dv"] = V.flash_bwd_dkv(*args)
                counted = {kname: getattr(V, kname).wide_launches for kname in kernels}
                check(all(c == 1 for c in counted.values()),
                      f"{tag}: wide launches {counted}")
                if score_std == SCORE_STDS[0]:
                    for kname, c in counted.items():
                        launches[kname] += c
                again = {"dq": V.flash_bwd_dq(*args)}
                again["dk"], again["dv"] = V.flash_bwd_dkv(*args)
                torch.cuda.synchronize()
                check(all(torch.equal(got[g], again[g]) for g in got),
                      f"flash backward {tag}: two runs gave different bits")
                ref = {"dq": V.flash_bwd_dq_plain(*args)}
                ref["dk"], ref["dv"] = V.flash_bwd_dkv_plain(*args)
                faults = {**_bwd_faults(V, *args), **_scale_train_faults(*args, sound=ref)}
                for kname, grads in (("flash_bwd_dq", ("dq",)), ("flash_bwd_dkv", ("dk", "dv"))):
                    r = {"score_std": score_std, "bitwise_repeat": True}
                    for g in grads:
                        r[g] = grad_reading(got[g], ref[g])
                        check(r[g]["bar_used"] <= 1.0, f"{kname} {tag} {g}: {r[g]}")
                    r["bar_used"] = max(r[g]["bar_used"] for g in grads)
                    r["max_abs_err"] = max(r[g]["max_abs_err"] for g in grads)
                    readings[kname].append(r)
                    for f, fg in faults.items():
                        used = [grad_reading(fg[g], ref[g])["bar_used"] for g in grads if g in fg]
                        if used:
                            key = f"{kname} {f}"
                            rejected[key] = max(rejected.get(key, 0.0), max(used))
            for f, used in rejected.items():
                check(used > 1.0, f"{tag}: the bar rejects {f} on no input spread ({used:.3g}x)")
            print(json.dumps({"wide_tp_case": tag, "n": n, "cq": cq, "cv": cv, "heads": h,
                              "readings": readings, "faults_rejected_by": rejected}), flush=True)
            # time on the last (peaked) inputs
            costs = _train_costs(b, n, cq, cv, h)
            qh, kh, vh, doh = (V._split_heads(t, h).detach().contiguous() for t in (q, k, v, do))
            qh, kh, vh = (t.requires_grad_() for t in (qh, kh, vh))
            sdpa_fwd = timed_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=scale),
                                5, 1)

            def sdpa_fwd_bwd():
                F.scaled_dot_product_attention(qh, kh, vh, scale=scale).backward(doh)
            sdpa_bwd = max(timed_ms(sdpa_fwd_bwd, 5, 1) - sdpa_fwd, 0.0)
            kern = {"flash_bwd_dq": lambda: V.flash_bwd_dq(*args),
                    "flash_bwd_dkv": lambda: V.flash_bwd_dkv(*args)}
            plain = {"flash_bwd_dq": lambda: V.flash_bwd_dq_plain(*args),
                     "flash_bwd_dkv": lambda: V.flash_bwd_dkv_plain(*args)}
            for kname in kernels:
                bnd, by = bound_ms(*costs[kname])
                rows[kname].append(dict(
                    node=node, b=b, n=n, cq=cq, cv=cv, heads=h, form="wide_sm90",
                    readings=readings[kname],
                    max_abs_err=max(x["max_abs_err"] for x in readings[kname]),
                    ms=timed_ms(kern[kname], 5, 1), plain_ms=timed_ms(plain[kname], 1, 1),
                    library_ms=sdpa_bwd, bound_ms=bnd, bound_by=by))
                print(json.dumps({"kernel": kname + f" wide_sm90 tp={tp}", **rows[kname][-1]}),
                      flush=True)
        out[tp] = {"rows": rows, "launches": launches}
    return out


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


# ---------------------------------------------------------------------------
# the training pipeline: annotations -> dataset -> threaded loader ->
# device_prefetch -> the train step -> validation loss -> EvalCallback ->
# checkpoints, through Trainer.fit, and an exact resume
# ---------------------------------------------------------------------------

FIT_TRAIN_IMAGES, FIT_VAL_IMAGES = 48, 16
FIT_PHOTO_SIZES = ((480, 640), (720, 1280))  # (h, w) of the written JPEGs
FIT_BATCHES = (16, 8)  # frozen epoch, unfrozen epoch
FIT_EVAL_BATCH = 8
FIT_WORKERS = 6  # loader threads (the card's machine has 8 cores)


def write_fit_set(root: str, seed: int = SEED):
    """A synthetic detection set made with numpy from `seed`: smooth
    backgrounds (a coarse random grid resized), one to four filled
    rectangles of one class with some noise, photo sizes, JPEG files and
    annotation lines. Returns (train_lines, val_lines)."""
    import os

    import cv2
    import numpy as np

    rng = np.random.default_rng(seed)
    lines = []
    for i in range(FIT_TRAIN_IMAGES + FIT_VAL_IMAGES):
        h, w = FIT_PHOTO_SIZES[i % len(FIT_PHOTO_SIZES)]
        coarse = rng.integers(40, 220, (6, 8, 3)).astype(np.uint8)
        img = cv2.resize(coarse, (w, h), interpolation=cv2.INTER_CUBIC)
        tokens = []
        for _ in range(int(rng.integers(1, 5))):
            bw, bh = int(rng.integers(w // 12, w // 3)), int(rng.integers(h // 12, h // 3))
            x1, y1 = int(rng.integers(0, w - bw)), int(rng.integers(0, h - bh))
            img[y1:y1 + bh, x1:x1 + bw] = rng.integers(0, 256, 3).astype(np.uint8)
            tokens.append(f"{x1},{y1},{x1 + bw},{y1 + bh},0")
        img = np.clip(img.astype(np.int16) + rng.integers(-12, 13, img.shape), 0, 255)
        path = os.path.join(root, f"img{i:03d}.jpg")
        check(cv2.imwrite(path, img.astype(np.uint8)), f"could not write {path}")
        lines.append(" ".join([path] + tokens))
    return lines[:FIT_TRAIN_IMAGES], lines[FIT_TRAIN_IMAGES:]


class LoaderClock:
    """Stands in for `device_prefetch` where Trainer.fit calls it (each
    epoch the training loader, then the validation loader): the host time
    each batch waited on it, and when each call began and ended."""

    def __init__(self, prefetch):
        self.prefetch = prefetch
        self.calls = []

    def __call__(self, iterator, **kw):
        rec = {"start": time.perf_counter(), "waits": []}
        self.calls.append(rec)
        gen = self.prefetch(iterator, **kw)
        while True:
            t = time.perf_counter()
            try:
                batch = next(gen)
            except StopIteration:
                rec["end"] = time.perf_counter()
                return
            rec["waits"].append(time.perf_counter() - t)
            yield batch


def _attention_impl_of(model):
    return next(m.attention_impl for m in model.modules() if hasattr(m, "attention_impl"))


def _smoke_eval_callback():
    """EvalCallback whose variables get class biases, before each
    evaluation, such that about CANDIDATES_PER_IMAGE anchors an image pass
    its confidence (as a trained detector's few dozen would; the random
    weights give none): the biases come from a plain-version forward on the
    first two validation images (plain versions count no launch)."""
    import numpy as np
    import torch
    from PIL import Image

    from transparent_object_detection_tpu_torch.data.annotations import parse_annotation_line
    from transparent_object_detection_tpu_torch.eval.callbacks import EvalCallback
    from transparent_object_detection_tpu_torch.models.detector import set_attention_impl
    from transparent_object_detection_tpu_torch.utils.image import cvt_color, resize_image

    class SmokeEval(EvalCallback):
        def letterboxed(self, lines):
            """The images of `lines` as evaluate letterboxes them."""
            h, w = self.model_cfg.input_shape
            return [np.asarray(resize_image(cvt_color(Image.open(parse_annotation_line(l)[0])),
                                            (w, h), letterbox_image=True), np.float32) / 255.0
                    for l in lines]

        def evaluate(self, model, variables, write_dirs=None):
            imgs = self.letterboxed(self.val_lines[:2])
            params = dict(variables["params"])
            names = [f"head.cls{i}.out.bias" for i in range(3)]
            for n in names:
                params[n] = torch.zeros_like(params[n])
            prev = _attention_impl_of(model)
            was_training = model.training
            set_attention_impl(model, "plain")
            model.eval()
            try:
                with torch.inference_mode():
                    dec = torch.func.functional_call(
                        model, {**params, **variables["batch_stats"]},
                        (torch.as_tensor(np.stack(imgs), device=self.device),))["decoded"]
                logits = torch.logit(dec[..., 4:].float().amax(-1), eps=1e-6).flatten()
            finally:
                set_attention_impl(model, prev)
                model.train(was_training)
            kth = float(logits.topk(CANDIDATES_PER_IMAGE * len(imgs)).values[-1])
            conf = self.predict_cfg.confidence
            bias = float(np.log(conf / (1 - conf))) - kth
            for n in names:
                params[n] = torch.full_like(params[n], bias)
            self.class_bias = bias
            return super().evaluate(model, {"params": params,
                                            "batch_stats": variables["batch_stats"]}, write_dirs)

    return SmokeEval


def fit_phase(card: str) -> dict:
    """Trainer.fit at phi='s' 640x640, full width and depth, bf16 (seeded
    random weights, dark3's gamma 0.5 as in the train slice), on a synthetic
    set written from seed 0 (FIT_TRAIN_IMAGES training and FIT_VAL_IMAGES
    validation JPEGs at photo sizes): one frozen epoch at batch 16, one
    unfrozen at batch 8, mosaic and mixup on, the threaded loader,
    device_prefetch, the validation loss, EvalCallback every epoch (the
    port's Predictor on the EMA weights, COCO and VOC mAP) and a
    CheckpointManager. Launch counts reset just before the fit and read
    just after, against the route table: rows 9-11 per step on their sm90
    forms, rows 1-2 per validation and EvalCallback forward. Then: the
    callback's forward on the weights it last evaluated against the plain
    versions (`decoded` within the slice limits, the detection sets matched
    anchor by anchor), its COCO and VOC stats against a run of the same
    callback on the plain versions (within 0.01: with random weights both
    score AP near 0, so this bar cannot tell a wrong kernel; the decoded
    and per-anchor checks are what hold the kernels), the evaluators' AP 1 on the ground truths, the checkpoint files, the
    last state read back bit for bit, a resumed fit from epoch 1's state
    (its epoch's losses against the uninterrupted run's), and the bare
    make_train_step's imgs/s at each batch beside the fit's (and with the
    loader's threads running beside it; its profiled device time gives the
    fit's estimated device idle share)."""
    import os
    import shutil
    import tempfile
    from unittest import mock

    import numpy as np
    import torch

    from transparent_object_detection_tpu_torch.config import ModelConfig, TrainConfig
    from transparent_object_detection_tpu_torch.data import loader as L
    from transparent_object_detection_tpu_torch.eval.coco_map import coco_eval
    from transparent_object_detection_tpu_torch.eval.voc_map import voc_map
    from transparent_object_detection_tpu_torch.models.detector import set_attention_impl
    from transparent_object_detection_tpu_torch.train import trainer as T
    from transparent_object_detection_tpu_torch.train.checkpoints import CheckpointManager
    from transparent_object_detection_tpu_torch.train.optimizer import build_optimizer

    t_phase = time.perf_counter()
    cfg = ModelConfig()  # phi='s', 640x640, bf16
    tc = TrainConfig(seed=SEED, freeze_epoch=1, unfreeze_epoch=2, freeze_batch_size=FIT_BATCHES[0],
                     unfreeze_batch_size=FIT_BATCHES[1], mosaic=True, mixup=True,
                     num_workers=FIT_WORKERS, save_period=2, eval_period=1)
    SmokeEval = _smoke_eval_callback()

    class Checkpoints(CheckpointManager):
        """Times each save and keeps epoch 1's `last_state` for the resume
        (a hard link: the next save replaces the name, not the file)."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.save_s = []

        def save_epoch(self, state, epoch, is_best, period):
            t = time.perf_counter()
            super().save_epoch(state, epoch, is_best, period)
            self.save_s.append(time.perf_counter() - t)
            if epoch == 1:
                src = os.path.join(self.save_dir, "last_state")
                dst = os.path.join(self.save_dir, "ep001_state")
                try:
                    os.link(src, dst)
                except OSError:  # a file system without hard links
                    shutil.copyfile(src, dst)

    with tempfile.TemporaryDirectory(prefix="fit_smoke_") as root:
        t0 = time.perf_counter()
        train_lines, val_lines = write_fit_set(root)
        write_s = time.perf_counter() - t0
        ckpt = Checkpoints(os.path.join(root, "ckpt"))
        # confidence 0.5, as the serving phases: the class biases then sit
        # near 0, where bf16 resolves the random head's logit spread (at the
        # 0.05 default's bias of -2.9 a bf16 step is 0.016, the spread ~0.005)
        cb = SmokeEval(cfg, val_lines, ["object"], os.path.join(root, "logs"), period=1,
                       confidence=0.5, batch_size=FIT_EVAL_BATCH, device=DEVICE)
        trainer = T.Trainer(cfg, tc, device=DEVICE, verbose=True)
        with torch.no_grad():  # else dark3's attention gets a zero cotangent
            trainer.model.backbone.dark3_attn.gamma.fill_(0.5)
        resets, read = train_launch_counts()
        clock = LoaderClock(L.device_prefetch)
        torch.cuda.synchronize()
        # the main path, counted: counts to 0 just before, read just after
        for reset in resets:
            reset()
        t0 = time.perf_counter()
        with mock.patch.object(T, "device_prefetch", clock):
            history = trainer.fit(train_lines, val_lines, callbacks=[cb], checkpointer=ckpt)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = read()
        fit_dets = cb.last_dets

        # launches: rows 9-11 per step, rows 1-2 per validation / eval forward
        steps = [FIT_TRAIN_IMAGES // b for b in FIT_BATCHES]
        forwards = (sum(FIT_VAL_IMAGES // b for b in FIT_BATCHES)
                    + len(history) * -(-FIT_VAL_IMAGES // FIT_EVAL_BATCH))
        per_step, per_fwd = train_expected(cfg), expected_launches("s", 2, "bf16")
        expected = {k: per_step.get(k, 0) * sum(steps) + per_fwd.get(k, 0) * forwards
                    for k in launches}
        print(json.dumps({"fit_main_path_launches": launches, "expected": expected,
                          "steps": steps, "serving_forwards": forwards}), flush=True)
        check(launches == expected, f"fit: launches {launches}, expected {expected}")
        for k in ("flash_fwd_lse_sm90", "flash_fwd_lse_single", "flash_bwd_dq_sm90",
                  "flash_bwd_dq_single", "flash_bwd_dkv_sm90", "flash_bwd_dkv_single",
                  "flash_mha_packed_sm90", "flash_single_sm90"):
            check(launches[k] > 0, f"fit: {k} never launched")

        # history: one finite entry per epoch
        check(len(history) == 2 and all(np.isfinite([h["loss"], h["val_loss"], h["map50"]]).all()
                                        for h in history), f"fit: history {history}")

        # the loader: host wait per batch, each epoch's training span
        epochs = []
        for e, bs in enumerate(FIT_BATCHES):
            tr, va = clock.calls[2 * e], clock.calls[2 * e + 1]
            span = va["start"] - tr["start"]  # the steps and the loss's host copy
            waits = np.asarray(tr["waits"]) * 1e3
            epochs.append({"epoch": e, "batch": bs, "steps": len(waits),
                           "train_span_s": span, "imgs_per_s": len(waits) * bs / span,
                           "loader_wait_ms_mean": float(waits.mean()),
                           "loader_wait_ms_median": float(np.median(waits)),
                           "loader_wait_ms_max": float(waits.max()),
                           "loader_wait_share": float(waits.sum() / 1e3 / span),
                           "first_batch_wait_ms": float(waits[0]),
                           "val_wait_ms_mean": float(np.mean(va["waits"]) * 1e3),
                           "epoch_seconds": history[e]["epoch_seconds"]})
            check(len(waits) == steps[e], f"fit: epoch {e} ran {len(waits)} steps")

        # EvalCallback: non-empty detections; its forward's `decoded` and
        # detection sets (as detect_step forms them) against the plain
        # versions under the slice limits, on the weights it last evaluated
        n_dets = [len(d) for d in fit_dets]
        check(all(n > 0 for n in n_dets), f"fit: EvalCallback found no detection: {n_dets}")
        check(max(n_dets) < cb.predict_cfg.max_detections,
              f"fit: max_detections cut the detections: {n_dets}")
        view = cb._predictor.model  # the model's graph on the evaluated variables
        images = torch.as_tensor(np.stack(cb.letterboxed(val_lines)), device=DEVICE)

        def decoded():
            with torch.inference_mode():
                return torch.cat([view(images[i:i + FIT_EVAL_BATCH])["decoded"]
                                  for i in range(0, len(images), FIT_EVAL_BATCH)])

        dec_k = decoded()
        set_attention_impl(trainer.model, "plain")
        try:
            dec_p = decoded()
        finally:
            set_attention_impl(trainer.model, None)
        dec_diff = {"decoded_box_max_abs_px": float((dec_k[..., :4] - dec_p[..., :4]).abs().max()),
                    "decoded_score_max_abs": float((dec_k[..., 4:] - dec_p[..., 4:]).abs().max())}
        match = {"matched_in_plain": match_per_anchor(dec_k, dec_p, cb.predict_cfg),
                 "plain_matched_here": match_per_anchor(dec_p, dec_k, cb.predict_cfg)}
        del images, dec_k, dec_p
        # the callback's scores: the last epoch's run against a run on the
        # plain versions of the same weights
        gts = cb.last_gts
        stats_k = coco_eval(fit_dets, gts, 1)  # what the last epoch's evaluate scored
        stats_k["voc_map"] = voc_map(fit_dets, gts, 1, cb.min_overlap)[0]
        check(abs(stats_k["AP50"] - history[-1]["map50"]) < 1e-12,
              f"fit: the scores of the last evaluation moved: {stats_k}, {history[-1]}")
        ema = {g: {k: v.to(DEVICE) for k, v in trainer.ema_variables[g].items()}
               for g in ("params", "batch_stats")}
        set_attention_impl(trainer.model, "plain")
        try:
            stats_p = cb.evaluate(trainer.model, ema)
        finally:
            set_attention_impl(trainer.model, None)
        del ema
        stat_keys = [k for k in stats_k if k != "stats"]
        stat_diff = {k: abs(stats_k[k] - stats_p[k]) for k in stat_keys}
        perfect = [np.concatenate([g[:, :4], np.ones((len(g), 1)), g[:, 4:5]], 1) for g in gts]
        ap_of_gts = {"coco_AP": coco_eval(perfect, gts, 1)["AP"],
                     "voc_map": voc_map(perfect, gts, 1)[0]}
        print(json.dumps({"fit_eval_parity": {
            "card": card, "detections_per_image": n_dets,
            "detections_per_image_plain": [len(d) for d in cb.last_dets],
            "class_bias": cb.class_bias, "confidence": cb.predict_cfg.confidence,
            "decoded": dec_diff, "match": match,
            "stats_kernels": {k: stats_k[k] for k in stat_keys},
            "stats_plain": {k: stats_p[k] for k in stat_keys}, "stat_abs_diff": stat_diff,
            "ap_of_ground_truths": ap_of_gts,
            "limits": {"box_px": BOX_LIMIT_PX, "score": SCORE_LIMIT, "stats": 0.01}}}),
            flush=True)
        check(dec_diff["decoded_box_max_abs_px"] <= BOX_LIMIT_PX
              and dec_diff["decoded_score_max_abs"] <= SCORE_LIMIT,
              f"fit: EvalCallback's decoded differs from plain by {dec_diff}")
        for key, m in match.items():
            check(m["compared"] > 0 and m["unmatched"] == 0, f"fit: detection sets differ: {m}")
        check(max(stat_diff.values()) <= 0.01, f"fit: COCO/VOC stats differ from plain: "
                                               f"{stat_diff}")
        check(abs(ap_of_gts["coco_AP"] - 1) < 1e-9 and abs(ap_of_gts["voc_map"] - 1) < 1e-9,
              f"fit: the evaluators do not give AP 1 on the ground truths: {ap_of_gts}")

        # checkpoints: the files, their bytes, the last state read back bit for bit
        names = sorted(os.listdir(ckpt.save_dir))
        check({"ep002_weights", "best_weights", "last_weights", "last_state"} <= set(names),
              f"fit: checkpoint files {names}")
        sizes = {n: os.path.getsize(os.path.join(ckpt.save_dir, n)) for n in names}
        t0 = time.perf_counter()
        last = ckpt.load_tree("last_state")
        load_s = time.perf_counter() - t0
        same = all(torch.equal(last[g][k], trainer.variables[g][k])
                   for g in ("params", "batch_stats") for k in trainer.variables[g])
        same &= all(torch.equal(last["ema_" + g][k], trainer.ema_variables[g][k])
                    for g in ("params", "batch_stats") for k in trainer.ema_variables[g])
        check(same and last["step"] == sum(steps) and last["ema_updates"] == 2 * steps[1],
              f"fit: last_state does not read back the trained state (step {last['step']}, "
              f"ema_updates {last['ema_updates']})")
        del last
        ckpt_info = {"card": card, "bytes": sizes, "save_s_per_epoch": ckpt.save_s,
                     "last_state_load_s": load_s,
                     "last_state_gb_per_s_read": sizes["last_state"] / load_s / 1e9}
        print(json.dumps({"fit_checkpoints": ckpt_info}), flush=True)

        # resume from epoch 1's state: the unfrozen epoch again
        resumed = T.Trainer(cfg, dataclasses.replace(tc, init_epoch=1), device=DEVICE,
                            verbose=True)
        t0 = time.perf_counter()
        rhist = resumed.fit(train_lines, val_lines,
                            checkpointer=CheckpointManager(os.path.join(root, "resumed")),
                            resume_from=os.path.join(ckpt.save_dir, "ep001_state"))
        resume_s = time.perf_counter() - t0
        a, b = history[1], rhist[0]
        resume = {"uninterrupted": {k: a[k] for k in ("loss", "val_loss", "lr")},
                  "resumed": {k: b[k] for k in ("loss", "val_loss", "lr")},
                  "equal_bits": a["loss"] == b["loss"] and a["val_loss"] == b["val_loss"],
                  "loss_rel": abs(a["loss"] - b["loss"]) / abs(a["loss"]),
                  "val_loss_rel": abs(a["val_loss"] - b["val_loss"]) / abs(a["val_loss"]),
                  "limit": TRAIN_LOSS_LIMIT, "resume_fit_s": resume_s}
        print(json.dumps({"fit_resume": resume}), flush=True)
        check(len(rhist) == 1 and b["lr"] == a["lr"] and resume["loss_rel"] <= TRAIN_LOSS_LIMIT
              and resume["val_loss_rel"] <= TRAIN_LOSS_LIMIT, f"fit: resume differs: {resume}")
        del resumed

        # the bare make_train_step at each batch, on a batch of the fit's
        # loader: alone, profiled (its device time), and with the loader's
        # threads assembling batches beside it (the host they share)
        import threading

        bare = {}
        model = trainer.model
        for bs, frozen in zip(FIT_BATCHES, (True, False)):
            opt = build_optimizer(tc, model, freeze_backbone=frozen)
            state = T.create_train_state(model, opt)
            step = T.make_train_step(model, opt, trainer.loss_cfg, tc, freeze_backbone=frozen)
            loader = trainer._make_loader(train_lines, bs, train=True)
            loader.set_epoch(0)
            batch = next(L.device_prefetch(iter(loader), device=DEVICE))

            def timed(n=4):
                nonlocal state
                times = []
                for _ in range(n):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    state, comps = step(state, batch, 1e-3)
                    float(comps["loss"])  # synchronises
                    times.append(time.perf_counter() - t0)
                return sorted(times[1:])[1] * 1e3  # median of 3 after a warm-up

            ms = timed()
            stop = threading.Event()

            def assemble():  # the loader alone, as many epochs as the steps take
                while not stop.is_set():
                    for _ in loader:
                        if stop.is_set():
                            break

            side = threading.Thread(target=assemble, daemon=True)
            side.start()
            time.sleep(0.5)
            try:
                ms_loaded = timed()
            finally:
                stop.set()
                side.join(timeout=60)
            check(not side.is_alive(), "fit: the loader thread did not stop")
            prof = profile_call(lambda: step(state, batch, 1e-3), bs)
            bare[bs] = {"step_ms": ms, "imgs_per_s": bs / ms * 1e3, "frozen": frozen,
                        "step_ms_beside_loader": ms_loaded,
                        "device_busy_ms": prof["device_busy_ms"],
                        "idle_share": prof["idle_share"]}
            del state, step, opt, batch
        for e in epochs:
            b = bare[e["batch"]]
            e["bare_step_imgs_per_s"] = b["imgs_per_s"]
            e["fit_over_bare"] = e["imgs_per_s"] / e["bare_step_imgs_per_s"]
            # the fit's steps do the bare step's device work: the device's
            # idle share of the training span, estimated from it
            e["device_idle_share_est"] = 1 - e["steps"] * b["device_busy_ms"] / 1e3 / (
                e["train_span_s"])
        del trainer, model
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    perf = {"card": card, "model": "phi=s 640x640 bf16 Trainer.fit (SGD nesterov, EMA)",
            "train_images": FIT_TRAIN_IMAGES, "val_images": FIT_VAL_IMAGES,
            "photo_sizes": FIT_PHOTO_SIZES, "loader_threads": FIT_WORKERS,
            "write_set_s": write_s, "fit_s": fit_s, "epochs": epochs, "bare_step": bare,
            "history": history, "phase_s": time.perf_counter() - t_phase}
    print(json.dumps({"fit_perf": perf}), flush=True)
    # the readings of the pipeline, each on its own line beside the card
    for e in epochs:
        print(json.dumps({"fit_epoch_imgs_per_s": e["imgs_per_s"], "epoch": e["epoch"],
                          "batch": e["batch"], "bare_step_imgs_per_s": e["bare_step_imgs_per_s"],
                          "card": card}), flush=True)
        print(json.dumps({"fit_loader_wait_ms_per_batch": e["loader_wait_ms_mean"],
                          "median": e["loader_wait_ms_median"], "max": e["loader_wait_ms_max"],
                          "epoch": e["epoch"], "card": card}), flush=True)
    print(json.dumps({"fit_checkpoint_file_bytes": sum(v for k, v in ckpt_info["bytes"].items()
                                                       if k != "ep001_state"),
                      "save_s": sum(ckpt_info["save_s_per_epoch"]), "card": card}), flush=True)
    print(json.dumps({"fit_phase_s": perf["phase_s"], "card": card}), flush=True)
    return {"launches": launches, "perf": perf}


# ---------------------------------------------------------------------------
# the user surface: FOCUS, its export, fuse, summary and train, the drivers
# ---------------------------------------------------------------------------


PHI_S_PARAMS = 259_642_024  # JAX's `count_params` of phi='s' (jax.eval_shape of its init)
API_IMAGE_SIZES = ((480, 640), (720, 1280), (480, 640))  # (h, w) of the written JPEGs
API_TRAIN_IMAGES, API_VAL_IMAGES, API_TRAIN_BATCH, API_WORKERS = 16, 8, 8, 4

# run in a fresh interpreter: each exported program loaded from its .pt2 file
# and run on the card on the saved input, its launch counts reset just before
# and read just after, its output saved beside it
_EXPORT_CHECK = r"""
import json, sys
import torch
import chip_smoke as S
from transparent_object_detection_tpu_torch.api import load_exported
x = torch.load(sys.argv[1]).cuda()
out = {}
for tag, path in json.loads(sys.argv[2]).items():
    program = load_exported(path)
    ops = [str(n.target) for n in program.graph.nodes if str(n.target).startswith("focus.")]
    S.reset_counts()
    with torch.no_grad():
        dec = program(x)
    torch.cuda.synchronize()
    out[tag] = {"launches": S.read_counts(), "ops": {o: ops.count(o) for o in sorted(set(ops))}}
    torch.save(dec.cpu(), path + ".decoded")
print(json.dumps(out))
"""


def _rows_as_dets(rows_per_image) -> dict:
    """FOCUS's per-image detection lists as the padded struct of
    `batched_nms` (for `match_detections`)."""
    import torch

    m = max([len(r) for r in rows_per_image] + [1])
    b = len(rows_per_image)
    dets = {"boxes": torch.zeros(b, m, 4), "scores": torch.zeros(b, m),
            "classes": torch.zeros(b, m, dtype=torch.int64),
            "valid": torch.zeros(b, m, dtype=torch.bool)}
    for i, rows in enumerate(rows_per_image):
        for j, r in enumerate(rows):
            dets["boxes"][i, j] = torch.tensor(r["box"])
            dets["scores"][i, j], dets["classes"][i, j] = r["score"], r["class"]
            dets["valid"][i, j] = True
    dets["num_detections"] = dets["valid"].sum(-1)
    return dets


def op_dispatch_us(calls: int = 2000) -> dict:
    """Host microseconds a call of quant_rows on a small bf16 (128, 256)
    tensor (a launch the host's enqueue bounds): its launcher called
    directly and through its registered operator (torch.ops.focus), in
    turns (launcher, operator, operator, launcher), `calls` calls each
    ending in a synchronise; and their difference, what the operator layer
    adds to a launch."""
    import torch

    from transparent_object_detection_tpu_torch.ops import quant_matmul as QM

    x = torch.randn(128, 256, device=DEVICE, dtype=torch.bfloat16)
    ways = {"launcher": lambda: QM.quant_rows(x, True, 1e-6, 127),
            "operator": lambda: torch.ops.focus.quant_rows(x, True, 1e-6, 127)}
    for fn in ways.values():
        fn()
    us = {k: [] for k in ways}
    for way in ("launcher", "operator", "operator", "launcher"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            ways[way]()
        torch.cuda.synchronize()
        us[way].append((time.perf_counter() - t0) / calls * 1e6)
    out = {k: sum(v) / len(v) for k, v in us.items()}
    out["turns"] = us
    out["operator_adds_us"] = out["operator"] - out["launcher"]
    return out


def _api_images(root: str):
    """API_IMAGE_SIZES JPEGs of smooth backgrounds and filled rectangles
    from seed SEED; returns their paths."""
    import os

    import cv2
    import numpy as np

    rng = np.random.default_rng(SEED + 1)
    paths = []
    for i, (h, w) in enumerate(API_IMAGE_SIZES):
        img = cv2.resize(rng.integers(40, 220, (6, 8, 3)).astype(np.uint8), (w, h),
                         interpolation=cv2.INTER_CUBIC)
        for _ in range(3):
            bw, bh = int(rng.integers(w // 10, w // 3)), int(rng.integers(h // 10, h // 3))
            x1, y1 = int(rng.integers(0, w - bw)), int(rng.integers(0, h - bh))
            img[y1:y1 + bh, x1:x1 + bw] = rng.integers(0, 256, 3).astype(np.uint8)
        paths.append(os.path.join(root, f"api{i}.jpg"))
        check(cv2.imwrite(paths[-1], img), f"could not write {paths[-1]}")
    return paths


def _api_focus(classes: str, tag: str, images_of):
    """FOCUS at phi='s' 640x640 on CUDA (tag "bf16" or "int8"), its seeded
    init_weights from seed SEED; for random weights to reach the
    detections: dark3's gamma 0.5, BatchNorm statistics drawn from seed SEED
    (mean N(0, 0.2), var U(0.5, 1.5), so that a fold's mean term matters),
    and class biases so that about CANDIDATES_PER_IMAGE (int8:
    INT8_CANDIDATES_PER_IMAGE) anchors an image pass 0.5."""
    import torch

    from transparent_object_detection_tpu_torch.api import FOCUS
    from transparent_object_detection_tpu_torch.config import PredictConfig
    from transparent_object_detection_tpu_torch.models.blocks import BatchNorm

    f = FOCUS(phi="s", classes_path=classes, int8=tag == "int8", predict_cfg=PredictConfig(),
              seed=SEED, verbose=False, device=DEVICE)
    gen = torch.Generator().manual_seed(SEED)
    with torch.no_grad():
        f.model.backbone.dark3_attn.gamma.fill_(0.5)
        for m in f.model.modules():
            if isinstance(m, BatchNorm):
                c = m.running_mean.numel()
                m.running_mean.copy_(torch.randn(c, generator=gen) * 0.2)
                m.running_var.copy_(torch.rand(c, generator=gen) + 0.5)
    images = images_of(f)
    _set_class_biases(f.model, images, INT8_CANDIDATES_PER_IMAGE if tag == "int8"
                      else CANDIDATES_PER_IMAGE)
    return f, images


def loader_turns(train_lines) -> dict:
    """The training loader as Trainer builds it (`Trainer._make_loader`) over
    the fit set's training lines at the fit's settings (640x640, mosaic and
    mixup, FIT_WORKERS workers, batch FIT_BATCHES[1]), epoch 0, in turns
    threads, processes, processes, threads (`Trainer(loader_processes=...)`:
    a process pool forked from the fork server). Each turn: the host seconds
    of the epoch and of its first batch; every turn's batches equal to the
    first's, bit for bit. The loader alone: no step shares the interpreter
    with it."""
    import types

    import numpy as np

    from transparent_object_detection_tpu_torch.config import ModelConfig, TrainConfig
    from transparent_object_detection_tpu_torch.train.trainer import Trainer

    tc = TrainConfig(seed=SEED, freeze_epoch=1, unfreeze_epoch=2, mosaic=True, mixup=True,
                     num_workers=FIT_WORKERS)
    turns, first = {"threads": [], "processes": []}, None
    for way in ("threads", "processes", "processes", "threads"):
        host = types.SimpleNamespace(train_cfg=tc, model_cfg=ModelConfig(phi="s"),
                                     loader_processes=way == "processes")
        loader = Trainer._make_loader(host, train_lines, FIT_BATCHES[1], True)
        loader.set_epoch(0)
        t0 = time.perf_counter()
        batches, first_s = [], None
        for batch in loader:
            first_s = first_s or time.perf_counter() - t0
            batches.append(batch)
        epoch_s = time.perf_counter() - t0
        if first is None:
            first = batches
        check(len(batches) == len(first) and all(
            a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)
            for a, b in zip(batches, first)), f"loader {way}: batches differ from threads'")
        turns[way].append({"epoch_s": epoch_s, "first_batch_s": first_s,
                           "imgs_per_s": len(batches) * FIT_BATCHES[1] / epoch_s})
    return {"workers": FIT_WORKERS, "batch": FIT_BATCHES[1], "batches": len(first),
            "turns": turns}


def api_phase(card: str) -> dict:
    """The port's user surface at phi='s' 640x640, bf16 and int8: FOCUS
    (`transparent_object_detection_tpu_torch.api`) built on CUDA, its calls
    with the launch counts reset just before and read just after each, held
    against the route table (`expected_launches`, batch 1 a forward; the
    int8 model through every kernel of its route). detect_image and
    predict_dir on three synthetic JPEGs (480x640, 720x1280): `decoded` and
    the detection sets against the same FOCUS on the plain versions
    (`set_attention_impl`) within the slice limits; predict_video on an MJPG
    .avi written with cv2; detect_heatmap; get_fps at batch 1 and 32 (the
    calls enqueued back to back, one host read at the end); fuse (bf16:
    `decoded` against the unfused model within the bf16 limits, and a fold
    without its mean term rejected by them); save_weights then load_weights
    bit for bit; export of both models, each .pt2 loaded and run in a fresh
    interpreter: its `decoded` equal to the eager model's bits, its launches
    equal to the route table's (a program traced on the plain versions
    launches nothing) and its graph holding the focus:: operators; summary:
    params equal to JAX's count, flops equal on CUDA and on the CPU plain
    path; FOCUS.train for one epoch with evaluation on a subset of the fit
    phase's synthetic JPEGs on API_WORKERS loader threads; the training
    loader over the fit set in threads and in processes (`loader_turns`);
    and the predict and summary drivers as subprocesses (rc 0)."""
    import copy
    import os
    import tempfile

    import numpy as np
    import torch
    from PIL import Image

    from transparent_object_detection_tpu_torch.api import _Decoded
    from transparent_object_detection_tpu_torch.config import ModelConfig
    from transparent_object_detection_tpu_torch.models.blocks import fuse_conv_bn
    from transparent_object_detection_tpu_torch.models.detector import (
        build_model,
        count_params,
        set_attention_impl,
    )
    from transparent_object_detection_tpu_torch.utils.profiling import cost_analysis

    # first, before the phase's other processes start: the host's cost
    out = {"card": card, "op_dispatch_us": op_dispatch_us()}
    print(json.dumps({"api_op_dispatch_us": out["op_dispatch_us"]}), flush=True)
    seconds = {}
    tmp = tempfile.TemporaryDirectory(prefix="api_phase_")
    root = tmp.name
    classes = os.path.join(root, "classes.txt")
    with open(classes, "w") as fh:
        fh.write("glass\n")
    img_dir = os.path.join(root, "images")
    os.makedirs(img_dir)
    paths = _api_images(img_dir)
    pil = [Image.open(p) for p in paths]
    # the drivers beside the phase: predict (one image, the seeded weights)
    # and summary, each in its own interpreter on the card
    mod = "transparent_object_detection_tpu_torch.tools"
    drivers = {
        "predict": subprocess.Popen(
            [sys.executable, "-m", f"{mod}.predict", "predict", "--source", paths[0],
             "--output", os.path.join(root, "cli.png"), "--classes", classes, "--seed", "0"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
        "summary": subprocess.Popen([sys.executable, "-m", f"{mod}.summary", "--phi", "s"],
                                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)}
    loader = None  # the fresh interpreter of the export check
    try:
        models = {}
        for tag in ("bf16", "int8"):
            t0 = time.perf_counter()
            limits = SCALE_LIMITS[tag]
            f, images = _api_focus(
                classes, tag, lambda f: torch.from_numpy(np.stack(
                    [f._letterboxed(im)[1] for im in pil])).to(DEVICE))
            pcfg = f.predict_cfg
            rec = {}
            launched = {}  # each counted call's launches, read in this run

            def counted(fn, forwards, what, batch=1):
                reset_counts()
                result = fn()
                torch.cuda.synchronize()
                got = launched[what] = read_counts()
                want = {k: v * forwards for k, v in expected_launches("s", batch, tag).items()}
                check(got == want, f"api {tag} {what}: launches {got}, expected {want}")
                return result

            # detect_image, each image one counted forward; then the plain route
            rows = [counted(lambda: f.detect_image(im), 1, f"detect_image {i}")
                    for i, im in enumerate(pil)]
            set_attention_impl(f.model, "plain")
            try:
                rows_p = [f.detect_image(im) for im in pil]
                with torch.inference_mode():
                    dec_p = f.model(images)["decoded"]
                    heat_p = f.detect_heatmap(pil[0])
            finally:
                set_attention_impl(f.model, None)
            with torch.inference_mode():
                dec_k = f.model(images)["decoded"]
            box_d = float((dec_k[..., :4] - dec_p[..., :4]).abs().max())
            score_d = float((dec_k[..., 4:] - dec_p[..., 4:]).abs().max())
            check(box_d <= limits[0] and score_d <= limits[1],
                  f"api {tag}: decoded {box_d} px, {score_d} from plain (limits {limits[:2]})")
            dets, dets_p = _rows_as_dets(rows), _rows_as_dets(rows_p)
            m_k = match_detections(dets, dets_p, pcfg, score_d, limits[0])
            m_p = match_detections(dets_p, dets, pcfg, score_d, limits[0])
            for m in (m_k, m_p):
                check(m["compared"] > 0 and m["unmatched"] == 0,
                      f"api {tag}: detection sets differ from plain: {m}")
            check(all(0 < len(r) < pcfg.max_detections for r in rows),
                  f"api {tag}: detections an image {[len(r) for r in rows]}")
            rec["detect_image"] = {"detections": [len(r) for r in rows],
                                   "launches": {k: sum(launched[f"detect_image {i}"][k]
                                                       for i in range(len(pil)))
                                                for k in launched["detect_image 0"]},
                                   "decoded_box_max_abs_px": box_d,
                                   "decoded_score_max_abs": score_d,
                                   "matched_in_plain": {k: m_k[k] for k in
                                                        ("compared", "identical", "unmatched")},
                                   "plain_matched_here": {k: m_p[k] for k in
                                                          ("compared", "identical",
                                                           "unmatched")}}
            # predict_dir: the same rows as detect_image, one forward an image
            res = counted(lambda: f.predict_dir(img_dir, os.path.join(root, f"out_{tag}")),
                          len(pil), "predict_dir")
            check([res[p] for p in paths] == rows, f"api {tag}: predict_dir != detect_image")
            # predict_video on an MJPG .avi of 4 frames
            import cv2

            avi = os.path.join(root, "clip.avi")
            writer = cv2.VideoWriter(avi, cv2.VideoWriter_fourcc(*"MJPG"), 10.0, (640, 480))
            frame = cv2.imread(paths[0])
            for k in range(4):
                writer.write(np.roll(frame, 16 * k, axis=1))
            writer.release()
            video_out = os.path.join(root, f"clip_{tag}.mp4")
            fps = counted(lambda: f.predict(avi, output_path=video_out), 4, "predict_video")
            check(fps > 0 and os.path.getsize(video_out) > 0, f"api {tag}: predict_video")
            heat = counted(lambda: f.detect_heatmap(pil[0], os.path.join(root, "heat.png")), 1,
                           "detect_heatmap")
            heat_d = float(np.abs(heat - heat_p).max())
            check(heat.shape == (80, 80) and np.isfinite(heat).all() and heat_d <= limits[1],
                  f"api {tag}: heatmap {heat.shape}, {heat_d} from plain")
            rec["video_fps"], rec["heatmap_max_abs_vs_plain"] = fps, heat_d
            # get_fps: 1 warm-up call and test_interval timed calls
            rec["get_fps"] = {}
            for b, calls in ((1, 20), (32, 5)):
                sec = counted(lambda: f.get_fps(pil[0], calls, b), calls + 1,
                              f"get_fps batch {b}", b)
                rec["get_fps"][b] = {"s_per_call": sec, "imgs_per_s": b / sec}
            # save_weights -> load_weights: bit for bit
            ts = time.perf_counter()
            before = {k: v.clone() for k, v in f.model.state_dict().items()}
            wpath = f.save_weights(os.path.join(root, f"w_{tag}"))
            with torch.no_grad():
                for v in f.model.state_dict().values():
                    v.zero_()
            f.load_weights(wpath)
            check(all(torch.equal(v, before[k]) for k, v in f.model.state_dict().items()),
                  f"api {tag}: load_weights did not give back the saved bits")
            rec["weights"] = {"bytes": os.path.getsize(wpath),
                              "save_load_s": time.perf_counter() - ts}
            os.remove(wpath)
            # fuse (bf16): decoded within the bf16 limits of the unfused, and a
            # fold without its mean term outside them
            if tag == "bf16":
                g = copy.copy(f)
                g.model = copy.deepcopy(f.model)
                g.fuse()
                fused = g.model.state_dict()
                with torch.inference_mode():
                    dec_f = g.model(images)["decoded"]
                    bad = dict(fused)
                    for k in fused:
                        if k.endswith(".bn.running_mean") and k[:-15] + "conv.weight" in fused:
                            bad[k[:-12] + "bias"] = before[k[:-12] + "bias"]
                    g.model.load_state_dict(bad)
                    dec_bad = g.model(images)["decoded"]
                reading = lambda d: (float((d[..., :4] - dec_k[..., :4]).abs().max()),
                                     float((d[..., 4:] - dec_k[..., 4:]).abs().max()))
                sound, fault = reading(dec_f), reading(dec_bad)
                check(sound[0] <= limits[0] and sound[1] <= limits[1],
                      f"api fuse: decoded {sound} from the unfused model (limits {limits[:2]})")
                check(fault[0] > limits[0] or fault[1] > limits[1],
                      f"api fuse: the limits do not reject a fold without its mean term {fault}")
                rec["fuse"] = {"sound": sound, "mean_term_dropped": fault}
                del g
            # summary on CUDA (counted from shapes: no launch)
            rec["summary"] = counted(f.summary, 0, "summary")
            check(rec["summary"]["params"] == PHI_S_PARAMS,
                  f"api {tag}: summary params {rec['summary']['params']} != {PHI_S_PARAMS}")
            seconds[tag] = time.perf_counter() - t0
            out[tag] = rec
            models[tag] = f
            print(json.dumps({"api": tag, **rec}), flush=True)

        # the CPU plain path's count for the same configurations: one model
        # on the CPU on the plain versions (FlopCounterMode counts their aten
        # products, not the focus:: formulas), its int8 flags switched for
        # the int8 count
        t0 = time.perf_counter()
        cpu_model = set_attention_impl(build_model(ModelConfig(phi="s"), device="cpu",
                                                   seed=None), "plain")
        for tag in ("bf16", "int8"):
            for m in cpu_model.modules():
                for flag in ("int8_dense", "int8_attn"):
                    if hasattr(m, flag):
                        setattr(m, flag, tag == "int8")
            cpu = cost_analysis(_Decoded(cpu_model), torch.zeros((1, 640, 640, 3)))
            check(count_params(cpu_model) == PHI_S_PARAMS and
                  cpu["flops"] == out[tag]["summary"]["flops"],
                  f"api {tag}: summary on CUDA {out[tag]['summary']} != CPU {cpu}")
            out[tag]["summary_cpu_flops"] = cpu["flops"]
        del cpu_model
        seconds["summary_cpu"] = time.perf_counter() - t0

        # export both models; each program loaded and run in a fresh interpreter
        t0 = time.perf_counter()
        x = torch.from_numpy(np.random.default_rng(SEED).random((1, 640, 640, 3),
                                                                dtype=np.float32))
        xpath = os.path.join(root, "x.pt")
        torch.save(x, xpath)
        programs, eager = {}, {}
        for tag, f in models.items():
            with torch.no_grad():
                eager[tag] = f.model(x.to(DEVICE))["decoded"].cpu()
            te = time.perf_counter()
            programs[tag] = f.export(os.path.join(root, f"focus_{tag}.pt2"))
            out[tag]["export"] = {"export_s": time.perf_counter() - te,
                                  "bytes": os.path.getsize(programs[tag])}
        # the fresh interpreter loads and runs the programs beside the train below
        loader = subprocess.Popen([sys.executable, "-c", _EXPORT_CHECK, xpath,
                                   json.dumps(programs)], stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True,
                                  cwd=os.path.dirname(os.path.abspath(__file__)))
        seconds["export"] = time.perf_counter() - t0

        # FOCUS.train: one epoch with evaluation, API_WORKERS loader threads
        t0 = time.perf_counter()
        f = models["bf16"]
        del models["int8"]
        torch.cuda.empty_cache()
        train_lines, val_lines = write_fit_set(root)
        resets, read_train = train_launch_counts()
        for reset in resets:
            reset()
        hist = f.train(train_lines=train_lines[:API_TRAIN_IMAGES],
                       val_lines=val_lines[:API_VAL_IMAGES], epochs=1,
                       batch_size=API_TRAIN_BATCH, save_dir=os.path.join(root, "logs"),
                       eval_period=1, num_workers=API_WORKERS)
        torch.cuda.synchronize()
        counts = read_train()
        check(len(hist) == 1 and np.isfinite(hist[0]["loss"]) and "map50" in hist[0],
              f"api train: history {hist}")
        check(all(counts[k] > 0 for k in ("flash_fwd_lse_sm90", "flash_bwd_dq_sm90",
                                          "flash_bwd_dkv_sm90", "flash_mha_packed_sm90")),
              f"api train: launches {counts}")
        check(os.path.exists(os.path.join(root, "logs", "last_weights")), "api train: no weights")
        out["train"] = {"history": hist, "launches": {k: v for k, v in counts.items() if v},
                        "workers": API_WORKERS, "loader": "threads"}
        seconds["train"] = time.perf_counter() - t0
        print(json.dumps({"api_train": out["train"]}), flush=True)
        # the training loader on the fit set: threads against processes
        t0 = time.perf_counter()
        out["loader"] = loader_turns(train_lines)
        seconds["loader"] = time.perf_counter() - t0
        print(json.dumps({"api_loader": out["loader"]}), flush=True)

        t0 = time.perf_counter()
        stdout, stderr = loader.communicate(timeout=600)
        check(loader.returncode == 0, f"api export: the fresh interpreter failed: "
                                      f"{stderr[-3000:]}")
        loaded = json.loads(stdout.strip().splitlines()[-1])
        for tag, path in programs.items():
            want = expected_launches("s", 1, tag)
            got = loaded[tag]["launches"]
            check(got == want and sum(got.values()) > 0,
                  f"api export {tag}: the loaded program launched {got}, expected {want}")
            same = torch.equal(torch.load(path + ".decoded"), eager[tag])
            check(same, f"api export {tag}: the loaded program's decoded differs from eager")
            out[tag]["export"].update(loaded[tag], decoded_bits_equal=same)
        seconds["export_check_wait"] = time.perf_counter() - t0
        print(json.dumps({"api_export": {t: out[t]["export"] for t in programs}}), flush=True)
    finally:
        if loader is not None and loader.poll() is None:
            loader.kill()
            loader.communicate()
        for name, proc in drivers.items():
            try:
                stdout, stderr = proc.communicate(timeout=300)
            except subprocess.TimeoutExpired:
                proc.kill()
                stdout, stderr = proc.communicate()
            out.setdefault("drivers", {})[name] = {"rc": proc.returncode,
                                                   "tail": stdout.strip().splitlines()[-3:]}
            if proc.returncode:
                print(stderr[-2000:], file=sys.stderr)
        tmp.cleanup()
    for name, d in out["drivers"].items():
        check(d["rc"] == 0, f"api driver {name}: rc {d['rc']}")
    out["seconds"] = seconds
    print(json.dumps({"api_drivers": out["drivers"], "api_seconds": seconds}), flush=True)
    return out


# ---------------------------------------------------------------------------
# parallel execution (parallel/, ops/teb_tp.py): ranks sharing the one card
# on gloo, a world of one rank on NCCL
# ---------------------------------------------------------------------------

# name -> (tp, ranks of the world of PARALLEL_WORLD): dp1xtp4 and dp2xtp2 on
# all four ranks, dp1xtp2 on ranks 0 and 1 (2 and 3 make its groups too)
PARALLEL_MESHES = {"dp2xtp2": (2, (0, 1, 2, 3)), "dp1xtp4": (4, (0, 1, 2, 3)),
                   "dp1xtp2": (2, (0, 1))}
PARALLEL_WORLD = 4
PARALLEL_CFG = dict(phi="s")  # at the default 640x640
PARALLEL_BATCH = 4           # the global batch of serving and training
PARALLEL_TRAIN_STEPS = 3
# compute type -> (ranks, steps) of the data-parallel training: bf16 beside
# dp1xtp2's serving on ranks 0 and 1, fp32 on ranks 0 and 1 after it
PARALLEL_TRAIN = {"bfloat16": ((2, 3), PARALLEL_TRAIN_STEPS), "float32": ((0, 1), 1)}
# int8 TP against the single-device int8 Predictor: JAX's own bar,
# 2e-2 * max|decoded| (tests/test_tp.py:169-190): the row-parallel
# projections quantize each rank's K/tp columns
PARALLEL_INT8_REL = 2e-2
PARALLEL_RANK_TIMEOUT = 900.0


def _parallel_model(images):
    """phi='s' 640x640 bf16 at full width on the card, with the api phase's
    weights: seeded init_weights, dark3's gamma 0.5, BatchNorm statistics
    drawn from seed SEED, class biases for about CANDIDATES_PER_IMAGE
    anchors an image."""
    import torch

    from transparent_object_detection_tpu_torch.config import ModelConfig
    from transparent_object_detection_tpu_torch.models.blocks import BatchNorm
    from transparent_object_detection_tpu_torch.models.detector import build_model

    model = build_model(ModelConfig(**PARALLEL_CFG), device=DEVICE, seed=SEED)
    gen = torch.Generator().manual_seed(SEED)
    with torch.no_grad():
        model.backbone.dark3_attn.gamma.fill_(0.5)
        for m in model.modules():
            if isinstance(m, BatchNorm):
                c = m.running_mean.numel()
                m.running_mean.copy_(torch.randn(c, generator=gen) * 0.2)
                m.running_var.copy_(torch.rand(c, generator=gen) + 0.5)
    _set_class_biases(model, images, CANDIDATES_PER_IMAGE)
    return model


def _parallel_inputs(cfg):
    """The phase's global batch: PARALLEL_BATCH uint8 480x640 images from
    seed SEED + 7, and a training batch whose two halves (each training
    rank's rows) are drawn from uniform(0, 0.5) and uniform(0.5, 1), so
    each rank's own BatchNorm statistics are far from the global batch's."""
    import numpy as np

    rng = np.random.default_rng(SEED + 7)
    raw = rng.integers(0, 256, size=(PARALLEL_BATCH, 480, 640, 3), dtype=np.uint8)
    shapes = np.tile(np.array([[480, 640]], np.float32), (PARALLEL_BATCH, 1))
    h, w = cfg.input_shape
    half = PARALLEL_BATCH // 2
    image = np.concatenate([rng.uniform(0.0, 0.5, (half, h, w, 3)),
                            rng.uniform(0.5, 1.0, (half, h, w, 3))]).astype(np.float32)
    boxes = np.zeros((PARALLEL_BATCH, 64, 4), np.float32)
    boxes[:, 0] = [0.5, 0.5, 0.4, 0.4]
    boxes[:, 1] = [0.25, 0.3, 0.2, 0.2]
    return raw, shapes, {"image": image, "boxes": boxes,
                         "labels": np.zeros((PARALLEL_BATCH, 64), np.int64)}


def _tp_counter(route: str, dq: int, dv: int, int8: bool) -> str:
    """The launch counter a serving route reaches at these head widths."""
    import torch

    from transparent_object_detection_tpu_torch.ops import attention as A
    from transparent_object_detection_tpu_torch.ops import attention_int8 as A8

    if route == "int8":  # the one int8 kernel
        check(A8.int8_fwd_form(dq, dv) == "sm90", f"int8 heads of {dq}/{dv}: no form")
        return "flash_mha_int8_sm90"
    if route == "packed":
        form = A.packed_fwd_form(dq, torch.bfloat16)
        return "flash_mha_packed" + ("_sm90" if form == "sm90" else "")
    return "flash_single_sm90"  # single and folded: the one-head form


def tp_expected(tp: int, int8: bool) -> dict:
    """Launches of one rank's forward of the phi='s' 640x640 model serving
    at tp on the route table: dark3 as on one device; each neck TEB's
    attention by `teb_tp.local_route` (head-local at heads/tp heads, or
    the all-gathered heads); with int8, four qmm a TEB, each after a
    quant_rows (JAX's TP routes: no handoffs)."""
    from transparent_object_detection_tpu_torch.config import ModelConfig
    from transparent_object_detection_tpu_torch.ops import attention as A
    from transparent_object_detection_tpu_torch.ops import teb_tp

    counts = dict.fromkeys(COUNTED, 0)
    cfg = ModelConfig(**PARALLEL_CFG)
    sites = scale_sites(cfg.phi, cfg.input_shape)
    n, cq, cv, _, _ = sites["dark3"]
    route = A.serving_route(n, cq, 1, cv, int8)[0]
    if route != "naive":
        counts[_tp_counter(route, cq, cv, int8)] += 1
    for name in ("h1", "h2", "h4", "h6"):
        n, c, _, heads, _ = sites[name]
        route = teb_tp.local_route(n, c, heads, tp, int8)[0]
        cl, h = (c // tp, heads // tp) if heads % tp == 0 else (c, heads)
        if route != "naive":
            counts[_tp_counter(route, cl // h, cl // h, int8)] += 1
        if int8:
            counts["qmm"] += 4
            counts["quant_rows"] += 4
    return counts


@contextlib.contextmanager
def skipped_all_reduce(which: int = 0):
    """The planted fault of the TP TEB: the `which`-th all-reduce of a
    row-parallel projection in a forward left out (every rank of the model
    group leaves out the same one, so no rank waits)."""
    from transparent_object_detection_tpu_torch.ops import teb_tp

    real, seen = teb_tp.all_reduce_sum, [0]

    def faulty(t, mesh, axis):
        seen[0] += 1
        return t if seen[0] - 1 == which else real(t, mesh, axis)

    teb_tp.all_reduce_sum = faulty
    try:
        yield
    finally:
        teb_tp.all_reduce_sum = real


def _decoded_reading(dec, ref) -> dict:
    return {"box_px": float((dec[..., :4] - ref[..., :4]).abs().max()),
            "score": float((dec[..., 4:] - ref[..., 4:]).abs().max())}


def _parallel_serve(model, mesh, name: str, tag: str, raw, shapes, images) -> dict:
    """One rank's Predictor on `mesh` (tag "bf16" or "int8"): parameter
    bytes, the counted main path (detect_raw_batch on the global batch,
    counts reset just before and read just after), its global detections
    and `decoded`, and the TP program against the same program on the plain
    versions, sound and with one row-parallel all-reduce left out."""
    import torch

    from transparent_object_detection_tpu_torch.config import ModelConfig, PredictConfig
    from transparent_object_detection_tpu_torch.inference import Predictor
    from transparent_object_detection_tpu_torch.models.detector import set_attention_impl
    from transparent_object_detection_tpu_torch.parallel.tp import per_rank_param_bytes

    t0 = time.perf_counter()
    cfg = ModelConfig(**PARALLEL_CFG)
    tp = mesh.size("model")
    pred = Predictor(model, cfg, PredictConfig(), device=DEVICE, mesh=mesh)
    out = {"bytes": sum(p.numel() * p.element_size() for p in pred.model.parameters()),
           "bytes_want": per_rank_param_bytes(model, tp) if tp > 1 else
           sum(p.numel() * p.element_size() for p in model.parameters()),
           "whole_bytes": sum(p.numel() * 4 for p in model.parameters()),
           "coords": mesh.coords, "setup_s": time.perf_counter() - t0}
    reset_counts()
    dets = pred.detect_raw_batch(raw, shapes)
    torch.cuda.synchronize()
    out["launches"] = read_counts()
    out["expected"] = tp_expected(tp, tag == "int8")
    out["dets"] = dets
    with torch.inference_mode():
        out["decoded"] = dec = pred.model(images)["decoded"]
        set_attention_impl(pred.model, "plain")
        try:
            dec_p = pred.model(images)["decoded"]
            with skipped_all_reduce():
                dec_f = pred.model(images)["decoded"]
        finally:
            set_attention_impl(pred.model, None)
    out["against_plain"] = _decoded_reading(dec, dec_p)
    out["fault_against_plain"] = _decoded_reading(dec_f, dec_p)
    out["s"] = time.perf_counter() - t0
    print(json.dumps({"parallel_serve": name, "tag": tag, "rank": mesh.coords,
                      **{k: out[k] for k in ("bytes", "launches", "against_plain",
                                             "fault_against_plain", "s")}}), flush=True)
    del pred
    return out


def _equal_across(tensors, mesh) -> int:
    """Elements of `tensors` on which this rank differs from the mesh's
    first rank (its values broadcast into copies), summed over the mesh."""
    import torch
    import torch.distributed as dist

    from transparent_object_detection_tpu_torch.parallel.mesh import all_reduce_sum, coalesced

    copies = [t.detach().clone() for t in tensors]
    coalesced(copies, lambda t: dist.broadcast(t, src=mesh.ranks[0], group=mesh.group_all))
    diff = torch.zeros(1, device=DEVICE)
    for a, b in zip(copies, tensors):
        diff += (a != b).sum()
    return int(all_reduce_sum(diff, mesh))


def _parallel_train(mesh, state_dict, batch_np, compute_dtype: str, steps: int) -> dict:
    """`steps` data-parallel steps in `compute_dtype` on the ranks of `mesh`
    (each on its rows of the global batch), from the first rank's weights
    (`replicate_state`). Before each, the first rank runs one process's
    step on the whole global batch from the same state (`steps`: the
    data-parallel step against it), before the first also the same step on
    the batch's rows in another order (`floor`: an exact implementation of
    the same step whose sums round otherwise); after them, the elements in
    which the ranks'
    parameters, EMA, BatchNorm statistics and momenta differ; then one step
    from the first weights with BatchNorm on each rank's own rows (`fault`,
    the planted fault, against the first reference step)."""
    import copy

    import torch

    from transparent_object_detection_tpu_torch.config import ModelConfig, TrainConfig
    from transparent_object_detection_tpu_torch.models import blocks
    from transparent_object_detection_tpu_torch.models.detector import build_model
    from transparent_object_detection_tpu_torch.parallel.mesh import replicate_state, shard_batch
    from transparent_object_detection_tpu_torch.train import trainer as T
    from transparent_object_detection_tpu_torch.train.optimizer import build_optimizer

    t0 = time.perf_counter()
    cfg = ModelConfig(**PARALLEL_CFG, compute_dtype=compute_dtype)
    tcfg = TrainConfig(max_boxes=64, optimizer_type="sgd", ema=True)
    lc = T.loss_config_from(cfg, tcfg)
    first = mesh.index("data") == 0
    batch = {k: torch.as_tensor(v, device=DEVICE) for k, v in batch_np.items()}
    local = shard_batch(batch, mesh)
    perm = torch.tensor([1, 0, 3, 2], device=DEVICE)  # rows swapped within each rank's half
    permuted = {k: v[perm] for k, v in batch.items()}
    record = _step_record  # on the host: two ranks train at once beside the serving ranks

    def fresh():
        model = build_model(cfg, device=DEVICE, seed=None)
        if first:
            model.load_state_dict(state_dict)
        replicate_state(model, mesh)
        model.train()
        opt = build_optimizer(tcfg, model)
        return model, T.create_train_state(model, opt), T.make_train_step(model, opt, lc, tcfg,
                                                                           mesh=mesh)

    out = {"steps": []}
    model, state, step = fresh()
    if first:  # one process on the global batch, from each step's state
        ref_model = copy.deepcopy(model)
        ref_opt = build_optimizer(tcfg, ref_model)
        ref_state = T.create_train_state(ref_model, ref_opt)
        ref_step = T.make_train_step(ref_model, ref_opt, lc, tcfg)
    dp_s = 0.0
    for k in range(steps):
        if first:
            snap = _model_snapshot(model, state)
            _restore(ref_model, ref_state, snap)
            old = record(ref_model, ref_state)
            ref_state, comps = ref_step(ref_state, batch, TRAIN_LR)
            ref = record(ref_model, ref_state, comps)
            if k == 0:
                _restore(ref_model, ref_state, snap)
                ref_state, comps = ref_step(ref_state, permuted, TRAIN_LR)
                out["floor"] = compare_steps(record(ref_model, ref_state, comps), ref, old)
                old0, ref0 = old, ref
            del snap
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, comps = step(state, local, TRAIN_LR)
        torch.cuda.synchronize()
        dp_s += time.perf_counter() - t1
        if first:
            out["steps"].append(compare_steps(record(model, state, comps), ref, old))
            del ref, old
    out["dp_steps_s"] = dp_s
    out["mismatched_elements"] = _equal_across(
        [*state.params.values(), *state.batch_stats.values(), *state.ema_params.values(),
         *state.ema_batch_stats.values(), *state.opt_state["trace"].values()], mesh)
    if first:
        del ref_model, ref_state, ref_step
    del model, state, step
    torch.cuda.empty_cache()
    model, state, step = fresh()  # the planted fault: BatchNorm on this rank's rows only
    T.global_batchnorm = lambda m, mesh_: blocks.global_batchnorm(m, None)
    try:
        state, comps = step(state, local, TRAIN_LR)
    finally:
        T.global_batchnorm = blocks.global_batchnorm
    if first:
        out["fault"] = compare_steps(record(model, state, comps), ref0, old0)
        del ref0, old0
    del model, state, step
    torch.cuda.empty_cache()
    out["s"] = time.perf_counter() - t0
    return out


# tensor-parallel training: (mesh of PARALLEL_MESHES, compute type, steps,
# planted faults, reordering floor) in this order, every rank of the mesh
# taking part; phi='s' at the global batch of PARALLEL_BATCH, with a clip of
# TP_TRAIN_CLIP that bites (the random-weight model's gradient norm is far
# above it). dp1xtp4 (ragged h2/h4) and dp1xtp2 read their steps beside
# dp2xtp2's floors: one process's step does not depend on the mesh
PARALLEL_TP_TRAIN = (("dp2xtp2", "float32", 1, True, True), ("dp2xtp2", "bfloat16", 1, False, True),
                     ("dp1xtp4", "bfloat16", 1, False, False),
                     ("dp1xtp2", "float32", 1, False, False))
TP_TRAIN_CLIP = 1.0
# rows 9-11 at the TP-local shapes of the bf16 TP steps (B, N, q/k, v,
# heads): dp2xtp2's ranks hold 2 rows and half the heads; dp1xtp4's 4 rows
# and a quarter of h1's, every head of the ragged h2 and h4
TP_TRAIN_SHAPES = {2: {"h1 tp=2": (2, 1600, 1024, 1024, 4), "h2 tp=2": (2, 6400, 768, 768, 3),
                       "h4 tp=2": (2, 1600, 768, 768, 3)},
                   4: {"h1 tp=4": (4, 1600, 512, 512, 2),
                       "h2 tp=4 gathered": (4, 6400, 1536, 1536, 6),
                       "h4 tp=4 gathered": (4, 1600, 1536, 1536, 6)}}


def tp_train_expected(tp: int, cfg) -> dict:
    """Launches of rows 9-11 a rank makes in one tensor-parallel training
    step at tp: `train_expected` with each neck TEB on its local heads
    (heads / tp of the same width) where tp divides its head count, on every
    head where it does not (ragged: all-gathered); dark3 as on one device."""
    return train_expected(cfg, tp)


@contextlib.contextmanager
def tp_train_fault(fault: str):
    """The planted faults of tensor-parallel training: the gradient of a
    column-parallel layer's input left unsummed over the model axis
    (copy_to_model's backward all-reduce skipped), or the clip's global norm
    without the model axis's sum of the sharded leaves' squares."""
    from transparent_object_detection_tpu_torch.parallel import mesh as M
    from transparent_object_detection_tpu_torch.train import optimizer as O

    if fault == "copy_to_model_grad_not_reduced":
        real = M._CopyToModel.backward
        M._CopyToModel.backward = staticmethod(lambda ctx, grad: (grad, None))
        try:
            yield
        finally:
            M._CopyToModel.backward = real
    else:
        real = O.all_reduce_sum
        O.all_reduce_sum = lambda t, mesh, axis=None: t
        try:
            yield
        finally:
            O.all_reduce_sum = real


TP_TRAIN_FAULTS = ("copy_to_model_grad_not_reduced", "clip_without_model_axis_sum")


def _model_group_mismatches(state, mesh) -> dict:
    """{kind: leaves in which this rank differs from another rank of its
    model group} over the replicated leaves (parameters, gradients,
    momenta, EMA, BatchNorm statistics and their EMA), summed over the
    group: each leaf's bits compared through two checksums of its 32-bit
    words, gathered over the model axis."""
    import torch

    from transparent_object_detection_tpu_torch.parallel.mesh import (
        MODEL_AXIS,
        all_gather_list,
        all_reduce_sum,
    )

    params = dict(state.model.named_parameters())
    rep = [n for n, spec in state.model.tp_specs.items() if MODEL_AXIS not in spec]
    kinds = {"params": [params[n] for n in rep], "grads": [params[n].grad for n in rep],
             "momenta": [state.opt_state["trace"][n] for n in rep],
             "ema": [state.ema_params[n] for n in rep],
             "batch_stats": list(state.model.buffers()),
             "ema_batch_stats": list(state.ema_batch_stats.values())}

    def sums(t):
        bits = t.detach().float().contiguous().view(torch.int32).reshape(-1).long()
        weights = torch.arange(bits.numel(), device=bits.device) % 65521 + 1
        return torch.stack([bits.sum(), (bits * weights).sum()])
    names = list(kinds)
    mine = torch.stack([sums(t) for k in names for t in kinds[k]])
    owner = torch.tensor([i for i, k in enumerate(names) for _ in kinds[k]], device=mine.device)
    bad = torch.zeros(len(names), dtype=torch.long, device=mine.device)
    for other in all_gather_list(mine, mesh, MODEL_AXIS):
        differs = (other != mine).any(dim=1)
        bad.index_add_(0, owner, differs.long())
    bad = all_reduce_sum(bad, mesh, MODEL_AXIS)
    return dict(zip(names, (int(b) for b in bad.tolist())))


def _parallel_tp_train(mesh, state_dict, batch_np, compute_dtype: str, steps: int,
                       faults: bool, floor: bool) -> dict:
    """`steps` tensor-parallel steps in `compute_dtype` on the ranks of
    `mesh` (parallel.tp.shard_train_state_tp after replicate_state; each
    data index on its rows of the global batch). Before each, the mesh's
    first rank runs one process's step on the whole global batch from the
    same state (after the first, the whole state gathered back,
    `gather_train_state_tp`), with `floor` before the first also on the
    batch's rows in another order; each TP step's gathered state against it
    (`compare_steps`). The first step's launches of rows 9-11 on this rank;
    the replicated leaves differing across the model group; this rank's
    peak memory. With `faults`, one step from the first weights under each
    of TP_TRAIN_FAULTS against the first reference step, with the leaves
    differing."""
    import copy

    import torch

    from transparent_object_detection_tpu_torch.config import ModelConfig, TrainConfig
    from transparent_object_detection_tpu_torch.models.detector import build_model
    from transparent_object_detection_tpu_torch.parallel.mesh import replicate_state, shard_batch
    from transparent_object_detection_tpu_torch.parallel.tp import (
        gather_train_state_tp,
        shard_train_state_tp,
    )
    from transparent_object_detection_tpu_torch.train import trainer as T
    from transparent_object_detection_tpu_torch.train.optimizer import build_optimizer

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = ModelConfig(**PARALLEL_CFG, compute_dtype=compute_dtype)
    tcfg = TrainConfig(max_boxes=64, optimizer_type="sgd", ema=True, grad_clip_norm=TP_TRAIN_CLIP)
    lc = T.loss_config_from(cfg, tcfg)
    first = mesh.ranks[0] == torch.distributed.get_rank()
    batch = {k: torch.as_tensor(v, device=DEVICE) for k, v in batch_np.items()}
    local = shard_batch(batch, mesh)
    perm = torch.tensor([1, 0, 3, 2], device=DEVICE)  # rows swapped within each data half
    permuted = {k: v[perm] for k, v in batch.items()}
    resets, read = train_launch_counts()

    def fresh():
        model = build_model(cfg, device=DEVICE, seed=None)
        if first:
            model.load_state_dict(state_dict)
        replicate_state(model, mesh)
        model.train()
        opt = build_optimizer(tcfg, model)
        return model, opt, T.create_train_state(model, opt)

    def tp_layout(model, opt, state):
        shard_train_state_tp(state, mesh)
        return T.make_train_step(model, opt, lc, tcfg, mesh=mesh)

    out = {"steps": [], "coords": mesh.coords}
    model, opt, state = fresh()
    if first:
        ref_model = copy.deepcopy(model)
        ref_opt = build_optimizer(tcfg, ref_model)
        ref_state = T.create_train_state(ref_model, ref_opt)
        ref_step = T.make_train_step(ref_model, ref_opt, lc, tcfg)
    step = tp_layout(model, opt, state)
    tp_s = 0.0
    for k in range(steps):
        whole = gather_train_state_tp(state, mesh) if k else None  # first: ref_model's state
        if first:
            snap = _model_snapshot(*((whole.model, whole) if k else (ref_model, ref_state)))
            _restore(ref_model, ref_state, snap)
            old = _step_record(ref_model, ref_state)
            ref_state, comps = ref_step(ref_state, batch, TRAIN_LR)
            ref = _step_record(ref_model, ref_state, comps)
            if k == 0:
                if floor:
                    _restore(ref_model, ref_state, snap)
                    ref_state, comps = ref_step(ref_state, permuted, TRAIN_LR)
                    out["floor"] = compare_steps(_step_record(ref_model, ref_state, comps), ref,
                                                 old)
                out["grad_norm"] = float(sum(float(g.double().square().sum())
                                             for g in ref["grads"].values()) ** 0.5)
                old0, ref0 = old, ref
            del snap
        del whole
        torch.cuda.synchronize()
        if k == 0:
            for reset in resets:
                reset()
        t1 = time.perf_counter()
        state, comps = step(state, local, TRAIN_LR)
        torch.cuda.synchronize()
        tp_s += time.perf_counter() - t1
        if k == 0:
            out["launches"] = read()
        whole = gather_train_state_tp(state, mesh)
        if first:
            out["steps"].append(compare_steps(_step_record(whole.model, whole, comps), ref, old))
            del ref, old
        del whole
        torch.cuda.empty_cache()
    out["tp_steps_s"] = tp_s
    out["mismatched_leaves"] = _model_group_mismatches(state, mesh)
    out["expected"] = tp_train_expected(mesh.size("model"), cfg)
    if first:
        del ref_model, ref_state, ref_step
    del model, state, step
    torch.cuda.empty_cache()
    out["faults"] = {}
    for fault in TP_TRAIN_FAULTS if faults else ():
        model, opt, state = fresh()
        step = tp_layout(model, opt, state)
        with tp_train_fault(fault):
            state, comps = step(state, local, TRAIN_LR)
        whole = gather_train_state_tp(state, mesh)
        reading = {"mismatched_leaves": _model_group_mismatches(state, mesh)}
        if first:
            reading.update(compare_steps(_step_record(whole.model, whole, comps), ref0, old0))
        out["faults"][fault] = reading
        del model, state, step, whole
        torch.cuda.empty_cache()
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    out["s"] = time.perf_counter() - t0
    print(json.dumps({"parallel_tp_train": compute_dtype, "rank": mesh.coords,
                      "mesh": dict(mesh.shape), "s": out["s"], "peak_gib": out["peak_gib"],
                      "tp_steps_s": tp_s, "launches_match": out["launches"] == out["expected"]}),
          flush=True)
    return out


def parallel_rank(path: str) -> dict:
    """One of PARALLEL_WORLD ranks sharing the card on gloo (CUDA tensors):
    every mesh of PARALLEL_MESHES serving bf16 and int8 (`_parallel_serve`,
    this rank's meshes), its part of the data-parallel training of
    PARALLEL_TRAIN (`_parallel_train`) and of the tensor-parallel training
    of PARALLEL_TP_TRAIN (`_parallel_tp_train`). Only each
    mesh's first rank loads the weights; the Predictor and
    `replicate_state` broadcast them."""
    import torch

    from transparent_object_detection_tpu_torch.config import ModelConfig
    from transparent_object_detection_tpu_torch.models.detector import build_model
    from transparent_object_detection_tpu_torch.ops.preprocess import letterbox_batch
    from transparent_object_detection_tpu_torch.parallel import (
        make_2d_mesh,
        make_mesh,
        process_index,
    )

    torch.backends.cuda.matmul.allow_tf32 = False  # as in the smoke's own process
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    data = torch.load(path, weights_only=False)
    rank = process_index()
    cfg = ModelConfig(**PARALLEL_CFG)
    meshes = {name: make_2d_mesh(tp, devices) for name, (tp, devices) in PARALLEL_MESHES.items()}
    train_meshes = {dtype: make_mesh(devices=ranks)
                    for dtype, (ranks, _) in PARALLEL_TRAIN.items()}
    firsts = {mesh.ranks[0] for mesh in (*meshes.values(), *train_meshes.values())}
    state = (torch.load(data["state_path"], map_location=DEVICE, weights_only=True)
             if rank in firsts else None)
    images = letterbox_batch(torch.as_tensor(data["raw"], device=DEVICE).float() / 255.0,
                             cfg.input_shape)
    out = {"rank": rank, "serve": {}, "start_s": time.perf_counter() - t0}
    # the meshes over all ranks first; then dp1xtp2 on its ranks beside the
    # training on the others
    for group in ([n for n, m in meshes.items() if len(m.ranks) == PARALLEL_WORLD],
                  [n for n, m in meshes.items() if len(m.ranks) < PARALLEL_WORLD]):
        mine = [n for n in group if meshes[n].member]
        for tag in ("bf16", "int8") if mine else ():
            int8 = tag == "int8"
            model = build_model(ModelConfig(**PARALLEL_CFG, int8_dense=int8, int8_attn=int8),
                                device=DEVICE, seed=None)
            if state is not None:
                model.load_state_dict(state)
            for name in mine:
                out["serve"][name, tag] = _parallel_serve(model, meshes[name], name, tag,
                                                          data["raw"], data["shapes"], images)
            del model
            torch.cuda.empty_cache()
    out["train"] = {dtype: _parallel_train(mesh, state, data["train_batch"], dtype,
                                           PARALLEL_TRAIN[dtype][1])
                    for dtype, mesh in train_meshes.items() if mesh.member}
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    out["tp_train"] = {(name, dtype): _parallel_tp_train(meshes[name], state, data["train_batch"],
                                                         dtype, steps, faults, floor)
                       for name, dtype, steps, faults, floor in PARALLEL_TP_TRAIN
                       if meshes[name].member}
    out["s"] = time.perf_counter() - t0
    return out


def nccl_rank(path: str) -> dict:
    """A world of one rank on NCCL: the data-parallel Predictor (its
    detections equal, bit for bit, to the same model's without a mesh) and
    one data-parallel step (against the same step without a mesh: within the
    train slice's limits, or the same step's on the rows in another order),
    so that the NCCL path runs."""
    import torch

    from transparent_object_detection_tpu_torch.config import ModelConfig, PredictConfig, TrainConfig
    from transparent_object_detection_tpu_torch.inference import Predictor
    from transparent_object_detection_tpu_torch.models.detector import build_model
    from transparent_object_detection_tpu_torch.parallel import make_mesh
    from transparent_object_detection_tpu_torch.train import trainer as T
    from transparent_object_detection_tpu_torch.train.optimizer import build_optimizer
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    data = torch.load(path, weights_only=False)
    cfg = ModelConfig(**PARALLEL_CFG)
    mesh = make_mesh()
    model = build_model(cfg, device=DEVICE, seed=None)
    state = torch.load(data["state_path"], map_location=DEVICE, weights_only=True)
    model.load_state_dict(state)
    out = {"backend": dist.get_backend(), "world": dist.get_world_size()}
    ref = Predictor(model, cfg, PredictConfig(), device=DEVICE).detect_raw_batch(
        data["raw"], data["shapes"])
    got = Predictor(model, cfg, PredictConfig(), device=DEVICE,
                    mesh=mesh).detect_raw_batch(data["raw"], data["shapes"])
    out["dets_equal"] = all(torch.equal(got[k], ref[k]) for k in ref)
    tcfg = TrainConfig(max_boxes=64, optimizer_type="sgd", ema=True)
    batch = {k: torch.as_tensor(v, device=DEVICE) for k, v in data["train_batch"].items()}
    perm = torch.tensor([1, 0, 3, 2], device=DEVICE)
    records = []
    for mesh_, rows in ((None, batch), (None, {k: v[perm] for k, v in batch.items()}),
                        (mesh, batch)):
        model.load_state_dict(state)
        model.train()
        opt = build_optimizer(tcfg, model)
        st = T.create_train_state(model, opt)
        old = _step_record(model, st)
        st, comps = T.make_train_step(model, opt, T.loss_config_from(cfg, tcfg), tcfg,
                                      mesh=mesh_)(st, rows, TRAIN_LR)
        records.append(_step_record(model, st, comps))
    out["step"] = compare_steps(records[2], records[0], old)
    out["floor"] = compare_steps(records[1], records[0], old)
    out["s"] = time.perf_counter() - t0
    return out


class _LocalModelAxis:
    """A model axis of `tp` in one process, for timing a rank's kernels at
    their TP-local shapes: rank 0's shards, every collective the identity
    (an all-gather repeats this rank's part, so shapes hold)."""

    distributed = False

    def __init__(self, tp: int):
        self.tp = tp

    def size(self, axis: str) -> int:
        return self.tp if axis == "model" else 1

    def index(self, axis: str) -> int:
        return 0


def tp_local_timing(model, int8_model) -> dict:
    """Rows 1, 3, 6 and 7 at the TP-local shapes of phi='s' 640x640 (tp 2
    and 4, batch 2), in this process alone (after the ranks): each neck TEB
    of rank 0 at tp (`tp_serving_copy` on a one-process model axis) run on
    random tokens; every int8 launch recorded, held against its plain
    version on its own activations and timed beside its bound, plain
    version and library yardstick (`int8_path_calls`); each head-local
    packed attention site's flash_mha_packed timed beside its bound, plain
    version and SDPA, held against plain with the kernel bar."""
    import torch

    from transparent_object_detection_tpu_torch.config import ModelConfig
    from transparent_object_detection_tpu_torch.ops import attention as A
    from transparent_object_detection_tpu_torch.ops import teb_tp
    from transparent_object_detection_tpu_torch.parallel.tp import tp_serving_copy

    cfg = ModelConfig(**PARALLEL_CFG)
    sites = scale_sites(cfg.phi, cfg.input_shape)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 11)
    real_gather = teb_tp.all_gather_list
    teb_tp.all_gather_list = lambda t, mesh, axis: [t] * mesh.size(axis)
    out = {}
    try:
        for tp in (2, 4):
            axis = _LocalModelAxis(tp)
            sim = tp_serving_copy(int8_model, axis)
            tokens = {name: torch.randn(2, sites[name][0], sites[name][1], generator=gen,
                                        device=DEVICE).bfloat16()
                      for name in ("h1", "h2", "h4", "h6")}
            tebs = {name: getattr(sim.neck, name).teb for name in tokens}
            rows = int8_path_calls(
                lambda _: [teb_tp.teb_tp_forward(tokens[n], tebs[n]) for n in tokens], None)
            del sim
            packed = []
            for name in ("h1", "h2", "h4"):
                n, c, _, heads, _ = sites[name]
                if heads % tp or teb_tp.local_route(n, c, heads, tp, False)[0] != "packed":
                    continue
                cl, h = c // tp, heads // tp
                qkv = (torch.randn(2, n, 3 * cl, generator=gen, device=DEVICE) * 0.5).bfloat16()
                scale = (cl // h) ** -0.5
                o = A.flash_mha_packed(qkv, h, scale)
                ref = A.flash_mha_packed_plain(qkv, h, scale)
                used = bar_used(o, ref)
                check(used <= 1.0, f"flash_mha_packed at tp={tp} {name}: {used}")
                packed.append({"node": f"{name} {h}x{cl // h}", "n": n, "heads": h,
                               "width": cl // h, "bar_used": used,
                               "max_abs_err": float((o.float() - ref.float()).abs().max()),
                               **_packed_timing(qkv, h, scale)})
                print(json.dumps({"tp_local_packed": tp, **packed[-1]}), flush=True)
            out[tp] = {"packed": packed, **rows}
    finally:
        teb_tp.all_gather_list = real_gather
    return out


def tp_train_kernel_entries(par: dict) -> list:
    """The kernels-line entries of rows 9-11 at the bf16 TP steps' local
    shapes ("... sm90 tp=2", "... sm90 tp=4"; timed in one process after the
    ranks, TP_TRAIN_SHAPES): their launches rank 0's in the first counted
    bf16 step of dp2xtp2 (tp 2) and dp1xtp4 (tp 4)."""
    jv = "transparent_object_detection_tpu/ops/attention_vjp.py"
    src = "transparent_object_detection_tpu_torch/csrc/"
    out = []
    for tp, rows in par["tp_train_rows"].items():
        launches = par["tp_train_launches"][tp]
        for name, source, line in (("flash_fwd_lse", "flash_fwd_sm90.cu", 63),
                                   ("flash_bwd_dq", "flash_bwd_sm90.cu", 170),
                                   ("flash_bwd_dkv", "flash_bwd_sm90.cu", 197)):
            out.append(kernel_entry(f"{name} sm90 tp={tp}", src + source, f"{jv}:{line}",
                                    rows[name], launches[name + "_sm90"]))
    return out


def parallel_kernel_entries(par: dict) -> list:
    """The kernels-line entries of rows 1, 3, 6 and 7 at their TP-local
    shapes (`tp_local_timing`, batch 2), "... tp=2" and "... tp=4": their
    launches rank 0's in the counted forward of dp1xtp2 and dp1xtp4."""
    ja = "transparent_object_detection_tpu/ops/attention.py"
    jq = "transparent_object_detection_tpu/ops/quant_matmul.py"
    ja8 = "transparent_object_detection_tpu/ops/attention_int8.py"
    src = "transparent_object_detection_tpu_torch/csrc/"
    out = []
    for tp, mesh in ((2, "dp1xtp2"), (4, "dp1xtp4")):
        rows = par["timing"][tp]
        bf16, int8 = par["launches"][mesh, "bf16"], par["launches"][mesh, "int8"]
        out.append(int8_kernel_entry(f"flash_mha_packed tp={tp}", src + "flash_fwd_sm90.cu",
                                     f"{ja}:239", rows["packed"], bf16["flash_mha_packed_sm90"],
                                     0.0))
        out += int8_attention_entries("flash_mha_int8", f" tp={tp}", rows["flash_mha_int8"],
                                      int8, 0.0, f"{ja8}:58")
        out.append(int8_kernel_entry(f"qmm sm90 tp={tp}", src + "qmm_sm90.cu", f"{jq}:80",
                                     rows["qmm"], int8["qmm"], 0.0))
        out.append(int8_kernel_entry(f"quant_rows tp={tp}", src + "quant_matmul.cu",
                                     f"{jq}:408", rows["quant_rows"], int8["quant_rows"], 0.0))
    return out


def _tp_train_report(ranks, limits, readings) -> dict:
    """The checks of the tensor-parallel training (PARALLEL_TP_TRAIN) on the
    ranks' results, printed first: every rank's first-step launches of rows
    9-11 equal to `tp_train_expected`; no replicated leaf differing across
    a model group; the clip biting (the reference's gradient norm above
    TP_TRAIN_CLIP); fp32 steps within the train slice's limits against one
    process's step from the same state, bf16 steps printed beside one
    process's step on the rows reordered; each planted fault rejected (past
    a limit, or replicated leaves differing). Returns rank 0's launches of
    the bf16 steps by tp."""
    report, launches, floors, failed = {}, {}, {}, []
    for name, dtype, steps, faults, floor in PARALLEL_TP_TRAIN:
        mine = [r for r in ranks if (name, dtype) in r["tp_train"]]
        first = mine[0]["tp_train"][name, dtype]
        if floor:
            floors[dtype] = readings(first["floor"])
        rep = {"steps": [readings(c) for c in first["steps"]],
               "floor_rows_reordered": floors[dtype], "grad_norm": first["grad_norm"],
               "launches": first["launches"], "expected": first["expected"],
               "leaves_differing": {r["rank"]: r["tp_train"][name, dtype]["mismatched_leaves"]
                                    for r in mine},
               "peak_gib": {r["rank"]: r["tp_train"][name, dtype]["peak_gib"] for r in mine},
               "tp_steps_s": first["tp_steps_s"], "s": first["s"], "faults": {}}
        for r in mine:
            t = r["tp_train"][name, dtype]
            if t["launches"] != t["expected"]:
                failed.append(f"TP train {name} {dtype} rank {r['rank']}: launches "
                              f"{t['launches']}, route table {t['expected']}")
            if any(t["mismatched_leaves"].values()):
                failed.append(f"TP train {name} {dtype} rank {r['rank']}: replicated leaves "
                              f"differ across the model group {t['mismatched_leaves']}")
        if first["grad_norm"] <= TP_TRAIN_CLIP:
            failed.append(f"TP train {name} {dtype}: the clip does not bite "
                          f"({first['grad_norm']})")
        for fault, f in first["faults"].items():
            differing = sum(sum(r["tp_train"][name, dtype]["faults"][fault]["mismatched_leaves"]
                                .values()) for r in mine)
            rep["faults"][fault] = {**readings(f), "leaves_differing": differing}
            if not (differing or any(readings(f)[k] > limits[k] for k in limits)):
                failed.append(f"TP train {name} {dtype}: {fault} not rejected: "
                              f"{rep['faults'][fault]}")
        if dtype == "float32":
            if not all(r[k] <= limits[k] for r in rep["steps"] for k in limits):
                failed.append(f"TP train {name} fp32 against one process: {rep['steps']} "
                              f"(limits {limits})")
        else:
            if not (len(rep["steps"]) == steps and all(
                    math.isfinite(v) for r in rep["steps"] for v in r.values())):
                failed.append(f"TP train {name} bf16 steps: {rep['steps']}")
            launches[PARALLEL_MESHES[name][0]] = first["launches"]  # by tp
        report[f"{name} {dtype}"] = rep
    print(json.dumps({"parallel_tp_training": report, "limits": limits}), flush=True)
    check(not failed, "; ".join(failed))
    return launches


def parallel_phase(card: str) -> dict:
    """Parallel execution on the card (parallel/, ops/teb_tp.py):
    PARALLEL_WORLD ranks sharing it on gloo (`parallel_rank`) and a world of
    one rank on NCCL (`nccl_rank`), started together after the kernels are
    built; meanwhile this process serves the same weights without a mesh
    (bf16 and int8, the references). Checks: every rank's launches equal
    `tp_expected`; its parameter bytes those of its shards; the global
    `decoded` and detections of every mesh against the single-process
    Predictor (bf16: the slice limits and detection sets matched; int8:
    PARALLEL_INT8_REL of the largest magnitude); each rank's TP program
    against its plain versions within the slice limits, and the planted
    fault (one row-parallel all-reduce left out) rejected by them; the
    data-parallel training of PARALLEL_TRAIN (`_parallel_train`: fp32
    within the train slice's limits, bf16 beside its reordering floor,
    BatchNorm on local statistics rejected, the ranks equal bit for bit);
    the NCCL rank's checks. Then rows 1, 3, 6 and 7 timed at their TP-local
    shapes in this process (`tp_local_timing`)."""
    import os
    import tempfile

    import torch

    from transparent_object_detection_tpu_torch.config import ModelConfig, PredictConfig
    from transparent_object_detection_tpu_torch.inference import Predictor
    from transparent_object_detection_tpu_torch.models.detector import build_model
    from transparent_object_detection_tpu_torch.ops.preprocess import letterbox_batch
    from transparent_object_detection_tpu_torch.parallel.launch import Ranks

    t0 = time.perf_counter()
    cfg, pcfg = ModelConfig(**PARALLEL_CFG), PredictConfig()
    raw, shapes, train_batch = _parallel_inputs(cfg)
    images = letterbox_batch(torch.as_tensor(raw, device=DEVICE).float() / 255.0,
                             cfg.input_shape)
    model = _parallel_model(images)
    tmp = tempfile.TemporaryDirectory(prefix="parallel_phase_")
    state_path = os.path.join(tmp.name, "state.pt")
    torch.save(model.state_dict(), state_path)
    path = os.path.join(tmp.name, "inputs.pt")
    torch.save({"state_path": state_path, "raw": raw, "shapes": shapes,
                "train_batch": train_batch}, path)
    setup_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    gloo = Ranks("chip_smoke:parallel_rank", PARALLEL_WORLD, {"path": path},
                 timeout=PARALLEL_RANK_TIMEOUT, device=DEVICE, backend="gloo")
    nccl = Ranks("chip_smoke:nccl_rank", 1, {"path": path}, timeout=PARALLEL_RANK_TIMEOUT,
                 device=DEVICE)
    int8_model = build_model(ModelConfig(**PARALLEL_CFG, int8_dense=True, int8_attn=True),
                             device=DEVICE, seed=None)
    int8_model.load_state_dict(model.state_dict())
    ref = {}
    with torch.inference_mode():
        for tag, m in (("bf16", model), ("int8", int8_model)):
            ref[tag] = {"decoded": m(images)["decoded"],
                        "dets": Predictor(m, cfg, pcfg, device=DEVICE).detect_raw_batch(raw,
                                                                                      shapes)}
    ranks = gloo.join()
    one = nccl.join()
    ranks_s = time.perf_counter() - t1
    print(json.dumps({"parallel_ranks_sharing_one_card_s": ranks_s,
                      "rank_s": [r["s"] for r in ranks], "rank_start_s": [r["start_s"]
                                                                        for r in ranks],
                      "rank_peak_gib": [r["peak_gib"] for r in ranks],
                      "nccl_rank_s": one[0]["s"]}), flush=True)

    launches = {}
    for r in ranks:
        for (name, tag), s in r["serve"].items():
            check(s["launches"] == s["expected"],
                  f"{name} {tag} rank {r['rank']}: launches {s['launches']}, route table "
                  f"{s['expected']}")
            check(s["bytes"] == s["bytes_want"] and s["bytes"] < s["whole_bytes"],
                  f"{name} {tag} rank {r['rank']}: {s['bytes']} parameter bytes, shards "
                  f"{s['bytes_want']}, whole model {s['whole_bytes']}")
            box, score, _ = SCALE_LIMITS[tag]
            sound, fault = s["against_plain"], s["fault_against_plain"]
            check(sound["box_px"] <= box and sound["score"] <= score,
                  f"{name} {tag} rank {r['rank']}: TP kernels against plain {sound}")
            check(fault["box_px"] > box or fault["score"] > score,
                  f"{name} {tag} rank {r['rank']}: the limits do not reject a row-parallel "
                  f"all-reduce left out: {fault}")
            # the global result, on every rank, against the single process
            dec, want = s["decoded"].to(DEVICE), ref[tag]["decoded"]
            if tag == "bf16":
                reading = _decoded_reading(dec, want)
                check(reading["box_px"] <= BOX_LIMIT_PX and reading["score"] <= SCORE_LIMIT,
                      f"{name} bf16 rank {r['rank']}: decoded against one process {reading}")
                d = {k: v.to(DEVICE) for k, v in s["dets"].items()}
                for a, b in ((d, ref[tag]["dets"]), (ref[tag]["dets"], d)):
                    m = match_detections(a, b, pcfg, reading["score"], BOX_LIMIT_PX)
                    check(m["compared"] > 0 and m["unmatched"] == 0,
                          f"{name} bf16 rank {r['rank']}: detection sets differ {m}")
            else:
                rel = float((dec - want).abs().max() / want.abs().max())
                reading = {"rel": rel}
                check(rel <= PARALLEL_INT8_REL and bool(torch.isfinite(dec).all()),
                      f"{name} int8 rank {r['rank']}: decoded {rel} of max from one process")
            s["against_one_process"] = reading
            if r["rank"] == 0:
                launches[name, tag] = s["launches"]
    summary = {f"{name} {tag}": {"launches": launches[name, tag],
                                 **{f"rank{r['rank']}": {k: r["serve"][name, tag][k] for k in (
                                     "against_plain", "fault_against_plain",
                                     "against_one_process", "bytes", "s", "setup_s")}
                                    for r in ranks if (name, tag) in r["serve"]}}
               for name, tag in launches}
    print(json.dumps({"parallel_serving": summary}), flush=True)

    train = {dtype: ranks[rs[0]]["train"][dtype] for dtype, (rs, _) in PARALLEL_TRAIN.items()}
    limits = {"grads": TRAIN_GRAD_LIMIT, "param_change": TRAIN_UPDATE_LIMIT,
              "ema_change": TRAIN_UPDATE_LIMIT, "bn_stats_change": TRAIN_STATS_LIMIT,
              "loss_rel": TRAIN_LOSS_LIMIT}
    readings = lambda c: {"grads": c["grads"]["all"], "param_change": c["param_change"],
                          "ema_change": c["ema_change"], "bn_stats_change": c["bn_stats_change"],
                          "loss_rel": max(c["loss_rel"].values())}
    report = {}
    for dtype, t in train.items():
        report[dtype] = {"steps": [readings(c) for c in t["steps"]],
                         "floor_rows_reordered": readings(t["floor"]),
                         "fault_local_batchnorm": readings(t["fault"]),
                         "mismatched_elements": [ranks[r]["train"][dtype]["mismatched_elements"]
                                                 for r in PARALLEL_TRAIN[dtype][0]],
                         "dp_steps_s": t["dp_steps_s"], "s": t["s"]}
    print(json.dumps({"parallel_training": {**report, "limits": limits}}), flush=True)
    # fp32: the data-parallel step is one process's step on the global batch
    # but for the order of its sums (the floor reads the same size): within
    # the train slice's limits, as the smoke holds its fp32 steps, which
    # reject BatchNorm on local statistics
    f32 = report["float32"]
    check(all(r[k] <= limits[k] for r in f32["steps"] for k in limits),
          f"fp32 data-parallel step against one process: {f32['steps']} (limits {limits})")
    check(any(f32["fault_local_batchnorm"][k] > limits[k] for k in limits),
          f"the limits do not reject BatchNorm on local statistics: {f32}")
    # bf16 (three steps): the same code in the compute type of the main path.
    # One process's step on the same rows in another order already reads
    # at these limits (bf16 sums rounded otherwise through every BatchNorm of
    # a random-weight model): the readings are printed beside that floor,
    # and BatchNorm on local statistics must read past both
    b16 = report["bfloat16"]
    bar = {k: max(limits[k], b16["floor_rows_reordered"][k]) for k in limits}
    check(len(b16["steps"]) == PARALLEL_TRAIN_STEPS and all(
        math.isfinite(v) for r in b16["steps"] for v in r.values()),
        f"bf16 data-parallel steps: {b16['steps']}")
    check(any(b16["fault_local_batchnorm"][k] > bar[k] for k in limits),
          f"bf16: BatchNorm on local statistics within the limits and the floor: {b16}")
    check(all(m == 0 for d in report.values() for m in d["mismatched_elements"]),
          "the training ranks' parameters, EMA, statistics or momenta differ")
    nccl_step, nccl_floor = readings(one[0]["step"]), readings(one[0]["floor"])
    print(json.dumps({"parallel_nccl": {**{k: one[0][k] for k in ("backend", "world",
                                                                    "dets_equal", "s")},
                                        "step": nccl_step, "floor": nccl_floor}}), flush=True)
    check(one[0]["backend"] == "nccl" and one[0]["world"] == 1 and one[0]["dets_equal"],
          f"NCCL world of one: {one[0]}")
    check(all(nccl_step[k] <= max(limits[k], nccl_floor[k]) for k in limits),
          f"NCCL data-parallel step against one process: {nccl_step} (floor {nccl_floor})")

    tp_launches = _tp_train_report(ranks, limits, readings)

    t2 = time.perf_counter()
    timing = tp_local_timing(model, int8_model)
    del model, int8_model
    torch.cuda.empty_cache()
    tmp.cleanup()
    # rows 9-11 at the bf16 TP steps' local shapes, held against plain with
    # their planted faults and timed (the train kernel phase's checks)
    tp_train_rows = {tp: train_kernel_phase(shapes) for tp, shapes in TP_TRAIN_SHAPES.items()}
    # the fp32 training state a rank holds at phi 'l' and 'x' (from shapes on
    # the meta device: parameters, gradients, momentum, EMA; no activations)
    from transparent_object_detection_tpu_torch.tools import tp_memory

    print(json.dumps({"tp_train_state_bytes_per_rank": {
        r["phi"]: {tp: r[f"tp{tp}_train_bytes"] for tp in (1, 2, 4, 8)}
        for r in tp_memory.rows() if r["phi"] in ("l", "x")}}), flush=True)
    out = {"launches": launches, "timing": timing, "ranks_s": ranks_s,
           "timing_s": time.perf_counter() - t2, "setup_s": setup_s,
           "tp_train_launches": tp_launches, "tp_train_rows": tp_train_rows}
    print(json.dumps({"parallel_phase_s": {k: out[k] for k in ("setup_s", "ranks_s",
                                                               "timing_s")}}), flush=True)
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

    if sys.argv[1:] == ["parallel"]:  # the parallel phase alone, no result line
        par = phase("parallel", parallel_phase, card)
        print(json.dumps({"parallel_kernels": parallel_kernel_entries(par)
                          + tp_train_kernel_entries(par)}))
        return 0
    if sys.argv[1:] == ["wide"]:  # the wide backward's checks alone, no result line
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        randn = lambda *s: torch.randn(*s, generator=gen, device="cuda")
        qk_std = lambda score_std, scale, d: (score_std / (scale * d ** 0.5)) ** 0.5
        phase("off grid backward", off_grid_backward, randn, qk_std)
        phase("train scale kernel", train_scale_kernel_phase)
        phase("wide tp", wide_tp_phase)
        return 0
    if sys.argv[1:] == ["int8_1x1"]:  # the int8 1x1 route alone (bf16 weights), no result line
        from transparent_object_detection_tpu_torch.config import ModelConfig
        from transparent_object_detection_tpu_torch.models.detector import build_model

        phase("int8 1x1 kernel", int8_1x1_kernel_phase)
        m = build_model(ModelConfig(), device=DEVICE, seed=SEED)
        m.backbone.dark3_attn.gamma.data.fill_(0.5)
        phase("int8 1x1", int8_1x1_phase, card, m)
        return 0

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
    i1x1_err = phase("int8 1x1 kernel", int8_1x1_kernel_phase)
    i1x1 = phase("int8 1x1", int8_1x1_phase, card, bf16_model)
    del bf16_model
    torch.cuda.empty_cache()
    train_launches = phase("train slice", train_slice_phase, card)["launches"]
    scale_err, n_single_rows = phase("scale kernel", scale_kernel_phase)
    m_run = phase("phi=m slice", scale_slice_phase, card, "m", ("bf16", "int8", "A", "B"),
                  (32, 1), timed=True)
    n_run = phase("phi=n slice", scale_slice_phase, card, "n", ("bf16", "int8"), (2,),
                  timed=False)
    phase("serve matrix", serve_matrix_phase, card)
    # phi='l' (8.33 B parameters) served end to end: bf16, int8, A, B from
    # one fp32 copy of the weights, throughput at the largest batch that fits
    l_run = phase("phi=l slice", scale_slice_phase, card, "l", ("bf16", "int8", "A", "B"),
                  (2, 1), timed=True, shared=True, fp32=False, big=(32, 16, 8))
    train_scale = phase("train scale kernel", train_scale_kernel_phase)
    wide_tp = phase("wide tp", wide_tp_phase)
    phase("folded route", folded_route_check)
    from transparent_object_detection_tpu_torch.config import ModelConfig

    m_train = phase("phi=m train", train_slice_phase, card, ModelConfig(phi="m", remat=True),
                    train_batches=(16, 8), faults=(), rejects=())
    n_train = phase("phi=n train", train_slice_phase, card, ModelConfig(phi="n"), rejects=(),
                    timed=False)
    n32_train = phase("phi=n fp32 train", train_slice_phase, card,
                      ModelConfig(phi="n", compute_dtype="float32"), rejects=(), timed=False)
    fit = phase("fit", fit_phase, card)
    torch.cuda.empty_cache()
    api = phase("api", api_phase, card)
    torch.cuda.empty_cache()
    par = phase("parallel", parallel_phase, card)
    vsrc = "transparent_object_detection_tpu_torch/csrc/flash_bwd_wide_sm90.cu"
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
    # row 1 and rows 9-11's packed sites run the sm90 kernels; rows 2 and
    # 9's one-head sites (dark3, the folded heads) its one-head form, rows
    # 10 and 11's the one-head sm90 backward
    form_rows = lambda rows, sm90: [r for r in rows if (r.get("form") == "sm90") == sm90]
    form_is = lambda rows, form: [r for r in rows if r.get("form") == form]

    def by_site(entry):  # each site's time beside its bound, plain and SDPA's call
        entry["sites"] = {r["node"]: {k: r[k] for k in ("ms", "bound_ms", "plain_ms",
                                                        "library_ms")}
                          for r in entry["shapes"]}
        return entry
    kernels = [
        kernel_entry("flash_mha_packed", sm90_src,
                     "transparent_object_detection_tpu/ops/attention.py:239", mha_rows,
                     launches["flash_mha_packed_sm90"]),
        by_site(kernel_entry("flash_single single_sm90", sm90_src,
                             "transparent_object_detection_tpu/ops/attention.py:137",
                             single_rows, launches["flash_single_sm90"])),
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
        by_site(kernel_entry("flash_fwd_lse single_sm90", sm90_src, f"{jv}:63",
                             form_is(train_rows["flash_fwd_lse"], "single_sm90"),
                             train_launches["flash_fwd_lse_single"])),
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
    forms = (("flash_mha_packed", src, f"{ja}:239"), ("flash_single", sm90_src, f"{ja}:137"),
             ("flash_mha_int8", I8_SM90_SRC, f"{ja8}:58"),
             ("flash_mha_int8_qout", I8_SM90_SRC, f"{ja8}:184"),
             ("flash_int8_handoff", I8_SM90_SRC, f"{ja8}:435"), ("qmm", qmm_src, f"{jq}:80"),
             ("quant_rows", qsrc, f"{jq}:408"), ("quant_rows_int4", qsrc, f"{jq}:408"))
    runs = (("phi=m", m_run, ("bf16", "int8", "A", "B"), 32, ""),
            ("phi=l", l_run, ("bf16", "int8", "A", "B"), 2, ""),
            ("phi=n", n_run, ("int8",), 2, ""),
            ("fp32 phi=m", m_run, ("fp32",), 2, "_f32"),
            ("fp32 phi=n", n_run, ("fp32 int8",), 2, "_f32"))
    for label, run, tags, batch, suffix in runs:
        for name, source, replaces in forms:
            tag = next((t for t in tags if run[t].get("rows", {}).get(name)), None)
            if tag is None:
                continue
            r = run[tag]
            if name.startswith(("flash_mha_int8", "flash_int8")):  # the int8 kernel
                kernels += int8_attention_entries(name, f" {label}", r["rows"][name],
                                                  r["launches"][batch],
                                                  scale_err.get(name + suffix, 0.0), replaces)
                continue
            # bf16 packed: the sm90 kernel; bf16 one head: its one-head form
            # (dark3 and the folded h1 apart); fp32 flash: the f32_sm90 kernel
            sm90 = name in ("flash_mha_packed", "flash_single") and not suffix
            f32 = suffix and name in ("flash_mha_packed", "flash_single")
            single = sm90 and name == "flash_single"
            entry = int8_kernel_entry(
                f"{'qmm sm90' if name == 'qmm' else name}{' single_sm90' if single else ''} "
                f"{label}", sm90_src if sm90 else f32_src if f32 else source, replaces,
                r["rows"][name],
                r["launches"][batch][name + ("_sm90" if sm90 else "_f32" if f32 else "")],
                scale_err.get(name + suffix, 0.0))
            kernels.append(by_site(entry) if single else entry)
    # row 2 at phi='n''s one-head sites (launches of the counted batch-2
    # forward, times of the scale kernel phase)
    kernels.append(by_site(int8_kernel_entry(
        "flash_single single_sm90 phi=n", sm90_src, f"{ja}:137", n_single_rows,
        n_run["bf16"]["launches"][2]["flash_single_sm90"], scale_err.get("flash_single", 0.0))))
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
                    f"{name} single_sm90 {label}",
                    sm90_src if name == "flash_fwd_lse" else ssrc, f"{jv}:{line}",
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
    # rows 10 and 11 on the wide kernels: phi='l''s sites (the train scale
    # kernel phase's timed backward, by site) and its tensor-parallel local
    # shapes (wide_tp_phase); launches those the phases counted, one a site
    for name, line in (("flash_bwd_dq", 170), ("flash_bwd_dkv", 197)):
        kernels.append(by_site(int8_kernel_entry(
            f"{name} wide_sm90 phi=l", vsrc, f"{jv}:{line}", train_scale["rows"][f"{name} phi=l"],
            train_scale["wide_launches"][name], train_scale["err"][name + " wide_sm90"])))
        for tp, r in wide_tp.items():
            kernels.append(by_site(int8_kernel_entry(
                f"{name} wide_sm90 phi=l tp={tp}", vsrc, f"{jv}:{line}", r["rows"][name],
                r["launches"][name], 0.0)))
    # the training pipeline (Trainer.fit): its launches of rows 1, 2 and 9-11
    # as `fit_launches` on the same kernels' phi='s' entries
    by_name = {k["name"]: k for k in kernels}
    for name, counter in (("flash_mha_packed", "flash_mha_packed_sm90"),
                          ("flash_single single_sm90", "flash_single_sm90"),
                          ("flash_fwd_lse sm90", "flash_fwd_lse_sm90"),
                          ("flash_fwd_lse single_sm90", "flash_fwd_lse_single"),
                          ("flash_bwd_dq sm90", "flash_bwd_dq_sm90"),
                          ("flash_bwd_dq single_sm90", "flash_bwd_dq_single"),
                          ("flash_bwd_dkv sm90", "flash_bwd_dkv_sm90"),
                          ("flash_bwd_dkv single_sm90", "flash_bwd_dkv_single")):
        by_name[name]["fit_launches"] = fit["launches"][counter]
    check(all(n32_train["launches"][k + "_f32"] > 0 for k in TRAIN_KERNELS),
          f"phi='n' fp32 training missed an f32_sm90 kernel: {n32_train['launches']}")
    check(n_train["launches"]["flash_fwd_lse_single"] > 0,
          "phi='n' bf16 training ran no one-head forward kernel")
    # the user surface (FOCUS): the launches of rows 1 and 2 that the bf16
    # model's three detect_image calls made, read in the api phase, as
    # `api_launches`
    for name, counter in (("flash_mha_packed", "flash_mha_packed_sm90"),
                          ("flash_single single_sm90", "flash_single_sm90")):
        by_name[name]["api_launches"] = api["bf16"]["detect_image"]["launches"][counter]
    # parallel execution: rank 0's launches of the counted forward of each
    # mesh as `parallel_launches` on rows 1, 3, 6 and 7's phi='s' entries,
    # and those rows at their TP-local shapes (tp 2 and 4, batch 2, timed
    # in one process) as entries of their own
    for name, counter, tag in (("flash_mha_packed", "flash_mha_packed_sm90", "bf16"),
                               ("flash_mha_int8", "flash_mha_int8_sm90", "int8"),
                               ("qmm sm90", "qmm", "int8"), ("quant_rows", "quant_rows", "int8")):
        by_name[name]["parallel_launches"] = {mesh: par["launches"][mesh, tag][counter]
                                              for mesh in PARALLEL_MESHES}
    kernels += parallel_kernel_entries(par)
    kernels += tp_train_kernel_entries(par)
    # the int8 1x1 convs: launches of the int8_1x1 model's counted batch-32
    # main path, times of its batch-16 forward's launches (every routed conv)
    for name, source, counter in (("qmm sm90", qmm_src, "qmm"), ("quant_rows", qsrc,
                                                                 "quant_rows")):
        kernels.append(int8_kernel_entry(
            f"{name} int8_1x1", source, f"{jq}:{80 if counter == 'qmm' else 408}",
            i1x1["rows"][counter], i1x1["launches"]["int8_1x1"][32][counter], i1x1_err[counter]))
    print(json.dumps({"smoke_total_s": time.perf_counter() - t_start, "phase_s": phase_s,
                      "api_s": api["seconds"]}), flush=True)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
