"""Time the serving kernels (rows 1-8) and the training kernels (rows 9-11:
flash_fwd_lse, flash_bwd_dq, flash_bwd_dkv, `time_training_kernels`) of
this checkout at the phi='s' 640x640 shapes, batch 2 (the packed sites and
the int8 attention entry points, rows 3-5, also at batch 1; rows 3-5 and
9-11 also at phi='m' h2 and h4, 8 heads of 384; row 2, flash_single, and
rows 9-11 also at the one-head sites of phi='m' and 'n': dark3 and the
folded h1, row 2 at batch 1 too), on one GPU; prints one JSON line (ms per
call, CUDA events, 20 calls after 3 warm-ups).

    python3 transparent_object_detection_tpu_torch/kernels/time_serving.py \
        [--forward | --wide-heads | --train-step | --f32 | --qmm | --int8 | --int8-wide |
         --wide-bwd | --graphs [s] [m] [l] | --train-graphs [--fit]]

With --forward it times only the phi='s' 640x640 FocusModel forward
(seeded weights) in bf16, int8 (int8_dense + int8_attn) and the int8
TEB's configurations A (attn_handoff + w4a4_mlp1) and B (attn_qout):
batch 1 on the host clock (the latency path) and by the device's busy
time, batch 32 with CUDA events; then the phi='m' bf16, int8, A and B
forwards at batch 32.
With --int8 it times only int8 attention (row 3, flash_mha_int8) at dark3
of phi 'm' (q/k 128, v 1,024, two key blocks) and 'n' (q/k 32, v 256; bf16
and fp32 q), batch 2 and 1, each held to the int8 value bar against its
plain version, and where the checkout's `int8_sm90_plan` takes a slice
width, csrc/flash_int8_sm90.cu's forms at those sites (v in slices of 128,
256 or 512 columns); then quant_rows (rows 7 and 8) at every launch shape
of one batch-2 forward of the phi 'n' (bf16 and fp32 compute), 's' (and
its configuration A, whose w4a4 mlp1 runs qmax 7) and 'm' int8 models
(recorded from the model's own forward), each held to the int8 bars, on
CUDA events and by its kernel's device time (torch.profiler: a launch is
shorter than the host's time to enqueue it), its bytes bound beside it,
and the forwards' sums by launch counts; and a
torch.profiler reading of one quant_rows launch at the phi='s' h2 qkv
shape (12,800 x 1,536 bf16, LN) and the phi='n' fp32 one. A checkout
before the sliced form times the dark3 sites on the mma_sync template
(that checkout's csrc/flash_attn_int8.cu) and quant_rows on its first
kernels.
With --int8-wide it times only rows 3-5 (flash_mha_int8, flash_mha_int8_qout,
flash_int8_handoff with its int8 output) at the int8 sites of phi 'l' and
'x' 640x640 (INT8_LX: the neck heads of 768 to 3,584, dark3 row 3 alone), at
batch 2 and 1, each held to the int8 bars against its plain version, beside
the three-product bound (the two-product one too), the plain version's time
and bf16 SDPA on the same shapes (a reference point: it computes another
function), with the kernel each call took (`int8_fwd_form`, and the plan
where the checkout has one). A checkout before the wide form times the neck
heads on the mma_sync template of csrc/flash_attn_int8.cu.
With --wide-bwd it times only rows 10 and 11 (flash_bwd_dq, flash_bwd_dkv)
in bf16 at the sites csrc/flash_bwd_wide_sm90.cu takes (WIDE_BWD_SITES:
every training site of phi 'l' 640x640, its tensor-parallel local shapes
at tp 4 and tp 8, and the sites of phi 'x'), batch 2, each held to the
gradient bar (1e-2 |plain| + 1e-2 max|plain| an element) against its
plain version, beside the bound (the Pallas count of operations at 989
TFLOP/s, or the bytes at 3.35 TB/s), the plain version's time (one call)
and SDPA's backward on the same operands (a yardstick), with the kernel
each call took (`bwd_form`). A checkout before the wide kernels times the
same sites on the mma.sync template of csrc/flash_attn_bwd.cu.
With --qmm it times only qmm (row 6) at every distinct launch shape of one
int8 forward of phi 's' and 'm' 640x640 at batch 2 and at batch 1 (the
launches recorded from the model's own forward, then each shape's call
repeated): the call, and for the quantized outputs its GEMM alone (the
same call writing the fp32 workspace, no row pass), beside torch._int_mm
alone and with the epilogue (on copies zero-padded to multiples of 8
where K or N is not), the activations' pad copy where K % 16 != 0, and
the sums over the forward by its launch counts. A checkout before
csrc/qmm_sm90.cu times the mma.sync GEMM of csrc/quant_matmul.cu (with its
per-call weight pad). With --wide-heads
it times only the two forms csrc/flash_fwd_sm90.cu has for heads wider
than 256, at phi='m' (8 heads of 384): the warpgroup split that
`attention.sm90_plan` picks and the sliced form (v in two slices of 192
across blocks, S recomputed per slice), each held to 1e-2 of max|plain|;
then its one-head form's (`attention.single_sm90_plan`) against the others
at the one-head serving sites (SINGLE_SITES; `time_single_forms`).
With --train-step it times only two eager training steps of
`make_train_step` (SGD nesterov, EMA; seeded weights, synthetic batches like
chip_smoke.py's): phi='s' 640x640 at batch 16 and phi='m' 640x640 with
remat at batch 16, each on CUDA events, the median of 3 steps after 1
warm-up.
With --train-graphs it times the train step eager against compiled (one
captured CUDA graph a key, train/trainer.py), rounds E, G, G, E: phi='s'
640x640 at batch 16 with the backbone frozen and at batch 8 (the fit's two
phases), phi='m' with remat at the first of batch 16 and 8 whose graph fits
(`time_train_graphs`: ms a step and imgs/s, device ms, each capture's
seconds, pool GiB and memory decision); with --fit also Trainer.fit eager
against compiled on chip_smoke.py's fit set (`time_fit_graphs`: each
epoch's training span and imgs/s).
With --f32 it times only the fp32 forms of rows 1, 2 and 9 (fp32 compute)
beside SDPA's fp32 call on the same operands (and names the kernel that call
spends most of its time in, by torch.profiler): rows 1 and 2 at the phi='m'
640x640 serving sites (h2 and h4, 8 heads of 384; dark3, q/k 128 and v
1,024; the folded h1, 16 heads of 600 at batch 2), row 9 at the phi='n'
training sites (h2 and h4, 6 heads of 128; dark3, 32 and 256; the folded
h1, 6 heads of 288), batch 2; rows 10 and 11 (flash_bwd_dq, flash_bwd_dkv)
at the same phi='n' training sites and phi='m' h4 (8 heads of 384) beside
SDPA's fp32 backward on the same operands (its main kernel named likewise);
then the fp32-compute phi='m' forward at batch 2 and the fp32 phi='n'
training step at batch 16 (CUDA events, median of 3 after 1 warm-up, and
its peak memory). A checkout before csrc/flash_fwd_f32_sm90.cu times the
forward calls on the CUDA-core FFMA kernel of csrc/flash_attn_fwd.cu, one
before csrc/flash_bwd_f32_sm90.cu the backward calls on the FFMA kernel of
csrc/flash_attn_bwd.cu.

With --graphs it times serving through the Predictor's captured CUDA graphs
(inference.py's program cache) against the same call run eagerly
(`inference.raw_detect_step` on the same kernels) on 480x640 uint8 images,
class biases set for ~50 candidates an image (200 in int8), seeded weights:
phi='s' in bf16, int8, A and B, phi='m' and phi='l' in bf16 (the phis
named after --graphs, else all), each in four rounds E, G, G, E: batch-1
p50 / p75 / min of 40 calls and batch-32 imgs/s of 3 calls (phi='l': 2),
each call ending in a host read of the detection counts, a round's shapes
warmed up (and, for G, captured) before its clock starts and the graphs
dropped before each E round, so that phi='l' holds one pool or the eager
run's memory, not both; each capture's seconds, the parts its batch runs
in (phi='l' at 32: its graph is captured at a part of the batch), the
pool's growth and the peaks of the eager call and the capture, the
weights' GiB, and the per-call check of the tensors a graph reads
(`TracedModules.traced` and `.fingerprint`) in µs; then csrc/nms_exact.cu
against its plain loop at K = 1,024, every candidate valid, batch 1 and
32, beside its bytes bound and its device time by torch.profiler.

The package is imported from the checkout this file lies in, so two
checkouts (say a parent commit unpacked with `git archive` into a directory
that .gitignore lists, with this file copied over its own) are compared on
one card by running each one's copy of this script in turns: A, B, B, A.
A checkout before the sm90 kernel times the packed sites on the mma_sync
template of csrc/flash_attn_fwd.cu, so such a pair gives both kernels'
times on the same inputs.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from transparent_object_detection_tpu_torch.kernels import _build  # noqa: E402
from transparent_object_detection_tpu_torch.ops import attention as A  # noqa: E402
from transparent_object_detection_tpu_torch.ops import attention_int8 as A8  # noqa: E402
from transparent_object_detection_tpu_torch.ops import attention_vjp as V  # noqa: E402
from transparent_object_detection_tpu_torch.ops import quant_matmul as QM  # noqa: E402

# (name, (batch, tokens, channels, heads)) of the phi='s' neck TEBs at 640x640
NECK = (("h1", (2, 1600, 2048, 8)), ("h2", (2, 6400, 1536, 6)), ("h4", (2, 1600, 1536, 6)))
# the int8 attention sites of rows 3-5 beyond phi='s': phi='m' h2 (two key
# blocks of 3,200) and h4, 8 heads of 384
INT8_WIDE = (("phi=m h2", (2, 6400, 3072, 8)), ("phi=m h4", (2, 1600, 3072, 8)))
# configurations of the --forward timing
FORWARDS = ("bf16", "int8", "A", "B")
# the --int8 dark3 sites: (name, (batch, tokens, q/k width, v width, key
# block, q's type)); and the v slice widths of the sm90 forms timed there
INT8_DARK3 = (("phi=m dark3", (2, 6400, 128, 1024, 3200, torch.bfloat16)),
              ("phi=n dark3", (2, 6400, 32, 256, 6400, torch.bfloat16)),
              ("phi=n dark3 fp32 q", (2, 6400, 32, 256, 6400, torch.float32)))
INT8_DARK3_FORMS = {"phi=m dark3": (128, 256, 512), "phi=n dark3": (128, 256),
                    "phi=n dark3 fp32 q": (128, 256)}
# the --int8-wide sites: (name, (tokens, q/k channels, v channels, heads, key
# block)) of phi 'l' and 'x' 640x640, key blocks from `pick_blocks`
INT8_LX = (("phi=l dark3", (6400, 256, 2048, 1, 1600)), ("phi=l h1", (1600, 12288, 12288, 8, 800)),
           ("phi=l h2", (6400, 6144, 6144, 8, 1600)), ("phi=l h4", (1600, 6144, 6144, 8, 1600)),
           ("phi=x dark3", (6400, 512, 4096, 1, 800)), ("phi=x h1", (1600, 28672, 28672, 8, 320)),
           ("phi=x h2", (6400, 12288, 12288, 8, 1280)),
           ("phi=x h4", (1600, 12288, 12288, 8, 800)))
# the --int8 quant_rows forwards: (label, phi, compute type, configuration)
QUANT_ROWS_FORWARDS = (("phi=n", "n", "bfloat16", "int8"), ("phi=n fp32", "n", "float32", "int8"),
                       ("phi=s", "s", "bfloat16", "int8"), ("phi=s A", "s", "bfloat16", "A"),
                       ("phi=m", "m", "bfloat16", "int8"))
PEAK_INT8_OPS = 1979e12  # H100 SXM data sheet, dense int8
PEAK_BYTES = 3.35e12
# the --qmm forwards: (phi, batches)
QMM_FORWARDS = (("s", (2, 1)), ("m", (2, 1)))
# (name, (batch, tokens, q/k width, v width, heads)) of the phi='s' training
# sites, then phi='m' and phi='n' ones: the packed h2 and h4 of phi='m', and
# the one-head sites of both (dark3; the folded h1 as the fold copy hands it
# over, B * H single heads of the padded width)
TRAIN_SITES = (("h1", (2, 1600, 2048, 2048, 8)), ("h2", (2, 6400, 1536, 1536, 6)),
               ("h4", (2, 1600, 1536, 1536, 6)), ("dark3", (2, 6400, 64, 512, 1)),
               ("phi=m h2", (2, 6400, 3072, 3072, 8)), ("phi=m h4", (2, 1600, 3072, 3072, 8)),
               ("phi=m dark3", (2, 6400, 128, 1024, 1)),
               ("phi=m h1 folded", (16, 1600, 600, 600, 1)),
               ("phi=n dark3", (2, 6400, 32, 256, 1)),
               ("phi=n h1 folded", (6, 1600, 288, 288, 1)))
# (name, (batch, tokens, q/k width, v width)) of the one-head serving sites
# of row 2 (flash_single) at batch 2, timed at batch 1 too: dark3 of phi
# 's', 'm' and 'n', and the folded h1 of phi 'm' and 'n' as the fold copy
# hands it over (B * H single heads of the padded width, scale d ** -0.5)
SINGLE_SITES = (("dark3", (2, 6400, 64, 512)), ("phi=m dark3", (2, 6400, 128, 1024)),
                ("phi=m h1 folded", (16, 1600, 600, 600)), ("phi=n dark3", (2, 6400, 32, 256)),
                ("phi=n h1 folded", (6, 1600, 288, 288)))
# the --train-step configurations: (label, ModelConfig keywords, batch)
TRAIN_STEPS = (("phi=s", {}, 16), ("phi=m remat", {"phi": "m", "remat": True}, 16))
# the --train-graphs steps: (label, ModelConfig keywords, batches tried in
# turn until the graph fits, frozen backbone): the fit's two phases, and
# phi='m' with remat
TRAIN_GRAPHS = (("phi=s", {}, (16,), True), ("phi=s", {}, (8,), False),
                ("phi=m remat", {"phi": "m", "remat": True}, (16, 8), False))
# the --f32 sites: (name, entry point, (batch, tokens, q/k width, v width,
# heads)); packed heads read q/k/v as column views of one packed qkv, the
# folded ones run as single heads on the widths the fold copy pads to 8
F32_SITES = (("row 1 phi=m h2", "flash_mha_packed", (2, 6400, 3072, 3072, 8)),
             ("row 1 phi=m h4", "flash_mha_packed", (2, 1600, 3072, 3072, 8)),
             ("row 2 phi=m dark3", "flash_single", (2, 6400, 128, 1024, 1)),
             ("row 2 phi=m h1 folded", "flash_single", (16, 1600, 600, 600, 1)),
             ("row 9 phi=n h2", "flash_fwd_lse", (2, 6400, 768, 768, 6)),
             ("row 9 phi=n h4", "flash_fwd_lse", (2, 1600, 768, 768, 6)),
             ("row 9 phi=n dark3", "flash_fwd_lse", (2, 6400, 32, 256, 1)),
             ("row 9 phi=n h1 folded", "flash_fwd_lse", (6, 1600, 288, 288, 1)))
# the --f32 sites of rows 10 and 11: (name, (batch, tokens, q/k width, v
# width, heads)), the phi='n' training sites and phi='m' h4
F32_BWD_SITES = (("phi=n h2", (2, 6400, 768, 768, 6)), ("phi=n h4", (2, 1600, 768, 768, 6)),
                 ("phi=n dark3", (2, 6400, 32, 256, 1)),
                 ("phi=n h1 folded", (6, 1600, 288, 288, 1)),
                 ("phi=m h4", (2, 1600, 3072, 3072, 8)))


# the --wide-bwd sites: (name, (batch, tokens, q/k channels, v channels,
# heads, score scale d ** -0.5 or none)): phi='l' 640x640's training sites,
# its tensor-parallel local shapes (the neck's 8 heads divided by tp), then
# phi='x''s sites
WIDE_BWD_SITES = (
    ("phi=l dark3", (2, 6400, 256, 2048, 1, False)), ("phi=l h1", (2, 1600, 12288, 12288, 8, True)),
    ("phi=l h2", (2, 6400, 6144, 6144, 8, True)), ("phi=l h4", (2, 1600, 6144, 6144, 8, True)),
    ("phi=l h1 tp=4", (2, 1600, 3072, 3072, 2, True)),
    ("phi=l h2 tp=4", (2, 6400, 1536, 1536, 2, True)),
    ("phi=l h4 tp=4", (2, 1600, 1536, 1536, 2, True)),
    ("phi=l h1 tp=8", (2, 1600, 1536, 1536, 1, True)),
    ("phi=l h2 tp=8", (2, 6400, 768, 768, 1, True)),
    ("phi=l h4 tp=8", (2, 1600, 768, 768, 1, True)),
    ("phi=x dark3", (2, 6400, 512, 4096, 1, False)), ("phi=x h1", (2, 1600, 28672, 28672, 8, True)),
    ("phi=x h2", (2, 6400, 12288, 12288, 8, True)), ("phi=x h4", (2, 1600, 12288, 12288, 8, True)))
PEAK_BF16_FLOPS = 989e12  # H100 SXM data sheet, dense bf16


def timed_ms(fn, iters: int = 20, warmup: int = 3) -> float:
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


def _grad_bar(out, ref) -> float:
    diff = (out.float() - ref.float()).abs()
    mag = ref.float().abs()
    return float((diff / (1e-2 * mag + 1e-2 * mag.max())).max())


def time_wide_bwd(randn) -> dict:
    """Rows 10 and 11 at WIDE_BWD_SITES, batch 2 (see the module's
    docstring); inputs with logits of std 2, q/k/v column views of one
    packed array."""
    import torch.nn.functional as F

    out = {}
    for name, (b, n, cq, cv, h, scaled) in WIDE_BWD_SITES:
        d = cq // h
        scale = d ** -0.5 if scaled else 1.0
        std = (2.0 / (scale * d ** 0.5)) ** 0.5
        qkv = randn(b, n, 2 * cq + cv)
        qkv[..., :2 * cq] *= std
        qkv = qkv.bfloat16()
        q, k, v = qkv[..., :cq], qkv[..., cq:2 * cq], qkv[..., 2 * cq:]
        do = randn(b, n, cv).bfloat16()
        pout, plse = V.flash_fwd_lse_plain(q, k, v, scale, h)
        args = (q, k, v, do, plse, V.compute_dcap(pout, do, h), scale, h)
        stats, operands = 4 * b * h * n, 2 * b * n * (2 * cq + 2 * cv)
        costs = {"flash_bwd_dq": (2.0 * b * n * n * (2 * cq + cv),
                                  operands + 2 * stats + 2 * b * n * cq),
                 "flash_bwd_dkv": (2.0 * b * n * n * (2 * cq + 2 * cv),
                                   operands + 2 * stats + 2 * b * n * (cq + cv))}
        kernels = {"flash_bwd_dq": (lambda: (V.flash_bwd_dq(*args),),
                                    lambda: (V.flash_bwd_dq_plain(*args),)),
                   "flash_bwd_dkv": (lambda: V.flash_bwd_dkv(*args),
                                     lambda: V.flash_bwd_dkv_plain(*args))}
        qh, kh, vh, doh = (t.reshape(b, n, h, -1).transpose(1, 2).contiguous()
                           for t in (q, k, v, do))
        qh, kh, vh = (t.requires_grad_() for t in (qh, kh, vh))
        sdpa_fwd = timed_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=scale), 3, 1)

        def sdpa_fwd_bwd():
            F.scaled_dot_product_attention(qh, kh, vh, scale=scale).backward(doh)
        sdpa_bwd = max(timed_ms(sdpa_fwd_bwd, 3, 1) - sdpa_fwd, 0.0)
        for kname, (kernel, plain) in kernels.items():
            got, ref = kernel(), plain()
            torch.cuda.synchronize()
            ops, nbytes = costs[kname]
            row = {"form": V.bwd_form(d, cv // h, h, q.dtype),
                   "bar_used": max(_grad_bar(g, r) for g, r in zip(got, ref)),
                   "ms": timed_ms(kernel, 5, 1),
                   "bound_ms": max(ops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * 1e3,
                   "plain_ms": timed_ms(plain, 1, 0), "sdpa_bwd_ms": sdpa_bwd}
            out[f"{kname} {name}"] = row
            print(json.dumps({f"{kname} {name}": row}), flush=True)
    return out


def time_training_kernels(randn) -> dict:
    """ms of flash_fwd_lse, flash_bwd_dq and flash_bwd_dkv at each training
    site of TRAIN_SITES (q/k/v as column views of one packed qkv for packed
    heads), and the kernel `bwd_form` names for the backward."""
    out = {}
    for name, (b, n, cq, cv, h) in TRAIN_SITES:
        scale = (cq // h) ** -0.5 if h > 1 else 1.0
        if h > 1:
            qkv = randn(b, n, 3 * cq).bfloat16()
            q, k, v = qkv[..., :cq], qkv[..., cq:2 * cq], qkv[..., 2 * cq:]
        else:
            q, k, v = randn(b, n, cq).bfloat16(), randn(b, n, cq).bfloat16(), \
                randn(b, n, cv).bfloat16()
        do = randn(b, n, cv).bfloat16()
        o, lse = V.flash_fwd_lse(q, k, v, scale, h)
        args = (q, k, v, do, lse, V.compute_dcap(o, do, h), scale, h)
        out[f"flash_fwd_lse {name}"] = timed_ms(lambda: V.flash_fwd_lse(q, k, v, scale, h))
        out[f"flash_bwd_dq {name}"] = timed_ms(lambda: V.flash_bwd_dq(*args))
        out[f"flash_bwd_dkv {name}"] = timed_ms(lambda: V.flash_bwd_dkv(*args))
        out[f"bwd_form {name}"] = V.bwd_form(cq // h, cv // h, h, q.dtype)
    return out


def _eager() -> dict:
    """make_train_step's keywords for the eager step: a checkout before the
    compiled steps has no `graphs` and runs eagerly anyway."""
    import inspect

    from transparent_object_detection_tpu_torch.train.trainer import make_train_step

    return {"graphs": False} if "graphs" in inspect.signature(make_train_step).parameters else {}


def _train_batch(cfg, b: int, seed: int = 1) -> dict:
    """A synthetic batch like chip_smoke.py's: two boxes an image."""
    import numpy as np

    rng = np.random.default_rng(seed)
    boxes = np.zeros((b, 64, 4), np.float32)
    boxes[:, 0] = [0.5, 0.5, 0.4, 0.4]
    boxes[:, 1] = [0.25, 0.3, 0.2, 0.2]
    h, w = cfg.input_shape
    return {"image": torch.as_tensor(rng.uniform(size=(b, h, w, 3)).astype(np.float32),
                                     device="cuda"),
            "boxes": torch.as_tensor(boxes, device="cuda"),
            "labels": torch.zeros((b, 64), dtype=torch.long, device="cuda")}


def time_train_graphs(configs=TRAIN_GRAPHS, steps: int = 6) -> dict:
    """The train step eager against compiled (one captured CUDA graph a key,
    train/trainer.py), rounds E, G, G, E, on each configuration of
    TRAIN_GRAPHS (phi, remat, the batches tried, frozen): the first batch
    whose graph the program cache predicts to fit, then per round the
    key's warm-up (and, for G, its capture) before the clock, `steps` steps
    enqueued back to back and one host read of the last loss: ms a step and
    imgs/s on the host clock, a step's device ms on CUDA events (the median
    of 3 more); each G round's capture seconds, pool GiB and memory
    decision, the eager step's peak GiB."""
    import gc
    import time

    from transparent_object_detection_tpu_torch import inference as I
    from transparent_object_detection_tpu_torch.config import ModelConfig, TrainConfig
    from transparent_object_detection_tpu_torch.models.detector import build_model
    from transparent_object_detection_tpu_torch.train.optimizer import build_optimizer
    from transparent_object_detection_tpu_torch.train.trainer import (
        create_train_state,
        loss_config_from,
        make_train_step,
    )

    out = {}
    for label, kw, batches, frozen in configs:
        cfg = ModelConfig(**kw)
        tcfg = TrainConfig(max_boxes=64, optimizer_type="sgd", ema=True)
        model = build_model(cfg, device="cuda", seed=0)
        with torch.no_grad():  # as chip_smoke.py: dark3's attention gets a gradient
            model.backbone.dark3_attn.gamma.fill_(0.5)
        opt = build_optimizer(tcfg, model, freeze_backbone=frozen)
        state = create_train_state(model, opt)
        lc = loss_config_from(cfg, tcfg)
        lr = torch.tensor(1e-3, device="cuda")
        step_of = lambda graphs: make_train_step(model, opt, lc, tcfg, freeze_backbone=frozen,
                                                 graphs=graphs)
        decisions = {}
        for b in batches:  # the first batch whose graph fits
            I.release_programs(model)
            gc.collect()
            torch.cuda.empty_cache()
            step, batch = step_of(None), _train_batch(cfg, b)
            for _ in range(2):
                state, _ = step(state, batch, lr)
            (p,) = [p for p in I.programs_of(model) if p["entry"] == "trainer.train_step"]
            decisions[b] = {k: p[k] for k in ("eager", "predicted_bytes", "free_bytes",
                                               "peak_bytes")}
            if not p["eager"]:
                break
        rec = {"batch": b, "decisions": decisions, "rounds": []}
        for kind in ("E", "G", "G", "E"):
            I.release_programs(model)
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            step = step_of(None if kind == "G" else False)
            for _ in range(2 if kind == "G" else 1):
                state, comps = step(state, batch, lr)
            float(comps["loss"])
            t0 = time.perf_counter()
            for _ in range(steps):
                state, comps = step(state, batch, lr)
            float(comps["loss"])
            ms = (time.perf_counter() - t0) / steps * 1e3
            device = []
            for _ in range(3):
                start, end = (torch.cuda.Event(enable_timing=True),
                              torch.cuda.Event(enable_timing=True))
                start.record()
                state, comps = step(state, batch, lr)
                end.record()
                torch.cuda.synchronize()
                device.append(start.elapsed_time(end))
            r = {"kind": kind, "step_ms": ms, "imgs_per_s": b / ms * 1e3,
                 "device_ms": sorted(device)[1],
                 "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
            if kind == "G":
                (p,) = [p for p in I.programs_of(model) if p["entry"] == "trainer.train_step"]
                r.update(capture_s=p["capture_s"], pool_gib=p["pool_bytes"] / 2**30,
                         warm_up_peak_gib=p["peak_bytes"] / 2**30, replays=p["replays"])
            rec["rounds"].append(r)
        out[f"{label} batch {b}{' frozen' if frozen else ''}"] = rec
        print(json.dumps({"train_graphs": label, **rec}), flush=True)
        I.release_programs(model)
        del model, opt, state, step, batch
        gc.collect()
        torch.cuda.empty_cache()
    return out


def time_fit_graphs(train_images: int = 192) -> dict:
    """Trainer.fit eager against compiled, rounds E, G, G, E: chip_smoke.py's
    fit at phi='s' 640x640 bf16 (its synthetic set from seed 0, here with
    `train_images` training images so that an epoch holds 12 and 24 steps,
    a frozen epoch at batch 16 and an unfrozen one at batch 8, mosaic,
    mixup, its loader threads; no EvalCallback, no checkpoints), each round
    from the same weights: each epoch's training span (chip_smoke.LoaderClock:
    the first batch asked for to the validation loader's start), its imgs/s
    and its imgs/s past the first two steps (a compiled step's warm-up and
    capture), and the fit's seconds."""
    import tempfile
    import time
    from unittest import mock

    import chip_smoke as S
    from transparent_object_detection_tpu_torch import inference as I
    from transparent_object_detection_tpu_torch.config import ModelConfig, TrainConfig
    from transparent_object_detection_tpu_torch.data import loader as L
    from transparent_object_detection_tpu_torch.models.detector import build_model
    from transparent_object_detection_tpu_torch.train import trainer as T

    cfg = ModelConfig()
    tc = TrainConfig(seed=S.SEED, freeze_epoch=1, unfreeze_epoch=2,
                     freeze_batch_size=S.FIT_BATCHES[0], unfreeze_batch_size=S.FIT_BATCHES[1],
                     mosaic=True, mixup=True, num_workers=S.FIT_WORKERS)
    model = build_model(cfg, device="cuda", seed=S.SEED)
    with torch.no_grad():
        model.backbone.dark3_attn.gamma.fill_(0.5)
    weights = {k: v.clone() for k, v in model.state_dict().items()}
    rounds = []
    with tempfile.TemporaryDirectory(prefix="fit_graphs_") as root:
        train_lines, val_lines = S.write_fit_set(root, train_images=train_images)
        for kind in ("E", "G", "G", "E"):
            I.release_programs(model)
            torch.cuda.empty_cache()
            model.load_state_dict(weights)
            trainer = T.Trainer(cfg, tc, model=model, device="cuda", verbose=False)
            trainer.graphs = kind == "G"
            clock = S.LoaderClock(L.device_prefetch)
            t0 = time.perf_counter()
            with mock.patch.object(T, "device_prefetch", clock):
                history = trainer.fit(train_lines, val_lines)
            fit_s = time.perf_counter() - t0
            epochs = []
            for e, bs in enumerate(S.FIT_BATCHES):
                tr, va = clock.calls[2 * e], clock.calls[2 * e + 1]
                span = va["start"] - tr["start"]
                epochs.append({"batch": bs, "steps": len(tr["waits"]), "train_span_s": span,
                               "imgs_per_s": len(tr["waits"]) * bs / span,
                               "imgs_per_s_past_capture": S.steady_imgs_per_s(tr, va, bs),
                               "loader_wait_share": sum(tr["waits"]) / span,
                               "first_batch_wait_s": tr["waits"][0],
                               "loss": history[e]["loss"]})
            rounds.append({"kind": kind, "fit_s": fit_s, "epochs": epochs})
            print(json.dumps({"fit_graphs": rounds[-1]}), flush=True)
    return {"rounds": rounds}


def time_train_steps(configs=TRAIN_STEPS) -> dict:
    """ms of one eager training step (forward, loss, backward, SGD, EMA) of
    each configuration (default TRAIN_STEPS) on CUDA events: 1 warm-up, then
    the median of 3 steps."""
    import numpy as np

    from transparent_object_detection_tpu_torch.config import ModelConfig, TrainConfig
    from transparent_object_detection_tpu_torch.models.detector import build_model
    from transparent_object_detection_tpu_torch.train.optimizer import build_optimizer
    from transparent_object_detection_tpu_torch.train.trainer import (
        create_train_state,
        loss_config_from,
        make_train_step,
    )

    out = {}
    for label, kw, b in configs:
        cfg = ModelConfig(**kw)
        tcfg = TrainConfig(max_boxes=64, optimizer_type="sgd", ema=True)
        model = build_model(cfg, device="cuda", seed=0)
        with torch.no_grad():  # as chip_smoke.py: dark3's attention gets a gradient
            model.backbone.dark3_attn.gamma.fill_(0.5)
        opt = build_optimizer(tcfg, model)
        state = create_train_state(model, opt)
        step = make_train_step(model, opt, loss_config_from(cfg, tcfg), tcfg, **_eager())
        rng = np.random.default_rng(1)
        boxes = np.zeros((b, 64, 4), np.float32)
        boxes[:, 0] = [0.5, 0.5, 0.4, 0.4]
        boxes[:, 1] = [0.25, 0.3, 0.2, 0.2]
        h, w = cfg.input_shape
        batch = {"image": torch.as_tensor(rng.uniform(size=(b, h, w, 3)).astype(np.float32),
                                          device="cuda"),
                 "boxes": torch.as_tensor(boxes, device="cuda"),
                 "labels": torch.zeros((b, 64), dtype=torch.long, device="cuda")}
        times = []
        torch.cuda.reset_peak_memory_stats()
        for i in range(4):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            state, _ = step(state, batch, 1e-3)
            end.record()
            torch.cuda.synchronize()
            if i:
                times.append(start.elapsed_time(end))
        out[f"train step {label} batch {b}"] = sorted(times)[1]
        out[f"train step {label} batch {b} all"] = times
        out[f"train step {label} batch {b} peak GiB"] = torch.cuda.max_memory_allocated() / 2**30
        del model, opt, state, step, batch
        torch.cuda.empty_cache()
    return out


def _top_kernel(fn) -> str:
    """The kernel `fn` spends most of its device time in (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return max(kernels, key=lambda e: e.self_device_time_total).key


def time_f32_backward(randn, out) -> None:
    """ms of flash_bwd_dq and flash_bwd_dkv in fp32 at F32_BWD_SITES (packed
    heads as column views of one packed qkv; lse from flash_fwd_lse) beside
    SDPA's fp32 backward on the same operands (heads first, contiguous: the
    forward and backward less the forward) and the kernel that backward
    spends most of its device time in."""
    import torch.nn.functional as F

    for name, (b, n, cq, cv, h) in F32_BWD_SITES:
        scale = (cq // h) ** -0.5 if h > 1 else 1.0
        if h > 1:
            qkv = randn(b, n, 2 * cq + cv) * 0.5
            q, k, v = qkv[..., :cq], qkv[..., cq:2 * cq], qkv[..., 2 * cq:]
        else:
            q, k, v = randn(b, n, cq) * 0.5, randn(b, n, cq) * 0.5, randn(b, n, cv)
        do = randn(b, n, cv)
        o, lse = V.flash_fwd_lse(q, k, v, scale, h)
        args = (q, k, v, do, lse, V.compute_dcap(o, do, h), scale, h)
        out[f"row 10 {name}"] = timed_ms(lambda: V.flash_bwd_dq(*args), 10, 2)
        out[f"row 11 {name}"] = timed_ms(lambda: V.flash_bwd_dkv(*args), 10, 2)
        qh, kh, vh, doh = (A._heads_first(t, h).contiguous() for t in (q, k, v, do))
        qh, kh, vh = (t.requires_grad_() for t in (qh, kh, vh))
        fwd = timed_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=scale), 10, 2)
        both = timed_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=scale)
                        .backward(doh), 10, 2)
        out[f"rows 10-11 {name} sdpa backward"] = both - fwd
        res = F.scaled_dot_product_attention(qh, kh, vh, scale=scale)
        out[f"rows 10-11 {name} sdpa backward kernel"] = _top_kernel(
            lambda: res.backward(doh, retain_graph=True))
        del q, k, v, do, o, lse, args, qh, kh, vh, doh, res
        torch.cuda.empty_cache()


def time_f32(randn) -> dict:
    """ms of the fp32 forms of rows 1, 2 and 9 at F32_SITES beside SDPA's
    fp32 call on the same operands (heads first, contiguous) and the name of
    the kernel that call spends most of its device time in (torch.profiler),
    of rows 10 and 11 at F32_BWD_SITES (`time_f32_backward`), then of the
    fp32-compute phi='m' forward at batch 2 and the fp32 phi='n' training
    step at batch 16."""
    import torch.nn.functional as F

    from transparent_object_detection_tpu_torch.config import ModelConfig

    out = {}
    for name, entry, (b, n, cq, cv, h) in F32_SITES:
        scale = (cq // h) ** -0.5 if h > 1 else 1.0
        if h > 1:
            qkv = randn(b, n, 3 * cq)
            q, k, v = qkv[..., :cq], qkv[..., cq:2 * cq], qkv[..., 2 * cq:]
        else:
            q, k, v = randn(b, n, cq), randn(b, n, cq), randn(b, n, cv)
        if entry == "flash_mha_packed":
            run = lambda: A.flash_mha_packed(qkv, h, scale)
        elif entry == "flash_single":
            run = lambda: A.flash_single(q, k, v, scale)
        else:
            run = lambda: V.flash_fwd_lse(q, k, v, scale, h)
        out[name] = timed_ms(run, 10, 2)
        qh, kh, vh = (A._heads_first(t, h).contiguous() for t in (q, k, v))
        out[f"{name} sdpa"] = timed_ms(
            lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=scale), 10, 2)
        out[f"{name} sdpa kernel"] = _top_kernel(
            lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=scale))
        del q, k, v, qh, kh, vh
        torch.cuda.empty_cache()
    time_f32_backward(randn, out)
    from transparent_object_detection_tpu_torch.models.detector import build_model

    model = build_model(ModelConfig(phi="m", compute_dtype="float32"), device="cuda", seed=0)
    images = torch.rand(2, 640, 640, 3, device="cuda")
    times = []
    with torch.inference_mode():
        for i in range(4):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            model(images)
            end.record()
            torch.cuda.synchronize()
            if i:
                times.append(start.elapsed_time(end))
    out["forward fp32 phi=m batch 2"] = sorted(times)[1]
    out["forward fp32 phi=m batch 2 all"] = times
    del model
    torch.cuda.empty_cache()
    out.update(time_train_steps((("phi=n fp32", {"phi": "n", "compute_dtype": "float32"},
                                  16),)))
    return out


def time_forward() -> dict:
    """The phi='s' 640x640 forward of each configuration in FORWARDS: at
    batch 1 the host clock (median and mean of 100 synchronised calls after
    5 warm-ups) and the device's busy ms a call (torch.profiler over 10
    calls: the kernels' own time, which the host's pace does not move); at
    batch 32 ms on CUDA events."""
    import time

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from transparent_object_detection_tpu_torch.config import Int8Variants, ModelConfig
    from transparent_object_detection_tpu_torch.models.detector import build_model

    gen = torch.Generator(device="cuda").manual_seed(1)
    img32 = torch.rand(32, 640, 640, 3, generator=gen, device="cuda")  # (B, H, W, 3)
    img1 = img32[:1].contiguous()
    variants = {"int8": Int8Variants(), "A": Int8Variants(attn_handoff=True, w4a4_mlp1=True),
                "B": Int8Variants(attn_qout=True)}
    out = {}
    for tag in FORWARDS:
        int8 = tag != "bf16"
        model = build_model(ModelConfig(int8_dense=int8, int8_attn=int8), device="cuda", seed=0,
                            int8_variants=variants.get(tag, Int8Variants()))
        lat = []
        with torch.inference_mode():
            for i in range(105):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                model(img1)
                torch.cuda.synchronize()
                if i >= 5:
                    lat.append((time.perf_counter() - t0) * 1e3)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(10):
                    model(img1)
                torch.cuda.synchronize()
            b32 = timed_ms(lambda: model(img32), 5, 2)
        busy = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.key != "Command Buffer Full")
        key = "forward" if tag == "bf16" else f"forward_{tag}"
        out.update({f"{key}_batch1_ms_p50": sorted(lat)[len(lat) // 2],
                    f"{key}_batch1_ms_mean": sum(lat) / len(lat),
                    f"{key}_batch1_device_busy_ms": busy / 1e3 / 10,
                    f"{key}_batch32_ms": b32})
        del model
        torch.cuda.empty_cache()
    for tag in FORWARDS:  # phi='m' at batch 32
        int8 = tag != "bf16"
        model = build_model(ModelConfig(phi="m", int8_dense=int8, int8_attn=int8), device="cuda",
                            seed=0, int8_variants=variants.get(tag, Int8Variants()))
        with torch.inference_mode():
            out[f"forward{'' if tag == 'bf16' else '_' + tag}_phi_m_batch32_ms"] = timed_ms(
                lambda: model(img32), 3, 1)
        del model
        torch.cuda.empty_cache()
    return out


def device_kernels(fn, iters: int = 10) -> dict:
    """{kernel name: device ms a launch}: the kernels' time under
    torch.profiler over `iters` calls of fn, after a warm-up (for calls
    shorter than the host's time to enqueue them, which CUDA events would
    read), each over the launches the profiler recorded (late in a long run
    it may record only some of them)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / 1e3 / e.count for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.key != "Command Buffer Full" and e.count}


def device_ms(fn, iters: int = 10) -> float:
    return sum(device_kernels(fn, iters).values())


def _int8_values_bar(out, ref) -> float:
    """Bar use of an int8 attention value output against its plain version
    (chip_smoke.py's int8 value bar: 1e-2 |plain| + 1e-3 max|plain|)."""
    diff = (out.float() - ref.float()).abs()
    mag = ref.float().abs()
    return float((diff / (1e-2 * mag + 1e-3 * mag.max())).max())


def time_int8_dark3(randn) -> dict:
    """Row 3 at the INT8_DARK3 sites: the route's kernel at batch 2 and 1
    beside the three-product bound, then the sm90 forms of INT8_DARK3_FORMS
    (where this checkout has them), each held to the int8 value bar."""
    import inspect

    sliced = "slice_cols" in inspect.signature(A8.int8_sm90_plan).parameters
    out = {}
    for name, (b, n, dq, dv, bk, dt) in INT8_DARK3:
        q = (randn(b, n, dq) * 0.6).to(dt)
        k, v = (randn(b, n, dq) * 0.6).to(dt), randn(b, n, dv).to(dt)
        kq, ks = A8.quantize_kv(k, 1, bk)
        vq, vs = A8.quantize_kv(v, 1, bk)
        ref = A8.flash_mha_int8_plain(q, kq, ks, vq, vs, 1, 1.0)
        row = {"form": A8.int8_fwd_form(dq, dv)}
        got = A8.flash_mha_int8(q, kq, ks, vq, vs, 1, 1.0)
        row["bar_used"] = _int8_values_bar(got, ref)
        row["ms"] = timed_ms(lambda: A8.flash_mha_int8(q, kq, ks, vq, vs, 1, 1.0))
        row["ms_b1"] = timed_ms(
            lambda: A8.flash_mha_int8(q[:1], kq[:1], ks[:1], vq[:1], vs[:1], 1, 1.0))
        ops = 2.0 * b * n * n * (2 * dq + dv)
        nbytes = b * n * (dq * (q.element_size() + 1) + dv * (1 + q.element_size()))
        row["bound_ms"] = max(ops / PEAK_INT8_OPS, nbytes / PEAK_BYTES) * 1e3
        if sliced and row["form"] == "sm90":
            forms = {}
            for width in INT8_DARK3_FORMS[name]:
                plan = A8.int8_sm90_plan(dq, dv, n // bk, slice_cols=width)
                fn = lambda: A8._launch_sm90(q, None, kq, ks, vq, vs, 1, 1.0, dt, plan=plan)
                forms[f"slices of {width}"] = {
                    "bar_used": _int8_values_bar(fn(), ref), "ms": timed_ms(fn),
                    "plan": {key: plan[key] for key in ("rows", "keys", "split", "slices",
                                                        "stages", "v_stages")},
                    "bound_ms": max(2.0 * b * n * n * (2 * dq * plan["slices"] + dv)
                                    / PEAK_INT8_OPS, nbytes / PEAK_BYTES) * 1e3}
            row["forms"] = forms
        out[name] = row
    return out


def _int8_bar(out, ref) -> float:
    """Bar use of an int8 attention output against its plain version: the
    value bar, or for an int8 output its payload (+-1 on <= 1e-3 of the
    elements) and scales (1e-5 relative), as chip_smoke.py holds them."""
    if not isinstance(out, tuple):
        return _int8_values_bar(out, ref)
    diff = (out[0].int() - ref[0].int()).abs()
    flips = float((diff > 0).float().mean()) / 1e-3
    rel = float(((out[1] - ref[1]).abs() / ref[1].abs().clamp(min=1e-30)).max()) / 1e-5
    return max(flips, rel, float(diff.max()) if int(diff.max()) > 1 else 0.0)


def time_int8_wide(randn) -> dict:
    """Rows 3-5 at the INT8_LX sites, batch 2 and 1 (see the module's
    docstring)."""
    import torch.nn.functional as F

    out = {}
    for name, (n, cq, cv, h, bk) in INT8_LX:
        dq, dv = cq // h, cv // h
        scale = dq ** -0.5 if h > 1 else 1.0
        std = (4.0 / (scale * dq ** 0.5)) ** 0.5  # logits of std 4: peaked
        q, k = ((randn(2, n, cq) * std).bfloat16() for _ in range(2))
        v = randn(2, n, cv).bfloat16()
        kq, ks = A8.quantize_kv(k, h, bk)
        vq, vs = A8.quantize_kv(v, h, bk)
        entries = {"flash_mha_int8": (A8.flash_mha_int8, A8.flash_mha_int8_plain)}
        if h > 1:  # the neck heads: the int8-output entries too
            entries["flash_mha_int8_qout"] = (A8.flash_mha_int8_qout,
                                              A8.flash_mha_int8_qout_plain)
            payload, scales = QM._output_plain(torch.cat([q, k, v], -1).float(), None, 3 * cq,
                                               None)
            qs = A8.q_scale_table(scales, cq, h)
            hk = A8.requantize_section(payload, scales, cq, cq, h, bk)
            hv = A8.requantize_section(payload, scales, 2 * cq, cq, h, bk)
            entries["flash_int8_handoff"] = (
                lambda *a: A8.flash_int8_handoff(*a, True),
                lambda *a: A8.flash_int8_handoff_plain(*a, True))
        qh, kh, vh = (t.reshape(2, n, h, -1).transpose(1, 2) for t in (q, k, v))
        for bname, sl in (("batch 2", slice(None)), ("batch 1", slice(0, 1))):
            b = 2 if bname == "batch 2" else 1
            ops3 = 2.0 * b * h * n * n * (2 * dq + dv)
            ops2 = 2.0 * b * h * n * n * (dq + dv)
            nbytes = b * n * (cq * 3 + cv * 2)
            sdpa = timed_ms(lambda: F.scaled_dot_product_attention(
                qh[sl], kh[sl], vh[sl], scale=scale), 5, 1)
            for entry, (kernel, plain) in entries.items():
                args = ((payload[sl], qs[sl], hk[0][sl], hk[1][sl], hv[0][sl], hv[1][sl], h,
                         scale) if entry == "flash_int8_handoff"
                        else (q[sl], kq[sl], ks[sl], vq[sl], vs[sl], h, scale))
                got = kernel(*args)
                torch.cuda.synchronize()
                row = {"bar_used": _int8_bar(got, plain(*args)),
                       "ms": timed_ms(lambda: kernel(*args), 10, 2),
                       "bound_ms": max(ops3 / PEAK_INT8_OPS, nbytes / PEAK_BYTES) * 1e3,
                       "bound2_ms": max(ops2 / PEAK_INT8_OPS, nbytes / PEAK_BYTES) * 1e3,
                       "sdpa_bf16_ms": sdpa}
                if b == 2:
                    row["plain_ms"] = timed_ms(lambda: plain(*args), 1, 0)
                row["form"] = A8.int8_fwd_form(dq, dv, entry)  # this checkout's rule
                try:  # and plan, where it has the wide form
                    plan = A8.int8_sm90_plan(dq, dv, n // bk, int8_out=entry != "flash_mha_int8")
                    row["plan"] = {key: plan[key] for key in ("rows", "slices", "split",
                                                              "q_stream", "cluster", "stages")}
                except TypeError:  # a checkout before it: the template's sites
                    pass
                out[f"{entry} {name} {bname}"] = row
                print(json.dumps({f"{entry} {name} {bname}": row}), flush=True)
    return out


def _team_sweep(real, args) -> dict:
    """{"team x units": device ms} of quant_rows on args for each number of
    units a thread (1, 2, 4; 8 for bf16) with the smallest team of 8 to 256
    threads that covers the row, and streamed (0 units held) by teams of
    16, 32 and 64, the rule's pick replaced for the call."""
    x = args[0]
    k, size = x.shape[1], x.element_size()
    units = -(-k // QM.QR_UNIT) + (1 if k % QM.QR_UNIT else 0)
    rule = QM.quant_rows_team
    out = {}
    picks = [(next((t for t in (8, 16, 32, 64, 128, 256) if t * upt >= units), None), upt)
             for upt in (1, 2, 4) + ((8,) if size == 2 else ())]
    picks += [(team, 0) for team in (16, 32, 64)]  # streamed: each statistic read again
    for team, upt in picks:
        if team is None:
            continue
        QM.quant_rows_team = lambda k_, e_, pick=(team, upt): pick
        try:
            out[f"{team}x{upt}"] = device_ms(lambda: real(*args))
        finally:
            QM.quant_rows_team = rule
    return out


def time_quant_rows() -> dict:
    """quant_rows at every launch shape of one batch-2 forward of each of
    QUANT_ROWS_FORWARDS (recorded from the model's forward, then each
    shape's call repeated), held to the int8 bars against its plain
    version, beside its bytes bound; the forwards' sums by launch counts;
    and one launch at the phi='s' h2 qkv and phi='n' fp32 qkv shapes under
    torch.profiler (kernel name and device time)."""
    from transparent_object_detection_tpu_torch.config import Int8Variants, ModelConfig
    from transparent_object_detection_tpu_torch.models.detector import build_model

    gen = torch.Generator(device="cuda").manual_seed(1)
    real = QM.quant_rows
    out = {}
    variants = {"int8": Int8Variants(), "A": Int8Variants(attn_handoff=True, w4a4_mlp1=True)}
    for label, phi, dtype, tag in QUANT_ROWS_FORWARDS:
        model = build_model(ModelConfig(phi=phi, compute_dtype=dtype, int8_dense=True,
                                        int8_attn=True), device="cuda", seed=0,
                            int8_variants=variants[tag])
        calls = {}

        def recording(x, ln, eps=1e-6, qmax=127):
            key = f"M={x.shape[0]} K={x.shape[1]} {str(x.dtype)[6:]} ln={bool(ln)} qmax={qmax}"
            calls.setdefault(key, [0, (x, ln, eps, qmax)])[0] += 1
            return real(x, ln, eps, qmax)
        recording.launches = recording.launches_int4 = 0
        QM.quant_rows = recording
        try:
            with torch.inference_mode():
                model(torch.rand(2, 640, 640, 3, generator=gen, device="cuda"))
        finally:
            QM.quant_rows = real
        rows, sums = {}, {"ms": 0.0, "device_ms": 0.0, "bound_ms": 0.0}
        with torch.inference_mode():
            for key, (count, args) in calls.items():
                x = args[0]
                xq, xs = real(*args)
                pq, ps = QM.quant_rows_plain(*args)
                flips = (xq.int() - pq.int()).abs()
                row = {"launches": count, "max_step": int(flips.max()),
                       "flip_share": float((flips > 0).float().mean()),
                       "scale_rel": float(((xs - ps).abs() / ps.abs()).max()),
                       "ms": timed_ms(lambda: real(*args), 20, 3),
                       "device_ms": device_ms(lambda: real(*args)),
                       "bound_ms": (x.numel() * (x.element_size() + 1) + x.shape[0] * 4)
                       / PEAK_BYTES * 1e3}
                if hasattr(QM, "quant_rows_team"):  # the rule's team, and the others' device ms
                    row["team"] = QM.quant_rows_team(x.shape[1], x.element_size())
                    row["teams_device_ms"] = _team_sweep(real, args)
                rows[key] = row
                for name in sums:
                    sums[name] += count * row[name]
        out[label] = {"shapes": rows, "forward_sums_ms": sums,
                      "launches": sum(c for c, _ in calls.values())}
        del model, calls
        torch.cuda.empty_cache()
    profiles = {}
    for name, (m, k, dt) in (("phi=s h2 qkv", (12800, 1536, torch.bfloat16)),
                             ("phi=n fp32 h2 qkv", (12800, 768, torch.float32))):
        x = (torch.randn(m, k, generator=gen, device="cuda") * 2 + 0.5).to(dt)
        profiles[name] = {"kernels_ms": device_kernels(lambda: real(x, True)),
                          "bound_ms": (x.numel() * (x.element_size() + 1) + m * 4)
                          / PEAK_BYTES * 1e3}
    out["profile_one_launch"] = profiles
    return out


def _int_mm_yardstick(args):
    """torch._int_mm alone, and with qmm's epilogue in PyTorch ops (per-row
    x scales; the G > 1 requantize left out), on copies of xq and wq
    zero-padded to multiples of 8 where K or N is not one."""
    import torch.nn.functional as F

    xq, xs, wq, ws, bias, act, res = args[:7]
    k, n = xq.shape[1], wq.shape[0]
    k8, n8 = k + (-k % 8), n + (-n % 8)
    a = F.pad(xq, (0, k8 - k)) if k8 != k else xq
    b = F.pad(wq[:, :k8], (0, k8 - min(k8, wq.shape[1]), 0, n8 - n)).t()
    rs = xs if xs.shape[-1] == 1 else xs.amax(-1, keepdim=True)

    def with_epilogue():
        o = torch._int_mm(a, b)[:, :n].float() * rs * ws
        if bias is not None:
            o = o + bias
        if act == "gelu":
            o = F.gelu(o, approximate="tanh")
        if res is not None:
            o = o + res.float()
        return o.bfloat16()
    return timed_ms(lambda: torch._int_mm(a, b), 10, 2), timed_ms(with_epilogue, 10, 2)


def time_qmm() -> dict:
    """ms of qmm at every distinct launch shape of one int8 forward (phi
    and batches of QMM_FORWARDS), from the launches of the model's own
    forward: the call, its GEMM alone where it has a row pass, _int_mm
    alone and with the epilogue, the activations' pad copy where K % 16 !=
    0; and each forward's sums by launch counts."""
    import torch.nn.functional as F

    from transparent_object_detection_tpu_torch.config import ModelConfig
    from transparent_object_detection_tpu_torch.models.detector import build_model

    gen = torch.Generator(device="cuda").manual_seed(1)
    out = {}
    real = QM.qmm
    for phi, batches in QMM_FORWARDS:
        model = build_model(ModelConfig(phi=phi, int8_dense=True, int8_attn=True), device="cuda",
                            seed=0)
        for batch in batches:
            calls = {}

            def recording(*args):
                m, k = args[0].shape
                out = ("quant_out" if args[7] is not None else "ln_out" if args[8] is not None
                       else str(args[9])[6:])
                key = (f"M={m} K={k} N={args[2].shape[0]} G={args[1].shape[-1]} act={args[5]} "
                       f"res={None if args[6] is None else str(args[6].dtype)[6:]} out={out}")
                calls.setdefault(key, [0, args])[0] += 1
                return real(*args)
            recording.launches = 0
            QM.qmm = recording
            try:
                with torch.inference_mode():
                    model(torch.rand(batch, 640, 640, 3, generator=gen, device="cuda"))
            finally:
                QM.qmm = real
            rows, sums = {}, {}
            with torch.inference_mode():
                for key, (count, args) in calls.items():
                    row = {"launches": count, "ms": timed_ms(lambda: real(*args), 10, 2)}
                    if args[7] is not None or args[8] is not None:
                        row["gemm_ms"] = timed_ms(
                            lambda: real(*args[:7], None, None, torch.float32), 10, 2)
                        row["row_pass_ms"] = row["ms"] - row["gemm_ms"]
                    k = args[0].shape[1]
                    if k % 16:
                        row["x_pad_ms"] = timed_ms(lambda: F.pad(args[0], (0, -k % 16)), 10, 2)
                    row["int_mm_ms"], row["int_mm_epilogue_ms"] = _int_mm_yardstick(args)
                    rows[key] = row
                    for name, v in row.items():
                        if name != "launches":
                            sums[name] = sums.get(name, 0.0) + count * v
            out[f"phi={phi} batch {batch}"] = {"shapes": rows, "forward_sums_ms": sums,
                                               "launches": sum(c for c, _ in calls.values())}
            del calls
        del model
        torch.cuda.empty_cache()
    return out


def time_int8_attention(randn, name, b, n, c, h, out) -> None:
    """ms of rows 3-5 (flash_mha_int8, flash_mha_int8_qout, flash_int8_handoff
    with its int8 output) on one neck site at batch b and batch 1: q read
    in place from the packed qkv, k/v quantized per `pick_blocks` key block
    (the handoff's requantized from the int8 payload)."""
    scale = (c // h) ** -0.5
    bk = A8.pick_blocks(n, c, h)[1]
    qkv = randn(b, n, 3 * c).bfloat16()
    kq, ks = A8.quantize_kv(qkv[..., c:2 * c], h, bk)
    vq, vs = A8.quantize_kv(qkv[..., 2 * c:], h, bk)
    payload, scales = QM._output_plain(qkv.float(), None, 3 * c, None)
    qs = A8.q_scale_table(scales, c, h)
    hk = A8.requantize_section(payload, scales, c, c, h, bk)
    hv = A8.requantize_section(payload, scales, 2 * c, c, h, bk)
    for suffix, sl in (("", slice(None)), (" batch 1", slice(0, 1))):
        args = (qkv[sl].contiguous(), kq[sl], ks[sl], vq[sl], vs[sl], h, scale, c)
        hargs = (payload[sl], qs[sl], hk[0][sl], hk[1][sl], hv[0][sl], hv[1][sl], h, scale,
                 True)
        out[f"flash_mha_int8 {name}{suffix}"] = timed_ms(lambda: A8.flash_mha_int8(*args))
        out[f"flash_mha_int8_qout {name}{suffix}"] = timed_ms(
            lambda: A8.flash_mha_int8_qout(*args))
        out[f"flash_int8_handoff {name}{suffix}"] = timed_ms(
            lambda: A8.flash_int8_handoff(*hargs))


def _single_inputs(randn, b, n, dq, dv):
    """q, k, v of a one-head site, bf16, and its scale: dark3's 1.0, a folded
    head's (599 or 283 real columns, the rest zero) d ** -0.5."""
    real = {600: 599, 288: 283}.get(dq, dq)
    scale = 1.0 if dq == real else real ** -0.5
    q, k, v = randn(b, n, dq), randn(b, n, dq), randn(b, n, dv)
    for t in (q, k, v):
        t[..., real:] = 0
    return q.bfloat16(), k.bfloat16(), v.bfloat16(), scale


def _single_variant(dq: int, dv: int, wg_split: bool, q_resident: bool = True,
                    v_stages: int = 2, stages: int = 0) -> dict:
    """A plan of the sm90 kernel for one head of these widths other than the
    one-head form's own: the slices (Q resident as the packed layout of the
    widths rounded up to 64 has it) or the halves (Q resident or streamed),
    64-key tiles, `v_stages` V stages and `stages` K stages (0: the most
    that fit)."""
    r64 = lambda d: -(-d // 64) * 64
    plan = dict(A._sm90_layout(r64(dq), r64(dv), False)) if not wg_split else {
        "rows": 64, "keys": 64, "slab": 64, "v_slice": r64(-(-dv // 2)), "dv_splits": 1,
        "wg_split": 1, "q_resident": int(q_resident)}
    q_resident = bool(plan["q_resident"])
    plan.update(keys=64, v_stages=v_stages)
    plan["stages"] = stages or A._sm90_stages(dq, plan["v_slice"], q_resident, wg_split, 64,
                                              v_stages=v_stages)
    plan["smem_bytes"] = A.sm90_smem_bytes(dq, plan["v_slice"], plan["stages"], q_resident,
                                           wg_split, 64, v_stages)
    return plan


def time_single_forms(randn) -> dict:
    """ms of the one-head form's plan against the sm90 kernel's other forms
    at SINGLE_SITES (serving, batch 2): at dark3 (sliced) the split form
    where it fits and four V stages beside four K stages; at the folded
    heads (split) v in slices and, at 600 (Q resident beside one V stage),
    the split form with Q streamed beside two V stages. Each held to 1e-2
    of max|plain| first."""
    out = {}
    for name, (b, n, dq, dv) in SINGLE_SITES:
        q, k, v, scale = _single_inputs(randn, b, n, dq, dv)
        ref = A.flash_single_plain(q, k, v, scale).float()
        plans = {"plan": A.single_sm90_plan(dq, dv)}
        if plans["plan"]["wg_split"]:
            plans["sliced"] = _single_variant(dq, dv, False)
            if plans["plan"]["v_stages"] == 1:
                plans["split, Q streamed, 2 V stages"] = _single_variant(dq, dv, True, False)
        else:
            plans["sliced, 4 V stages, 4 K stages"] = _single_variant(dq, dv, False, v_stages=4,
                                                                       stages=4)
            if 256 < dv <= 512:
                plans["split"] = _single_variant(dq, dv, True)
        for form, plan in plans.items():
            run = lambda: A._launch_sm90_plan(q, k, v, 1, scale, None, plan)
            err = float((run().float() - ref).abs().max() / ref.abs().max())
            if err > 1e-2:
                raise RuntimeError(f"{form} plan at {name}: {err:.3g} of max|plain|")
            out[f"flash_single {name} {form}"] = timed_ms(run)
        del q, k, v, ref
        torch.cuda.empty_cache()
    return out


def time_wide_heads(randn) -> dict:
    """ms of the sm90 kernel's two forms for heads of 384 (phi='m' 640x640
    h2 and h4 at batch 2, h4 at batch 1), serving: the plan's (split) and
    the sliced one, each held to 1e-2 of max|plain| first; then the
    one-head form's alternatives (`time_single_forms`)."""
    out = {}
    for name, (b, n, c, h) in (("h2", (2, 6400, 3072, 8)), ("h4", (2, 1600, 3072, 8)),
                               ("h4 batch 1", (1, 1600, 3072, 8))):
        d, scale = c // h, (c // h) ** -0.5
        qkv = randn(b, n, 3 * c).bfloat16()
        views = (qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:])
        ref = A.flash_mha_packed_plain(qkv, h, scale).float()
        for form, plan in (("split", A.sm90_plan(d, d)), ("sliced", A._sm90_layout(d, d, False))):
            run = lambda: A._launch_sm90_plan(*views, h, scale, None, plan)
            err = float((run().float() - ref).abs().max() / ref.abs().max())
            if err > 1e-2:
                raise RuntimeError(f"{form} plan at phi=m {name}: {err:.3g} of max|plain|")
            out[f"flash_mha_packed phi=m {name} {form}"] = timed_ms(run)
    out.update(time_single_forms(randn))
    return out


GRAPH_CONFIGS = (("s", "bf16"), ("s", "int8"), ("s", "A"), ("s", "B"), ("m", "bf16"),
                 ("l", "bf16"))
GRAPH_VARIANTS = {"A": {"attn_handoff": True, "w4a4_mlp1": True}, "B": {"attn_qout": True}}


def set_class_biases(model, images, candidates: int) -> None:
    """Class biases so that about `candidates` anchors an image of `images`
    pass the 0.5 confidence (as a trained detector's few dozen would)."""
    with torch.no_grad():
        towers = [getattr(model.head, f"cls{i}") for i in range(3)]
        for t in towers:
            t.out.bias.zero_()
        logits = torch.logit(model(images)["decoded"][..., 4:].amax(-1), eps=1e-6).flatten()
        shift = float(logits.topk(candidates * images.shape[0]).values[-1])
        for t in towers:
            t.out.bias.fill_(-shift)


def _host_ms(fn, calls: int) -> list:
    import time

    out = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()["num_detections"].cpu()
        out.append((time.perf_counter() - t0) * 1e3)
    return sorted(out)


def time_graphs(phis=("s", "m", "l")) -> dict:
    """Eager against graphed serving (GRAPH_CONFIGS, rounds E, G, G, E), then
    nms_exact against its plain loop; see --graphs above."""
    import gc
    import time

    import numpy as np

    from transparent_object_detection_tpu_torch import inference as I
    from transparent_object_detection_tpu_torch.config import (
        Int8Variants,
        ModelConfig,
        PredictConfig,
    )
    from transparent_object_detection_tpu_torch.models.detector import build_model
    from transparent_object_detection_tpu_torch.ops.preprocess import letterbox_batch

    rng = np.random.default_rng(0)
    raws = {b: (rng.integers(0, 256, (b, 480, 640, 3), dtype=np.uint8),
                np.tile(np.array([[480, 640]], np.float32), (b, 1))) for b in (1, 32)}
    pcfg = PredictConfig()
    out = {}
    for phi, tag in [c for c in GRAPH_CONFIGS if c[0] in phis]:
        int8 = tag != "bf16"
        cfg = ModelConfig(phi=phi, int8_dense=int8, int8_attn=int8)
        model = build_model(cfg, device="cuda", seed=0, init_on_device=phi == "l",
                            int8_variants=Int8Variants(**GRAPH_VARIANTS.get(tag, {})))
        with torch.no_grad():
            model.backbone.dark3_attn.gamma.fill_(0.5)
        images = letterbox_batch(torch.as_tensor(raws[32][0][:4], device="cuda").float()
                                 / 255.0, cfg.input_shape)
        set_class_biases(model, images, 200 if int8 else 50)
        del images
        predictor = I.Predictor(model, cfg, pcfg, device="cuda")
        big, calls = 32, 2 if phi == "l" else 3

        def eager(b):
            raw, shapes = raws[b]
            with torch.inference_mode():
                return I.raw_detect_step(model, torch.as_tensor(raw, device="cuda"),
                                         torch.as_tensor(shapes, device="cuda"),
                                         cfg.input_shape, pcfg)

        rec = {"rounds": [], "captures": []}
        for kind in ("E", "G", "G", "E"):
            if kind == "E":  # the graphs and their pool gone: eager alone in memory
                I.release_programs(model)
                gc.collect()
                torch.cuda.empty_cache()
                call = eager
            else:
                call = lambda b: predictor.detect_raw_batch(*raws[b])
            # warm-up; for G the shape's eager call and its capture, the big
            # batch first: its eager call beside no pool, batch 1's capture in
            # the big batch's pool
            mem = {}
            for b in (big, 1):
                for i in range(2):
                    torch.cuda.reset_peak_memory_stats()
                    call(b)["num_detections"].cpu()
                    mem[b, i] = torch.cuda.max_memory_allocated() / 2**30
            if kind == "G":
                rec["captures"].append({p["key"][3][0][0][0]: {
                    "capture_s": p["capture_s"], "parts": p["parts"],
                    "pool_gib": p["pool_bytes"] / 2**30,
                    "warm_up_peak_gib": p["peak_bytes"] / 2**30,
                    "eager_peak_gib": mem[p["key"][3][0][0][0], 0],
                    "capture_peak_gib": mem[p["key"][3][0][0][0], 1]}
                    for p in I.programs_of(model)})
            lat = _host_ms(lambda: call(1), 40)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                call(big)["num_detections"].cpu()
            rec["rounds"].append({"kind": kind, "batch1_ms_p50": lat[20], "batch1_ms_p75": lat[30],
                                  "batch1_ms_min": lat[0],
                                  f"batch{big}_imgs_per_s": big * calls / (time.perf_counter()
                                                                           - t0)})
        t0 = time.perf_counter()
        for _ in range(100):
            modules = I._traced(model)[1]
            modules.traced(), modules.fingerprint()
        rec["fingerprint_us"] = (time.perf_counter() - t0) / 100 * 1e6
        rec["weights_gib"] = sum(t.numel() * t.element_size() for t in
                                 [*model.parameters(), *model.buffers()]) / 2**30
        rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        out[f"phi={phi} {tag}"] = rec
        print(json.dumps({"graphs": f"phi={phi} {tag}", **rec}), flush=True)
        I.release_programs(model)
        del model, predictor
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    out["nms_exact"] = time_nms_exact()
    return out


def time_nms_exact() -> dict:
    """nms_exact against its plain loop at K = 1,024, every candidate valid
    (boxes of 10-80 px in 300 px), batch 1 and 32: CUDA events, the kernel's
    device time, the bytes bound (the IoU triangle of the valid rows, valid
    and keep) and B x K^2 x 4 bytes beside it."""
    from transparent_object_detection_tpu_torch.ops import nms as N
    from transparent_object_detection_tpu_torch.ops.geometry import pairwise_iou

    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for b in (1, 32):
        k = 1024
        xy = torch.rand(b, k, 2, generator=gen, device="cuda") * 300
        wh = 10 + torch.rand(b, k, 2, generator=gen, device="cuda") * 70
        boxes = torch.cat([xy, xy + wh], dim=-1)
        iou = pairwise_iou(boxes, boxes).contiguous()
        valid = torch.ones(b, k, dtype=torch.bool, device="cuda")
        keep = N.nms_exact(iou, valid, 0.4)
        assert torch.equal(keep, N.nms_exact_plain(iou, valid, 0.4))
        need = b * (k * (k - 1) // 2 * 4 + 2 * k)
        out[b] = {"ms": timed_ms(lambda: N.nms_exact(iou, valid, 0.4)),
                  "device_ms": device_ms(lambda: N.nms_exact(iou, valid, 0.4)),
                  "plain_ms": timed_ms(lambda: N.nms_exact_plain(iou, valid, 0.4), 3, 1),
                  "bound_ms": need / PEAK_BYTES * 1e3,
                  "bound_full_iou_ms": b * (k * k * 4 + 2 * k) / PEAK_BYTES * 1e3,
                  "kept": int(keep.sum())}
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("time_serving: no CUDA device", file=sys.stderr)
        return 1
    _build.build(_build.all_sources())
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    gen = torch.Generator(device="cuda").manual_seed(0)
    randn = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    result = {"checkout": str(ROOT), "card": card}
    if "--graphs" in sys.argv[1:]:
        phis = [a for a in sys.argv[1:] if a in ("s", "m", "l")]
        print(json.dumps({**result, "graphs": time_graphs(phis or ("s", "m", "l"))}))
        return 0
    if "--forward" in sys.argv[1:]:
        print(json.dumps({**result, "forward": time_forward()}))
        return 0
    if "--wide-heads" in sys.argv[1:]:
        print(json.dumps({**result, "ms": time_wide_heads(randn)}))
        return 0
    if "--train-graphs" in sys.argv[1:]:
        out = {"train_graphs": time_train_graphs()}
        if "--fit" in sys.argv[1:]:
            out["fit"] = time_fit_graphs()
        print(json.dumps({**result, **out}))
        return 0
    if "--train-step" in sys.argv[1:]:
        print(json.dumps({**result, "ms": time_train_steps()}))
        return 0
    if "--qmm" in sys.argv[1:]:
        print(json.dumps({**result, "qmm": time_qmm()}))
        return 0
    if "--wide-bwd" in sys.argv[1:]:
        print(json.dumps({**result, "wide_bwd": time_wide_bwd(randn)}))
        return 0
    if "--int8-wide" in sys.argv[1:]:
        print(json.dumps({**result, "int8_wide": time_int8_wide(randn)}))
        return 0
    if "--int8" in sys.argv[1:]:
        print(json.dumps({**result, "int8_dark3": time_int8_dark3(randn),
                          "quant_rows": time_quant_rows()}))
        return 0
    if "--f32" in sys.argv[1:]:
        # fp32 as chip_smoke.py runs it: no TF32 in SDPA, matmuls or convolutions
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print(json.dumps({**result, "ms": time_f32(randn)}))
        return 0
    training = time_training_kernels(randn)
    out = {}
    for name, (b, n, c, h) in NECK:
        scale = (c // h) ** -0.5
        qkv = randn(b, n, 3 * c).bfloat16()
        one = qkv[:1].contiguous()
        out[f"flash_mha_packed {name}"] = timed_ms(lambda: A.flash_mha_packed(qkv, h, scale))
        out[f"flash_mha_packed {name} batch 1"] = timed_ms(
            lambda: A.flash_mha_packed(one, h, scale))
        time_int8_attention(randn, name, b, n, c, h, out)
    for name, (b, n, c, h) in INT8_WIDE:
        time_int8_attention(randn, name, b, n, c, h, out)
    for name, (b, n, dq, dv) in SINGLE_SITES:  # row 2 at its one-head sites
        q, k, v, scale = _single_inputs(randn, b, n, dq, dv)
        out[f"flash_single {name}"] = timed_ms(lambda: A.flash_single(q, k, v, scale))
        half = slice(0, b // 2)
        out[f"flash_single {name} batch 1"] = timed_ms(
            lambda: A.flash_single(q[half], k[half], v[half], scale))
    q, k = randn(2, 6400, 64).bfloat16(), randn(2, 6400, 64).bfloat16()
    v = randn(2, 6400, 512).bfloat16()
    kq, ks = A8.quantize_kv(k, 1, 6400)
    vq, vs = A8.quantize_kv(v, 1, 6400)
    out["flash_mha_int8 dark3"] = timed_ms(lambda: A8.flash_mha_int8(q, kq, ks, vq, vs, 1, 1.0))
    out["flash_mha_int8 dark3 batch 1"] = timed_ms(
        lambda: A8.flash_mha_int8(q[:1], kq[:1], ks[:1], vq[:1], vs[:1], 1, 1.0))
    x = randn(12800, 1536).bfloat16()
    w = QM.prepare_weights(randn(4608, 1536) / 1536 ** 0.5, randn(4608) * 0.1)
    xq, xs = QM.quant_rows(x, True)
    out["quant_rows h2 qkv"] = timed_ms(lambda: QM.quant_rows(x, True))
    out["qmm h2 qkv"] = timed_ms(lambda: QM.qmm(xq, xs, w["wq"], w["w_scale"], w["bias"]))
    print(json.dumps({**result, "ms": out, "training_ms": training}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
