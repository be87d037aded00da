"""Time the serving kernels (rows 1-8) and the training kernels (rows 9-11:
flash_fwd_lse, flash_bwd_dq, flash_bwd_dkv, `time_training_kernels`) of
this checkout at the phi='s' 640x640 shapes, batch 2 (the packed sites and
the int8 attention entry points, rows 3-5, also at batch 1; rows 3-5 and
9-11 also at phi='m' h2 and h4, 8 heads of 384; rows 9-11 also at the
one-head sites of phi='m' and 'n': dark3 and the folded h1), on one GPU;
prints one JSON line (ms per call, CUDA events, 20 calls after 3 warm-ups).

    python3 transparent_object_detection_tpu_torch/kernels/time_serving.py \
        [--forward | --wide-heads | --train-step | --f32 | --qmm]

With --forward it times only the phi='s' 640x640 FocusModel forward
(seeded weights) in bf16, int8 (int8_dense + int8_attn) and the int8
TEB's configurations A (attn_handoff + w4a4_mlp1) and B (attn_qout):
batch 1 on the host clock (the latency path) and by the device's busy
time, batch 32 with CUDA events; then the phi='m' int8 forward at batch 32.
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
across blocks, S recomputed per slice), each held to 1e-2 of max|plain|.
With --train-step it times only two training steps of `make_train_step`
(SGD nesterov, EMA; seeded weights, synthetic batches like chip_smoke.py's):
phi='s' 640x640 at batch 16 and phi='m' 640x640 with remat at batch 16,
each on CUDA events, the median of 3 steps after 1 warm-up.
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
# the --train-step configurations: (label, ModelConfig keywords, batch)
TRAIN_STEPS = (("phi=s", {}, 16), ("phi=m remat", {"phi": "m", "remat": True}, 16))
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


def time_train_steps(configs=TRAIN_STEPS) -> dict:
    """ms of one training step (forward, loss, backward, SGD, EMA) of each
    configuration (default TRAIN_STEPS) on CUDA events: 1 warm-up, then the
    median of 3 steps."""
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
        step = make_train_step(model, opt, loss_config_from(cfg, tcfg), tcfg)
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
    model = build_model(ModelConfig(phi="m", int8_dense=True, int8_attn=True), device="cuda",
                        seed=0)
    with torch.inference_mode():
        out["forward_int8_phi_m_batch32_ms"] = timed_ms(lambda: model(img32), 3, 1)
    del model
    torch.cuda.empty_cache()
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


def time_wide_heads(randn) -> dict:
    """ms of the sm90 kernel's two forms for heads of 384 (phi='m' 640x640
    h2 and h4 at batch 2, h4 at batch 1), serving: the plan's (split) and
    the sliced one, each held to 1e-2 of max|plain| first."""
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
    if "--forward" in sys.argv[1:]:
        print(json.dumps({**result, "forward": time_forward()}))
        return 0
    if "--wide-heads" in sys.argv[1:]:
        print(json.dumps({**result, "ms": time_wide_heads(randn)}))
        return 0
    if "--train-step" in sys.argv[1:]:
        print(json.dumps({**result, "ms": time_train_steps()}))
        return 0
    if "--qmm" in sys.argv[1:]:
        print(json.dumps({**result, "qmm": time_qmm()}))
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
    q, k = randn(2, 6400, 64).bfloat16(), randn(2, 6400, 64).bfloat16()
    v = randn(2, 6400, 512).bfloat16()
    kq, ks = A8.quantize_kv(k, 1, 6400)
    vq, vs = A8.quantize_kv(v, 1, 6400)
    out["flash_single dark3"] = timed_ms(lambda: A.flash_single(q, k, v, 1.0))
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
