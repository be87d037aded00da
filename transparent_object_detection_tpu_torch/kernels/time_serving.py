"""Time the serving kernels (rows 1-8) and the training kernels (rows 9-11:
flash_fwd_lse, flash_bwd_dq, flash_bwd_dkv, `time_training_kernels`) of
this checkout at the phi='s' 640x640 shapes, batch 2 (the packed sites and
the int8 attention entry points, rows 3-5, also at batch 1; rows 3-5 and
9-11 also at phi='m' h2 and h4, 8 heads of 384), on one GPU; prints one
JSON line (ms per call, CUDA events, 20 calls after 3 warm-ups).

    python3 transparent_object_detection_tpu_torch/kernels/time_serving.py \
        [--forward | --wide-heads | --train-step]

With --forward it times only the phi='s' 640x640 FocusModel forward
(seeded weights) in bf16, int8 (int8_dense + int8_attn) and the int8
TEB's configurations A (attn_handoff + w4a4_mlp1) and B (attn_qout):
batch 1 on the host clock (the latency path) and by the device's busy
time, batch 32 with CUDA events. With --wide-heads
it times only the two forms csrc/flash_fwd_sm90.cu has for heads wider
than 256, at phi='m' (8 heads of 384): the warpgroup split that
`attention.sm90_plan` picks and the sliced form (v in two slices of 192
across blocks, S recomputed per slice), each held to 1e-2 of max|plain|.
With --train-step it times only two training steps of `make_train_step`
(SGD nesterov, EMA; seeded weights, synthetic batches like chip_smoke.py's):
phi='s' 640x640 at batch 16 and phi='m' 640x640 with remat at batch 16,
each on CUDA events, the median of 3 steps after 1 warm-up.

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
# (name, (batch, tokens, q/k width, v width, heads)) of the phi='s' training sites
TRAIN_SITES = (("h1", (2, 1600, 2048, 2048, 8)), ("h2", (2, 6400, 1536, 1536, 6)),
               ("h4", (2, 1600, 1536, 1536, 6)), ("dark3", (2, 6400, 64, 512, 1)),
               ("phi=m h2", (2, 6400, 3072, 3072, 8)), ("phi=m h4", (2, 1600, 3072, 3072, 8)))
# the --train-step configurations: (label, ModelConfig keywords, batch)
TRAIN_STEPS = (("phi=s", {}, 16), ("phi=m remat", {"phi": "m", "remat": True}, 16))


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
    """ms of flash_fwd_lse, flash_bwd_dq and flash_bwd_dkv at each phi='s'
    training site (q/k/v as column views of one packed qkv for the neck)."""
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
    return out


def time_train_steps() -> dict:
    """ms of one training step (forward, loss, backward, SGD, EMA) of each
    TRAIN_STEPS configuration on CUDA events: 1 warm-up, then the median of
    3 steps."""
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
    for label, kw, b in TRAIN_STEPS:
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
        del model, opt, state, step, batch
        torch.cuda.empty_cache()
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
