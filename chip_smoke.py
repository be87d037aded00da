#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

1. Builds every kernel in transparent_object_detection_tpu_torch/csrc/ with
   nvcc (all sources at once) and prints the card's name and power limit.
2. Kernel phase: holds each flash-attention kernel against its plain PyTorch
   version on the card, in bf16, at the shapes the phi='s' 640x640 serving
   forward gives it (batch 2) and at a ragged N, with near-flat (score std 1)
   and peaked (score std 4) inputs. An element passes when
   |kernel - plain| <= RTOL * |plain| + ATOL_OF_MAX * max|plain|, a bar set
   from the output's own scale; the same bar must reject the plain version
   with a planted fault (one kv tile of 64 keys left out, or the softmax
   scale 2% off), else the check would be blind to such a kernel. Times
   kernel, plain version, and as a yardstick only
   F.scaled_dot_product_attention (which the port never calls).
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
   quant_out group width (qmm), p rounded against a running 64-key max and
   k/v scales per 64 keys (flash_mha_int8).
5. int8 slice phase: the same weights as ModelConfig(int8_dense=True,
   int8_attn=True) through Predictor.detect_raw_batch with all five counts
   reset before and read after; `decoded` and detection sets against the
   same model on plain versions (limits between the sound reading and a
   planted fault's); every launch of one batch-2 forward against its plain
   version, timed beside its bound and a library yardstick; launches per
   forward at batch 1 and 32; timings beside the bf16 run's; a profile.
6. Prints a JSON line of the five kernels, the card's name and power limit,
   then {"ok": true, "device": ...} last.

Any failed check exits non-zero before the last line. TF32 is off for
matmuls and convolutions wherever numbers are compared.
"""
from __future__ import annotations

import contextlib
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


@contextlib.contextmanager
def planted(fault: str):
    """The plain attention versions with a planted fault: what a kernel that
    made that mistake would return."""
    from transparent_object_detection_tpu_torch.ops import attention as A

    real = A._online_softmax_attention
    A._online_softmax_attention = PLANTED_FAULTS[fault](real)
    try:
        yield
    finally:
        A._online_softmax_attention = real


def hold_against_plain(kernel, plain, what: str, faults_must_fail: bool = True) -> dict:
    """Kernel output against its plain version, and the plain version with
    each planted fault against the same bar (which, on synthetic inputs,
    must reject every fault)."""
    import torch

    out, ref = kernel(), plain()
    torch.cuda.synchronize()
    check(bool(torch.isfinite(out.float()).all()), f"{what}: non-finite output")
    diff = float((out.float() - ref.float()).abs().max())
    ref_max = float(ref.float().abs().max())
    reading = {"max_abs_err": diff, "max_rel_err": diff / ref_max, "ref_max_abs": ref_max,
               "bar_used": bar_used(out, ref), "fault_bar_used": {}}
    for fault in PLANTED_FAULTS:
        with planted(fault):
            reading["fault_bar_used"][fault] = bar_used(plain(), ref)
    print(json.dumps({"check": what, **reading}), flush=True)
    check(reading["bar_used"] <= 1.0,
          f"{what}: kernel off by {reading['bar_used']:.3g}x the bar "
          f"{RTOL}*|plain| + {ATOL_OF_MAX}*max|plain| (max abs {diff})")
    for fault, used in reading["fault_bar_used"].items():
        check(used > 1.0 or not faults_must_fail,
              f"{what}: the bar does not reject the planted fault {fault} ({used:.3g}x the bar)")
    return reading


def kernel_phase():
    import torch
    import torch.nn.functional as F

    from transparent_object_detection_tpu_torch.ops import attention as A

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    randn = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    # std of q and k for softmax logits of std `score_std`: scale^2 * d * std^4
    qk_std = lambda score_std, scale, d: (score_std / (scale * d ** 0.5)) ** 0.5
    mha_rows, single_rows = [], []

    # packed multi-head: (B, N, C, heads); neck h1, h2, h4 at 640x640, then ragged
    for name, (b, n, c, h) in (("h1", (2, 1600, 2048, 8)), ("h2", (2, 6400, 1536, 6)),
                               ("h4", (2, 1600, 1536, 6)), ("ragged", (2, 3600, 1536, 6))):
        scale = (c // h) ** -0.5
        readings = []
        for score_std in SCORE_STDS:
            qkv = randn(b, n, 3 * c)
            qkv[..., :2 * c] *= qk_std(score_std, scale, c // h)
            qkv = qkv.to(torch.bfloat16)
            readings.append({"score_std": score_std, **hold_against_plain(
                lambda: A.flash_mha_packed(qkv, h, scale),
                lambda: A.flash_mha_packed_plain(qkv, h, scale),
                f"flash_mha_packed {name} score_std {score_std}")})
        q, k, v = (A._heads_first(t, h).contiguous() for t in qkv.chunk(3, dim=-1))
        flops = 2.0 * b * n * n * (c + c)
        bnd, by = bound_ms(flops, 2.0 * (b * n * 3 * c + b * n * c))
        mha_rows.append(dict(
            node=name, b=b, n=n, c=c, heads=h, readings=readings,
            ms=timed_ms(lambda: A.flash_mha_packed(qkv, h, scale), 20),
            plain_ms=timed_ms(lambda: A.flash_mha_packed_plain(qkv, h, scale), 3, 1),
            library_ms=timed_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=scale), 20),
            bound_ms=bnd, bound_by=by,
        ))
        print(json.dumps({"kernel": "flash_mha_packed", **mha_rows[-1]}), flush=True)

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
    forward's worth of this kernel's launches at batch 2), the ragged shape
    kept in `shapes` and in the error."""
    main = [r for r in rows if r["node"] != "ragged"]
    total = lambda key: sum(r[key] for r in main)
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches,
        "max_abs_err": max(x["max_abs_err"] for r in rows for x in r["readings"]),
        "ms": total("ms"), "plain_ms": total("plain_ms"), "bound_ms": total("bound_ms"),
        "bound_by": "operations" if all(r["bound_by"] == "operations" for r in main) else "bytes",
        "library_ms": total("library_ms"), "shapes": rows,
    }


KERNEL_CLASSES = (  # first match wins: convolutions run as implicit GEMMs
    ("flash attention (ours)", ("flash_fwd_kernel",)),
    ("int8 flash attention (ours)", ("flash_int8_kernel",)),
    ("int8 GEMM (ours)", ("qmm_kernel", "rows_out_kernel")),
    ("int8 row quantize (ours)", ("quant_rows_kernel",)),
    ("batch/layer norm", ("bn_fw", "batch_norm", "layer_norm")),
    ("convolution", ("conv", "implicit", "winograd", "fprop", "dgrad")),
    ("matmul", ("gemm", "xmma", "cutlass", "nvjet", "Kernel2")),
    ("reduction", ("reduce", "softmax")),
    ("elementwise and copies", ("elementwise", "vectorized", "unrolled", "copy", "fill",
                                "cat", "Memcpy", "Memset")),
)


def profile_forward(model, images) -> dict:
    """Device time of one forward by kernel class and the top kernels, from
    torch.profiler, and the device's idle share of the forward's wall time
    (profiler overhead included)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model(images)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device kernels only: the aten:: operator rows repeat their kernels' time
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count)
               for e in prof.key_averages()
               if e.self_device_time_total > 0 and not e.key.startswith("aten::")]
    busy = sum(t for _, t, _ in kernels)
    classes = {}
    for name, t, _ in kernels:
        cls = next((c for c, keys in KERNEL_CLASSES
                    if any(k.lower() in name.lower() for k in keys)), "other")
        classes[cls] = classes.get(cls, 0.0) + t
    top = sorted(kernels, key=lambda r: -r[1])[:12]
    reading = {"profile_batch": int(images.shape[0]), "wall_ms": wall_ms,
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
                "flash_single": A.flash_single.launches}
    print(json.dumps({"main_path_launches": launches}), flush=True)
    check(launches == {"flash_mha_packed": 3, "flash_single": 1},
          f"expected 3 packed and 1 single-head launch per forward, got {launches}")
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
        launch.launches = 0  # the wrapper counts on the name it is bound to
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
# SCALE_RTOL relative. Values (bf16): |diff| <= RTOL8 * |plain| + ATOL8_OF_MAX
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


def _component_reading(out, ref) -> dict:
    """Bar use (<= 1 passes) of one output component against its plain
    version: int8 payload, f32 scales or bf16 values."""
    import torch

    check(tuple(out.shape) == tuple(ref.shape),
          f"shape {tuple(out.shape)} against the plain version's {tuple(ref.shape)}")
    if out.dtype == torch.int8:
        diff = (out.int() - ref.int()).abs()
        share = float((diff > 0).float().mean())
        return {"kind": "payload", "max_step": int(diff.max()), "flip_share": share,
                "bar_used": max(float(diff.max()) / 1.0 if int(diff.max()) > 1 else 0.0,
                                share / PAYLOAD_FLIP_SHARE)}
    if out.dtype == torch.float32:
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

    outs = out if isinstance(out, tuple) else (out,)
    refs = ref if isinstance(ref, tuple) else (ref,)
    parts = [_component_reading(o, r) for o, r in zip(outs, refs)]
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


QMM_FAULTS = {"qmm_k_slab_dropped": _k_slab_dropped, "qmm_group_width_halved": _group_halved}


def int8_attention_reference(q, k, v, heads, scale, scale_tile, max_tile):
    """The int8 attention function with the k/v scales taken per
    `scale_tile` keys and p rounded against the running maximum over
    `max_tile`-key tiles (float64 sums). At scale_tile = max_tile = bk it is
    the plain version's function; smaller tiles plant the two faults a
    tiled kernel could make."""
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
        outs.append((acc / l.double()).to(q.dtype))
    return torch.stack(outs).transpose(1, 2).reshape(b, n, -1)


def _qmm_case(name, x, xs, m, k, n, groups, act, residual, group=None, ln_out=False, ln=None):
    """One synthetic qmm (and, for bf16 x, quant_rows) check with faults."""
    import torch

    from transparent_object_detection_tpu_torch.ops import quant_matmul as QM

    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    w = torch.randn(n, k, generator=gen, device=DEVICE) / k ** 0.5
    bias = torch.randn(n, generator=gen, device=DEVICE) * 0.1
    wts = QM.prepare_weights(w, bias)
    res = (torch.randn(m, n, generator=gen, device=DEVICE).bfloat16() if residual else None)
    readings = {}
    if ln is not None:  # bf16 rows: quant_rows first
        xq, xsk = QM.quant_rows(x, ln)
        xq_p, xs_p = QM.quant_rows_plain(x, ln)
        readings["quant_rows"] = int8_reading((xq, xsk), (xq_p, xs_p))
        check(readings["quant_rows"]["bar_used"] <= 1.0, f"quant_rows {name}: {readings}")
        x, xs = xq_p, xs_p
    eps = 1e-6 if ln_out else None
    kern = lambda: QM.qmm(x, xs, wts["wq"], wts["w_scale"], wts["bias"], act, res, group, eps)
    plain = lambda: QM.qmm_plain(x, xs, wts["wq"], wts["w_scale"], wts["bias"], act, res, group,
                                 eps)
    out = kern()
    torch.cuda.synchronize()
    ref = plain()
    readings["qmm"] = int8_reading(out, ref)
    faults = {}
    for fault, plant in QMM_FAULTS.items():
        if fault == "qmm_group_width_halved" and group is None:
            continue
        with plant(QM):
            faults[fault] = int8_reading(plain(), ref)["bar_used"]
    readings["qmm_faults_bar_used"] = faults
    print(json.dumps({"check": f"qmm {name}", "m": m, "k": k, "n": n, "groups": groups,
                      "act": act, "residual": residual, "group": group, "ln_out": ln_out,
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
        rejected = {f: False for f in faults}
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
            out = A8.flash_mha_int8(q, kq, ks, vq, vs, h, scale, q_width)
            torch.cuda.synchronize()
            ref = A8.flash_mha_int8_plain(q, kq, ks, vq, vs, h, scale, q_width)
            qc = q[..., :cq]
            reading = int8_reading(out, ref)
            reading["reference_bar_used"] = int8_reading(
                int8_attention_reference(qc, k, v, h, scale, bk, bk), ref)["bar_used"]
            reading["faults_bar_used"] = {
                f: int8_reading(fn(qc, k, v, h, scale, bk), ref)["bar_used"]
                for f, fn in faults.items()}
            for f, used in reading["faults_bar_used"].items():
                rejected[f] |= used > 1.0
            print(json.dumps({"check": f"flash_mha_int8 {name} score_std {score_std}",
                              "b": b, "n": n, "cq": cq, "cv": cv, "heads": h, "bk": bk,
                              **reading}), flush=True)
            check(reading["bar_used"] <= 1.0, f"flash_mha_int8 {name}: off the bar {reading}")
            check(reading["reference_bar_used"] <= 1.0,
                  f"flash_mha_int8 {name}: the fault reference is not the plain function")
            err["flash_mha_int8"] = max(err["flash_mha_int8"], reading["max_abs_err"])
        for f, ok in rejected.items():
            check(ok, f"flash_mha_int8 {name}: the bar rejects {f} on no input spread")
    # several key blocks (pick_blocks gives bk < N past 6,400 tokens): the
    # kernel's variant with the fp32 acc in shared memory, at h2's widths
    n, h, cq = 6400 // shrink, 6, 1536
    bk = n // 4
    qkv = randn(1, n, 3 * cq)
    qkv[..., :2 * cq] *= qk_std(4.0, (cq // h) ** -0.5, cq // h)
    qkv = qkv.bfloat16()
    kq, ks = A8.quantize_kv(qkv[..., cq:2 * cq], h, bk)
    vq, vs = A8.quantize_kv(qkv[..., 2 * cq:], h, bk)
    args = (qkv, kq, ks, vq, vs, h, (cq // h) ** -0.5, cq)
    out = A8.flash_mha_int8(*args)
    torch.cuda.synchronize()
    reading = int8_reading(out, A8.flash_mha_int8_plain(*args))
    print(json.dumps({"check": "flash_mha_int8 h2 widths, 4 key blocks", "n": n, "bk": bk,
                      **reading}), flush=True)
    check(reading["bar_used"] <= 1.0, f"flash_mha_int8 with 4 key blocks: {reading}")
    return err


def _qmm_cost(args, out):
    """(operations, bytes) of one qmm call: each input read once, each
    output written once."""
    xq, xs, wq, ws, bias, act, res = args[:7]
    m, k = xq.shape
    n = wq.shape[0]
    outs = out if isinstance(out, tuple) else (out,)
    nbytes = (xq.numel() + xs.numel() * 4 + wq.numel() + ws.numel() * 4
              + (0 if bias is None else n * 4) + (0 if res is None else res.numel() * 2)
              + sum(o.numel() * o.element_size() for o in outs))
    return 2.0 * m * k * n, nbytes


def _library_qmm(args):
    """One torch._int_mm (cuBLASLt int8 GEMM) plus the epilogue in PyTorch
    ops: the yardstick of qmm (per-row x scales; the G > 1 requantize is
    left out)."""
    import torch
    import torch.nn.functional as F

    xq, xs, wq, ws, bias, act, res = args[:7]
    rs = xs if xs.shape[-1] == 1 else xs.amax(-1, keepdim=True)

    def run():
        out = torch._int_mm(xq, wq.t()).float() * rs * ws
        if bias is not None:
            out = out + bias
        if act == "gelu":
            out = F.gelu(out, approximate="tanh")
        if res is not None:
            out = out + res.float()
        return out.bfloat16()
    return run


def int8_path_calls(model, images) -> dict:
    """Every int8 kernel launch of one forward, recorded with its arguments,
    then held against its plain version on the same activations and timed
    beside its plain version, its bound and a library yardstick."""
    import torch
    import torch.nn.functional as F

    from transparent_object_detection_tpu_torch.ops import attention_int8 as A8
    from transparent_object_detection_tpu_torch.ops import quant_matmul as QM

    calls = []
    real = {"quant_rows": (QM, QM.quant_rows, QM.quant_rows_plain),
            "qmm": (QM, QM.qmm, QM.qmm_plain),
            "flash_mha_int8": (A8, A8.flash_mha_int8, A8.flash_mha_int8_plain)}

    def recording(name, kernel):
        def launch(*args, **kw):
            out = kernel(*args, **kw)
            calls.append((name, args, kw, out))
            return out
        launch.launches = 0  # the wrapper counts on the name it is bound to
        return launch

    for name, (mod, kernel, _) in real.items():
        setattr(mod, name, recording(name, kernel))
    try:
        with torch.inference_mode():
            model(images)
    finally:
        for name, (mod, kernel, _) in real.items():
            setattr(mod, name, kernel)
    rows = {name: [] for name in real}
    for i, (name, args, kw, out) in enumerate(calls):
        mod, kernel, plain = real[name]
        with torch.inference_mode():
            reading = int8_reading(out, plain(*args, **kw))
            check(reading["bar_used"] <= 1.0,
                  f"{name} launch {i} on the path's activations: {reading}")
            ms = timed_ms(lambda: kernel(*args, **kw), 10, 2)
            plain_ms = timed_ms(lambda: plain(*args, **kw), 2, 1)
            if name == "qmm":
                ops, nbytes = _qmm_cost(args, out)
                lib = _library_qmm(args)
                library_ms = timed_ms(lib, 10, 2)
                bnd = max(ops / PEAK_INT8_OPS, nbytes / PEAK_BYTES) * 1e3
                by = "operations" if ops / PEAK_INT8_OPS >= nbytes / PEAK_BYTES else "bytes"
                shape = {"m": args[0].shape[0], "k": args[0].shape[1], "n": args[2].shape[0],
                         "groups": args[1].shape[-1], "act": args[5],
                         "out": ("quant_out" if args[7] is not None
                                 else "ln_out" if args[8] is not None else "bf16")}
            elif name == "quant_rows":
                x = args[0]
                nbytes = x.numel() * 3 + x.shape[0] * 4
                library_ms, bnd, by = None, nbytes / PEAK_BYTES * 1e3, "bytes"
                shape = {"m": x.shape[0], "k": x.shape[1], "ln": bool(args[1])}
            else:
                q, kq, ks, vq, vs, h, scale = args[:7]
                q_width = args[7] if len(args) > 7 else None
                b, n, cq = kq.shape
                cv = vq.shape[-1]
                ops = 2.0 * b * n * n * (cq + cv)
                nbytes = (b * n * cq * 2 + kq.numel() + vq.numel() + 8 * ks.numel()
                          + b * n * cv * 2)
                bnd = max(ops / PEAK_INT8_OPS, nbytes / PEAK_BYTES) * 1e3
                by = "operations" if ops / PEAK_INT8_OPS >= nbytes / PEAK_BYTES else "bytes"
                # bf16 SDPA on the same shapes (values from the int8 payloads)
                qh = A8._split_heads(q[..., :cq], h).contiguous()
                kb, vb = (A8._split_heads(t, h).bfloat16().contiguous() for t in (kq, vq))
                library_ms = timed_ms(lambda: F.scaled_dot_product_attention(
                    qh, kb, vb, scale=scale), 10, 2)
                shape = {"b": b, "n": n, "cq": cq, "cv": cv, "heads": h,
                         "bk": n // ks.shape[-1], "packed_q": q_width is not None}
        rows[name].append({"launch": i, **shape, "bar_used": reading["bar_used"],
                           "max_abs_err": reading["max_abs_err"], "ms": ms,
                           "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by,
                           "library_ms": library_ms})
        print(json.dumps({"int8_path_call": name, **rows[name][-1]}), flush=True)
    return rows


def int8_slice_phase(card: str, bf16_model, bf16_perf: dict):
    """The int8 model (int8_dense + int8_attn) at phi='s' 640x640 with the
    bf16 model's weights, through Predictor.detect_raw_batch; launch counts,
    parity with the same model on plain versions, timings and profile."""
    import numpy as np
    import torch

    from transparent_object_detection_tpu_torch.config import ModelConfig, PredictConfig
    from transparent_object_detection_tpu_torch.inference import Predictor
    from transparent_object_detection_tpu_torch.models.detector import (
        build_model,
        set_attention_impl,
    )
    from transparent_object_detection_tpu_torch.ops import attention as A
    from transparent_object_detection_tpu_torch.ops import attention_int8 as A8
    from transparent_object_detection_tpu_torch.ops import quant_matmul as QM
    from transparent_object_detection_tpu_torch.ops.preprocess import letterbox_batch

    cfg, pcfg = ModelConfig(int8_dense=True, int8_attn=True), PredictConfig()
    model = build_model(cfg, device="cuda", seed=SEED)
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

    counters = (A.reset_launch_counts, A8.reset_launch_counts, QM.reset_launch_counts)
    read = lambda: {"flash_mha_packed": A.flash_mha_packed.launches,
                    "flash_single": A.flash_single.launches,
                    "flash_mha_int8": A8.flash_mha_int8.launches,
                    "qmm": QM.qmm.launches, "quant_rows": QM.quant_rows.launches}
    # the main path, counted: counts to 0 just before, read just after
    for reset in counters:
        reset()
    dets = predictor.detect_raw_batch(raw, shapes)
    torch.cuda.synchronize()
    launches = read()
    print(json.dumps({"int8_main_path_launches": launches}), flush=True)
    # batch 4: 4 TEBs x (qkv, attn_out, mlp1, mlp2), 3 quant_rows each (no
    # TEB reaches the LN handoff's 51,200 rows); int8 attention at h1, h2, h4
    # and dark3, naive bf16 at h6 (N = 400)
    expected = {"flash_mha_packed": 0, "flash_single": 0, "flash_mha_int8": 4, "qmm": 16,
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
            for reset in counters:
                reset()
            model(img)
            per_batch[b] = read()
    print(json.dumps({"int8_launches_per_forward": per_batch}), flush=True)

    # timing, as the bf16 slice
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
        iters = 3
        for _ in range(iters):
            predictor.detect_raw_batch(raw32, shapes32)["num_detections"].cpu()
        b32_s = (time.perf_counter() - t0) / iters
        img32 = letterbox_batch(torch.as_tensor(raw32, device="cuda").float() / 255.0,
                                cfg.input_shape)
        fwd32 = timed_ms(lambda: model(img32), 3, 1)
        peak = torch.cuda.max_memory_allocated() / 2**30
        profile = profile_forward(model, img32)
    perf = {
        "card": card, "model": "phi=s 640x640 int8_dense + int8_attn",
        "batch1_latency_ms_p50": lat[len(lat) // 2], "batch1_latency_ms_p75": lat[3 * len(lat) // 4],
        "batch1_latency_ms_min": lat[0], "batch1_forward_ms": fwd1,
        "batch32_imgs_per_s": 32 / b32_s, "batch32_step_ms": b32_s * 1e3,
        "batch32_forward_ms": fwd32, "peak_mem_gib_batch32": peak,
        "bf16_same_run": {k: bf16_perf[k] for k in (
            "batch1_latency_ms_p50", "batch1_latency_ms_p75", "batch32_imgs_per_s",
            "batch32_forward_ms")},
    }
    print(json.dumps({"int8_slice_perf": perf}), flush=True)
    return launches, rows


def int8_kernel_entry(name, source, replaces, rows, launches, max_err):
    """One line of the kernels report: one batch-2 forward's launches of
    this kernel summed."""
    total = lambda key: sum(r[key] for r in rows)
    lib = [r["library_ms"] for r in rows]
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches, "max_abs_err": max(max_err, max(r["max_abs_err"] for r in rows)),
        "ms": total("ms"), "plain_ms": total("plain_ms"), "bound_ms": total("bound_ms"),
        "bound_by": ("operations" if all(r["bound_by"] == "operations" for r in rows)
                     else "bytes" if all(r["bound_by"] == "bytes" for r in rows) else "mixed"),
        "library_ms": None if any(x is None for x in lib) else sum(lib),
        "shapes": rows,
    }


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
    t0 = time.perf_counter()
    logs = _build.build(_build.all_sources())
    print(json.dumps({"build_s": time.perf_counter() - t0, "built": sorted(logs)}), flush=True)
    for log in logs.values():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print("  " + line.strip())

    mha_rows, single_rows = kernel_phase()
    int8_err = int8_kernel_phase()
    launches, bf16_model, bf16_perf = slice_phase(card)
    int8_launches, int8_rows = int8_slice_phase(card, bf16_model, bf16_perf)
    src = "transparent_object_detection_tpu_torch/csrc/flash_attn_fwd.cu"
    qsrc = "transparent_object_detection_tpu_torch/csrc/quant_matmul.cu"
    jq = "transparent_object_detection_tpu/ops/quant_matmul.py"
    kernels = [
        kernel_entry("flash_mha_packed", src,
                     "transparent_object_detection_tpu/ops/attention.py:239", mha_rows,
                     launches["flash_mha_packed"]),
        kernel_entry("flash_single", src,
                     "transparent_object_detection_tpu/ops/attention.py:137", single_rows,
                     launches["flash_single"]),
        int8_kernel_entry("flash_mha_int8",
                          "transparent_object_detection_tpu_torch/csrc/flash_attn_int8.cu",
                          "transparent_object_detection_tpu/ops/attention_int8.py:58",
                          int8_rows["flash_mha_int8"], int8_launches["flash_mha_int8"],
                          int8_err["flash_mha_int8"]),
        int8_kernel_entry("qmm", qsrc, f"{jq}:80", int8_rows["qmm"], int8_launches["qmm"],
                          int8_err["qmm"]),
        int8_kernel_entry("quant_rows", qsrc, f"{jq}:408", int8_rows["quant_rows"],
                          int8_launches["quant_rows"], int8_err["quant_rows"]),
    ]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
