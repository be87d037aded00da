"""Profile the serving or the training step: a torch.profiler trace
(Chrome format, `<out>/trace.json`) of --steps steps after one warm-up
step (serving on CUDA: two, the shape's eager call and its CUDA graph's
capture, so that the trace and the clock see replays), then the step's
time on CUDA events (median of --steps; on the CPU, the host clock),
beside the forward's FLOPs counted from shapes.

    python -m transparent_object_detection_tpu_torch.tools.profile serve --phi s --batch 32
    python -m transparent_object_detection_tpu_torch.tools.profile train --phi s --batch 16
    python -m transparent_object_detection_tpu_torch.tools.profile serve --int8 --steps 5

The weights are random (seed 0).
"""
from __future__ import annotations

import argparse
import json
import statistics
import time


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("mode", choices=["serve", "train"])
    p.add_argument("--phi", default="s", choices=list("nsmlx"))
    p.add_argument("--batch", type=int, default=None, help="default: 32 serve, 16 train")
    p.add_argument("--input-shape", type=int, nargs=2, default=(640, 640))
    p.add_argument("--int8", action="store_true", help="serve mode: the int8 serving path")
    p.add_argument("--steps", type=int, default=3,
                   help="traced and timed steps (after one warm-up step)")
    p.add_argument("--out", default="logs/trace")
    p.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from transparent_object_detection_tpu_torch.api import _Decoded
    from transparent_object_detection_tpu_torch.config import (
        ModelConfig,
        PredictConfig,
        TrainConfig,
    )
    from transparent_object_detection_tpu_torch.models.detector import build_model
    from transparent_object_detection_tpu_torch.utils.profiling import cost_analysis, trace

    batch = args.batch or (32 if args.mode == "serve" else 16)
    shape = tuple(args.input_shape)
    gen = torch.Generator().manual_seed(0)
    images_host = torch.rand((batch, *shape, 3), generator=gen)
    if args.mode == "serve":
        from transparent_object_detection_tpu_torch.inference import Predictor

        cfg = ModelConfig(num_classes=1, phi=args.phi, input_shape=shape,
                          int8_dense=args.int8, int8_attn=args.int8)
        model = build_model(cfg, device=args.device, seed=0)
        device = next(model.parameters()).device
        pred = Predictor(model, cfg, PredictConfig(confidence=0.25, nms_iou=0.5,
                                                   max_detections=100, pre_nms_topk=256,
                                                   nms_mode="fast"), device=device)
        images = images_host.to(device)
        shapes = torch.tensor([list(shape)] * batch, dtype=torch.float32, device=device)
        run = lambda: pred.detect_letterboxed(images, shapes)["num_detections"]
    else:
        from transparent_object_detection_tpu_torch.train.optimizer import build_optimizer
        from transparent_object_detection_tpu_torch.train.trainer import (
            create_train_state,
            loss_config_from,
            make_train_step,
        )

        cfg = ModelConfig(num_classes=1, phi=args.phi, input_shape=shape)
        tc = TrainConfig(max_boxes=64, optimizer_type="sgd", ema=True)
        model = build_model(cfg, device=args.device, seed=0)
        device = next(model.parameters()).device
        state = create_train_state(model, build_optimizer(tc, model))
        step = make_train_step(model, build_optimizer(tc, model), loss_config_from(cfg, tc), tc)
        boxes = np.zeros((batch, 64, 4), np.float32)
        boxes[:, 0] = [0.5, 0.5, 0.4, 0.4]
        data = {"image": images_host.to(device),
                "boxes": torch.from_numpy(boxes).to(device),
                "labels": torch.zeros((batch, 64), dtype=torch.int64, device=device)}
        run = lambda: step(state, data, 1e-3)[1]["loss"]

    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    for _ in range(2 if cuda and args.mode == "serve" else 1):
        run()
    sync()
    with trace(args.out):
        for _ in range(args.steps):
            run()
    times = []
    for _ in range(max(args.steps, 3)):
        if cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            run()
            times.append((time.perf_counter() - t0) * 1e3)
    model.eval()
    flops = cost_analysis(_Decoded(model), images_host[:1].to(device))["flops"] * batch
    ms = statistics.median(times)
    print(f"trace written to {args.out}/trace.json ({args.steps} steps)")
    print(json.dumps({"mode": args.mode, "phi": args.phi, "batch": batch, "int8": args.int8,
                      "device": str(device), "clock": "cuda events" if cuda else "host",
                      "step_ms_median": ms, "step_ms": times, "imgs_per_s": batch / ms * 1e3,
                      "forward_flops": flops}))


if __name__ == "__main__":
    main()
