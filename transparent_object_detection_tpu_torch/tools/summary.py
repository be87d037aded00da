"""Architecture inspection: parameter count, and FLOPs and bytes of the
evaluation forward counted from shapes (utils.profiling.cost_analysis;
nothing is computed), with the module tree on request.

    python -m transparent_object_detection_tpu_torch.tools.summary --phi s [--device cpu]
"""
from __future__ import annotations

import argparse


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--phi", default="s", choices=list("nsmlx"))
    p.add_argument("--input-shape", type=int, nargs=2, default=[640, 640])
    p.add_argument("--num-classes", type=int, default=1)
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--compute-dtype", default="bfloat16")
    p.add_argument("--int8", action="store_true", help="the int8 serving model")
    p.add_argument("--tabulate", action="store_true", help="print the module tree")
    p.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = p.parse_args(argv)

    import torch

    from transparent_object_detection_tpu_torch.api import _Decoded
    from transparent_object_detection_tpu_torch.config import ModelConfig
    from transparent_object_detection_tpu_torch.models.detector import build_model, count_params
    from transparent_object_detection_tpu_torch.utils.profiling import cost_analysis

    cfg = ModelConfig(num_classes=args.num_classes, phi=args.phi,
                      input_shape=tuple(args.input_shape), compute_dtype=args.compute_dtype,
                      int8_dense=args.int8, int8_attn=args.int8)
    model = build_model(cfg, device=args.device, seed=None)  # counts need no weights
    if args.tabulate:
        print(model)
    h, w = cfg.input_shape
    device = next(model.parameters()).device
    cost = cost_analysis(_Decoded(model),
                         torch.zeros((args.batch_size, h, w, 3), device=device))
    print(f"phi={args.phi} input={cfg.input_shape} classes={args.num_classes} device={device}")
    print(f"params:         {count_params(model) / 1e6:.2f} M")
    print(f"flops:          {cost['flops'] / 1e9:.2f} G @ batch {args.batch_size}")
    print(f"bytes accessed: {cost['bytes_accessed'] / 1e6:.1f} MB (no fusion)")


if __name__ == "__main__":
    main()
