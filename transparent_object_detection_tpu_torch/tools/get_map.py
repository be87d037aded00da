"""Standalone mAP evaluation.

Modes: 0 = predict + eval, 1 = predict only (cache detections to npz),
2 = eval cached detections. COCO protocol thresholds: confidence 0.001,
NMS IoU 0.65.

    python -m transparent_object_detection_tpu_torch.tools.get_map --mode 0 \
        --val-annotations val.txt --model-path logs/best_weights
"""
from __future__ import annotations

import argparse

import numpy as np


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--mode", type=int, default=0, choices=[0, 1, 2])
    p.add_argument("--val-annotations", required=True)
    p.add_argument("--classes", default="model_data/coco_classes.txt")
    p.add_argument("--phi", default="s", choices=list("nsmlx"))
    p.add_argument("--model-path", default=None)
    p.add_argument("--input-shape", type=int, nargs=2, default=[640, 640])
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--cache", default="map_cache.npz")
    p.add_argument("--confidence", type=float, default=0.001)
    p.add_argument("--nms-iou", type=float, default=0.65)
    p.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = p.parse_args(argv)

    from transparent_object_detection_tpu_torch.data.annotations import read_annotation_file
    from transparent_object_detection_tpu_torch.eval.coco_map import coco_eval
    from transparent_object_detection_tpu_torch.eval.voc_map import voc_map
    from transparent_object_detection_tpu_torch.utils.common import get_classes

    val_lines = read_annotation_file(args.val_annotations)
    class_names, nc = get_classes(args.classes)

    if args.mode in (0, 1):
        from transparent_object_detection_tpu_torch.api import FOCUS
        from transparent_object_detection_tpu_torch.eval.callbacks import EvalCallback

        focus = FOCUS(phi=args.phi, model_path=args.model_path, classes_path=args.classes,
                      input_shape=tuple(args.input_shape), device=args.device)
        cb = EvalCallback(focus.model_cfg, val_lines, class_names, log_dir=".",
                          confidence=args.confidence, nms_iou=args.nms_iou,
                          batch_size=args.batch_size, device=focus.device)
        stats = cb.evaluate(focus.model, focus.variables)
        if args.mode == 1:
            # raw per-image detections and ground truths for a later mode 2
            np.savez(args.cache, dets=np.asarray(cb.last_dets, dtype=object),
                     gts=np.asarray(cb.last_gts, dtype=object))
            print(f"cached {len(cb.last_dets)} images of detections to {args.cache}")
        _print_stats(stats)
    else:
        data = np.load(args.cache, allow_pickle=True)  # a cache this tool wrote (mode 1)
        dets, gts = list(data["dets"]), list(data["gts"])
        stats = coco_eval(dets, gts, nc)
        stats["voc_map"], _ = voc_map(dets, gts, nc)
        _print_stats(stats)


def _print_stats(stats) -> None:
    order = ["AP", "AP50", "AP75", "APs", "APm", "APl",
             "AR1", "AR10", "AR100", "ARs", "ARm", "ARl"]
    for k in order:
        print(f"{k:>6}: {stats[k]:.4f}")
    if "voc_map" in stats:
        print(f"voc_map@0.5: {stats['voc_map']:.4f}")


if __name__ == "__main__":
    main()
