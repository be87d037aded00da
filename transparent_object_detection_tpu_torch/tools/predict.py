"""Prediction driver, all six modes:

  predict      single image (a prompt loop if --source is omitted)
  video        video file or camera index, FPS overlay
  fps          seconds per detection call over --test-interval calls
  dir_predict  a folder of images
  heatmap      class-activation heatmap
  export       the evaluation forward as a torch.export program (.pt2)

    python -m transparent_object_detection_tpu_torch.tools.predict predict \
        --source image.jpg --output prediction.png [--device cpu]
"""
from __future__ import annotations

import argparse


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("mode", choices=["predict", "video", "fps", "dir_predict", "heatmap",
                                    "export"])
    p.add_argument("--source", default=None, help="image/video/dir path or camera index")
    p.add_argument("--output", default=None, help="output path (video/dir/heatmap/export)")
    p.add_argument("--classes", default="model_data/coco_classes.txt")
    p.add_argument("--phi", default="s", choices=list("nsmlx"))
    p.add_argument("--model-path", default=None, help="weights file (FOCUS.save_weights)")
    p.add_argument("--input-shape", type=int, nargs=2, default=[640, 640])
    p.add_argument("--confidence", type=float, default=0.5)
    p.add_argument("--nms-iou", type=float, default=0.4)
    p.add_argument("--test-interval", type=int, default=100)
    p.add_argument("--batch-size", type=int, default=1, help="fps mode: images a call")
    p.add_argument("--compute-dtype", default="bfloat16")
    p.add_argument("--int8", action="store_true",
                   help="int8 serving (int8 TEB projections and int8 flash attention); "
                        "the same weights")
    p.add_argument("--seed", type=int, default=11, help="weights' seed without --model-path")
    p.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = p.parse_args(argv)

    from transparent_object_detection_tpu_torch.api import FOCUS
    from transparent_object_detection_tpu_torch.config import PredictConfig

    focus = FOCUS(
        phi=args.phi,
        model_path=args.model_path,
        classes_path=args.classes,
        input_shape=tuple(args.input_shape),
        compute_dtype=args.compute_dtype,
        int8=args.int8,
        predict_cfg=PredictConfig(confidence=args.confidence, nms_iou=args.nms_iou),
        seed=args.seed,
        device=args.device,
    )

    if args.mode == "predict":
        from PIL import Image

        if args.source:
            rows, drawn = focus.detect_image(Image.open(args.source), draw=True)
            out = args.output or "prediction.png"
            drawn.save(out)
            print(f"{len(rows)} detections -> {out}")
            for r in rows:
                print(r)
        else:
            while True:
                path = input("Input image filename (or 'quit'): ").strip()
                if path in ("quit", "exit", ""):
                    break
                try:
                    rows, drawn = focus.detect_image(Image.open(path), draw=True)
                except OSError as e:
                    print(f"open failed: {e}")
                    continue
                drawn.show()
                print(f"{len(rows)} detections")
    elif args.mode == "video":
        fps = focus.predict_video(args.source or 0, args.output)
        print(f"mean fps: {fps:.2f}")
    elif args.mode == "fps":
        from PIL import Image

        img = Image.open(args.source) if args.source else None
        sec = focus.get_fps(img, args.test_interval, args.batch_size)
        print(f"{sec:.4f} seconds / call, {args.batch_size / sec:.2f} images/s "
              f"@ batch {args.batch_size}")
    elif args.mode == "dir_predict":
        res = focus.predict_dir(args.source or "img/", args.output or "img_out/")
        print(f"predicted {len(res)} images")
    elif args.mode == "heatmap":
        focus.detect_heatmap(args.source, args.output or "heatmap.png")
        print(f"heatmap -> {args.output or 'heatmap.png'}")
    elif args.mode == "export":
        out = focus.export(args.output or "model.pt2")
        print(f"exported -> {out}")


if __name__ == "__main__":
    main()
