"""COCO instances json -> per-line txt annotations.

    python -m transparent_object_detection_tpu_torch.tools.coco_annotation \
        --json instances_train2017.json --image-dir train2017/ --out train.txt
"""
from __future__ import annotations

import argparse


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--json", required=True)
    p.add_argument("--image-dir", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--keep-crowd", action="store_true")
    args = p.parse_args(argv)

    from transparent_object_detection_tpu_torch.data.annotations import (
        coco_to_annotation_lines,
        write_annotation_file,
    )

    lines = coco_to_annotation_lines(args.json, args.image_dir, skip_crowd=not args.keep_crowd)
    write_annotation_file(lines, args.out)
    print(f"wrote {len(lines)} lines -> {args.out}")


if __name__ == "__main__":
    main()
