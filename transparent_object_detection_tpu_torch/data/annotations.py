"""Annotation parsing + COCO conversion tooling: the port's own copy of
transparent_object_detection_tpu/data/annotations.py (plain Python and numpy).

The framework's on-disk annotation format matches the reference
(dataset/coco/annotation.py:52-109 output): one image per line,

    <image path> <x1>,<y1>,<x2>,<y2>,<class> <x1>,<y1>,...

`coco_to_annotation_lines` rebuilds the reference's COCO-json converter
(incl. the 91->80 category-id compaction, annotation.py:19-50) without
pycocotools: plain json walking.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def parse_annotation_line(line: str) -> Tuple[str, np.ndarray]:
    """-> (image_path, (N, 5) int array of [x1, y1, x2, y2, cls])."""
    parts = line.strip().split()
    if not parts:
        raise ValueError("empty annotation line")
    path = parts[0]
    if len(parts) == 1:
        return path, np.zeros((0, 5), dtype=np.float32)
    boxes = np.array(
        [list(map(float, token.split(","))) for token in parts[1:]], dtype=np.float32
    )
    if boxes.shape[1] != 5:
        raise ValueError(f"expected 5 fields per box, got {boxes.shape[1]}")
    return path, boxes


def read_annotation_file(path: str) -> List[str]:
    with open(path, encoding="utf-8") as f:
        return [ln for ln in (l.strip() for l in f) if ln]


def coco_category_remap(categories: Sequence[dict]) -> Dict[int, int]:
    """Sparse COCO category ids -> contiguous [0, n) training ids.

    Generalizes the reference's hardcoded 91->80 skip table
    (annotation.py:19-50): ids are compacted in ascending order.
    """
    ids = sorted(c["id"] for c in categories)
    return {cid: i for i, cid in enumerate(ids)}


def coco_to_annotation_lines(
    coco_json_path: str,
    image_dir: str,
    remap: Optional[Dict[int, int]] = None,
    skip_crowd: bool = True,
) -> List[str]:
    """COCO instances json -> annotation lines (annotation.py:52-109).

    Boxes convert from COCO [x, y, w, h] to integer [x1, y1, x2, y2].
    Images without annotations still emit a bare-path line (trainable as
    negatives).
    """
    with open(coco_json_path, encoding="utf-8") as f:
        coco = json.load(f)
    if remap is None:
        remap = coco_category_remap(coco.get("categories", []))

    by_image: Dict[int, List[str]] = {}
    for ann in coco.get("annotations", []):
        if skip_crowd and ann.get("iscrowd", 0):
            continue
        x, y, w, h = ann["bbox"]
        cls = remap[ann["category_id"]]
        token = f"{int(x)},{int(y)},{int(x + w)},{int(y + h)},{cls}"
        by_image.setdefault(ann["image_id"], []).append(token)

    lines = []
    for img in coco.get("images", []):
        path = os.path.join(image_dir, img["file_name"])
        tokens = by_image.get(img["id"], [])
        lines.append(" ".join([path] + tokens))
    return lines


def write_annotation_file(lines: Sequence[str], out_path: str) -> None:
    with open(out_path, "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
