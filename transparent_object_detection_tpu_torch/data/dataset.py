"""Detection dataset with epoch-phased augmentation and fixed-shape targets:
the port's own copy of transparent_object_detection_tpu/data/dataset.py,
with its contract (numpy samples with the keys image, boxes, labels and
num_boxes, their dtypes and fixed shapes).

Every sample returns *padded* targets — (max_boxes, 4) normalized cxcywh +
(max_boxes,) labels + a count — instead of ragged arrays, so the collated
batch has one shape for every step of an epoch.

Mosaic phases out for the last (1 - special_aug_ratio) of training, driven
by `epoch_now` exactly like the reference (dataloader.py:34, train.py:454).
RNG is explicit: sample i at epoch e under seed s is reproducible.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

from transparent_object_detection_tpu_torch.data.annotations import parse_annotation_line
from transparent_object_detection_tpu_torch.data.augment import (
    hsv_jitter,
    letterbox_deterministic,
    load_rgb,
    mixup,
    mosaic4,
    random_affine,
)


@dataclass
class DetectionDataset:
    annotation_lines: List[str]
    input_shape: Tuple[int, int] = (640, 640)
    num_classes: int = 1
    epoch_length: int = 300
    mosaic: bool = True
    mosaic_prob: float = 0.5
    mixup: bool = True
    mixup_prob: float = 0.5
    train: bool = True
    special_aug_ratio: float = 0.7
    max_boxes: int = 128
    seed: int = 11
    # Keep decoded uint8 images in RAM (the ultralytics cache=True analog):
    # JPEG decode dominates the augmented pipeline (~5 ms per 640x480 source
    # vs ~4 ms for a whole fused mosaic), so epochs after the first run
    # decode-free. Budget ~1 MB per VGA image; leave off for datasets that
    # don't fit host RAM.
    cache_images: bool = False

    def __post_init__(self):
        self.epoch_now = -1
        self._image_cache: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
        if not self.annotation_lines:
            raise ValueError("empty annotation list")

    def __len__(self) -> int:
        return len(self.annotation_lines)

    def _rng(self, index: int) -> np.random.Generator:
        return np.random.default_rng(
            (self.seed * 1_000_003 + max(self.epoch_now, 0) * 65_537 + index) & 0xFFFFFFFF
        )

    def _load(self, line: str) -> Tuple[np.ndarray, np.ndarray]:
        if self.cache_images:
            hit = self._image_cache.get(line)
            if hit is not None:
                return hit
        path, boxes = parse_annotation_line(line)
        out = (load_rgb(path), boxes)
        if self.cache_images:
            self._image_cache[line] = out
        return out

    def _single(self, line: str, rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
        image, boxes = self._load(line)
        if not self.train:
            return letterbox_deterministic(image, boxes, self.input_shape)
        canvas, b, _ = random_affine(image, boxes, self.input_shape, rng)
        canvas = hsv_jitter(canvas, rng)
        return canvas, b

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        index = index % len(self)
        rng = self._rng(index)
        mosaic_on = (
            self.train
            and self.mosaic
            and self.epoch_now < self.epoch_length * self.special_aug_ratio
            and rng.random() < self.mosaic_prob
        )
        if mosaic_on:
            picks = [self.annotation_lines[i] for i in rng.integers(0, len(self), size=3)]
            picks.append(self.annotation_lines[index])
            rng.shuffle(picks)
            loaded = [self._load(l) for l in picks]
            image, boxes = mosaic4(
                [im for im, _ in loaded], [b for _, b in loaded], self.input_shape, rng
            )
            if self.mixup and rng.random() < self.mixup_prob:
                other_line = self.annotation_lines[int(rng.integers(0, len(self)))]
                img2, b2 = self._single(other_line, rng)
                image, boxes = mixup(image, boxes, img2, b2)
        else:
            image, boxes = self._single(self.annotation_lines[index], rng)

        return self._pack(image, boxes)

    def _pack(self, image: np.ndarray, boxes: np.ndarray) -> Dict[str, np.ndarray]:
        """HWC uint8 + pixel xyxy boxes -> fixed-shape training sample
        (the collate contract, dataloader.py:44-58 lifted to padded form)."""
        h, w = self.input_shape
        img = np.multiply(image, np.float32(1.0 / 255.0), dtype=np.float32)

        m = self.max_boxes
        out_boxes = np.zeros((m, 4), dtype=np.float32)
        out_labels = np.zeros((m,), dtype=np.int32)
        boxes = boxes.reshape(-1, 5)[:m]
        n = len(boxes)
        if n:
            cx = (boxes[:, 0] + boxes[:, 2]) / 2.0 / w
            cy = (boxes[:, 1] + boxes[:, 3]) / 2.0 / h
            bw = (boxes[:, 2] - boxes[:, 0]) / w
            bh = (boxes[:, 3] - boxes[:, 1]) / h
            out_boxes[:n] = np.stack([cx, cy, bw, bh], axis=1)
            out_labels[:n] = boxes[:, 4].astype(np.int32)
        return {
            "image": img,
            "boxes": out_boxes,
            "labels": out_labels,
            "num_boxes": np.int32(n),
        }


def collate(samples: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Stack fixed-shape samples into a batch dict."""
    return {k: np.stack([s[k] for s in samples], axis=0) for k in samples[0]}
