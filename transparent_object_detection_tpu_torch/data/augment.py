"""Host-side image augmentation (numpy + cv2), explicit-RNG: the port's own
copy of transparent_object_detection_tpu/data/augment.py, bit for bit the
same arrays for the same generator (every draw in the same order).

Behavioral rebuild of the reference augmentation pipeline
(utils/dataloader.py:65-288): deterministic letterbox, random
aspect-jitter/scale/placement/flip, HSV LUT jitter, 4-image mosaic with
seam clipping, 0.5/0.5 mixup. Every function takes a numpy Generator —
no global RNG state — so loader workers are reproducible per
(seed, epoch, index).

These run on CPU worker threads (cv2 releases the GIL); the device never
sees anything but the final fixed-shape batch.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import cv2
import numpy as np

GRAY = 128  # canvas fill, matching the reference


def load_rgb(path: str) -> np.ndarray:
    """Read an image file as RGB uint8 (HWC)."""
    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(path)
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def _paste(canvas: np.ndarray, img: np.ndarray, dx: int, dy: int) -> None:
    """Paste img onto canvas at (dx, dy), clipping out-of-canvas regions
    (PIL Image.paste semantics used throughout dataloader.py)."""
    h, w = img.shape[:2]
    ch, cw = canvas.shape[:2]
    x1, y1 = max(dx, 0), max(dy, 0)
    x2, y2 = min(dx + w, cw), min(dy + h, ch)
    if x2 <= x1 or y2 <= y1:
        return
    canvas[y1:y2, x1:x2] = img[y1 - dy : y2 - dy, x1 - dx : x2 - dx]


def _transform_boxes(
    boxes: np.ndarray,
    sx: float,
    sy: float,
    dx: float,
    dy: float,
    out_w: int,
    out_h: int,
    flip: bool = False,
    min_size: float = 1.0,
) -> np.ndarray:
    """Scale + shift (+ optional h-flip) boxes, clip to canvas, drop
    degenerates (< min_size px on either side) — dataloader.py:135-143."""
    if len(boxes) == 0:
        return boxes.reshape(0, 5)
    b = boxes.astype(np.float32).copy()
    b[:, [0, 2]] = b[:, [0, 2]] * sx + dx
    b[:, [1, 3]] = b[:, [1, 3]] * sy + dy
    if flip:
        b[:, [0, 2]] = out_w - b[:, [2, 0]]
    b[:, 0:2] = np.maximum(b[:, 0:2], 0)
    b[:, 2] = np.minimum(b[:, 2], out_w)
    b[:, 3] = np.minimum(b[:, 3], out_h)
    keep = (b[:, 2] - b[:, 0] > min_size) & (b[:, 3] - b[:, 1] > min_size)
    return b[keep]


def hsv_jitter(
    image: np.ndarray,
    rng: np.random.Generator,
    hue: float = 0.1,
    sat: float = 0.7,
    val: float = 0.4,
) -> np.ndarray:
    """LUT-based HSV color jitter on uint8 RGB (dataloader.py:121-133).

    One 3-channel cv2.LUT call on the HSV image (no split/merge round trip —
    measured ~2x faster than the per-channel form on this pipeline's
    hot path)."""
    r = rng.uniform(-1, 1, 3) * np.array([hue, sat, val]) + 1
    hsv = cv2.cvtColor(image, cv2.COLOR_RGB2HSV)
    x = np.arange(256, dtype=r.dtype)
    lut3 = np.stack(
        [
            (x * r[0]) % 180,
            np.clip(x * r[1], 0, 255),
            np.clip(x * r[2], 0, 255),
        ],
        axis=-1,
    ).astype(image.dtype).reshape(1, 256, 3)
    return cv2.cvtColor(cv2.LUT(hsv, lut3), cv2.COLOR_HSV2RGB)


def letterbox_deterministic(
    image: np.ndarray, boxes: np.ndarray, input_shape: Tuple[int, int]
) -> Tuple[np.ndarray, np.ndarray]:
    """Eval-mode letterbox onto gray canvas (dataloader.py:76-99)."""
    ih, iw = image.shape[:2]
    h, w = input_shape
    scale = min(w / iw, h / ih)
    nw, nh = int(iw * scale), int(ih * scale)
    dx, dy = (w - nw) // 2, (h - nh) // 2
    resized = cv2.resize(image, (nw, nh), interpolation=cv2.INTER_CUBIC)
    canvas = np.full((h, w, 3), GRAY, dtype=np.uint8)
    _paste(canvas, resized, dx, dy)
    boxes = _transform_boxes(boxes, nw / iw, nh / ih, dx, dy, w, h)
    return canvas, boxes


def random_affine(
    image: np.ndarray,
    boxes: np.ndarray,
    input_shape: Tuple[int, int],
    rng: np.random.Generator,
    jitter: float = 0.3,
    scale_range: Tuple[float, float] = (0.25, 2.0),
    flip_prob: float = 0.5,
    place_random: bool = True,
    quadrant_offset: Optional[Tuple[int, int]] = None,
) -> Tuple[np.ndarray, np.ndarray, bool]:
    """Train-mode geometric augmentation (dataloader.py:101-143):
    aspect jitter + random scale resize, random (or mosaic-quadrant)
    placement on a gray canvas, horizontal flip.

    Returns (canvas uint8, transformed boxes, flipped?).
    """
    ih, iw = image.shape[:2]
    h, w = input_shape
    new_ar = (iw / ih) * rng.uniform(1 - jitter, 1 + jitter) / rng.uniform(1 - jitter, 1 + jitter)
    scale = rng.uniform(*scale_range)
    if new_ar < 1:
        nh = int(scale * h)
        nw = int(nh * new_ar)
    else:
        nw = int(scale * w)
        nh = int(nw / new_ar)
    nw, nh = max(nw, 1), max(nh, 1)
    resized = cv2.resize(image, (nw, nh), interpolation=cv2.INTER_LINEAR)

    flip = rng.random() < flip_prob
    if flip:
        resized = resized[:, ::-1]

    if quadrant_offset is not None:
        dx, dy = quadrant_offset
    elif place_random:
        # uniform between 0 and (w - nw), either sign (dataloader.py:112-113)
        dx = int(rng.uniform(*sorted((0, w - nw))))
        dy = int(rng.uniform(*sorted((0, h - nh))))
    else:
        dx, dy = (w - nw) // 2, (h - nh) // 2

    canvas = np.full((h, w, 3), GRAY, dtype=np.uint8)
    _paste(canvas, resized, dx, dy)
    # flip happens on the resized tile, so box flip uses tile width then shift
    b = boxes.astype(np.float32).copy().reshape(-1, 5)
    if len(b):
        b[:, [0, 2]] = b[:, [0, 2]] * (nw / iw)
        b[:, [1, 3]] = b[:, [1, 3]] * (nh / ih)
        if flip:
            b[:, [0, 2]] = nw - b[:, [2, 0]]
        b[:, [0, 2]] += dx
        b[:, [1, 3]] += dy
        b[:, 0:2] = np.maximum(b[:, 0:2], 0)
        b[:, 2] = np.minimum(b[:, 2], w)
        b[:, 3] = np.minimum(b[:, 3], h)
        keep = (b[:, 2] - b[:, 0] > 1) & (b[:, 3] - b[:, 1] > 1)
        b = b[keep]
    return canvas, b, flip


def mosaic4(
    images: Sequence[np.ndarray],
    boxes_list: Sequence[np.ndarray],
    input_shape: Tuple[int, int],
    rng: np.random.Generator,
    jitter: float = 0.3,
    scale_range: Tuple[float, float] = (0.4, 1.0),
) -> Tuple[np.ndarray, np.ndarray]:
    """4-image mosaic around a random cut point (dataloader.py:186-278).

    Tile order (reference quadrant layout): 0 top-left, 1 bottom-left,
    2 bottom-right, 3 top-right. Boxes are intersected with their quadrant
    (equivalent to the reference's merge_bboxes seam clipping) and
    degenerate slivers are dropped (repaired behavior: the reference keeps
    zero-width seam boxes).
    """
    h, w = input_shape
    cutx = int(w * rng.uniform(0.3, 0.7))
    cuty = int(h * rng.uniform(0.3, 0.7))

    quadrants = [  # (x1, y1, x2, y2) region per tile index
        (0, 0, cutx, cuty),
        (0, cuty, cutx, h),
        (cutx, cuty, w, h),
        (cutx, 0, w, cuty),
    ]

    # Draw all geometry first (same RNG sequence for the native and numpy
    # pixel paths, and box math is shared below).
    geom = np.zeros((4, 5), dtype=np.int32)  # [nw, nh, dx, dy, flip]
    for idx, img in enumerate(images):
        ih, iw = img.shape[:2]
        new_ar = (
            (iw / ih)
            * rng.uniform(1 - jitter, 1 + jitter)
            / rng.uniform(1 - jitter, 1 + jitter)
        )
        scale = rng.uniform(*scale_range)
        if new_ar < 1:
            nh = int(scale * h)
            nw = int(nh * new_ar)
        else:
            nw = int(scale * w)
            nh = int(nw / new_ar)
        nw, nh = max(nw, 1), max(nh, 1)
        flip = rng.random() < 0.5
        # tile anchor per quadrant: the tile corner sits at the cut point
        if idx == 0:
            dx, dy = cutx - nw, cuty - nh
        elif idx == 1:
            dx, dy = cutx - nw, cuty
        elif idx == 2:
            dx, dy = cutx, cuty
        else:
            dx, dy = cutx, cuty - nh
        geom[idx] = (nw, nh, dx, dy, int(flip))

    # -- pixels --------------------------------------------------------------
    # Default path: cv2 resize + direct quadrant-intersected paste (cv2's
    # SIMD resize beats the scalar native kernel on AVX-512 hosts; the
    # native single-pass kernel is kept for hosts where it wins —
    # TOD_NATIVE_MOSAIC=1).
    import os

    from transparent_object_detection_tpu_torch.data import native

    use_native = os.environ.get("TOD_NATIVE_MOSAIC", "0") == "1" and native.available()
    if not use_native:
        canvas = np.full((h, w, 3), GRAY, dtype=np.uint8)
        for idx, img in enumerate(images):
            nw, nh, dx, dy, flip = (int(v) for v in geom[idx])
            tile = cv2.resize(img, (nw, nh), interpolation=cv2.INTER_LINEAR)
            if flip:
                tile = tile[:, ::-1]
            # paste only the tile ∩ quadrant region — no per-tile scratch canvas
            qx1, qy1, qx2, qy2 = quadrants[idx]
            x1, y1 = max(dx, qx1), max(dy, qy1)
            x2, y2 = min(dx + nw, qx2), min(dy + nh, qy2)
            if x2 > x1 and y2 > y1:
                canvas[y1:y2, x1:x2] = tile[y1 - dy : y2 - dy, x1 - dx : x2 - dx]

    # -- boxes (shared) -------------------------------------------------------
    merged: List[np.ndarray] = []
    for idx, boxes in enumerate(boxes_list):
        ih, iw = images[idx].shape[:2]
        nw, nh, dx, dy, flip = (int(v) for v in geom[idx])
        qx1, qy1, qx2, qy2 = quadrants[idx]
        b = boxes.astype(np.float32).copy().reshape(-1, 5)
        if len(b):
            b[:, [0, 2]] = b[:, [0, 2]] * (nw / iw)
            b[:, [1, 3]] = b[:, [1, 3]] * (nh / ih)
            if flip:
                b[:, [0, 2]] = nw - b[:, [2, 0]]
            b[:, [0, 2]] += dx
            b[:, [1, 3]] += dy
            # intersect with quadrant (seam clipping)
            b[:, 0] = np.clip(b[:, 0], qx1, qx2)
            b[:, 2] = np.clip(b[:, 2], qx1, qx2)
            b[:, 1] = np.clip(b[:, 1], qy1, qy2)
            b[:, 3] = np.clip(b[:, 3], qy1, qy2)
            keep = (b[:, 2] - b[:, 0] > 1) & (b[:, 3] - b[:, 1] > 1)
            merged.append(b[keep])

    out_boxes = (
        np.concatenate(merged, axis=0) if merged else np.zeros((0, 5), dtype=np.float32)
    )
    if use_native:
        # one native pass composes resize+flip+paste; HSV jitter stays on
        # cv2's SIMD LUT path (measured faster than the scalar C loop)
        canvas = native.mosaic4_u8(images, geom, (h, w), cutx, cuty, GRAY)
    canvas = hsv_jitter(canvas, rng)
    return canvas, out_boxes


def mixup(
    image_1: np.ndarray, boxes_1: np.ndarray, image_2: np.ndarray, boxes_2: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """0.5/0.5 pixel blend + box union (dataloader.py:280-288)."""
    from transparent_object_detection_tpu_torch.data import native

    if native.available() and image_1.dtype == np.uint8 and image_1.shape == image_2.shape:
        blended = native.blend_half_u8(image_1, image_2)
    else:
        blended = (
            image_1.astype(np.float32) * 0.5 + image_2.astype(np.float32) * 0.5
        ).astype(np.uint8)
    b1 = boxes_1.reshape(-1, 5)
    b2 = boxes_2.reshape(-1, 5)
    return blended, np.concatenate([b1, b2], axis=0)
