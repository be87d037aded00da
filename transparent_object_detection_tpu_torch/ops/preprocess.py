"""Batched letterbox and box un-letterboxing on the device (counterpart of
transparent_object_detection_tpu/ops/preprocess.py). Images keep the JAX
layout (B, H, W, 3)."""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

GRAY = 128.0 / 255.0  # letterbox canvas fill


def letterbox_batch(images: torch.Tensor, input_shape: Tuple[int, int]) -> torch.Tensor:
    """Aspect-preserving resize + centred pad of a uniform-size batch.

    images (B, H, W, 3) float in [0, 1] -> (B, h, w, 3). The resize is
    bilinear with antialiasing and half-pixel centres, the counterpart of
    `jax.image.resize(..., "linear")`, which antialiases when it downsamples."""
    b, ih, iw, c = images.shape
    h, w = input_shape
    scale = min(w / iw, h / ih)
    nw, nh = int(iw * scale), int(ih * scale)
    resized = F.interpolate(images.permute(0, 3, 1, 2), size=(nh, nw), mode="bilinear",
                            align_corners=False, antialias=True)
    dy, dx = (h - nh) // 2, (w - nw) // 2
    canvas = torch.full((b, h, w, c), GRAY, dtype=images.dtype, device=images.device)
    canvas[:, dy:dy + nh, dx:dx + nw, :] = resized.permute(0, 2, 3, 1)
    return canvas


def unletterbox_boxes(boxes: torch.Tensor, input_shape: Tuple[int, int],
                      image_shapes: torch.Tensor, letterbox_image: bool = True) -> torch.Tensor:
    """Map xyxy boxes (B, D, 4) from input pixels back to original-image
    pixels; image_shapes (B, 2) holds each image's (h, w)."""
    h_in, w_in = input_shape
    ih = image_shapes[..., 0:1].to(boxes.dtype)
    iw = image_shapes[..., 1:2].to(boxes.dtype)
    x1, y1, x2, y2 = boxes.unbind(-1)
    if letterbox_image:
        scale = torch.minimum(w_in / iw, h_in / ih)
        nw = (iw * scale).to(torch.int32).to(boxes.dtype)
        nh = (ih * scale).to(torch.int32).to(boxes.dtype)
        dx = torch.div(w_in - nw, 2, rounding_mode="floor")
        dy = torch.div(h_in - nh, 2, rounding_mode="floor")
        x1, x2 = (x1 - dx) / scale, (x2 - dx) / scale
        y1, y2 = (y1 - dy) / scale, (y2 - dy) / scale
    else:
        x1, x2 = x1 * iw / w_in, x2 * iw / w_in
        y1, y2 = y1 * ih / h_in, y2 * ih / h_in
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    x1 = torch.minimum(torch.maximum(x1, zero), iw)
    x2 = torch.minimum(torch.maximum(x2, zero), iw)
    y1 = torch.minimum(torch.maximum(y1, zero), ih)
    y2 = torch.minimum(torch.maximum(y2, zero), ih)
    return torch.stack([x1, y1, x2, y2], dim=-1)
