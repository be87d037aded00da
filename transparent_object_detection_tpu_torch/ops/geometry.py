"""Box geometry on the last axis, broadcasting over leading axes.

Counterpart of transparent_object_detection_tpu/ops/geometry.py (the parts
the serving path uses).
"""
from __future__ import annotations

from typing import Tuple

import torch


def xywh2xyxy(x: torch.Tensor) -> torch.Tensor:
    """(cx, cy, w, h) -> (x1, y1, x2, y2)."""
    cxy = x[..., 0:2]
    half = x[..., 2:4] * 0.5
    return torch.cat([cxy - half, cxy + half], dim=-1)


def bbox_iou(box1: torch.Tensor, box2: torch.Tensor, xywh: bool = True,
             eps: float = 1e-7) -> torch.Tensor:
    """Plain IoU between broadcastable (..., 4) box arrays (the "iou" kind)."""
    if xywh:
        box1, box2 = xywh2xyxy(box1), xywh2xyxy(box2)
    b1_x1, b1_y1, b1_x2, b1_y2 = box1.unbind(-1)
    b2_x1, b2_y1, b2_x2, b2_y2 = box2.unbind(-1)
    w1, h1 = b1_x2 - b1_x1, b1_y2 - b1_y1 + eps
    w2, h2 = b2_x2 - b2_x1, b2_y2 - b2_y1 + eps
    inter_w = (torch.minimum(b1_x2, b2_x2) - torch.maximum(b1_x1, b2_x1)).clamp(min=0)
    inter_h = (torch.minimum(b1_y2, b2_y2) - torch.maximum(b1_y1, b2_y1)).clamp(min=0)
    inter = inter_w * inter_h
    union = w1 * h1 + w2 * h2 - inter + eps
    return inter / union


def pairwise_iou(boxes1: torch.Tensor, boxes2: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """IoU matrix of xyxy boxes: (..., N, 4) x (..., M, 4) -> (..., N, M)."""
    return bbox_iou(boxes1[..., :, None, :], boxes2[..., None, :, :], xywh=False, eps=eps)


def make_anchors(
    feat_shapes: Tuple[Tuple[int, int], ...],
    strides: Tuple[int, ...],
    grid_cell_offset: float = 0.5,
    dtype: torch.dtype = torch.float32,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Grid-cell centres and per-anchor strides of every pyramid level:
    (sum(h*w), 2) points as (x + off, y + off) and (sum(h*w), 1) strides."""
    points, stride_chunks = [], []
    for (h, w), s in zip(feat_shapes, strides):
        sx = torch.arange(w, dtype=dtype, device=device) + grid_cell_offset
        sy = torch.arange(h, dtype=dtype, device=device) + grid_cell_offset
        gy, gx = torch.meshgrid(sy, sx, indexing="ij")
        points.append(torch.stack([gx, gy], dim=-1).reshape(-1, 2))
        stride_chunks.append(torch.full((h * w, 1), float(s), dtype=dtype, device=device))
    return torch.cat(points, dim=0), torch.cat(stride_chunks, dim=0)
