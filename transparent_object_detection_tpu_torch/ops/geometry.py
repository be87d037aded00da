"""Box geometry on the last axis, broadcasting over leading axes.

Counterpart of transparent_object_detection_tpu/ops/geometry.py.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch


def xywh2xyxy(x: torch.Tensor) -> torch.Tensor:
    """(cx, cy, w, h) -> (x1, y1, x2, y2)."""
    cxy = x[..., 0:2]
    half = x[..., 2:4] * 0.5
    return torch.cat([cxy - half, cxy + half], dim=-1)


def xyxy2xywh(x: torch.Tensor) -> torch.Tensor:
    """(x1, y1, x2, y2) -> (cx, cy, w, h)."""
    lt, rb = x[..., 0:2], x[..., 2:4]
    return torch.cat([(lt + rb) * 0.5, rb - lt], dim=-1)


def bbox_iou(box1: torch.Tensor, box2: torch.Tensor, xywh: bool = True, kind: str = "iou",
             eps: float = 1e-7) -> torch.Tensor:
    """IoU-family metric between broadcastable (..., 4) box arrays; kind is
    "iou", "giou", "diou" or "ciou". In CIoU the aspect-ratio weight alpha
    carries no gradient (detached), as in the reference."""
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
    iou = inter / union
    if kind == "iou":
        return iou
    cw = torch.maximum(b1_x2, b2_x2) - torch.minimum(b1_x1, b2_x1)
    ch = torch.maximum(b1_y2, b2_y2) - torch.minimum(b1_y1, b2_y1)
    if kind == "giou":
        c_area = cw * ch + eps
        return iou - (c_area - union) / c_area
    c2 = cw ** 2 + ch ** 2 + eps
    rho2 = ((b2_x1 + b2_x2 - b1_x1 - b1_x2) ** 2 + (b2_y1 + b2_y2 - b1_y1 - b1_y2) ** 2) / 4.0
    if kind == "diou":
        return iou - rho2 / c2
    if kind == "ciou":
        v = (4.0 / math.pi ** 2) * (torch.atan(w2 / h2) - torch.atan(w1 / h1)) ** 2
        alpha = (v / (v - iou + (1.0 + eps))).detach()
        return iou - (rho2 / c2 + v * alpha)
    raise ValueError(f"unknown IoU kind: {kind!r}")


def pairwise_iou(boxes1: torch.Tensor, boxes2: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """IoU matrix of xyxy boxes: (..., N, 4) x (..., M, 4) -> (..., N, M)."""
    return bbox_iou(boxes1[..., :, None, :], boxes2[..., None, :, :], xywh=False, eps=eps)


def bbox2dist(anchor_points: torch.Tensor, bbox: torch.Tensor, reg_max: float) -> torch.Tensor:
    """xyxy boxes -> ltrb distances from the anchor points, clamped to
    [0, reg_max - 0.01]."""
    ltrb = torch.cat([anchor_points - bbox[..., 0:2], bbox[..., 2:4] - anchor_points], dim=-1)
    return ltrb.clamp(0.0, reg_max - 0.01)


def dist2bbox(distance: torch.Tensor, anchor_points: torch.Tensor,
              xywh: bool = True) -> torch.Tensor:
    """ltrb distances around anchor points -> xywh or xyxy boxes."""
    x1y1 = anchor_points - distance[..., 0:2]
    x2y2 = anchor_points + distance[..., 2:4]
    if xywh:
        return torch.cat([(x1y1 + x2y2) * 0.5, x2y2 - x1y1], dim=-1)
    return torch.cat([x1y1, x2y2], dim=-1)


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
