"""Batched class-aware non-maximum suppression on the device, fixed shapes
(counterpart of transparent_object_detection_tpu/ops/nms.py).

Per-class separation by the coordinate-offset trick (class * 8192). Two
suppression modes:
  * "exact": sequential greedy NMS over the score-sorted candidates (the
    keep set of torchvision's nms), a device loop over candidate rows;
  * "fast": YOLACT-style one-shot suppression.

Ordering: `jax.lax.top_k` breaks score ties lower-index-first; `torch.topk`
promises no order on CUDA, so ranking is a stable descending sort.
"""
from __future__ import annotations

from typing import Dict

import torch

from transparent_object_detection_tpu_torch.ops.geometry import pairwise_iou

# Larger than any coordinate of a 4096x4096 input: boxes of distinct classes
# never intersect after the offset.
_CLASS_OFFSET = 8192.0


def _top_k_stable(x: torch.Tensor, k: int):
    """Largest k along the last axis, ties lower-index-first (lax.top_k)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _exact_greedy_keep(iou: torch.Tensor, valid: torch.Tensor, iou_thres: float) -> torch.Tensor:
    """Greedy suppression over score-sorted candidates: iou (B, K, K),
    valid (B, K) -> keep (B, K). A box suppressed by an already-suppressed box
    is not removed. Valid candidates come first (they are sorted by score and
    invalid ones score -1), so rows past the largest valid count cannot
    suppress anything and the loop stops there: one host read of that count,
    the same keep set as the full K-step loop."""
    k = iou.shape[-1]
    idx = torch.arange(k, device=iou.device)
    over = (iou > iou_thres) & (idx[None, :] > idx[:, None])  # (B, K, K), j after i
    keep = torch.ones_like(valid)
    for i in range(int(valid.sum(dim=-1).max())):
        alive = keep[:, i] & valid[:, i]
        keep &= ~(over[:, i, :] & alive[:, None])
    return keep & valid


def _fast_keep(iou: torch.Tensor, valid: torch.Tensor, iou_thres: float) -> torch.Tensor:
    """YOLACT-style fast NMS: one masked max over higher-ranked candidates."""
    k = iou.shape[-1]
    idx = torch.arange(k, device=iou.device)
    upper = (idx[:, None] < idx[None, :]) & valid[:, :, None]
    max_prior_iou = torch.where(upper, iou, torch.zeros((), device=iou.device)).amax(dim=-2)
    return (max_prior_iou <= iou_thres) & valid


def batched_nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    conf_thres: float = 0.5,
    iou_thres: float = 0.4,
    max_detections: int = 100,
    pre_nms_topk: int = 1024,
    mode: str = "exact",
    class_agnostic: bool = False,
) -> Dict[str, torch.Tensor]:
    """boxes (B, A, 4) xyxy, scores (B, A, C) sigmoided -> fixed-shape dict:
    boxes (B, D, 4), scores (B, D), classes (B, D) int32, valid (B, D) bool,
    num_detections (B,) int32."""
    if boxes.dim() != 3 or scores.dim() != 3:
        raise ValueError(f"expected (B,A,4)/(B,A,C); got {tuple(boxes.shape)}/"
                         f"{tuple(scores.shape)}")
    if mode not in ("exact", "fast"):
        raise ValueError(f"unknown nms mode {mode!r}")
    a = boxes.shape[1]
    k = min(pre_nms_topk, a)

    class_conf, class_pred = scores.max(dim=-1)
    class_pred = class_pred.to(torch.int32)
    ranked = torch.where(class_conf >= conf_thres, class_conf, torch.full_like(class_conf, -1.0))
    top_scores, top_idx = _top_k_stable(ranked, k)
    cand_boxes = torch.gather(boxes, 1, top_idx[..., None].expand(-1, -1, 4))
    cand_cls = torch.gather(class_pred, 1, top_idx)
    cand_valid = top_scores >= 0.0

    if class_agnostic:
        offset_boxes = cand_boxes
    else:
        offset_boxes = cand_boxes + cand_cls.to(cand_boxes.dtype)[..., None] * _CLASS_OFFSET
    offset_boxes = offset_boxes.float()
    iou = pairwise_iou(offset_boxes, offset_boxes)
    if mode == "exact":
        keep = _exact_greedy_keep(iou, cand_valid, iou_thres)
    else:
        keep = _fast_keep(iou, cand_valid, iou_thres)

    d = min(max_detections, k)
    final_rank = torch.where(keep, top_scores, torch.full_like(top_scores, -1.0))
    det_scores, det_sel = _top_k_stable(final_rank, d)
    det_boxes = torch.gather(cand_boxes, 1, det_sel[..., None].expand(-1, -1, 4))
    det_cls = torch.gather(cand_cls, 1, det_sel)
    det_valid = det_scores >= 0.0
    return {
        "boxes": torch.where(det_valid[..., None], det_boxes, torch.zeros_like(det_boxes)),
        "scores": torch.where(det_valid, det_scores, torch.zeros_like(det_scores)),
        "classes": torch.where(det_valid, det_cls, torch.full_like(det_cls, -1)),
        "valid": det_valid,
        "num_detections": det_valid.sum(dim=-1).to(torch.int32),
    }
