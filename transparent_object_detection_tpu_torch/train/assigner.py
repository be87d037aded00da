"""Task-aligned assigner on padded ground truth, fixed shapes. Counterpart of
transparent_object_detection_tpu/train/assigner.py, with the same
semantics, including the reference's quirk that masked top-k slots collapse
onto anchor 0 and are then dropped by the duplicate rule.

Ties: `jax.lax.top_k` puts lower indices first among equal metrics, and on a
real batch most metrics are exactly 0; `torch.topk` promises no order, so
the top-k here comes from a stable descending sort. `argmax` takes the first
maximum in both packages.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from transparent_object_detection_tpu_torch.ops.geometry import bbox_iou


class AssignResult(NamedTuple):
    target_labels: torch.Tensor  # (B, A) int64
    target_bboxes: torch.Tensor  # (B, A, 4) xyxy, units of gt_bboxes
    target_scores: torch.Tensor  # (B, A, C) soft targets (TAL-normalised)
    fg_mask: torch.Tensor  # (B, A) bool
    target_gt_idx: torch.Tensor  # (B, A) int64


def candidates_in_gts(anc_points: torch.Tensor, gt_bboxes: torch.Tensor,
                      eps: float = 1e-9) -> torch.Tensor:
    """Anchor centres strictly inside the GT boxes: (A, 2), (B, M, 4) xyxy ->
    (B, M, A) bool."""
    lt = gt_bboxes[..., None, 0:2]
    rb = gt_bboxes[..., None, 2:4]
    deltas = torch.cat([anc_points[None, None] - lt, rb - anc_points[None, None]], dim=-1)
    return deltas.amin(dim=-1) > eps


def topk_membership(metrics: torch.Tensor, topk: int, topk_mask: torch.Tensor) -> torch.Tensor:
    """Per-GT top-k anchors with the duplicate rule: (B, M, A) metrics,
    (B, M) valid-GT mask -> (B, M, A) 0/1 in the metrics' type."""
    a = metrics.shape[-1]
    k = min(topk, a)
    topk_idxs = torch.sort(metrics, dim=-1, descending=True, stable=True).indices[..., :k]
    topk_idxs = torch.where(topk_mask[..., None], topk_idxs, torch.zeros_like(topk_idxs))
    counts = torch.zeros_like(metrics).scatter_add_(
        -1, topk_idxs, torch.ones(topk_idxs.shape, dtype=metrics.dtype, device=metrics.device))
    return torch.where(counts > 1, torch.zeros_like(counts), counts)


def _one_hot(idx: torch.Tensor, n: int, dtype: torch.dtype) -> torch.Tensor:
    """F.one_hot(idx, n) in `dtype` as a comparison: F.one_hot checks its
    range with two host reads off CUDA, and a train step reads nothing
    back."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def resolve_multi_gt(mask_pos: torch.Tensor, overlaps: torch.Tensor):
    """Anchors claimed by several GTs go to the highest-IoU GT. (B, M, A)
    each -> target_gt_idx (B, A), fg_mask (B, A), mask_pos (B, M, A)."""
    m = mask_pos.shape[1]
    fg_count = mask_pos.sum(dim=-2)
    is_max = _one_hot(overlaps.argmax(dim=1), m, mask_pos.dtype).permute(0, 2, 1)
    mask_pos = torch.where(fg_count[:, None, :] > 1, is_max, mask_pos)
    fg_mask = mask_pos.sum(dim=-2)
    target_gt_idx = mask_pos.argmax(dim=-2)
    return target_gt_idx, fg_mask, mask_pos


@torch.no_grad()
def task_aligned_assign(pd_scores: torch.Tensor, pd_bboxes: torch.Tensor,
                        anc_points: torch.Tensor, gt_labels: torch.Tensor,
                        gt_bboxes: torch.Tensor, mask_gt: torch.Tensor, num_classes: int,
                        topk: int = 10, alpha: float = 0.5, beta: float = 6.0,
                        eps: float = 1e-9) -> AssignResult:
    """Assign padded GTs to anchors by the task-aligned metric s^alpha *
    iou^beta. pd_scores (B, A, C) sigmoid scores, pd_bboxes (B, A, 4) xyxy,
    anc_points (A, 2), gt_labels (B, M), gt_bboxes (B, M, 4) xyxy (padded
    slots zero), mask_gt (B, M) bool. No gradient flows through it."""
    b, a, c = pd_scores.shape
    m = gt_bboxes.shape[1]
    overlaps = bbox_iou(gt_bboxes[:, :, None, :], pd_bboxes[:, None, :, :], xywh=False,
                        kind="ciou").clamp(min=0.0)  # (B, M, A)
    labels_safe = gt_labels.clamp(0, c - 1).long()
    bbox_scores = torch.gather(pd_scores.transpose(1, 2), 1,
                               labels_safe[:, :, None].expand(b, m, a))  # (B, M, A)
    align_metric = bbox_scores ** alpha * overlaps ** beta

    mask_in_gts = candidates_in_gts(anc_points, gt_bboxes, eps).to(align_metric.dtype)
    mask_topk = topk_membership(align_metric * mask_in_gts, topk, mask_gt)
    mask_pos = mask_topk * mask_in_gts * mask_gt.to(pd_scores.dtype)[..., None]

    target_gt_idx, fg_mask, mask_pos = resolve_multi_gt(mask_pos, overlaps)

    target_labels = torch.gather(labels_safe, 1, target_gt_idx)
    target_bboxes = torch.gather(gt_bboxes, 1, target_gt_idx[..., None].expand(b, a, 4))
    target_scores = _one_hot(target_labels, c, pd_scores.dtype)
    target_scores = target_scores * (fg_mask > 0)[..., None]

    align_metric = align_metric * mask_pos
    pos_align = align_metric.amax(dim=-1, keepdim=True)
    pos_overlap = (overlaps * mask_pos).amax(dim=-1, keepdim=True)
    norm = (align_metric * pos_overlap / (pos_align + eps)).amax(dim=-2)[..., None]
    return AssignResult(target_labels=target_labels, target_bboxes=target_bboxes,
                        target_scores=target_scores * norm, fg_mask=fg_mask > 0,
                        target_gt_idx=target_gt_idx)
