"""Detection criterion: task-aligned assignment + CIoU + DFL + BCE over the
raw head maps and padded targets, in fp32. Counterpart of
transparent_object_detection_tpu/train/loss.py.

Loss = 7.5 * CIoU + 0.5 * BCE + 1.5 * DFL, each term normalised by the
total target score mass.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F

from transparent_object_detection_tpu_torch.models.blocks import dfl_expectation
from transparent_object_detection_tpu_torch.ops.geometry import (
    bbox2dist,
    bbox_iou,
    dist2bbox,
    make_anchors,
    xywh2xyxy,
)
from transparent_object_detection_tpu_torch.train.assigner import task_aligned_assign


class LossConfig(NamedTuple):
    num_classes: int = 1
    reg_max: int = 16
    strides: Tuple[int, ...] = (8, 16, 32)
    box_weight: float = 7.5
    cls_weight: float = 0.5
    dfl_weight: float = 1.5
    tal_topk: int = 10
    tal_alpha: float = 0.5
    tal_beta: float = 6.0
    label_smoothing: float = 0.0


def _df_loss(pred_dist_logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Distribution-focal cross-entropy on the two neighbouring bins:
    (..., 4, reg_max) logits, (..., 4) ltrb targets in [0, reg_max - 1) ->
    (...) mean over the 4 sides."""
    logp = F.log_softmax(pred_dist_logits, dim=-1)
    tl = target.floor().long()
    tr = tl + 1
    wl = tr.to(target.dtype) - target
    wr = 1.0 - wl
    ce_l = -logp.gather(-1, tl[..., None])[..., 0]
    ce_r = -logp.gather(-1, tr.clamp(0, logp.shape[-1] - 1)[..., None])[..., 0]
    return (ce_l * wl + ce_r * wr).mean(dim=-1)


def sigmoid_bce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Elementwise binary cross-entropy with logits, log(1 + exp(-|x|)) form."""
    return logits.clamp(min=0.0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))


def detection_loss(raw_maps: Sequence[torch.Tensor], target_boxes: torch.Tensor,
                   target_labels: torch.Tensor,
                   cfg: LossConfig = LossConfig()) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """raw_maps: per level (B, H_l, W_l, 4*reg_max + nc); target_boxes
    (B, M, 4) normalised (cx, cy, w, h), padded slots all zero;
    target_labels (B, M) int. Returns (total, components), 0-d fp32 tensors;
    the assigner sees detached predictions."""
    nc, reg_max = cfg.num_classes, cfg.reg_max
    b = raw_maps[0].shape[0]
    feat_shapes = tuple((m.shape[1], m.shape[2]) for m in raw_maps)
    strides = cfg.strides[:len(raw_maps)]
    flat = torch.cat([m.reshape(b, -1, 4 * reg_max + nc) for m in raw_maps], dim=1).float()
    pred_distri = flat[..., :4 * reg_max]
    pred_scores = flat[..., 4 * reg_max:]
    a = flat.shape[1]
    dev = flat.device

    anchor_points, stride_tensor = make_anchors(feat_shapes, strides, 0.5, device=dev)
    img_h = feat_shapes[0][0] * strides[0]
    img_w = feat_shapes[0][1] * strides[0]
    scale = torch.tensor([img_w, img_h, img_w, img_h], dtype=torch.float32, device=dev)
    gt_bboxes = xywh2xyxy(target_boxes.float() * scale)
    mask_gt = gt_bboxes.sum(dim=-1) > 0

    pred_dist = dfl_expectation(pred_distri.reshape(b, a, 4, reg_max), reg_max)
    pred_bboxes = dist2bbox(pred_dist, anchor_points[None], xywh=False)

    assign = task_aligned_assign(
        torch.sigmoid(pred_scores).detach(), pred_bboxes.detach() * stride_tensor[None],
        anchor_points * stride_tensor, target_labels, gt_bboxes, mask_gt, num_classes=nc,
        topk=cfg.tal_topk, alpha=cfg.tal_alpha, beta=cfg.tal_beta)

    target_bboxes = assign.target_bboxes / stride_tensor[None]
    target_scores = assign.target_scores
    fg = assign.fg_mask.float()
    target_scores_sum = target_scores.sum().clamp(min=1.0)

    cls_targets = target_scores
    if cfg.label_smoothing > 0:
        cls_targets = cls_targets * (1.0 - cfg.label_smoothing) + 0.5 * cfg.label_smoothing
    loss_cls = sigmoid_bce(pred_scores, cls_targets).sum() / target_scores_sum

    weight = target_scores.sum(dim=-1) * fg
    iou = bbox_iou(pred_bboxes, target_bboxes, xywh=False, kind="ciou")
    loss_iou = ((1.0 - iou) * weight).sum() / target_scores_sum

    target_ltrb = bbox2dist(anchor_points[None], target_bboxes, reg_max - 1)
    dfl = _df_loss(pred_distri.reshape(b, a, 4, reg_max), target_ltrb)
    loss_dfl = (dfl * weight).sum() / target_scores_sum

    total = cfg.box_weight * loss_iou + cfg.cls_weight * loss_cls + cfg.dfl_weight * loss_dfl
    return total, {"loss": total, "loss_iou": loss_iou, "loss_cls": loss_cls,
                   "loss_dfl": loss_dfl, "num_fg": fg.sum()}
