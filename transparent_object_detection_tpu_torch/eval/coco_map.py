"""COCO-style AP without pycocotools: the full 12-stat COCOeval vector (the
port's own numpy copy of transparent_object_detection_tpu/eval/coco_map.py).

Rebuild of the capability at utils/utils_map.py:724-864 (get_coco_map via
pycocotools, which is not available in this environment) as a standalone
numpy implementation of COCOeval's bbox protocol:

  * IoU thresholds 0.50:0.05:0.95, 101-point recall interpolation
  * area ranges all / small (<32^2) / medium / large (>96^2)
  * maxDets 1 / 10 / 100
  * greedy per-image matching in score order, best available GT, with the
    COCOeval rule that a detection may steal an unmatched GT only if its
    IoU beats the threshold and any previously considered GT match.

Returns the standard stat vector:
  [AP, AP50, AP75, APs, APm, APl, AR1, AR10, AR100, ARs, ARm, ARl]
(the trainer's eval callback consumes index 1 = AP50, like callbacks.py:211).
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

IOU_THRS = np.linspace(0.5, 0.95, 10)
RECALL_THRS = np.linspace(0.0, 1.0, 101)
# pycocotools areaRng, boundaries inclusive on BOTH ends (ignore condition is
# area < lo or area > hi — an area of exactly 32^2 counts as small AND medium)
AREA_RANGES = {
    "all": (0.0, 1e5**2),
    "small": (0.0, 32.0**2),
    "medium": (32.0**2, 96.0**2),
    "large": (96.0**2, 1e5**2),
}
MAX_DETS = (1, 10, 100)


def _iou_xyxy(d: np.ndarray, g: np.ndarray) -> np.ndarray:
    """(N, 4) x (M, 4) -> (N, M) IoU (COCO convention: no +1)."""
    if len(d) == 0 or len(g) == 0:
        return np.zeros((len(d), len(g)))
    ixmin = np.maximum(d[:, None, 0], g[None, :, 0])
    iymin = np.maximum(d[:, None, 1], g[None, :, 1])
    ixmax = np.minimum(d[:, None, 2], g[None, :, 2])
    iymax = np.minimum(d[:, None, 3], g[None, :, 3])
    inter = np.maximum(ixmax - ixmin, 0) * np.maximum(iymax - iymin, 0)
    area_d = (d[:, 2] - d[:, 0]) * (d[:, 3] - d[:, 1])
    area_g = (g[:, 2] - g[:, 0]) * (g[:, 3] - g[:, 1])
    return inter / np.maximum(area_d[:, None] + area_g[None, :] - inter, 1e-10)


def _match_image(
    det: np.ndarray, gt: np.ndarray, area_rng: Tuple[float, float], max_det: int
):
    """Per-image, per-class matching for all IoU thresholds at once.

    det: (N, 5) [x1,y1,x2,y2,score] sorted desc by caller.
    gt: (M, 4).
    Returns (det_matched (T, N) bool, det_ignored (T, N) bool, scores (N,),
             n_valid_gt).
    """
    det = det[:max_det]
    n, m = len(det), len(gt)
    t = len(IOU_THRS)
    g_area = (gt[:, 2] - gt[:, 0]) * (gt[:, 3] - gt[:, 1]) if m else np.zeros(0)
    g_ignore = (g_area < area_rng[0]) | (g_area > area_rng[1])
    # sort GTs: valid first (COCOeval processes non-ignored first)
    g_order = np.argsort(g_ignore, kind="stable")
    gt = gt[g_order]
    g_ignore = g_ignore[g_order]

    ious = _iou_xyxy(det[:, :4], gt)
    det_matched = np.zeros((t, n), dtype=bool)
    det_ignore = np.zeros((t, n), dtype=bool)
    for ti, thr in enumerate(IOU_THRS):
        g_used = np.zeros(m, dtype=bool)
        for di in range(n):
            best_iou = min(thr, 1 - 1e-10)
            best = -1
            for gi in range(m):
                # COCOeval lets a detection re-match an already-used GT only
                # when that GT is iscrowd; this pipeline carries no crowd
                # annotations, so any used GT is off the table (area-ignored
                # GTs are NOT reusable — treating them crowd-like inflates
                # the small/medium/large stats).
                if g_used[gi]:
                    continue
                # can't fall back to ignored gt once matched to a valid one
                if best > -1 and not g_ignore[best] and g_ignore[gi]:
                    break
                if ious[di, gi] < best_iou:
                    continue
                best_iou = ious[di, gi]
                best = gi
            if best == -1:
                continue
            g_used[best] = True
            det_matched[ti, di] = True
            det_ignore[ti, di] = g_ignore[best]
    # unmatched detections outside the area range are ignored, per COCOeval
    d_area = (det[:, 2] - det[:, 0]) * (det[:, 3] - det[:, 1]) if n else np.zeros(0)
    d_out = (d_area < area_rng[0]) | (d_area > area_rng[1])
    det_ignore = det_ignore | (~det_matched & d_out[None, :])
    n_valid_gt = int((~g_ignore).sum())
    return det_matched, det_ignore, det[:, 4], n_valid_gt


def coco_eval(
    detections: Sequence[np.ndarray],
    ground_truths: Sequence[np.ndarray],
    num_classes: int,
) -> Dict[str, float]:
    """Full COCO bbox evaluation.

    detections: per image (N, 6) [x1,y1,x2,y2,score,cls].
    ground_truths: per image (M, 5) [x1,y1,x2,y2,cls].
    Returns dict with the 12 standard stats plus 'stats' (the raw vector).
    """
    t = len(IOU_THRS)
    # precision[t, recall, class, area, maxdet], recall_[t, class, area, maxdet]
    n_area, n_md = len(AREA_RANGES), len(MAX_DETS)
    precision = -np.ones((t, len(RECALL_THRS), num_classes, n_area, n_md))
    recall_out = -np.ones((t, num_classes, n_area, n_md))

    for c in range(num_classes):
        per_img = []
        for det, gt in zip(detections, ground_truths):
            det = det.reshape(-1, 6)
            gt = gt.reshape(-1, 5)
            d = det[det[:, 5].astype(int) == c][:, :5]
            d = d[np.argsort(-d[:, 4], kind="stable")]
            g = gt[gt[:, 4].astype(int) == c][:, :4]
            per_img.append((d, g))

        for ai, area_rng in enumerate(AREA_RANGES.values()):
            for mi, max_det in enumerate(MAX_DETS):
                matched, ignored, scores, total_gt = [], [], [], 0
                for d, g in per_img:
                    dm, dig, sc, ng = _match_image(d, g, area_rng, max_det)
                    matched.append(dm)
                    ignored.append(dig)
                    scores.append(sc)
                    total_gt += ng
                if total_gt == 0:
                    continue
                scores_all = np.concatenate(scores) if scores else np.zeros(0)
                order = np.argsort(-scores_all, kind="mergesort")
                dm_all = np.concatenate(matched, axis=1)[:, order]  # (T, D)
                dig_all = np.concatenate(ignored, axis=1)[:, order]
                keep = ~dig_all  # (T, D)
                for ti in range(t):
                    tps = (dm_all[ti] & keep[ti]).astype(np.float64)
                    fps = (~dm_all[ti] & keep[ti]).astype(np.float64)
                    tp_cum = np.cumsum(tps)
                    fp_cum = np.cumsum(fps)
                    rc = tp_cum / total_gt
                    pr = tp_cum / np.maximum(tp_cum + fp_cum, 1e-10)
                    recall_out[ti, c, ai, mi] = rc[-1] if len(rc) else 0.0
                    # monotone envelope then sample at 101 recall points
                    pr = pr.tolist()
                    for i in range(len(pr) - 1, 0, -1):
                        pr[i - 1] = max(pr[i - 1], pr[i])
                    inds = np.searchsorted(rc, RECALL_THRS, side="left")
                    q = np.zeros(len(RECALL_THRS))
                    for ri, pi in enumerate(inds):
                        if pi < len(pr):
                            q[ri] = pr[pi]
                    precision[ti, :, c, ai, mi] = q

    def _summarize(ap=True, iou_thr=None, area="all", max_det=100):
        ai = list(AREA_RANGES).index(area)
        mi = MAX_DETS.index(max_det)
        if ap:
            s = precision[:, :, :, ai, mi]
            if iou_thr is not None:
                ti = int(np.where(np.isclose(IOU_THRS, iou_thr))[0][0])
                s = s[ti : ti + 1]
        else:
            s = recall_out[:, :, ai, mi]
            if iou_thr is not None:
                ti = int(np.where(np.isclose(IOU_THRS, iou_thr))[0][0])
                s = s[ti : ti + 1]
        valid = s[s > -1]
        return float(np.mean(valid)) if valid.size else -1.0

    stats = [
        _summarize(True),
        _summarize(True, iou_thr=0.5),
        _summarize(True, iou_thr=0.75),
        _summarize(True, area="small"),
        _summarize(True, area="medium"),
        _summarize(True, area="large"),
        _summarize(False, max_det=1),
        _summarize(False, max_det=10),
        _summarize(False, max_det=100),
        _summarize(False, area="small"),
        _summarize(False, area="medium"),
        _summarize(False, area="large"),
    ]
    return {
        "AP": stats[0],
        "AP50": stats[1],
        "AP75": stats[2],
        "APs": stats[3],
        "APm": stats[4],
        "APl": stats[5],
        "AR1": stats[6],
        "AR10": stats[7],
        "AR100": stats[8],
        "ARs": stats[9],
        "ARm": stats[10],
        "ARl": stats[11],
        "stats": stats,
    }
