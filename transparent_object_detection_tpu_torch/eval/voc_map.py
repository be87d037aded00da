"""VOC-style mAP, precision/recall/F1 and log-average miss rate: the port's
own numpy copy of transparent_object_detection_tpu/eval/voc_map.py.

In-memory rebuild of the reference's Cartucho-lineage evaluator
(utils/utils_map.py:258-722): per-class greedy IoU matching with the VOC
+1-pixel area convention (utils_map.py:450-453), AP via the monotonic
precision envelope (voc_ap, utils_map.py:98-129), and LAMR over 9 FPPI
points (utils_map.py:35-70). Works directly on arrays — no temp-directory
txt round trip — with an optional Cartucho-format txt-dir front end for
drop-in workflow parity (callbacks.py:196-207 writes those dirs).
"""
from __future__ import annotations

import glob
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclass
class ClassResult:
    ap: float
    precision: np.ndarray
    recall: np.ndarray
    f1: float
    prec_at_thresh: float
    rec_at_thresh: float
    lamr: float
    num_gt: int
    num_det: int


def voc_ap(recall: np.ndarray, precision: np.ndarray) -> float:
    """AP as the area under the monotonic precision envelope
    (utils_map.py:98-129)."""
    mrec = np.concatenate([[0.0], recall, [1.0]])
    mpre = np.concatenate([[0.0], precision, [0.0]])
    for i in range(len(mpre) - 2, -1, -1):
        mpre[i] = max(mpre[i], mpre[i + 1])
    idx = np.where(mrec[1:] != mrec[:-1])[0] + 1
    return float(np.sum((mrec[idx] - mrec[idx - 1]) * mpre[idx]))


def log_average_miss_rate(precision: np.ndarray, fp_cumsum: np.ndarray, num_images: int):
    """LAMR over 9 log-spaced FPPI points (utils_map.py:35-70)."""
    if precision.size == 0:
        return 0.0, np.array([1.0]), np.array([0.0])
    fppi = fp_cumsum / float(num_images)
    mr = 1.0 - precision
    fppi_tmp = np.concatenate([[-1.0], fppi])
    mr_tmp = np.concatenate([[1.0], mr])
    refs = np.logspace(-2.0, 0.0, num=9)
    points = []
    for r in refs:
        j = np.where(fppi_tmp <= r)[0][-1]
        points.append(mr_tmp[j])
    lamr = float(np.exp(np.mean(np.log(np.maximum(1e-10, np.asarray(points))))))
    return lamr, mr, fppi


def _iou_plus_one(box: np.ndarray, gts: np.ndarray) -> np.ndarray:
    """IoU with the VOC +1-pixel area convention (utils_map.py:445-460)."""
    ixmin = np.maximum(gts[:, 0], box[0])
    iymin = np.maximum(gts[:, 1], box[1])
    ixmax = np.minimum(gts[:, 2], box[2])
    iymax = np.minimum(gts[:, 3], box[3])
    iw = np.maximum(ixmax - ixmin + 1.0, 0.0)
    ih = np.maximum(iymax - iymin + 1.0, 0.0)
    inter = iw * ih
    union = (
        (box[2] - box[0] + 1.0) * (box[3] - box[1] + 1.0)
        + (gts[:, 2] - gts[:, 0] + 1.0) * (gts[:, 3] - gts[:, 1] + 1.0)
        - inter
    )
    return inter / np.maximum(union, 1e-10)


def evaluate_class(
    det_boxes: List[np.ndarray],
    det_scores: List[np.ndarray],
    gt_boxes: List[np.ndarray],
    gt_difficult: Optional[List[np.ndarray]],
    min_overlap: float,
    score_threshold: float,
) -> ClassResult:
    """Greedy-match one class across a dataset (utils_map.py:404-560).

    Per-image lists; det/gt boxes are (N, 4) xyxy.
    """
    n_images = len(det_boxes)
    if gt_difficult is None:
        gt_difficult = [np.zeros(len(g), dtype=bool) for g in gt_boxes]
    num_gt = int(sum((~d).sum() for d in gt_difficult))

    # flatten detections with image ids, sort by score desc
    img_ids = np.concatenate(
        [np.full(len(b), i, dtype=np.int64) for i, b in enumerate(det_boxes)]
    ) if any(len(b) for b in det_boxes) else np.zeros(0, dtype=np.int64)
    boxes = np.concatenate([b.reshape(-1, 4) for b in det_boxes]) if len(img_ids) else np.zeros((0, 4))
    scores = np.concatenate([s for s in det_scores]) if len(img_ids) else np.zeros(0)
    order = np.argsort(-scores)
    img_ids, boxes, scores = img_ids[order], boxes[order], scores[order]

    matched = [np.zeros(len(g), dtype=bool) for g in gt_boxes]
    tp = np.zeros(len(boxes))
    fp = np.zeros(len(boxes))
    for d in range(len(boxes)):
        i = img_ids[d]
        gts = gt_boxes[i].reshape(-1, 4)
        if len(gts) == 0:
            fp[d] = 1.0
            continue
        ious = _iou_plus_one(boxes[d], gts)
        j = int(np.argmax(ious))
        if ious[j] >= min_overlap:
            if gt_difficult[i][j]:
                continue  # difficult GT: neither TP nor FP (utils_map.py:487)
            if not matched[i][j]:
                matched[i][j] = True
                tp[d] = 1.0
            else:
                fp[d] = 1.0
        else:
            fp[d] = 1.0

    tp_cum = np.cumsum(tp)
    fp_cum = np.cumsum(fp)
    recall = tp_cum / max(num_gt, 1)
    precision = tp_cum / np.maximum(tp_cum + fp_cum, 1e-10)
    ap = voc_ap(recall.copy(), precision.copy()) if num_gt > 0 else 0.0
    lamr, _, _ = log_average_miss_rate(precision, fp_cum, n_images)

    # point metrics at the score threshold (utils_map.py:565-585)
    keep = scores >= score_threshold
    n_at = int(keep.sum())
    tp_at = float(tp[keep].sum())
    rec_at = tp_at / max(num_gt, 1)
    prec_at = tp_at / max(n_at, 1)
    f1 = (
        2 * prec_at * rec_at / (prec_at + rec_at)
        if (prec_at + rec_at) > 0
        else 0.0
    )
    return ClassResult(
        ap=ap,
        precision=precision,
        recall=recall,
        f1=f1,
        prec_at_thresh=prec_at,
        rec_at_thresh=rec_at,
        lamr=lamr,
        num_gt=num_gt,
        num_det=len(boxes),
    )


def voc_map(
    detections: Sequence[np.ndarray],
    ground_truths: Sequence[np.ndarray],
    num_classes: int,
    min_overlap: float = 0.5,
    score_threshold: float = 0.5,
    difficult: Optional[Sequence[np.ndarray]] = None,
) -> Tuple[float, Dict[int, ClassResult]]:
    """Dataset mAP@min_overlap.

    detections: per image (N, 6) [x1, y1, x2, y2, score, cls].
    ground_truths: per image (M, 5) [x1, y1, x2, y2, cls].
    difficult: optional per-image (M,) bool.
    Returns (mAP over classes with GT, per-class results).
    """
    results: Dict[int, ClassResult] = {}
    aps = []
    for c in range(num_classes):
        det_b, det_s, gt_b, gt_d = [], [], [], []
        for i, (det, gt) in enumerate(zip(detections, ground_truths)):
            det = det.reshape(-1, 6)
            gt = gt.reshape(-1, 5)
            dm = det[:, 5].astype(int) == c
            gm = gt[:, 4].astype(int) == c
            det_b.append(det[dm, :4])
            det_s.append(det[dm, 4])
            gt_b.append(gt[gm, :4])
            if difficult is not None:
                gt_d.append(np.asarray(difficult[i]).reshape(-1)[gm])
            else:
                gt_d.append(np.zeros(int(gm.sum()), dtype=bool))
        res = evaluate_class(det_b, det_s, gt_b, gt_d, min_overlap, score_threshold)
        results[c] = res
        if res.num_gt > 0:
            aps.append(res.ap)
    return (float(np.mean(aps)) if aps else 0.0), results


# ----------------------------------------------------------------------------
# Cartucho txt-dir front end (drop-in for the reference's get_map file flow)
# ----------------------------------------------------------------------------


def read_cartucho_dirs(
    gt_dir: str, dr_dir: str, class_names: Sequence[str]
) -> Tuple[List[np.ndarray], List[np.ndarray], List[np.ndarray]]:
    """Read ground-truth/ and detection-results/ txt dirs
    (format written by callbacks.py:196-207): per image one txt, lines
    `name x1 y1 x2 y2` (gt, optional trailing 'difficult') and
    `name score x1 y1 x2 y2` (detections)."""
    name_to_id = {n: i for i, n in enumerate(class_names)}
    gts, dets, diffs = [], [], []
    for gt_path in sorted(glob.glob(os.path.join(gt_dir, "*.txt"))):
        image_id = os.path.basename(gt_path)[:-4]
        g_rows, d_flags = [], []
        with open(gt_path, encoding="utf-8") as f:
            for ln in f:
                parts = ln.split()
                if not parts:
                    continue
                difficult = parts[-1] == "difficult"
                if difficult:
                    parts = parts[:-1]
                name, x1, y1, x2, y2 = parts[-5], *parts[-4:]
                if name not in name_to_id:
                    continue
                g_rows.append([float(x1), float(y1), float(x2), float(y2), name_to_id[name]])
                d_flags.append(difficult)
        d_rows = []
        dr_path = os.path.join(dr_dir, image_id + ".txt")
        if os.path.exists(dr_path):
            with open(dr_path, encoding="utf-8") as f:
                for ln in f:
                    parts = ln.split()
                    if len(parts) < 6:
                        continue
                    name, score, x1, y1, x2, y2 = parts[-6:]
                    if name not in name_to_id:
                        continue
                    d_rows.append(
                        [float(x1), float(y1), float(x2), float(y2), float(score), name_to_id[name]]
                    )
        gts.append(np.asarray(g_rows, dtype=np.float64).reshape(-1, 5))
        dets.append(np.asarray(d_rows, dtype=np.float64).reshape(-1, 6))
        diffs.append(np.asarray(d_flags, dtype=bool))
    return dets, gts, diffs


def get_map_from_dirs(
    gt_dir: str,
    dr_dir: str,
    class_names: Sequence[str],
    min_overlap: float = 0.5,
    score_threshold: float = 0.5,
) -> Tuple[float, Dict[int, ClassResult]]:
    dets, gts, diffs = read_cartucho_dirs(gt_dir, dr_dir, class_names)
    return voc_map(dets, gts, len(class_names), min_overlap, score_threshold, diffs)


def write_results(
    out_dir: str,
    mean_ap: float,
    results: Dict[int, ClassResult],
    class_names: Sequence[str],
    min_overlap: float = 0.5,
    plots: bool = True,
) -> str:
    """results.txt + per-class PR / AP / F1-P-R / LAMR artifacts
    (the reporting surface of utils_map.py:404-721)."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "results.txt")
    with open(path, "w", encoding="utf-8") as f:
        f.write(f"# mAP@{min_overlap}: {mean_ap * 100:.2f}%\n")
        for c, r in results.items():
            name = class_names[c] if c < len(class_names) else str(c)
            f.write(
                f"{name}: AP={r.ap * 100:.2f}% F1={r.f1:.3f} "
                f"P={r.prec_at_thresh * 100:.2f}% R={r.rec_at_thresh * 100:.2f}% "
                f"LAMR={r.lamr:.3f} GT={r.num_gt} Det={r.num_det}\n"
            )
    if plots:
        try:
            import matplotlib

            matplotlib.use("Agg")
            from matplotlib import pyplot as plt

            for c, r in results.items():
                if r.num_gt == 0 or len(r.recall) == 0:
                    continue
                name = class_names[c] if c < len(class_names) else str(c)
                plt.figure()
                plt.plot(r.recall, r.precision, linewidth=2)
                plt.fill_between(r.recall, r.precision, alpha=0.2)
                plt.xlabel("Recall")
                plt.ylabel("Precision")
                plt.title(f"{name}: AP@{min_overlap}={r.ap * 100:.2f}%")
                plt.xlim(0, 1)
                plt.ylim(0, 1.05)
                plt.grid(True)
                plt.savefig(os.path.join(out_dir, f"pr_{name}.png"))
                plt.close("all")

            # per-metric class summaries, one horizontal bar per class
            # (the reference's mAP/F1/Recall/Precision/lamr plot set,
            # utils_map.py:560-721)
            names = [
                class_names[c] if c < len(class_names) else str(c) for c in results
            ]
            metric_sets = {
                "mAP": ([r.ap for r in results.values()],
                        f"mAP@{min_overlap} = {mean_ap * 100:.2f}%"),
                "F1": ([r.f1 for r in results.values()], "F1 at score threshold"),
                "Recall": ([r.rec_at_thresh for r in results.values()],
                           "Recall at score threshold"),
                "Precision": ([r.prec_at_thresh for r in results.values()],
                              "Precision at score threshold"),
                "lamr": ([r.lamr for r in results.values()],
                         "log-average miss rate (lower is better)"),
            }
            for fname, (values, title) in metric_sets.items():
                plt.figure(figsize=(8, max(2, 0.4 * len(names) + 1)))
                ypos = np.arange(len(names))
                plt.barh(ypos, values)
                for y, v in zip(ypos, values):
                    plt.text(v, y, f" {v:.3f}", va="center")
                plt.yticks(ypos, names)
                plt.title(title)
                plt.xlim(0, 1.1)
                plt.tight_layout()
                plt.savefig(os.path.join(out_dir, f"{fname}.png"))
                plt.close("all")
        except Exception:
            pass
    return path
