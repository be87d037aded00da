"""Batched class-aware non-maximum suppression on the device, fixed shapes
(counterpart of transparent_object_detection_tpu/ops/nms.py).

Per-class separation by the coordinate-offset trick (class * 8192). Two
suppression modes:
  * "exact": sequential greedy NMS over the score-sorted candidates (the
    keep set of torchvision's nms): on the card one launch of
    csrc/nms_exact.cu (`nms_exact`, the operator focus::nms_exact), whose
    loop runs on the device and reads nothing back to the host; on the CPU
    its plain version, `nms_exact_plain`;
  * "fast": YOLACT-style one-shot suppression.

Ordering: `jax.lax.top_k` breaks score ties lower-index-first; `torch.topk`
promises no order on CUDA, so ranking is a stable descending sort.
"""
from __future__ import annotations

import ctypes
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


NMS_EXACT_MAX_K = 1024  # csrc/nms_exact.cu: one thread a candidate, a block of 1,024


def nms_exact_plain(iou: torch.Tensor, valid: torch.Tensor, iou_thres: float) -> torch.Tensor:
    """Greedy suppression over score-sorted candidates: iou (B, K, K),
    valid (B, K) -> keep (B, K). A box suppressed by an already-suppressed box
    is not removed. Valid candidates come first (they are sorted by score and
    invalid ones score -1), so rows past the largest valid count cannot
    suppress anything and the loop stops there: one host read of that count,
    the same keep set as the full K-step loop. The plain version of
    `nms_exact`."""
    k = iou.shape[-1]
    idx = torch.arange(k, device=iou.device)
    over = (iou > iou_thres) & (idx[None, :] > idx[:, None])  # (B, K, K), j after i
    keep = torch.ones_like(valid)
    for i in range(int(valid.sum(dim=-1).max())):
        alive = keep[:, i] & valid[:, i]
        keep &= ~(over[:, i, :] & alive[:, None])
    return keep & valid


def _nms_lib():
    from transparent_object_detection_tpu_torch.kernels import _build

    lib = _build.load("nms_exact")
    if not getattr(lib, "_argtypes_set", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.nms_exact.argtypes = [vp, vp, vp, ci, ci, ctypes.c_float, vp]
        lib.nms_exact.restype = ci
        lib._argtypes_set = True
    return lib


def nms_exact(iou: torch.Tensor, valid: torch.Tensor, iou_thres: float) -> torch.Tensor:
    """The exact keep set (`nms_exact_plain`'s, bit for bit) of iou (B, K, K)
    fp32 and valid (B, K) bool, valid candidates first in each row. A CUDA
    tensor launches csrc/nms_exact.cu (K <= NMS_EXACT_MAX_K, else
    ValueError), counted in `launches`; its loop is bounded on the device,
    so nothing is read back to the host and the call can be captured in a
    CUDA graph. A CPU tensor runs `nms_exact_plain`."""
    if iou.device.type == "cpu":
        return nms_exact_plain(iou, valid, iou_thres)
    b, k = valid.shape
    if iou.shape != (b, k, k) or iou.dtype != torch.float32 or valid.dtype != torch.bool:
        raise ValueError(f"nms_exact takes fp32 iou (B, K, K) and bool valid (B, K), got "
                         f"{iou.dtype} {tuple(iou.shape)} and {valid.dtype} {tuple(valid.shape)}")
    if k > NMS_EXACT_MAX_K:
        raise ValueError(f"nms_exact takes at most {NMS_EXACT_MAX_K} candidates an image "
                         f"(pre_nms_topk), got {k}")
    if iou.device.type != "cuda" or valid.device != iou.device:
        raise ValueError(f"nms_exact: iou on {iou.device}, valid on {valid.device}")
    iou, valid = iou.contiguous(), valid.contiguous()
    keep = torch.empty_like(valid)
    err = _nms_lib().nms_exact(iou.data_ptr(), valid.data_ptr(), keep.data_ptr(), b, k,
                               iou_thres, torch.cuda.current_stream(iou.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"nms_exact: CUDA launch failed with cudaError_t {err}")
    nms_exact.launches += 1
    return keep


def reset_launch_counts() -> None:
    nms_exact.launches = 0


reset_launch_counts()


def _exact_greedy_keep(iou: torch.Tensor, valid: torch.Tensor, iou_thres: float) -> torch.Tensor:
    """The exact keep set through the registered operator (ops/library.py:
    focus::nms_exact): the kernel for CUDA tensors, `nms_exact_plain` for
    CPU ones."""
    return torch.ops.focus.nms_exact(iou, valid, float(iou_thres))


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
