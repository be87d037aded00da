"""Serving front end of the port (counterpart of
transparent_object_detection_tpu/inference.py):

    device letterbox -> FocusModel forward -> DFL decode -> batched NMS ->
    unletterbox

All of it runs on the Predictor's device; the only transfers are the input
batch and the fixed-shape detection struct (plus one count read by the exact
NMS loop). PyTorch runs eagerly: there is no compiled program to cache.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from transparent_object_detection_tpu_torch.config import ModelConfig, PredictConfig
from transparent_object_detection_tpu_torch.models.detector import FocusModel, resolve_device
from transparent_object_detection_tpu_torch.ops.geometry import xywh2xyxy
from transparent_object_detection_tpu_torch.ops.nms import batched_nms
from transparent_object_detection_tpu_torch.ops.preprocess import (
    letterbox_batch,
    unletterbox_boxes,
)


def detect_step(model: FocusModel, images: torch.Tensor, image_shapes: torch.Tensor,
                input_shape: Tuple[int, int], predict_cfg: PredictConfig) -> Dict[str, torch.Tensor]:
    """Detection on already-letterboxed images.

    images (B, h, w, 3) float in [0, 1] with (h, w) == input_shape;
    image_shapes (B, 2) original (h, w) per image. Returns the batched_nms
    dict with boxes in original-image pixels."""
    decoded = model(images)["decoded"]
    dets = batched_nms(
        xywh2xyxy(decoded[..., :4]),
        decoded[..., 4:],
        conf_thres=predict_cfg.confidence,
        iou_thres=predict_cfg.nms_iou,
        max_detections=predict_cfg.max_detections,
        pre_nms_topk=predict_cfg.pre_nms_topk,
        mode=predict_cfg.nms_mode,
        class_agnostic=predict_cfg.class_agnostic,
    )
    dets["boxes"] = unletterbox_boxes(dets["boxes"], input_shape, image_shapes,
                                      predict_cfg.letterbox_image)
    return dets


class Predictor:
    """Batch detector front end on one device (CUDA unless `device` names
    another)."""

    def __init__(self, model: FocusModel, model_cfg: ModelConfig,
                 predict_cfg: Optional[PredictConfig] = None, device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.model_cfg = model_cfg
        self.predict_cfg = predict_cfg or PredictConfig()

    def _tensor(self, x, dtype=None) -> torch.Tensor:
        return torch.as_tensor(x).to(self.device, dtype=dtype)

    @torch.inference_mode()
    def detect_letterboxed(self, images, image_shapes) -> Dict[str, torch.Tensor]:
        """images already letterboxed to input_shape, float32 in [0, 1]."""
        return detect_step(self.model, self._tensor(images, torch.float32),
                           self._tensor(image_shapes, torch.float32),
                           self.model_cfg.input_shape, self.predict_cfg)

    @torch.inference_mode()
    def detect_raw_batch(self, raw_images, image_shapes) -> Dict[str, torch.Tensor]:
        """Uniform-size uint8 batch (B, H, W, 3); letterboxing runs on the
        device (the uint8 batch is what crosses to it)."""
        raw = self._tensor(raw_images)
        images = letterbox_batch(raw.float() / 255.0, self.model_cfg.input_shape)
        return detect_step(self.model, images, self._tensor(image_shapes, torch.float32),
                           self.model_cfg.input_shape, self.predict_cfg)

    def predict_image(self, image) -> List[Dict[str, Any]]:
        """One PIL image -> list of {box, score, class} in original pixels."""
        from transparent_object_detection_tpu_torch.utils.image import cvt_color, resize_image

        image = cvt_color(image)
        iw, ih = image.size
        h, w = self.model_cfg.input_shape
        boxed = resize_image(image, (w, h), letterbox_image=self.predict_cfg.letterbox_image)
        arr = np.asarray(boxed, dtype=np.float32)[None] / 255.0
        shapes = np.asarray([[ih, iw]], dtype=np.float32)
        return self.to_host_detections(self.detect_letterboxed(arr, shapes))[0]

    @torch.inference_mode()
    def class_activation_map(self, images) -> torch.Tensor:
        """Max class-probability heatmap per image at stride-8 resolution:
        (B, H/8, W/8) from letterboxed float images (B, H, W, 3)."""
        raw = self.model(self._tensor(images, torch.float32), decode=False)["raw"]
        cls = raw[0][..., 4 * self.model_cfg.reg_max:]
        return torch.sigmoid(cls.float()).amax(dim=-1)

    @staticmethod
    def to_host_detections(dets: Dict[str, torch.Tensor]) -> List[List[Dict[str, Any]]]:
        """Fixed-shape device struct -> per-image python lists."""
        boxes = dets["boxes"].cpu().numpy()
        scores = dets["scores"].cpu().numpy()
        classes = dets["classes"].cpu().numpy()
        valid = dets["valid"].cpu().numpy()
        out = []
        for b in range(boxes.shape[0]):
            out.append([
                {"box": boxes[b, i].tolist(), "score": float(scores[b, i]),
                 "class": int(classes[b, i])}
                for i in np.nonzero(valid[b])[0]
            ])
        return out
