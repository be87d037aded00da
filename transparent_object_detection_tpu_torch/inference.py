"""Serving front end of the port (counterpart of
transparent_object_detection_tpu/inference.py):

    device letterbox -> FocusModel forward -> DFL decode -> batched NMS ->
    unletterbox

All of it runs on the Predictor's device; the only transfers are the input
batch and the fixed-shape detection struct (plus one count read by the exact
NMS loop). PyTorch runs eagerly: there is no compiled program to cache.

On a mesh (parallel/) every rank is handed the global batch, as the JAX
caller hands one global array: each data index runs its rows, and the
fixed-shape results are all-gathered over the data axis, so every rank
returns the global result. With a model axis the neck TEBs run tensor-
parallel on the Predictor's own sharded copy of the weights.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from transparent_object_detection_tpu_torch.config import ModelConfig, PredictConfig
from transparent_object_detection_tpu_torch.models.blocks import global_rows
from transparent_object_detection_tpu_torch.models.detector import FocusModel, resolve_device
from transparent_object_detection_tpu_torch.ops.geometry import xywh2xyxy
from transparent_object_detection_tpu_torch.ops.nms import batched_nms
from transparent_object_detection_tpu_torch.ops.preprocess import (
    letterbox_batch,
    unletterbox_boxes,
)
from transparent_object_detection_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    Mesh,
    all_gather_cat,
    replicate_state,
    rows_of,
)
from transparent_object_detection_tpu_torch.parallel.tp import MODEL_AXIS, tp_serving_copy


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
    another).

    mesh: an optional `parallel.Mesh` (`make_mesh`, `make_2d_mesh`) this
    process is a rank of. The mesh's first rank's weights are broadcast to
    every rank (one replicated copy, as JAX places it); each call takes the
    global batch, runs this rank's rows of it (batch sizes must be a
    multiple of `data_shards`, else ValueError) and returns the global
    result, all-gathered over the data axis. A mesh with a model axis of
    tp > 1 serves tensor-parallel: `model` becomes the Predictor's own copy
    (`parallel.tp.tp_serving_copy`: this rank's shards of the TEB
    projections and of the big kernels, qkv rows canonicalized, weights of
    two or more dimensions in the compute type), the caller's model left as
    it was. The int8 1x1 convs gate on the global batch's rows, as JAX's do
    on its global array (`blocks.global_rows`). Every rank of the mesh
    makes the same calls in the same order."""

    def __init__(self, model: FocusModel, model_cfg: ModelConfig,
                 predict_cfg: Optional[PredictConfig] = None, device=None,
                 mesh: Optional[Mesh] = None):
        self.device = resolve_device(device)
        self.mesh = mesh
        model = model.to(self.device)
        if mesh is not None:
            replicate_state(model, mesh)
            if mesh.size(MODEL_AXIS) > 1:
                model = tp_serving_copy(model, mesh)
        self.model = model.eval()
        self.model_cfg = model_cfg
        self.predict_cfg = predict_cfg or PredictConfig()

    @property
    def data_shards(self) -> int:
        """Size of the data axis the Predictor splits a batch over (1 with no
        mesh). Batch sizes must be a multiple of it; callers that batch
        lists of any length (EvalCallback) pad to it."""
        return 1 if self.mesh is None else self.mesh.size(DATA_AXIS)

    def _tensor(self, x, dtype=None) -> torch.Tensor:
        return torch.as_tensor(x).to(self.device, dtype=dtype)

    def _rows(self, *arrays):
        """This rank's rows of each global batch array, on the device."""
        n = self.data_shards
        if n > 1 and arrays[0].shape[0] % n:
            raise ValueError(
                f"batch size {arrays[0].shape[0]} does not divide the mesh data axis ({n}); "
                f"pad the batch to a multiple of Predictor.data_shards")
        if self.mesh is None:
            return arrays
        return tuple(rows_of(a, self.mesh) for a in arrays)

    def _gathered(self, out):
        """The global result: each tensor's rows from every data rank."""
        if self.mesh is None:
            return out
        if isinstance(out, torch.Tensor):
            return all_gather_cat(out, self.mesh, DATA_AXIS, 0)
        return {k: all_gather_cat(v, self.mesh, DATA_AXIS, 0) for k, v in out.items()}

    @torch.inference_mode()
    def detect_letterboxed(self, images, image_shapes) -> Dict[str, torch.Tensor]:
        """images already letterboxed to input_shape, float32 in [0, 1]."""
        images, image_shapes = self._rows(self._tensor(images, torch.float32),
                                          self._tensor(image_shapes, torch.float32))
        with global_rows(self.model, self.data_shards):
            dets = detect_step(self.model, images, image_shapes, self.model_cfg.input_shape,
                               self.predict_cfg)
        return self._gathered(dets)

    @torch.inference_mode()
    def detect_raw_batch(self, raw_images, image_shapes) -> Dict[str, torch.Tensor]:
        """Uniform-size uint8 batch (B, H, W, 3); letterboxing runs on the
        device (the uint8 batch is what crosses to it)."""
        raw, shapes = self._rows(self._tensor(raw_images),
                                 self._tensor(image_shapes, torch.float32))
        images = letterbox_batch(raw.float() / 255.0, self.model_cfg.input_shape)
        with global_rows(self.model, self.data_shards):
            dets = detect_step(self.model, images, shapes, self.model_cfg.input_shape,
                               self.predict_cfg)
        return self._gathered(dets)

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
        (images,) = self._rows(self._tensor(images, torch.float32))
        with global_rows(self.model, self.data_shards):
            raw = self.model(images, decode=False)["raw"]
        cls = raw[0][..., 4 * self.model_cfg.reg_max:]
        return self._gathered(torch.sigmoid(cls.float()).amax(dim=-1))

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
