"""Configuration of the PyTorch port: its own copy of the scale table and of
the model and predict settings of transparent_object_detection_tpu/config.py
(the port imports nothing of the JAX package).

Fields the port does not implement yet (`int8_1x1`, `remat`) are kept so a
configuration reads the same in both packages; `build_model` refuses them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

# (base_channels, base_depth, deep_mul) per model scale.
SCALE_TABLE: Dict[str, Tuple[int, int, float]] = {
    "n": (64, 1, 0.33),
    "s": (128, 2, 0.5),
    "m": (256, 3, 0.67),
    "l": (512, 4, 1.0),
    "x": (1024, 5, 1.25),
}


@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters."""

    num_classes: int = 1
    phi: str = "s"
    input_shape: Tuple[int, int] = (640, 640)  # (h, w), divisible by 32
    reg_max: int = 16  # DFL bins
    compute_dtype: str = "bfloat16"
    # Largest head count <= num_heads dividing the TEB width (see
    # models/blocks._pick_num_heads).
    num_heads: int = 8
    remat: bool = False  # training only; not ported yet
    norm_dtype: str = "float32"  # LayerNorm compute dtype
    # Prefer head counts whose head width is a multiple of 128 (6 x 256 on the
    # phi='s' 1536-channel TEBs); part of the function being computed.
    lane_align_heads: bool = True
    # int8 serving: the TEB projections as int8 GEMMs (ops/quant_matmul.py)
    # and int8 flash attention on large maps (ops/attention_int8.py); each
    # works alone or with the other. int8_1x1 (fused int8 1x1 convs) is not
    # ported yet and `build_model` refuses it.
    int8_dense: bool = False
    int8_attn: bool = False
    int8_1x1: bool = False

    @property
    def scale(self) -> Tuple[int, int, float]:
        if self.phi not in SCALE_TABLE:
            raise ValueError(f"invalid phi {self.phi!r}; choose from {sorted(SCALE_TABLE)}")
        return SCALE_TABLE[self.phi]

    @property
    def base_channels(self) -> int:
        return self.scale[0]

    @property
    def base_depth(self) -> int:
        return self.scale[1]

    @property
    def deep_mul(self) -> float:
        return self.scale[2]

    @property
    def strides(self) -> Tuple[int, int, int]:
        return (8, 16, 32)

    @property
    def feat_shapes(self) -> Tuple[Tuple[int, int], ...]:
        h, w = self.input_shape
        return tuple((h // s, w // s) for s in self.strides)

    @property
    def num_anchors(self) -> int:
        return sum(h * w for h, w in self.feat_shapes)


@dataclass(frozen=True)
class PredictConfig:
    """Inference settings."""

    confidence: float = 0.5
    nms_iou: float = 0.4
    max_detections: int = 100
    pre_nms_topk: int = 1024  # candidates kept before NMS
    letterbox_image: bool = True
    nms_mode: str = "exact"  # "exact" greedy | "fast" YOLACT-style
    class_agnostic: bool = False
