"""Configuration of the PyTorch port: its own copy of the scale table and of
the model, training and predict settings of
transparent_object_detection_tpu/config.py (the port imports nothing of the
JAX package).
"""
from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional, Tuple

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
    remat: bool = False  # recompute each neck fusion node's activations in the backward
    norm_dtype: str = "float32"  # LayerNorm compute dtype
    # Prefer head counts whose head width is a multiple of 128 (6 x 256 on the
    # phi='s' 1536-channel TEBs); part of the function being computed.
    lane_align_heads: bool = True
    # int8 serving: the TEB projections as int8 GEMMs (ops/quant_matmul.py),
    # int8 flash attention on large maps (ops/attention_int8.py), and the
    # eligible 1x1 convs as one int8 GEMM with BatchNorm folded in
    # (models/blocks.ConvBNAct, `int8_1x1_profitable`); each works alone or
    # with the others.
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
class Int8Variants:
    """The int8 TEB's handoff variants, which the JAX package reads from the
    environment inside its TEB (the same variable names and defaults;
    `from_env` reads them). They change nothing unless `int8_dense` and/or
    `int8_attn` is on, and each is part of the function computed.

    attn_handoff (TOD_ATTN_HANDOFF): the qkv projection emits an int8
        payload, attention consumes it (k/v requantized per key block) and
        its int8 output feeds attn_out.
    attn_qout (TOD_ATTN_QOUT): only the output side of that handoff.
    w4a4_mlp1 (TOD_W4A4_MLP1): mlp1 on int4-range weights and activations;
        it turns the LN handoff off.
    ln_handoff (TOD_LN_HANDOFF) and ln_handoff_min_rows
        (TOD_LN_HANDOFF_MIN_ROWS): attn_out emits the LN2-normalized payload
        for mlp1 from this many rows (B * N) up.
    int8_1x1_narrow (TOD_INT8_1X1_NARROW): with `int8_1x1`, also route the
        512 -> 256 1x1 convs of 100,000 rows and more
        (`models.blocks.int8_1x1_profitable`); nothing else reads it.
    """

    attn_handoff: bool = False
    attn_qout: bool = False
    w4a4_mlp1: bool = False
    ln_handoff: bool = True
    ln_handoff_min_rows: int = 51200
    int8_1x1_narrow: bool = False

    @classmethod
    def from_env(cls, environ: Optional[Mapping[str, str]] = None) -> "Int8Variants":
        env = os.environ if environ is None else environ
        on = lambda name, default: env.get(name, default) == "1"
        return cls(
            attn_handoff=on("TOD_ATTN_HANDOFF", "0"),
            attn_qout=on("TOD_ATTN_QOUT", "0"),
            w4a4_mlp1=on("TOD_W4A4_MLP1", "0"),
            ln_handoff=on("TOD_LN_HANDOFF", "1"),
            ln_handoff_min_rows=int(env.get("TOD_LN_HANDOFF_MIN_ROWS", "51200")),
            int8_1x1_narrow=on("TOD_INT8_1X1_NARROW", "0"),
        )


@dataclass(frozen=True)
class TrainConfig:
    """Training knobs (the reference trainer's constant block): the same
    fields and defaults as the JAX package's, read by the train step and by
    `train.trainer.Trainer.fit` (schedule, data, augmentation, io)."""

    seed: int = 11
    # -- schedule ---------------------------------------------------------
    init_epoch: int = 0
    freeze_epoch: int = 50
    unfreeze_epoch: int = 300
    freeze_train: bool = True
    freeze_batch_size: int = 32
    unfreeze_batch_size: int = 16
    # -- optimizer --------------------------------------------------------
    init_lr: float = 1e-2
    min_lr_ratio: float = 0.01  # min_lr = init_lr * 0.01
    optimizer_type: str = "sgd"  # "sgd" | "adam"
    momentum: float = 0.937
    weight_decay: float = 5e-4
    lr_decay_type: str = "cos"  # "cos" | "step"
    nbs: int = 64  # nominal batch size for lr scaling
    grad_clip_norm: float = 10.0
    # -- loss -------------------------------------------------------------
    box_weight: float = 7.5
    cls_weight: float = 0.5
    dfl_weight: float = 1.5
    tal_topk: int = 10
    tal_alpha: float = 0.5
    tal_beta: float = 6.0
    label_smoothing: float = 0.0
    # -- EMA --------------------------------------------------------------
    ema: bool = True
    ema_decay: float = 0.9999
    ema_tau: int = 2000
    # -- augmentation -----------------------------------------------------
    mosaic: bool = True
    mosaic_prob: float = 0.5
    mixup: bool = True
    mixup_prob: float = 0.5
    special_aug_ratio: float = 0.7
    max_boxes: int = 128  # padded ground-truth slots per image
    # -- io / logging -----------------------------------------------------
    save_period: int = 10
    save_dir: str = "logs"
    eval_flag: bool = True
    eval_period: int = 10
    num_workers: int = 4
    train_annotation_path: str = "train.txt"
    val_annotation_path: str = "val.txt"

    @property
    def min_lr(self) -> float:
        return self.init_lr * self.min_lr_ratio

    def fit_lr(self, batch_size: int) -> Tuple[float, float]:
        """Batch-size-scaled (init, min) lr with per-optimizer clamps."""
        lr_limit_max = 1e-3 if self.optimizer_type == "adam" else 5e-2
        lr_limit_min = 3e-4 if self.optimizer_type == "adam" else 5e-4
        init_lr_fit = min(max(batch_size / self.nbs * self.init_lr, lr_limit_min), lr_limit_max)
        min_lr_fit = min(
            max(batch_size / self.nbs * self.min_lr, lr_limit_min * 1e-2), lr_limit_max * 1e-2
        )
        return init_lr_fit, min_lr_fit


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


def _from_dict(cls, d: Dict[str, Any]):
    """A `cls` dataclass from one section of a config file: unknown keys
    refused, lists read as tuples."""
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(d) - names
    if unknown:
        raise ValueError(f"unknown {cls.__name__} keys: {sorted(unknown)}")
    return cls(**{k: tuple(v) if isinstance(v, list) else v for k, v in d.items()})


def load_config(path: str) -> Tuple[ModelConfig, "TrainConfig", PredictConfig]:
    """(ModelConfig, TrainConfig, PredictConfig) from the {model: ...,
    train: ..., predict: ...} sections of a JSON or YAML file (YAML through
    `yaml.safe_load`, imported only for a file that is not JSON)."""
    import json

    with open(path, encoding="utf-8") as f:
        text = f.read()
    try:
        data = json.loads(text)
    except json.JSONDecodeError:
        import yaml

        data = yaml.safe_load(text)
    return (
        _from_dict(ModelConfig, data.get("model", {})),
        _from_dict(TrainConfig, data.get("train", {})),
        _from_dict(PredictConfig, data.get("predict", {})),
    )
