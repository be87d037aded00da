"""Full detector (counterpart of
transparent_object_detection_tpu/models/detector.py): FocusModel = Backbone
-> Neck -> Head; the evaluation forward ends in the on-device DFL decode,
the training forward (`model.train()`) in the raw maps."""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from transparent_object_detection_tpu_torch.config import Int8Variants, ModelConfig
from transparent_object_detection_tpu_torch.models.backbone import Backbone
from transparent_object_detection_tpu_torch.models.head import BranchTower, Head
from transparent_object_detection_tpu_torch.models.neck import Neck


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. Without a card and without an explicit device, raise; there is
    no silent CPU fallback."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the GPU; pass device='cpu' "
                "explicitly to run the plain PyTorch versions on the CPU"
            )
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    return device


class FocusModel(nn.Module):
    """The FOCUS detector graph."""

    def __init__(self, num_classes: int = 1, base_channels: int = 128, base_depth: int = 2,
                 deep_mul: float = 0.5, num_heads: int = 8, reg_max: int = 16,
                 strides: Tuple[int, int, int] = (8, 16, 32),
                 dtype: torch.dtype = torch.bfloat16, norm_dtype: torch.dtype = torch.float32,
                 lane_align_heads: bool = True, attention_impl: Optional[str] = None,
                 int8_dense: bool = False, int8_attn: bool = False,
                 int8_variants: Optional[Int8Variants] = None, remat: bool = False):
        super().__init__()
        self.dtype = dtype
        self.backbone = Backbone(base_channels, base_depth, deep_mul, dtype, attention_impl,
                                 int8_attn)
        self.neck = Neck(base_channels, base_depth, deep_mul, num_heads, dtype, norm_dtype,
                         lane_align_heads, attention_impl, int8_dense, int8_attn,
                         int8_variants, remat)
        filters = (base_channels * 4, base_channels * 8, int(base_channels * 16 * deep_mul))
        self.head = Head(num_classes, filters, strides, reg_max, dtype)

    def forward(self, images: torch.Tensor, decode: bool = True) -> Dict[str, Any]:
        """images: (B, H, W, 3) float in [0, 1], H and W divisible by 32.
        Returns {"raw": per-level (B, h, w, 4*reg_max + nc) maps,
        "decoded": (B, sum(hw), 4 + nc)} (decoded only in evaluation mode
        with decode=True; training mode returns the raw maps alone)."""
        x = images.to(self.dtype).permute(0, 3, 1, 2)
        if x.is_cuda:
            x = x.contiguous(memory_format=torch.channels_last)
        raw = self.head(self.neck(self.backbone(x)))
        out: Dict[str, Any] = {"raw": tuple(raw)}
        if decode and not self.training:
            out["decoded"] = self.head.decode(raw)
        return out


def build_model(cfg: ModelConfig, device=None, attention_impl: Optional[str] = None,
                seed: Optional[int] = 0,
                int8_variants: Optional[Int8Variants] = None) -> FocusModel:
    """FocusModel at `cfg`'s scale, in evaluation mode on `device` (CUDA
    unless given; a trainer puts it in training mode). Weights are the
    seeded initialisation of `init_weights` (seed=None keeps PyTorch's
    defaults); load a JAX checkpoint with
    weights.load_jax_variables. attention_impl="plain" runs the attention
    kernels' plain PyTorch versions (comparison only). int8_dense and
    int8_attn select the int8 serving paths, alone or together;
    `int8_variants` their TEB handoff variants (None reads
    `Int8Variants.from_env()`, the JAX package's TOD_* variables, once
    here); they change nothing with both int8 flags off. `cfg.remat`
    recomputes each neck fusion node's activations in the backward."""
    if cfg.int8_1x1:
        raise NotImplementedError("int8_1x1 is not ported yet")
    device = resolve_device(device)
    with device:  # parameters made where they live (1.35 B at phi='m')
        model = FocusModel(
            num_classes=cfg.num_classes, base_channels=cfg.base_channels,
            base_depth=cfg.base_depth, deep_mul=cfg.deep_mul, num_heads=cfg.num_heads,
            reg_max=cfg.reg_max, strides=cfg.strides, dtype=getattr(torch, cfg.compute_dtype),
            norm_dtype=getattr(torch, cfg.norm_dtype), lane_align_heads=cfg.lane_align_heads,
            attention_impl=attention_impl, int8_dense=cfg.int8_dense, int8_attn=cfg.int8_attn,
            int8_variants=int8_variants or Int8Variants.from_env(), remat=cfg.remat,
        )
    if seed is not None:
        init_weights(model, seed)
    return model.eval()


def set_attention_impl(model: nn.Module, impl: Optional[str]) -> nn.Module:
    """Switch every kernel of `model` (attention forward and backward, and
    the int8 projections of the TEBs) between the kernels (None) and their
    plain versions ("plain"), weights untouched."""
    for m in model.modules():
        if hasattr(m, "attention_impl"):
            m.attention_impl = impl
    return model


@torch.no_grad()
def init_weights(model: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded initialisation after the flax defaults: conv and dense kernels
    LeCun-normal (std 1/sqrt(fan_in)), dense biases 0, norms at identity,
    SelfAttention gamma 0, head output biases at their prior values."""
    gen = torch.Generator().manual_seed(seed)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "weight" and p.dim() >= 2:
            fan_in = p[0].numel()
            p.copy_(torch.randn(p.shape, generator=gen) / fan_in ** 0.5)
        elif leaf == "weight":
            p.fill_(1.0)
        elif leaf == "gamma" or leaf == "bias":
            p.zero_()
    for m in model.modules():
        if isinstance(m, BranchTower):
            m.out.bias.fill_(m.bias_init_value)
    return model
