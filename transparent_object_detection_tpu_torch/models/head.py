"""Anchor-free decoupled detection head with DFL (counterpart of
transparent_object_detection_tpu/models/head.py).

Per pyramid level a box tower and a cls tower (Conv3x3 -> CBAM -> Conv3x3 ->
CBAM -> 1x1 conv with bias). `decode` turns the raw maps into
(B, sum(HW), 4 + nc): xywh in input pixels and sigmoid class scores, in fp32.
"""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from transparent_object_detection_tpu_torch.models.blocks import (
    CBAM,
    ConvBNAct,
    dfl_expectation,
    gather_outputs,
    model_input,
)
from transparent_object_detection_tpu_torch.ops.geometry import make_anchors


class BranchTower(nn.Module):
    """Conv3x3 -> CBAM -> Conv3x3 -> CBAM -> plain 1x1 conv with bias
    initialised to `bias_init_value`."""

    def __init__(self, in_features: int, mid_features: int, out_features: int,
                 bias_init_value: float, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.bias_init_value = bias_init_value
        self.conv1 = ConvBNAct(in_features, mid_features, 3, dtype=dtype)
        self.cbam1 = CBAM(mid_features, dtype=dtype)
        self.conv2 = ConvBNAct(mid_features, mid_features, 3, dtype=dtype)
        self.cbam2 = CBAM(mid_features, dtype=dtype)
        self.out = nn.Conv2d(mid_features, out_features, 1, bias=True)
        nn.init.constant_(self.out.bias, bias_init_value)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.cbam2(self.conv2(self.cbam1(self.conv1(x))))
        dt, out = self.dtype, self.out
        if getattr(out, "tp_mesh", None) is not None:  # outputs sharded: bias after the gather
            y = gather_outputs(F.conv2d(model_input(x, out), out.weight.to(dt)), out, 1)
            return y + out.bias.to(dt)[:, None, None]
        return F.conv2d(x, out.weight.to(dt), out.bias.to(dt))


class Head(nn.Module):
    def __init__(self, num_classes: int, filters: Tuple[int, int, int],
                 strides: Tuple[int, int, int] = (8, 16, 32), reg_max: int = 16,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.num_classes, self.strides, self.reg_max = num_classes, tuple(strides), reg_max
        c1 = max(filters[0], num_classes)
        c2 = max(filters[0] // 4, reg_max * 4)
        for i, f in enumerate(filters):
            setattr(self, f"box{i}", BranchTower(f, c2, 4 * reg_max, 1.0, dtype))
            setattr(self, f"cls{i}", BranchTower(f, c1, num_classes,
                                                 self.cls_bias(self.strides[i]), dtype))

    def cls_bias(self, stride: int) -> float:
        """Prior-probability bias: log(5 / nc / (640 / s)^2)."""
        return math.log(max(5.0 / self.num_classes / (640.0 / stride) ** 2, 1e-10))

    def forward(self, feats: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Raw per-level maps in the JAX layout (B, H, W, 4*reg_max + nc)."""
        raw = []
        for i, x in enumerate(feats):
            m = torch.cat([getattr(self, f"box{i}")(x), getattr(self, f"cls{i}")(x)], dim=1)
            raw.append(m.permute(0, 2, 3, 1))
        return raw

    def decode(self, raw: Sequence[torch.Tensor]) -> torch.Tensor:
        """Raw maps -> (B, sum(HW), 4 + nc): DFL expectation -> distances
        around the grid anchors -> xywh * stride, then sigmoid scores."""
        b = raw[0].shape[0]
        no = 4 * self.reg_max + self.num_classes
        feat_shapes = tuple((m.shape[1], m.shape[2]) for m in raw)
        anchors, stride_t = make_anchors(feat_shapes, self.strides, 0.5, device=raw[0].device)
        flat = torch.cat([m.reshape(b, -1, no) for m in raw], dim=1).float()
        box_logits = flat[..., :4 * self.reg_max]
        cls_logits = flat[..., 4 * self.reg_max:]
        dist = dfl_expectation(box_logits.reshape(b, -1, 4, self.reg_max), self.reg_max)
        x1y1 = anchors[None] - dist[..., 0:2]
        x2y2 = anchors[None] + dist[..., 2:4]
        xywh = torch.cat([(x1y1 + x2y2) * 0.5, x2y2 - x1y1], dim=-1) * stride_t[None]
        return torch.cat([xywh, torch.sigmoid(cls_logits)], dim=-1)
