"""CSP backbone with interleaved attention (counterpart of
transparent_object_detection_tpu/models/backbone.py).

  stem   Conv s2            3 -> c            /2
  dark2  Conv s2 + C2f(d)  + CBAM   -> 2c     /4
  dark3  Conv s2 + C2f(2d) + SelfAttention -> 4c   /8   (P3 out)
  dark4  Conv s2 + C2f(2d) + CBAM   -> 8c     /16  (P4 out)
  dark5  Conv s2 + C2f(d)  + SPPF   -> 16c*deep_mul  /32  (P5 out)

int8_1x1 reaches the 1x1 convs of the C2f and SPPF blocks (ConvBNAct).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from transparent_object_detection_tpu_torch.config import Int8Variants
from transparent_object_detection_tpu_torch.models.blocks import (
    C2f,
    CBAM,
    ConvBNAct,
    SelfAttention,
    SPPF,
)


class Backbone(nn.Module):
    def __init__(self, base_channels: int, base_depth: int, deep_mul: float,
                 dtype: torch.dtype = torch.bfloat16, attention_impl: Optional[str] = None,
                 int8_attn: bool = False, int8_1x1: bool = False,
                 int8_variants: Optional[Int8Variants] = None):
        super().__init__()
        c, d, dt = base_channels, base_depth, dtype
        c5 = int(c * 16 * deep_mul)
        i8 = dict(int8_1x1=int8_1x1, int8_variants=int8_variants)
        self.stem = ConvBNAct(3, c, 3, strides=2, dtype=dt)
        self.dark2_conv = ConvBNAct(c, c * 2, 3, strides=2, dtype=dt)
        self.dark2_c2f = C2f(c * 2, c * 2, n=d, shortcut=True, dtype=dt, **i8)
        self.dark2_cbam = CBAM(c * 2, dtype=dt)
        self.dark3_conv = ConvBNAct(c * 2, c * 4, 3, strides=2, dtype=dt)
        self.dark3_c2f = C2f(c * 4, c * 4, n=d * 2, shortcut=True, dtype=dt, **i8)
        self.dark3_attn = SelfAttention(c * 4, dtype=dt, attention_impl=attention_impl,
                                        int8_attn=int8_attn)
        self.dark4_conv = ConvBNAct(c * 4, c * 8, 3, strides=2, dtype=dt)
        self.dark4_c2f = C2f(c * 8, c * 8, n=d * 2, shortcut=True, dtype=dt, **i8)
        self.dark4_cbam = CBAM(c * 8, dtype=dt)
        self.dark5_conv = ConvBNAct(c * 8, c5, 3, strides=2, dtype=dt)
        self.dark5_c2f = C2f(c5, c5, n=d, shortcut=True, dtype=dt, **i8)
        self.dark5_sppf = SPPF(c5, c5, pool_size=5, dtype=dt, **i8)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        x = self.stem(x)
        x = self.dark2_cbam(self.dark2_c2f(self.dark2_conv(x)))
        feat1 = x = self.dark3_attn(self.dark3_c2f(self.dark3_conv(x)))
        feat2 = x = self.dark4_cbam(self.dark4_c2f(self.dark4_conv(x)))
        feat3 = self.dark5_sppf(self.dark5_c2f(self.dark5_conv(x)))
        return feat1, feat2, feat3
