"""Attention PAN neck (counterpart of
transparent_object_detection_tpu/models/neck.py): top-down then bottom-up
fusion, each fusion node TransformerEncoderBlock -> channel-reducing 1x1
ConvBNAct -> CBAM. With `remat`, each fusion node's activations are
recomputed in the backward instead of kept (JAX: nn.remat(FusionNode))."""
from __future__ import annotations

import contextlib
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from transparent_object_detection_tpu_torch.config import Int8Variants
from transparent_object_detection_tpu_torch.models.blocks import (
    CBAM,
    ConvBNAct,
    TransformerEncoderBlock,
    recomputing,
)


def upsample2x_nearest(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x spatial upsample of an NCHW map."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


class FusionNode(nn.Module):
    """TEB over the concatenated features -> reduce to out_features -> CBAM.
    int8_1x1: the int8 route for `reduce` (see ConvBNAct)."""

    def __init__(self, in_features: int, out_features: int, num_heads: int = 8,
                 dtype: torch.dtype = torch.bfloat16, norm_dtype: torch.dtype = torch.float32,
                 lane_align_heads: bool = True, attention_impl: Optional[str] = None,
                 int8_dense: bool = False, int8_attn: bool = False,
                 int8_variants: Optional[Int8Variants] = None, tp_serving: bool = False,
                 int8_1x1: bool = False):
        super().__init__()
        self.teb = TransformerEncoderBlock(
            in_features, num_heads, dtype=dtype, attention_impl=attention_impl,
            norm_dtype=norm_dtype, lane_align_heads=lane_align_heads,
            int8_dense=int8_dense, int8_attn=int8_attn, int8_variants=int8_variants,
            tp_serving=tp_serving,
        )
        self.reduce = ConvBNAct(in_features, out_features, 1, dtype=dtype, int8_1x1=int8_1x1,
                                int8_variants=int8_variants)
        self.cbam = CBAM(out_features, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.cbam(self.reduce(self.teb(x)))


def _remat_contexts(node: nn.Module):
    """checkpoint's (forward, recompute) contexts for `node`: the recompute
    leaves its BatchNorm running statistics alone."""
    return contextlib.nullcontext(), recomputing(node)


class Neck(nn.Module):
    def __init__(self, base_channels: int, base_depth: int, deep_mul: float,
                 num_heads: int = 8, dtype: torch.dtype = torch.bfloat16,
                 norm_dtype: torch.dtype = torch.float32, lane_align_heads: bool = True,
                 attention_impl: Optional[str] = None, int8_dense: bool = False,
                 int8_attn: bool = False, int8_variants: Optional[Int8Variants] = None,
                 remat: bool = False, tp_serving: bool = False, int8_1x1: bool = False):
        super().__init__()
        self.remat = remat
        c = base_channels
        c5 = int(c * 16 * deep_mul)
        node = lambda cin, cout: FusionNode(cin, cout, num_heads, dtype, norm_dtype,
                                            lane_align_heads, attention_impl, int8_dense,
                                            int8_attn, int8_variants, tp_serving, int8_1x1)
        self.h1 = node(c5 + c * 8, c * 8)   # top-down, /16
        self.h2 = node(c * 8 + c * 4, c * 4)  # top-down, /8 == P3 out
        self.h3 = ConvBNAct(c * 4, c * 4, 3, strides=2, dtype=dtype)
        self.h4 = node(c * 4 + c * 8, c * 8)  # bottom-up, /16 == P4 out
        self.h5 = ConvBNAct(c * 8, c * 8, 3, strides=2, dtype=dtype)
        self.h6 = node(c * 8 + c5, c5)      # bottom-up, /32 == P5 out

    def _node(self, node: FusionNode, x: torch.Tensor) -> torch.Tensor:
        """A fusion node; in training with `remat`, checkpointed: only its
        input is kept, and the backward reruns its forward. The forward
        draws no random numbers, so no RNG state is stashed for the rerun
        (a CUDA graph capture refuses to read the card's RNG state)."""
        if self.remat and self.training and torch.is_grad_enabled():
            return checkpoint(node, x, use_reentrant=False, preserve_rng_state=False,
                              context_fn=functools.partial(_remat_contexts, node))
        return node(x)

    def forward(self, feats: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]):
        p3, p4, p5 = feats
        h1 = self._node(self.h1, torch.cat([upsample2x_nearest(p5), p4], dim=1))
        h2 = self._node(self.h2, torch.cat([upsample2x_nearest(h1), p3], dim=1))
        h4 = self._node(self.h4, torch.cat([self.h3(h2), h1], dim=1))
        h6 = self._node(self.h6, torch.cat([self.h5(h4), p5], dim=1))
        return h2, h4, h6
