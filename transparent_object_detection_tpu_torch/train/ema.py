"""Exponential moving average of the model's variables: fp32 shadows of the
parameters and of the BatchNorm statistics, with the ramped decay
d * (1 - exp(-updates / tau)). Counterpart of
transparent_object_detection_tpu/train/ema.py; the shadows are updated in
place."""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def ema_decay(updates: int, decay: float = 0.9999, tau: int = 2000) -> float:
    """d * (1 - exp(-updates / tau)), in float32 as the JAX package computes it."""
    u = np.float32(updates)
    return float(np.float32(decay) * (np.float32(1.0) - np.exp(-u / np.float32(tau))))


def ema_init(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """fp32 copies (not aliases) of named tensors."""
    return {name: t.detach().to(torch.float32, copy=True) for name, t in tensors.items()}


@torch.no_grad()
def ema_update(ema: Dict[str, torch.Tensor], new: Dict[str, torch.Tensor], updates: int,
               decay: float = 0.9999, tau: int = 2000) -> Dict[str, torch.Tensor]:
    """ema <- d * ema + (1 - d) * new, in place; `updates` is the counter
    after its increment."""
    d = ema_decay(updates, decay, tau)
    names = list(ema)
    shadows = [ema[n] for n in names]
    torch._foreach_mul_(shadows, d)
    torch._foreach_add_(shadows, [new[n].detach().float() for n in names], alpha=1.0 - d)
    return ema
