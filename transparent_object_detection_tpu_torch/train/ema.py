"""Exponential moving average of the model's variables: fp32 shadows of the
parameters and of the BatchNorm statistics, with the ramped decay
d * (1 - exp(-updates / tau)). Counterpart of
transparent_object_detection_tpu/train/ema.py; the shadows are updated in
place. As in JAX, the decay is computed on the device from the device
counter (a 0-d int32 tensor), so a captured train step reads the counter at
each replay; `ema_decay` is the host reference of that float32 formula."""
from __future__ import annotations

from typing import Dict, Union

import numpy as np
import torch


def ema_decay(updates: int, decay: float = 0.9999, tau: int = 2000) -> float:
    """d * (1 - exp(-updates / tau)), in float32 as the JAX package computes it."""
    u = np.float32(updates)
    return float(np.float32(decay) * (np.float32(1.0) - np.exp(-u / np.float32(tau))))


def ema_decay_device(updates: torch.Tensor, decay: float = 0.9999,
                     tau: int = 2000) -> torch.Tensor:
    """`ema_decay` on the device: a 0-d float32 tensor from the counter
    `updates` (a 0-d integer tensor), with no host read."""
    return decay * (1.0 - torch.exp(-updates.float() / tau))


def ema_init(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """fp32 copies (not aliases) of named tensors."""
    return {name: t.detach().to(torch.float32, copy=True) for name, t in tensors.items()}


@torch.no_grad()
def ema_update(ema: Dict[str, torch.Tensor], new: Dict[str, torch.Tensor],
               updates: Union[int, torch.Tensor], decay: float = 0.9999,
               tau: int = 2000) -> Dict[str, torch.Tensor]:
    """ema <- d * ema + (1 - d) * new, in place (JAX's e * d + (1 - d) * p);
    `updates` is the counter after its increment: a 0-d integer tensor on
    the shadows' device (the train step's) or a number."""
    names = list(ema)
    shadows = [ema[n] for n in names]
    if not isinstance(updates, torch.Tensor):
        updates = torch.tensor(updates, dtype=torch.int32)
    d = ema_decay_device(updates.to(shadows[0].device), decay, tau)
    torch._foreach_mul_(shadows, d)
    torch._foreach_add_(shadows, torch._foreach_mul([new[n].detach().float() for n in names],
                                                    1.0 - d))
    return ema
