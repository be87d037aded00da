"""Optimizer of the training step: global-norm clip -> masked weight decay
-> nesterov SGD or Adam, ending before the learning rate (the step applies
p <- p - lr * update). Counterpart of
transparent_object_detection_tpu/train/optimizer.py and of its optax chain:

  optax.clip_by_global_norm(c)        g * c / |g| when |g| >= c (no epsilon;
                                      torch's clip_grad_norm_ divides by
                                      |g| + 1e-6, so it is not used)
  optax.add_decayed_weights(wd, mask) g + wd * p on the decayed leaves
  optax.trace(momentum, nesterov)     t <- g + m t; u = g + m t (torch's
                                      nesterov SGD with dampening 0)
  optax.scale_by_adam(b1=momentum)    bias-corrected Adam, eps 1e-8

Decay applies to what JAX calls `kernel` leaves: the weights of
convolutions and dense layers. In torch the norms' weights, every bias and
SelfAttention's gamma are parameters too, so the mask is built from the
module types, never from the parameter's name. Tensors are updated in
place; the state is a dict of tensors keyed by parameter name.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch
from torch import nn

from transparent_object_detection_tpu_torch.config import TrainConfig

ADAM_B2, ADAM_EPS = 0.999, 1e-8


def _bias_correction(decay: float, count: int) -> float:
    """1 - decay^count in float32, as optax computes it (for b2 = 0.999 the
    float32 cancellation is part of the update's value)."""
    return float(np.float32(1.0) - np.float32(decay) ** np.float32(count))


def weight_decay_mask(model: nn.Module) -> Dict[str, bool]:
    """True for the weights of Conv2d and Linear modules (JAX kernels)."""
    kernels = {id(m.weight) for m in model.modules() if isinstance(m, (nn.Conv2d, nn.Linear))}
    return {name: id(p) in kernels for name, p in model.named_parameters()}


def backbone_frozen_mask(model: nn.Module) -> Dict[str, bool]:
    """True for every parameter under the backbone (freeze phase)."""
    return {name: name.startswith("backbone.") for name, _ in model.named_parameters()}


class Optimizer:
    """The chain above as init(params) -> state and
    update(grads, state, params) -> (updates, state)."""

    def __init__(self, cfg: TrainConfig, decay_mask: Dict[str, bool]):
        if cfg.optimizer_type not in ("sgd", "adam"):
            raise ValueError(f"unsupported optimizer_type {cfg.optimizer_type!r}")
        self.cfg, self.decay_mask = cfg, dict(decay_mask)

    def init(self, params: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        zeros = lambda: {n: torch.zeros_like(p, memory_format=torch.preserve_format)
                         for n, p in params.items()}
        if self.cfg.optimizer_type == "sgd":
            return {"trace": zeros()}
        return {"mu": zeros(), "nu": zeros(), "count": 0}

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor], state: Dict[str, Any],
               params: Dict[str, torch.Tensor]) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
        cfg = self.cfg
        names = list(grads)
        g = [grads[n] for n in names]
        # clip by the global norm, as optax: (g / |g|) * c unless |g| < c
        g_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(g)))
        keep = g_norm < cfg.grad_clip_norm
        u = [torch.where(keep, t, t / g_norm * cfg.grad_clip_norm) for t in g]
        if cfg.weight_decay:
            idx = [i for i, n in enumerate(names) if self.decay_mask[n]]
            torch._foreach_add_([u[i] for i in idx], [params[names[i]] for i in idx],
                                alpha=cfg.weight_decay)
        m = cfg.momentum
        if cfg.optimizer_type == "sgd":
            trace = [state["trace"][n] for n in names]
            torch._foreach_mul_(trace, m)
            torch._foreach_add_(trace, u)
            u = torch._foreach_add(u, trace, alpha=m)
        else:
            mu = [state["mu"][n] for n in names]
            nu = [state["nu"][n] for n in names]
            torch._foreach_mul_(mu, m)
            torch._foreach_add_(mu, u, alpha=1.0 - m)
            torch._foreach_mul_(nu, ADAM_B2)
            torch._foreach_addcmul_(nu, u, u, value=1.0 - ADAM_B2)
            state["count"] += 1
            mu_hat = torch._foreach_div(mu, _bias_correction(m, state["count"]))
            nu_hat = torch._foreach_div(nu, _bias_correction(ADAM_B2, state["count"]))
            torch._foreach_sqrt_(nu_hat)
            torch._foreach_add_(nu_hat, ADAM_EPS)
            u = torch._foreach_div(mu_hat, nu_hat)
        return dict(zip(names, u)), state


def build_optimizer(cfg: TrainConfig, model: nn.Module, freeze_backbone: bool = False) -> Optimizer:
    """The optimizer for `model`; with freeze_backbone the decay mask also
    leaves out the backbone (whose gradients the train step zeroes), so its
    momentum or Adam moments stay exactly zero while frozen."""
    mask = weight_decay_mask(model)
    if freeze_backbone:
        frozen = backbone_frozen_mask(model)
        mask = {n: w and not frozen[n] for n, w in mask.items()}
    return Optimizer(cfg, mask)
