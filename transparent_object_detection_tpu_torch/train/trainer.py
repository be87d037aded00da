"""The training step of the PyTorch port: forward in training mode (batch
statistics, BatchNorm running statistics updated) -> detection loss ->
backward -> [backbone gradients zeroed] -> clip -> masked weight decay ->
nesterov SGD or Adam -> p <- p - lr * update -> EMA of the parameters and
the BatchNorm statistics. Counterpart of TrainState, create_train_state,
loss_config_from, make_train_step and make_eval_step in
transparent_object_detection_tpu/train/trainer.py; the epoch loop
(`Trainer.fit`) and its data pipeline are not ported.

Compute policy, as in JAX: parameters are fp32 and cast to the compute type
at each use (gradients flow back through the casts to fp32), norms run in
fp32, and there is no autocast and no loss scaling. The step updates the
model and the state in place (the counterpart of JAX's donated state) and
leaves each parameter's `.grad` holding this step's loss gradient (zero on
a frozen backbone).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict

import torch
from torch import nn

from transparent_object_detection_tpu_torch.config import ModelConfig, TrainConfig
from transparent_object_detection_tpu_torch.train.ema import ema_init, ema_update
from transparent_object_detection_tpu_torch.train.loss import LossConfig, detection_loss
from transparent_object_detection_tpu_torch.train.optimizer import (
    Optimizer,
    backbone_frozen_mask,
)


@dataclass
class TrainState:
    """The model holds the parameters and the BatchNorm statistics; beside
    it, the optimizer state, the fp32 EMA shadows and two counters. All
    tensors live on the model's device."""

    model: nn.Module
    opt_state: Dict[str, Any]
    ema_params: Dict[str, torch.Tensor]
    ema_batch_stats: Dict[str, torch.Tensor]
    ema_updates: int = 0
    step: int = 0

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())

    @property
    def batch_stats(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_buffers())


def create_train_state(model: nn.Module, optimizer: Optimizer, ema_updates: int = 0) -> TrainState:
    """State for `model` as it is (load weights first)."""
    params = dict(model.named_parameters())
    return TrainState(model=model, opt_state=optimizer.init(params), ema_params=ema_init(params),
                      ema_batch_stats=ema_init(dict(model.named_buffers())),
                      ema_updates=ema_updates)


def loss_config_from(model_cfg: ModelConfig, train_cfg: TrainConfig) -> LossConfig:
    return LossConfig(
        num_classes=model_cfg.num_classes, reg_max=model_cfg.reg_max, strides=model_cfg.strides,
        box_weight=train_cfg.box_weight, cls_weight=train_cfg.cls_weight,
        dfl_weight=train_cfg.dfl_weight, tal_topk=train_cfg.tal_topk,
        tal_alpha=train_cfg.tal_alpha, tal_beta=train_cfg.tal_beta,
        label_smoothing=train_cfg.label_smoothing,
    )


def make_train_step(model: nn.Module, optimizer: Optimizer, loss_cfg: LossConfig,
                    train_cfg: TrainConfig, freeze_backbone: bool = False) -> Callable:
    """(state, batch, lr) -> (state, components). batch: {"image" (B, H, W, 3)
    float in [0, 1], "boxes" (B, M, 4) normalised cxcywh (padded slots zero),
    "labels" (B, M) int}; lr a float. Components are 0-d fp32 tensors on the
    device (no host synchronisation). With freeze_backbone the backbone's
    gradients are zeroed before the clip and its parameters do not move;
    its BatchNorm statistics still update."""
    frozen = ([n for n, f in backbone_frozen_mask(model).items() if f]
              if freeze_backbone else [])

    def step(state: TrainState, batch: Dict[str, torch.Tensor], lr: float):
        model.train()
        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        out = model(batch["image"])
        total, comps = detection_loss(out["raw"], batch["boxes"], batch["labels"], loss_cfg)
        total.backward()
        with torch.no_grad():
            if frozen:
                torch._foreach_zero_([params[n].grad for n in frozen])
            grads = {n: p.grad for n, p in params.items()}
            updates, state.opt_state = optimizer.update(grads, state.opt_state, params)
            if frozen:
                torch._foreach_zero_([updates[n] for n in frozen])
            names = list(params)
            torch._foreach_add_([params[n] for n in names], [updates[n] for n in names],
                                alpha=-lr)
            if train_cfg.ema:
                state.ema_updates += 1
                ema_update(state.ema_params, params, state.ema_updates, train_cfg.ema_decay,
                           train_cfg.ema_tau)
                ema_update(state.ema_batch_stats, dict(model.named_buffers()),
                           state.ema_updates, train_cfg.ema_decay, train_cfg.ema_tau)
        state.step += 1
        return state, {k: v.detach() for k, v in comps.items()}

    return step


def make_eval_step(model: nn.Module, loss_cfg: LossConfig, use_ema: bool = True) -> Callable:
    """(state, batch) -> components: the validation loss in evaluation mode
    (running statistics) on the raw maps, with the EMA weights by default."""

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        was_training = model.training
        model.eval()
        try:
            with torch.no_grad():
                if use_ema:
                    out = torch.func.functional_call(
                        model, {**state.ema_params, **state.ema_batch_stats},
                        (batch["image"],), {"decode": False})
                else:
                    out = model(batch["image"], decode=False)
                _, comps = detection_loss(out["raw"], batch["boxes"], batch["labels"], loss_cfg)
        finally:
            model.train(was_training)
        return comps

    return step
