"""Learning-rate schedules: the port's own copy of
transparent_object_detection_tpu/train/schedule.py (pure Python).

Host-side callables iteration -> lr; the value is passed to the train step
as its `lr` argument (the optimizer state is not touched).
"""
from __future__ import annotations

import math
from typing import Callable


def cosine_schedule(
    lr: float,
    min_lr: float,
    total_iters: int,
    warmup_iters_ratio: float = 0.05,
    warmup_lr_ratio: float = 0.1,
    no_aug_iter_ratio: float = 0.05,
) -> Callable[[int], float]:
    """Quadratic warmup (<=3 iters) -> cosine -> min_lr floor (<=15 iters)
    for the final no-augmentation window."""
    warmup_total = min(max(int(warmup_iters_ratio * total_iters), 1), 3)
    warmup_start = max(warmup_lr_ratio * lr, 1e-6)
    no_aug = min(max(int(no_aug_iter_ratio * total_iters), 1), 15)

    def fn(iters: int) -> float:
        if iters <= warmup_total:
            return (lr - warmup_start) * (iters / float(warmup_total)) ** 2 + warmup_start
        if iters >= total_iters - no_aug:
            return min_lr
        return min_lr + 0.5 * (lr - min_lr) * (
            1.0
            + math.cos(math.pi * (iters - warmup_total) / (total_iters - warmup_total - no_aug))
        )

    return fn


def step_schedule(
    lr: float, min_lr: float, total_iters: int, step_num: int = 10
) -> Callable[[int], float]:
    """Geometric decay over step_num stages."""
    if step_num < 1:
        raise ValueError("step_num must be >= 1")
    decay_rate = (min_lr / lr) ** (1 / (step_num - 1)) if step_num > 1 else 0.0
    step_size = total_iters / step_num

    def fn(iters: int) -> float:
        if step_size < 1:
            raise ValueError("step_size must be at least 1")
        return lr * decay_rate ** (iters // step_size)

    return fn


def get_lr_scheduler(
    lr_decay_type: str, lr: float, min_lr: float, total_iters: int, **kwargs
) -> Callable[[int], float]:
    if lr_decay_type == "cos":
        return cosine_schedule(lr, min_lr, total_iters, **kwargs)
    if lr_decay_type == "step":
        return step_schedule(lr, min_lr, total_iters, **kwargs)
    raise ValueError(f"unsupported lr_decay_type: {lr_decay_type!r}")
