"""Per-rank bytes of tensor parallelism at every scale, from shapes on the
meta device (no weights are made): phi n/s/m/l/x at tp 1, 2, 4 and 8, bf16
serving parameters (`parallel.tp.per_rank_param_bytes`: this rank's
shards, weights of two or more dimensions in bf16) beside the fp32 model,
and the fp32 training state (`parallel.tp.train_state_bytes`: parameters,
gradients, SGD momentum and EMA in the layout of `shard_train_state_tp`,
no activations). A scale whose TEB widths tp does not divide prints null
there (it cannot run at that tp).

    python -m transparent_object_detection_tpu_torch.tools.tp_memory
"""
from __future__ import annotations

import json

import torch

from transparent_object_detection_tpu_torch.config import SCALE_TABLE, ModelConfig
from transparent_object_detection_tpu_torch.models.detector import FocusModel
from transparent_object_detection_tpu_torch.parallel.tp import (
    per_rank_param_bytes,
    train_state_bytes,
)


def rows():
    for phi in SCALE_TABLE:
        cfg = ModelConfig(phi=phi)
        with torch.device("meta"):
            model = FocusModel(base_channels=cfg.base_channels, base_depth=cfg.base_depth,
                               deep_mul=cfg.deep_mul, num_heads=cfg.num_heads)
        row = {"phi": phi, "params": sum(p.numel() for p in model.parameters()),
               "fp32_bytes": per_rank_param_bytes(model, 1, torch.float32)}
        for tp in (1, 2, 4, 8):
            for key, fn in (("bf16", lambda: per_rank_param_bytes(model, tp, torch.bfloat16)),
                            ("train", lambda: train_state_bytes(model, tp))):
                try:
                    row[f"tp{tp}_{key}_bytes"] = fn()
                except ValueError:
                    row[f"tp{tp}_{key}_bytes"] = None
        yield row


def main() -> None:
    for row in rows():
        print(json.dumps(row))


if __name__ == "__main__":
    main()
