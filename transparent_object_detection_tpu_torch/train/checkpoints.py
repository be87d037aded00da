"""Checkpointing with `torch.save`: the port's counterpart of
transparent_object_detection_tpu/train/checkpoints.py.

The same policy and the same names: periodic `ep{NNN}_weights` every
save_period epochs, `best_weights` on minimum validation loss,
`last_weights` every epoch; with EMA on, the EMA weights are what
best/last/periodic hold. `last_state` holds the whole train state for an
exact resume: parameters, BatchNorm statistics, optimizer state, EMA
shadows, `ema_updates` and `step` (`state_tree` writes that tree and
`load_state_tree` puts it back into a train state). Each name is one file of
`torch.save`, a dict of tensors keyed by the port's parameter and buffer
names ({"params": {...}, "batch_stats": {...}}), loaded with
`weights_only=True`.
"""
from __future__ import annotations

import os
from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch


def _leaves(tree: Any, path: Tuple[str, ...] = ()):
    """(path, leaf) of a tree of dicts, keys sorted at each level (the order
    in which jax.tree_util flattens a dict)."""
    if isinstance(tree, Mapping):
        for key in sorted(tree):
            yield from _leaves(tree[key], path + (key,))
    else:
        yield path, tree


def _keystr(path: Tuple[str, ...]) -> str:
    """A leaf's path as jax.tree_util.keystr writes a dict path."""
    return "".join(f"[{k!r}]" for k in path)


class CheckpointManager:
    def __init__(self, save_dir: str, save_ema: bool = True):
        self.save_dir = os.path.abspath(save_dir)
        os.makedirs(self.save_dir, exist_ok=True)
        self.save_ema = save_ema

    # -- low-level -----------------------------------------------------------

    def _path(self, name_or_path: str) -> str:
        return (name_or_path if os.path.isabs(name_or_path)
                else os.path.join(self.save_dir, name_or_path))

    def save_tree(self, name: str, tree: Any) -> str:
        """Write `tree` (dicts of tensors and numbers) as one file; tensors
        are written from the device they are on and keep their dtype."""
        path = os.path.join(self.save_dir, name)
        tmp = path + ".tmp"
        torch.save(tree, tmp)
        os.replace(tmp, path)  # a reader never sees a half-written file
        return path

    def load_tree(self, name_or_path: str, map_location="cpu") -> Any:
        return torch.load(self._path(name_or_path), map_location=map_location,
                          weights_only=True)

    def restore_like(self, name_or_path: str, template: Any) -> Any:
        """Restore a checkpoint into the structure of `template`: the same
        keys in the same order, every tensor of the template's shape, on
        the template's device and in its dtype; numbers stay numbers."""
        raw = self.load_tree(name_or_path)
        t_leaves = list(_leaves(template))
        r_leaves = dict(_leaves(raw))
        if len(r_leaves) != len(t_leaves):
            raise ValueError(
                f"checkpoint has {len(r_leaves)} leaves, template {len(t_leaves)}"
            )

        def rebuild(t, path):
            if isinstance(t, Mapping):
                return {k: rebuild(v, path + (k,)) for k, v in t.items()}
            if path not in r_leaves:
                raise KeyError(f"checkpoint lacks {_keystr(path)}")
            r = r_leaves[path]
            if isinstance(t, torch.Tensor):
                if tuple(r.shape) != tuple(t.shape):
                    raise ValueError(f"{_keystr(path)}: checkpoint shape {tuple(r.shape)}, "
                                     f"template {tuple(t.shape)}")
                return r.to(device=t.device, dtype=t.dtype)
            return r

        return rebuild(template, ())

    # -- trainer protocol ------------------------------------------------------

    def weights_of(self, state) -> Dict[str, Any]:
        if self.save_ema:
            return {"params": state.ema_params, "batch_stats": state.ema_batch_stats}
        return {"params": {n: p.detach() for n, p in state.params.items()},
                "batch_stats": state.batch_stats}

    def save_epoch(self, state, epoch: int, is_best: bool, period: int) -> None:
        weights = self.weights_of(state)
        if period and epoch % period == 0:
            self.save_tree(f"ep{epoch:03d}_weights", weights)
        if is_best:
            self.save_tree("best_weights", weights)
        self.save_tree("last_weights", weights)
        self.save_tree("last_state", state_tree(state))


def state_tree(state) -> Dict[str, Any]:
    """The whole train state as the tree `last_state` holds: the counters
    (`ema_updates`, `step`, Adam's `count`) as numbers, whatever device
    tensor holds them."""
    return {
        "params": {n: p.detach() for n, p in state.params.items()},
        "batch_stats": state.batch_stats,
        "opt_state": {k: (int(v) if k == "count" else v) for k, v in state.opt_state.items()},
        "ema_params": state.ema_params,
        "ema_batch_stats": state.ema_batch_stats,
        "ema_updates": int(state.ema_updates),
        "step": int(state.step),
    }


@torch.no_grad()
def load_state_tree(state, tree: Dict[str, Any]):
    """Put a tree of `state_tree`'s structure (restored on the state's
    devices and dtypes) into the train state: the parameters and BatchNorm
    statistics into its model in place, the EMA counter into its tensor, the
    rest replaced (Adam's count as a 0-d int32 tensor on the parameters'
    device), so that a compiled step warms up and captures anew."""
    for name, p in state.model.named_parameters():
        p.copy_(tree["params"][name])
    for name, b in state.model.named_buffers():
        b.copy_(tree["batch_stats"][name])
    opt = dict(tree["opt_state"])
    if "count" in opt:
        device = next(state.model.parameters()).device
        opt["count"] = torch.tensor(int(opt["count"]), dtype=torch.int32, device=device)
    state.opt_state = opt
    state.ema_params = tree["ema_params"]
    state.ema_batch_stats = tree["ema_batch_stats"]
    state.ema_updates = int(tree["ema_updates"])
    state.step = int(tree["step"])
    return state


def load_weights_partial(target: Mapping, source: Mapping):
    """Shape-filtered partial weight load: copy every leaf whose path exists
    in `target` with a matching shape; report what loaded and what didn't.
    Trees are dicts (a state_dict is a tree of one level); leaves are torch
    tensors or numpy arrays, and a loaded leaf takes the target leaf's type,
    dtype (and device).

    Returns (merged_tree, loaded_paths, skipped_paths), the paths written as
    jax.tree_util.keystr writes them.
    """
    loaded: List[str] = []
    skipped: List[str] = []
    flat_s = dict(_leaves(source))

    def merge(t, path):
        if isinstance(t, Mapping):
            return {k: merge(t[k], path + (k,)) for k in sorted(t)}
        sv = flat_s.get(path)
        if sv is not None and tuple(np.shape(sv)) == tuple(np.shape(t)):
            loaded.append(_keystr(path))
            if isinstance(t, torch.Tensor):
                return torch.as_tensor(np.asarray(sv) if not isinstance(sv, torch.Tensor)
                                       else sv).to(device=t.device, dtype=t.dtype)
            return np.asarray(sv, dtype=np.asarray(t).dtype)
        skipped.append(_keystr(path))
        return t

    return merge(target, ()), loaded, skipped
