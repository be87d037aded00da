"""Weight bridge: JAX variables {params, batch_stats} -> the port's state_dict.

The port's modules are named one to one after the flax tree
(`backbone.dark3_attn.query`, `neck.h2.teb.qkv`, `head.box0.out`, C2f
bottlenecks `m0`, `m1`, ...), so the map is mechanical. Per leaf:

  conv kernel (kh, kw, in, out)  -> weight (out, in, kh, kw)
  dense kernel (in, out)         -> weight (out, in)
  LayerNorm / BatchNorm scale    -> weight;  bias -> bias
  batch_stats mean / var         -> running_mean / running_var
  gamma                          -> gamma

Leaves are taken as numpy arrays (anything `np.asarray` accepts). A leaf
that maps to no port parameter, a shape mismatch, or a port parameter left
unfilled raises. `params_from_jax` maps any tree shaped like `params` (a
gradient, an optimizer moment) onto the port's parameter names.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch
from torch import nn

_RENAME = {
    "scale": "weight",
    "bias": "bias",
    "mean": "running_mean",
    "var": "running_var",
    "gamma": "gamma",
}


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for key, val in tree.items():
        if isinstance(val, Mapping):
            yield from _leaves(val, prefix + (str(key),))
        else:
            yield prefix + (str(key),), val


def _convert(path: Tuple[str, ...], leaf) -> Tuple[str, np.ndarray]:
    arr = np.asarray(leaf, dtype=np.float32)
    name = path[-1]
    if name == "kernel":
        if arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)
        elif arr.ndim == 2:
            arr = arr.T
        else:
            raise ValueError(f"kernel {'/'.join(path)} has unexpected rank {arr.ndim}")
        torch_name = "weight"
    elif name in _RENAME:
        torch_name = _RENAME[name]
    else:
        raise KeyError(f"unmapped JAX leaf {'/'.join(path)}")
    return ".".join(path[:-1] + (torch_name,)), np.ascontiguousarray(arr)


def state_dict_from_jax(variables: Mapping, model: nn.Module) -> Dict[str, torch.Tensor]:
    """Convert JAX variables into a complete state_dict for `model`."""
    expected = model.state_dict()
    out: Dict[str, torch.Tensor] = {}
    for collection in ("params", "batch_stats"):
        for path, leaf in _leaves(variables.get(collection, {})):
            key, arr = _convert(path, leaf)
            if key not in expected:
                raise KeyError(f"JAX leaf {collection}/{'/'.join(path)} maps to {key!r}, "
                               "which the port does not have")
            if tuple(arr.shape) != tuple(expected[key].shape):
                raise ValueError(f"{key}: JAX shape {arr.shape} (converted) != port shape "
                                 f"{tuple(expected[key].shape)}")
            if key in out:
                raise KeyError(f"{key} filled twice")
            out[key] = torch.tensor(arr, dtype=expected[key].dtype)
    unfilled = sorted(set(expected) - set(out))
    if unfilled:
        raise KeyError(f"port parameters left unfilled by the JAX variables: {unfilled[:10]}"
                       f"{' ...' if len(unfilled) > 10 else ''}")
    return out


def params_from_jax(tree: Mapping, model: nn.Module) -> Dict[str, torch.Tensor]:
    """Convert a tree shaped like JAX `params` (the parameters themselves,
    or their gradients, optimizer moments or EMA) into {name: tensor} over
    `model.named_parameters()`, with the same checks as `state_dict_from_jax`."""
    expected = dict(model.named_parameters())
    out: Dict[str, torch.Tensor] = {}
    for path, leaf in _leaves(tree):
        key, arr = _convert(path, leaf)
        if key not in expected:
            raise KeyError(f"JAX leaf {'/'.join(path)} maps to {key!r}, which is no port "
                           "parameter")
        if tuple(arr.shape) != tuple(expected[key].shape):
            raise ValueError(f"{key}: JAX shape {arr.shape} (converted) != port shape "
                             f"{tuple(expected[key].shape)}")
        out[key] = torch.tensor(arr)
    unfilled = sorted(set(expected) - set(out))
    if unfilled:
        raise KeyError(f"port parameters left unfilled: {unfilled[:10]}"
                       f"{' ...' if len(unfilled) > 10 else ''}")
    return out


def load_jax_variables(model: nn.Module, variables: Mapping) -> nn.Module:
    """Load JAX {params, batch_stats} into `model` in place; returns it."""
    sd = state_dict_from_jax(variables, model)
    model.load_state_dict(sd, strict=True)
    return model
