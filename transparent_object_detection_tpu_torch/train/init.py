"""Weight re-initialization schemes: the port's counterpart of
transparent_object_detection_tpu/train/init.py.

Applies normal / xavier / kaiming / orthogonal init to every conv/dense
kernel of a parameter dict ({name: tensor}, as `model.named_parameters()`
gives it) and N(1, 0.02)/0 to norm scales/biases, as a pure transform with
an explicit seed. The draws are those of the JAX initializers, in the
port's (out, in, kh, kw) layout:

  normal      gain * N(0, 1), untruncated
  xavier      jax.nn.initializers.glorot_normal: a normal truncated at +-2
              of its std, the std raised by 1/0.87962566 so the variance is
              2 / (fan_in + fan_out)
  kaiming     he_normal: the same truncation, variance 2 / fan_in
  orthogonal  orthogonal(scale=gain): the kernel, flattened to (out, rest),
              has orthonormal rows (or columns where out > rest) times gain

with fan_in = in * kh * kw and fan_out = out * kh * kw (JAX's in_axis=-2,
out_axis=-1 of a (kh, kw, in, out) kernel). Random bits differ from JAX's:
the distributions are the same.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch

from transparent_object_detection_tpu_torch.models.detector import TRUNCATED_NORMAL_STD

NORM_MODULES = ("bn", "norm1", "norm2")


def _fans(shape: Tuple[int, ...]) -> Tuple[int, int]:
    """(fan_in, fan_out) of a kernel of the port's layout (out, in, *k)."""
    receptive = 1
    for d in shape[2:]:
        receptive *= d
    return shape[1] * receptive, shape[0] * receptive


def _truncated(shape, variance: float, gen: torch.Generator) -> torch.Tensor:
    std = variance ** 0.5 / TRUNCATED_NORMAL_STD
    w = torch.empty(shape)
    torch.nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=gen)
    return w


def _kernel_init(init_type: str, gain: float):
    if init_type == "normal":
        return lambda shape, gen: gain * torch.randn(shape, generator=gen)
    if init_type == "xavier":
        return lambda shape, gen: _truncated(shape, 2.0 / sum(_fans(shape)), gen)
    if init_type == "kaiming":
        return lambda shape, gen: _truncated(shape, 2.0 / _fans(shape)[0], gen)
    if init_type == "orthogonal":
        return lambda shape, gen: torch.nn.init.orthogonal_(torch.empty(shape), gain,
                                                            generator=gen)
    raise NotImplementedError(f"init method [{init_type}] is not implemented")


@torch.no_grad()
def weights_init(params: Mapping[str, torch.Tensor], seed: int = 0, init_type: str = "kaiming",
                 init_gain: float = 0.02) -> Dict[str, torch.Tensor]:
    """Re-draw kernels per `init_type`; norm scales ~ N(1, 0.02), biases 0;
    every other leaf as it is. Returns a new dict (each tensor on its
    leaf's device and in its dtype); load it with
    `model.load_state_dict(..., strict=False)`."""
    kinit = _kernel_init(init_type, init_gain)
    gen = torch.Generator().manual_seed(seed)
    out: Dict[str, torch.Tensor] = {}
    for name, leaf in params.items():
        parts = name.split(".")
        last = parts[-1]
        is_norm = len(parts) > 1 and parts[-2] in NORM_MODULES
        if last == "weight" and leaf.dim() >= 2:  # conv and dense kernels
            new = kinit(tuple(leaf.shape), gen)
        elif last == "weight" and is_norm:
            new = 1.0 + 0.02 * torch.randn(leaf.shape, generator=gen)
        elif last == "bias" and is_norm:
            new = torch.zeros(leaf.shape)
        else:
            out[name] = leaf
            continue
        out[name] = new.to(device=leaf.device, dtype=leaf.dtype)
    return out
