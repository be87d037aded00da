"""Shared helpers of the tests that hold the PyTorch port against the JAX
package: seeded random JAX variables without a JAX `init` pass (shapes from
`jax.eval_shape`, values from numpy), and conversion to numpy trees."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def random_variables(module, example, seed: int = 0, **call_kwargs):
    """Seeded {params, batch_stats} for a flax module: kernels N(0, 1/fan_in),
    biases N(0, 0.1), norm scales U(0.5, 1.5), BN statistics randomised
    (mean N(0, 0.2), var U(0.5, 1.5)), SelfAttention gamma 0.5 (its init 0
    would hide the attention path). Returns numpy leaves."""
    shapes = jax.eval_shape(
        lambda x: module.init({"params": jax.random.key(0)}, x, **call_kwargs), example
    )
    rng = np.random.default_rng(seed)

    def fill(path, sds):
        names = [getattr(p, "key", str(p)) for p in path]
        name, shape = names[-1], sds.shape
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            val = rng.standard_normal(shape) / np.sqrt(fan_in)
        elif name == "gamma":
            val = np.full(shape, 0.5)
        elif name == "scale":
            val = rng.uniform(0.5, 1.5, shape)
        elif name == "var":
            val = rng.uniform(0.5, 1.5, shape)
        elif name == "mean":
            val = rng.normal(0.0, 0.2, shape)
        elif name == "bias":
            val = rng.normal(0.0, 0.1, shape)
        else:
            raise KeyError(f"unexpected leaf {'/'.join(map(str, names))}")
        return val.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, dict(shapes))


def to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def rel_err(a, b) -> float:
    """max |a - b| / max |b| over the whole array."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))
