"""JAX's Trainer.fit in float64, run as its own process (x64 must be on
before JAX is imported): `python tests/_jax_fit_float64.py IN.pkl OUT.pkl`.

IN.pkl holds {"lines", "val_lines", "variables" (numpy tree), "tiny" (the
FocusModel keywords), "model_cfg", "train_cfg" (ModelConfig / TrainConfig
keywords)}. The model runs at dtype and norm_dtype float64 on float64
variables. Flax's BatchNorm reduces its batch statistics in the precision
the layer asks for, which the JAX model fixes at float32 (models/blocks.py,
ConvBN); here they reduce in the input's precision instead, since the
float32 fast variance E[x^2] - E[x]^2 is the rounding this run measures.
The other float32 sites stay as the package has them (the loss on the raw
maps, the EMA, BatchNorm's output): they round without cancelling.

OUT.pkl holds {"history", "variables", "ema_variables"} as numpy trees.
"""
import os
import pickle
import sys

os.environ["JAX_ENABLE_X64"] = "1"
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import flax.linen.normalization as norm  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from transparent_object_detection_tpu import config as jcfg  # noqa: E402
from transparent_object_detection_tpu.models import FocusModel  # noqa: E402
from transparent_object_detection_tpu.train import trainer as jtr  # noqa: E402

_compute_stats = norm._compute_stats


def _stats_in_input_precision(x, axes, dtype, *args, **kwargs):
    return _compute_stats(x, axes, None, *args, **kwargs)


def main(src: str, dst: str) -> None:
    with open(src, "rb") as f:
        spec = pickle.load(f)
    norm._compute_stats = _stats_in_input_precision
    variables = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), spec["variables"])
    trainer = jtr.Trainer(
        jcfg.ModelConfig(**spec["model_cfg"]), jcfg.TrainConfig(**spec["train_cfg"]),
        model=FocusModel(**spec["tiny"], dtype=jnp.float64, norm_dtype=jnp.float64),
        variables=variables, verbose=False)
    history = trainer.fit(spec["lines"], spec["val_lines"])
    host = lambda tree: jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)
    with open(dst, "wb") as f:
        pickle.dump({"history": [{k: float(v) for k, v in h.items()} for h in history],
                     "variables": host(trainer.variables),
                     "ema_variables": host(trainer.ema_variables)}, f)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
