"""PyTorch/CUDA port of the FOCUS transparent-object detector.

The JAX package `transparent_object_detection_tpu` is the reference; this
package keeps its module and layer names and its public layouts, runs on an
NVIDIA Hopper card, and replaces the TPU's Pallas kernels with hand-written
CUDA kernels (`csrc/`), registered as `torch.ops.focus.*`
(`ops/library.py`). It imports neither JAX nor the JAX package.

Entry points: `FOCUS` (api.py: predict, train, evaluate, export, fuse,
summary), `models.detector.build_model`, `inference.Predictor`,
`train.trainer.Trainer` (`fit`: data/, the train step, eval/, checkpoints),
`weights.load_jax_variables`, `config.load_config`; the drivers under
`tools/` (`python -m transparent_object_detection_tpu_torch.tools.predict`
and the others).
"""

from transparent_object_detection_tpu_torch.config import (  # noqa: F401
    SCALE_TABLE,
    ModelConfig,
    PredictConfig,
    TrainConfig,
    load_config,
)

_LAZY = {"FOCUS": "transparent_object_detection_tpu_torch.api"}


def __getattr__(name):
    # FOCUS imported on first use: `import transparent_object_detection_tpu_torch`
    # stays cheap for ops-only users and free of import cycles.
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(name)
