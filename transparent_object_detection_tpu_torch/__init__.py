"""PyTorch/CUDA port of the FOCUS transparent-object detector.

The JAX package `transparent_object_detection_tpu` is the reference; this
package keeps its module and layer names and its public layouts, runs on an
NVIDIA Hopper card, and replaces the TPU's Pallas kernels with hand-written
CUDA kernels (`csrc/`). It imports neither JAX nor the JAX package.

Entry points: `models.detector.build_model`, `inference.Predictor`,
`train.trainer.Trainer` (`fit`: data/, the train step, eval/, checkpoints),
`weights.load_jax_variables`.
"""
