"""Tensor operations of the PyTorch port. Importing any of them registers
the serving kernels as `torch.ops.focus.*` (ops/library.py)."""
from transparent_object_detection_tpu_torch.ops import library  # noqa: F401
