"""Profiling and timing helpers: the port's counterpart of
transparent_object_detection_tpu/utils/profiling.py.

  * time_fn / throughput: wall-clock timing that waits for the CUDA stream
    where JAX waits with block_until_ready.
  * trace: a torch.profiler context writing a Chrome trace.
  * cost_analysis: operations and bytes of any callable, counted from shapes
    without running it (fake tensors), as JAX's lowering counts them.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves


def _sync() -> None:
    """Wait for every launched CUDA kernel (nothing to wait for on the CPU)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def time_fn(fn: Callable, *args, iters: int = 20, warmup: int = 2, **kwargs) -> float:
    """Mean seconds per call of `fn`, the device's work included."""
    for _ in range(max(warmup, 1)):
        fn(*args, **kwargs)
    _sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args, **kwargs)
    _sync()
    return (time.perf_counter() - t0) / iters


def throughput(fn: Callable, batch_size: int, *args, iters: int = 20, **kwargs) -> float:
    """Items/sec for a batched function."""
    return batch_size / time_fn(fn, *args, iters=iters, **kwargs)


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler over the block (the CPU, and CUDA where there is a
    card); writes `log_dir/trace.json` (Chrome trace format: chrome://tracing
    or Perfetto) and yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
        _sync()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class _BytesCounter(TorchDispatchMode):
    """Sums the bytes of every tensor operand and result of each dispatched
    operator."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves((args, kwargs, out)):
            if isinstance(t, torch.Tensor):
                self.bytes += t.numel() * t.element_size()
        return out


def cost_analysis(fn: Callable, *example_args) -> Dict[str, float]:
    """Operations and bytes of fn(*example_args), counted on fake tensors of
    the arguments' shapes, types and devices, so nothing is computed:

      * flops: `torch.utils.flop_counter.FlopCounterMode`, 2 per
        multiply-add of the products (matmuls, convolutions, attention) and
        of the port's registered kernels (`torch.ops.focus.*`, their
        formulas in ops/library.py); elementwise work counts nothing.
      * bytes_accessed: the bytes of every operand and result of every
        dispatched operator summed, i.e. the traffic with no fusion at all.

    JAX's `cost_analysis` is XLA's cost model of the compiled program:
    it counts elementwise operations too and the bytes of its fused
    kernels, so the two agree on the products and differ by the rest."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    flops = FlopCounterMode(display=False)
    nbytes = _BytesCounter()
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        args = [mode.from_tensor(a) if isinstance(a, torch.Tensor) else a
                for a in example_args]
        with torch.no_grad(), flops, nbytes:
            fn(*args)
    return {"flops": float(flops.get_total_flops()), "bytes_accessed": float(nbytes.bytes)}
