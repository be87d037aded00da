"""Start a function on N ranks of a fresh process group and collect what
each returns: one process a rank on this host, with torchrun's RANK,
WORLD_SIZE and LOCAL_RANK, joined through `initialize_multihost` on a
rendezvous file in the run's own temporary directory before the function
runs (no port is taken: runs started side by side cannot meet).

    from transparent_object_detection_tpu_torch.parallel.launch import run_ranks
    results = run_ranks("mypkg.mymod:fn", 2, {"x": 1}, timeout=120, device="cpu")

Every rank runs `fn(**kwargs)`; its return value (anything `torch.save`
writes) comes back in rank order. A rank that fails makes the others stop
at once (they would wait in a collective), and so does the timeout; either
raises `RankFailure` with the ranks' output. Serving and training under
torchrun need none of this: it is how the port's tests and chip_smoke.py
run several ranks on one host (ranks on one card: device="cuda",
backend="gloo").
"""
from __future__ import annotations

import importlib
import os
import subprocess
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional, Sequence

import torch

PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


class RankFailure(RuntimeError):
    pass


class Ranks:
    """`world_size` running ranks of `target` ("module:function"), started
    at once; `join` waits for them. `device` and `backend` go to
    `initialize_multihost`; `threads` sets each rank's torch threads;
    `paths` are put before the package on each rank's import path."""

    def __init__(self, target: str, world_size: int, kwargs: Optional[Dict[str, Any]] = None,
                 timeout: float = 600.0, device: Optional[str] = None,
                 backend: Optional[str] = None, threads: Optional[int] = None,
                 paths: Sequence[str] = ()):
        self.dir = tempfile.TemporaryDirectory(prefix="ranks_")
        self.timeout = timeout
        self.deadline = time.monotonic() + timeout
        spec = os.path.join(self.dir.name, "spec.pt")
        torch.save({"target": target, "kwargs": kwargs or {}, "device": device,
                    "backend": backend, "threads": threads, "paths": list(paths),
                    "timeout_s": timeout}, spec)
        base = dict(os.environ)
        base["PYTHONPATH"] = os.pathsep.join(
            [PACKAGE_ROOT, *paths] + ([base["PYTHONPATH"]] if base.get("PYTHONPATH") else []))
        base["WORLD_SIZE"] = str(world_size)
        self.procs, self.logs = [], []
        for rank in range(world_size):
            log = open(os.path.join(self.dir.name, f"rank{rank}.log"), "w+")
            self.logs.append(log)
            self.procs.append(subprocess.Popen(
                [sys.executable, "-m", __name__, spec, str(rank)],
                env={**base, "RANK": str(rank), "LOCAL_RANK": str(rank)},
                stdout=log, stderr=subprocess.STDOUT, cwd=PACKAGE_ROOT))

    def _output(self, rank: int, tail: int = 6000) -> str:
        log = self.logs[rank]
        log.flush()
        log.seek(0)
        return log.read()[-tail:]

    def _stop(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait()

    def join(self) -> List[Any]:
        try:
            while True:
                codes = [p.poll() for p in self.procs]
                failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
                if failed:
                    self._stop()
                    raise RankFailure(f"rank {failed[0]} exited with {codes[failed[0]]}:\n"
                                      + self._output(failed[0]))
                if all(c == 0 for c in codes):
                    break
                if time.monotonic() > self.deadline:
                    late = [r for r, c in enumerate(codes) if c is None]
                    self._stop()
                    raise RankFailure(f"ranks {late} still running after {self.timeout} s:\n"
                                      + self._output(late[0]))
                time.sleep(0.05)
            return [torch.load(os.path.join(self.dir.name, f"result{r}.pt"),
                               weights_only=False) for r in range(len(self.procs))]
        finally:
            self._stop()
            for log in self.logs:
                log.close()
            self.dir.cleanup()


def run_ranks(target: str, world_size: int, kwargs: Optional[Dict[str, Any]] = None,
              timeout: float = 600.0, **options) -> List[Any]:
    """Run `target` on `world_size` ranks and return their results in rank
    order (options as `Ranks`)."""
    return Ranks(target, world_size, kwargs, timeout, **options).join()


def _on_cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _on_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_on_cpu(v) for v in obj)
    return obj


def _rank_main(spec_path: str, rank: int) -> None:
    import datetime

    from transparent_object_detection_tpu_torch.parallel.distributed import (
        initialize_multihost,
        shutdown_multihost,
    )

    spec = torch.load(spec_path, weights_only=False)
    sys.path[:0] = spec["paths"]
    if spec["threads"]:
        torch.set_num_threads(spec["threads"])
    module, _, name = spec["target"].partition(":")
    fn = getattr(importlib.import_module(module), name)
    initialize_multihost("file://" + os.path.join(os.path.dirname(spec_path), "rendezvous"),
                         backend=spec["backend"], device=spec["device"],
                         timeout=datetime.timedelta(seconds=spec["timeout_s"]))
    try:
        result = fn(**spec["kwargs"])
    finally:
        shutdown_multihost()
    out = os.path.join(os.path.dirname(spec_path), f"result{rank}.pt")
    torch.save(_on_cpu(result), out + ".tmp")
    os.replace(out + ".tmp", out)


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]))
