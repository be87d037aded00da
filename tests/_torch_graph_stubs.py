"""The CPU's stand-ins for a CUDA graph capture (inference._capture_graph),
shared by the program cache's tests and the rank functions that run the
cache on gloo ranks (tests/_torch_ranks.py). The CPU has no CUDA graphs:
  * `FakeGraph` (serving): the capture runs the step once on the static
    input buffers, as a capture traces it; each replay runs it again and
    writes the static output in place, as a replay does;
  * `FakeTrainGraph` (a step that writes state): the capture runs the
    step's Python once (its host effects happen) and puts back every tensor
    the step wrote in place (`_UndoWrites`), as a capture records kernels
    without running them; a replay runs the step again;
  * `HostReads`: records every op that reads a tensor back to the host or
    makes one from host data, which a captured step must not do.
Each holds the model weakly, as a graph holds no Python object. This module
imports neither JAX nor the JAX package."""
from __future__ import annotations

import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode


class FakeGraph:
    """A CUDA graph's part on the CPU: `replay` runs the captured step on the
    static inputs and writes the static output in place."""

    def __init__(self, step, model, inputs):
        self.step, self.model, self.inputs = step, weakref.ref(model), inputs
        self.output = step(model, *inputs)

    def replay(self):
        fresh = self.step(self.model(), *self.inputs)
        pairs = (zip(self.output.values(), fresh.values()) if isinstance(fresh, dict)
                 else [(self.output, fresh)])
        for static, new in pairs:
            static.copy_(new)


class _UndoWrites(TorchDispatchMode):
    """Keeps the value of every tensor an op writes in place, before its
    first write, and puts them all back on exit."""

    def __init__(self):
        super().__init__()
        self.saved, self.seen = [], set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        for i, arg in enumerate(func._schema.arguments):
            if arg.alias_info is None or not arg.alias_info.is_write:
                continue
            value = args[i] if i < len(args) else kwargs.get(arg.name)
            for t in (value if isinstance(value, (list, tuple)) else [value]):
                if isinstance(t, torch.Tensor) and id(t) not in self.seen:
                    self.seen.add(id(t))
                    self.saved.append((t, t.clone()))
        return func(*args, **kwargs)

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        with torch.no_grad():
            for t, value in reversed(self.saved):
                t.copy_(value)
        return out


class FakeTrainGraph:
    """A CUDA graph's part on the CPU for a step that writes state: the
    capture runs the step's Python and undoes its writes; `replay` runs the
    step on the static inputs and writes the static output in place."""

    def __init__(self, step, model, inputs):
        self.step, self.model, self.inputs = step, weakref.ref(model), inputs
        with _UndoWrites():
            self.output = step(model, *inputs)

    def replay(self):
        fresh = self.step(self.model(), *self.inputs)
        for static, new in zip(self.output.values(), fresh.values()):
            static.copy_(new)


class HostReads(TorchDispatchMode):
    """Records every op that reads a tensor back to the host or makes one
    from host data."""

    READS = ("aten::_local_scalar_dense", "aten::lift_fresh", "aten::lift_fresh_copy")

    def __init__(self):
        super().__init__()
        self.reads = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func._schema.name in self.READS:
            self.reads.append(func._schema.name)
        return func(*args, **(kwargs or {}))


def install(inference, train: bool = False) -> list:
    """Put the stand-in capture into `inference` (the port's module) for the
    rest of the process: FakeTrainGraph with `train`, else FakeGraph.
    Returns the list the captures are appended to."""
    made = []
    kind = FakeTrainGraph if train else FakeGraph

    def capture(step, model, inputs):
        graph = kind(step, model, inputs)
        made.append(graph)
        return graph, graph.output, 0

    inference._capture_graph = capture
    return made
