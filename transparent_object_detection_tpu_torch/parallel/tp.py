"""Tensor-parallel layout (counterpart of
transparent_object_detection_tpu/parallel/tp.py): Megatron-style shards of
the TEB projections over a `model` axis, and of the big kernels elsewhere,
for serving and for training.

    qkv / mlp1 weights (out, in)   column-parallel: rows (outputs) split
    attn_out / mlp2 weights        row-parallel: columns (inputs) split
    qkv / mlp1 biases              split with their outputs
    any other weight of >= GENERIC_SHARD_MIN_SIZE elements whose output
    count divides tp (not SelfAttention's query / key / value)
                                   column-parallel, outputs all-gathered
    everything else                replicated

The JAX package lets GSPMD place the collectives; the port runs them where
they fall: the TEB as a Megatron block (ops/teb_tp.py: one all-reduce a
row-parallel projection), a generically sharded conv or dense as its local
output channels, all-gathered over the model axis (models/blocks.py).
`tp_serving_copy` makes the Predictor's own copy of a model in that layout,
holding this rank's shards only; `shard_train_state_tp` puts a train state
in it (parameters, optimizer state, EMA) and `gather_train_state_tp` brings
the whole state back to every rank.
"""
from __future__ import annotations

import copy
import math
from typing import Dict, Iterable, Optional, Sequence, Tuple

import torch
from torch import nn

from transparent_object_detection_tpu_torch.parallel.distributed import process_count
from transparent_object_detection_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh

_COLUMN_PARALLEL = ("qkv", "mlp1")  # outputs split
_ROW_PARALLEL = ("attn_out", "mlp2")  # inputs split

# Kernels at or above this element count are sharded even outside the TEBs
# (the phi 'l'/'x' backbone convs reach 0.1-0.9 B parameters each); smaller
# ones stay replicated, where a shard saves little and costs a collective.
GENERIC_SHARD_MIN_SIZE = 1 << 20

Spec = Tuple[Optional[str], ...]


def make_2d_mesh(tp: int, devices: Optional[Sequence[int]] = None) -> Mesh:
    """(data, model) mesh: a tp-way model axis, the data axis over the rest;
    rank r (the r-th of `devices`, default every rank) is model index
    r % tp and data index r // tp."""
    ranks = list(devices) if devices is not None else list(range(process_count()))
    if len(ranks) % tp:
        raise ValueError(f"{len(ranks)} devices not divisible by tp={tp}")
    return Mesh(ranks, (len(ranks) // tp, tp), (DATA_AXIS, MODEL_AXIS))


def tp_param_spec(name: str, shape: Sequence[int], tp: Optional[int] = None) -> Spec:
    """The model-axis layout of one parameter, by its dotted name and shape
    in the port's layout: one entry a dimension, MODEL_AXIS on the split one
    (all None: replicated). tp, the model axis's size, enables the generic
    big-kernel rule; tp=None keeps to the TEB projections."""
    ndim = len(shape)
    parts = name.split(".")
    leaf = parts[-1]
    parent = parts[-2] if len(parts) > 1 else ""
    none: Spec = (None,) * ndim
    if leaf not in ("weight", "bias"):
        return none
    kernel = leaf == "weight" and ndim >= 2
    if parent in _COLUMN_PARALLEL and (kernel or leaf == "bias"):
        return (MODEL_AXIS,) + (None,) * (ndim - 1)
    if parent in _ROW_PARALLEL and kernel:
        return (None, MODEL_AXIS) + (None,) * (ndim - 2)
    if (tp is not None and kernel and math.prod(shape) >= GENERIC_SHARD_MIN_SIZE
            and shape[0] % tp == 0 and parent not in ("query", "key", "value")):
        return (MODEL_AXIS,) + (None,) * (ndim - 1)
    return none


def tp_shardings(model: nn.Module, mesh: Mesh) -> Dict[str, Spec]:
    """{parameter name: spec} over `model` (the rules above at the mesh's
    model-axis size)."""
    tp = mesh.size(MODEL_AXIS)
    return {n: tp_param_spec(n, tuple(p.shape), tp) for n, p in model.named_parameters()}


def canonicalize_qkv_for_tp(params: Dict[str, torch.Tensor], tp: int,
                            inverse: bool = False) -> Dict[str, torch.Tensor]:
    """Permute every fused qkv projection into rank-major row order.

    The stored rows are [q | k | v], C each; a contiguous model-axis shard
    of the 3C outputs would split inside a section. The TP TEB
    (ops/teb_tp.py) wants rank r's shard to be (q_r | k_r | v_r), its
    heads/tp contiguous heads of each section, so the rows are reordered to
    [q_0 | k_0 | v_0 | q_1 | k_1 | v_1 | ...] (JAX permutes the columns of
    its (in, out) kernels the same way). With `inverse`, the rank-major rows
    back to [q | k | v]. Returns a new dict; the other entries are passed
    through."""
    out = dict(params)
    for name, w in params.items():
        if not (name.endswith("qkv.weight") and w.dim() == 2 and w.shape[0] == 3 * w.shape[1]):
            continue
        c = w.shape[1]
        if c % tp:
            raise ValueError(f"qkv width {c} not divisible by tp={tp}")
        # (3, tp, C/tp, ...) <-> (tp, 3, C/tp, ...)
        split = (tp, 3) if inverse else (3, tp)
        out[name] = w.reshape(*split, c // tp, c).transpose(0, 1).reshape(3 * c, c)
        bias = name[: -len("weight")] + "bias"
        if bias in params:
            out[bias] = params[bias].reshape(*split, c // tp).transpose(0, 1).reshape(3 * c)
    return out


def _shard(t: torch.Tensor, spec: Spec, tp: int, r: int) -> torch.Tensor:
    if MODEL_AXIS not in spec:
        return t
    dim = spec.index(MODEL_AXIS)
    if t.shape[dim] % tp:
        raise ValueError(f"dimension {dim} of {tuple(t.shape)} not divisible by tp={tp}")
    return t.narrow(dim, r * (t.shape[dim] // tp), t.shape[dim] // tp)


def shard_params_tp(params: Dict[str, torch.Tensor], mesh: Mesh) -> Dict[str, torch.Tensor]:
    """This rank's shard of each entry of {name: tensor} by the rules above
    (views; replicated entries passed through)."""
    tp, r = mesh.size(MODEL_AXIS), mesh.index(MODEL_AXIS)
    return {n: _shard(t, tp_param_spec(n, tuple(t.shape), tp), tp, r)
            for n, t in params.items()}


def _owner(model: nn.Module, name: str) -> Tuple[nn.Module, str]:
    path, _, leaf = name.rpartition(".")
    return (model.get_submodule(path) if path else model), leaf


def _teb_modules(model: nn.Module) -> Iterable[nn.Module]:
    from transparent_object_detection_tpu_torch.models.blocks import TransformerEncoderBlock

    return [m for m in model.modules() if isinstance(m, TransformerEncoderBlock)]


@torch.no_grad()
def tp_serving_copy(model: nn.Module, mesh: Mesh) -> nn.Module:
    """The Predictor's own copy of `model` for tensor-parallel serving on
    `mesh`: the qkv rows canonicalized, every weight of two or more
    dimensions stored in the compute type when that is not fp32 (the bf16
    forward casts them at use anyway; the int8 weights are then quantized
    from the bf16-rounded values, as in JAX), only this rank's shard of each
    sharded parameter, and the TEBs and generically sharded layers pointed
    at the mesh. `model` itself is left as it was (its parameters are not
    copied first: the copy starts from meta placeholders)."""
    dtype = getattr(model, "dtype", torch.float32)
    specs = tp_shardings(model, mesh)
    full = {n: p.detach() for n, p in model.named_parameters()}
    params = shard_params_tp(canonicalize_qkv_for_tp(full, mesh.size(MODEL_AXIS)), mesh)
    tebs = _teb_modules(model)
    caches = [t._int8_cache for t in tebs]
    memo = {id(t): torch.empty(0, device="meta")
            for t in (*model.parameters(), *model.buffers())}
    for t in tebs:
        t._int8_cache = None
    try:
        out = copy.deepcopy(model, memo)
    finally:
        for t, cache in zip(tebs, caches):
            t._int8_cache = cache
    for name, p in params.items():
        owner, leaf = _owner(out, name)
        w = p
        if p.dim() >= 2 and dtype != torch.float32:
            w = w.to(dtype)
        owner._parameters[leaf] = nn.Parameter(w.clone(), requires_grad=False)
    for name, b in model.named_buffers():
        owner, leaf = _owner(out, name)
        owner._buffers[leaf] = b.detach().clone()
    _point_at(out, specs, mesh)
    return out


def _point_at(model: nn.Module, specs: Dict[str, Spec], mesh) -> None:
    """The TEBs and the generically sharded layers of `model` pointed at
    `mesh` (None: back to one device)."""
    for name, spec in specs.items():
        owner, leaf = _owner(model, name)
        if (MODEL_AXIS in spec and leaf == "weight"
                and name.rsplit(".", 2)[-2] not in _COLUMN_PARALLEL + _ROW_PARALLEL):
            owner.tp_mesh = mesh  # generic column-parallel: outputs all-gathered
    for t in _teb_modules(model):
        t.tp_serving, t.tp_mesh = mesh is not None, mesh
    model.tp_serving = mesh is not None


@torch.no_grad()
def shard_train_state_tp(state, mesh: Mesh):
    """A train state (train.trainer.TrainState) in the tensor-parallel
    layout of `mesh`, in place (JAX's `shard_params_tp` placing a train
    state's parameters): every parameter by `tp_param_spec` at the mesh's
    tp (the generic big-kernel rule on, as JAX's `tp_shardings`), the qkv
    rows canonicalized, this rank's shard of each sharded leaf of the
    parameters, the SGD momentum or Adam moments and the EMA parameters;
    BatchNorm statistics and their EMA replicated. The TEBs train through
    ops/teb_tp.py's training form and the generically sharded layers as
    column-parallel layers; `make_train_step(..., mesh=mesh)` and
    `make_eval_step` then run the step. `gather_train_state_tp` undoes it.
    Every rank must hold the same state first (`parallel.replicate_state`).
    Returns `state`."""
    model = state.model
    tp = mesh.size(MODEL_AXIS)
    specs = tp_shardings(model, mesh)
    layout = lambda d: shard_params_tp(canonicalize_qkv_for_tp(d, tp), mesh)
    params = layout({n: p.detach() for n, p in model.named_parameters()})
    for name, p in list(model.named_parameters()):
        owner, leaf = _owner(model, name)
        owner._parameters[leaf] = nn.Parameter(params[name].clone(),
                                               requires_grad=p.requires_grad)
    for key in ("trace", "mu", "nu"):
        if key in state.opt_state:
            state.opt_state[key] = {n: t.clone() for n, t in layout(state.opt_state[key]).items()}
    state.ema_params = {n: t.clone() for n, t in layout(state.ema_params).items()}
    _point_at(model, specs, mesh)
    model.tp_specs = specs
    for m in model.modules():  # int8 weights made from the whole parameters
        if hasattr(m, "_int8_cache"):
            m._int8_cache = None
    return state


@torch.no_grad()
def gather_train_state_tp(state, mesh: Mesh):
    """The whole train state on every rank, from a state in the layout of
    `shard_train_state_tp`: a new TrainState on a copy of the model in the
    one-device layout (the shards all-gathered over the model axis, the qkv
    rows back in [q | k | v] order; the parameters' `.grad` too, where
    set), for comparison, evaluation and saving. `state` is left as it
    is."""
    from transparent_object_detection_tpu_torch.parallel.mesh import all_gather_cat

    model = state.model
    specs = model.tp_specs
    tp = mesh.size(MODEL_AXIS)

    def whole(d):
        out = {}
        for n, t in d.items():
            spec = specs[n]
            out[n] = (all_gather_cat(t.detach(), mesh, MODEL_AXIS, spec.index(MODEL_AXIS))
                      if MODEL_AXIS in spec else t.detach().clone())
        return canonicalize_qkv_for_tp(out, tp, inverse=True)

    memo = {id(t): torch.empty(0, device="meta")
            for t in (*model.parameters(), *model.buffers())}
    meshes = {id(m.tp_mesh): m.tp_mesh for m in model.modules()
              if getattr(m, "tp_mesh", None) is not None}
    memo.update(meshes)  # the process groups are not copied
    caches = {m: m._int8_cache for m in model.modules() if hasattr(m, "_int8_cache")}
    for m in caches:
        m._int8_cache = None
    try:
        out = copy.deepcopy(model, memo)
    finally:
        for m, cache in caches.items():
            m._int8_cache = cache
    params = whole({n: p for n, p in model.named_parameters()})
    grads = whole({n: p.grad for n, p in model.named_parameters() if p.grad is not None})
    for name, p in model.named_parameters():
        owner, leaf = _owner(out, name)
        owner._parameters[leaf] = nn.Parameter(params[name], requires_grad=p.requires_grad)
        owner._parameters[leaf].grad = grads.get(name)
    for name, b in model.named_buffers():
        owner, leaf = _owner(out, name)
        owner._buffers[leaf] = b.detach().clone()
    _point_at(out, specs, None)
    del out.tp_specs
    opt_state = {k: (whole(v) if k in ("trace", "mu", "nu") else v.clone())
                 for k, v in state.opt_state.items()}
    return type(state)(model=out, opt_state=opt_state, ema_params=whole(state.ema_params),
                       ema_batch_stats={n: t.clone() for n, t in state.ema_batch_stats.items()},
                       ema_updates=state.ema_updates.clone(), step=state.step)


def train_state_bytes(model: nn.Module, tp: int, optimizer_type: str = "sgd",
                      ema: bool = True) -> int:
    """Bytes of the fp32 training state one rank holds at tp in the layout
    of `shard_train_state_tp`: parameters, their gradients, SGD momentum
    (Adam: two moments) and EMA parameters, each leaf's shard by
    `tp_param_spec`, plus the BatchNorm statistics and their EMA; from
    shapes only (a model on the meta device will do). Activations are not
    counted."""
    copies = 2 + (1 if optimizer_type == "sgd" else 2) + (1 if ema else 0)
    total = 0
    for name, p in model.named_parameters():
        spec = tp_param_spec(name, tuple(p.shape), tp)
        if MODEL_AXIS in spec and p.shape[spec.index(MODEL_AXIS)] % tp:
            raise ValueError(f"{name}: {tuple(p.shape)} not divisible by tp={tp}")
        total += copies * 4 * (p.numel() // (tp if MODEL_AXIS in spec else 1))
    stats = sum(b.numel() for b in model.buffers())
    return total + (2 if ema else 1) * 4 * stats


def per_rank_param_bytes(model: nn.Module, tp: int, dtype: Optional[torch.dtype] = None) -> int:
    """Bytes of parameters one rank holds when `model` serves at tp (its
    shards by `tp_param_spec`, weights of two or more dimensions in `dtype`
    when it is not fp32, as `tp_serving_copy` stores them); from shapes
    only, so a model on the meta device will do."""
    dtype = dtype or getattr(model, "dtype", torch.float32)
    wide = torch.finfo(dtype).bits // 8
    total = 0
    for name, p in model.named_parameters():
        spec = tp_param_spec(name, tuple(p.shape), tp)
        if MODEL_AXIS in spec and p.shape[spec.index(MODEL_AXIS)] % tp:
            raise ValueError(f"{name}: {tuple(p.shape)} not divisible by tp={tp}")
        n = p.numel() // (tp if MODEL_AXIS in spec else 1)
        total += n * (wide if p.dim() >= 2 and dtype != torch.float32 else 4)
    return total
