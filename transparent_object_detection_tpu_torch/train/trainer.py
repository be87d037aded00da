"""Training engine of the PyTorch port: the train and eval steps and the
epoch loop. Counterpart of transparent_object_detection_tpu/train/trainer.py
(TrainState, create_train_state, loss_config_from, make_train_step,
make_eval_step, Trainer).

The step: forward in training mode (batch statistics, BatchNorm running
statistics updated) -> detection loss -> backward -> [backbone gradients
zeroed] -> clip -> masked weight decay -> nesterov SGD or Adam -> p <- p -
lr * update -> EMA of the parameters and the BatchNorm statistics.

`Trainer.fit`: annotations -> augmented DetectionDataset -> threaded
DataLoader -> device_prefetch -> the step; validation loss on the EMA
weights; callbacks (LossHistory, EvalCallback); checkpoints with an exact
resume. Freeze phase: backbone updates are zeroed with the same optimizer
state structure, so the state carries across the unfreeze boundary, where
the loaders and lr schedule are rebuilt and the EMA update counter resyncs
to steps_per_epoch * epoch.

Tensor parallelism (a (data, model) mesh, on a state from
`parallel.tp.shard_train_state_tp`) runs in `make_train_step` and
`make_eval_step`; `Trainer.fit` trains data-parallel only, as JAX's fit.

Data parallelism (`mesh`, a 1-D data mesh of parallel/): every rank runs
the step on its rows of the same global batch, and the step equals JAX's
step on the global batch: BatchNorm takes the global batch's statistics
(`models.blocks.global_batchnorm`), the loss is normalised by the global
target score mass, the gradients are summed over the ranks before the clip,
and the parameters, optimizer state and EMA stay bit-identical on every
rank. Rank 0 alone writes checkpoints and logs.

Compute policy, as in JAX: parameters are fp32 and cast to the compute type
at each use (gradients flow back through the casts to fp32), norms run in
fp32, and there is no autocast and no loss scaling. The step updates the
model and the state in place (the counterpart of JAX's donated state) and
leaves each parameter's `.grad` holding this step's loss gradient (zero on
a frozen backbone).

Compiled steps, as JAX's `jax.jit(step, donate_argnums=(0,))` and
`jax.jit(eval_step)`, whatever the sharding of their inputs: on CUDA, with
no mesh or on a mesh whose collectives NCCL runs (`Mesh.capturable`), both
steps run through the program cache of inference.py, one captured CUDA
graph a key (the entry, its configuration, the mesh's layout, the batch's
shapes and dtypes, the model's traced attributes), the first call of a key
eager, the second captured, later ones replayed. On a mesh the graph holds
the step's collectives: the global BatchNorm's statistic sums, the loss's
normaliser, the gradient all-reduce, the replicated gradients' broadcast
over the model axis, the clip's sum over shards and the components' sum;
a replay launches each once. The learning rate is an input of the program
(a 0-d float32 tensor copied in with the batch), the EMA decay and Adam's
bias corrections are computed on the device from device counters, and
nothing is read back to the host inside a step, so one graph serves every
epoch of a phase.
A graph reads and writes the tensors it was captured on: the model's, the
gradients (zeroed and accumulated in place, never reallocated), the
optimizer state, the EMA shadows and the counter; a step whose tensors
changed (a resume's `load_state_tree`, a new state) warms up and captures
anew. On the CPU, and on a mesh with a gloo group (gloo stages its
transfers through the host, which a capture cannot record), the steps run
eagerly.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from transparent_object_detection_tpu_torch.config import ModelConfig, TrainConfig
from transparent_object_detection_tpu_torch.data.dataset import DetectionDataset
from transparent_object_detection_tpu_torch.data.loader import DataLoader, device_prefetch
from transparent_object_detection_tpu_torch.inference import programs_of, run_program
from transparent_object_detection_tpu_torch.models.blocks import global_batchnorm
from transparent_object_detection_tpu_torch.models.detector import build_model, resolve_device
from transparent_object_detection_tpu_torch.parallel.distributed import process_index
from transparent_object_detection_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    all_reduce_sum,
    broadcast_first,
    coalesced,
    local_batch_slice,
    replicate_state,
)
from transparent_object_detection_tpu_torch.parallel.tp import MODEL_AXIS
from transparent_object_detection_tpu_torch.train.checkpoints import load_state_tree, state_tree
from transparent_object_detection_tpu_torch.train.ema import ema_init, ema_update
from transparent_object_detection_tpu_torch.train.loss import LossConfig, detection_loss
from transparent_object_detection_tpu_torch.train.optimizer import (
    Optimizer,
    backbone_frozen_mask,
    build_optimizer,
)
from transparent_object_detection_tpu_torch.train.schedule import get_lr_scheduler


@dataclass
class TrainState:
    """The model holds the parameters and the BatchNorm statistics; beside
    it, the optimizer state, the fp32 EMA shadows and two counters. All
    tensors live on the model's device. `ema_updates` is a 0-d int32 tensor
    there (JAX's device int32), which the step advances in place; assigning
    a number or a tensor writes its value into that tensor (never aliasing
    another state's counter) and `int(state.ema_updates)` reads it. `step`
    is a host int, advanced once a call outside any graph."""

    model: nn.Module
    opt_state: Dict[str, Any]
    ema_params: Dict[str, torch.Tensor]
    ema_batch_stats: Dict[str, torch.Tensor]
    ema_updates: Any = 0
    step: int = 0

    def __post_init__(self):
        if not isinstance(self.ema_updates, torch.Tensor):
            device = next(self.model.parameters()).device
            self.__dict__["ema_updates"] = torch.tensor(int(self.ema_updates),
                                                        dtype=torch.int32, device=device)

    def __setattr__(self, name, value):
        counter = self.__dict__.get(name)
        if name == "ema_updates" and isinstance(counter, torch.Tensor):
            with torch.no_grad():
                if isinstance(value, torch.Tensor):
                    counter.copy_(value)
                else:
                    counter.fill_(int(value))
        else:
            super().__setattr__(name, value)

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())

    @property
    def batch_stats(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_buffers())

    def tensors(self) -> Tuple[torch.Tensor, ...]:
        """What a step reads and writes besides the model's parameters and
        buffers: the gradients, the optimizer state, the EMA shadows and
        the counter (a compiled step's fingerprint)."""
        opt = [t for v in self.opt_state.values()
               for t in (v.values() if isinstance(v, dict) else (v,))
               if isinstance(t, torch.Tensor)]
        grads = [p.grad for p in self.model.parameters() if p.grad is not None]
        return (*grads, *opt, *self.ema_params.values(), *self.ema_batch_stats.values(),
                self.ema_updates)


def create_train_state(model: nn.Module, optimizer: Optimizer, ema_updates: int = 0) -> TrainState:
    """State for `model` as it is (load weights first)."""
    params = dict(model.named_parameters())
    return TrainState(model=model, opt_state=optimizer.init(params), ema_params=ema_init(params),
                      ema_batch_stats=ema_init(dict(model.named_buffers())),
                      ema_updates=ema_updates)


def loss_config_from(model_cfg: ModelConfig, train_cfg: TrainConfig) -> LossConfig:
    return LossConfig(
        num_classes=model_cfg.num_classes, reg_max=model_cfg.reg_max, strides=model_cfg.strides,
        box_weight=train_cfg.box_weight, cls_weight=train_cfg.cls_weight,
        dfl_weight=train_cfg.dfl_weight, tal_topk=train_cfg.tal_topk,
        tal_alpha=train_cfg.tal_alpha, tal_beta=train_cfg.tal_beta,
        label_smoothing=train_cfg.label_smoothing,
    )


def _sharded(model: nn.Module, mesh) -> List[str]:
    """The parameters of `model` that hold this rank's shard over the model
    axis of `mesh` (empty without one). A model axis of tp > 1 needs the
    model in the tensor-parallel layout (`parallel.tp.shard_train_state_tp`
    on its state, on this mesh)."""
    if mesh is None or mesh.size(MODEL_AXIS) <= 1:
        return []
    specs = getattr(model, "tp_specs", None)
    if specs is None or not getattr(model, "tp_serving", False):
        raise ValueError("a (data, model) mesh trains a state in the tensor-parallel layout: "
                         "call parallel.tp.shard_train_state_tp(state, mesh) first")
    return [n for n, spec in specs.items() if MODEL_AXIS in spec]


def _global_components(comps: Dict[str, torch.Tensor], mesh) -> Dict[str, torch.Tensor]:
    """The ranks' loss components summed: the global batch's (one
    all-reduce)."""
    if mesh is None:
        return comps
    keys = list(comps)
    vals = all_reduce_sum(torch.stack([comps[k].detach().float() for k in keys]), mesh)
    return dict(zip(keys, vals.unbind()))


def _compiled(graphs: Optional[bool], mesh, image: torch.Tensor) -> bool:
    """Whether a step runs through the program cache: on CUDA with no mesh
    or a capturable one (NCCL's), unless `graphs` says otherwise."""
    if graphs is not None:
        return graphs
    return image.device.type == "cuda" and (mesh is None or mesh.capturable)


def make_train_step(model: nn.Module, optimizer: Optimizer, loss_cfg: LossConfig,
                    train_cfg: TrainConfig, freeze_backbone: bool = False,
                    mesh=None, graphs: Optional[bool] = None) -> Callable:
    """(state, batch, lr) -> (state, components). batch: {"image" (B, H, W, 3)
    float in [0, 1], "boxes" (B, M, 4) normalised cxcywh (padded slots zero),
    "labels" (B, M) int}; lr a float or a 0-d float32 tensor on the device
    (JAX's `jnp.asarray(lr, jnp.float32)`). Components are 0-d fp32 tensors
    on the device (no host synchronisation), each call's its own. With
    freeze_backbone the backbone's gradients are zeroed before the clip and
    its parameters do not move; its BatchNorm statistics still update. With
    a data-parallel `mesh`, batch holds this rank's rows of the global
    batch, and the step (and its components) is the global batch's. With a
    (data, model) mesh (`parallel.tp.make_2d_mesh`), the state is in the
    tensor-parallel layout (`parallel.tp.shard_train_state_tp`): each rank
    of a model group takes the same rows, the sharded layers' collectives
    run in the forward and backward, the gradients are summed over the data
    axis only (each replicated leaf's then taken from the model group's
    first rank), the clip takes the global norm over the shards, and the
    optimizer and the EMA run on the shards (JAX's step on
    `shard_params_tp`'s state).

    On CUDA with no mesh, or on a mesh whose collectives NCCL runs, the
    step is compiled: a captured CUDA graph a batch shape, its collectives
    in it (module docstring); `graphs` forces that path (True) or the eager
    one (False), as comparisons of kernels against plain versions or of
    planted faults need (a replayed graph runs the kernels it was captured
    on)."""
    frozen = ([n for n, f in backbone_frozen_mask(model).items() if f]
              if freeze_backbone else [])
    # what the graph bakes in besides the tensors it reads: never the lr
    config = repr((freeze_backbone, train_cfg, optimizer.cfg,
                   sorted(n for n, f in optimizer.decay_mask.items() if f), loss_cfg))

    def run(state: TrainState, image, boxes, labels, lr):
        """The step's device work, with no host-side effect (a capture runs
        it once without running its kernels, and a replay runs no Python)."""
        sharded = _sharded(model, mesh)
        params = dict(model.named_parameters())
        # gradients zeroed and accumulated in place: a graph writes the
        # tensors it was captured on
        held = [p.grad for p in params.values() if p.grad is not None]
        if held:
            torch._foreach_zero_(held)
        with global_batchnorm(model, mesh):
            out = model(image)
            total, comps = detection_loss(out["raw"], boxes, labels, loss_cfg, mesh)
            total.backward()
        with torch.no_grad():
            if mesh is not None:  # the global batch's gradient: the ranks' sum
                coalesced([p.grad for p in params.values()],
                          lambda t: all_reduce_sum(t, mesh, DATA_AXIS))
            if sharded:
                # a replicated leaf's gradient is computed on every rank of the
                # model group, and on a card not to the same bits (atomics in
                # its backward kernels): every rank takes the first rank's
                keep = set(sharded)
                coalesced([p.grad for n, p in params.items() if n not in keep],
                          lambda t: broadcast_first(t, mesh, MODEL_AXIS))
            if frozen:
                torch._foreach_zero_([params[n].grad for n in frozen])
            grads = {n: p.grad for n, p in params.items()}
            updates, state.opt_state = optimizer.update(grads, state.opt_state, params, mesh,
                                                        sharded)
            if frozen:
                torch._foreach_zero_([updates[n] for n in frozen])
            names = list(params)
            # p + (-lr * u), as JAX's apply_updates of -lr * updates
            scaled = torch._foreach_mul([updates[n] for n in names], -lr)
            del updates
            torch._foreach_add_([params[n] for n in names], scaled)
            del scaled
            if train_cfg.ema:
                state.ema_updates.add_(1)
                ema_update(state.ema_params, params, state.ema_updates, train_cfg.ema_decay,
                           train_cfg.ema_tau)
                ema_update(state.ema_batch_stats, dict(model.named_buffers()),
                           state.ema_updates, train_cfg.ema_decay, train_cfg.ema_tau)
        return _global_components({k: v.detach() for k, v in comps.items()}, mesh)

    def step(state: TrainState, batch: Dict[str, torch.Tensor], lr):
        model.train()
        image = batch["image"]
        lr = torch.as_tensor(lr, dtype=torch.float32, device=image.device)
        inputs = (image, batch["boxes"], batch["labels"], lr)
        if _compiled(graphs, mesh, image):
            comps = run_program(model, "trainer.train_step",
                                lambda m, *t: run(state, *t), inputs, (config,),
                                tensors=state.tensors, training=True, mesh=mesh)
        else:
            comps = run(state, *inputs)
        state.step += 1
        return state, comps

    return step


def make_eval_step(model: nn.Module, loss_cfg: LossConfig, use_ema: bool = True,
                   mesh=None, graphs: Optional[bool] = None) -> Callable:
    """(state, batch) -> components: the validation loss in evaluation mode
    (running statistics) on the raw maps, with the EMA weights by default;
    with a data-parallel `mesh`, the global batch's from this rank's rows;
    with a (data, model) mesh, on a state in the tensor-parallel layout (the
    sharded layers' serving forms). On CUDA with no mesh or a capturable
    one, one captured CUDA graph a batch shape, reading the EMA shadows in
    place; `graphs` as in `make_train_step`."""

    def run(state: TrainState, image, boxes, labels):
        with torch.no_grad():
            if use_ema:
                out = torch.func.functional_call(
                    model, {**state.ema_params, **state.ema_batch_stats}, (image,),
                    {"decode": False})
            else:
                out = model(image, decode=False)
            _, comps = detection_loss(out["raw"], boxes, labels, loss_cfg, mesh)
        return _global_components(comps, mesh)

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        _sharded(model, mesh)
        inputs = (batch["image"], batch["boxes"], batch["labels"])
        was_training = model.training
        model.eval()
        try:
            if _compiled(graphs, mesh, inputs[0]):
                shadows = lambda: ((*state.ema_params.values(), *state.ema_batch_stats.values())
                                   if use_ema else ())
                return run_program(model, "trainer.eval_step", lambda m, *t: run(state, *t),
                                   inputs, (use_ema, repr(loss_cfg)), tensors=shadows, mesh=mesh)
            return run(state, *inputs)
        finally:
            model.train(was_training)

    return step


def _host_copy(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {n: t.detach().to("cpu", copy=True) for n, t in tensors.items()}


class Trainer:
    """Epoch loop. The model is built at `model_cfg` (seeded with
    train_cfg.seed) unless given, and runs on `device`: CUDA unless the
    caller names another; without a card this raises unless device="cpu".
    `loader_processes`: the loaders assemble batches in a process pool of
    train_cfg.num_workers workers instead of threads (the same batches;
    data/loader.py); the pool's fork server imports the calling script, so
    its entry point must sit under `if __name__ == "__main__":`.
    `fit(..., mesh=...)` trains data-parallel (every rank of the mesh calls
    it with the same arguments). On CUDA, with no mesh or on an NCCL mesh,
    `fit` runs the train and eval steps as captured CUDA graphs, and its
    EvalCallback's Predictor serves from them (module docstring); on a gloo
    mesh they run eagerly. `graphs` forces that path (True) or the eager
    one (False)."""

    def __init__(
        self,
        model_cfg: ModelConfig,
        train_cfg: TrainConfig,
        model: Optional[nn.Module] = None,
        verbose: bool = True,
        device=None,
        loader_processes: bool = False,
    ):
        self.model_cfg = model_cfg
        self.loader_processes = loader_processes
        self.train_cfg = train_cfg
        self.verbose = verbose
        self.device = resolve_device(device)
        self.model = (model if model is not None
                      else build_model(model_cfg, device=self.device, seed=train_cfg.seed))
        self.model.to(self.device)
        self.loss_cfg = loss_config_from(model_cfg, train_cfg)
        self.mesh = None  # the data-parallel mesh of the running `fit`
        self.history: List[Dict[str, float]] = []
        # host copies of {"params", "batch_stats"} ({name: tensor}), set by fit
        self.variables: Optional[Dict[str, Dict[str, torch.Tensor]]] = None
        self.ema_variables: Optional[Dict[str, Dict[str, torch.Tensor]]] = None
        self.graphs: Optional[bool] = None
        self._reported = set()  # the train keys whose eager decision was printed

    # -- loaders -------------------------------------------------------------

    @property
    def is_main(self) -> bool:
        """Whether this process writes checkpoints and logs (rank 0)."""
        return process_index() == 0

    def _make_loader(self, lines: Sequence[str], batch_size: int, train: bool) -> DataLoader:
        tc = self.train_cfg
        mesh = getattr(self, "mesh", None)
        ds = DetectionDataset(
            list(lines),
            input_shape=self.model_cfg.input_shape,
            num_classes=self.model_cfg.num_classes,
            epoch_length=tc.unfreeze_epoch,
            mosaic=tc.mosaic if train else False,
            mosaic_prob=tc.mosaic_prob if train else 0.0,
            mixup=tc.mixup if train else False,
            mixup_prob=tc.mixup_prob if train else 0.0,
            train=train,
            special_aug_ratio=tc.special_aug_ratio if train else 0.0,
            max_boxes=tc.max_boxes,
            seed=tc.seed,
        )
        return DataLoader(
            ds,
            batch_size=batch_size,
            shuffle=train,
            num_workers=tc.num_workers,
            drop_last=True,
            seed=tc.seed,
            use_processes=self.loader_processes,
            row_shard=0 if mesh is None else mesh.index(DATA_AXIS),
            row_shards=1 if mesh is None else mesh.size(DATA_AXIS),
        )

    def _report_eager_keys(self) -> None:
        """Print, once a key, each train step the program cache runs eagerly
        because its graph was predicted not to fit."""
        for p in programs_of(self.model):
            if p["eager"] and p["key"] not in self._reported:
                self._reported.add(p["key"])
                shapes = p["key"][-1]
                print(f"{p['entry']} at batch {shapes[0][0][0]} runs eagerly: its graph is "
                      f"predicted at {p['predicted_bytes'] / 2**30:.2f} GiB, "
                      f"{p['free_bytes'] / 2**30:.2f} GiB free")

    # -- main loop -------------------------------------------------------------

    def fit(
        self,
        train_lines: Sequence[str],
        val_lines: Sequence[str],
        callbacks: Sequence[Any] = (),
        checkpointer: Optional[Any] = None,
        resume_from: Optional[str] = None,
        mesh=None,
    ) -> List[Dict[str, float]]:
        """mesh: a data-parallel mesh (parallel.make_mesh) to train on: each
        rank assembles and steps on its rows of every global batch (the
        batch sizes must divide the mesh), the EvalCallback's Predictor
        adopts the mesh, and rank 0 alone writes checkpoints and logs."""
        tc = self.train_cfg
        model = self.model
        if mesh is not None and mesh.size(MODEL_AXIS) > 1:
            raise NotImplementedError(
                "Trainer.fit trains on a data-parallel mesh (parallel.make_mesh); train "
                "tensor-parallel through make_train_step on a state from "
                "parallel.tp.shard_train_state_tp, as JAX's make_train_step on "
                "shard_params_tp's state")
        self.mesh = mesh
        if mesh is not None:
            for bs in {tc.freeze_batch_size, tc.unfreeze_batch_size}:
                local_batch_slice(bs, mesh)
        opt = build_optimizer(tc, model)
        state = create_train_state(model, opt)
        if resume_from is not None:
            # Exact resume: the whole train state, optimizer and EMA counters
            # included. Set train_cfg.init_epoch to match.
            if checkpointer is None:
                raise ValueError("resume_from requires a checkpointer")
            load_state_tree(state, checkpointer.restore_like(resume_from, state_tree(state)))
        if mesh is not None:  # every rank starts from rank 0's state
            replicate_state(state, mesh)

        frozen_phase = tc.freeze_train and tc.init_epoch < tc.freeze_epoch
        batch_size = tc.freeze_batch_size if frozen_phase else tc.unfreeze_batch_size

        def build_phase(bs: int, frozen: bool):
            init_lr, min_lr = tc.fit_lr(bs)
            sched = get_lr_scheduler(tc.lr_decay_type, init_lr, min_lr, tc.unfreeze_epoch)
            # The freeze-phase optimizer differs only in its weight-decay
            # mask: the same state structure, so opt_state carries across.
            phase_opt = build_optimizer(tc, model, freeze_backbone=True) if frozen else opt
            step_fn = make_train_step(model, phase_opt, self.loss_cfg, tc, freeze_backbone=frozen,
                                      mesh=mesh, graphs=self.graphs)
            tl = self._make_loader(train_lines, bs, train=True)
            vl = self._make_loader(val_lines, bs, train=False)
            return sched, step_fn, tl, vl

        sched, train_step, train_loader, val_loader = build_phase(batch_size, frozen_phase)
        eval_step = make_eval_step(model, self.loss_cfg, use_ema=tc.ema, mesh=mesh,
                                   graphs=self.graphs)
        steps_per_epoch = len(train_loader)
        if steps_per_epoch == 0 or len(val_loader) == 0:
            raise ValueError("dataset too small for the batch size")
        if tc.init_epoch:
            state.ema_updates = steps_per_epoch * tc.init_epoch

        best_val = float("inf")
        unfroze = not frozen_phase
        for epoch in range(tc.init_epoch, tc.unfreeze_epoch):
            if tc.freeze_train and not unfroze and epoch >= tc.freeze_epoch:
                batch_size = tc.unfreeze_batch_size
                sched, train_step, train_loader, val_loader = build_phase(batch_size, False)
                steps_per_epoch = len(train_loader)
                state.ema_updates = steps_per_epoch * epoch
                unfroze = True

            train_loader.set_epoch(epoch)
            val_loader.set_epoch(epoch)
            lr = float(sched(epoch))
            # an input of the compiled step, as JAX's jnp.asarray(lr, jnp.float32)
            lr_t = torch.tensor(lr, dtype=torch.float32, device=self.device)

            t0 = time.time()
            # Per-step losses stay on the device (each step's own tensor,
            # cloned out of a graph's output): one stack + sum, and one host
            # synchronisation, per epoch.
            tr_losses = []
            for batch in device_prefetch(iter(train_loader), device=self.device):
                state, comps = train_step(state, batch, lr_t)
                tr_losses.append(comps["loss"])
            n_tr = len(tr_losses)
            tr_loss = float(torch.stack(tr_losses).sum()) if tr_losses else 0.0

            va_losses = []
            for batch in device_prefetch(iter(val_loader), device=self.device):
                comps = eval_step(state, batch)
                va_losses.append(comps["loss"])
            n_va = len(va_losses)
            va_loss = float(torch.stack(va_losses).sum()) if va_losses else 0.0

            logs = {
                "epoch": epoch,
                "loss": tr_loss / max(n_tr, 1),
                "val_loss": va_loss / max(n_va, 1),
                "lr": lr,
                "epoch_seconds": time.time() - t0,
            }
            self.history.append(logs)
            if self.verbose and self.is_main:
                self._report_eager_keys()
                print(
                    f"epoch {epoch + 1}/{tc.unfreeze_epoch} "
                    f"loss={logs['loss']:.4f} val_loss={logs['val_loss']:.4f} "
                    f"lr={lr:.2e} ({logs['epoch_seconds']:.1f}s, "
                    f"{n_tr * batch_size / max(logs['epoch_seconds'], 1e-9):.1f} imgs/s)"
                )
            for cb in callbacks:
                cb.on_epoch_end(epoch + 1, logs, self, state)

            if checkpointer is not None and self.is_main:
                is_best = logs["val_loss"] < best_val
                best_val = min(best_val, logs["val_loss"])
                checkpointer.save_epoch(state, epoch + 1, is_best=is_best,
                                        period=tc.save_period)

        self.variables = {"params": _host_copy(state.params),
                          "batch_stats": _host_copy(state.batch_stats)}
        self.ema_variables = {"params": _host_copy(state.ema_params),
                              "batch_stats": _host_copy(state.ema_batch_stats)}
        return self.history
