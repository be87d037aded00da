"""Rank functions of the port's parallel tests (tests/test_torch_tp.py,
test_torch_parallel.py, test_torch_distributed.py): each runs in one of the
processes that `parallel.launch.Ranks` starts on the CPU (gloo, one thread
a rank), after the process group is up, and returns what its test holds
against the JAX package. This module imports neither JAX nor the JAX
package, so a rank starts in a few seconds."""
from __future__ import annotations

import os

import numpy as np
import torch

from transparent_object_detection_tpu_torch.config import ModelConfig, PredictConfig, TrainConfig
from transparent_object_detection_tpu_torch.inference import Predictor
from transparent_object_detection_tpu_torch.models import blocks
from transparent_object_detection_tpu_torch.models.detector import FocusModel
from transparent_object_detection_tpu_torch.parallel import (
    make_2d_mesh,
    make_mesh,
    process_count,
    process_index,
    shard_batch,
)
from transparent_object_detection_tpu_torch.parallel.mesh import all_reduce_sum
from transparent_object_detection_tpu_torch.train import trainer as trainer_mod
from transparent_object_detection_tpu_torch.train.optimizer import build_optimizer
from transparent_object_detection_tpu_torch.train.trainer import (
    create_train_state,
    loss_config_from,
    make_train_step,
)

# tests/test_tp.py's serving setup: base_channels 32 at 128 x 128, 8 heads
# requested (4 at h1 and h6, a ragged 3 at h2 and h4)
TP_MODEL = dict(num_classes=1, base_channels=32, base_depth=1, deep_mul=0.5, num_heads=8,
                dtype=torch.float32)
TP_CFG = ModelConfig(num_classes=1, input_shape=(128, 128), compute_dtype="float32")
TP_PREDICT = PredictConfig(confidence=0.01, max_detections=16, pre_nms_topk=64)
# tests/test_parallel.py's tiny model
TINY_MODEL = dict(num_classes=1, base_channels=8, base_depth=1, deep_mul=0.5, num_heads=2,
                  dtype=torch.float32)
TINY_CFG = ModelConfig(num_classes=1, input_shape=(64, 64), compute_dtype="float32")
TINY_PREDICT = PredictConfig(confidence=0.01, max_detections=8, pre_nms_topk=32)


def _param_bytes(model: torch.nn.Module) -> int:
    return sum(p.numel() * p.element_size() for p in model.parameters())


def tp_serving(path: str, tp: int) -> dict:
    """The TP Predictor on make_2d_mesh(tp) over the world, fp32 and int8
    (int8_dense + int8_attn) on the same weights: the global `decoded` of
    the Predictor's model, its detections (fp32), its parameter bytes."""
    data = torch.load(path)
    mesh = make_2d_mesh(tp)
    out = {"coords": mesh.coords}
    for int8 in (False, True):
        model = FocusModel(**TP_MODEL, int8_dense=int8, int8_attn=int8)
        model.load_state_dict(data["state"])
        pred = Predictor(model, TP_CFG, TP_PREDICT, device="cpu", mesh=mesh)
        with torch.no_grad():
            decoded = pred.model(data["images"])["decoded"]
        key = "int8" if int8 else "fp32"
        out[key] = {"decoded": decoded, "bytes": _param_bytes(pred.model),
                    "tp_serving": pred.model.tp_serving and model.tp_serving is False}
        if not int8:
            out["dets"] = pred.detect_letterboxed(data["images"], data["shapes"])
    return out


def predictors(path: str) -> dict:
    """Two Predictors with different meshes in one process (a data mesh and
    a (data 1, model 2) mesh), called in turns, beside the Predictor with no
    mesh; and the indivisible batch refused by the data mesh."""
    data = torch.load(path)
    model = FocusModel(**TINY_MODEL)
    model.load_state_dict(data["state"])
    images, shapes = data["images"], data["shapes"]
    ref = Predictor(model, TINY_CFG, TINY_PREDICT, device="cpu").detect_letterboxed(images, shapes)
    p_dp = Predictor(model, TINY_CFG, TINY_PREDICT, device="cpu", mesh=make_mesh())
    p_tp = Predictor(model, TINY_CFG, TINY_PREDICT, device="cpu", mesh=make_2d_mesh(2))
    runs = [p_dp.detect_letterboxed(images, shapes), p_tp.detect_letterboxed(images, shapes),
            p_dp.detect_letterboxed(images, shapes)]
    refused = None
    try:
        p_dp.detect_letterboxed(images[:3], shapes[:3])
    except ValueError as exc:
        refused = str(exc)
    return {"ref": ref, "runs": runs, "refused": refused,
            "shards": (p_dp.data_shards, p_tp.data_shards),
            "tp_three": p_tp.detect_letterboxed(images[:3], shapes[:3])["num_detections"]}


def dp_steps(path: str) -> dict:
    """One data-parallel step (make_mesh over the world) from the same
    weights on each global batch of `path`; and, for the planted fault,
    the same step with BatchNorm on each rank's own statistics."""
    data = torch.load(path)
    tc = TrainConfig(**data["train_cfg"])
    mesh = make_mesh()
    out = {}
    for name, batch in data["batches"].items():
        for fault in (False, True):
            model = FocusModel(**TINY_MODEL)
            model.load_state_dict(data["state"])
            opt = build_optimizer(tc, model)
            step = make_train_step(model, opt, loss_config_from(TINY_CFG, tc), tc, mesh=mesh)
            state = create_train_state(model, opt)
            if fault:  # the step's BatchNorm context without the mesh
                trainer_mod.global_batchnorm = lambda m, mesh: blocks.global_batchnorm(m, None)
            try:
                state, comps = step(state, shard_batch(batch, mesh), data["lr"])
            finally:
                trainer_mod.global_batchnorm = blocks.global_batchnorm
            out[name, fault] = {
                "comps": {k: float(v) for k, v in comps.items()},
                "params": {k: v.detach().clone() for k, v in state.params.items()},
                "batch_stats": {k: v.clone() for k, v in state.batch_stats.items()},
                "ema_params": state.ema_params, "ema_batch_stats": state.ema_batch_stats,
                "trace": state.opt_state["trace"],
            }
    return out


def fit_with_eval(root: str, lines: list) -> dict:
    """tests/test_parallel.py's --data-parallel path: Trainer.fit on a data
    mesh over the world with an EvalCallback whose batch (5) does not
    divide it, a LossHistory and a CheckpointManager in one directory
    shared by the ranks."""
    from transparent_object_detection_tpu_torch.eval.callbacks import EvalCallback, LossHistory
    from transparent_object_detection_tpu_torch.train.checkpoints import CheckpointManager
    from transparent_object_detection_tpu_torch.train.trainer import Trainer

    tc = TrainConfig(init_epoch=0, freeze_epoch=0, unfreeze_epoch=1, freeze_train=False,
                     unfreeze_batch_size=8, num_workers=2, mosaic=False, mixup=False,
                     max_boxes=8, optimizer_type="sgd", save_dir=os.path.join(root, "logs"),
                     eval_period=1, save_period=1)
    model = FocusModel(**TINY_MODEL)
    trainer = Trainer(TINY_CFG, tc, model=model, verbose=False, device="cpu")
    cb = EvalCallback(TINY_CFG, lines, ["Transparent"], tc.save_dir, period=1, eval_flag=True,
                      batch_size=5, device="cpu")
    history = trainer.fit(lines, lines, callbacks=[LossHistory(tc.save_dir), cb],
                          checkpointer=CheckpointManager(tc.save_dir), mesh=make_mesh())
    return {"history": history, "data_shards": cb._predictor.data_shards,
            "dets": cb.last_dets,
            "params": {k: v.detach().clone() for k, v in model.named_parameters()}}


def collectives(n_items: int) -> dict:
    """tests/test_distributed.py's bring-up: the process group's rank and
    size, an all-reduce of ones, the loader's file shards and its row
    shards of each global batch."""
    from transparent_object_detection_tpu_torch.data.loader import DataLoader

    class _Stub:
        epoch_now = 0

        def __len__(self):
            return n_items

        def __getitem__(self, i):
            return {"index": np.asarray(i)}

    rank, world = process_index(), process_count()
    total = all_reduce_sum(torch.ones(4, 4), make_mesh())
    files = DataLoader(_Stub(), batch_size=2, shuffle=False, num_workers=1, shard_id=rank,
                       num_shards=world)
    rows = DataLoader(_Stub(), batch_size=4, shuffle=True, num_workers=1, seed=3,
                      row_shard=rank, row_shards=world)
    rows.set_epoch(1)
    return {"rank": rank, "world": world, "total": float(total.sum()), "files": sorted(int(i) for i in files._epoch_indices()),
            "rows": [b["index"].tolist() for b in rows]}


def one_rank_fails() -> None:
    """Rank 1 raises while rank 0 waits in a collective: the launcher must
    stop rank 0 and report rank 1's error."""
    if process_index() == 1:
        raise RuntimeError("planted failure on rank 1")
    all_reduce_sum(torch.ones(1), make_mesh())


def hangs() -> None:
    """Every rank waits in a collective that one rank never joins."""
    if process_index() == 0:
        all_reduce_sum(torch.ones(1), make_mesh())
    else:
        import time

        time.sleep(3600)


def focus_serve_mesh(root: str) -> dict:
    """FOCUS.serve_mesh at phi='n' 64 x 64 on the CPU: the data-parallel
    Predictor's detections against FOCUS's own Predictor, and tp=2, which
    phi='n''s TEB widths (849 at h1) refuse as JAX's canonicalization does."""
    from transparent_object_detection_tpu_torch.api import FOCUS

    classes = os.path.join(root, "classes.txt")
    if process_index() == 0:
        with open(classes, "w") as fh:
            fh.write("glass\n")
    all_reduce_sum(torch.zeros(1), make_mesh())  # the file is written before rank 1 reads it
    f = FOCUS(phi="n", classes_path=classes, input_shape=(64, 64), verbose=False, device="cpu")
    images = torch.from_numpy(np.random.default_rng(4).uniform(size=(4, 64, 64, 3))
                              .astype(np.float32))
    shapes = torch.full((4, 2), 64.0)
    ref = f.predictor.detect_letterboxed(images, shapes)
    pred = f.serve_mesh()
    got = pred.detect_letterboxed(images, shapes)
    refused = None
    try:
        f.serve_mesh(tp=2)
    except ValueError as exc:
        refused = str(exc)
    return {"ref": ref, "got": got, "data_shards": pred.data_shards, "refused": refused}


def train_tool(root: str, train: str, val: str) -> list:
    """tools/train.py --data-parallel on the ranks of this world (phi='n'
    64 x 64, one unfrozen epoch at a global batch of 4, evaluation on)."""
    from transparent_object_detection_tpu_torch.tools import train as train_cli

    classes = os.path.join(root, "classes.txt")
    with open(classes, "w") as fh:
        fh.write("glass\n")
    train_cli.main(["--classes", classes, "--phi", "n", "--input-shape", "64", "64",
                 "--train-annotations", train, "--val-annotations", val,
                 "--save-dir", os.path.join(root, "logs"), "--no-freeze-train",
                 "--init-epoch", "0", "--freeze-epoch", "0", "--unfreeze-epoch", "1",
                 "--unfreeze-batch-size", "4", "--no-mosaic", "--no-mixup", "--eval-period", "1",
                 "--save-period", "1", "--num-workers", "1", "--compute-dtype", "float32",
                 "--device", "cpu", "--data-parallel"])
    all_reduce_sum(torch.zeros(1), make_mesh())  # rank 0's files are written
    return sorted(os.listdir(os.path.join(root, "logs")))


# tensor-parallel training cases of tests/test_torch_tp_train.py: name ->
# (TrainConfig overrides, make_train_step's freeze_backbone, FocusModel's
# remat, GENERIC_SHARD_MIN_SIZE or None for the package's own)
TP_TRAIN_CASES = {
    "default": ({}, False, False, None),
    "clip": ({"grad_clip_norm": 1.0}, False, False, None),
    "freeze": ({}, True, False, None),
    "remat": ({}, False, True, None),
    "generic": ({}, False, False, 2048),
}


def _replicated_mismatches(state, mesh) -> int:
    """Elements of the replicated leaves (parameters, their gradients, the
    momenta, EMA, BatchNorm statistics) in which this rank differs from
    another rank of its model group."""
    from transparent_object_detection_tpu_torch.parallel.mesh import MODEL_AXIS, all_gather_list

    specs = state.model.tp_specs
    rep = [n for n, spec in specs.items() if MODEL_AXIS not in spec]
    params = dict(state.model.named_parameters())
    tensors = ([params[n] for n in rep] + [params[n].grad for n in rep]
               + [state.opt_state["trace"][n] for n in rep] + [state.ema_params[n] for n in rep]
               + list(state.model.buffers()) + list(state.ema_batch_stats.values()))
    bad = 0
    for t in tensors:
        for other in all_gather_list(t.detach(), mesh, MODEL_AXIS):
            bad += int((other != t).sum())
    return bad


def tp_train(path: str, tp: int) -> dict:
    """Every case of TP_TRAIN_CASES as one step on make_2d_mesh(tp) over the
    world, from the weights in `path` on its global batch (each rank of a
    model group on its data index's rows): the loss components, the whole
    state gathered back (`gather_train_state_tp`), the replicated leaves'
    mismatches across the model group; for the default case also the eval
    step on the TP state against the eval step on the gathered one."""
    from transparent_object_detection_tpu_torch.parallel import tp as ttp
    from transparent_object_detection_tpu_torch.train.trainer import make_eval_step

    data = torch.load(path)
    mesh = make_2d_mesh(tp)
    batch = shard_batch(data["batch"], mesh)
    out = {"coords": mesh.coords}
    default_min = ttp.GENERIC_SHARD_MIN_SIZE
    for name, (overrides, freeze, remat, min_size) in TP_TRAIN_CASES.items():
        tc = TrainConfig(**{**data["train_cfg"], **overrides})
        model = FocusModel(**TINY_MODEL, remat=remat)
        model.load_state_dict(data["state"])
        opt = build_optimizer(tc, model, freeze_backbone=freeze)
        state = create_train_state(model, opt)
        ttp.GENERIC_SHARD_MIN_SIZE = min_size or default_min  # this rank's process only
        try:
            ttp.shard_train_state_tp(state, mesh)
        finally:
            ttp.GENERIC_SHARD_MIN_SIZE = default_min
        lc = loss_config_from(TINY_CFG, tc)
        step = make_train_step(model, opt, lc, tc, freeze_backbone=freeze, mesh=mesh)
        state, comps = step(state, batch, data["lr"])
        whole = ttp.gather_train_state_tp(state, mesh)
        rec = {"comps": {k: float(v) for k, v in comps.items()},
               "sharded": sorted(n for n, s in model.tp_specs.items() if "model" in s),
               "params": {k: v.detach() for k, v in whole.params.items()},
               "batch_stats": dict(whole.batch_stats), "ema_params": whole.ema_params,
               "ema_batch_stats": whole.ema_batch_stats, "trace": whole.opt_state["trace"],
               "replicated_mismatches": _replicated_mismatches(state, mesh)}
        if name == "default":
            ev = make_eval_step(model, lc, mesh=mesh)(state, batch)
            ref = make_eval_step(whole.model, lc)(whole, data["batch"])
            rec["eval"] = {k: float(v) for k, v in ev.items()}
            rec["eval_whole"] = {k: float(v) for k, v in ref.items()}
        out[name] = rec
    try:
        from transparent_object_detection_tpu_torch.train.trainer import Trainer

        Trainer(TINY_CFG, TrainConfig(), model=FocusModel(**TINY_MODEL), verbose=False,
                device="cpu").fit([], [], mesh=mesh)
    except NotImplementedError as exc:
        out["fit_refused"] = str(exc)
    return out


def int8_1x1_ranks(path: str) -> dict:
    """The int8 1x1 route on 2 ranks: a ConvBNAct(1,536 -> 1,024) on a data
    mesh, each rank on its half of the global batch (128 rows a rank, not
    a multiple of 256; the global batch's 256 are): its own route off,
    under `global_rows` on; the same conv column-sharded over a model axis
    of 2 (its route on this rank's output columns, all-gathered); and the
    Predictor on a data mesh opening `global_rows` around its forward (the
    tiny model's int8 convs see `data_shards` 2)."""
    from transparent_object_detection_tpu_torch.parallel.mesh import MODEL_AXIS, all_gather_cat

    data = torch.load(path)
    conv = blocks.ConvBNAct(1536, 1024, 1, dtype=torch.float32, int8_1x1=True).eval()
    conv.load_state_dict(data["conv"])
    x = data["x"]
    mesh = make_mesh()
    local = shard_batch({"x": x}, mesh)["x"]
    out = {"local_route": conv.int8_route(local)}
    with torch.no_grad():
        with blocks.global_rows(conv, mesh.size("data")):
            out["global_route"] = conv.int8_route(local)
            y = conv(local)
        out["dp"] = all_gather_cat(y, mesh, "data", 0)
        tp_mesh = make_2d_mesh(2)
        r, n = tp_mesh.index(MODEL_AXIS), 512
        conv.conv.weight = torch.nn.Parameter(conv.conv.weight[r * n:(r + 1) * n].clone())
        conv.conv.tp_mesh = tp_mesh
        out["tp"] = conv(x)
    seen = []
    real = blocks.ConvBNAct.int8_route

    def spy(self, x):
        if self.int8_1x1:
            seen.append(self.data_shards)
        return real(self, x)

    model = FocusModel(**TINY_MODEL, int8_1x1=True)
    model.load_state_dict(data["tiny"])
    pred = Predictor(model, TINY_CFG, TINY_PREDICT, device="cpu", mesh=mesh)
    blocks.ConvBNAct.int8_route = spy
    try:
        pred.detect_letterboxed(data["images"], data["shapes"])
    finally:
        blocks.ConvBNAct.int8_route = real
    out["predictor_shards"] = sorted(set(seen))
    out["after"] = sorted({m.data_shards for m in model.modules()
                           if isinstance(m, blocks.ConvBNAct)})
    return out


# ---------------------------------------------------------------------------
# mesh programs through the program cache (tests/test_torch_mesh_graphs.py)
# ---------------------------------------------------------------------------

MESH_GRAPH_LRS = (1e-3, 5e-4, 2e-3)  # one lr a step: one graph serves them all


def _leaves(model, state, comps=None) -> dict:
    """Every leaf a step reads or writes, copied (this rank's shards)."""
    out = {f"param {n}": p.detach().clone() for n, p in model.named_parameters()}
    out.update({f"grad {n}": p.grad.clone() for n, p in model.named_parameters()
                if p.grad is not None})
    out.update({f"stat {n}": b.clone() for n, b in model.named_buffers()})
    out.update({f"trace {n}": t.clone() for n, t in state.opt_state["trace"].items()})
    out.update({f"ema {n}": t.clone() for n, t in state.ema_params.items()})
    out.update({f"ema stat {n}": t.clone() for n, t in state.ema_batch_stats.items()})
    out["ema_updates"] = state.ema_updates.clone()
    out.update({f"comp {k}": v.clone() for k, v in (comps or {}).items()})
    return out


def _mesh_step_setup(data, mesh, graphs, tp: bool = False):
    from transparent_object_detection_tpu_torch.parallel import tp as ttp
    from transparent_object_detection_tpu_torch.train.trainer import make_eval_step

    tc = TrainConfig(**data["train_cfg"])
    model = FocusModel(**TINY_MODEL)
    model.load_state_dict(data["state"])
    opt = build_optimizer(tc, model)
    state = create_train_state(model, opt)
    if tp:
        ttp.shard_train_state_tp(state, mesh)
    lc = loss_config_from(TINY_CFG, tc)
    return (model, state, make_train_step(model, opt, lc, tc, mesh=mesh, graphs=graphs),
            make_eval_step(model, lc, mesh=mesh, graphs=graphs))


def _mesh_steps(data, mesh, batch, graphs: bool, tp: bool = False) -> dict:
    """Three steps at MESH_GRAPH_LRS (warm-up, capture and replay, replay
    when graphed), then three eval steps, from the weights in `data`."""
    from transparent_object_detection_tpu_torch.inference import programs_of

    model, state, step, eval_step = _mesh_step_setup(data, mesh, graphs, tp)
    records = []
    for lr in MESH_GRAPH_LRS:
        state, comps = step(state, batch, lr)
        records.append(_leaves(model, state, comps))
    evals = [eval_step(state, batch) for _ in range(3)]
    return {"records": records, "evals": evals,
            "entries": [{k: e[k] for k in ("entry", "captured", "replays", "parts", "eager")}
                        for e in programs_of(model)]}


def _from_start(data, mesh, batch) -> list:
    """Three graphed data-parallel steps, each from the weights in `data`
    (the state written back in place, so the graph reads it): the loss, the
    parameters and the BatchNorm statistics after each."""
    model, state, step, _ = _mesh_step_setup(data, mesh, True)
    tensors = [*(p.detach() for p in model.parameters()), *model.buffers(),
               *state.opt_state["trace"].values(), *state.ema_params.values(),
               *state.ema_batch_stats.values(), state.ema_updates]
    start = [t.clone() for t in tensors]
    out = []
    for lr in MESH_GRAPH_LRS:
        state, comps = step(state, batch, lr)
        out.append({"loss": float(comps["loss"]),
                    "params": {n: p.detach().clone() for n, p in model.named_parameters()},
                    "stats": {n: b.clone() for n, b in model.named_buffers()}})
        with torch.no_grad():
            for t, t0 in zip(tensors, start):
                t.copy_(t0)
    return out


def mesh_graphs(path: str) -> dict:
    """The mesh programs through the program cache on these gloo ranks, the
    capture stubbed (tests/_torch_graph_stubs.py), as the CUDA path runs
    them on NCCL:
      * the data-mesh Predictor forced onto the cache: warm-up, capture and
        replays on two batches, beside the eager mesh Predictor; a
        no-mesh Predictor and a Predictor on a mesh of the ranks in the
        other order on the same model (each its own entry);
      * the memory decision with each rank given other free bytes;
      * the data-parallel and the (data 1, model 2) train and eval steps
        graphed and eager, the eager steps under HostReads, and three
        graphed data-parallel steps each from the starting weights;
      * the capturability predicate and `_compiled` on this gloo mesh."""
    from types import SimpleNamespace

    from _torch_graph_stubs import HostReads, install

    from transparent_object_detection_tpu_torch import inference
    from transparent_object_detection_tpu_torch.parallel.mesh import Mesh

    data = torch.load(path)
    mesh = make_mesh()
    cuda_image = SimpleNamespace(device=SimpleNamespace(type="cuda"))
    out = {"capturable": mesh.capturable,
           "compiled": trainer_mod._compiled(None, mesh, cuda_image)}
    images, shapes = data["images"], data["shapes"]

    # serving: the mesh Predictor on the cache, against eager
    made = install(inference)
    model = FocusModel(**TINY_MODEL)
    model.load_state_dict(data["state"])
    graphed = Predictor(model, TINY_CFG, TINY_PREDICT, device="cpu", mesh=mesh)
    out["eager_graphs_flag"] = graphed._graphs
    graphed._graphs = True  # the CUDA path, on the stubbed capture
    eager = Predictor(model, TINY_CFG, TINY_PREDICT, device="cpu", mesh=mesh)
    calls = [graphed.detect_letterboxed(images, shapes) for _ in range(3)]
    calls.append(graphed.detect_letterboxed(data["images2"], shapes))
    out["serve"] = {"graphed": calls, "eager": [eager.detect_letterboxed(images, shapes),
                                                eager.detect_letterboxed(data["images2"], shapes)],
                    "captures": len(made)}
    # keys: the same model with no mesh, and on the ranks in the other order
    single = Predictor(model, TINY_CFG, TINY_PREDICT, device="cpu")
    single._graphs = True
    reversed_mesh = Mesh(list(reversed(range(process_count()))), (process_count(),), ("data",))
    other = Predictor(model, TINY_CFG, TINY_PREDICT, device="cpu", mesh=reversed_mesh)
    other._graphs = True
    out["keys"] = {"single": [single.detect_letterboxed(images, shapes) for _ in range(3)],
                   "single_eager": Predictor(model, TINY_CFG, TINY_PREDICT,
                                             device="cpu").detect_letterboxed(images, shapes),
                   "reversed": [other.detect_letterboxed(images, shapes) for _ in range(3)],
                   "entries": [{k: e[k] for k in ("key", "captured", "replays")}
                               for e in inference.programs_of(model)],
                   "captures": len(made)}

    # the memory decision: every rank given other free bytes (a warm-up
    # peak of 1,000 bytes; GRAPH_POOL_OVER_EAGER 1.6)
    rank = process_index()
    decisions = {}
    real_warm_up, real_free = inference._warm_up, inference._free_bytes
    inference._warm_up = lambda *a: (real_warm_up(*a)[0], 1000)
    try:
        for case, free in data["free_bytes"].items():
            inference._free_bytes = lambda device, f=free[rank]: f
            m = FocusModel(**TINY_MODEL)
            m.load_state_dict(data["state"])
            pred = Predictor(m, TINY_CFG, TINY_PREDICT, device="cpu", mesh=mesh)
            pred._graphs = True
            got = [pred.detect_letterboxed(images, shapes) for _ in range(3)]
            (entry,) = inference.programs_of(m)
            decisions[case] = {k: entry[k] for k in ("parts", "eager", "captured", "free_bytes",
                                                     "peak_bytes")}
            decisions[case]["dets"] = got[-1]
        inference._free_bytes = lambda device: data["train_free_bytes"][rank]
        install(inference, train=True)
        m, state, step, _ = _mesh_step_setup(data, mesh, True)
        for lr in MESH_GRAPH_LRS:
            state, _ = step(state, shard_batch(data["batch"], mesh), lr)
        (entry,) = inference.programs_of(m)
        decisions["train"] = {k: entry[k] for k in ("eager", "captured", "free_bytes",
                                                     "predicted_bytes")}
    finally:
        inference._warm_up, inference._free_bytes = real_warm_up, real_free
    out["decisions"] = decisions

    # the steps: data-parallel and (data 1, model 2), graphed against eager
    made = install(inference, train=True)
    tp_mesh = make_2d_mesh(2)
    local = shard_batch(data["batch"], mesh)
    tp_rows = shard_batch(data["batch"], tp_mesh)
    cases = (("dp", mesh, local, False), ("tp", tp_mesh, tp_rows, True))
    out["steps"] = {name: {"eager": _mesh_steps(data, m_, rows, False, tp),
                           "graphed": _mesh_steps(data, m_, rows, True, tp)}
                    for name, m_, rows, tp in cases}
    out["step_captures"] = len(made)
    reads = {}
    for name, m_, rows, tp in cases:
        _, state, step, eval_step = _mesh_step_setup(data, m_, False, tp)
        state, _ = step(state, rows, MESH_GRAPH_LRS[0])  # the gradients exist
        lr = torch.tensor(MESH_GRAPH_LRS[1])  # a device tensor, as Trainer.fit passes it
        with HostReads() as guard:
            step(state, rows, lr)
        reads[name] = guard.reads
        with HostReads() as guard:
            eval_step(state, rows)
        reads[name + " eval"] = guard.reads
    out["host_reads"] = reads
    out["from_start"] = _from_start(data, mesh, local)
    return out
