"""The port's tensor-parallel training (parallel/mesh.py's collectives with
their gradients, ops/teb_tp.py's training form, the column-parallel convs
and denses, parallel.tp.shard_train_state_tp / gather_train_state_tp, the
clip over shards, make_train_step on a (data, model) mesh) against the JAX
package's TP train step (tests/test_tp.py:72-123), on the CPU.

The port runs gloo processes of one thread each (`parallel.launch.Ranks`,
started first) at dp1xtp2, dp1xtp4 (the tiny model's one-head h1/h6 and
two-head h2/h4 TEBs: ragged at tp 4, all-gathered) and dp2xtp2; JAX runs
its single-device step and its step on `shard_params_tp`'s state over 2
and 4 of the conftest's virtual devices. The setup is tests/test_tp.py's:
the tiny fp32 model (base_channels 8), 64 x 64, a global batch of 8, SGD
with EMA, lr 1e-3, on random_variables' weights. Bars are JAX's own: loss
1e-4 relative, parameters 5e-5, and the same 5e-5 for the momenta, the EMA
and the BatchNorm statistics of the state gathered back to every rank.

Cases (tests/_torch_ranks.TP_TRAIN_CASES): the default step; the clip
biting (grad_clip_norm 1); a frozen backbone; remat; GENERIC_SHARD_MIN_SIZE
lowered to 2,048 on both sides (convs, the head's output convs and denses
column-sharded), against JAX's TP step with the same rule at dp2xtp2. The
replicated leaves are equal bit for bit across each model group; the eval
step on the TP state equals it on the gathered state; Trainer.fit refuses a
model axis.
"""
from __future__ import annotations

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from _torch_parity import random_variables, to_jax
from transparent_object_detection_tpu import config as jcfg
from transparent_object_detection_tpu.models import FocusModel as JFocusModel
from transparent_object_detection_tpu.parallel import tp as jtp
from transparent_object_detection_tpu.train import optimizer as jopt
from transparent_object_detection_tpu.train import trainer as jtr
from transparent_object_detection_tpu_torch.config import TrainConfig
from transparent_object_detection_tpu_torch.models.detector import FocusModel
from transparent_object_detection_tpu_torch.parallel.launch import Ranks
from transparent_object_detection_tpu_torch.weights import (
    load_jax_variables,
    params_from_jax,
    state_dict_from_jax,
)

import _torch_ranks as R

torch.set_num_threads(1)

TESTS = os.path.dirname(__file__)
RANK_TIMEOUT = 300.0
LR = 1e-3
LOSS_REL, PARAM_TOL = 1e-4, 5e-5
# name -> (tp, ranks)
MESHES = {"dp1xtp2": (2, 2), "dp1xtp4": (4, 4), "dp2xtp2": (2, 4)}
# JAX's TP step: one case a mesh (each a compile of its own)
JAX_TP = {"dp1xtp2": "default", "dp1xtp4": "default", "dp2xtp2": "generic"}
# the single-device reference of each port case (remat and the generic rule
# change no value)
JAX_SINGLE = {"default": "default", "clip": "clip", "freeze": "freeze", "remat": "default",
              "generic": "default"}


def _jax_tiny():
    return JFocusModel(num_classes=1, base_channels=8, base_depth=1, deep_mul=0.5, num_heads=2,
                       dtype=jnp.float32)


def _batch() -> dict:
    """tests/test_tp.py:80-85."""
    boxes = np.zeros((8, 4, 4), np.float32)
    boxes[:, 0] = [0.5, 0.5, 0.4, 0.4]
    return {"image": np.random.default_rng(1).uniform(size=(8, 64, 64, 3)).astype(np.float32),
            "boxes": boxes, "labels": np.zeros((8, 4), np.int64)}


def _trace(opt_state):
    (trace,) = [s.trace for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.TraceState))
        if isinstance(s, optax.TraceState)]
    return trace


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    variables = random_variables(_jax_tiny(), jnp.zeros((1, 64, 64, 3), jnp.float32), train=True)
    port = load_jax_variables(FocusModel(**R.TINY_MODEL), variables)
    tc = TrainConfig(max_boxes=4, optimizer_type="sgd", ema=True)
    batch = _batch()
    path = str(tmp_path_factory.mktemp("tp_train") / "inputs.pt")
    torch.save({"state": port.state_dict(), "train_cfg": dataclasses.asdict(tc), "lr": LR,
                "batch": {k: torch.from_numpy(v) for k, v in batch.items()}}, path)
    ranks = {name: Ranks("_torch_ranks:tp_train", n, {"path": path, "tp": tp},
                         timeout=RANK_TIMEOUT, device="cpu", threads=1, paths=[TESTS])
             for name, (tp, n) in MESHES.items()}

    jmodel = _jax_tiny()
    mc = jcfg.ModelConfig(num_classes=1, input_shape=(64, 64), compute_dtype="float32")
    jb = {k: jnp.asarray(v.astype(np.int32) if k == "labels" else v) for k, v in batch.items()}
    lr = jnp.asarray(LR, jnp.float32)

    def record(new, comps):
        return {"loss": float(comps["loss"]), "params": params_from_jax(new.params, port),
                "ema_params": params_from_jax(new.ema_params, port),
                "trace": params_from_jax(_trace(new.opt_state), port),
                "batch_stats": state_dict_from_jax({"params": new.params,
                                                    "batch_stats": new.batch_stats}, port),
                "ema_batch_stats": state_dict_from_jax({"params": new.params,
                                                        "batch_stats": new.ema_batch_stats},
                                                       port)}

    def step_of(case):
        overrides, freeze, _, _ = R.TP_TRAIN_CASES[case]
        jtc = jcfg.TrainConfig(**{**dataclasses.asdict(tc), **overrides})
        tx = jopt.build_optimizer(jtc, to_jax(variables["params"]), freeze_backbone=freeze)
        step = jtr.make_train_step(jmodel, tx, jtr.loss_config_from(mc, jtc), jtc,
                                   freeze_backbone=freeze, donate=False)
        return step, jtr.create_train_state(jmodel, to_jax(variables), tx)

    single = {}
    for case in sorted(set(JAX_SINGLE.values())):
        step, state = step_of(case)
        single[case] = record(*step(state, jb, lr))
    tp_runs = {}
    for name, case in JAX_TP.items():
        tp, n = MESHES[name]
        mesh = jtp.make_2d_mesh(tp, jax.devices()[:n])
        step, state = step_of(case)
        min_size = R.TP_TRAIN_CASES[case][3] or jtp.GENERIC_SHARD_MIN_SIZE
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jtp, "GENERIC_SHARD_MIN_SIZE", min_size)
            state = state.replace(params=jtp.shard_params_tp(state.params, mesh))
            specs = jax.tree_util.tree_leaves(jtp.tp_shardings(state.params, mesh))
        repl = NamedSharding(mesh, P())
        state = state.replace(batch_stats=jax.device_put(state.batch_stats, repl),
                              ema_params=jax.device_put(state.ema_params, repl),
                              ema_batch_stats=jax.device_put(state.ema_batch_stats, repl))
        jbs = jax.tree_util.tree_map(lambda v: jax.device_put(v, NamedSharding(mesh, P("data"))),
                                     jb)
        tp_runs[name] = record(*step(state, jbs, lr))
        tp_runs[name]["sharded"] = sum("model" in s.spec for s in specs)
    return {"single": single, "tp": tp_runs, "port": {k: r.join() for k, r in ranks.items()}}


def _max_diff(got: dict, want: dict) -> float:
    """Largest difference over got's leaves (want may hold more: a JAX
    state dict carries the parameters beside the statistics)."""
    assert got and set(got) <= set(want)
    return max(float((got[n] - want[n]).abs().max()) for n in got)


def _hold(got: dict, want: dict, what: str, trace_slack: float = 0.0) -> None:
    """Loss within 1e-4 relative; parameters, EMA and BatchNorm statistics
    within 5e-5; the momenta, which are gradients (the parameters' change is
    lr times them), within 5e-5 of their largest magnitude, plus
    `trace_slack`."""
    assert abs(got["comps"]["loss"] - want["loss"]) <= LOSS_REL * abs(want["loss"]), what
    for key in ("params", "ema_params", "batch_stats", "ema_batch_stats"):
        err = _max_diff(got[key], want[key])
        assert err < PARAM_TOL, (what, key, err)
    scale = max(float(t.abs().max()) for t in want["trace"].values())
    err = _max_diff(got["trace"], want["trace"])
    assert err < PARAM_TOL * scale + trace_slack, (what, "trace", err, scale, trace_slack)


@pytest.mark.parametrize("case", sorted(R.TP_TRAIN_CASES))
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_tp_step_matches_jax_single_device(runs, mesh, case):
    """Every rank's gathered state after one TP step is JAX's single-device
    step: loss, parameters, momenta, EMA, BatchNorm statistics."""
    want = runs["single"][JAX_SINGLE[case]]
    for rank, out in enumerate(runs["port"][mesh]):
        _hold(out[case], want, (mesh, case, rank))


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_tp_step_matches_jax_tp_step(runs, mesh):
    """JAX's step on shard_params_tp's state over as many virtual devices
    (at dp2xtp2 with the generic rule lowered on both sides), at the same
    bars; the momenta's bar adds JAX's TP step's own distance from its
    single-device step."""
    case = JAX_TP[mesh]
    want = runs["tp"][mesh]
    got = runs["port"][mesh][0][case]
    # JAX's TP momenta stand this far from its own single-device step's
    # (its partitioned sums); the port's are held to that reference above
    own = _max_diff(want["trace"], runs["single"][JAX_SINGLE[case]]["trace"])
    _hold(got, want, (mesh, case), trace_slack=own)
    # the same leaves are sharded on both sides
    assert len(got["sharded"]) == want["sharded"] > 0


def test_cases_exercise_what_they_name(runs):
    """The clip bites (the momenta move against the unclipped step's); the
    frozen backbone keeps its parameters and zero momenta; the lowered
    generic rule shards convolutions beside the TEB projections."""
    out = runs["port"]["dp1xtp2"][0]
    clip, default = out["clip"]["trace"], out["default"]["trace"]
    assert _max_diff(clip, default) > 100 * PARAM_TOL
    assert _max_diff(runs["single"]["clip"]["trace"], runs["single"]["default"]["trace"]) > 0
    frozen = out["freeze"]
    for name, t in frozen["trace"].items():
        if name.startswith("backbone."):
            assert float(t.abs().max()) == 0.0, name
    teb = [n for n in out["default"]["sharded"] if ".teb." in n]
    assert out["default"]["sharded"] == teb and len(teb) == 24  # 4 TEBs x 6 leaves
    convs = [n for n in out["generic"]["sharded"] if n.endswith("conv.weight")]
    assert len(convs) > 10 and any(n.startswith("head.") and ".out." in n
                                   for n in out["generic"]["sharded"])


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_replicated_leaves_equal_across_model_group(runs, mesh):
    """Replicated parameters, their gradients, momenta, EMA and BatchNorm
    statistics: the same bits on every rank of a model group; and every
    rank of the mesh returns the same gathered state."""
    ranks = runs["port"][mesh]
    for rank, out in enumerate(ranks):
        assert out["coords"] == {"data": rank // MESHES[mesh][0], "model": rank % MESHES[mesh][0]}
        for case in R.TP_TRAIN_CASES:
            assert out[case]["replicated_mismatches"] == 0, (mesh, case, rank)
            if rank:
                for key in ("params", "trace", "ema_params", "batch_stats"):
                    assert _max_diff(out[case][key], ranks[0][case][key]) == 0.0, (key, case)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_tp_eval_step_and_fit_refusal(runs, mesh):
    """make_eval_step on the TP state (the sharded layers' serving forms)
    gives the gathered state's one-device loss; Trainer.fit refuses a model
    axis and names make_train_step."""
    for out in runs["port"][mesh]:
        ev, whole = out["default"]["eval"], out["default"]["eval_whole"]
        assert ev["num_fg"] == whole["num_fg"] > 0
        for key in ("loss", "loss_iou", "loss_cls", "loss_dfl"):
            assert abs(ev[key] - whole[key]) <= LOSS_REL * abs(whole[key]), key
        assert "make_train_step" in out["fit_refused"]


def test_train_state_bytes_table():
    """tools/tp_memory.py's fp32 training state a rank (parameters,
    gradients, momentum, EMA; from shapes): phi='l' 133 GB and phi='x' 735
    GB on one device fall with tp; phi='n' (h1 of 849) cannot split; at tp 1
    it is four copies of the fp32 parameters and two of the statistics."""
    from transparent_object_detection_tpu_torch.tools import tp_memory

    rows = {r["phi"]: r for r in tp_memory.rows()}
    assert rows["n"]["tp2_train_bytes"] is None
    for phi in "smlx":
        b = [rows[phi][f"tp{tp}_train_bytes"] for tp in (1, 2, 4, 8)]
        assert b[0] > b[1] > b[2] > b[3] > 0, phi
        assert 4 * rows[phi]["fp32_bytes"] < b[0] < 4.01 * rows[phi]["fp32_bytes"], phi
    assert round(rows["l"]["tp1_train_bytes"] / 1e9) == 133
    assert round(rows["x"]["tp1_train_bytes"] / 1e9) == 735
