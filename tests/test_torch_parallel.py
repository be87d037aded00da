"""The port's data parallelism (parallel/mesh.py, the data-parallel train
step, Predictor(mesh=make_mesh()), Trainer.fit(mesh=...)) against the JAX
package, on the CPU: the counterparts of tests/test_parallel.py, run on two
gloo processes of one thread each (`parallel.launch.Ranks`, started while
the JAX side computes).

  * The step on 2 ranks, each on 4 rows, against JAX's single-device step
    on the global batch of 8 (tests/test_parallel.py's tiny model, 64 x 64,
    fp32, SGD with EMA; random_variables' weights): loss within 1e-4
    relative, parameters within 5e-5, BatchNorm statistics within 1e-4, on
    its random batch and on a batch whose images are drawn from
    uniform(i, i + 1), where each rank's own statistics are far from the
    global ones; BatchNorm on local statistics (a planted fault) misses the
    bar there. The ranks' parameters, EMA, BatchNorm statistics and momenta
    equal bit for bit.
  * Two Predictors with different meshes in one process, called in turns,
    against the Predictor with no mesh; the indivisible batch's ValueError.
  * Trainer.fit with an EvalCallback of batch 5 under a data mesh of 2: the
    callback's Predictor adopts the mesh and pads, rank 0 alone writes the
    logs and checkpoints, the ranks end with the same parameters.
"""
from __future__ import annotations

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import random_variables, to_jax
from transparent_object_detection_tpu import config as jcfg
from transparent_object_detection_tpu.models import FocusModel as JFocusModel
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
RANK_TIMEOUT = 240.0
LR = 1e-3
LOSS_REL, PARAM_TOL, STATS_TOL = 1e-4, 5e-5, 1e-4
BATCHES = ("random", "uniform")


def _jax_tiny():
    return JFocusModel(num_classes=1, base_channels=8, base_depth=1, deep_mul=0.5, num_heads=2,
                       dtype=jnp.float32)


def _batch(kind: str) -> dict:
    """tests/test_parallel.py's batches: 8 images, one box each."""
    if kind == "random":
        image = np.random.default_rng(0).uniform(size=(8, 64, 64, 3))
    else:  # shard contents differ wildly: global statistics != per-rank ones
        rng = np.random.default_rng(1)
        image = np.concatenate([rng.uniform(i, i + 1, size=(1, 64, 64, 3)) for i in range(8)])
    boxes = np.zeros((8, 4, 4), np.float32)
    boxes[:, 0] = [0.5, 0.5, 0.4, 0.4]
    return {"image": image.astype(np.float32), "boxes": boxes,
            "labels": np.zeros((8, 4), np.int64)}


def _images(root: str) -> list:
    from PIL import Image

    rng = np.random.default_rng(0)
    lines = []
    for i in range(8):
        arr = rng.integers(0, 255, size=(80, 96, 3), dtype=np.uint8)
        arr[20:60, 30:70] = (255, 0, 0)
        path = os.path.join(root, f"t{i}.png")
        Image.fromarray(arr).save(path)
        lines.append(f"{path} 30,20,70,60,0")
    return lines


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("dp"))
    variables = random_variables(_jax_tiny(), jnp.zeros((1, 64, 64, 3), jnp.float32), train=True)
    port = load_jax_variables(FocusModel(**R.TINY_MODEL), variables)
    tc = TrainConfig(max_boxes=4, optimizer_type="sgd", ema=True)
    batches = {k: _batch(k) for k in BATCHES}
    path = os.path.join(root, "inputs.pt")
    rng = np.random.default_rng(2)
    torch.save({"state": port.state_dict(), "train_cfg": dataclasses.asdict(tc), "lr": LR,
                "batches": {k: {n: torch.from_numpy(v) for n, v in b.items()}
                            for k, b in batches.items()},
                "images": torch.from_numpy(rng.uniform(size=(8, 64, 64, 3)).astype(np.float32)),
                "shapes": torch.full((8, 2), 64.0)}, path)
    opts = dict(timeout=RANK_TIMEOUT, device="cpu", threads=1, paths=[TESTS])
    fit_root, tool_root = os.path.join(root, "fit"), os.path.join(root, "tool")
    os.makedirs(fit_root)
    os.makedirs(tool_root)
    lines_path = os.path.join(root, "lines.txt")
    with open(lines_path, "w") as fh:
        fh.write("\n".join(_images(root)))
    ranks = {"steps": Ranks("_torch_ranks:dp_steps", 2, {"path": path}, **opts),
             "predictors": Ranks("_torch_ranks:predictors", 2, {"path": path}, **opts),
             "fit": Ranks("_torch_ranks:fit_with_eval", 2,
                          {"root": fit_root, "lines": _images(root)}, **opts),
             "focus": Ranks("_torch_ranks:focus_serve_mesh", 2, {"root": root}, **opts),
             "tool": Ranks("_torch_ranks:train_tool", 2,
                             {"root": tool_root, "train": lines_path, "val": lines_path},
                             **opts)}

    jmodel = _jax_tiny()
    jtc = jcfg.TrainConfig(**dataclasses.asdict(tc))
    mc = jcfg.ModelConfig(num_classes=1, input_shape=(64, 64), compute_dtype="float32")
    tx = jopt.build_optimizer(jtc, to_jax(variables["params"]))
    step = jtr.make_train_step(jmodel, tx, jtr.loss_config_from(mc, jtc), jtc, donate=False)
    jax_out = {}
    for kind, b in batches.items():
        jb = {k: jnp.asarray(v.astype(np.int32) if k == "labels" else v) for k, v in b.items()}
        new, comps = step(jtr.create_train_state(jmodel, to_jax(variables), tx), jb,
                          jnp.asarray(LR, jnp.float32))
        jax_out[kind] = {
            "loss": float(comps["loss"]),
            "params": params_from_jax(new.params, port),
            "stats": state_dict_from_jax({"params": new.params,
                                          "batch_stats": new.batch_stats}, port),
        }
    return {"jax": jax_out, "port": {k: r.join() for k, r in ranks.items()}, "root": fit_root,
            "tool_root": tool_root}


def _max_diff(got: dict, want: dict, names) -> float:
    return max(float((got[n] - want[n]).abs().max()) for n in names)


@pytest.mark.parametrize("kind", BATCHES)
def test_dp_step_matches_jax_global_step(runs, kind):
    """tests/test_parallel.py:51-77: the step on 2 ranks' rows equals JAX's
    step on the global batch."""
    want = runs["jax"][kind]
    got = runs["port"]["steps"][0][kind, False]
    assert abs(got["comps"]["loss"] - want["loss"]) <= LOSS_REL * abs(want["loss"])
    assert _max_diff(got["params"], want["params"], want["params"]) < PARAM_TOL


@pytest.mark.parametrize("kind", BATCHES)
def test_batchnorm_stats_are_global(runs, kind):
    """tests/test_parallel.py:80-110: the BatchNorm statistics after the
    step equal the global batch's; on the uniform(i, i + 1) batch, local
    statistics (the planted fault) miss the bar."""
    want = runs["jax"][kind]["stats"]
    out = runs["port"]["steps"][0]
    names = list(out[kind, False]["batch_stats"])
    assert len(names) > 20
    assert _max_diff(out[kind, False]["batch_stats"], want, names) < STATS_TOL
    fault = _max_diff(out[kind, True]["batch_stats"], want, names)
    if kind == "uniform":
        assert fault > 100 * STATS_TOL, fault


@pytest.mark.parametrize("kind", BATCHES)
def test_dp_ranks_equal_bit_for_bit(runs, kind):
    """Parameters, EMA shadows, BatchNorm statistics (and their EMA), SGD
    momenta and the loss components: the same bits on both ranks."""
    a, b = (r[kind, False] for r in runs["port"]["steps"])
    assert a["comps"] == b["comps"]
    for key in ("params", "batch_stats", "ema_params", "ema_batch_stats", "trace"):
        assert a[key].keys() == b[key].keys()
        for name in a[key]:
            assert torch.equal(a[key][name], b[key][name]), (key, name)


def test_two_predictors_different_meshes_one_process(runs):
    """tests/test_parallel.py:138: a data mesh of 2 and a (1, 2) model mesh
    in one process, called in turns, each equal to the Predictor with no
    mesh, on both ranks."""
    for out in runs["port"]["predictors"]:
        ref = out["ref"]
        assert out["shards"] == (2, 1)
        for d in out["runs"]:
            np.testing.assert_array_equal(d["num_detections"].numpy(),
                                          ref["num_detections"].numpy())
            np.testing.assert_allclose(d["boxes"].numpy(), ref["boxes"].numpy(), atol=1e-4)


def test_mesh_predictor_rejects_indivisible_batch(runs):
    """tests/test_parallel.py:174: 3 images on a data axis of 2 raise
    ValueError; the (1, 2) mesh (one data rank) takes them."""
    for out in runs["port"]["predictors"]:
        assert out["refused"] is not None and "data_shards" in out["refused"]
        assert tuple(out["tp_three"].shape) == (3,)


def test_trainer_fit_with_evalcallback_under_mesh(runs):
    """tests/test_parallel.py:189-238, the tools/train.py --data-parallel
    path: one epoch at a global batch of 8 on 2 ranks with an EvalCallback
    of batch 5 (5 % 2 != 0)."""
    a, b = runs["port"]["fit"]
    for out in (a, b):
        assert len(out["history"]) == 1
        assert np.isfinite(out["history"][0]["loss"]) and "map50" in out["history"][0]
        assert out["data_shards"] == 2  # the callback's Predictor adopted the mesh
        assert len(out["dets"]) == 8  # the padded images' detections dropped
    assert a["history"][0]["loss"] == b["history"][0]["loss"]
    for name in a["params"]:
        assert torch.equal(a["params"][name], b["params"][name]), name
    logs = os.path.join(runs["root"], "logs")
    for name in ("epoch_loss.txt", "epoch_map.txt"):  # written once, by rank 0
        with open(os.path.join(logs, name)) as fh:
            assert len(fh.read().split()) == 1, name
    assert {"last_weights", "best_weights", "last_state"} <= set(os.listdir(logs))


def test_focus_serve_mesh(runs):
    """FOCUS.serve_mesh(): the data-parallel Predictor over both ranks, its
    detections those of FOCUS's own Predictor; tp=2 refused where a TEB
    width does not divide it (phi='n' h1: 849 channels)."""
    for out in runs["port"]["focus"]:
        assert out["data_shards"] == 2
        for key in ("num_detections", "boxes", "scores", "classes", "valid"):
            assert torch.equal(out["got"][key], out["ref"][key]), key
        assert out["refused"] is not None and "not divisible by tp=2" in out["refused"]


def test_train_tool_data_parallel(runs):
    """tools/train.py --data-parallel under two ranks: one epoch, the logs
    and checkpoints written once (rank 0)."""
    a, b = runs["port"]["tool"]
    assert a == b and {"last_weights", "last_state", "epoch_loss.txt"} <= set(a)
    assert sum(name.startswith("events.out") for name in a) <= 1  # one rank's TensorBoard log
    with open(os.path.join(runs["tool_root"], "logs", "epoch_loss.txt")) as fh:
        assert len(fh.read().split()) == 1
