"""Mesh programs through the program cache (inference.run_program with a
mesh: the counterpart of JAX's jitted mesh programs, `_jitted` with the mesh
in its key and `jax.jit(step)` whatever the sharding of its inputs), on the
CPU.

On CUDA a mesh whose groups are NCCL's captures its programs; gloo's cannot
be captured, and the CPU has no CUDA graphs. So the ranks here are gloo
processes of one thread each (`parallel.launch.Ranks`, started while the
JAX side computes) with the capture stubbed (tests/_torch_graph_stubs.py:
FakeGraph for serving, FakeTrainGraph for the steps, installed in each
rank) and the cache forced on, as the CUDA path runs it. Held here, on
tests/test_parallel.py's tiny fp32 model (64 x 64, random_variables'
weights through the weight bridge):
  * the data-mesh Predictor on 2 ranks: its warm-up, capture and replays
    (two batches) equal the eager mesh Predictor bit for bit, and JAX's
    Predictor on the global batch within tests/test_torch_inference.py's
    Predictor bars (counts and classes equal, scores 1e-4, boxes 1e-2 px);
  * keys: the same model's Predictor with no mesh and on a mesh of the
    ranks in the other order each get an entry of their own;
  * the decision: `Mesh.capturable` false on a gloo mesh, true without a
    process group, and `_compiled` alike; ranks given different free bytes
    take the same parts, eager or capture decision (serving and training);
  * the data-parallel step and the (data 1, model 2) tensor-parallel step,
    with their eval steps: three graphed steps equal three eager ones bit
    for bit in every leaf, the eager steps read nothing from the host
    (HostReads), and three graphed data-parallel steps, each from the
    starting weights at another lr, equal JAX's jitted global step within
    tests/test_torch_parallel.py's bars (loss 1e-4 relative, parameters
    5e-5, BatchNorm statistics 1e-4).
"""
from __future__ import annotations

import dataclasses
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import random_variables, to_jax
from transparent_object_detection_tpu import config as jcfg
from transparent_object_detection_tpu import inference as jinference
from transparent_object_detection_tpu.models import FocusModel as JFocusModel
from transparent_object_detection_tpu.train import optimizer as jopt
from transparent_object_detection_tpu.train import trainer as jtr
from transparent_object_detection_tpu_torch.config import TrainConfig
from transparent_object_detection_tpu_torch.models.detector import FocusModel
from transparent_object_detection_tpu_torch.parallel.launch import Ranks
from transparent_object_detection_tpu_torch.parallel.mesh import make_mesh
from transparent_object_detection_tpu_torch.train import trainer as ttr
from transparent_object_detection_tpu_torch.weights import (
    load_jax_variables,
    params_from_jax,
    state_dict_from_jax,
)

import _torch_ranks as R

torch.set_num_threads(1)

TESTS = os.path.dirname(__file__)
RANK_TIMEOUT = 240.0
LOSS_REL, PARAM_TOL, STATS_TOL = 1e-4, 5e-5, 1e-4  # tests/test_torch_parallel.py
SCORE_TOL, BOX_TOL = 1e-4, 1e-2  # tests/test_torch_inference.py
# free bytes of rank 0 and rank 1 against a warm-up peak of 1,000 bytes, a
# global batch of 8 on a data axis of 2: alone, rank 0 would capture whole
# (1,600 bytes fit) and rank 1 would split ("parts": 4 parts of 2 rows fit
# 500; "eager": no part of a multiple of 2 rows fits 100)
FREE_BYTES = {"parts": (2000, 500), "eager": (2000, 100)}
WANT = {"parts": (4, False), "eager": (1, True)}
TRAIN_FREE_BYTES = (2000, 100)  # the train key: alone, rank 0 would capture


def _jax_tiny():
    return JFocusModel(num_classes=1, base_channels=8, base_depth=1, deep_mul=0.5, num_heads=2,
                       dtype=jnp.float32)


def _batch() -> dict:
    """tests/test_parallel.py's uniform batch: 8 images from uniform(i, i + 1),
    one box each, so each rank's own statistics are far from the global."""
    rng = np.random.default_rng(1)
    image = np.concatenate([rng.uniform(i, i + 1, size=(1, 64, 64, 3)) for i in range(8)])
    boxes = np.zeros((8, 4, 4), np.float32)
    boxes[:, 0] = [0.5, 0.5, 0.4, 0.4]
    return {"image": image.astype(np.float32), "boxes": boxes,
            "labels": np.zeros((8, 4), np.int64)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mesh_graphs"))
    variables = random_variables(_jax_tiny(), jnp.zeros((1, 64, 64, 3), jnp.float32), train=True)
    port = load_jax_variables(FocusModel(**R.TINY_MODEL), variables)
    tc = TrainConfig(max_boxes=4, optimizer_type="sgd", ema=True)
    batch = _batch()
    rng = np.random.default_rng(3)
    images = [rng.uniform(size=(8, 64, 64, 3)).astype(np.float32) for _ in range(2)]
    shapes = np.full((8, 2), 64.0, np.float32)
    path = os.path.join(root, "inputs.pt")
    torch.save({"state": port.state_dict(), "train_cfg": dataclasses.asdict(tc),
                "batch": {k: torch.from_numpy(v) for k, v in batch.items()},
                "images": torch.from_numpy(images[0]), "images2": torch.from_numpy(images[1]),
                "shapes": torch.from_numpy(shapes), "free_bytes": FREE_BYTES,
                "train_free_bytes": TRAIN_FREE_BYTES}, path)
    ranks = Ranks("_torch_ranks:mesh_graphs", 2, {"path": path}, timeout=RANK_TIMEOUT,
                  device="cpu", threads=1, paths=[TESTS])

    jmodel = _jax_tiny()
    jv = to_jax(variables)
    mc = jcfg.ModelConfig(num_classes=1, input_shape=(64, 64), compute_dtype="float32")
    pc = jcfg.PredictConfig(**dataclasses.asdict(R.TINY_PREDICT))
    jpred = jinference.Predictor(jmodel, jv, mc, pc)
    jax_dets = [jax.device_get(jpred.detect_letterboxed(jnp.asarray(x), jnp.asarray(shapes)))
                for x in images]
    jtc = jcfg.TrainConfig(**dataclasses.asdict(tc))
    tx = jopt.build_optimizer(jtc, to_jax(variables["params"]))
    step = jtr.make_train_step(jmodel, tx, jtr.loss_config_from(mc, jtc), jtc, donate=False)
    jb = {k: jnp.asarray(v.astype(np.int32) if k == "labels" else v) for k, v in batch.items()}
    jax_steps = []
    for lr in R.MESH_GRAPH_LRS:
        new, comps = step(jtr.create_train_state(jmodel, jv, tx), jb, jnp.asarray(lr, jnp.float32))
        jax_steps.append({"loss": float(comps["loss"]),
                          "params": params_from_jax(new.params, port),
                          "stats": state_dict_from_jax({"params": new.params,
                                                        "batch_stats": new.batch_stats}, port)})
    return {"port": ranks.join(), "jax_dets": jax_dets, "jax_steps": jax_steps}


def _same(a: dict, b: dict):
    assert a.keys() == b.keys()
    for key in a:
        assert a[key].dtype == b[key].dtype and torch.equal(a[key], b[key]), key


def test_capturable_decides_the_path(runs):
    """A gloo mesh cannot be captured (its transfers staged through the
    host), so a mesh step on it runs eagerly even on CUDA; a mesh without a
    process group (a world of one, every collective the identity) can."""
    cuda_image = SimpleNamespace(device=SimpleNamespace(type="cuda"))
    alone = make_mesh()
    assert not alone.distributed and alone.capturable
    assert ttr._compiled(None, alone, cuda_image) and ttr._compiled(None, None, cuda_image)
    assert not ttr._compiled(None, alone, SimpleNamespace(device=SimpleNamespace(type="cpu")))
    for out in runs["port"]:
        assert out["capturable"] is False and out["compiled"] is False
        assert out["eager_graphs_flag"] is False


def test_graphed_mesh_serving_equals_eager(runs):
    """The data-mesh Predictor's warm-up, capture and replay on one batch
    and a replay on another: the eager mesh Predictor's bits, the global
    result on both ranks."""
    for out in runs["port"]:
        serve = out["serve"]
        assert serve["captures"] == 1
        for got in serve["graphed"][:3]:
            _same(got, serve["eager"][0])
        _same(serve["graphed"][3], serve["eager"][1])
        assert tuple(serve["graphed"][0]["boxes"].shape[:1]) == (8,)
    _same(runs["port"][0]["serve"]["graphed"][3], runs["port"][1]["serve"]["graphed"][3])


@pytest.mark.parametrize("call", [0, 2, 3])
def test_graphed_mesh_serving_matches_jax(runs, call):
    """The warm-up (0), the replay after the capture (2) and the replay on
    other images (3) against JAX's Predictor on the global batch."""
    want = runs["jax_dets"][1 if call == 3 else 0]
    for out in runs["port"]:
        got = out["serve"]["graphed"][call]
        n = got["num_detections"].numpy()
        np.testing.assert_array_equal(n, np.asarray(want["num_detections"]))
        assert n.min() > 0
        np.testing.assert_array_equal(got["classes"].numpy(), np.asarray(want["classes"]))
        np.testing.assert_allclose(got["scores"].numpy(), np.asarray(want["scores"]),
                                   atol=SCORE_TOL)
        np.testing.assert_allclose(got["boxes"].numpy(), np.asarray(want["boxes"]), atol=BOX_TOL)


def test_each_mesh_its_own_key(runs):
    """One model served on the data mesh, with no mesh and on the ranks in
    the other order: three entries, each captured once and replayed, the
    mesh's layout in the key. The graphed no-mesh Predictor's results are
    its eager bits; the other order's and the eager mesh Predictor's are
    within tests/test_torch_parallel.py's bar of them (the rows go through
    other processes, and 8 rows at once round otherwise on the CPU)."""
    for out in runs["port"]:
        keys = out["keys"]
        assert keys["captures"] == 3
        entries = keys["entries"]
        assert len(entries) == 3 and all(e["captured"] for e in entries)
        # the data mesh's also served the second batch (test above)
        assert sorted(e["replays"] for e in entries) == [2, 2, 3]
        layouts = sorted(str(e["key"][1][-1]) for e in entries)
        assert sum("mesh" in k for k in layouts) == 2
        assert "((0, 1), (('data', 2),))" in " ".join(layouts)
        assert "((1, 0), (('data', 2),))" in " ".join(layouts)
        for got in keys["single"]:
            _same(got, keys["single_eager"])
        for got in [out["serve"]["eager"][0], *keys["reversed"]]:
            assert torch.equal(got["num_detections"], keys["single_eager"]["num_detections"])
            np.testing.assert_allclose(got["boxes"].numpy(),
                                       keys["single_eager"]["boxes"].numpy(), atol=1e-4)


@pytest.mark.parametrize("case", sorted(WANT))
def test_ranks_decide_alike(runs, case):
    """Each rank given other free bytes: the agreed (least) free memory and
    (largest) peak decide, so both ranks take the same number of parts, or
    both run the key eagerly; the result the same global bits on both."""
    a, b = (out["decisions"][case] for out in runs["port"])
    parts, eager = WANT[case]
    for d in (a, b):
        assert (d["parts"], d["eager"], d["captured"]) == (parts, eager, not eager)
        assert d["free_bytes"] == min(FREE_BYTES[case]) and d["peak_bytes"] == 1000
    _same(a["dets"], b["dets"])
    np.testing.assert_array_equal(a["dets"]["num_detections"].numpy(),
                                  runs["port"][0]["serve"]["eager"][0]["num_detections"].numpy())


def test_ranks_decide_alike_train_key(runs):
    """A train key over the memory on one rank only: both run it eagerly."""
    for out in runs["port"]:
        d = out["decisions"]["train"]
        assert d["eager"] and not d["captured"] and d["free_bytes"] == min(TRAIN_FREE_BYTES)
        assert d["predicted_bytes"] == int(1.6 * 1000)


@pytest.mark.parametrize("mesh", ["dp", "tp"])
def test_graphed_mesh_steps_equal_eager_bit_for_bit(runs, mesh):
    """Three graphed steps (warm-up, capture and replay, replay; the lr
    changed each step) against three eager ones from the same weights, in
    every leaf of this rank (its shards at tp 2); then three eval steps."""
    for out in runs["port"]:
        eager, graphed = out["steps"][mesh]["eager"], out["steps"][mesh]["graphed"]
        for got, want in zip(graphed["records"], eager["records"]):
            _same(got, want)
        for got, want in zip(graphed["evals"], eager["evals"]):
            _same(got, want)
        entries = {e["entry"]: e for e in graphed["entries"]}
        assert entries["trainer.train_step"]["captured"]
        assert entries["trainer.train_step"]["replays"] == 2
        assert entries["trainer.eval_step"]["replays"] == 2
        assert eager["entries"] == []
    assert runs["port"][0]["step_captures"] == 4


@pytest.mark.parametrize("what", ["dp", "dp eval", "tp", "tp eval"])
def test_mesh_steps_read_nothing_from_the_host(runs, what):
    for out in runs["port"]:
        assert out["host_reads"][what] == []


@pytest.mark.parametrize("i", range(len(R.MESH_GRAPH_LRS)))
def test_graphed_dp_step_matches_jax_global_step(runs, i):
    """The warm-up (0), the capture's replay (1) and a replay (2), each from
    the starting weights at its lr, against JAX's step on the global
    batch."""
    want = runs["jax_steps"][i]
    for out in runs["port"]:
        got = out["from_start"][i]
        assert abs(got["loss"] - want["loss"]) <= LOSS_REL * abs(want["loss"])
        assert max(float((got["params"][n] - want["params"][n]).abs().max())
                   for n in want["params"]) < PARAM_TOL
        names = list(got["stats"])
        assert len(names) > 20
        assert max(float((got["stats"][n] - want["stats"][n]).abs().max())
                   for n in names) < STATS_TOL
