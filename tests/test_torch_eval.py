"""The port's evaluation against the JAX package's on the CPU: the VOC and
COCO evaluators on random detection sets (equal results: the same numpy
code), the Cartucho directories and results.txt (the same bytes),
`EvalCallback.evaluate` on the same validation lines (the tiny fp32 model of
the other port tests, JAX variables bridged by weights.load_jax_variables:
detections within 2e-4 relative, the COCO and VOC stats within 1e-6), and
LossHistory's text logs (the same bytes)."""
from __future__ import annotations

import dataclasses
import importlib
import os

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import random_variables, to_jax
from transparent_object_detection_tpu import config as jcfg
from transparent_object_detection_tpu.eval import callbacks as jcb
from transparent_object_detection_tpu.models.detector import FocusModel as JFocusModel
from transparent_object_detection_tpu_torch import config as tcfg
from transparent_object_detection_tpu_torch import eval as teval
from transparent_object_detection_tpu_torch.eval import callbacks as tcb
from transparent_object_detection_tpu_torch.models.detector import FocusModel
from transparent_object_detection_tpu_torch.weights import load_jax_variables, state_dict_from_jax

# the modules, not the functions of the same names that the packages export
jcoco = importlib.import_module("transparent_object_detection_tpu.eval.coco_map")
jvoc = importlib.import_module("transparent_object_detection_tpu.eval.voc_map")
tcoco = importlib.import_module("transparent_object_detection_tpu_torch.eval.coco_map")
tvoc = importlib.import_module("transparent_object_detection_tpu_torch.eval.voc_map")

torch.set_num_threads(1)
NAMES = ["glass", "bottle", "window"]


def scene(seed: int, n_images: int = 6, nc: int = 3):
    """Random ground truths (some images without any, small and large
    boxes, difficult flags) and detections: jittered copies, duplicates,
    false positives, scores on a 0.1 grid (ties), some images without
    detections."""
    rng = np.random.default_rng(seed)
    dets, gts, diffs = [], [], []
    for i in range(n_images):
        g_rows, d_rows = [], []
        for _ in range(0 if i == 1 else int(rng.integers(1, 6))):
            x1, y1 = rng.uniform(0, 300, 2)
            w, h = rng.uniform(8, 150, 2)
            c = int(rng.integers(0, nc))
            g_rows.append([x1, y1, x1 + w, y1 + h, c])
            if i != 2 and rng.random() < 0.8:
                for _ in range(1 + int(rng.random() < 0.3)):  # sometimes a duplicate
                    j = rng.uniform(-0.15, 0.15, 4) * [w, h, w, h]
                    d_rows.append([x1 + j[0], y1 + j[1], x1 + w + j[2], y1 + h + j[3],
                                   round(float(rng.uniform(0.1, 1.0)), 1), c])
        for _ in range(int(rng.integers(0, 3)) if i != 2 else 0):  # false positives
            a, b = rng.uniform(0, 400, 2)
            d_rows.append([a, b, a + rng.uniform(5, 80), b + rng.uniform(5, 80),
                           round(float(rng.uniform(0.1, 1.0)), 1), int(rng.integers(0, nc))])
        gts.append(np.asarray(g_rows, np.float64).reshape(-1, 5))
        dets.append(np.asarray(d_rows, np.float64).reshape(-1, 6))
        diffs.append(rng.random(len(g_rows)) < 0.2)
    return dets, gts, diffs


def same_class_results(a, b):
    assert a.keys() == b.keys()
    for c in a:
        for f in dataclasses.fields(a[c]):
            x, y = getattr(a[c], f.name), getattr(b[c], f.name)
            if isinstance(x, np.ndarray):
                np.testing.assert_array_equal(x, y, err_msg=f"class {c} {f.name}")
            else:
                assert x == y, (c, f.name, x, y)


@pytest.mark.parametrize("seed", range(8))
def test_evaluators_match_jax(seed):
    dets, gts, diffs = scene(seed)
    for difficult in (None, diffs):
        for thr in (0.5, 0.75):
            jm, jr = jvoc.voc_map(dets, gts, 3, thr, difficult=difficult)
            tm, tr = tvoc.voc_map(dets, gts, 3, thr, difficult=difficult)
            assert tm == jm
            same_class_results(tr, jr)
    assert tcoco.coco_eval(dets, gts, 3) == jcoco.coco_eval(dets, gts, 3)
    # the parts on their own: voc_ap and the miss rate on one class's curve
    res = tr[int(np.argmax([r.num_det for r in tr.values()]))]
    assert tvoc.voc_ap(res.recall.copy(), res.precision.copy()) == jvoc.voc_ap(
        res.recall.copy(), res.precision.copy())
    fp = np.cumsum(np.random.default_rng(seed).random(len(res.precision)) < 0.4)
    t, j = (mod.log_average_miss_rate(res.precision, fp, 6) for mod in (tvoc, jvoc))
    assert t[0] == j[0]
    np.testing.assert_array_equal(t[1], j[1])
    np.testing.assert_array_equal(t[2], j[2])


@pytest.mark.parametrize("case", ["no_detections", "no_ground_truth", "nothing"])
def test_evaluators_match_jax_on_empty_sets(case):
    dets, gts, _ = scene(11)
    if case in ("no_detections", "nothing"):
        dets = [np.zeros((0, 6)) for _ in dets]
    if case in ("no_ground_truth", "nothing"):
        gts = [np.zeros((0, 5)) for _ in gts]
    assert tcoco.coco_eval(dets, gts, 3) == jcoco.coco_eval(dets, gts, 3)
    jm, jr = jvoc.voc_map(dets, gts, 3)
    tm, tr = tvoc.voc_map(dets, gts, 3)
    assert tm == jm
    same_class_results(tr, jr)
    empty = (np.zeros(0), np.zeros(0), 4)
    assert tvoc.log_average_miss_rate(*empty)[0] == jvoc.log_average_miss_rate(*empty)[0]


def test_ground_truth_as_detections_scores_one():
    dets, gts, _ = scene(3)
    perfect = [np.concatenate([g[:, :4], np.ones((len(g), 1)), g[:, 4:5]], 1) for g in gts]
    stats = tcoco.coco_eval(perfect, gts, 3)
    assert stats["AP"] == stats["AP50"] == pytest.approx(1.0)
    assert tvoc.voc_map(perfect, gts, 3)[0] == pytest.approx(1.0)


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


def test_cartucho_dirs_and_results_match_jax(tmp_path):
    dets, gts, diffs = scene(5)
    jc = jcb.EvalCallback(jcfg.ModelConfig(num_classes=3), [], NAMES, str(tmp_path / "jlog"))
    tc = tcb.EvalCallback(tcfg.ModelConfig(num_classes=3), [], NAMES, str(tmp_path / "tlog"),
                          device="cpu")
    jc.write_cartucho_dirs(dets, gts, str(tmp_path / "j"))
    tc.write_cartucho_dirs(dets, gts, str(tmp_path / "t"))
    assert _files(tmp_path / "t") == _files(tmp_path / "j") != {}
    # difficult flags appended to the ground truths, then read back by both
    for i, flags in enumerate(diffs):
        p = tmp_path / "t" / "ground-truth" / f"{i:06d}.txt"
        rows = p.read_text().splitlines()
        p.write_text("".join(r + (" difficult" if f else "") + "\n" for r, f in zip(rows, flags)))
    args = (str(tmp_path / "t" / "ground-truth"), str(tmp_path / "t" / "detection-results"),
            NAMES)
    for a, b in zip(tvoc.read_cartucho_dirs(*args), jvoc.read_cartucho_dirs(*args)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    tm, tr = tvoc.get_map_from_dirs(*args)
    jm, jr = jvoc.get_map_from_dirs(*args)
    assert tm == jm
    same_class_results(tr, jr)
    tvoc.write_results(str(tmp_path / "tres"), tm, tr, NAMES)
    jvoc.write_results(str(tmp_path / "jres"), jm, jr, NAMES)
    t, j = _files(tmp_path / "tres"), _files(tmp_path / "jres")
    assert t.keys() == j.keys() and t["results.txt"] == j["results.txt"]


def test_loss_history_logs_match_jax(tmp_path):
    jh, th = jcb.LossHistory(str(tmp_path / "j")), tcb.LossHistory(str(tmp_path / "t"))
    for epoch, (loss, val) in enumerate([(3.25, 4.5), (2.125, 3.0625), (1.1, 2.7)]):
        jh.on_epoch_end(epoch + 1, {"loss": loss, "val_loss": val})
        th.on_epoch_end(epoch + 1, {"loss": loss, "val_loss": val})
    jh.close()
    th.close()
    t, j = _files(tmp_path / "t"), _files(tmp_path / "j")
    assert t.keys() == j.keys()
    for name in ("epoch_loss.txt", "epoch_val_loss.txt"):
        assert t[name] == j[name]
    assert th.losses == jh.losses and th.val_losses == jh.val_losses


# ---------------------------------------------------------------- EvalCallback
@pytest.fixture(scope="module")
def val_lines(tmp_path_factory):
    root = tmp_path_factory.mktemp("evalds")
    rng = np.random.default_rng(1)
    out = []
    for i in range(5):
        h, w = int(rng.integers(41, 121)), int(rng.integers(41, 121))
        img = np.clip(rng.normal(120, 50, (h, w, 3)), 0, 255).astype(np.uint8)
        x1, y1 = int(rng.integers(0, w // 2)), int(rng.integers(0, h // 2))
        x2, y2 = x1 + int(rng.integers(10, w - x1)), y1 + int(rng.integers(10, h - y1))
        img[y1:y2, x1:x2] = (240, 30, 30)
        path = str(root / f"v{i}.{'png' if i % 2 else 'jpg'}")
        cv2.imwrite(path, img[..., ::-1])
        out.append(f"{path} {x1},{y1},{x2},{y2},{i % 2}")
    return out


KW = dict(num_classes=2, base_channels=8, base_depth=1, deep_mul=0.5)
CB_KW = dict(confidence=0.3, nms_iou=0.5, max_boxes=20)


@pytest.fixture(scope="module")
def evaluations(val_lines, tmp_path_factory):
    """JAX's and the port's evaluate on the same lines and variables; the
    port's model holds other weights (its own variables must not be the
    ones evaluated) and is in training mode."""
    jmodel = JFocusModel(**KW, dtype=jnp.float32)
    example = jnp.zeros((1, 64, 64, 3), jnp.float32)
    variables = random_variables(jmodel, example, seed=0, train=True)
    other = random_variables(jmodel, example, seed=1, train=True)
    mc = dict(num_classes=2, input_shape=(64, 64), compute_dtype="float32")
    root = tmp_path_factory.mktemp("evallogs")
    jc = jcb.EvalCallback(jcfg.ModelConfig(**mc), val_lines, NAMES[:2], str(root / "j"),
                          batch_size=2, **CB_KW)
    jstats = jc.evaluate(jmodel, to_jax(variables))
    tmodel = load_jax_variables(FocusModel(**KW, dtype=torch.float32), other).train()
    before = {k: v.clone() for k, v in tmodel.state_dict().items()}
    sd = state_dict_from_jax(variables, tmodel)
    names = dict(tmodel.named_parameters())
    tvars = {"params": {k: v for k, v in sd.items() if k in names},
             "batch_stats": {k: v for k, v in sd.items() if k not in names}}
    tc = tcb.EvalCallback(tcfg.ModelConfig(**mc), val_lines, NAMES[:2], str(root / "t"),
                          batch_size=2, device="cpu", **CB_KW)
    tstats = tc.evaluate(tmodel, tvars)
    return dict(jc=jc, jstats=jstats, tc=tc, tstats=tstats, tmodel=tmodel, before=before,
                tvars=tvars, mc=mc, root=root)


def test_eval_callback_detections_match_jax(evaluations):
    jc, tc = evaluations["jc"], evaluations["tc"]
    assert len(tc.last_dets) == len(jc.last_dets) == 5
    assert sum(len(d) for d in tc.last_dets) > 0
    scale = max(float(np.abs(d).max()) for d in jc.last_dets if len(d))
    for t, j in zip(tc.last_dets, jc.last_dets):
        assert t.shape == j.shape
        np.testing.assert_array_equal(t[:, 5], j[:, 5])
        np.testing.assert_allclose(t[:, :4], j[:, :4], rtol=0, atol=2e-4 * scale)
        np.testing.assert_allclose(t[:, 4], j[:, 4], rtol=0, atol=2e-4)
    for t, j in zip(tc.last_gts, jc.last_gts):
        np.testing.assert_array_equal(t, j)


def test_eval_callback_stats_match_jax(evaluations):
    jstats, tstats = evaluations["jstats"], evaluations["tstats"]
    assert tstats.keys() == jstats.keys()
    for key, value in jstats.items():
        np.testing.assert_allclose(tstats[key], value, rtol=0, atol=1e-6, err_msg=key)


def test_eval_callback_leaves_the_model_alone(evaluations, val_lines):
    """The evaluated weights are the variables given: the model's own are
    untouched, it stays in training mode, and a batch that divides the lines
    another way gives the same detections (the tail runs at its own size)."""
    model = evaluations["tmodel"]
    assert model.training
    for k, v in model.state_dict().items():
        assert torch.equal(v, evaluations["before"][k]), k
    tc = tcb.EvalCallback(tcfg.ModelConfig(**evaluations["mc"]), val_lines, NAMES[:2],
                          str(evaluations["root"] / "t5"), batch_size=5, device="cpu", **CB_KW)
    tc.evaluate(model, evaluations["tvars"])
    for a, b in zip(tc.last_dets, evaluations["tc"].last_dets):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)
    assert model.training


def test_eval_callback_epoch_hook(evaluations):
    """on_epoch_end evaluates the state's EMA variables every `period`
    epochs, logs map50 and coco_ap and appends to epoch_map.txt."""
    tvars = evaluations["tvars"]

    class State:  # the fields of TrainState the hook reads
        ema_params, ema_batch_stats = tvars["params"], tvars["batch_stats"]
        params = batch_stats = None

    class Trainer:
        model = evaluations["tmodel"]

    tc = evaluations["tc"]
    tc.period = 2
    logs = {}
    tc.on_epoch_end(1, logs, Trainer(), State())
    assert logs == {}
    tc.on_epoch_end(2, logs, Trainer(), State())
    stats = evaluations["tstats"]
    want = stats["AP50"] if stats["AP50"] >= 0 else stats["voc_map"]
    assert logs == {"map50": float(want), "coco_ap": float(stats["AP"])}
    text = open(os.path.join(tc.log_dir, "epoch_map.txt")).read().split()
    assert text == [str(want)] and tc.epochs == [2]


def test_eval_callback_needs_a_device_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        teval.EvalCallback(tcfg.ModelConfig(), [], NAMES, str(tmp_path))
