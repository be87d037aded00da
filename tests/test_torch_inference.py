"""Serving path of the PyTorch port against the JAX package, on the CPU:
batched NMS, letterbox / unletterbox, and the end-to-end Predictor.

Tolerances:
  * NMS keep sets: identical (same inputs, fp32 IoU).
  * letterbox: the port's bilinear antialiased resize against
    jax.image.resize("linear"), within 1e-5 in [0, 1] pixel units. Both use
    a triangle kernel widened by the downsampling factor, half-pixel
    centres; the largest difference measured over sources 40x30 to
    1920x1080 and targets 64 and 640 was 7.2e-6 (300x200 -> 640x640).
  * Predictor: equal detection counts and classes, scores within 1e-4, boxes
    within 1e-2 pixels (fp32 model, the same letterboxed input up to the
    resize tolerance above).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import random_variables, to_jax
from transparent_object_detection_tpu import config as jconfig
from transparent_object_detection_tpu import inference as jinference
from transparent_object_detection_tpu.models.detector import FocusModel as JaxFocusModel
from transparent_object_detection_tpu.ops import nms as jnms
from transparent_object_detection_tpu.ops import preprocess as jpre
from transparent_object_detection_tpu_torch import config as tconfig
from transparent_object_detection_tpu_torch.inference import Predictor
from transparent_object_detection_tpu_torch.models.detector import FocusModel
from transparent_object_detection_tpu_torch.ops import nms as tnms
from transparent_object_detection_tpu_torch.ops import preprocess as tpre
from transparent_object_detection_tpu_torch.weights import load_jax_variables

torch.set_num_threads(1)


def _nms_inputs(seed: int, b: int = 2, a: int = 300, nc: int = 3):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 200, (b, a, 2))
    wh = rng.uniform(5, 60, (b, a, 2))
    boxes = np.concatenate([xy, xy + wh], axis=-1).astype(np.float32)
    # scores on a coarse grid: many exact ties, across and within classes
    scores = (rng.integers(0, 20, (b, a, nc)) / 20.0).astype(np.float32)
    return boxes, scores


def _nms_chain_inputs(seed: int, b: int = 2, chains: int = 40, length: int = 20,
                      loose: int = 500, nc: int = 3):
    """Every candidate above the confidence, K = 1,024 of 1,300: chains of
    40 x 40 boxes of one class, each 12 px right of the last (IoU 0.54 with
    it, 0.25 with the one before) at falling scores, so the greedy loop keeps
    every other box, beside loose boxes; scores on a grid of 1/80, so there
    are ties within and across chains."""
    rng = np.random.default_rng(seed)
    start = rng.uniform(0, 500, (b, chains, 1, 2))
    steps = np.arange(length)[None, None, :, None] * np.array([12.0, 0.0])
    xy = np.concatenate([(start + steps).reshape(b, -1, 2),
                         rng.uniform(0, 600, (b, loose, 2))], axis=1)
    wh = np.concatenate([np.full((b, chains * length, 2), 40.0),
                         rng.uniform(5, 60, (b, loose, 2))], axis=1)
    boxes = np.concatenate([xy, xy + wh], axis=-1).astype(np.float32)
    top = rng.integers(40, 81, (b, chains, 1))
    chain_scores = np.maximum(top - np.arange(length)[None, None, :], 28).reshape(b, -1)
    best = np.concatenate([chain_scores, rng.integers(28, 81, (b, loose))], axis=1) / 80.0
    cls = np.concatenate([np.repeat(rng.integers(0, nc, (b, chains)), length, axis=1),
                          rng.integers(0, nc, (b, loose))], axis=1)
    scores = np.where(np.arange(nc) == cls[..., None], best[..., None], 0.5 * best[..., None])
    return boxes, scores.astype(np.float32)


NMS_CASES = {"mixed": (lambda: _nms_inputs(0), 128, 50),
             "k1024_all_valid_chains": (lambda: _nms_chain_inputs(7), 1024, 1024)}


@pytest.mark.parametrize("class_agnostic,mode,case", [
    pytest.param(agnostic, mode, case, id="-".join([str(agnostic), mode]
                                                   + ([case] if case != "mixed" else [])))
    for case in NMS_CASES for agnostic in (False, True) for mode in ("exact", "fast")])
def test_batched_nms_keep_sets_match(mode, class_agnostic, case):
    make, topk, max_det = NMS_CASES[case]
    boxes, scores = make()
    kw = dict(conf_thres=0.3, iou_thres=0.4, max_detections=max_det, pre_nms_topk=topk,
              mode=mode, class_agnostic=class_agnostic)
    ref = jnms.batched_nms(jnp.asarray(boxes), jnp.asarray(scores), **kw)
    out = tnms.batched_nms(torch.from_numpy(boxes), torch.from_numpy(scores), **kw)
    for key in ("boxes", "scores", "classes", "valid", "num_detections"):
        np.testing.assert_array_equal(out[key].numpy(), np.asarray(ref[key]), err_msg=key)
    assert int(out["num_detections"].min()) > 0


def test_batched_nms_all_below_threshold():
    boxes, scores = _nms_inputs(1)
    out = tnms.batched_nms(torch.from_numpy(boxes), torch.from_numpy(scores), conf_thres=2.0)
    assert int(out["num_detections"].sum()) == 0
    assert bool((out["classes"] == -1).all())


@pytest.mark.parametrize("src,dst", [((96, 128), 64), ((100, 75), 64), ((40, 30), 64),
                                     ((300, 200), 640)])
def test_letterbox_matches_jax(src, dst):
    h, w = src
    imgs = np.random.default_rng(2).uniform(0, 1, (2, h, w, 3)).astype(np.float32)
    ref = np.asarray(jpre.letterbox_batch(jnp.asarray(imgs), (dst, dst)))
    out = tpre.letterbox_batch(torch.from_numpy(imgs), (dst, dst)).numpy()
    assert out.shape == ref.shape == (2, dst, dst, 3)
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("letterbox", [True, False])
def test_unletterbox_matches_jax(letterbox):
    rng = np.random.default_rng(3)
    boxes = rng.uniform(-10, 80, (3, 7, 4)).astype(np.float32)
    shapes = np.array([[96, 128], [100, 75], [64, 64]], np.float32)
    ref = jpre.unletterbox_boxes(jnp.asarray(boxes), (64, 64), jnp.asarray(shapes), letterbox)
    out = tpre.unletterbox_boxes(torch.from_numpy(boxes), (64, 64), torch.from_numpy(shapes),
                                 letterbox)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-6)


@pytest.fixture(scope="module")
def predictors():
    kw = dict(num_classes=2, base_channels=8, base_depth=1, deep_mul=0.5)
    jmodel = JaxFocusModel(**kw, dtype=jnp.float32)
    variables = random_variables(jmodel, jnp.zeros((1, 64, 64, 3), jnp.float32), train=True)
    pkw = dict(confidence=0.3, nms_iou=0.5, max_detections=20)
    jpred = jinference.Predictor(
        jmodel, to_jax(variables),
        jconfig.ModelConfig(num_classes=2, input_shape=(64, 64), compute_dtype="float32"),
        jconfig.PredictConfig(**pkw),
    )
    tmodel = load_jax_variables(FocusModel(**kw, dtype=torch.float32), variables)
    tpred = Predictor(tmodel, tconfig.ModelConfig(num_classes=2, input_shape=(64, 64),
                                                  compute_dtype="float32"),
                      tconfig.PredictConfig(**pkw), device="cpu")
    return jpred, tpred


def test_predictor_detect_raw_batch_matches_jax(predictors):
    jpred, tpred = predictors
    raw = np.random.default_rng(4).integers(0, 256, (2, 48, 80, 3), dtype=np.uint8)
    shapes = np.array([[48, 80], [48, 80]], np.float32)
    ref = jax.device_get(jpred.detect_raw_batch(jnp.asarray(raw), jnp.asarray(shapes)))
    out = tpred.detect_raw_batch(raw, shapes)
    n = out["num_detections"].numpy()
    np.testing.assert_array_equal(n, np.asarray(ref["num_detections"]))
    assert n.min() > 0
    np.testing.assert_array_equal(out["classes"].numpy(), np.asarray(ref["classes"]))
    np.testing.assert_allclose(out["scores"].numpy(), np.asarray(ref["scores"]), atol=1e-4)
    np.testing.assert_allclose(out["boxes"].numpy(), np.asarray(ref["boxes"]), atol=1e-2)
    host = Predictor.to_host_detections(out)
    assert [len(rows) for rows in host] == n.tolist()
    assert host[0][0]["class"] == int(out["classes"][0, 0])


def test_class_activation_map_matches_jax(predictors):
    jpred, tpred = predictors
    imgs = np.random.default_rng(6).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    ref = np.asarray(jpred.class_activation_map(jnp.asarray(imgs)))
    out = tpred.class_activation_map(imgs).numpy()
    assert out.shape == ref.shape == (2, 8, 8)
    np.testing.assert_allclose(out, ref, atol=1e-5)


def test_predict_image_matches_jax(predictors):
    from PIL import Image

    jpred, tpred = predictors
    arr = np.random.default_rng(5).integers(0, 256, (40, 70, 3), dtype=np.uint8)
    image = Image.fromarray(arr)
    ref, out = jpred.predict_image(image), tpred.predict_image(image)
    assert len(out) == len(ref) > 0
    for o, r in zip(out, ref):
        assert o["class"] == r["class"]
        assert o["score"] == pytest.approx(r["score"], abs=1e-4)
        np.testing.assert_allclose(o["box"], r["box"], atol=1e-2)
