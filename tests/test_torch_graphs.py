"""The serving program cache (inference.py: one captured CUDA graph per
key, the counterpart of the JAX Predictor's `_jitted`), on the CPU.

The CPU has no CUDA graphs, so the capture step (`inference._capture_graph`)
is stubbed by `FakeGraph`: it runs the step once on the static input
buffers, as a capture traces it, and on each replay runs it again and
writes the static output in place, as a replay does; it holds the model
weakly, as a graph holds no Python object. Held here:
  * the Predictor's calls: the first of a key eager, the second captured
    and replayed, later ones replayed; results equal to eager `detect_step`
    and the other entries' eager steps, and not aliasing one another or the
    graph's buffers; CPU Predictors eager and uncached;
  * the key: two Predictors on one model and config share one entry; each
    key field on its own (entry, config, batch, raw size, input dtype, the
    kernel switch `set_attention_impl`, int8 variants, compute dtype, data
    shards, mode) gives a new entry;
  * the tensors a graph reads: a replaced tensor (`.data` swapped, as
    `.to()` does; `load_state_dict(assign=True)`) and an EvalCallback's
    variables swapped each give a new warm-up and a new capture, an in-place
    update does not (unless the model holds int8 weight caches);
  * the launch counters move only where a wrapper runs (eagerly, or while a
    capture traces it), never on a replay, which the entry counts; a failed
    capture raises and leaves no entry;
  * the fingerprint taken after the warm-up, so a model whose first call
    makes its int8 weight caches captures on its second call;
  * a batch whose graph would not fit runs as replays of one graph over
    equal parts of it, the int8 1x1 convs gated on the whole batch;
  * deleting the model frees its entries; FOCUS.get_fps times replays.
"""
from __future__ import annotations

import gc
import weakref

import numpy as np
import pytest
import torch
from torch import nn

from transparent_object_detection_tpu_torch import api as tapi
from transparent_object_detection_tpu_torch import inference
from transparent_object_detection_tpu_torch.config import Int8Variants, ModelConfig, PredictConfig
from transparent_object_detection_tpu_torch.eval.callbacks import _ModelOn
from transparent_object_detection_tpu_torch.models.blocks import ConvBNAct
from transparent_object_detection_tpu_torch.models.detector import (
    FocusModel,
    init_weights,
    set_attention_impl,
)
from transparent_object_detection_tpu_torch.ops import nms as tnms

from _torch_graph_stubs import FakeGraph

torch.set_num_threads(1)

KW = dict(num_classes=2, base_channels=8, base_depth=1, deep_mul=0.5, num_heads=2)
HW = (64, 64)
CFG = ModelConfig(num_classes=2, input_shape=HW, compute_dtype="float32")
PCFG = PredictConfig(confidence=0.3, max_detections=20)


@pytest.fixture
def captures(monkeypatch):
    """Stub the capture step; each capture counts one nms_exact launch, as
    the wrappers count while a capture traces them."""
    made = []

    def capture(step, model, inputs):
        tnms.nms_exact.launches += 1
        graph = FakeGraph(step, model, inputs)
        made.append(graph)
        return graph, graph.output, 0

    monkeypatch.setattr(inference, "_capture_graph", capture)
    tnms.reset_launch_counts()
    return made


def _model(seed: int = 0) -> FocusModel:
    model = init_weights(FocusModel(**KW, dtype=torch.float32), seed).eval()
    with torch.no_grad():  # candidates above the confidence in every image
        for i in range(3):
            getattr(model.head, f"cls{i}").out.bias.fill_(-0.5)
    return model


def _graphed(model, cfg=CFG, pcfg=PCFG) -> inference.Predictor:
    pred = inference.Predictor(model, cfg, pcfg, device="cpu")
    pred._graphs = True  # the CUDA path, on the stubbed capture
    return pred


def _raw(seed: int, b: int = 2, h: int = 48, w: int = 80):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8),
            np.tile(np.array([[h, w]], np.float32), (b, 1)))


def _eager(model, raw, shapes, pcfg=PCFG):
    with torch.inference_mode():
        return inference.raw_detect_step(model, torch.as_tensor(raw),
                                         torch.as_tensor(shapes), HW, pcfg)


def _same(a: dict, b: dict):
    for key in a:
        assert torch.equal(a[key], b[key]), key


def _entries(model):
    return inference.programs_of(model)


def test_calls_warm_up_capture_replay(captures):
    model = _model()
    pred = _graphed(model)
    outs = []
    for seed in range(4):
        raw, shapes = _raw(seed)
        outs.append(pred.detect_raw_batch(raw, shapes))
        _same(outs[-1], _eager(model, raw, shapes))
        assert len(captures) == (0 if seed == 0 else 1)
    (entry,) = _entries(model)
    assert entry["entry"] == "detect_raw_batch" and entry["captured"]
    assert entry["replays"] == 3 and entry["replayed_calls"] == 2
    assert int(outs[0]["num_detections"].min()) > 0
    # the other entries against their eager steps
    imgs = np.random.default_rng(9).uniform(0, 1, (2, *HW, 3)).astype(np.float32)
    for _ in range(3):
        heat = pred.class_activation_map(imgs)
        dets = pred.detect_letterboxed(imgs, np.full((2, 2), 64, np.float32))
    with torch.inference_mode():
        x = torch.from_numpy(imgs)
        assert torch.equal(heat, inference.cam_step(model, x, CFG.reg_max))
        _same(dets, inference.detect_step(model, x, torch.full((2, 2), 64.0), HW, PCFG))
    assert sorted(e["entry"] for e in _entries(model)) == [
        "class_activation_map", "detect_letterboxed", "detect_raw_batch"]


def test_results_do_not_alias(captures):
    model = _model()
    pred = _graphed(model)
    (raw1, shapes1), (raw2, shapes2) = _raw(1), _raw(2)
    pred.detect_raw_batch(raw1, shapes1)
    first = pred.detect_raw_batch(raw1, shapes1)  # the capture's call
    kept = {k: v.clone() for k, v in first.items()}
    second = pred.detect_raw_batch(raw2, shapes2)  # a replay on other images
    _same(first, kept)
    assert not torch.equal(first["scores"], second["scores"])
    static = captures[0].output
    for key in first:
        ptrs = {first[key].data_ptr(), second[key].data_ptr(), static[key].data_ptr()}
        assert len(ptrs) == 3, key


def test_cpu_predictor_is_eager():
    model = _model()
    pred = inference.Predictor(model, CFG, PCFG, device="cpu")
    assert not pred._graphs
    for _ in range(3):
        pred.detect_raw_batch(*_raw(0))
    assert _entries(model) == []


def test_two_predictors_share_one_entry(captures):
    model = _model()
    a, b = _graphed(model), _graphed(model)
    a.detect_raw_batch(*_raw(0))
    b.detect_raw_batch(*_raw(1))  # the second call of the key: it captures
    a.detect_raw_batch(*_raw(2))
    (entry,) = _entries(model)
    assert len(captures) == 1 and entry["replays"] == 2


class _Tiny(nn.Module):
    def __init__(self):
        super().__init__()
        self.lin = nn.Linear(3, 3)
        self.lin.attention_impl = None
        self.lin.int8_variants = Int8Variants()
        self.lin.data_shards = 1
        self.dtype = torch.float32

    def forward(self, x):
        return self.lin(x.float())


def _tiny_step(m, x):
    return m(x)


KEY_CHANGES = {
    "entry": lambda m, x, e, k: (m, x, "other", k),
    "config": lambda m, x, e, k: (m, x, e, (HW, PredictConfig(nms_mode="fast"))),
    "batch": lambda m, x, e, k: (m, torch.ones(4, 3), e, k),
    "raw_hw": lambda m, x, e, k: (m, torch.ones(2, 2, 3), e, k),
    "input_dtype": lambda m, x, e, k: (m, torch.ones(2, 3, dtype=torch.float64), e, k),
    "attention_impl": lambda m, x, e, k: (set_attention_impl(m, "plain"), x, e, k),
    "int8_variants": lambda m, x, e, k: (
        setattr(m.lin, "int8_variants", Int8Variants(attn_qout=True)) or m, x, e, k),
    "compute_dtype": lambda m, x, e, k: (setattr(m, "dtype", torch.bfloat16) or m, x, e, k),
    "data_shards": lambda m, x, e, k: (setattr(m.lin, "data_shards", 2) or m, x, e, k),
    "mode": lambda m, x, e, k: (m.train(), x, e, k),
}


@pytest.mark.parametrize("field", KEY_CHANGES)
def test_each_key_field_gives_a_new_entry(captures, field):
    model, x, entry, key = _Tiny().eval(), torch.ones(2, 3), "detect", (HW, PredictConfig())
    run = lambda m, t, e, k: inference.run_program(m, e, _tiny_step, (t,), k)
    for _ in range(2):
        run(model, x, entry, key)
    model, x2, entry2, key2 = KEY_CHANGES[field](model, x, entry, key)
    out = run(model, x2, entry2, key2)  # a new key: eager
    assert torch.equal(out, model(x2))
    entries = _entries(model)
    assert len(entries) == 2 and len(captures) == 1
    assert sum(e["captured"] for e in entries) == 1


def test_replaced_tensors_capture_anew(captures):
    model = _model()
    pred = _graphed(model)
    raw, shapes = _raw(3)
    for _ in range(2):
        pred.detect_raw_batch(raw, shapes)
    assert len(captures) == 1
    p = next(model.parameters())
    with torch.no_grad():
        p.data = p.data.clone()  # what .to() does to a parameter
    for n in (1, 2):  # a warm-up, then a capture on the new tensor
        _same(pred.detect_raw_batch(raw, shapes), _eager(model, raw, shapes))
        assert len(captures) == n
    model.load_state_dict({k: v.clone() for k, v in model.state_dict().items()}, assign=True)
    for n in (2, 3):
        _same(pred.detect_raw_batch(raw, shapes), _eager(model, raw, shapes))
        assert len(captures) == n
    assert len(_entries(model)) == 1


def test_in_place_update_replays(captures):
    model = _model()
    pred = _graphed(model)
    raw, shapes = _raw(4)
    for _ in range(2):
        pred.detect_raw_batch(raw, shapes)
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(1.01)  # an optimizer or EMA step, FOCUS.fuse's load_state_dict
    _same(pred.detect_raw_batch(raw, shapes), _eager(model, raw, shapes))
    assert len(captures) == 1 and _entries(model)[0]["replays"] == 2


def test_in_place_update_with_int8_caches_warms_up_again(captures):
    model = _Tiny()
    model.lin._int8_cache = ("int8 weights made from lin's tensors",)
    run = lambda: inference.run_program(model, "detect", _tiny_step, (torch.ones(2, 3),), ())
    for _ in range(2):
        run()
    with torch.no_grad():
        model.lin.weight.mul_(2.0)
    run()
    assert len(captures) == 1 and not _entries(model)[0]["captured"]
    run()
    assert len(captures) == 2


class _Cached(_Tiny):
    """_Tiny whose forward makes an int8 weight cache on its first call, as
    blocks._cached does."""

    def __init__(self):
        super().__init__()
        self.lin._int8_cache = None

    def forward(self, x):
        if self.lin._int8_cache is None:
            self.lin._int8_cache = ("int8 weights", self.lin.weight.detach().clone())
        return super().forward(x)


def test_int8_caches_made_on_the_first_call_capture_on_the_second(captures):
    model = _Cached()
    run = lambda: inference.run_program(model, "detect", _tiny_step, (torch.ones(2, 3),), ())
    run()
    assert model.lin._int8_cache is not None and len(captures) == 0
    run()
    assert len(captures) == 1 and _entries(model)[0]["captured"]
    run()
    assert len(captures) == 1 and _entries(model)[0]["replays"] == 2


@pytest.mark.parametrize("batch, peak, free, parts", [
    (32, 100, 1000, 1), (32, 100, 160, 1), (32, 100, 159, 2), (32, 100, 80, 2),
    (32, 100, 79, 4), (6, 100, 60, 3), (6, 100, 1, 6), (1, 100, 1, 1)])
def test_parts_of_a_batch(batch, peak, free, parts):
    assert inference.GRAPH_POOL_OVER_EAGER == 1.6
    assert inference._parts(batch, peak, free) == parts


def test_batch_over_the_memory_runs_in_parts(captures, monkeypatch):
    model = init_weights(FocusModel(**KW, dtype=torch.float32, int8_1x1=True), 0).eval()
    with torch.no_grad():
        for i in range(3):
            getattr(model.head, f"cls{i}").out.bias.fill_(-0.5)
    convs = [m for m in model.modules() if isinstance(m, ConvBNAct) and m.int8_1x1]
    assert convs
    shards = []
    real_capture = inference._capture_graph

    def capture(step, m, inputs):  # the gate the capture traces, and the shape
        shards.append(({c.data_shards for c in convs}, inputs[0].shape[0]))
        return real_capture(step, m, inputs)

    warm_up = inference._warm_up
    monkeypatch.setattr(inference, "_capture_graph", capture)
    monkeypatch.setattr(inference, "_warm_up", lambda *a: (warm_up(*a)[0], 1000))
    monkeypatch.setattr(inference, "_free_bytes", lambda device: 800)  # 1.6 x 1000 / 2
    pred = _graphed(model)
    for seed in range(4):
        raw, shapes = _raw(seed, b=4)
        _same(pred.detect_raw_batch(raw, shapes), _eager(model, raw, shapes))
    assert shards == [({2}, 2)]
    assert {c.data_shards for c in convs} == {1}
    (entry,) = _entries(model)
    assert entry["parts"] == 2 and entry["replays"] == 2 * 3


def test_eval_callback_variables_swap_captures_anew(captures):
    model = _model()
    wrap = _ModelOn(model)
    pred = _graphed(wrap)
    imgs = np.random.default_rng(5).uniform(0, 1, (2, *HW, 3)).astype(np.float32)
    shapes = np.full((2, 2), 64, np.float32)
    for epoch in range(2):  # the callback's new variables each epoch
        wrap.variables = {k: v.clone() * (1 + 0.01 * epoch) if v.is_floating_point() else v
                          for k, v in model.state_dict().items()}
        for _ in range(3):
            got = pred.detect_letterboxed(imgs, shapes)
        assert len(captures) == epoch + 1
        with torch.inference_mode():
            ref = inference.detect_step(wrap, torch.from_numpy(imgs), torch.from_numpy(shapes),
                                        HW, PCFG)
        _same(got, ref)
    (entry,) = _entries(wrap)
    # each epoch: the capture's call and the one after it, the key's counts
    # going on across its captures
    assert entry["replays"] == 4 and entry["replayed_calls"] == 2


def test_set_attention_impl_gives_its_own_entry(captures):
    model = _model()
    pred = _graphed(model)
    raw, shapes = _raw(6)
    for impl in (None, "plain", None, "plain", None):
        set_attention_impl(model, impl)
        pred.detect_raw_batch(raw, shapes)
    assert len(captures) == 2
    assert sorted(e["replays"] for e in _entries(model)) == [1, 2]


def test_replays_leave_launch_counts_alone(captures):
    model = _model()
    pred = _graphed(model)
    raw, shapes = _raw(7)
    pred.detect_raw_batch(raw, shapes)  # eager on the CPU: no kernel launched
    assert tnms.nms_exact.launches == 0
    pred.detect_raw_batch(raw, shapes)  # the wrapper counted its launch into the graph
    assert tnms.nms_exact.launches == 1
    for n in (2, 3, 4):
        pred.detect_raw_batch(raw, shapes)
        assert tnms.nms_exact.launches == 1
        assert _entries(model)[0]["replays"] == n


def test_failed_capture_raises(monkeypatch):
    def broken(step, model, inputs):
        tnms.nms_exact.launches += 1
        raise RuntimeError("operation not permitted when stream is capturing")

    monkeypatch.setattr(inference, "_capture_graph", broken)
    tnms.reset_launch_counts()
    model = _model()
    pred = _graphed(model)
    raw, shapes = _raw(8)
    pred.detect_raw_batch(raw, shapes)
    with pytest.raises(RuntimeError, match="CUDA graph capture of Predictor.detect_raw_batch"):
        pred.detect_raw_batch(raw, shapes)
    assert tnms.nms_exact.launches == 1 and _entries(model) == []


def test_pool_kept_while_a_graph_lives(captures, monkeypatch):
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", object)
    model = _model()
    pred = _graphed(model)
    served = inference._SERVED.get(model) or inference._traced(model)[0]
    first = inference._pool(served)  # no graph yet: a new pool
    assert inference._pool(served) is not first
    raw, shapes = _raw(0)
    for _ in range(2):
        pred.detect_raw_batch(raw, shapes)  # a graph in the cache
    pool = inference._pool(served)
    assert inference._pool(served) is pool  # shared while the graph lives
    p = next(model.parameters())
    with torch.no_grad():
        p.data = p.data.clone()
    pred.detect_raw_batch(raw, shapes)  # the graph dropped for a warm-up
    assert inference._pool(served) is not pool


def test_deleting_the_model_frees_its_entries(captures):
    model = _model()
    pred = _graphed(model)
    for _ in range(3):
        pred.detect_raw_batch(*_raw(0))
    gone = weakref.ref(model)
    assert model in inference._SERVED
    before = len(inference._SERVED)
    del model, pred
    gc.collect()
    assert gone() is None
    assert len(inference._SERVED) == before - 1


def test_get_fps_times_replays(captures):
    from PIL import Image

    f = tapi.FOCUS.__new__(tapi.FOCUS)
    f.device, f.class_names, f.num_classes = torch.device("cpu"), ["a", "b"], 2
    f.model_cfg, f.predict_cfg, f.seed = CFG, PCFG, 0
    f.model = _model()
    f._predictor = None
    f.predictor._graphs = True
    assert f.get_fps(Image.new("RGB", (80, 48)), test_interval=3) > 0
    (entry,) = _entries(f.model)
    # the second warm-up captured and replayed; the timed loop replayed only
    assert entry["captured"] and entry["replays"] == 1 + 3
