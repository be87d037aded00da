"""The port's user surface against the JAX package's on the CPU: FOCUS
(api.py), load_config, the utilities, fuse, summary, evaluate, export, the
registered kernel operators and the drivers.

The tiny fp32 model of tests/test_api.py (base_channels 8, depth 1, 2
heads, 64x64), its JAX variables from `_torch_parity.random_variables`
bridged into the port by weights.load_jax_variables. Detections: the same
sets, boxes within 2e-4 of the largest box coordinate, scores within 2e-4;
heatmaps within 2e-4; the fused state_dict within 1e-6 relative of JAX's
fuse_conv_bn; evaluate within tests/test_torch_eval.py's bars (detections 2e-4, statistics
1e-6); weights and exported programs bit for bit. FLOPs: the port counts
2 per multiply-add of the products (`FlopCounterMode`), XLA's cost model
also counts elementwise work and decodes differently, so the whole forward
is held within 10%; each registered operator's formula equals the count of
its plain version exactly."""
from __future__ import annotations

# the standard library's profiler first: tests/test_yolo_import.py puts the
# JAX package's tools/ (which holds a profile.py) on sys.path when pytest
# collects it, and torch._dynamo, which torch.export and fake tensors import,
# imports cProfile, which imports `profile`
import cProfile  # noqa: F401
import dataclasses
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from _torch_parity import random_variables, rel_err, to_jax
from transparent_object_detection_tpu import api as japi
from transparent_object_detection_tpu import config as jcfg
from transparent_object_detection_tpu.models import FocusModel as JFocusModel
from transparent_object_detection_tpu.models.blocks import fuse_conv_bn as jfuse
from transparent_object_detection_tpu.models.detector import count_params as jcount
from transparent_object_detection_tpu.utils import common as jcommon
from transparent_object_detection_tpu_torch import api as tapi
from transparent_object_detection_tpu_torch import config as tcfg
from transparent_object_detection_tpu_torch.models.detector import FocusModel, count_params
from transparent_object_detection_tpu_torch.ops import attention as A
from transparent_object_detection_tpu_torch.ops import attention_int8 as A8
from transparent_object_detection_tpu_torch.ops import library
from transparent_object_detection_tpu_torch.ops import nms as NMS
from transparent_object_detection_tpu_torch.ops import quant_matmul as QM
from transparent_object_detection_tpu_torch.utils import common as tcommon
from transparent_object_detection_tpu_torch.utils import profiling
from transparent_object_detection_tpu_torch.weights import load_jax_variables, state_dict_from_jax

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(num_classes=1, base_channels=8, base_depth=1, deep_mul=0.5, num_heads=2)
HW = (64, 64)
# no candidate cut before or after NMS (84 anchors at 64x64): the sets
# compare whole
PCFG = dict(confidence=0.5, max_detections=100, pre_nms_topk=1024)
DET_TOL = 2e-4


def _jax_focus(variables, input_shape=HW):
    """JAX's FOCUS on the tiny model, built as tests/test_api.py builds it."""
    f = japi.FOCUS.__new__(japi.FOCUS)
    f.class_names, f.num_classes = ["Transparent"], 1
    f.model_cfg = jcfg.ModelConfig(num_classes=1, input_shape=input_shape,
                                   compute_dtype="float32")
    f.predict_cfg = jcfg.PredictConfig(**PCFG)
    f.seed = 11
    f.model = JFocusModel(**KW, dtype=jnp.float32)
    f.variables = to_jax(variables)
    f._predictor = None
    return f


def _port_focus(variables, input_shape=HW, **model_kw):
    """The port's FOCUS on the same model and variables, on the CPU."""
    f = tapi.FOCUS.__new__(tapi.FOCUS)
    f.device = torch.device("cpu")
    f.class_names, f.num_classes = ["Transparent"], 1
    f.model_cfg = tcfg.ModelConfig(num_classes=1, input_shape=input_shape,
                                   compute_dtype="float32", **model_kw)
    f.predict_cfg = tcfg.PredictConfig(**PCFG)
    f.seed = 11
    f.model = load_jax_variables(FocusModel(**KW, dtype=torch.float32, **model_kw),
                                 variables).eval()
    f._predictor = None
    return f


@pytest.fixture(scope="module")
def variables():
    return random_variables(JFocusModel(**KW, dtype=jnp.float32),
                            jnp.zeros((1, *HW, 3), jnp.float32), seed=0, train=True)


@pytest.fixture(scope="module")
def pair(variables):
    return _jax_focus(variables), _port_focus(variables)


@pytest.fixture(scope="module")
def image():
    rng = np.random.default_rng(7)
    arr = np.clip(rng.normal(120, 60, (80, 100, 3)), 0, 255).astype(np.uint8)
    arr[10:50, 20:70] = (230, 40, 40)
    return Image.fromarray(arr)


def same_detections(t_rows, j_rows):
    """Equal sets: each port detection has a JAX one of its class with every
    box coordinate within DET_TOL of the largest coordinate and its score
    within DET_TOL, one to one."""
    assert len(t_rows) == len(j_rows), (len(t_rows), len(j_rows))
    scale = max([abs(v) for r in j_rows for v in r["box"]] + [1.0])
    left = list(j_rows)
    for r in t_rows:
        hit = [j for j in left if j["class"] == r["class"]
               and np.abs(np.subtract(j["box"], r["box"])).max() <= DET_TOL * scale
               and abs(j["score"] - r["score"]) <= DET_TOL]
        assert hit, f"no JAX detection matches {r}"
        left.remove(hit[0])


# ---------------------------------------------------------------- config and utilities
def test_scale_table_and_model_config_match_jax():
    assert tcfg.SCALE_TABLE == jcfg.SCALE_TABLE
    for phi in "nsmlx":
        t = tcfg.ModelConfig(phi=phi, input_shape=(640, 480))
        j = jcfg.ModelConfig(phi=phi, input_shape=(640, 480))
        for name in ("base_channels", "base_depth", "deep_mul", "strides", "feat_shapes",
                     "num_anchors"):
            assert getattr(t, name) == getattr(j, name), (phi, name)
    with pytest.raises(ValueError, match="invalid phi"):
        _ = tcfg.ModelConfig(phi="z").scale


CONFIG_TEXT = {
    "yaml": ("model:\n  phi: m\n  input_shape: [320, 320]\n"
             "train:\n  unfreeze_epoch: 10\n  optimizer_type: adam\n"
             "predict:\n  confidence: 0.3\n"),
    "json": json.dumps({"model": {"phi": "n", "input_shape": [256, 320], "int8_dense": True},
                        "train": {"freeze_batch_size": 8, "mosaic": False},
                        "predict": {"nms_mode": "fast", "nms_iou": 0.5}}),
    "default": None,
}


@pytest.mark.parametrize("kind", sorted(CONFIG_TEXT))
def test_load_config_matches_jax(kind, tmp_path):
    if kind == "default":
        path = os.path.join(REPO, "configs", "default.yaml")
    else:
        path = str(tmp_path / f"c.{kind}")
        with open(path, "w") as f:
            f.write(CONFIG_TEXT[kind])
    got, want = tcfg.load_config(path), jcfg.load_config(path)
    for t, j in zip(got, want):
        assert type(t).__name__ == type(j).__name__
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert isinstance(got[0].input_shape, tuple)


@pytest.mark.parametrize("section", ["model", "train", "predict"])
def test_load_config_refuses_unknown_keys_as_jax(section, tmp_path):
    path = str(tmp_path / "c.json")
    with open(path, "w") as f:
        json.dump({section: {"nonexistent_knob": 1, "phi_": 2}}, f)
    with pytest.raises(ValueError) as t_err:
        tcfg.load_config(path)
    with pytest.raises(ValueError) as j_err:
        jcfg.load_config(path)
    assert str(t_err.value) == str(j_err.value)
    assert "nonexistent_knob" in str(t_err.value)


def test_common_utilities_match_jax(tmp_path, capsys):
    path = tmp_path / "classes.txt"
    path.write_text("glass\n\n  bottle  \nwindow\n")
    assert tcommon.get_classes(str(path)) == jcommon.get_classes(str(path))
    kw = dict(phi="s", model_path=None, input_shape=(640, 640), a_long_key_name_here=3.5)
    t_text = tcommon.show_config(**kw)
    t_out = capsys.readouterr().out
    j_text = jcommon.show_config(**kw)
    assert t_text == j_text and t_out == capsys.readouterr().out
    img = np.random.default_rng(0).integers(0, 256, (5, 7, 3), dtype=np.uint8)
    np.testing.assert_array_equal(tcommon.preprocess_input(img), jcommon.preprocess_input(img))
    gen = tcommon.seed_everything(5)
    draws = (gen.random(4), np.random.random(3), __import__("random").random(),
             torch.rand(3))
    jgen = jcommon.seed_everything(5)
    np.testing.assert_array_equal(draws[0], jgen.random(4))
    np.testing.assert_array_equal(draws[1], np.random.random(3))
    assert draws[2] == __import__("random").random()
    # the port also seeds torch's default generator
    assert torch.equal(draws[3], torch.rand(3, generator=torch.Generator().manual_seed(5)))


def test_count_params_matches_jax(pair):
    j, t = pair
    assert count_params(t.model) == jcount(j.variables["params"])


# ---------------------------------------------------------------- predict
def test_detect_image_matches_jax(pair, image, tmp_path, capsys):
    j, t = pair
    rows, drawn = t.detect_image(image, draw=True, crop=True, count=True,
                                 crop_dir=str(tmp_path / "crops"))
    assert len(rows) > 0
    assert "class counts:" in capsys.readouterr().out
    assert len(os.listdir(tmp_path / "crops")) == len(rows)
    assert drawn.size == image.size
    same_detections(rows, j.detect_image(image))


def test_predict_dispatch_matches_jax(pair, image, tmp_path):
    j, t = pair
    path = str(tmp_path / "x.png")
    image.save(path)
    same_detections(t.predict(path), j.predict(path))
    for f in (t, j):
        with pytest.raises(ValueError, match="unsupported source"):
            f.predict(str(tmp_path / "x.txt"))


def test_predict_dir_matches_jax(pair, image, tmp_path):
    j, t = pair
    din = tmp_path / "in"
    din.mkdir()
    for i in range(3):
        image.rotate(90 * i, expand=True).save(din / f"{i}.png")
    got = t.predict_dir(str(din), str(tmp_path / "out"))
    want = j.predict_dir(str(din))
    assert sorted(got) == sorted(want) and len(got) == 3
    for p in got:
        same_detections(got[p], want[p])
    assert sorted(os.listdir(tmp_path / "out")) == ["0.png", "1.png", "2.png"]


def test_predict_video_writes_frames(pair, tmp_path):
    import cv2

    t = pair[1]
    src = str(tmp_path / "in.avi")
    writer = cv2.VideoWriter(src, cv2.VideoWriter_fourcc(*"MJPG"), 5.0, (96, 72))
    for i in range(4):
        writer.write(np.full((72, 96, 3), 40 * i, np.uint8))
    writer.release()
    fps = t.predict(src, output_path=str(tmp_path / "out.avi"), max_frames=3)
    assert fps > 0 and os.path.getsize(tmp_path / "out.avi") > 0


@pytest.mark.parametrize("batch_size", [1, 2])
def test_get_fps(pair, batch_size):
    assert pair[1].get_fps(test_interval=2, batch_size=batch_size) > 0


def test_heatmap_matches_jax(pair, image, tmp_path):
    j, t = pair
    heat = t.detect_heatmap(image, str(tmp_path / "h.png"))
    want = j.detect_heatmap(image)
    assert heat.shape == want.shape == (8, 8)
    np.testing.assert_allclose(heat, want, rtol=0, atol=DET_TOL)
    assert os.path.exists(tmp_path / "h.png")


def test_int8_serving_same_checkpoint(variables, pair, image):
    """The int8 serving model takes the bf16 model's state_dict unchanged
    and serves through FOCUS."""
    q = _port_focus(variables, int8_dense=True, int8_attn=True)
    assert q.model.state_dict().keys() == pair[1].model.state_dict().keys()
    rows = q.detect_image(image)
    assert isinstance(rows, list)


# ---------------------------------------------------------------- weights, fuse, export
def test_weights_roundtrip(variables, tmp_path, capsys):
    t = _port_focus(variables)
    before = {k: v.clone() for k, v in t.model.state_dict().items()}
    path = t.save_weights(str(tmp_path / "w"))
    with torch.no_grad():
        for v in t.model.state_dict().values():
            v.zero_()
    t.load_weights(path)
    assert "loaded %d tensors, skipped 0" % len(before) in capsys.readouterr().out
    for k, v in t.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    # partial: a tensor of another shape is skipped, the rest loads
    tree = torch.load(path, weights_only=True)
    name = next(iter(tree["params"]))
    tree["params"][name] = torch.zeros(3)
    torch.save(tree, tmp_path / "w2")
    t.load_weights(str(tmp_path / "w2"))
    assert "skipped 1" in capsys.readouterr().out
    assert torch.equal(t.model.state_dict()[name], before[name])


def test_fuse_matches_jax(variables, pair, image):
    j = pair[0]
    t = _port_focus(variables)
    x = torch.from_numpy(np.random.default_rng(3).random((2, *HW, 3), dtype=np.float32))
    with torch.no_grad():
        unfused = t.model(x)["decoded"]
    sd = {k: v.clone() for k, v in t.model.state_dict().items()}
    fused = t.fuse().model.state_dict()
    fp, fs = jfuse(j.variables["params"], j.variables["batch_stats"])
    want = state_dict_from_jax({"params": fp, "batch_stats": fs}, t.model)
    assert fused.keys() == want.keys()
    folded = [k for k in fused if k.endswith(".bn.running_mean")]
    assert len(folded) > 20
    for k, v in want.items():
        assert rel_err(fused[k], v) <= 1e-6, k
    with torch.no_grad():
        dec = t.model(x)["decoded"]
    assert rel_err(dec, unfused) <= DET_TOL
    same_detections(t.detect_image(image), j.detect_image(image))
    # the bar sees a fold without its mean term
    bad = dict(fused)
    for k in folded:
        p = k[: -len("running_mean")]
        bad[p + "bias"] = sd[p + "bias"]
    t.model.load_state_dict(bad)
    with torch.no_grad():
        assert rel_err(t.model(x)["decoded"], unfused) > 10 * DET_TOL


def test_export_roundtrip(variables, tmp_path):
    """The .pt2 program loads and gives the eager `decoded` bit for bit. At
    288x288 the token maps of stride 8 (1,296 > 1,024 tokens) take the flash
    routes, so the graph holds the kernels' registered operators (their CPU
    implementations here)."""
    hw = (288, 288)
    t = _port_focus(variables, input_shape=hw)
    path = t.export(str(tmp_path / "m.pt2"))
    program = tapi.load_exported(path)
    ops = [str(n.target) for n in program.graph.nodes if str(n.target).startswith("focus.")]
    assert ops.count("focus.flash_single.default") == 2, ops
    x = torch.from_numpy(np.random.default_rng(5).random((1, *hw, 3), dtype=np.float32))
    with torch.no_grad():
        assert torch.equal(program(x), t.model(x)["decoded"])


# ---------------------------------------------------------------- summary and operators
@pytest.mark.parametrize("side", [64, 96])
def test_summary_matches_jax(variables, side):
    j = _jax_focus(variables, (side, side))
    t = _port_focus(variables, (side, side))
    got, want = t.summary(), j.summary()
    assert got["params"] == want["params"]
    assert abs(got["flops"] / want["flops"] - 1.0) <= 0.10, (got, want)
    assert got["bytes_accessed"] > 0



@pytest.mark.parametrize("int8", [False, True])
def test_summary_operators_count_plain_flops(int8):
    """At 288x288 dark3 (N = 1,296) takes the one-head kernel's operator and
    the int8 model its qmm and quant_rows operators: the forward's count
    through the operators' formulas equals its count on the plain versions
    (`set_attention_impl`), which FlopCounterMode takes from their aten
    products."""
    from transparent_object_detection_tpu_torch.models.detector import set_attention_impl

    model = FocusModel(**KW, dtype=torch.float32, int8_dense=int8, int8_attn=int8).eval()
    x = torch.zeros(1, 288, 288, 3)
    via_ops = profiling.cost_analysis(tapi._Decoded(model), x)["flops"]
    plain = profiling.cost_analysis(tapi._Decoded(set_attention_impl(model, "plain")), x)
    assert via_ops == plain["flops"] > 0

def _op_cases():
    """(operator, its arguments, its plain version's call) at small shapes
    the plain versions take."""
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=g)
    b, n, c, h, bk = 2, 64, 64, 2, 32
    qkv = r(b, n, 3 * c)
    kq, ks = A8.quantize_kv(r(b, n, c), h, bk)
    vq, vs = A8.quantize_kv(r(b, n, c), h, bk)
    payload = torch.randint(-127, 128, (b, n, 3 * c), dtype=torch.int8, generator=g)
    qs = torch.rand(b, n, h, generator=g) * 0.01
    w = QM.prepare_weights(r(48, 40), r(48))
    xq, xs = QM.quant_rows_plain(r(24, 40), False)
    res = r(24, 48)
    args = {
        "flash_mha_packed": (qkv, h, 0.125),
        "flash_single": (r(b, n, 16), r(b, n, 16), r(b, n, 40), 0.25),
        "flash_mha_int8": (qkv, kq, ks, vq, vs, h, 0.125, c),
        "flash_mha_int8_qout": (qkv, kq, ks, vq, vs, h, 0.125, c),
        "flash_int8_handoff": (payload, qs, kq, ks, vq, vs, h, 0.125, torch.float32),
        "flash_int8_handoff_qout": (payload, qs, kq, ks, vq, vs, h, 0.125),
        "quant_rows": (r(24, 40), True, 1e-6, 127),
        "qmm": (xq, xs, w["wq"], w["w_scale"], w["bias"], "gelu", res, torch.float32),
        "qmm_quant_out": (xq, xs, w["wq"], w["w_scale"], w["bias"], None, None, 16,
                          torch.float32),
        "qmm_ln_out": (xq, xs, w["wq"], w["w_scale"], None, "silu", res, 1e-6, torch.float32),
        "nms_exact": (torch.rand(b, n, n, generator=g), torch.arange(n).expand(b, n) < 40, 0.4),
    }
    plain = {
        "flash_mha_packed": lambda a: A.flash_mha_packed_plain(*a),
        "flash_single": lambda a: A.flash_single_plain(*a),
        "flash_mha_int8": lambda a: A8.flash_mha_int8_plain(*a),
        "flash_mha_int8_qout": lambda a: A8.flash_mha_int8_qout_plain(*a),
        "flash_int8_handoff": lambda a: A8.flash_int8_handoff_plain(*a[:8], False, a[8]),
        "flash_int8_handoff_qout": lambda a: A8.flash_int8_handoff_plain(*a, True),
        "quant_rows": lambda a: QM.quant_rows_plain(*a),
        "qmm": lambda a: QM.qmm_plain(*a[:7], None, None, a[7]),
        "qmm_quant_out": lambda a: QM.qmm_plain(*a[:7], a[7], None, a[8]),
        "qmm_ln_out": lambda a: QM.qmm_plain(*a[:7], None, a[7], a[8]),
        "nms_exact": lambda a: NMS.nms_exact_plain(*a),
    }
    return {name: (getattr(torch.ops.focus, name), args[name], plain[name])
            for name in library.OPS}


OP_CASES = _op_cases()


@pytest.mark.parametrize("name", library.OPS)
def test_op_formula_counts_plain_flops(name):
    """An operator counts, by its registered formula, the FLOPs that
    FlopCounterMode counts over its plain version; the CPU implementation
    is the plain version, bit for bit."""
    from torch.utils.flop_counter import FlopCounterMode

    op, args, plain = OP_CASES[name]
    with FlopCounterMode(display=False) as via_op:
        out = op(*args)
    with FlopCounterMode(display=False) as via_plain:
        ref = plain(args)
    assert via_op.get_total_flops() == via_plain.get_total_flops()
    assert (via_op.get_total_flops() > 0) == (name not in ("quant_rows", "nms_exact"))
    for a, b in zip(*(x if isinstance(x, tuple) else (x,) for x in (out, ref))):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("name", library.OPS)
def test_op_fake_matches_cpu(name):
    from torch._subclasses.fake_tensor import FakeTensorMode

    op, args, _ = OP_CASES[name]
    real = op(*args)
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        fake = op(*(mode.from_tensor(a) if isinstance(a, torch.Tensor) else a for a in args))
    real, fake = (x if isinstance(x, tuple) else (x,) for x in (real, fake))
    assert [(r.shape, r.dtype) for r in real] == [(f.shape, f.dtype) for f in fake]


def test_profiling_helpers(tmp_path):
    a, b = torch.randn(32, 48), torch.randn(48, 16)
    assert profiling.time_fn(torch.matmul, a, b, iters=2) > 0
    assert profiling.throughput(torch.matmul, 32, a, b, iters=2) > 0
    with profiling.trace(str(tmp_path / "tr")):
        torch.matmul(a, b)
    assert os.path.getsize(tmp_path / "tr" / "trace.json") > 0
    cost = profiling.cost_analysis(torch.matmul, a, b)
    assert cost == {"flops": 2.0 * 32 * 48 * 16, "bytes_accessed": 4.0 * (32 * 48 + 48 * 16
                                                                          + 32 * 16)}


# ---------------------------------------------------------------- evaluate and train
def _val_lines(root, n=4):
    rng = np.random.default_rng(4)
    lines = []
    for i in range(n):
        arr = np.clip(rng.normal(200, 30, (80, 72, 3)), 0, 255).astype(np.uint8)
        arr[20:60, 15:55] = (200, 40, 40)
        p = str(root / f"e{i}.png")
        Image.fromarray(arr).save(p)
        lines.append(f"{p} 15,20,55,60,0")
    return lines


def test_evaluate_matches_jax(pair, tmp_path):
    j, t = pair
    lines = _val_lines(tmp_path)
    got = t.evaluate(lines, batch_size=2, confidence=0.3)
    want = j.evaluate(lines, batch_size=2, confidence=0.3)
    assert got.keys() == want.keys()
    for key, value in want.items():
        np.testing.assert_allclose(got[key], value, rtol=0, atol=1e-6, err_msg=key)


def _recording_trainer(seen, port: bool):
    class Recorder:
        def __init__(self, model_cfg, train_cfg, model=None, variables=None, **kw):
            seen.append((model_cfg, train_cfg))
            if port:  # the model it trains is the bf16 one
                assert not any(getattr(m, "int8_dense", False) or getattr(m, "int8_attn", False)
                               for m in model.modules())
            self.variables = self.ema_variables = (tapi.variables_of(model) if port
                                                   else variables)

        def fit(self, *a, **kw):
            return []
    return Recorder


@pytest.mark.parametrize("int8", [False, True])
def test_train_config_matches_jax(variables, tmp_path, monkeypatch, int8):
    """FOCUS.train hands the trainer the same TrainConfig as JAX's FOCUS.train
    (defaults, and every argument changed), and with int8 on the same
    de-quantized model configuration."""
    import transparent_object_detection_tpu.train.trainer as jtrainer
    import transparent_object_detection_tpu_torch.train.trainer as ttrainer

    seen_j, seen_t = [], []
    monkeypatch.setattr(jtrainer, "Trainer", _recording_trainer(seen_j, False))
    monkeypatch.setattr(ttrainer, "Trainer", _recording_trainer(seen_t, True))
    j, t = _jax_focus(variables), _port_focus(variables)
    if int8:
        for f in (j, t):
            f.model_cfg = dataclasses.replace(f.model_cfg, int8_dense=True, int8_attn=True)
    lines = _val_lines(tmp_path, 2)
    calls = (dict(), dict(epochs=3, batch_size=4, lr=2e-3, eval_period=2, freeze_train=True))
    for kw in calls:
        for f in (j, t):
            f.train(train_lines=lines, val_lines=lines, save_dir=str(tmp_path / "logs"), **kw)
    assert len(seen_j) == len(seen_t) == 2
    for (jm, jt), (tm, tt) in zip(seen_j, seen_t):
        assert dataclasses.asdict(tt) == dataclasses.asdict(jt)
        assert dataclasses.asdict(tm) == dataclasses.asdict(jm)
        assert not (tm.int8_dense or tm.int8_attn)


def test_focus_train_one_epoch(variables, tmp_path):
    """FOCUS.train end to end on the tiny model (one epoch, the EMA weights
    adopted), then evaluate."""
    t = _port_focus(variables)
    before = {k: v.clone() for k, v in t.model.state_dict().items()}
    rng = np.random.default_rng(5)
    lines = []
    for i in range(4):
        arr = np.full((80, 80, 3), 230, dtype=np.uint8)
        arr[20:60, 25:65] = rng.integers(0, 255, 3)
        p = str(tmp_path / f"tr{i}.png")
        Image.fromarray(arr).save(p)
        lines.append(f"{p} 25,20,65,60,0")
    tc = tcfg.TrainConfig(init_epoch=0, freeze_epoch=0, unfreeze_epoch=1, freeze_train=False,
                          freeze_batch_size=2, unfreeze_batch_size=2, optimizer_type="adam",
                          mosaic=False, mixup=False, max_boxes=8,
                          save_dir=str(tmp_path / "logs"), eval_period=100, eval_flag=False)
    hist = t.train(train_lines=lines, val_lines=lines, train_cfg=tc,
                   save_dir=str(tmp_path / "logs"), num_workers=1)
    assert len(hist) == 1 and np.isfinite(hist[0]["loss"])
    assert not t.model.training
    assert any(not torch.equal(v, before[k]) for k, v in t.model.state_dict().items())
    assert os.path.exists(tmp_path / "logs" / "last_weights")
    stats = t.evaluate(lines, batch_size=2)
    assert "AP50" in stats and "voc_map" in stats


# ---------------------------------------------------------------- drivers
DRIVERS = ("predict", "train", "summary", "get_map", "profile", "coco_annotation")


@pytest.mark.parametrize("driver", DRIVERS)
def test_driver_help(driver):
    res = subprocess.run([sys.executable, "-m",
                          f"transparent_object_detection_tpu_torch.tools.{driver}", "--help"],
                         cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "usage:" in res.stdout
