"""The port's tensor-parallel serving (parallel/tp.py, ops/teb_tp.py,
Predictor(mesh=make_2d_mesh(tp))) against the JAX package's, on the CPU.

JAX runs its TP Predictor on make_2d_mesh over 2 and 4 of the conftest's
virtual CPU devices; the port runs as many gloo processes (one thread
each), started with `parallel.launch.Ranks` while the JAX side computes.
The setup is tests/test_tp.py's (base_channels 32, 128 x 128, 8 heads
requested: 4 at h1 and h6, so tp=4 is head-local there, and a ragged 3 at
h2 and h4, which all-gather at tp 2 and 4), on random_variables' weights:

  * fp32 `decoded` within 2e-4 of its largest magnitude of JAX's TP run
    and of JAX's single device, every rank the same bits; the detections
    of the global batch (4 images) with the same counts, boxes within 1e-3
    of JAX's single device;
  * int8 (int8_dense + int8_attn) within 1e-2 of JAX's TP run (the fp32
    bar of tests/test_torch_int8_variants.py against JAX);
  * each rank's parameter bytes those of its shards;
  * tp_param_spec against JAX's at every leaf of phi n..x, the qkv
    canonicalization bit for bit, the attention routes at the local shapes
    against JAX's dispatch, and the refusals (no mesh, widths tp does not
    divide).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from _torch_parity import random_variables, rel_err, to_jax
from transparent_object_detection_tpu.config import ModelConfig as JModelConfig
from transparent_object_detection_tpu.config import PredictConfig as JPredictConfig
from transparent_object_detection_tpu.inference import Predictor as JPredictor
from transparent_object_detection_tpu.models import FocusModel as JFocusModel
from transparent_object_detection_tpu.ops.shard import set_compute_mesh
from transparent_object_detection_tpu.parallel import tp as jtp
from transparent_object_detection_tpu_torch.config import SCALE_TABLE
from transparent_object_detection_tpu_torch.models.detector import FocusModel
from transparent_object_detection_tpu_torch.ops import attention as tattn
from transparent_object_detection_tpu_torch.ops import teb_tp
from transparent_object_detection_tpu_torch.parallel import tp as ttp
from transparent_object_detection_tpu_torch.parallel.launch import Ranks
from transparent_object_detection_tpu_torch.weights import load_jax_variables, params_from_jax

import _torch_ranks as R

torch.set_num_threads(1)

TESTS = __import__("os").path.dirname(__file__)
# name -> (tp, ranks)
MESHES = {"dp1xtp2": (2, 2), "dp1xtp4": (4, 4), "dp2xtp2": (2, 4)}
RANK_TIMEOUT = 240.0
# the bf16 sites where JAX on a TPU leaves for its chunked route at the local
# shapes too (heads of 1,536 at N = 1,600 and of 3,584, whole on each rank)
# and the port keeps its kernel
KEPT_TP = {(phi, name, tp) for phi, name in (("l", "h1"), ("x", "h1"), ("x", "h4"))
           for tp in (2, 4, 8)}
FP32_BAR, INT8_BAR = 2e-4, 1e-2


def _jax_model(int8: bool):
    return JFocusModel(num_classes=1, base_channels=32, base_depth=1, deep_mul=0.5,
                       num_heads=8, dtype=jnp.float32, int8_dense=int8, int8_attn=int8)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every mesh's ranks (started first) and JAX's TP and single-device
    runs on the same weights and images."""
    variables = random_variables(_jax_model(False), jnp.zeros((1, 128, 128, 3), jnp.float32),
                                 train=False)
    rng = np.random.default_rng(0)
    images = rng.uniform(size=(4, 128, 128, 3)).astype(np.float32)
    shapes = np.tile(np.asarray([[128.0, 128.0]], np.float32), (4, 1))
    port = load_jax_variables(FocusModel(**R.TP_MODEL), variables)
    path = str(tmp_path_factory.mktemp("tp") / "inputs.pt")
    torch.save({"state": port.state_dict(), "images": torch.from_numpy(images),
                "shapes": torch.from_numpy(shapes)}, path)
    ranks = {name: Ranks("_torch_ranks:tp_serving", n, {"path": path, "tp": tp},
                         timeout=RANK_TIMEOUT, device="cpu", threads=1, paths=[TESTS])
             for name, (tp, n) in MESHES.items()}

    mc = JModelConfig(num_classes=1, input_shape=(128, 128), compute_dtype="float32")
    pc = JPredictConfig(confidence=0.01, max_detections=16, pre_nms_topk=64)
    jv = to_jax(variables)
    x, s = jnp.asarray(images), jnp.asarray(shapes)
    jax_out = {}
    for int8 in (False, True):
        model = _jax_model(int8)
        key = "int8" if int8 else "fp32"
        jax_out[key, "single"] = np.asarray(
            jax.jit(lambda v, a: model.apply(v, a, train=False)["decoded"])(jv, x))
        if not int8:
            dets = JPredictor(model, jv, mc, pc).detect_letterboxed(x, s)
            jax_out["dets"] = {k: np.asarray(v) for k, v in dets.items()}
        for name, (tp, n) in MESHES.items():
            mesh = jtp.make_2d_mesh(tp, jax.devices()[:n])
            try:
                pt = JPredictor(model, jv, mc, pc, mesh=mesh)
                assert pt.model.tp_serving
                jax_out[key, name] = np.asarray(jax.jit(
                    lambda v, a: pt.model.apply(v, a, train=False)["decoded"])(pt.variables, x))
            finally:
                set_compute_mesh(None)
    port_out = {name: r.join() for name, r in ranks.items()}
    return {"jax": jax_out, "port": port_out, "variables": variables}


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("dtype", ["fp32", "int8"])
def test_tp_decoded_matches_jax_tp(runs, mesh, dtype):
    ranks = runs["port"][mesh]
    got = ranks[0][dtype]["decoded"].numpy()
    for r in ranks[1:]:
        assert torch.equal(r[dtype]["decoded"], ranks[0][dtype]["decoded"])
    assert all(r[dtype]["tp_serving"] for r in ranks)
    want = runs["jax"][dtype, mesh]
    assert got.shape == want.shape == (4, 336, 5)
    if dtype == "fp32":
        assert rel_err(got, want) <= FP32_BAR
        assert rel_err(got, runs["jax"]["fp32", "single"]) <= FP32_BAR
    else:
        assert rel_err(got, want) <= INT8_BAR
        assert np.isfinite(got).all()


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_tp_detections_match_single_device(runs, mesh):
    """The whole serving program (decode, NMS, unletterbox) on the global
    batch, returned on every rank."""
    want = runs["jax"]["dets"]
    ranks = runs["port"][mesh]
    for r in ranks:
        d = r["dets"]
        np.testing.assert_array_equal(d["num_detections"].numpy(), want["num_detections"])
        np.testing.assert_allclose(d["boxes"].numpy(), want["boxes"], atol=1e-3)
        for k in d:
            assert torch.equal(d[k], ranks[0]["dets"][k]), k


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_tp_ranks_layout_and_param_bytes(runs, mesh):
    """Rank r is model index r % tp and data index r // tp (JAX's reshape);
    each holds its shards' bytes, fewer than the whole model's."""
    tp, n = MESHES[mesh]
    full = FocusModel(**R.TP_MODEL)
    whole = sum(p.numel() * 4 for p in full.parameters())
    want = ttp.per_rank_param_bytes(full, tp)
    for r, out in enumerate(runs["port"][mesh]):
        assert out["coords"] == {"data": r // tp, "model": r % tp}
        assert out["fp32"]["bytes"] == out["int8"]["bytes"] == want < whole


@pytest.mark.parametrize("phi", ["n", "s", "m", "l", "x"])
def test_tp_param_spec_matches_jax(phi):
    """The port's spec of every parameter is JAX's spec of the same leaf
    (variables from jax.eval_shape, names through the weight bridge's
    layouts: a kernel's output axis is the port's dimension 0)."""
    c, d, mul = SCALE_TABLE[phi]
    jmodel = JFocusModel(num_classes=1, base_channels=c, base_depth=d, deep_mul=mul)
    shapes = jax.eval_shape(lambda a: jmodel.init(jax.random.key(0), a, train=False),
                            jax.ShapeDtypeStruct((1, 64, 64, 3), jnp.float32))["params"]
    flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
    with torch.device("meta"):
        port = FocusModel(base_channels=c, base_depth=d, deep_mul=mul)
    port_shapes = {n: tuple(p.shape) for n, p in port.named_parameters()}
    assert len(flat) == len(port_shapes)
    sharded = 0
    for tp in (2, 4, 8):
        for path, leaf in flat:
            names = [k.key for k in path]
            want = jtp.tp_param_spec(names, leaf, tp)
            name = ".".join(names[:-1] + [{"kernel": "weight", "scale": "weight"}.get(
                names[-1], names[-1])])
            got = ttp.tp_param_spec(name, port_shapes[name], tp)
            # JAX's axis of the leaf in its layout -> the port's dimension
            jax_axis = next((i for i, a in enumerate(want) if a == "model"), None)
            port_axis = next((i for i, a in enumerate(got) if a == "model"), None)
            if jax_axis is None:
                assert want == P() and port_axis is None, (name, want, got)
                continue
            sharded += 1
            nd = leaf.ndim
            if nd == 1:
                expect = 0
            else:  # (..., in, out) -> (out, in, ...)
                expect = {nd - 1: 0, nd - 2: 1}[jax_axis]
            assert port_axis == expect, (name, want, got)
    assert sharded > 0


@pytest.mark.parametrize("tp", [2, 4])
def test_canonicalize_qkv_matches_jax(tp):
    """JAX's canonicalize_qkv_for_tp, through the weight bridge, equals the
    port's on the bridged weights, bit for bit."""
    variables = random_variables(_jax_model(False), jnp.zeros((1, 128, 128, 3), jnp.float32),
                                 train=False)
    model = FocusModel(**R.TP_MODEL)
    canon = jtp.canonicalize_qkv_for_tp(to_jax(variables["params"]), tp)
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, canon), model)
    got = ttp.canonicalize_qkv_for_tp(params_from_jax(variables["params"], model), tp)
    assert set(got) == set(want)
    moved = 0
    for name in want:
        assert torch.equal(got[name], want[name]), name
        moved += "qkv" in name
    assert moved == 8  # weight and bias of four TEBs
    with pytest.raises(ValueError, match="not divisible"):
        ttp.canonicalize_qkv_for_tp({"teb.qkv.weight": torch.zeros(30, 10)}, 4)


def test_tp_serving_refuses_without_mesh():
    """A tp_serving model outside the Predictor raises (its qkv weights
    would be read as canonicalized), as JAX's does."""
    model = FocusModel(**R.TP_MODEL, tp_serving=True).eval()
    assert model.tp_serving and model.neck.h1.teb.tp_serving
    with pytest.raises(RuntimeError, match="tp_serving"):
        with torch.no_grad():
            model(torch.zeros(1, 128, 128, 3))


class _Axis:
    """A stand-in mesh with a model axis of `tp` (no process group)."""

    def __init__(self, tp):
        self.tp = tp

    def size(self, axis):
        return self.tp if axis == "model" else 1


def test_tp_teb_refuses_widths_tp_does_not_divide():
    teb = FocusModel(**R.TP_MODEL).neck.h2.teb.eval()  # 384 channels
    teb.tp_mesh = _Axis(5)
    with pytest.raises(ValueError, match="not divisible by tp=5"):
        teb_tp.teb_tp_forward(torch.zeros(1, 4, 384), teb)
    with pytest.raises(ValueError, match="not divisible by tp=3"):
        ttp.make_2d_mesh(3, devices=[0, 1])


def test_make_2d_mesh_without_process_group():
    """A single process is a world of one rank: tp=1 fits, tp=2 does not
    (JAX's ValueError on an indivisible device count)."""
    mesh = ttp.make_2d_mesh(1)
    assert mesh.shape == {"data": 1, "model": 1} and mesh.coords == {"data": 0, "model": 0}
    with pytest.raises(ValueError, match="not divisible by tp=2"):
        ttp.make_2d_mesh(2)


def _jax_local_route(monkeypatch, n, c, heads, tp, int8):
    """JAX's teb_tp attention call at this site: attention(q, k, v) on the
    local heads/tp heads, or on every head after the ragged all-gather."""
    from test_torch_scales import _jax_route

    local = heads % tp == 0
    cq, h = (c // tp, heads // tp) if local else (c, heads)
    return _jax_route(monkeypatch, n, cq, cq, h, int8, packed=False)


@pytest.mark.parametrize("int8", [False, True])
def test_tp_attention_routes_match_jax(monkeypatch, int8):
    """At 640 x 640, every neck TEB of phi n..x at tp 2, 4 and 8 takes the
    route JAX's teb_tp takes on a TPU (its multi-head flash kernel on
    separate q, k, v is the port's packed route on the local qkv;
    `teb_tp.local_route`), where its VMEM fit holds; and phi='s' at tp 2
    and 4 takes the routes the chip smoke counts."""
    from test_torch_scales import sites

    kept = set()
    for phi in ("n", "s", "m", "l", "x"):
        for name in ("h1", "h2", "h4", "h6"):
            n, c, _, heads, _ = sites(phi)[name]
            for tp in (2, 4, 8):
                if c % tp:
                    continue
                got = teb_tp.local_route(n, c, heads, tp, int8)
                want = _jax_local_route(monkeypatch, n, c, heads, tp, int8)
                want = ("packed", None) if want[0] == "mha" else want
                if want == ("chunked", None):  # JAX's VMEM fit fails: the port keeps its kernel
                    local = heads % tp == 0 and heads // tp == 1
                    assert got == (("single" if local else "packed"), None), (phi, name, tp)
                    kept.add((phi, name, tp))
                else:
                    assert got == want, (phi, name, tp, got, want)
    assert kept == (set() if int8 else KEPT_TP), sorted(kept)
    table = {(name, tp): teb_tp.local_route(*sites("s")[name][:2], sites("s")[name][3], tp,
                                            int8)
             for name in ("h1", "h2", "h4") for tp in (2, 4)}
    if not int8:
        assert table == {("h1", 2): ("packed", None), ("h2", 2): ("packed", None),
                         ("h4", 2): ("packed", None), ("h1", 4): ("packed", None),
                         ("h2", 4): ("packed", None), ("h4", 4): ("packed", None)}
    assert tattn.serving_route(1600, 1024, 4, 1024, False, True) == ("packed", None)


def test_per_rank_param_bytes_table():
    """tools/tp_memory.py from shapes: each scale's bf16 bytes a rank fall
    with tp; phi='n' (h1 of 849 channels) cannot split; at tp=1 the bf16
    model is half the fp32 one but for the 1-D parameters; phi='s' at tp=2
    is what a rank of the smoke's dp1xtp2 holds."""
    from transparent_object_detection_tpu_torch.tools import tp_memory

    rows = {r["phi"]: r for r in tp_memory.rows()}
    assert set(rows) == {"n", "s", "m", "l", "x"}
    assert rows["n"]["tp2_bf16_bytes"] is None and rows["n"]["tp1_bf16_bytes"] > 0
    for phi in "smlx":
        r = rows[phi]
        b = [r[f"tp{tp}_bf16_bytes"] for tp in (1, 2, 4, 8)]
        assert b[0] > b[1] > b[2] > b[3] > 0, phi
        assert r["fp32_bytes"] / 2 <= b[0] < 0.51 * r["fp32_bytes"], phi
    assert rows["s"]["params"] == 259_642_024 and rows["s"]["tp2_bf16_bytes"] == 270_314_968
