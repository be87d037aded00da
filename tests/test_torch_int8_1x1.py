"""The port's int8 1x1 conv route (models/blocks.ConvBNAct with int8_1x1,
`int8_1x1_profitable`, C2f / SPPF / FusionNode carrying the flag,
build_model with ModelConfig(int8_1x1=True)) and QuantDense, against the
JAX package on the CPU.

  * tests/test_conv_int8.py's cases (ConvBNAct 1,536 -> 1,024 at 16 x 16,
    C2f(1024)) and SPPF(1024), fp32, on random_variables' weights: the
    port's plain route against JAX's (its `_qmm_reference` on the CPU): the
    activation and weight payloads equal but for +-1 on at most 1e-3 of
    the elements, outputs within 1e-2 of their largest magnitude (the bars
    of tests/test_torch_quant_matmul.py and test_torch_int8_variants.py);
  * training mode, an odd token count and the 256 -> 256 shape give the
    bf16 branch's bits;
  * the set of routed convs equals JAX's at phi n/s/m/l/x, 640 x 640,
    batch 1/2/16/32, with and without TOD_INT8_1X1_NARROW=1 (JAX's
    quant_matmul calls recorded under jax.eval_shape; the port's
    `int8_1x1_routes`, on the meta device);
  * a data mesh of 2 gloo ranks routes on the global batch's rows where a
    rank's own rows alone would not; the route column-sharded over a model
    axis of 2 gives the one-process bits;
  * fuse_conv_bn then the route gives the unfused route's bits;
  * QuantDense against JAX's on bridged weights (tests/test_blocks.py:
    155-172), its payload against JAX's.
"""
from __future__ import annotations

import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.linen.module import _context

from _torch_parity import random_variables, rel_err, to_jax
from transparent_object_detection_tpu.models import FocusModel as JFocusModel
from transparent_object_detection_tpu.models import blocks as jb
from transparent_object_detection_tpu.ops import quant_matmul as jqm
from transparent_object_detection_tpu_torch.config import SCALE_TABLE, Int8Variants, ModelConfig
from transparent_object_detection_tpu_torch.models import blocks as tb
from transparent_object_detection_tpu_torch.models.detector import (
    FocusModel,
    build_model,
    int8_1x1_routes,
)
from transparent_object_detection_tpu_torch.ops import quant_matmul as tqm
from transparent_object_detection_tpu_torch.parallel.launch import Ranks
from transparent_object_detection_tpu_torch.weights import load_jax_variables

import _torch_ranks as R

torch.set_num_threads(1)

TESTS = os.path.dirname(__file__)
FLIP_SHARE, OUT_BAR = 1e-3, 1e-2


def _payload_flips(got: torch.Tensor, want) -> float:
    """Share of payload elements off by one; fails on a step past one."""
    want = torch.from_numpy(np.asarray(want).astype(np.int32))
    diff = (got.int() - want).abs()
    assert got.shape == want.shape and int(diff.max()) <= 1
    return float((diff > 0).float().mean())


class _IntDots:
    """JAX's int8 dot_generals (the 1x1 route's and QuantDense's products)
    recorded with their operands while an eager apply runs."""

    def __init__(self, monkeypatch):
        self.calls = []
        real = jax.lax.dot_general

        def dot(a, b, *args, **kw):
            if a.dtype == jnp.int8:
                self.calls.append((np.asarray(a), np.asarray(b)))
            return real(a, b, *args, **kw)
        monkeypatch.setattr(jax.lax, "dot_general", dot)


def _port_payloads(module):
    """(activation payload, weight payload (N, K)) of each routed conv of
    `module`, in call order, on its plain route."""
    calls = []
    real = tb.ConvBNAct._forward_int8

    def rec(self, x):
        rows = x.permute(0, 2, 3, 1).reshape(-1, x.shape[1])
        xq, _ = tqm.quant_rows_plain(rows, False)
        wq = self._prepare_int8()["wq"][:, :x.shape[1]]
        calls.append((xq, wq))
        return real(self, x)
    tb.ConvBNAct._forward_int8 = rec
    return calls, lambda: setattr(tb.ConvBNAct, "_forward_int8", real)


CASES = {
    # name: (JAX module, port module, input channels)
    "conv": (lambda i8: jb.ConvBNAct(1024, 1, dtype=jnp.float32, int8=i8),
             lambda i8: tb.ConvBNAct(1536, 1024, 1, dtype=torch.float32, int8_1x1=i8), 1536),
    "c2f": (lambda i8: jb.C2f(1024, n=1, shortcut=True, dtype=jnp.float32, int8_1x1=i8),
            lambda i8: tb.C2f(1024, 1024, n=1, shortcut=True, dtype=torch.float32,
                              int8_1x1=i8), 1024),
    "sppf": (lambda i8: jb.SPPF(1024, dtype=jnp.float32, int8_1x1=i8),
             lambda i8: tb.SPPF(1024, 1024, dtype=torch.float32, int8_1x1=i8), 1024),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_int8_route_matches_jax(monkeypatch, case):
    """tests/test_conv_int8.py's shapes and SPPF(1024): the routed convs
    (conv: itself; C2f: cv2, 1,536 -> 1,024; SPPF: cv2, 2,048 -> 1,024)
    quantize as JAX does and give JAX's outputs; the bf16-branch modules
    hold the same parameters."""
    jmod, tmod, cin = CASES[case]
    x = np.random.default_rng(0).normal(size=(1, 16, 16, cin)).astype(np.float32)
    variables = random_variables(jmod(True), jnp.zeros((1, 16, 16, cin)), train=False)
    port = load_jax_variables(tmod(True).eval(), variables)
    plain = load_jax_variables(tmod(False).eval(), variables)
    assert port.state_dict().keys() == plain.state_dict().keys()
    dots = _IntDots(monkeypatch)
    want = np.asarray(jmod(True).apply(to_jax(variables), jnp.asarray(x), train=False))
    calls, undo = _port_payloads(port)
    try:
        with torch.no_grad():
            got = port(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    finally:
        undo()
    assert len(calls) == len(dots.calls) == 1
    for (xq, wq), (jx, jw) in zip(calls, dots.calls):
        assert _payload_flips(xq, jx.reshape(xq.shape)) <= FLIP_SHARE
        assert _payload_flips(wq, jw.T) <= FLIP_SHARE
    assert got.shape == want.shape
    assert rel_err(got.numpy(), want) <= OUT_BAR


def test_ineligible_and_training_take_the_conv_branch():
    """Training mode, an odd token count (15 x 15 = 225 rows) and the
    bandwidth-bound 256 -> 256 conv give the bf16 branch's bits."""
    torch.manual_seed(0)
    for cin, cout, hw in ((1536, 1024, 16), (1536, 1024, 15), (256, 256, 16)):
        i8 = tb.ConvBNAct(cin, cout, 1, dtype=torch.float32, int8_1x1=True)
        bf = tb.ConvBNAct(cin, cout, 1, dtype=torch.float32)
        bf.load_state_dict(i8.state_dict())
        x = torch.randn(2, cin, hw, hw)
        for train in (True, False):
            i8.train(train)
            bf.train(train)
            routed = i8.int8_route(x)
            assert routed == (not train and hw == 16 and cin == 1536)
            if not routed:
                assert torch.equal(i8(x), bf(x)), (cin, cout, hw, train)


def _jax_routes(monkeypatch, phi, batch, narrow):
    """JAX's quant_matmul calls of one forward at 640 x 640: {conv path:
    (M, K, N)}, traced under jax.eval_shape (no weights)."""
    calls = {}

    def rec(x, w, **kw):
        calls[".".join(_context.module_stack[-1].path)] = (x.size // x.shape[-1], x.shape[-1],
                                                           w.shape[-1])
        return jnp.zeros(x.shape[:-1] + (w.shape[-1],), kw.get("out_dtype", jnp.bfloat16))
    monkeypatch.setattr(jqm, "quant_matmul", rec)
    monkeypatch.setenv("TOD_INT8_1X1_NARROW", "1" if narrow else "0")
    c, d, mul = SCALE_TABLE[phi]
    model = JFocusModel(num_classes=1, base_channels=c, base_depth=d, deep_mul=mul, int8_1x1=True)
    x = jax.ShapeDtypeStruct((batch, 640, 640, 3), jnp.float32)
    jax.eval_shape(lambda a: model.init_with_output(jax.random.key(0), a, train=False), x)
    return calls


@pytest.mark.parametrize("phi", ["n", "s", "m", "l", "x"])
def test_routed_set_matches_jax(monkeypatch, phi):
    """The convs that take the int8 route, with their rows and widths, are
    JAX's at batch 1, 2, 16 and 32, with the narrow clause off and on; at
    phi='s' six convs from batch 16 up (none at 1 and 2), and the narrow
    clause adds dark2's C2f cv2 (512 -> 256) from 100,000 rows."""
    table = {}
    for batch in (1, 2, 16, 32):
        for narrow in (False, True):
            want = _jax_routes(monkeypatch, phi, batch, narrow)
            got = int8_1x1_routes(ModelConfig(phi=phi), batch,
                                  Int8Variants(int8_1x1_narrow=narrow))
            assert got == want, (phi, batch, narrow, sorted(got), sorted(want))
            table[batch, narrow] = sorted(got)
    if phi == "s":
        six = ["backbone.dark4_c2f.cv2", "backbone.dark5_c2f.cv2", "backbone.dark5_sppf.cv2",
               "neck.h1.reduce", "neck.h4.reduce", "neck.h6.reduce"]
        assert table[1, False] == table[2, False] == table[2, True] == []
        assert table[16, False] == table[32, False] == six
        assert table[32, True] == sorted(six + ["backbone.dark2_c2f.cv2"])


@pytest.fixture(scope="module")
def rank_runs(tmp_path_factory):
    """int8_1x1_ranks on 2 gloo ranks, and the one-process route."""
    torch.manual_seed(1)
    conv = tb.ConvBNAct(1536, 1024, 1, dtype=torch.float32, int8_1x1=True).eval()
    with torch.no_grad():
        conv.bn.running_mean.normal_(0, 0.2)
        conv.bn.running_var.uniform_(0.5, 1.5)
        conv.bn.weight.uniform_(0.5, 1.5)
        conv.bn.bias.normal_(0, 0.1)
    x = torch.randn(2, 1536, 8, 16)
    tiny = FocusModel(**R.TINY_MODEL, int8_1x1=True)
    rng = np.random.default_rng(2)
    path = str(tmp_path_factory.mktemp("int8_1x1") / "inputs.pt")
    torch.save({"conv": conv.state_dict(), "x": x, "tiny": tiny.state_dict(),
                "images": torch.from_numpy(rng.uniform(size=(4, 64, 64, 3)).astype(np.float32)),
                "shapes": torch.full((4, 2), 64.0)}, path)
    ranks = Ranks("_torch_ranks:int8_1x1_ranks", 2, {"path": path}, timeout=240.0, device="cpu",
                  threads=1, paths=[TESTS])
    with torch.no_grad():
        ref = conv(x)
    assert conv.int8_route(x)
    return {"ranks": ranks.join(), "ref": ref}


def test_data_mesh_routes_on_global_rows(rank_runs):
    """Each rank's 128 rows alone refuse the route; with the data axis's 2
    shards they take it, and the gathered output is the one-process route's
    bits (the quantization is per row); the Predictor on the data mesh
    opens the context around its forward and closes it after."""
    for out in rank_runs["ranks"]:
        assert out["local_route"] is False and out["global_route"] is True
        assert torch.equal(out["dp"], rank_runs["ref"])
        assert out["predictor_shards"] == [2] and out["after"] == [1]


def test_tp_column_shard_route_gives_one_process_bits(rank_runs):
    """The route on this rank's 512 output columns (weight scales per
    column, row scales over the whole K), all-gathered: the whole product's
    columns, bit for bit."""
    for out in rank_runs["ranks"]:
        assert torch.equal(out["tp"], rank_runs["ref"])


def test_fuse_then_route_gives_unfused_bits():
    """fuse_conv_bn's state through the route gives the unfused route's
    bits: the route folds as fuse_conv_bn does, and the fused BatchNorm
    (weight 1, mean 0, var 1 - eps) folds to the identity."""
    torch.manual_seed(2)
    model = build_model(ModelConfig(phi="n", input_shape=(64, 64), int8_1x1=True,
                                    compute_dtype="float32"), device="cpu", seed=0)
    conv = tb.ConvBNAct(1536, 1024, 1, dtype=torch.float32, int8_1x1=True).eval()
    with torch.no_grad():
        conv.bn.running_mean.normal_(0, 0.2)
        conv.bn.running_var.uniform_(0.5, 1.5)
        conv.bn.weight.uniform_(0.5, 1.5)
        conv.bn.bias.normal_(0, 0.1)
    fused = tb.ConvBNAct(1536, 1024, 1, dtype=torch.float32, int8_1x1=True).eval()
    # fuse_conv_bn folds each "<prefix>.conv" / "<prefix>.bn" pair of a model's state
    state = tb.fuse_conv_bn({f"c.{k}": v for k, v in conv.state_dict().items()})
    fused.load_state_dict({k[2:]: v for k, v in state.items()})
    x = torch.randn(1, 1536, 16, 16)
    with torch.no_grad():
        assert conv.int8_route(x) and torch.equal(conv(x), fused(x))
    assert not torch.equal(fused.conv.weight, conv.conv.weight)
    # the model's flags: the C2f / SPPF 1x1 convs and the reduce convs
    flagged = {n for n, m in model.named_modules() if isinstance(m, tb.ConvBNAct) and m.int8_1x1}
    assert "backbone.dark5_sppf.cv2" in flagged and "neck.h1.reduce" in flagged
    assert "backbone.stem" not in flagged and "head.box0.conv1" not in flagged


def test_quantdense_matches_jax(monkeypatch):
    """tests/test_blocks.py:155-172 on bridged weights: QuantDense(32) on
    (64, 48) fp32 rows against JAX's, its payloads against JAX's, and
    within JAX's own bar (2e-2) of the fp32 dense."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 48)).astype(np.float32)
    jmod = jb.QuantDense(32, dtype=jnp.float32)
    variables = random_variables(jmod, jnp.zeros((1, 48)))
    dense = fnn.Dense(32, dtype=jnp.float32, param_dtype=jnp.float32)
    assert (jax.tree_util.tree_structure(variables["params"])
            == jax.tree_util.tree_structure(jax.eval_shape(
                lambda a: dense.init(jax.random.key(1), a), jnp.zeros((1, 48)))["params"]))
    port = load_jax_variables(tb.QuantDense(48, 32, dtype=torch.float32), variables)
    dots = _IntDots(monkeypatch)
    want = np.asarray(jmod.apply(to_jax(variables), jnp.asarray(x)))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    (jx, jw), = dots.calls
    xq, _ = tqm.quant_rows_plain(torch.from_numpy(x), False)
    assert _payload_flips(xq, jx) <= FLIP_SHARE
    assert _payload_flips(tqm.quantize_weights(port.weight.detach())[0], jw.T) == 0.0
    assert rel_err(got.numpy(), want) <= 1e-5
    ref = x @ np.asarray(variables["params"]["kernel"]) + np.asarray(variables["params"]["bias"])
    assert rel_err(got.numpy(), ref) < 2e-2
    # the cached int8 weights follow a parameter change
    with torch.no_grad():
        port.bias.add_(1.0)
        assert torch.allclose(port(torch.from_numpy(x)), got + 1.0, atol=1e-5)
