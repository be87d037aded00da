"""FocusModel of the PyTorch port against the JAX FocusModel, on the CPU.

One module-scoped set of seeded random JAX variables per compute type
(base_channels 8, depth 1; BatchNorm statistics randomised, dark3 gamma 0.5)
goes through the weight bridge; `raw` and `decoded` must agree within a
fraction of each output's largest magnitude: 2e-4 in fp32 (summation order
only), 2e-2 in bf16 (the JAX tests' bf16 bar; the frameworks round to bf16
at different points, measured ~7e-3 on the raw maps). The int8 model
(int8_dense + int8_attn) is held to 2e-2 in fp32: the same integers on both
sides, a +-1 payload flip moving a TEB row by ~1e-3 (at this size the TEB
maps are small, so the JAX dispatch takes its reference route and the
attention its naive one; tests/test_torch_blocks.py covers the int8 kernels'
routes).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import random_variables, rel_err, to_jax
from transparent_object_detection_tpu.models.detector import FocusModel as JaxFocusModel
from transparent_object_detection_tpu_torch.config import ModelConfig
from transparent_object_detection_tpu_torch.models.detector import FocusModel, build_model
from transparent_object_detection_tpu_torch.weights import load_jax_variables

torch.set_num_threads(1)

KW = dict(num_classes=2, base_channels=8, base_depth=1, deep_mul=0.5)
SIZE = 64


TOL = {"float32": 2e-4, "bfloat16": 2e-2}


@pytest.fixture(scope="module", params=sorted(TOL))
def pair(request):
    dtype = request.param
    jmodel = JaxFocusModel(**KW, dtype=jnp.dtype(dtype))
    variables = random_variables(jmodel, jnp.zeros((1, SIZE, SIZE, 3), jnp.float32), train=True)
    tmodel = load_jax_variables(FocusModel(**KW, dtype=getattr(torch, dtype)).eval(), variables)
    apply = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))
    return dtype, apply, to_jax(variables), tmodel


def test_raw_and_decoded_match_jax(pair):
    dtype, apply, jvars, tmodel = pair
    x = np.random.default_rng(0).uniform(0, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
    ref = apply(jvars, jnp.asarray(x))
    with torch.no_grad():
        out = tmodel(torch.from_numpy(x))
    assert len(out["raw"]) == len(ref["raw"]) == 3
    for o, r in zip(out["raw"], ref["raw"]):
        assert tuple(o.shape) == r.shape
        assert rel_err(o.float().numpy(), np.asarray(r, np.float32)) <= TOL[dtype]
    assert tuple(out["decoded"].shape) == ref["decoded"].shape == (2, 84, 6)
    assert out["decoded"].dtype == torch.float32
    assert rel_err(out["decoded"].numpy(), ref["decoded"]) <= TOL[dtype]


def test_int8_decoded_matches_jax():
    kw = dict(KW, int8_dense=True, int8_attn=True)
    jmodel = JaxFocusModel(**kw, dtype=jnp.float32)
    variables = random_variables(jmodel, jnp.zeros((1, SIZE, SIZE, 3), jnp.float32), train=True)
    tmodel = load_jax_variables(FocusModel(**kw, dtype=torch.float32).eval(), variables)
    x = np.random.default_rng(0).uniform(0, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
    ref = jax.jit(lambda v, a: jmodel.apply(v, a, train=False))(to_jax(variables), jnp.asarray(x))
    with torch.no_grad():
        out = tmodel(torch.from_numpy(x))
    assert tuple(out["decoded"].shape) == ref["decoded"].shape
    assert rel_err(out["decoded"].numpy(), ref["decoded"]) <= 2e-2


def test_build_model_on_cpu():
    cfg = ModelConfig(phi="n", input_shape=(64, 64), compute_dtype="float32")
    model = build_model(cfg, device="cpu", seed=3)
    assert not model.training
    assert model.backbone.dark3_attn.gamma.item() == 0.0
    assert model.head.cls0.out.bias[0].item() == pytest.approx(model.head.cls_bias(8))
    with torch.no_grad():
        out = model(torch.zeros(1, 64, 64, 3))
    assert tuple(out["decoded"].shape) == (1, cfg.num_anchors, 4 + cfg.num_classes)
    again = build_model(cfg, device="cpu", seed=3)
    for a, b in zip(model.parameters(), again.parameters()):
        assert torch.equal(a, b)
    int8 = build_model(ModelConfig(phi="n", input_shape=(64, 64), int8_dense=True,
                                   int8_attn=True), device="cpu", seed=3)
    assert int8.neck.h1.teb.int8_dense and int8.backbone.dark3_attn.int8_attn
    with pytest.raises(NotImplementedError):
        build_model(ModelConfig(int8_1x1=True), device="cpu")
    remat = build_model(ModelConfig(phi="n", input_shape=(64, 64), compute_dtype="float32",
                                    remat=True), device="cpu", seed=3)
    assert remat.neck.remat and not model.neck.remat
    for a, b in zip(model.parameters(), remat.parameters()):
        assert torch.equal(a, b)
