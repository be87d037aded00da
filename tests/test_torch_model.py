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
    i1x1 = build_model(ModelConfig(phi="n", input_shape=(64, 64), int8_1x1=True), device="cpu",
                       seed=3)
    flagged = {n for n, m in i1x1.named_modules() if getattr(m, "int8_1x1", False)}
    assert {"backbone.dark2_c2f.cv1", "backbone.dark5_sppf.cv2", "neck.h6.reduce"} <= flagged
    assert not {"backbone.stem", "backbone.dark2_c2f.m0.cv1", "neck.h3"} & flagged
    assert not i1x1.neck.h1.teb.int8_dense and not i1x1.backbone.dark3_attn.int8_attn
    remat = build_model(ModelConfig(phi="n", input_shape=(64, 64), compute_dtype="float32",
                                    remat=True), device="cpu", seed=3)
    assert remat.neck.remat and not model.neck.remat
    for a, b in zip(model.parameters(), remat.parameters()):
        assert torch.equal(a, b)


def test_init_weights_draws_flax_lecun_normal():
    """init_weights draws conv and dense kernels as flax's lecun_normal
    does: a normal truncated at +-2 of its std, the std raised by
    1/0.87962566 so that the variance is 1/fan_in. On a kernel of
    (3, 3, 64, 4,096) the port's max |w| * sqrt(fan_in) stays within the
    cut (2 / 0.87962566 = 2.2737), and its empirical std agrees with the
    JAX draw's within 1%."""
    from transparent_object_detection_tpu_torch.models.detector import (
        TRUNCATED_NORMAL_STD,
        init_weights,
    )

    kh, kw, cin, cout = 3, 3, 64, 4096
    fan_in = kh * kw * cin
    conv = torch.nn.Sequential(torch.nn.Conv2d(cin, cout, (kh, kw), bias=False))
    w = init_weights(conv, seed=0)[0].weight.detach().numpy().astype(np.float64)
    ref = np.asarray(jax.nn.initializers.lecun_normal()(jax.random.PRNGKey(0),
                                                        (kh, kw, cin, cout)), np.float64)
    cut = 2.0 / TRUNCATED_NORMAL_STD
    assert cut == pytest.approx(2.2737, abs=1e-4)
    assert np.abs(w).max() * fan_in ** 0.5 <= cut * (1 + 1e-6)
    assert np.abs(ref).max() * fan_in ** 0.5 <= cut * (1 + 1e-6)
    assert abs(w.std() / ref.std() - 1.0) <= 0.01
    assert abs(w.mean()) * fan_in ** 0.5 <= 1e-2
    # the cut is reached, as the JAX draw reaches it (an untruncated normal
    # of this std would put ~2.3% of the kernel past it)
    assert np.abs(w).max() * fan_in ** 0.5 > 0.999 * cut


def test_init_weights_on_device_draws_where_the_parameters_live():
    """`init_on_device` (phi='l''s 8.33 B parameters drawn on the card) takes
    the generator of the parameters' device: on a model on the CPU that is
    the CPU's, so the same bits as the default draws from the same seed,
    through build_model as through init_weights."""
    from transparent_object_detection_tpu_torch.config import ModelConfig
    from transparent_object_detection_tpu_torch.models.detector import build_model

    cfg = ModelConfig(phi="n", input_shape=(64, 64))
    a = build_model(cfg, device="cpu", seed=3)
    b = build_model(cfg, device="cpu", seed=3, init_on_device=True)
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb), name
