"""Blocks of the PyTorch port against their flax modules, in fp32 on the CPU.

Each case builds the flax module and the port module, fills the flax
variables with seeded random values (BatchNorm statistics randomised,
SelfAttention gamma 0.5), converts them with the port's weight bridge, runs
the same numpy input through both in evaluation mode and requires the
outputs to agree within 2e-4 of the output's largest magnitude (fp32: only
summation order differs).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import transparent_object_detection_tpu.ops.attention as jattn
import transparent_object_detection_tpu.ops.attention_int8 as ja8
import transparent_object_detection_tpu.ops.quant_matmul as jqm
from _torch_parity import random_variables, rel_err, to_jax
from transparent_object_detection_tpu.models import blocks as jb
from transparent_object_detection_tpu_torch.models import blocks as tb
from transparent_object_detection_tpu_torch.ops import quant_matmul as tqm
from transparent_object_detection_tpu_torch.weights import load_jax_variables

torch.set_num_threads(1)

F32 = dict(dtype=torch.float32)
JF32 = dict(dtype=jnp.float32)

# name -> (flax module, port module, input (B, H, W, C))
CASES = {
    "conv_bn_act_s2": (lambda: jb.ConvBNAct(24, 3, strides=2, **JF32),
                       lambda: tb.ConvBNAct(16, 24, 3, strides=2, **F32), (2, 15, 17, 16)),
    "c2f": (lambda: jb.C2f(32, n=2, shortcut=True, **JF32),
            lambda: tb.C2f(16, 32, n=2, shortcut=True, **F32), (2, 12, 10, 16)),
    "sppf": (lambda: jb.SPPF(24, **JF32), lambda: tb.SPPF(32, 24, **F32), (2, 9, 11, 32)),
    "cbam": (lambda: jb.CBAM(**JF32), lambda: tb.CBAM(48, **F32), (2, 13, 7, 48)),
    # 34 x 34 = 1156 tokens: the flash route (single-head plain version)
    "self_attention_flash": (lambda: jb.SelfAttention(**JF32),
                             lambda: tb.SelfAttention(16, **F32), (1, 34, 34, 16)),
    "self_attention_naive": (lambda: jb.SelfAttention(**JF32),
                             lambda: tb.SelfAttention(32, **F32), (2, 8, 12, 32)),
    # 33 x 32 = 1056 tokens, 256 channels -> 2 heads of 128: packed route
    "teb_packed": (lambda: jb.TransformerEncoderBlock(num_heads=8, **JF32),
                   lambda: tb.TransformerEncoderBlock(256, 8, **F32), (1, 33, 32, 256)),
    # 48 channels -> 8 heads of 6, 100 tokens: naive route
    "teb_naive": (lambda: jb.TransformerEncoderBlock(num_heads=8, **JF32),
                  lambda: tb.TransformerEncoderBlock(48, 8, **F32), (2, 10, 10, 48)),
}


def _run_pair(jmod, tmod, shape, dtype=jnp.float32):
    """Both modules on the same seeded input (of `dtype`) and variables."""
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    variables = random_variables(jmod, jnp.zeros(shape, jnp.float32), train=False)
    xj = jnp.asarray(x).astype(dtype)
    ref = jax.jit(lambda v, a: jmod.apply(v, a, train=False))(to_jax(variables), xj)
    load_jax_variables(tmod, variables).eval()
    xt = torch.from_numpy(np.array(xj, np.float32)).to(getattr(torch, jnp.dtype(dtype).name))
    with torch.no_grad():
        out = tmod(xt.permute(0, 3, 1, 2)).permute(0, 2, 3, 1).float().numpy()
    assert out.shape == ref.shape
    return out, np.asarray(ref, np.float32)


@pytest.mark.parametrize("case", sorted(CASES))
def test_block_matches_flax(case):
    make_j, make_t, shape = CASES[case]
    out, ref = _run_pair(make_j(), make_t(), shape)
    assert rel_err(out, ref) <= 2e-4


# int8 serving branches at 40 x 40 = 1,600 tokens (the int8 attention route
# needs N > 1024 and a multiple of 32) and batch 2 (3,200 rows, a multiple of
# 128, so the JAX dispatch reaches its kernels), with the JAX kernels in the
# Pallas interpreter. name -> (flax kwargs, port kwargs, channels, dtype, bar).
# Bars, relative to the output's largest magnitude. fp32: both sides compute
# the same integers, but a +-1 payload flip (summation order of a statistic)
# moves a row by ~1e-3 of its projection and the TEB chains five
# quantizations: 1e-2 for the int8 TEB (measured 5.0e-3, 99.9% of elements
# within 1.7e-3), 5e-3 for one quantized stage (measured <= 9.5e-4). bf16:
# 2e-2, the JAX tests' bf16 bar (measured 7.4e-3). In fp32 the LN handoff
# computes what the plain route computes, so its case runs in bf16.
INT8_CASES = {
    "teb_int8": (dict(int8_dense=True, int8_attn=True), dict(int8_dense=True, int8_attn=True),
                 256, jnp.float32, 1e-2),
    "teb_int8_ln_handoff": (dict(int8_dense=True, int8_attn=True),
                            dict(int8_dense=True, int8_attn=True), 256, jnp.bfloat16, 2e-2),
    "teb_int8_dense_bf16": (dict(int8_dense=True), dict(int8_dense=True), 256, jnp.bfloat16,
                            2e-2),
    "teb_int8_attn": (dict(int8_attn=True), dict(int8_attn=True), 256, jnp.float32, 5e-3),
    "self_attention_int8": (dict(int8_attn=True), dict(int8_attn=True), 256, jnp.float32, 5e-3),
}


@pytest.mark.parametrize("case", sorted(INT8_CASES))
def test_int8_block_matches_flax(case, monkeypatch):
    monkeypatch.setattr(jqm, "INTERPRET", True)
    monkeypatch.setattr(ja8, "INTERPRET", True)
    monkeypatch.setattr(jattn, "INTERPRET", True)
    if case.endswith("ln_handoff"):  # the handoff's row floor, lowered on both sides
        monkeypatch.setenv("TOD_LN_HANDOFF_MIN_ROWS", "128")
        monkeypatch.setattr(tqm, "LN_HANDOFF_MIN_ROWS", 128)
    jkw, tkw, c, dtype, bar = INT8_CASES[case]
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, jdt.name)
    if case.startswith("teb"):
        jmod = jb.TransformerEncoderBlock(num_heads=8, dtype=jdt, attention_impl="pallas", **jkw)
        tmod = tb.TransformerEncoderBlock(c, 8, dtype=tdt, **tkw)
    else:
        jmod = jb.SelfAttention(dtype=jdt, attention_impl="pallas", **jkw)
        tmod = tb.SelfAttention(c, dtype=tdt, **tkw)
    out, ref = _run_pair(jmod, tmod, (2, 40, 40, c), dtype)
    assert rel_err(out, ref) <= bar


def test_int8_teb_loads_the_bf16_parameters():
    """The int8 branch declares the bf16 branch's parameters (the JAX param
    twins): one set of JAX variables fills both port blocks."""
    shape = (1, 4, 4, 256)
    jvars = random_variables(jb.TransformerEncoderBlock(int8_dense=True),
                             jnp.zeros(shape, jnp.float32), train=False)
    for kw in (dict(), dict(int8_dense=True, int8_attn=True)):
        load_jax_variables(tb.TransformerEncoderBlock(256, 8, **kw), jvars)


def test_pick_num_heads_and_dfl():
    for c in (48, 256, 337, 849, 1536, 2048):
        for lane in (True, False):
            assert tb._pick_num_heads(c, 8, lane) == jb._pick_num_heads(c, 8, lane)
    assert tb._pick_num_heads(1536, 8) == 6
    logits = np.random.default_rng(1).standard_normal((2, 5, 4, 16)).astype(np.float32)
    out = tb.dfl_expectation(torch.from_numpy(logits), 16).numpy()
    ref = np.asarray(jb.dfl_expectation(jnp.asarray(logits), 16))
    assert rel_err(out, ref) <= 2e-6
    assert [tb.autopad(k, None, d) for k, d in ((1, 1), (3, 1), (5, 1), (3, 2))] == \
        [jb.autopad(k, None, d) for k, d in ((1, 1), (3, 1), (5, 1), (3, 2))]
