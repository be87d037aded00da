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

from _torch_parity import random_variables, rel_err, to_jax
from transparent_object_detection_tpu.models import blocks as jb
from transparent_object_detection_tpu_torch.models import blocks as tb
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


@pytest.mark.parametrize("case", sorted(CASES))
def test_block_matches_flax(case):
    make_j, make_t, shape = CASES[case]
    jmod, tmod = make_j(), make_t()
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    variables = random_variables(jmod, jnp.zeros(shape, jnp.float32), train=False)
    ref = np.asarray(jax.jit(lambda v, a: jmod.apply(v, a, train=False))(to_jax(variables),
                                                                          jnp.asarray(x)))
    load_jax_variables(tmod, variables)
    with torch.no_grad():
        out = tmod(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert out.shape == ref.shape
    assert rel_err(out, ref) <= 2e-4


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
