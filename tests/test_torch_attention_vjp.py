"""Training attention of the PyTorch port against the JAX package, on the CPU.

The CUDA kernels cannot run here; what runs is each kernel's plain PyTorch
version (the wrappers take it for CPU tensors), held against the Pallas
kernels of ops/attention_vjp.py run through the Pallas interpreter, as
tests/test_attention_vjp.py runs them (`attention_vjp.INTERPRET`, the
`_diff_flash` cache cleared before and after). Inputs are fp32, made from a
seed with numpy. The shapes cover the kernels' whole domain in small: packed
heads of 128, single heads with q/k and v widths that differ either way and
are not powers of two, and a folded form of 3 odd heads of 53, which the
port's fold copy (ops/attention.py `_fold_heads`) zero-pads to 56 and JAX
folds unpadded; its padded columns are cut before the comparison. Bars, as tests/test_attention_vjp.py sets them against its
reference: out within 2e-4 of its largest magnitude (summation order and exp
vs exp2 only), lse within 1e-4, gradients within 1e-3 of each array's
largest magnitude.

The training blocks (SelfAttention and the TEB at 40 x 40 = 1,600 tokens, so
that N > 1024 reaches the flash route) are held against the flax modules with
attention_impl="pallas": outputs within 2e-4, every parameter gradient
within 1e-3 of the leaf's largest magnitude.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import transparent_object_detection_tpu.ops.attention as jattn
import transparent_object_detection_tpu.ops.attention_vjp as jvjp
from _torch_parity import random_variables, rel_err, to_jax
from transparent_object_detection_tpu.models import blocks as jb
from transparent_object_detection_tpu_torch.models import blocks as tb
from transparent_object_detection_tpu_torch.ops import attention as tattn
from transparent_object_detection_tpu_torch.ops import attention_vjp as tvjp
from transparent_object_detection_tpu_torch.weights import load_jax_variables, params_from_jax

torch.set_num_threads(1)

OUT_REL, LSE_ABS, GRAD_REL = 2e-4, 1e-4, 1e-3
# name -> (B, N, q/k width, v width, heads, scale): the JAX tests' shapes,
# then packed heads of 128 at N = 384, single heads of (40, 72) and (96, 32),
# and 3 folded heads of 53
SHAPES = {"single": (1, 256, 32, 64, 1, 0.3), "packed": (1, 256, 256, 256, 2, 128 ** -0.5),
          "packed_3x128": (1, 384, 384, 384, 3, 128 ** -0.5),
          "single_40_72": (1, 256, 40, 72, 1, 0.25),
          "single_qk_wider": (1, 256, 96, 32, 1, 0.2),
          "folded_3x53": (1, 256, 159, 159, 3, 53 ** -0.5)}
FOLDED = ("folded_3x53",)


@pytest.fixture(autouse=True)
def _interpret():
    jvjp.INTERPRET = True
    jattn._diff_flash.cache_clear()
    yield
    jvjp.INTERPRET = False
    jattn._diff_flash.cache_clear()


def _inputs(name: str, seed: int = 0):
    b, n, cq, cv, h, scale = SHAPES[name]
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((b, n, cq), (b, n, cq), (b, n, cv), (b, n, cv))]
    return arrs, h, scale


def _t(*arrs):
    return [torch.from_numpy(a) for a in arrs]


def _jfold(a, h):
    """JAX's fold of heads into the batch axis (no padding)."""
    b, n, c = a.shape
    return a.reshape(b, n, h, c // h).transpose(0, 2, 1, 3).reshape(b * h, n, c // h)


def _junfold(a, h):
    bh, n, d = a.shape
    return a.reshape(bh // h, h, n, d).transpose(0, 2, 1, 3).reshape(bh // h, n, h * d)


def _calls(name, arrs, h):
    """The operands of the kernel call and its head count: the folded form
    as JAX folds it (numpy) and as the port's fold copy pads it (torch)."""
    if name not in FOLDED:
        return arrs, _t(*arrs), h
    return ([_jfold(a, h) for a in arrs],
            [tattn._fold_heads(t, h) for t in _t(*arrs)], 1)


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_fwd_lse_plain_matches_pallas(name):
    arrs, h, scale = _inputs(name)
    jarrs, tarrs, h = _calls(name, arrs[:3], h)
    ref_out, ref_lse = jvjp.flash_fwd_lse(*map(jnp.asarray, jarrs), scale, 128, 128, h)
    out, lse = tvjp.flash_fwd_lse(*tarrs, scale, h)  # CPU: the plain version
    assert tuple(lse.shape) == ref_lse.shape
    assert rel_err(out[..., :ref_out.shape[-1]].numpy(), ref_out) <= OUT_REL
    assert float(np.abs(lse.numpy() - np.asarray(ref_lse)).max()) <= LSE_ABS


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_bwd_plain_matches_pallas(name):
    """dq, dk, dv of the plain versions against the Pallas backward, both
    given JAX's lse and D."""
    arrs, h, scale = _inputs(name, seed=1)
    jarrs, tarrs, h = _calls(name, arrs, h)
    jq, jk, jv, jg = map(jnp.asarray, jarrs)
    out, lse = jvjp.flash_fwd_lse(jq, jk, jv, scale, 128, 128, h)
    dcap = jvjp.compute_dcap(out, jg, h)
    ref = jvjp.flash_bwd(jq, jk, jv, jg, lse, dcap, scale, 128, 128, h)
    width = tarrs[3].shape[-1]  # the padded width of a folded form
    out_t = torch.nn.functional.pad(torch.from_numpy(np.array(out)), (0, width - out.shape[-1]))
    dcap_t = tvjp.compute_dcap(out_t, tarrs[3], h)
    assert rel_err(dcap_t.numpy(), dcap) <= OUT_REL
    args = tarrs + [torch.from_numpy(np.array(lse)), dcap_t]
    dq = tvjp.flash_bwd_dq(*args, scale, h)
    dk, dv = tvjp.flash_bwd_dkv(*args, scale, h)
    for got, want in zip((dq, dk, dv), ref):
        assert tuple(got.shape[:-1]) == want.shape[:-1]
        assert not got[..., want.shape[-1]:].any()  # the padded columns of a folded form
        assert rel_err(got[..., :want.shape[-1]].numpy(), want) <= GRAD_REL


@pytest.mark.parametrize("name,packed_input",
                         [("single", False), ("packed", False), ("packed", True),
                          ("packed_3x128", True), ("single_40_72", False),
                          ("single_qk_wider", False), ("folded_3x53", False)])
def test_function_matches_diff_flash(name, packed_input):
    """The autograd Function's output and gradient against jax.vjp of
    `_diff_flash` (Pallas forward with lse, Pallas backward). The packed
    input form takes one (B, N, 3C) qkv and returns one packed gradient; the
    folded form runs the port's folded training route (`_train_folded`:
    padded fold copy, Function, cut and unfold) against `_diff_flash` on
    JAX's unpadded fold."""
    (q, k, v, g), h, scale = _inputs(name, seed=2)
    if name in FOLDED:
        single = jattn._diff_flash(scale, 128, 128, 1)
        fn = lambda *t: _junfold(single(*(_jfold(x, h) for x in t)), h)
    else:
        fn = jattn._diff_flash(scale, 128, 128, h)
    ref, vjp = jax.vjp(fn, *map(jnp.asarray, (q, k, v)))
    ref_grads = vjp(jnp.asarray(g))
    if name in FOLDED:
        leaves = [t.requires_grad_() for t in _t(q, k, v)]
        out = tattn._train_folded(*leaves, scale, h, None)
        out.backward(torch.from_numpy(g))
        grads = [t.grad for t in leaves]
    elif packed_input:
        qkv = torch.from_numpy(np.concatenate([q, k, v], axis=-1)).requires_grad_()
        out = tvjp.flash_attention_qkv(qkv, scale, h)
        out.backward(torch.from_numpy(g))
        grads = qkv.grad.chunk(3, dim=-1)
    else:
        leaves = [t.requires_grad_() for t in _t(q, k, v)]
        out = tvjp.flash_attention(*leaves, scale, h)
        out.backward(torch.from_numpy(g))
        grads = [t.grad for t in leaves]
    assert rel_err(out.detach().numpy(), ref) <= OUT_REL
    for got, want in zip(grads, ref_grads):
        assert rel_err(got.numpy(), want) <= GRAD_REL


# training blocks at 40 x 40 tokens: SelfAttention (single head, q/k 32, v
# 256) and the TEB (256 channels: 2 packed heads of 128). The int8 cases set
# the int8 serving flags on both sides: in training both packages bypass
# them and compute the bf16 training function.
INT8 = dict(int8_dense=True, int8_attn=True)
BLOCKS = {
    "self_attention": (lambda: jb.SelfAttention(dtype=jnp.float32, attention_impl="pallas"),
                       lambda: tb.SelfAttention(256, dtype=torch.float32)),
    "self_attention_int8_flag": (
        lambda: jb.SelfAttention(dtype=jnp.float32, attention_impl="pallas", int8_attn=True),
        lambda: tb.SelfAttention(256, dtype=torch.float32, int8_attn=True)),
    "teb": (lambda: jb.TransformerEncoderBlock(num_heads=8, dtype=jnp.float32,
                                               attention_impl="pallas"),
            lambda: tb.TransformerEncoderBlock(256, 8, dtype=torch.float32)),
    "teb_int8_flags": (lambda: jb.TransformerEncoderBlock(num_heads=8, dtype=jnp.float32,
                                                          attention_impl="pallas", **INT8),
                       lambda: tb.TransformerEncoderBlock(256, 8, dtype=torch.float32, **INT8)),
}


def _block_pair(case: str):
    """Output and parameter gradients (for a seeded cotangent) of the flax
    block in training and of the port block in training mode."""
    make_j, make_t = BLOCKS[case]
    jmod, tmod = make_j(), make_t()
    shape = (1, 40, 40, 256)
    rng = np.random.default_rng(3)
    x = rng.standard_normal(shape).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    variables = random_variables(jmod, jnp.zeros(shape, jnp.float32), train=True)

    def f(params, xx):
        return jmod.apply({"params": params}, xx, train=True)

    ref, vjp = jax.vjp(f, to_jax(variables["params"]), jnp.asarray(x))
    ref_grads = vjp(jnp.asarray(g))[0]
    load_jax_variables(tmod, variables)
    tmod.train()
    out = tmod(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    out.backward(torch.from_numpy(g))
    want = params_from_jax(ref_grads, tmod)
    grads = {n: p.grad for n, p in tmod.named_parameters()}
    return out.detach().numpy(), np.asarray(ref), grads, want


def grad_err(name: str, grads, want) -> float:
    """Largest |port - JAX| of a parameter gradient over the JAX leaf's
    largest magnitude. SelfAttention's key bias adds the same amount to
    every score of a query, which the softmax ignores: its gradient is zero
    up to rounding on both sides, so it is measured against the key
    weight's gradient instead."""
    scale = want[name.replace("key.bias", "key.weight")] if name.endswith("key.bias") else want[name]
    diff = (grads[name].double() - want[name].double()).abs().max()
    return float(diff / scale.double().abs().max())


@pytest.mark.parametrize("case", sorted(BLOCKS))
def test_training_block_matches_flax(case):
    out, ref, grads, want = _block_pair(case)
    assert rel_err(out, ref) <= OUT_REL
    assert set(grads) == set(want)
    for name in grads:
        assert grad_err(name, grads, want) <= GRAD_REL, name
