"""Attention of the PyTorch port against the JAX package, on the CPU.

The CUDA kernels cannot run here; what runs is each kernel's plain PyTorch
version (the wrappers take it for CPU tensors), held against:
  * the packed multi-head Pallas kernel run through the Pallas interpreter
    (`attention.INTERPRET`, as tests/test_attention_packed.py does);
  * the single-head launcher's function, `reference_attention` /
    `chunked_attention` (flash_attention_pallas has no interpret switch).
Tolerances: fp32 2e-4 relative to the output's largest magnitude (the
algorithms differ only in summation order and exp vs exp2), bf16 2e-2 (the
JAX tests' bar; both sides round p and the output to bf16 at different
points).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import transparent_object_detection_tpu.ops.attention as jattn
from transparent_object_detection_tpu_torch.ops import attention as tattn

torch.set_num_threads(1)

FP32_REL = 2e-4
BF16_TOL = 2e-2


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _pair(arr: np.ndarray, dtype: str):
    """The same numpy array as a JAX and a torch array of `dtype`."""
    return jnp.asarray(arr).astype(dtype), torch.from_numpy(arr).to(getattr(torch, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_packed_plain_matches_pallas_interpret(monkeypatch, dtype):
    monkeypatch.setattr(jattn, "INTERPRET", True)
    b, n, c, heads = 1, 1024, 256, 2
    scale = (c // heads) ** -0.5
    arr = np.random.default_rng(0).standard_normal((b, n, 3 * c)).astype(np.float32)
    jq, tq = _pair(arr, dtype)
    ref = np.asarray(jattn.attention_qkv(jq, scale=scale, impl="pallas", num_heads=heads),
                     np.float32)
    out = tattn.flash_mha_packed(tq, heads, scale).float().numpy()
    assert out.shape == (b, n, c)
    if dtype == "float32":
        assert _rel(out, ref) <= FP32_REL
    else:
        np.testing.assert_allclose(out, ref, atol=BF16_TOL, rtol=BF16_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_single_head_plain_matches_reference(dtype):
    b, n, dq, dv = 2, 1600, 8, 64
    rng = np.random.default_rng(1)
    q, k, v = (rng.standard_normal((b, n, d)).astype(np.float32) for d in (dq, dq, dv))
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, k, v))
    out = tattn.flash_single(tq, tk, tv, 1.0).float().numpy()
    assert out.shape == (b, n, dv)
    # the Pallas kernel accumulates q.k^T in fp32 (preferred_element_type);
    # the JAX references round bf16 scores to bf16, an error of ~3% at
    # |s| ~ 8 with scale 1.0, so they run in fp32 on the bf16-rounded inputs
    jq, jk, jv = (t.astype(jnp.float32) for t in (jq, jk, jv))
    for ref_fn in (jattn.reference_attention, jattn.chunked_attention):
        ref = np.asarray(ref_fn(jq, jk, jv, 1.0), np.float32)
        if dtype == "float32":
            assert _rel(out, ref) <= FP32_REL
        else:
            np.testing.assert_allclose(out, ref, atol=BF16_TOL, rtol=BF16_TOL)


@pytest.mark.parametrize("n", [1024, 1040])
def test_qkv_routing_and_parity(monkeypatch, n):
    """N <= 1024 takes the naive route, larger maps the packed kernel (its
    plain version here); both agree with the JAX front end in fp32."""
    calls = []
    real = tattn.flash_mha_packed
    monkeypatch.setattr(tattn, "flash_mha_packed",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    b, c, heads = 1, 256, 2
    scale = (c // heads) ** -0.5
    arr = np.random.default_rng(2).standard_normal((b, n, 3 * c)).astype(np.float32)
    jq, tq = _pair(arr, "float32")
    out = tattn.attention_qkv(tq, scale=scale, num_heads=heads).numpy()
    ref = np.asarray(jattn.attention_qkv(jq, scale=scale, num_heads=heads))
    assert len(calls) == (1 if n > tattn.NAIVE_MAX_TOKENS else 0)
    assert _rel(out, ref) <= FP32_REL


@pytest.mark.parametrize("n", [1024, 1100])
def test_single_head_routing(monkeypatch, n):
    calls = []
    real = tattn.flash_single
    monkeypatch.setattr(tattn, "flash_single",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((1, n, d)).astype(np.float32) for d in (4, 4, 32))
    out = tattn.attention(*(torch.from_numpy(a) for a in (q, k, v)), scale=1.0).numpy()
    ref = np.asarray(jattn.attention(*(jnp.asarray(a) for a in (q, k, v)), scale=1.0))
    assert len(calls) == (1 if n > tattn.NAIVE_MAX_TOKENS else 0)
    assert _rel(out, ref) <= FP32_REL


def test_plain_impl_matches_default_on_cpu():
    arr = np.random.default_rng(4).standard_normal((1, 1100, 3 * 128)).astype(np.float32)
    t = torch.from_numpy(arr)
    a = tattn.attention_qkv(t, scale=0.1, num_heads=1)
    b = tattn.attention_qkv(t, scale=0.1, impl="plain", num_heads=1)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match="unknown attention impl"):
        tattn.attention_qkv(t, impl="chunked")


def test_wrappers_never_fall_back_off_cpu():
    """A tensor that is not on the CPU never reaches the plain version: the
    wrapper launches the kernel or raises (here on the meta device, before
    any library is built), and counts nothing, with the sm90 kernel the
    rule gives bf16 heads of 128 (csrc/flash_fwd_sm90.cu) as with the
    others. reset_launch_counts clears every counter, the sm90 kernel's
    too."""
    tattn.flash_mha_packed.launches = tattn.flash_mha_packed.sm90_launches = 3
    tattn.reset_launch_counts()
    assert tattn.flash_mha_packed.launches == 0 and tattn.flash_mha_packed.sm90_launches == 0
    qkv = torch.empty((1, 2048, 3 * 256), dtype=torch.bfloat16, device="meta")
    assert tattn.packed_fwd_form(128, qkv.dtype) == "sm90"
    with pytest.raises(ValueError, match="CUDA tensor"):
        tattn.flash_mha_packed(qkv, 2, 0.1)
    q = torch.empty((1, 2048, 64), dtype=torch.bfloat16, device="meta")
    v = torch.empty((1, 2048, 512), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        tattn.flash_single(q, q, v, 1.0)
    assert tattn.flash_mha_packed.launches == 0 and tattn.flash_single.sm90_launches == 0
    assert tattn.flash_mha_packed.sm90_launches == 0


def test_kernel_shape_support():
    """The phi='s' 640x640 shapes are kernel shapes (neck heads of 256, dark3
    dq 64 / dv 512), and so are the other scales': the packed kernel reads
    any head width that is a multiple of 8 in place (phi='n' heads of 128,
    phi='m' 384, phi='x' 3,584), the single-head wrapper takes any width
    (phi='n' h1's folded 283, zero-padded to 288); a head layout that does
    not divide C or a width that is not a multiple of 8 is refused by the
    packed kernel."""
    for c, heads in ((2048, 8), (1536, 6), (768, 6), (3072, 8), (28672, 8)):
        assert tattn.packed_kernel_supports(c, heads)
    for dq, dv in ((64, 512), (32, 256), (128, 1024), (283, 283), (599, 599), (64, 448)):
        assert tattn.single_kernel_supports(dq, dv)
    assert not tattn.packed_kernel_supports(849, 3)  # heads of 283
    assert not tattn.packed_kernel_supports(1536, 7)
    assert not tattn.single_kernel_supports(0, 256)
