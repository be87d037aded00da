"""int8 flash attention of the PyTorch port (ops/attention_int8.py) against
the JAX package, on the CPU.

The port's plain version (what its wrapper runs on CPU tensors) is held
against `_mha_flash_int8_kernel` run through the Pallas interpreter
(`attention_int8.INTERPRET`, as tests/test_attention_int8.py runs it), on
the same numpy-seeded inputs. The q/k/v payloads and scores are the same
integers on both sides; only exp2 may differ in its last bit, which can move
a rounded p by one. Tolerances: k/v payloads equal and scales within 1e-6
relative; fp32 outputs within 5e-3 of the output's largest magnitude (a p
rounded the other way moves its row by |v| / l, ~1e-3 of the output on
near-flat rows; measured 4e-7 to 1.7e-3), bf16 outputs 1e-2 (bf16
rounding; measured up to 3.9e-3). The block rule `pick_blocks` must equal JAX's at every
shape of the phi='s' 640x640 path.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import transparent_object_detection_tpu.ops.attention as jattn
import transparent_object_detection_tpu.ops.attention_int8 as a8
from _torch_parity import rel_err
from transparent_object_detection_tpu_torch.ops import attention as tattn
from transparent_object_detection_tpu_torch.ops import attention_int8 as t8

torch.set_num_threads(1)

FP32_REL, BF16_REL = 5e-3, 1e-2


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(a8, "INTERPRET", True)


def _pair(arr: np.ndarray, dtype: str):
    return jnp.asarray(arr).astype(dtype), torch.from_numpy(arr).to(getattr(torch, dtype))


def _to_np(t):
    return np.asarray(t, np.float32) if not isinstance(t, torch.Tensor) else t.float().numpy()


def test_pick_blocks_matches_jax():
    shapes = [(1600, 2048, 8, None), (6400, 1536, 6, None), (1600, 1536, 6, None),
              (400, 2048, 8, None), (6400, 64, 1, 512), (3600, 1536, 6, None),
              (3600, 64, 1, 512), (25600, 1536, 6, None), (1600, 256, 2, None),
              (1600, 32, 1, 256), (1156, 256, 2, None), (6400, 128, 1, 1024)]
    for n, cq, h, cv in shapes:
        assert t8.pick_blocks(n, cq, h, cv=cv) == a8.pick_blocks(n, cq, h, cv=cv), (n, cq, h, cv)
    # the serving path's blocks: k/v scales over the full token axis
    assert t8.pick_blocks(1600, 2048, 8) == (320, 1600)
    assert t8.pick_blocks(6400, 1536, 6) == (320, 6400)
    assert t8.pick_blocks(6400, 64, 1, cv=512) == (256, 6400)
    assert t8.pick_blocks(3600, 1536, 6) is None


def test_quantize_kv_matches_jax():
    x = np.random.default_rng(0).standard_normal((2, 256, 256)).astype(np.float32) * 3
    jx, tx = _pair(x, "bfloat16")
    q_ref, s_ref = a8._quantize_kv(jx, 2, 64)
    q, s = t8.quantize_kv(tx, 2, 64)
    assert tuple(s.shape) == s_ref.shape == (2, 2, 4)
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref))
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), rtol=1e-6, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("blocks", [(64, 128), (128, 512)])
def test_plain_matches_pallas_interpret(interpret, dtype, blocks):
    """Several key blocks (running max across blocks) and one block."""
    b, n, heads, dh = 2, 512, 2, 128
    c = heads * dh
    rng = np.random.default_rng(1)
    q, k, v = (rng.standard_normal((b, n, c)).astype(np.float32) * s for s in (1.5, 1.5, 1.0))
    (jq, tq), (jk, tk), (jv, tv) = _pair(q, dtype), _pair(k, dtype), _pair(v, dtype)
    scale = dh ** -0.5
    ref = a8.flash_attention_mha_int8(jq, jk, jv, heads, scale, *blocks)
    kq, ks = t8.quantize_kv(tk, heads, blocks[1])
    vq, vs = t8.quantize_kv(tv, heads, blocks[1])
    out = t8.flash_mha_int8(tq, kq, ks, vq, vs, heads, scale)
    assert out.dtype == getattr(torch, dtype) and tuple(out.shape) == (b, n, c)
    assert rel_err(_to_np(out), _to_np(ref)) <= (FP32_REL if dtype == "float32" else BF16_REL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_packed_route_matches_jax(interpret, dtype):
    """attention_qkv(int8=True) at N = 1600 (40 x 40): q read in place from
    the packed array, k/v quantized from its sections, bk = N."""
    b, n, heads, dh = 1, 1600, 2, 128
    c = heads * dh
    qkv = np.random.default_rng(2).standard_normal((b, n, 3 * c)).astype(np.float32)
    jx, tx = _pair(qkv, dtype)
    ref = jattn.attention_qkv(jx, scale=dh ** -0.5, impl="pallas", num_heads=heads, int8=True)
    out = tattn.attention_qkv(tx, scale=dh ** -0.5, num_heads=heads, int8=True)
    assert rel_err(_to_np(out), _to_np(ref)) <= (FP32_REL if dtype == "float32" else BF16_REL)


def test_single_head_route_matches_jax(interpret):
    """The SelfAttention shape class: q/k width C/8, v width C, scale 1."""
    b, n, dq, dv = 1, 1600, 32, 256
    rng = np.random.default_rng(3)
    q, k = (rng.standard_normal((b, n, dq)).astype(np.float32) * 0.7 for _ in range(2))
    v = rng.standard_normal((b, n, dv)).astype(np.float32)
    ref = jattn.attention(*(jnp.asarray(a) for a in (q, k, v)), scale=1.0, impl="pallas",
                          int8=True)
    out = tattn.attention(*(torch.from_numpy(a) for a in (q, k, v)), scale=1.0, int8=True)
    assert rel_err(out.numpy(), _to_np(ref)) <= FP32_REL


def test_int8_routing():
    """int8 takes its route only where pick_blocks tiles and N > 1024; a
    ragged N (3,600, a 480x480 input's P3) and N <= 1024 keep the bf16
    routes, as in JAX."""
    rng = np.random.default_rng(4)
    for n in (3600, 1024):
        qkv = torch.from_numpy(rng.standard_normal((1, n, 768)).astype(np.float32))
        np.testing.assert_array_equal(
            tattn.attention_qkv(qkv, 0.1, num_heads=2, int8=True).numpy(),
            tattn.attention_qkv(qkv, 0.1, num_heads=2).numpy())
    qkv = torch.from_numpy(rng.standard_normal((1, 1600, 768)).astype(np.float32))
    assert not torch.equal(tattn.attention_qkv(qkv, 0.1, num_heads=2, int8=True),
                           tattn.attention_qkv(qkv, 0.1, num_heads=2))
