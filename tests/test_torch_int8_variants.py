"""The int8 TEB's handoff variants in the PyTorch port against the JAX
package, on the CPU: the attention handoff (TOD_ATTN_HANDOFF), the attention
quant_out (TOD_ATTN_QOUT) and the w4a4 mlp1 (TOD_W4A4_MLP1).

The port's plain versions (what its wrappers run on CPU tensors) are held
against the JAX Pallas kernels run through the Pallas interpreter
(`attention_int8.INTERPRET` and `quant_matmul.INTERPRET` set, as
tests/test_attention_int8.py runs them; without them the JAX dispatch
returns None off a TPU and computes the dequantized fallback, another
function), on the same numpy-seeded inputs. Tolerances, those of the int8
port's other tests:
  * int8 payloads equal except +-1 on at most 1e-3 of the elements, scales
    1e-5 relative (a requantize, a row quantize: the same fp32 arithmetic);
  * attention outputs: the q/k/v integers are equal, only exp2 may differ
    in its last bit and move a rounded p by one, which moves its row by
    ~1e-3 of the output: values within 5e-3 of the output's largest
    magnitude (measured 1e-6); the int8 outputs to the payload and scale
    bars above, so the values they stand for differ by at most one payload
    step (amax / 127 of the row's head, up to 7.9e-3 of the largest);
  * the int8 TEB in fp32 within 1e-2 of the output's largest magnitude,
    the bar of the int8 TEB in tests/test_torch_blocks.py (it chains five or
    six quantizations, and one +-1 payload flip moves a row by ~1e-3 of its
    projection; measured up to 4.8e-3), in bf16 2e-2 (the JAX tests' bar);
  * with w4a4, the same bar on all but 1% of the rows (tokens), and 5e-2 on
    every row: the two sides' mlp1 inputs differ in their last bits, and an
    int4-range activation on a rounding boundary then lands one step of
    amax / 7 apart, which moves its row by 1-3e-2 (measured: 10 of 2,304
    rows past 5e-3, the largest at 2.3e-2). The w4a4 function itself, on
    equal inputs, is held to the payload bars above.
"""
from __future__ import annotations

import functools
import inspect
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import transparent_object_detection_tpu.ops.attention as jattn
import transparent_object_detection_tpu.ops.attention_int8 as ja8
import transparent_object_detection_tpu.ops.quant_matmul as jq
from _torch_parity import random_variables, rel_err, to_jax
from transparent_object_detection_tpu.models import blocks as jb
from transparent_object_detection_tpu.models import neck as jneck
from transparent_object_detection_tpu_torch.config import Int8Variants
from transparent_object_detection_tpu_torch.models import blocks as tb
from transparent_object_detection_tpu_torch.models import neck as tneck
from transparent_object_detection_tpu_torch.ops import attention_int8 as t8
from transparent_object_detection_tpu_torch.ops import quant_matmul as tq
from transparent_object_detection_tpu_torch.weights import load_jax_variables

torch.set_num_threads(1)

# (node, tokens, channels, heads) of the phi='s' 640x640 neck TEBs
NECK = (("h1", 1600, 2048, 8), ("h2", 6400, 1536, 6), ("h4", 1600, 1536, 6),
        ("h6", 400, 2048, 8))
VARIANT_ENV = ("TOD_ATTN_HANDOFF", "TOD_ATTN_QOUT", "TOD_W4A4_MLP1", "TOD_LN_HANDOFF",
               "TOD_LN_HANDOFF_MIN_ROWS")


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(ja8, "INTERPRET", True)
    monkeypatch.setattr(jq, "INTERPRET", True)
    monkeypatch.setattr(jattn, "INTERPRET", True)


def assert_payload_close(out, ref, share: float = 1e-3):
    diff = np.abs(np.asarray(out, np.int32) - np.asarray(ref, np.int32))
    assert diff.max() <= 1
    assert (diff > 0).mean() <= share


def assert_scales_close(out, ref, rtol: float = 1e-5):
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=rtol, atol=0)


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _dequant(payload, scales):
    p, s = np.asarray(_np(payload), np.float64), np.asarray(_np(scales), np.float64)
    g = p.shape[-1] // s.shape[-1]
    return (p.reshape(*p.shape[:-1], s.shape[-1], g) * s[..., None]).reshape(p.shape)


def assert_int8_output_close(out, ref):
    """An int8 output (payload, per-(row, group) scales): the payload and
    scale bars, and the values within one payload step of each other."""
    assert out[0].dtype == torch.int8 and tuple(out[1].shape) == tuple(ref[1].shape)
    assert_payload_close(_np(out[0]), ref[0])
    assert_scales_close(_np(out[1]), ref[1])
    step = np.repeat(np.asarray(ref[1], np.float64), out[0].shape[-1] // ref[1].shape[-1], -1)
    assert (np.abs(_dequant(*out) - _dequant(*ref)) <= 1.0001 * step).all()


# ---------------------------------------------------------------------------
# the gates
# ---------------------------------------------------------------------------


def test_variants_from_env_match_the_jax_gates(monkeypatch):
    """The defaults and the parsing are the JAX TEB's: each variable as it
    reads it (`os.environ.get(name, default) == "1"`, the row floor as an
    int), taken from its source."""
    src = inspect.getsource(jb.TransformerEncoderBlock)
    jax_defaults = dict(re.findall(r'os\.environ\.get\(\s*"(TOD_[A-Z0-9_]+)",\s*"([0-9]+)"\)',
                                   src))
    assert set(VARIANT_ENV) <= set(jax_defaults)
    for name in VARIANT_ENV:
        monkeypatch.delenv(name, raising=False)
    fields = dict(TOD_ATTN_HANDOFF="attn_handoff", TOD_ATTN_QOUT="attn_qout",
                  TOD_W4A4_MLP1="w4a4_mlp1", TOD_LN_HANDOFF="ln_handoff",
                  TOD_LN_HANDOFF_MIN_ROWS="ln_handoff_min_rows")
    default = Int8Variants.from_env()
    assert default == Int8Variants()
    for name, field in fields.items():
        want = (int(jax_defaults[name]) if name.endswith("ROWS")
                else jax_defaults[name] == "1")
        assert getattr(default, field) == want, name
    env = dict(TOD_ATTN_HANDOFF="1", TOD_ATTN_QOUT="true", TOD_W4A4_MLP1="1",
               TOD_LN_HANDOFF="0", TOD_LN_HANDOFF_MIN_ROWS="128")
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    assert Int8Variants.from_env() == Int8Variants(attn_handoff=True, attn_qout=False,
                                                   w4a4_mlp1=True, ln_handoff=False,
                                                   ln_handoff_min_rows=128)
    assert Int8Variants.from_env({}) == Int8Variants()


# ---------------------------------------------------------------------------
# quant_out alignment, w4a4
# ---------------------------------------------------------------------------


def _jax_qkv_group_width(m, c, dh):
    w = jax.ShapeDtypeStruct((c, 3 * c), jnp.float32)
    vec = lambda n: jax.ShapeDtypeStruct((n,), jnp.float32)
    fn = lambda x, w, b, g, bb: jq.quant_matmul(x, w, bias=b, ln_scale=g, ln_bias=bb,
                                                quant_out=True, quant_out_align=(c, dh))
    _, scales = jax.eval_shape(fn, jax.ShapeDtypeStruct((m, c), jnp.bfloat16), w, vec(3 * c),
                               vec(c), vec(c))
    return 3 * c // scales.shape[-1]


@pytest.mark.parametrize("batch", (1, 2, 4, 32))
def test_qkv_quant_out_groups_match_jax(interpret, batch):
    """The qkv projection's aligned quant_out groups at every neck shape, as
    the JAX dispatch gives them (read off its output shape, nothing
    computed)."""
    for _, tokens, c, heads in NECK:
        m, dh = batch * tokens, c // heads
        got = tq.quant_out_group_width(m, c, 3 * c, 0, align=(c, dh))
        assert got == _jax_qkv_group_width(m, c, dh), (batch, tokens, c)
        blocks = jq._pick_blocks(m, c, 3 * c, residual=False, out_bytes=1, align=(c, dh))
        assert got == (3 * c if blocks is None else blocks[1])


def test_qkv_quant_out_group_table():
    """h1: per row at batch 1 (1,600 rows), 512 (2 heads, G = 12) from
    batch 2; h2 and h4 full width (G = 1)."""
    g = lambda b, node: tq.quant_out_group_width(
        b * node[1], node[2], 3 * node[2], 0, align=(node[2], node[2] // node[3]))
    h1, h2, h4, _ = NECK
    assert [g(b, h1) for b in (1, 2, 32)] == [6144, 512, 512]
    assert [g(b, h2) for b in (1, 2, 32)] == [4608] * 3
    assert [g(b, h4) for b in (1, 2, 32)] == [4608] * 3


@pytest.mark.parametrize("ln", [False, True])
def test_quant_rows_qmax7_matches_pallas(ln):
    """quant_rows_plain(qmax=7) against _quant_rows_kernel(qmax=7) in the
    interpreter (the int4-range payload of w4a4, stored int8)."""
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.standard_normal((256, 384)).astype(np.float32) * 2 + 0.3,
                    jnp.bfloat16)
    q, s = pl.pallas_call(
        functools.partial(jq._quant_rows_kernel, ln=ln, ln_eps=1e-6, qmax=7.0),
        out_shape=[jax.ShapeDtypeStruct((256, 384), jnp.int8),
                   jax.ShapeDtypeStruct((256, 1), jnp.float32)],
        interpret=True,
    )(x)
    tx = torch.from_numpy(np.asarray(x, np.float32)).bfloat16()
    tqq, ts = tq.quant_rows(tx, ln, qmax=7)
    assert int(tqq.abs().max()) == 7
    assert_payload_close(tqq.numpy(), q)
    assert_scales_close(ts.numpy(), s)
    with pytest.raises(ValueError):
        tq.quant_rows(tx, ln, qmax=15)


@pytest.mark.parametrize("ln", [False, True])
@pytest.mark.parametrize("quant_out", [False, True])
def test_quant_matmul_w4a4_matches_jax(ln, quant_out):
    """Batched (2, 128, K) rows through the port's w4a4 and JAX's twin (the
    int4 dot needs a TPU; the twin computes the same integers)."""
    rng = np.random.default_rng(4)
    k, n = 256, 512
    x = rng.standard_normal((2, 128, k)).astype(np.float32) + 0.3
    w = (rng.standard_normal((k, n)) / k ** 0.5).astype(np.float32)
    bias, gamma, beta = (rng.standard_normal(s).astype(np.float32) * 0.1 for s in (n, k, k))
    gamma += 1.0
    kw = dict(bias=jnp.asarray(bias), act="gelu", out_dtype=jnp.float32, quant_out=quant_out)
    if ln:
        kw.update(ln_scale=jnp.asarray(gamma), ln_bias=jnp.asarray(beta))
    ref = jq.quant_matmul_w4a4(jnp.asarray(x), jnp.asarray(w), **kw)
    t = torch.from_numpy
    wts = (tq.prepare_weights4(t(w.T.copy()), t(bias), t(gamma), t(beta)) if ln
           else tq.prepare_weights4(t(w.T.copy()), t(bias)))
    assert int(wts["wq"].abs().max()) == 7
    wq_ref, ws_ref = jq.quantize_weights4(jq._fold_ln(jnp.asarray(w), None, jnp.asarray(gamma),
                                                      jnp.asarray(beta))[0] if ln
                                          else jnp.asarray(w))
    assert_payload_close(wts["wq"].numpy().T, np.asarray(wq_ref, np.int8), share=1e-4)
    assert_scales_close(wts["w_scale"].numpy(), np.asarray(ws_ref)[0])
    out = tq.quant_matmul_w4a4(t(x), wts, ln=ln, act="gelu", out_dtype=torch.float32,
                               quant_out=quant_out)
    if quant_out:
        assert tuple(out[1].shape) == (2, 128, 1)
        assert_int8_output_close(out, ref)
    else:
        assert rel_err(out.numpy(), ref) <= 5e-3
    assert tq.w4a4_supported(256, 1536, 6144) and not tq.w4a4_supported(1600, 1536, 6144)


# ---------------------------------------------------------------------------
# attention variants
# ---------------------------------------------------------------------------


def _qkv8(rng, b, n, c, groups):
    """A random int8 qkv payload (B, N, 3C) with per-(row, group) scales
    sized for logits of std ~2 at head width 128."""
    payload = rng.integers(-127, 128, size=(b, n, 3 * c)).astype(np.int8)
    scales = rng.uniform(0.01, 0.03, size=(b, n, groups)).astype(np.float32)
    return payload, scales


@pytest.mark.parametrize("groups", [1, 6])
@pytest.mark.parametrize("block_k", [64, 256])
def test_requantize_section_matches_jax(groups, block_k):
    """k and v onto per-(batch, head, key block) scalars, from one scale per
    row (G = 1) and from one per head (g = dh)."""
    b, n, c, h = 2, 256, 256, 2
    payload, scales = _qkv8(np.random.default_rng(5), b, n, c, groups)
    for col0 in (c, 2 * c):
        ref = ja8._requantize_section(jnp.asarray(payload), jnp.asarray(scales), col0, c, h,
                                      block_k)
        out = t8.requantize_section(torch.from_numpy(payload), torch.from_numpy(scales), col0,
                                    c, h, block_k)
        assert out[0].dtype == torch.int8 and tuple(out[1].shape) == (b, h, n // block_k)
        assert_payload_close(out[0].numpy(), ref[0])
        assert_scales_close(out[1].numpy(), ref[1])


@pytest.mark.parametrize("quant_out", [True, False])
@pytest.mark.parametrize("groups", [1, 3, 6])
def test_teb_attention_handoff_matches_pallas(interpret, quant_out, groups):
    """The handoff kernel in the interpreter against the port's plain
    version: two heads of 128 with one scale per row (G = 1), per two heads
    (G = 3, g = 256, as h1's groups of 512 cover two heads of 256) and per
    head (G = 6, g = dh)."""
    b, n, c, h = 2, 512, 256, 2
    payload, scales = _qkv8(np.random.default_rng(6), b, n, c, groups)
    scale = (c // h) ** -0.5
    ref = ja8.teb_attention_handoff(jnp.asarray(payload), jnp.asarray(scales), h, scale,
                                    quant_out=quant_out, out_dtype=jnp.float32)
    out = t8.teb_attention_handoff(torch.from_numpy(payload), torch.from_numpy(scales), h,
                                   scale, quant_out=quant_out, out_dtype=torch.float32)
    assert ref is not None and out is not None
    if quant_out:
        assert tuple(out[1].shape) == (b, n, h)
        assert_int8_output_close(out, ref)
    else:
        assert out.dtype == torch.float32
        assert rel_err(out.numpy(), ref) <= 5e-3


@pytest.mark.parametrize("n,groups", [(512, 12), (512, 4), (100, 1)])
def test_teb_attention_handoff_none(interpret, n, groups):
    """None, on both sides, where scale groups split a head (g = 64 < dh,
    g = 192 not a multiple of dh) or `pick_blocks` rejects N."""
    payload, scales = _qkv8(np.random.default_rng(7), 1, n, 256, groups)
    args = (2, 128 ** -0.5)
    assert ja8.teb_attention_handoff(jnp.asarray(payload), jnp.asarray(scales), *args) is None
    assert t8.teb_attention_handoff(torch.from_numpy(payload), torch.from_numpy(scales),
                                    *args) is None


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_int8_quant_out_matches_pallas(interpret, dtype):
    """q, k and v read in place from one packed qkv on the port's side, split
    on JAX's (a copy, not part of the function)."""
    b, n, c, h = 2, 512, 256, 2
    rng = np.random.default_rng(8)
    qkv = rng.standard_normal((b, n, 3 * c)).astype(np.float32)
    qkv[..., :2 * c] *= 1.5
    jqkv = jnp.asarray(qkv).astype(dtype)
    tqkv = torch.from_numpy(np.asarray(jqkv.astype(jnp.float32))).to(getattr(torch, dtype))
    scale = (c // h) ** -0.5
    ref = ja8.attention_int8_quant_out(*jnp.split(jqkv, 3, axis=-1), scale=scale, num_heads=h)
    out = t8.attention_int8_quant_out(tqkv, tqkv[..., c:2 * c], tqkv[..., 2 * c:], scale, h,
                                      q_width=c)
    assert_int8_output_close(out, ref)
    assert t8.attention_int8_quant_out(tqkv[:, :100], tqkv[:, :100, c:2 * c],
                                       tqkv[:, :100, 2 * c:], scale, h, q_width=c) is None


# ---------------------------------------------------------------------------
# the int8 TEB with each variant
# ---------------------------------------------------------------------------


def assert_teb_close(out, ref, bar: float, int4_rows: bool) -> None:
    """Within `bar` of the output's largest magnitude; with int4_rows, all
    but 1% of the pixels (rows of the TEB) and every pixel within 5e-2."""
    if not int4_rows:
        assert rel_err(out, ref) <= bar
        return
    rows = np.abs(out - ref).max(-1) / np.abs(ref).max()
    assert rows.max() <= 5e-2
    assert (rows > bar).mean() <= 0.01


def _run_pair(jmod, tmod, shape, dtype):
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


# name -> (TOD_* set to "1", input (B, H, W, C), dtype, bar). 48 x 48 = 2,304
# tokens (a multiple of 128, so w4a4's gate opens at batch 1), 128 channels
# (one head of 128); 34 x 34 = 1,156 tokens: pick_blocks rejects N, so the
# handoff returns None and the block dequantizes onto the bf16 route.
TEB_CASES = {
    "attn_handoff": (("TOD_ATTN_HANDOFF",), (1, 48, 48, 128), jnp.float32, 1e-2),
    "attn_qout": (("TOD_ATTN_QOUT",), (1, 48, 48, 128), jnp.float32, 1e-2),
    "w4a4_mlp1": (("TOD_W4A4_MLP1",), (1, 48, 48, 128), jnp.float32, 1e-2),
    "attn_handoff_w4a4": (("TOD_ATTN_HANDOFF", "TOD_W4A4_MLP1"), (1, 48, 48, 128),
                          jnp.float32, 1e-2),
    "attn_qout_bf16": (("TOD_ATTN_QOUT",), (1, 48, 48, 128), jnp.bfloat16, 2e-2),
    "attn_handoff_fallback": (("TOD_ATTN_HANDOFF",), (1, 34, 34, 128), jnp.float32, 1e-2),
}


@pytest.mark.parametrize("case", sorted(TEB_CASES))
def test_int8_teb_variant_matches_flax(case, interpret, monkeypatch):
    """The int8 TEB (int8_dense + int8_attn) with the variant switched on
    through the TOD_* variables on both sides; the port reads them once,
    when the block is built."""
    names, shape, dtype, bar = TEB_CASES[case]
    for name in VARIANT_ENV:
        monkeypatch.delenv(name, raising=False)
    for name in names:
        monkeypatch.setenv(name, "1")
    jdt = jnp.dtype(dtype)
    kw = dict(int8_dense=True, int8_attn=True)
    jmod = jb.TransformerEncoderBlock(num_heads=8, dtype=jdt, attention_impl="pallas", **kw)
    tmod = tb.TransformerEncoderBlock(shape[-1], 8, dtype=getattr(torch, jdt.name), **kw)
    assert tmod.heads == 1 and tmod.int8_variants == Int8Variants.from_env()
    out, ref = _run_pair(jmod, tmod, shape, dtype)
    assert_teb_close(out, ref, bar, int4_rows="TOD_W4A4_MLP1" in names)


def test_variant_routes_and_plain_routes(monkeypatch):
    """Each variant takes its route in the port (the wrappers count their
    CPU calls nowhere, so the routes are read through the plain functions
    the block calls), and impl="plain" takes the same routes."""
    calls = []
    for mod, name in ((t8, "flash_int8_handoff_plain"), (t8, "flash_mha_int8_qout_plain"),
                      (t8, "flash_mha_int8_plain"), (tq, "quant_rows_plain")):
        real = getattr(mod, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls.append((_name, kw.get("qmax", a[3] if len(a) > 3 else 127)
                          if _name == "quant_rows_plain" else None))
            return _real(*a, **kw)
        monkeypatch.setattr(mod, name, spy)
    x = torch.randn(1, 128, 48, 48)
    for variants, want in ((Int8Variants(attn_handoff=True), "flash_int8_handoff_plain"),
                           (Int8Variants(attn_qout=True), "flash_mha_int8_qout_plain"),
                           (Int8Variants(), "flash_mha_int8_plain")):
        for impl in (None, "plain"):
            calls.clear()
            teb = tb.TransformerEncoderBlock(128, 8, dtype=torch.float32, int8_dense=True,
                                             int8_attn=True, attention_impl=impl,
                                             int8_variants=variants).eval()
            with torch.no_grad():
                teb(x)
            names = [c[0] for c in calls]
            assert names.count(want) == 1, (variants, impl, names)
    calls.clear()
    teb = tb.TransformerEncoderBlock(128, 8, dtype=torch.float32, int8_dense=True,
                                     int8_variants=Int8Variants(w4a4_mlp1=True)).eval()
    with torch.no_grad():
        teb(x)
    assert [q for name, q in calls if name == "quant_rows_plain"].count(7) == 1


def test_fusion_node_with_variants_matches_flax(interpret, monkeypatch):
    """The h2 FusionNode (TEB -> reduce -> CBAM) of a narrow model at 40 x 40
    (1,600 tokens, 384 channels: 3 heads of 128) and batch 2 (3,200 rows,
    so w4a4 opens), with the attention handoff and w4a4 on: the slice-level
    check (a whole FocusModel reaching these routes would need a 320 x 320
    input, beyond the interpreter's time here)."""
    for name in VARIANT_ENV:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("TOD_ATTN_HANDOFF", "1")
    monkeypatch.setenv("TOD_W4A4_MLP1", "1")
    kw = dict(int8_dense=True, int8_attn=True)
    jmod = jneck.FusionNode(128, dtype=jnp.float32, **kw)
    tmod = tneck.FusionNode(384, 128, dtype=torch.float32, **kw)
    assert tmod.teb.heads == 3
    out, ref = _run_pair(jmod, tmod, (2, 40, 40, 384), jnp.float32)
    # the TEB's bar; CBAM's 7 x 7 spatial gate spreads a w4a4 row over its
    # neighbours (measured 6 of 3,200 pixels past 1e-2, the largest 1.4e-2)
    assert_teb_close(out, ref, 1e-2, int4_rows=True)
