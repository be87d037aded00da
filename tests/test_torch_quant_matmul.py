"""int8 projections of the PyTorch port (ops/quant_matmul.py) against the JAX
package, on the CPU.

The port's plain versions (what its wrappers run on CPU tensors) are held
against the JAX Pallas kernels run through the Pallas interpreter
(`quant_matmul.INTERPRET`, as tests/test_quant_matmul.py runs them), on the
same numpy-seeded inputs, with m a multiple of 128 so that the JAX dispatch
reaches its kernel. Tolerances, stated per check:
  * int8 payloads: equal, except +-1 on at most 1e-3 of the elements (the
    two frameworks sum the LN statistics in different orders, which moves
    a value sitting on a rounding boundary);
  * scales: 1e-5 relative; scales and payloads of an output (quant_out,
    ln_out) inherit the output's bar: 5e-3 relative, and +-1 on at most 1%
    of the elements;
  * fp32 outputs: within 5e-3 of the output's largest magnitude (the same
    integer sums, dequantized in the same order, but one +-1 payload flip
    moves a whole row by ~1e-3 of it: measured 9.5e-4), and all but 2% of
    the elements within 1e-5 of it; bf16 outputs: 1e-2 (one bf16 ulp is
    2^-8 of a value).
The routing rules (`quant_out_group_width`, `ln_handoff`, `prefer_split`)
must equal JAX's at every shape of the phi='s' 640x640 neck at batch 1, 2,
4 and 32; the group width is read off the JAX dispatch's own output shape
(`jax.eval_shape`, nothing computed).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import transparent_object_detection_tpu.ops.quant_matmul as jq
from _torch_parity import rel_err
from transparent_object_detection_tpu_torch.ops import quant_matmul as tq

torch.set_num_threads(1)

# (node, tokens, channels) of the phi='s' 640x640 neck TEBs
NECK = (("h1", 1600, 2048), ("h2", 6400, 1536), ("h4", 1600, 1536), ("h6", 400, 2048))
BATCHES = (1, 2, 4, 32)
M, K, N = 256, 256, 512


def assert_out_close(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    rel = np.abs(out - ref) / np.abs(ref).max()
    assert rel.max() <= 5e-3
    assert (rel > 1e-5).mean() <= 0.02


def assert_payload_close(out, ref, share: float = 1e-3):
    diff = np.abs(np.asarray(out, np.int32) - np.asarray(ref, np.int32))
    assert diff.max() <= 1
    assert (diff > 0).mean() <= share


def assert_scales_close(out, ref, rtol: float = 1e-5):
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=rtol, atol=0)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    f = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)
    return dict(x=f(M, K) + 0.3, w=f(K, N, scale=K ** -0.5), bias=f(N, scale=0.1),
                gamma=1.0 + f(K, scale=0.1), beta=f(K, scale=0.1), res=f(M, N),
                w2=f(N, K, scale=N ** -0.5), bias2=f(K, scale=0.1))


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(jq, "INTERPRET", True)


def _port_weights(d, ln: bool, second: bool = False):
    w, b = (d["w2"], d["bias2"]) if second else (d["w"], d["bias"])
    t = lambda a: torch.from_numpy(a)
    if ln:
        return tq.prepare_weights(t(w.T.copy()), t(b), t(d["gamma"]), t(d["beta"]))
    return tq.prepare_weights(t(w.T.copy()), t(b))


def test_weights_fold_and_quantize_match_jax(data):
    w_eff, b_eff = jq._fold_ln(jnp.asarray(data["w"]), jnp.asarray(data["bias"]),
                               jnp.asarray(data["gamma"]), jnp.asarray(data["beta"]))
    wq, ws = jq.quantize_weights(w_eff)
    port = _port_weights(data, ln=True)
    assert_payload_close(port["wq"].numpy().T, wq, share=1e-4)
    assert_scales_close(port["w_scale"].numpy(), np.asarray(ws)[0])
    np.testing.assert_allclose(port["bias"].numpy(), np.asarray(b_eff), rtol=1e-5, atol=1e-6)


# (ln, rows' type, K, qmax): bf16 rows of the neck's widths (the first two,
# ids kept), fp32 rows (the fp32 models), K off the 8 and 16 grids (phi='n''s
# 849, rows starting at any byte) and the int4 range of w4a4 (qmax 7)
QUANT_ROWS_CASES = [
    pytest.param(False, "bfloat16", K, 127, id="False"),
    pytest.param(True, "bfloat16", K, 127, id="True"),
    pytest.param(False, "float32", K, 127, id="float32-False"),
    pytest.param(True, "float32", K, 127, id="float32-True"),
    pytest.param(True, "bfloat16", 849, 127, id="k849-True"),
    pytest.param(False, "float32", 849, 127, id="float32-k849-False"),
    pytest.param(True, "float32", 849, 127, id="float32-k849-True"),
    pytest.param(True, "bfloat16", K, 7, id="qmax7-True"),
    pytest.param(False, "float32", 849, 7, id="float32-k849-qmax7-False"),
]


@pytest.mark.parametrize("ln,dtype,k,qmax", QUANT_ROWS_CASES)
def test_quant_rows_matches_pallas(data, ln, dtype, k, qmax):
    """Port of _quant_rows_kernel against the kernel in the interpreter, on
    bf16 or fp32 rows of K = 256 or 849, with qmax 127 or 7 (each time with
    and without the LayerNorm on some case); the rows of the 849-wide cases
    are drawn anew (same seed rule), the others are the module's."""
    x = data["x"] if k == K else (
        np.random.default_rng(k).standard_normal((M, k)).astype(np.float32) * 2 + 0.3)
    jx = jnp.asarray(x.astype(jnp.bfloat16) if dtype == "bfloat16" else x)
    q, s = pl.pallas_call(
        functools.partial(jq._quant_rows_kernel, ln=ln, ln_eps=1e-6, qmax=float(qmax)),
        out_shape=[jax.ShapeDtypeStruct((M, k), jnp.int8),
                   jax.ShapeDtypeStruct((M, 1), jnp.float32)],
        interpret=True,
    )(jx)
    tx = torch.from_numpy(np.asarray(jx, np.float32)).to(getattr(torch, dtype))
    tqq, ts = tq.quant_rows(tx, ln, qmax=qmax)
    assert tqq.dtype == torch.int8 and tuple(ts.shape) == (M, 1)
    assert int(tqq.abs().max()) <= qmax
    assert_payload_close(tqq.numpy(), q)
    assert_scales_close(ts.numpy(), s)


@pytest.mark.parametrize("elem_bytes", [2, 4])
def test_quant_rows_team_covers_rows(elem_bytes):
    """csrc/quant_matmul.cu's quant_rows team rule (`quant_rows_team`): for
    every width from 1 to 9,000 columns and the widths of the int8 routes
    (849 to 28,672), the team's threads hold every 16-element unit the row
    spans, aligned in the flattened array (the rule counts one more than
    the row's own where K is off the 16 grid): 4 units a thread in bf16, 2
    in fp32, on the smallest team of 8 to 256 threads (a power of two) that
    covers the row; past 256 threads more units, at most 64 registers of
    row a thread; rows no team holds are streamed (0 units)."""
    base, upt_max = (2, 4) if elem_bytes == 4 else (4, 8)
    for k in [*range(1, 9001), 12288, 19168, 28672, 40000]:
        team, upt = tq.quant_rows_team(k, elem_bytes)
        # the units row r spans in the flat (m, k) array, worst case over r
        span = max(((r + 1) * k - 1) // 16 - (r * k) // 16 + 1 for r in range(16))
        units = -(-k // 16) + (k % 16 > 0)  # the rule's count, at least the span
        assert span <= units, k
        assert team in (8, 16, 32, 64, 128, 256), k
        if upt == 0:
            assert team == 256 and 256 * upt_max < units, k
            continue
        assert upt in (1, 2, 4, 8) and base <= upt <= upt_max and team * upt >= units, k
        if upt == base:
            assert team == 8 or (team // 2) * base < units, k
        else:
            assert team == 256 and 256 * (upt // 2) < units, k


@pytest.mark.parametrize("ln,act,residual", [(True, None, False), (False, None, True),
                                             (True, "gelu", False), (True, "gelu", True),
                                             (False, "silu", False)])
def test_bf16_input_matches_pallas(data, interpret, ln, act, residual):
    """groups=0: the fused JAX kernel (LN, quantize prologue, epilogue)."""
    kw = dict(bias=jnp.asarray(data["bias"]), act=act, out_dtype=jnp.float32)
    if ln:
        kw.update(ln_scale=jnp.asarray(data["gamma"]), ln_bias=jnp.asarray(data["beta"]))
    if residual:
        kw.update(residual=jnp.asarray(data["res"]))
    ref = jq.quant_matmul(jnp.asarray(data["x"]), jnp.asarray(data["w"]), **kw)
    out = tq.quant_matmul(torch.from_numpy(data["x"]), _port_weights(data, ln), ln=ln, act=act,
                          residual=torch.from_numpy(data["res"]) if residual else None,
                          out_dtype=torch.float32)
    assert_out_close(out.numpy(), ref)


def test_bf16_io_matches_pallas(data, interpret):
    """bf16 activations, residual and output, as on the serving path."""
    x = jnp.asarray(data["x"]).astype(jnp.bfloat16)
    res = jnp.asarray(data["res"]).astype(jnp.bfloat16)
    ref = jq.quant_matmul(x, jnp.asarray(data["w"]), bias=jnp.asarray(data["bias"]),
                          ln_scale=jnp.asarray(data["gamma"]), ln_bias=jnp.asarray(data["beta"]),
                          act="gelu", residual=res)
    to_t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).bfloat16()
    out = tq.quant_matmul(to_t(x), _port_weights(data, True), ln=True, act="gelu",
                          residual=to_t(res))
    assert out.dtype == torch.bfloat16
    assert rel_err(out.float().numpy(), np.asarray(ref, np.float32)) <= 1e-2


@pytest.mark.parametrize("groups", [1, 2])
def test_int8_input_matches_pallas(data, interpret, groups):
    """x_quant with per-row (G=1) and per-(row, group) (G=2, the requantize
    prologue) scales; the JAX kernel takes the second weight (K=512)."""
    rng = np.random.default_rng(1)
    payload = rng.integers(-127, 128, size=(M, N)).astype(np.int8)
    scales = rng.uniform(0.01, 0.05, size=(M, groups)).astype(np.float32)
    ref = jq.quant_matmul(None, jnp.asarray(data["w2"]), bias=jnp.asarray(data["bias2"]),
                          residual=jnp.asarray(data["res"][:, :K]), out_dtype=jnp.float32,
                          x_quant=(jnp.asarray(payload), jnp.asarray(scales)))
    out = tq.quant_matmul(None, _port_weights(data, False, second=True),
                          residual=torch.from_numpy(data["res"][:, :K].copy()),
                          out_dtype=torch.float32,
                          x_quant=(torch.from_numpy(payload), torch.from_numpy(scales)))
    assert_out_close(out.numpy(), ref)


@pytest.mark.parametrize("group", [256, 512])
def test_quant_out_matches_pallas(data, interpret, group):
    """quant_out at a group narrower than N and at N: the JAX kernel at
    bn = group, against the port's qmm at the same group width."""
    x = jnp.asarray(data["x"])
    w_eff, b_eff = jq._fold_ln(jnp.asarray(data["w"]), jnp.asarray(data["bias"]),
                               jnp.asarray(data["gamma"]), jnp.asarray(data["beta"]))
    wq, ws = jq.quantize_weights(w_eff)
    payload, scales = jq._qmm_call(
        x, None, wq, ws, b_eff, None, out_dtype=jnp.float32, bm=128, bn=group, ln=True,
        act="gelu", residual=False, ln_eps=1e-6, quant_out=True)
    wts = _port_weights(data, True)
    xq, xs = tq.quant_rows(torch.from_numpy(data["x"]), True)
    tp, ts = tq.qmm(xq, xs, wts["wq"], wts["w_scale"], wts["bias"], act="gelu",
                    quant_out_group=group)
    assert tuple(ts.shape) == (M, N // group) == scales.shape
    assert_payload_close(tp.numpy(), payload, share=1e-2)
    assert_scales_close(ts.numpy(), scales, rtol=5e-3)


def test_ln_out_matches_pallas(data, interpret):
    """ln_quant_out: value, LN-normalized payload and per-row scale."""
    ref = jq.quant_matmul(jnp.asarray(data["x"]), jnp.asarray(data["w"]),
                          bias=jnp.asarray(data["bias"]), residual=jnp.asarray(data["res"]),
                          out_dtype=jnp.float32, ln_quant_out=True)
    out = tq.quant_matmul(torch.from_numpy(data["x"]), _port_weights(data, False),
                          residual=torch.from_numpy(data["res"]), out_dtype=torch.float32,
                          ln_quant_out=True)
    assert_out_close(out[0].numpy(), ref[0])
    assert_payload_close(out[1].numpy(), ref[1], share=1e-2)
    assert_scales_close(out[2].numpy(), ref[2], rtol=5e-3)


def test_split_route_matches_pallas(interpret):
    """The JAX split route (_pquant_call: quant pass + plain int8 dot) on a
    qkv-shaped projection, against the port's quant_rows + qmm."""
    rng = np.random.default_rng(2)
    m, k = 512, 128
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, 3 * k)) / np.sqrt(k)).astype(np.float32)
    b = (rng.standard_normal(3 * k) * 0.1).astype(np.float32)
    wq, ws = jq.quantize_weights(jnp.asarray(w))
    ref = jq._pquant_call(jnp.asarray(x), wq, ws, jnp.asarray(b), out_dtype=jnp.float32,
                          ln=True, act=None, ln_eps=1e-6)
    wts = tq.prepare_weights(torch.from_numpy(w.T.copy()), torch.from_numpy(b))
    xq, xs = tq.quant_rows(torch.from_numpy(x), True)
    out = tq.qmm(xq, xs, wts["wq"], wts["w_scale"], wts["bias"], out_dtype=torch.float32)
    assert_out_close(out.numpy(), ref)


def test_dequantize_matches_jax():
    rng = np.random.default_rng(3)
    p = rng.integers(-127, 128, size=(2, 5, 512)).astype(np.int8)
    s = rng.uniform(0.1, 1.0, size=(2, 5, 4)).astype(np.float32)
    ref = jq.dequantize(jnp.asarray(p), jnp.asarray(s), jnp.float32)
    out = tq.dequantize(torch.from_numpy(p), torch.from_numpy(s), torch.float32)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def _jax_group_width(m, k, n, x_quant: bool) -> int:
    """The scale-group width of a JAX quant_out call, from its output shape."""
    w = jax.ShapeDtypeStruct((k, n), jnp.float32)
    vec = lambda d: jax.ShapeDtypeStruct((d,), jnp.float32)
    if x_quant:
        fn = lambda p, s, w, b, g, bb: jq.quant_matmul(
            None, w, bias=b, ln_scale=g, ln_bias=bb, act="gelu", quant_out=True,
            x_quant=(p, s), x_quant_normalized=True)
        args = (jax.ShapeDtypeStruct((m, k), jnp.int8), jax.ShapeDtypeStruct((m, 1), jnp.float32))
    else:
        fn = lambda x, w, b, g, bb: jq.quant_matmul(
            x, w, bias=b, ln_scale=g, ln_bias=bb, act="gelu", quant_out=True)
        args = (jax.ShapeDtypeStruct((m, k), jnp.bfloat16),)
    _, scales = jax.eval_shape(fn, *args, w, vec(n), vec(k), vec(k))
    return n // scales.shape[-1]


@pytest.mark.parametrize("batch", BATCHES)
def test_routing_rules_match_jax(interpret, batch):
    for _, tokens, c in NECK:
        m = batch * tokens
        for groups_in in (0, 1):
            assert tq.quant_out_group_width(m, c, 4 * c, groups_in) == \
                _jax_group_width(m, c, 4 * c, x_quant=groups_in == 1), (m, c, groups_in)
        assert tq.ln_handoff(m, c) == (m >= 51200 and jq.ln_quant_out_supported(m, c, c))
        assert tq.prefer_split(m, c, 3 * c, True, None, None) == \
            jq._prefer_split(m, c, 3 * c, True, None, None)


def test_group_width_table():
    """The mlp1 quant_out group widths of the phi='s' 640x640 neck: per row
    at batch 1, 512 at h1 from batch 2, 512 at h6 at batch 32; the LN
    handoff at batch 32 on h1, h2, h4 only."""
    g = lambda b, node, gin=0: tq.quant_out_group_width(
        b * dict((x[0], x[1]) for x in NECK)[node], dict((x[0], x[2]) for x in NECK)[node],
        4 * dict((x[0], x[2]) for x in NECK)[node], gin)
    assert [g(1, nd) for nd in ("h1", "h2", "h4", "h6")] == [8192, 6144, 6144, 8192]
    assert [g(2, nd) for nd in ("h1", "h2", "h4", "h6")] == [512, 6144, 6144, 8192]
    assert [g(32, nd, 1) for nd in ("h1", "h2", "h4")] + [g(32, "h6")] == [512, 6144, 6144, 512]
    assert [tq.ln_handoff(32 * t, c) for _, t, c in NECK] == [True, True, True, False]
    assert not any(tq.ln_handoff(2 * t, c) for _, t, c in NECK)


def _quant_rows_emulated(x: np.ndarray, itemsize: int, ln: bool, qmax: int, eps: float = 1e-6):
    """csrc/quant_matmul.cu's quant_rows walked as its threads walk the
    flattened (m, k) array: each row's 16-element units (aligned in the flat
    array, so a row off the 16 grid starts mid-unit), a unit's 16-byte
    pieces (of `itemsize`-byte elements)
    loaded only where they hold an element of the row, the row's
    elements masked inside each unit, a whole unit stored at once and a
    straddling one byte by byte. Returns the payload, the scales, the
    number of times each output byte was written and the largest 16-byte
    granule of x read."""
    m, k = x.shape
    per = 16 // itemsize  # elements a 16-byte piece
    flat = x.reshape(-1)
    out = np.zeros(m * k, np.int8)
    writes = np.zeros(m * k, np.int64)
    scales = np.zeros((m, 1), np.float32)
    top_granule = -1
    for r in range(m):
        lo, hi = r * k, (r + 1) * k
        units = []
        for u in range(lo // 16, (hi - 1) // 16 + 1):
            a, b = max(lo - 16 * u, 0), min(hi - 16 * u, 16)
            vals = np.zeros(16, np.float32)
            for p in range(16 // per):
                if (p + 1) * per > a and p * per < b:
                    g = (16 * u + p * per) * itemsize // 16
                    top_granule = max(top_granule, g)
                    vals[p * per:(p + 1) * per] = flat[16 * u + p * per:16 * u + (p + 1) * per]
            units.append((u, a, b, vals))
        row = np.concatenate([vals[a:b] for _, a, b, vals in units])
        assert row.size == k
        mu, rstd = np.float32(0), np.float32(1)
        if ln:
            mu = np.float32(row.sum(dtype=np.float32) / np.float32(k))
            m2 = np.float32((row * row).sum(dtype=np.float32) / np.float32(k))
            rstd = np.float32(1 / np.sqrt(max(m2 - mu * mu, 0) + eps))
        amax = np.float32(max(np.abs(row - mu).max(), 1e-12))
        inv = np.float32(qmax) / amax
        for u, a, b, vals in units:
            q = np.rint((vals - mu) * inv).astype(np.int8)
            span = slice(0, 16) if (a, b) == (0, 16) else slice(a, b)
            idx = 16 * u + np.arange(16)[span]
            out[idx] = q[span]
            writes[idx] += 1
        scales[r] = amax * np.float32(1 / qmax) * rstd
    return out.reshape(m, k), scales, writes, top_granule


@pytest.mark.parametrize("dtype,k,ln,qmax", [("float32", 849, True, 127), ("bfloat16", 849, False, 7),
                                             ("bfloat16", 40, True, 127), ("float32", 5, True, 127),
                                             ("bfloat16", 256, True, 127)])
def test_quant_rows_unit_walk_matches_plain(dtype, k, ln, qmax):
    """The kernel's walk over aligned 16-element units (rows of K = 849, 40
    and 5 starting mid-unit and mid-piece, and an aligned K = 256) writes
    every output byte exactly once, reads no 16-byte granule past the
    tensor's last, and gives quant_rows_plain's payload (+-1 on at most
    1e-3 of it) and scales (1e-5)."""
    m = 64
    x = np.random.default_rng(k).standard_normal((m, k)).astype(np.float32) * 2 + 0.3
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    q, s, writes, top = _quant_rows_emulated(tx.float().numpy(), tx.element_size(), ln, qmax)
    assert (writes == 1).all()
    assert top == (m * k * tx.element_size() - 1) // 16
    pq, ps = tq.quant_rows_plain(tx, ln, qmax=qmax)
    assert_payload_close(q, pq.numpy())
    assert_scales_close(s, ps.numpy())
