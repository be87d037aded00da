"""Every scale of the PyTorch port against the JAX package, on the CPU.

  * The route table: at 640x640 each attention site of phi 'n', 's', 'm',
    'l' and 'x' (dark3, neck nodes h1, h2, h4, h6) takes the route the JAX
    dispatch takes on a TPU (naive, packed, single-head, folded single-head
    or int8 with its key block), read off JAX's own `attention_qkv` /
    `attention` traced abstractly with the backend reported as a TPU and
    the kernel launchers replaced by recorders (nothing is computed). One
    difference is kept on purpose and asserted: where the TPU's VMEM fit
    fails (phi='l' h1, phi='x' h1 and h4) JAX falls to its bf16-scored
    chunked route, the port keeps its packed kernel (ROADMAP section 3).
  * The quant_out group widths of the int8 TEB projections and the LN
    handoff at every scale, against the JAX dispatch's output shapes.
  * Every kernel wrapper's shape gate admits every site of those scales,
    and the input 480x576 (N = 4,320, fault 3.2 of the ROADMAP).
  * Two tiny models whose head widths are not multiples of 128 (base
    channels 8: h1 2 heads of 53, h2 and h4 8 of 12), so that every qmm
    takes JAX's reference route (one quant_out scale a row) and, at a
    512x576 input (h1 N = 1,152), h1 takes the folded single-head route:
    fp32 int8 (int8_dense + int8_attn) and bf16, each held against the JAX
    FocusModel on the same numpy weights through weights.py. Tolerances are
    those of tests/test_torch_model.py: fp32 int8 2e-2 of each output's
    largest magnitude (the same integers on both sides, a +-1 payload flip
    moving a TEB row by ~1e-3), bf16 2e-2 (the JAX tests' bar).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import transparent_object_detection_tpu.ops.attention as jattn
import transparent_object_detection_tpu.ops.attention_int8 as ja8
import transparent_object_detection_tpu.ops.quant_matmul as jq
from _torch_parity import random_variables, rel_err, to_jax
from transparent_object_detection_tpu.models import blocks as jb
from transparent_object_detection_tpu.models.detector import FocusModel as JaxFocusModel
from transparent_object_detection_tpu_torch.config import SCALE_TABLE
from transparent_object_detection_tpu_torch.models import blocks as tb
from transparent_object_detection_tpu_torch.models.detector import FocusModel
from transparent_object_detection_tpu_torch.ops import attention as tattn
from transparent_object_detection_tpu_torch.ops import attention_int8 as t8
from transparent_object_detection_tpu_torch.ops import quant_matmul as tq
from transparent_object_detection_tpu_torch.weights import load_jax_variables

torch.set_num_threads(1)

PHIS = ("n", "s", "m", "l", "x")


def sites(phi: str, hw=(640, 640)):
    """{site: (N, q/k width, v width, heads, packed qkv input)} of the
    attention calls of one 640x640 forward (the neck's heads as the TEB
    picks them)."""
    c, _, mul = SCALE_TABLE[phi]
    c5 = int(c * 16 * mul)
    h, w = hw
    n8, n16, n32 = (h // 8) * (w // 8), (h // 16) * (w // 16), (h // 32) * (w // 32)
    out = {"dark3": (n8, max(4 * c // 8, 1), 4 * c, 1, False)}
    for name, n, ch in (("h1", n16, c5 + 8 * c), ("h2", n8, 12 * c), ("h4", n16, 12 * c),
                        ("h6", n32, 8 * c + c5)):
        out[name] = (n, ch, ch, tb._pick_num_heads(ch, 8), True)
    return out


def test_sites_heads_match_jax():
    """The port's head choice is JAX's at every scale (phi='n' h1 3 x 283,
    phi='m' h1 8 x 599, h2/h4 8 x 384)."""
    for phi in PHIS:
        for name, (_, c, _, heads, packed) in sites(phi).items():
            if packed:
                assert heads == jb._pick_num_heads(c, 8, True), (phi, name)
    assert sites("n")["h1"][1:4] == (849, 849, 3)
    assert sites("m")["h1"][1:4] == (4792, 4792, 8)
    assert sites("m")["h2"][1:4] == (3072, 3072, 8)
    assert sites("x")["h1"][1:4] == (28672, 28672, 8)


def _jax_route(monkeypatch, n, cq, cv, heads, int8, packed):
    """(route, key block) of JAX's serving dispatch on a TPU for one call,
    read by tracing it abstractly with recorders in place of the kernels."""
    calls = []

    def zeros_like_out(q, v):
        return jnp.zeros(q.shape[:2] + (v.shape[-1],), q.dtype)

    def packed_kernel(qp, h, scale, bq, bk):
        calls.append(("packed", None))
        return jnp.zeros(qp.shape[:2] + (qp.shape[2] // 3,), qp.dtype)

    def diff_flash(scale, bq, bk, h):
        def fn(q, k, v):
            calls.append(("flash", h))
            return zeros_like_out(q, v)
        return fn

    def int8_kernel(q, k, v, num_heads, scale, block_q, block_k, q_width=None):
        calls.append(("int8", block_k))
        return zeros_like_out(k, v)

    def recorder(route):
        def fn(q, k, v, *args, **kw):
            calls.append((route, None))
            return zeros_like_out(q, v)
        return fn

    with monkeypatch.context() as mp:
        mp.setattr(jax, "default_backend", lambda: "tpu")
        mp.setattr(jattn, "flash_attention_mha_packed", packed_kernel)
        mp.setattr(jattn, "_diff_flash", diff_flash)
        mp.setattr(jattn, "chunked_attention", recorder("chunked"))
        mp.setattr(jattn, "reference_attention", recorder("naive"))
        mp.setattr(ja8, "flash_attention_mha_int8", int8_kernel)
        sds = lambda *s: jax.ShapeDtypeStruct(s, jnp.bfloat16)
        if packed:
            jax.eval_shape(lambda x: jattn.attention_qkv(x, scale=0.1, num_heads=heads,
                                                         int8=int8), sds(1, n, 3 * cq))
        else:
            jax.eval_shape(lambda q, k, v: jattn.attention(q, k, v, 1.0, num_heads=heads,
                                                           int8=int8),
                           sds(1, n, cq), sds(1, n, cq), sds(1, n, cv))
    assert len(calls) == 1, calls
    route, arg = calls[0]
    if route == "flash":  # JAX's single-head kernel, or its multi-head one
        route = "mha" if arg > 1 else ("folded" if heads > 1 else "single")
        arg = None
    return route, arg


# the sites where JAX on a TPU leaves for its chunked route (its bf16 VMEM
# fit fails: heads of 1,536 at N = 1,600 and of 3,584) and the port keeps
# its packed kernel
KEPT_PACKED = {("l", "h1"), ("x", "h1"), ("x", "h4")}


@pytest.mark.parametrize("int8", [False, True])
def test_route_table_matches_jax(monkeypatch, int8):
    table = {}
    for phi in PHIS:
        for name, (n, cq, cv, heads, packed) in sites(phi).items():
            want = _jax_route(monkeypatch, n, cq, cv, heads, int8, packed)
            got = tattn.serving_route(n, cq, heads, cv, int8, packed)
            table[phi, name] = got
            if (phi, name) in KEPT_PACKED and not int8:
                assert want == ("chunked", None) and got == ("packed", None), (phi, name, want)
            else:
                assert got == want, (phi, name, got, want)
    # the widths and key blocks at 640x640
    if int8:
        assert [table["m", s] for s in ("dark3", "h1", "h2", "h4")] == [
            ("int8", 3200), ("folded", None), ("int8", 3200), ("int8", 1600)]
        assert table["l", "h1"] == ("int8", 800)
        assert [table["x", s] for s in ("dark3", "h1", "h2", "h4")] == [
            ("int8", 800), ("int8", 320), ("int8", 1280), ("int8", 800)]
        assert table["n", "h1"] == ("folded", None)
        assert [table["n", s] for s in ("dark3", "h2", "h4")] == [
            ("int8", 6400), ("int8", 6400), ("int8", 1600)]
    else:
        assert [table["n", s] for s in ("dark3", "h1", "h2", "h4", "h6")] == [
            ("single", None), ("folded", None), ("packed", None), ("packed", None),
            ("naive", None)]
        assert [table["m", s] for s in ("dark3", "h1", "h2", "h4")] == [
            ("single", None), ("folded", None), ("packed", None), ("packed", None)]


def test_route_at_480x576_matches_jax(monkeypatch):
    """N = 4,320 (60 x 72) at dark3 and h2: JAX's int8 route with key blocks
    that are multiples of 32 but not of 64 (fault 3.2): 4,320 at phi='s',
    1,440 at phi='m' dark3, 864 at phi='x'."""
    blocks = {}
    for phi in PHIS:
        for name in ("dark3", "h2"):
            n, cq, cv, heads, packed = sites(phi, (480, 576))[name]
            assert n == 4320
            got = tattn.serving_route(n, cq, heads, cv, True, packed)
            assert got == _jax_route(monkeypatch, n, cq, cv, heads, True, packed)
            assert got[0] == "int8" and got[1] % 32 == 0 and got[1] % 64
            blocks[phi, name] = got[1]
    assert blocks["s", "dark3"] == blocks["s", "h2"] == 4320
    assert (blocks["m", "dark3"], blocks["x", "h2"]) == (1440, 864)


def test_wide_int8_sites_take_the_sm90_form(monkeypatch):
    """Every int8 site of phi 'l' and 'x', at 640x640 and 480x576 (the neck
    heads of 768 to 3,584 and dark3), is on JAX's int8 route with its key
    block, and the port sends it, for all three int8 entry points, to the
    one Hopper kernel (csrc/flash_int8_sm90.cu) with a plan that fits: the
    neck heads' q/k wider than a resident Q tile allows stream through the
    ring, an int8 output's v slices are one cluster."""
    found = []
    for phi in ("l", "x"):
        for hw in ((640, 640), (480, 576)):
            for name, (n, cq, cv, heads, packed) in sites(phi, hw).items():
                route, bk = tattn.serving_route(n, cq, heads, cv, True, packed)
                if route != "int8":
                    continue
                assert (route, bk) == _jax_route(monkeypatch, n, cq, cv, heads, True, packed)
                dq, dv = cq // heads, cv // heads
                for entry in ("flash_mha_int8",) + t8.INT8_OUT_ENTRIES:
                    assert t8.int8_fwd_form(dq, dv, entry) == "sm90", (phi, hw, name, entry)
                    plan = t8.int8_sm90_plan(dq, dv, n // bk,
                                             int8_out=entry != "flash_mha_int8")
                    assert plan["smem_bytes"] <= t8.SM90_SMEM_LIMIT
                    assert plan["cluster"] in (1, plan["slices"])
                found.append((phi, hw, name, dq))
    # the neck heads at 640x640, dark3 and h2 at 480x576 (N = 1,080 is no
    # multiple of 32: h1 and h4 there take the bf16 route)
    assert len(found) == 12
    assert {dq for *_, dq in found} == {256, 512, 768, 1536, 3584}


def _kernel_admits(route, bk, n, cq, cv, heads):
    if route == "packed":
        return tattn.packed_kernel_supports(cq, heads)
    if route in ("single", "folded"):
        return tattn.single_kernel_supports(cq // heads, cv // heads)
    if route == "int8":
        return t8.kernel_supports(n, cq // heads, cv // heads, bk)
    return route == "naive"


@pytest.mark.parametrize("int8", [False, True])
def test_kernel_gates_admit_every_site(int8):
    """No site of any scale, nor the 480x576 input, reaches a kernel that
    would refuse it on the card; the int8 TEB's projections at batch 1, 2
    and 32 are all qmm shapes, with every quant_out group the route picks."""
    for hw in ((640, 640), (480, 576)):
        for phi in PHIS:
            for name, (n, cq, cv, heads, packed) in sites(phi, hw).items():
                route, bk = tattn.serving_route(n, cq, heads, cv, int8, packed)
                assert _kernel_admits(route, bk, n, cq, cv, heads), (phi, name, route)
                if not packed:
                    continue
                for b in (1, 2, 32):
                    m, c = b * n, cq
                    dh = c // heads
                    g_qkv = tq.quant_out_group_width(m, c, 3 * c, 0, align=(c, dh))
                    g_mlp1 = tq.quant_out_group_width(m, c, 4 * c, 0)
                    assert tq.kernel_supports(m, c, 3 * c) and (3 * c) % g_qkv == 0
                    assert tq.kernel_supports(m, c, 4 * c) and (4 * c) % g_mlp1 == 0
                    assert tq.kernel_supports(m, 4 * c, c, 4 * c // g_mlp1)
                    assert tq.kernel_supports(m, c, c, heads if dh % 128 == 0 else 1)


def _jax_group_width(m, k, n, groups_in, align=None):
    """The quant_out group width of JAX's dispatch, read off its output's
    scale shape (traced abstractly, the Pallas route opened as on a TPU)."""
    w = jax.ShapeDtypeStruct((k, n), jnp.float32)
    vec = lambda size: jax.ShapeDtypeStruct((size,), jnp.float32)
    if groups_in:
        fn = lambda p, s, w, b, g, bb: jq.quant_matmul(
            None, w, bias=b, ln_scale=g, ln_bias=bb, act="gelu", quant_out=True,
            x_quant=(p, s), x_quant_normalized=True)
        args = (jax.ShapeDtypeStruct((m, k), jnp.int8),
                jax.ShapeDtypeStruct((m, groups_in), jnp.float32))
    else:
        fn = lambda x, w, b, g, bb: jq.quant_matmul(
            x, w, bias=b, ln_scale=g, ln_bias=bb, act="gelu", quant_out=True,
            quant_out_align=align)
        args = (jax.ShapeDtypeStruct((m, k), jnp.bfloat16),)
    _, scales = jax.eval_shape(fn, *args, w, vec(n), vec(k), vec(k))
    return n // scales.shape[-1]


@pytest.mark.parametrize("phi", PHIS)
def test_quant_out_groups_match_jax(monkeypatch, phi):
    """mlp1's quant_out groups (bf16 rows, and the LN handoff's payload) and
    the attention handoff's aligned qkv groups at batch 2 and 32, and the
    LN handoff's gate, as the JAX dispatch on a TPU gives them; at phi='n'
    and 'm' h1 / h6 (K not a multiple of 128) JAX takes `_qmm_reference`,
    one scale a row."""
    monkeypatch.setattr(jq, "INTERPRET", True)
    for name, (n, c, _, heads, packed) in sites(phi).items():
        if not packed:
            continue
        for b in (2, 32):
            m = b * n
            for groups_in in (0, 1):
                assert tq.quant_out_group_width(m, c, 4 * c, groups_in) == \
                    _jax_group_width(m, c, 4 * c, groups_in), (phi, name, b, groups_in)
            align = (c, c // heads)
            assert tq.quant_out_group_width(m, c, 3 * c, 0, align=align) == \
                _jax_group_width(m, c, 3 * c, 0, align=align), (phi, name, b)
            assert tq.ln_handoff(m, c) == (m >= 51200 and jq.ln_quant_out_supported(m, c, c))
    if phi in ("n", "m"):
        n, c = sites(phi)["h1"][:2]
        assert tq.quant_out_group_width(2 * n, c, 4 * c, 0) == 4 * c


# ---------------------------------------------------------------------------
# tiny models with odd head widths, against JAX
# ---------------------------------------------------------------------------

KW = dict(num_classes=2, base_channels=8, base_depth=1, deep_mul=0.33)
HW = (512, 576)  # h1: 32 x 36 = 1,152 tokens, past the naive route's 1,024


def _model_pair(dtype, **flags):
    jmodel = JaxFocusModel(**KW, **flags, dtype=jnp.dtype(dtype))
    variables = random_variables(jmodel, jnp.zeros((1, 64, 64, 3), jnp.float32), train=True)
    tmodel = load_jax_variables(
        FocusModel(**KW, **flags, dtype=getattr(torch, dtype)).eval(), variables)
    return jmodel, to_jax(variables), tmodel


@pytest.mark.parametrize("dtype,flags", [
    ("float32", dict(int8_dense=True, int8_attn=True)),
    ("bfloat16", {}),
], ids=["fp32_int8", "bf16"])
def test_odd_width_model_matches_jax(dtype, flags):
    jmodel, jvars, tmodel = _model_pair(dtype, **flags)
    teb1 = tmodel.neck.h1.teb
    assert (teb1.heads, teb1.qkv.in_features // teb1.heads) == (2, 53)
    n1 = (HW[0] // 16) * (HW[1] // 16)
    assert tattn.serving_route(n1, 106, 2, 106, bool(flags), True) == ("folded", None)
    assert tq.quant_out_group_width(n1, 106, 424, 0) == 424  # JAX's reference route
    x = np.random.default_rng(0).uniform(0, 1, (1, *HW, 3)).astype(np.float32)
    ref = jax.jit(lambda v, a: jmodel.apply(v, a, train=False))(jvars, jnp.asarray(x))
    with torch.no_grad():
        out = tmodel(torch.from_numpy(x))
    for o, r in zip(out["raw"], ref["raw"]):
        assert tuple(o.shape) == r.shape
        assert rel_err(o.float().numpy(), np.asarray(r, np.float32)) <= 2e-2
    assert tuple(out["decoded"].shape) == ref["decoded"].shape
    assert rel_err(out["decoded"].numpy(), ref["decoded"]) <= 2e-2
