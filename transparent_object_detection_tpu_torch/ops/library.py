"""The serving kernels as registered PyTorch operators, `torch.ops.focus.*`.

The model's evaluation forward (and `detect_step`'s exact NMS) calls these
operators, never the launchers or the plain versions directly, so that
`torch.export` (and any other tracer) sees each kernel as one operator of
the program instead of a ctypes call it cannot follow. Each operator has

  * one implementation for the CUDA and CPU keys: the kernel's launcher as
    it stands (ops/attention.py, ops/attention_int8.py,
    ops/quant_matmul.py, ops/nms.py), looked up by name at each call, which
    launches the kernel for CUDA tensors and counts the launch, and runs the
    kernel's plain PyTorch version for CPU tensors;
  * a fake implementation: the output shapes and dtypes (int8 payloads and
    their scales too), for tracing and for `utils.profiling.cost_analysis`;
  * a FLOP formula (`torch.utils.flop_counter`): 2 per multiply-add of its
    products, the count `FlopCounterMode` gives the plain version.

A CUDA tensor reaches only the kernel (the launcher raises where its kernel
does not take the call); a CPU tensor only the plain version. Defined with
`torch.library.Library` and registered per dispatch key, which adds only
the dispatcher's call to each launch. The training route (FlashAttention,
ops/attention_vjp.py) is an autograd Function and is not registered here.

Operators, each with the launcher it calls and the TPU kernel that launcher
replaces (the file and line of the Pallas kernel in the JAX package):

  flash_mha_packed         attention.flash_mha_packed   ops/attention.py:239
  flash_single             attention.flash_single       ops/attention.py:137
  flash_mha_int8           attention_int8.flash_mha_int8       ops/attention_int8.py:58
  flash_mha_int8_qout      attention_int8.flash_mha_int8_qout  ops/attention_int8.py:184
  flash_int8_handoff       attention_int8.flash_int8_handoff   ops/attention_int8.py:435
  flash_int8_handoff_qout  the same launcher, int8 output
  quant_rows               quant_matmul.quant_rows       ops/quant_matmul.py:408
  qmm, qmm_quant_out, qmm_ln_out   quant_matmul.qmm, by output form   ops/quant_matmul.py:80
  nms_exact                nms.nms_exact     none: JAX runs this loop in its program
                           (ops/nms.py::_exact_greedy_keep, a lax.fori_loop)
"""
from __future__ import annotations

import torch
from torch.utils.flop_counter import register_flop_formula

from transparent_object_detection_tpu_torch.ops import attention as A
from transparent_object_detection_tpu_torch.ops import attention_int8 as A8
from transparent_object_detection_tpu_torch.ops import nms as N
from transparent_object_detection_tpu_torch.ops import quant_matmul as QM

NAMESPACE = "focus"
_LIB = torch.library.Library(NAMESPACE, "DEF")

_INT8_ATTN = ("Tensor q, Tensor kq, Tensor ks, Tensor vq, Tensor vs, int num_heads, "
              "float scale, int? q_width")
_HANDOFF = ("Tensor payload, Tensor qs, Tensor kq, Tensor ks, Tensor vq, Tensor vs, "
            "int num_heads, float scale")
_QMM = ("Tensor xq, Tensor x_scales, Tensor wq, Tensor w_scale, Tensor? bias, str? act, "
        "Tensor? residual")
SCHEMAS = {
    "flash_mha_packed": "(Tensor qkv, int num_heads, float scale) -> Tensor",
    "flash_single": "(Tensor q, Tensor k, Tensor v, float scale) -> Tensor",
    "flash_mha_int8": f"({_INT8_ATTN}) -> Tensor",
    "flash_mha_int8_qout": f"({_INT8_ATTN}) -> (Tensor, Tensor)",
    "flash_int8_handoff": f"({_HANDOFF}, ScalarType out_dtype) -> Tensor",
    "flash_int8_handoff_qout": f"({_HANDOFF}) -> (Tensor, Tensor)",
    "quant_rows": "(Tensor x, bool ln, float eps, int qmax) -> (Tensor, Tensor)",
    "qmm": f"({_QMM}, ScalarType out_dtype) -> Tensor",
    "qmm_quant_out": f"({_QMM}, int group, ScalarType out_dtype) -> (Tensor, Tensor)",
    "qmm_ln_out": f"({_QMM}, float eps, ScalarType out_dtype) -> (Tensor, Tensor, Tensor)",
    "nms_exact": "(Tensor iou, Tensor valid, float iou_thres) -> Tensor",
}
OPS = tuple(SCHEMAS)

# The implementation of each operator, for CUDA and CPU tensors alike: its
# launcher with the launcher's positional arguments, looked up at each call.
# A launcher launches its kernel for CUDA tensors (or raises) and runs its
# plain version for CPU tensors.
_LAUNCHERS = {
    "flash_mha_packed": lambda *a: A.flash_mha_packed(*a),
    "flash_single": lambda *a: A.flash_single(*a),
    "flash_mha_int8": lambda *a: A8.flash_mha_int8(*a),
    "flash_mha_int8_qout": lambda *a: A8.flash_mha_int8_qout(*a),
    "flash_int8_handoff": lambda *a: A8.flash_int8_handoff(*a[:8], False, a[8]),
    "flash_int8_handoff_qout": lambda *a: A8.flash_int8_handoff(*a, True, torch.int8),
    "quant_rows": lambda *a: QM.quant_rows(*a),
    "qmm": lambda *a: QM.qmm(*a[:7], None, None, a[7]),
    "qmm_quant_out": lambda *a: QM.qmm(*a[:8], None, a[8]),
    "qmm_ln_out": lambda *a: QM.qmm(*a[:7], None, a[7], a[8]),
    "nms_exact": lambda *a: N.nms_exact(*a),
}

for _name, _schema in SCHEMAS.items():
    _LIB.define(_name + _schema)
    for _key in ("CUDA", "CPU"):
        _LIB.impl(_name, _LAUNCHERS[_name], _key)


# ---------------------------------------------------------------------------
# fake implementations: the CPU implementation's shapes and dtypes
# ---------------------------------------------------------------------------


def _int8_out(x: torch.Tensor, b: int, n: int, cv: int, heads: int):
    return (x.new_empty((b, n, cv), dtype=torch.int8),
            x.new_empty((b, n, heads), dtype=torch.float32))


def _fake(name: str):
    return lambda fn: torch.library.register_fake(f"{NAMESPACE}::{name}", fn, lib=_LIB)


@_fake("flash_mha_packed")
def _(qkv, num_heads, scale):
    b, n, c3 = qkv.shape
    return qkv.new_empty((b, n, c3 // 3))


@_fake("flash_single")
def _(q, k, v, scale):
    return v.new_empty(v.shape)


@_fake("flash_mha_int8")
def _(q, kq, ks, vq, vs, num_heads, scale, q_width):
    return q.new_empty(vq.shape)


@_fake("flash_mha_int8_qout")
def _(q, kq, ks, vq, vs, num_heads, scale, q_width):
    return _int8_out(q, *vq.shape, num_heads)


@_fake("flash_int8_handoff")
def _(payload, qs, kq, ks, vq, vs, num_heads, scale, out_dtype):
    return payload.new_empty(vq.shape, dtype=out_dtype)


@_fake("flash_int8_handoff_qout")
def _(payload, qs, kq, ks, vq, vs, num_heads, scale):
    return _int8_out(payload, *vq.shape, num_heads)


@_fake("quant_rows")
def _(x, ln, eps, qmax):
    m, k = x.shape
    return (x.new_empty((m, k), dtype=torch.int8), x.new_empty((m, 1), dtype=torch.float32))


@_fake("qmm")
def _(xq, x_scales, wq, w_scale, bias, act, residual, out_dtype):
    return xq.new_empty((xq.shape[0], wq.shape[0]), dtype=out_dtype)


@_fake("qmm_quant_out")
def _(xq, x_scales, wq, w_scale, bias, act, residual, group, out_dtype):
    m, n = xq.shape[0], wq.shape[0]
    return (xq.new_empty((m, n), dtype=torch.int8),
            xq.new_empty((m, n // group), dtype=torch.float32))


@_fake("qmm_ln_out")
def _(xq, x_scales, wq, w_scale, bias, act, residual, eps, out_dtype):
    m, n = xq.shape[0], wq.shape[0]
    return (xq.new_empty((m, n), dtype=out_dtype), xq.new_empty((m, n), dtype=torch.int8),
            xq.new_empty((m, 1), dtype=torch.float32))


@_fake("nms_exact")
def _(iou, valid, iou_thres):
    return valid.new_empty(valid.shape)


# ---------------------------------------------------------------------------
# FLOP formulas: 2 per multiply-add of the products (arguments as shapes)
# ---------------------------------------------------------------------------


def _attention_flops(b: int, n: int, cq: int, cv: int) -> int:
    """S = Q K^T and O = P V over every head: 2 N^2 (Cq + Cv) an image."""
    return 2 * b * n * n * (cq + cv)


@register_flop_formula(torch.ops.focus.flash_mha_packed)
def _(qkv, num_heads, scale, out_shape=None, **kw) -> int:
    b, n, c3 = qkv
    return _attention_flops(b, n, c3 // 3, c3 // 3)


@register_flop_formula(torch.ops.focus.flash_single)
def _(q, k, v, scale, out_shape=None, **kw) -> int:
    return _attention_flops(q[0], q[1], q[2], v[2])


@register_flop_formula([torch.ops.focus.flash_mha_int8, torch.ops.focus.flash_mha_int8_qout])
def _(q, kq, ks, vq, vs, *rest, out_shape=None, **kw) -> int:
    return _attention_flops(kq[0], kq[1], kq[2], vq[2])


@register_flop_formula([torch.ops.focus.flash_int8_handoff,
                        torch.ops.focus.flash_int8_handoff_qout])
def _(payload, qs, kq, ks, vq, vs, *rest, out_shape=None, **kw) -> int:
    return _attention_flops(kq[0], kq[1], kq[2], vq[2])


@register_flop_formula(torch.ops.focus.quant_rows)
def _(x, *rest, out_shape=None, **kw) -> int:
    return 0  # no product: a LayerNorm, an amax and a rounding per row


@register_flop_formula(torch.ops.focus.nms_exact)
def _(iou, *rest, out_shape=None, **kw) -> int:
    return 0  # no product: comparisons and bit operations


@register_flop_formula([torch.ops.focus.qmm, torch.ops.focus.qmm_quant_out,
                        torch.ops.focus.qmm_ln_out])
def _(xq, x_scales, wq, *rest, out_shape=None, **kw) -> int:
    (m, k), n = xq, wq[0]
    return 2 * m * n * k
