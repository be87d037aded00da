"""Tensor-parallel TransformerEncoderBlock serving: the TEB body as a
Megatron block over the mesh's `model` axis (counterpart of
transparent_object_detection_tpu/ops/teb_tp.py, written from it and not
from the single-device TEB: its rounding points are JAX's TP ones).

  * LayerNorms run replicated on the full channel axis, in norm_dtype;
  * qkv and mlp1 run column-parallel: the full K, this rank's N (bf16: the
    product, then the bias, in the compute type; int8: `quant_matmul` with
    the LN folded into the shard and gelu for mlp1);
  * attention runs on this rank's heads/tp heads when the head count
    divides tp: the canonicalized local qkv is the packed (q_r | k_r | v_r)
    layout, which `attention_qkv` reads in place. With a ragged head count
    the sections are all-gathered, attention runs with every head, and the
    rank keeps its own output columns;
  * attn_out and mlp2 run row-parallel into an fp32 partial product, summed
    by one all-reduce over the model axis, then the bias and the residual in
    fp32.

The int8 path takes JAX's TP routes, not the single-device TEB's handoffs:
no mlp1 -> mlp2 int8 output, no LN or attention handoff, no w4a4. Each rank
quantizes its own weight shards; on the row-parallel shards the activation
rows are quantized over this rank's K/tp columns, so int8 TP serving is not
bit-equal to single-device int8 (the same quantization-noise class).
The training form (`teb_tp_train_forward`, bf16 and fp32; int8 is
serving-only) is the same Megatron block with its gradients
(parallel/mesh.py's collectives): the LayerNorm outputs enter the
column-parallel qkv and mlp1 through `copy_to_model` (their gradient summed
over the model axis); attention runs on the local heads through the
differentiable flash route, or, with a ragged head count, on every head
after `gather_from_model`, each rank's output columns split off by
`scatter_to_model`; attn_out and mlp2 run row-parallel into fp32 partial
products summed by `reduce_from_model`. It rounds where the single-device
training TEB rounds (LayerNorm as `F.layer_norm`, each projection's value
in the compute type once, the residual added in it), so the step is the
single-device step but for the order of the sums.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from transparent_object_detection_tpu_torch.ops.attention import (
    attention,
    attention_qkv,
    serving_route,
)
from transparent_object_detection_tpu_torch.ops.quant_matmul import quant_matmul
from transparent_object_detection_tpu_torch.parallel.mesh import (
    MODEL_AXIS,
    all_gather_list,
    all_reduce_sum,
    copy_to_model,
    gather_from_model,
    reduce_from_model,
    scatter_to_model,
)


def _layernorm(x: torch.Tensor, ln, norm_dtype: torch.dtype) -> torch.Tensor:
    """flax nn.LayerNorm written out: statistics and affine in norm_dtype."""
    xf = x.to(norm_dtype)
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + ln.eps)
    return y * ln.weight.to(norm_dtype) + ln.bias.to(norm_dtype)


def local_route(n: int, c: int, heads: int, tp: int, int8: bool):
    """(route, key block) of a TP TEB's attention on N tokens of C channels:
    `serving_route` at the local qkv (C/tp channels, heads/tp heads) where
    the head count divides tp, else at the all-gathered one. As JAX's
    attention on separate q, k, v: several heads take the packed kernel, one
    head the single-head one."""
    cq, h = (c // tp, heads // tp) if heads % tp == 0 else (c, heads)
    return serving_route(n, cq, h, cq, int8, packed=h > 1)


def _attend(qkv: torch.Tensor, heads: int, teb) -> torch.Tensor:
    """Attention on a packed (q | k | v) array by `local_route`'s rule."""
    if heads > 1:
        return attention_qkv(qkv, scale=teb.scale, impl=teb.attention_impl, num_heads=heads,
                             int8=teb.int8_attn)
    q, k, v = qkv.chunk(3, dim=-1)
    return attention(q, k, v, teb.scale, teb.attention_impl, 1, teb.int8_attn)


def _tp_size(teb) -> int:
    mesh = teb.tp_mesh
    tp = 1 if mesh is None else mesh.size(MODEL_AXIS)
    if tp <= 1:
        raise RuntimeError(
            "tp_serving TEB requires a (data, model) mesh with model-axis size > 1: build it "
            "through FOCUS.serve_mesh(tp=...) or Predictor(mesh=make_2d_mesh(tp)) for "
            "serving, or parallel.tp.shard_train_state_tp for training. A tp_serving model "
            "never runs outside them: its qkv weights are TP-canonicalized.")
    c = teb.qkv.in_features
    if c % tp or (c * teb.mlp_ratio) % tp:
        raise ValueError(f"TEB channel width {c} (mlp {c * teb.mlp_ratio}) not divisible by "
                         f"tp={tp}")
    return tp


def teb_tp_train_forward(tokens: torch.Tensor, teb) -> torch.Tensor:
    """tokens (B, N, C) -> (B, N, C) through `teb` in training mode (its
    parameters this rank's shards, qkv rows canonicalized:
    parallel.tp.shard_train_state_tp) on the mesh in `teb.tp_mesh`, with
    its gradients; every rank of a model group passes the same tokens and
    gets the same output."""
    mesh = teb.tp_mesh
    tp = _tp_size(teb)
    heads, dt, impl = teb.heads, teb.dtype, teb.attention_impl
    fp32 = torch.float32

    def col_parallel(x, layer):
        return F.linear(copy_to_model(x, mesh), layer.weight.to(dt), layer.bias.to(dt))

    def row_parallel(x, layer):
        """The bias-added sum of the ranks' fp32 partial products of the
        compute-type operands, in the compute type: the single device's
        projection value."""
        part = torch.matmul(x.to(dt).to(fp32), layer.weight.to(dt).to(fp32).t())
        return (reduce_from_model(part, mesh) + layer.bias.to(dt).to(fp32)).to(dt)

    qkv_l = col_parallel(teb._norm(tokens, teb.norm1), teb.qkv)  # (q_r | k_r | v_r)
    if heads % tp == 0:
        o_l = attention_qkv(qkv_l, scale=teb.scale, impl=impl, num_heads=heads // tp,
                            train=True)
    else:  # ragged: every head on every rank, this rank's output columns split off
        qkv = torch.cat([gather_from_model(sec, mesh, -1) for sec in qkv_l.chunk(3, dim=-1)],
                        dim=-1)
        o = attention_qkv(qkv, scale=teb.scale, impl=impl, num_heads=heads, train=True)
        o_l = scatter_to_model(o, mesh, -1)
    tokens = tokens + row_parallel(o_l, teb.attn_out)
    z = F.gelu(col_parallel(teb._norm(tokens, teb.norm2), teb.mlp1), approximate="tanh")
    return tokens + row_parallel(z, teb.mlp2)


def teb_tp_forward(tokens: torch.Tensor, teb) -> torch.Tensor:
    """tokens (B, N, C) -> (B, N, C) through `teb` (a TransformerEncoderBlock
    set up by parallel.tp.tp_serving_copy: its projections hold this rank's
    shards, its qkv rows canonicalized) on the mesh in `teb.tp_mesh`. Every
    rank of a model group passes the same tokens and gets the same output."""
    mesh = teb.tp_mesh
    tp = _tp_size(teb)
    b, n, c = tokens.shape
    cl = c // tp
    heads = teb.heads
    dt, nd, impl = teb.dtype, teb.norm_dtype, teb.attention_impl
    fp32 = torch.float32
    wts = teb._int8_weights() if teb.int8_dense else None

    def col_parallel(x, name, ln, act=None):
        """[LN ->] x @ W_local^T (+ bias_local): the full K, this rank's N."""
        if wts is not None:
            return quant_matmul(x, wts[name], ln=True, ln_eps=ln.eps, act=act, out_dtype=dt,
                                impl=impl)
        layer = getattr(teb, name)
        y = _layernorm(x, ln, nd).to(dt)
        out = torch.matmul(y, layer.weight.to(dt).t()) + layer.bias.to(dt)
        return F.gelu(out, approximate="tanh") if act == "gelu" else out

    def row_parallel(x, name):
        """x_local @ W_local^T -> the fp32 partial product (the bias and the
        residual come after the all-reduce)."""
        if wts is not None:
            return quant_matmul(x, wts[name], out_dtype=fp32, impl=impl)
        w = getattr(teb, name).weight
        # compute-type operands, fp32 products and sums (each product of two
        # bf16 values is exact in fp32)
        return torch.matmul(x.to(dt).to(fp32), w.to(dt).to(fp32).t())

    # ---- attention sub-block ----------------------------------------------
    qkv_l = col_parallel(tokens, "qkv", teb.norm1)  # (b, n, 3 cl) = (q_r | k_r | v_r)
    if heads % tp == 0:
        o_l = _attend(qkv_l, heads // tp, teb)
    else:
        # ragged head count: every rank's sections, attention with the
        # single-device head grouping, this rank's output columns kept
        parts = all_gather_list(qkv_l, mesh, MODEL_AXIS)
        qkv = torch.cat([torch.cat([p[..., s * cl:(s + 1) * cl] for p in parts], dim=-1)
                         for s in range(3)], dim=-1)
        o = _attend(qkv, heads, teb)
        r = mesh.index(MODEL_AXIS)
        o_l = o[..., r * cl:(r + 1) * cl]
    attn = all_reduce_sum(row_parallel(o_l, "attn_out"), mesh, MODEL_AXIS)
    attn = attn + teb.attn_out.bias.to(fp32)
    tok = (tokens.to(fp32) + attn).to(dt)

    # ---- MLP sub-block ----------------------------------------------------
    z_l = col_parallel(tok, "mlp1", teb.norm2, act="gelu")
    mlp = all_reduce_sum(row_parallel(z_l, "mlp2"), mesh, MODEL_AXIS)
    mlp = mlp + teb.mlp2.bias.to(fp32)
    return (tok.to(fp32) + mlp).to(dt)
