"""Network blocks of the PyTorch port: bf16 and int8 serving branches, and
training mode (`nn.Module.train()`, the counterpart of flax's `train=True`).

Counterpart of transparent_object_detection_tpu/models/blocks.py. Tensors are
NCHW inside (channels_last memory on the card); attention tokens are
(B, N, C). Module and parameter names follow the flax tree one to one, so
weights.py maps a JAX checkpoint mechanically.

Compute policy, as the flax modules' `dtype=bf16, param_dtype=fp32`:
parameters are stored in fp32 and cast to the compute type at use (no
autocast); BatchNorm normalises in fp32 before the cast; LayerNorm runs in
`norm_dtype` (fp32) with the flax epsilon 1e-6; GELU is the tanh form.
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from transparent_object_detection_tpu_torch.config import Int8Variants
from transparent_object_detection_tpu_torch.ops.attention import attention, attention_qkv
from transparent_object_detection_tpu_torch.ops.attention_int8 import (
    attention_int8_quant_out,
    teb_attention_handoff,
)
from transparent_object_detection_tpu_torch.ops.quant_matmul import (
    dequantize,
    ln_handoff,
    prepare_weights,
    prepare_weights4,
    quant_matmul,
    quant_matmul_w4a4,
)


def autopad(k: int, p: Optional[int] = None, d: int = 1) -> int:
    """'same'-output padding for odd kernels, dilation included."""
    if d > 1:
        k = d * (k - 1) + 1
    if p is None:
        p = k // 2
    return p


class _BatchNormTrain(torch.autograd.Function):
    """Training-mode BatchNorm as flax computes it: statistics over (B, H, W)
    in fp32, the fast variance E[x^2] - E[x]^2 clipped at 0, normalisation
    with those batch statistics, y = (x - mean) * rsqrt(var + eps) * w + b.
    The backward is that function's gradient written out, so only x (in its
    own type) and per-channel vectors are kept for it, not fp32 copies of
    the activation. Returns y (fp32) and the batch mean and biased variance
    (no gradient)."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps: float):
        xf = x.float()
        dims = (0, 2, 3)
        mean = xf.mean(dims)
        var_raw = (xf * xf).mean(dims) - mean * mean
        var = var_raw.clamp(min=0.0)
        r = torch.rsqrt(var + eps)
        mul = r * weight
        y = (xf - mean[:, None, None]) * mul[:, None, None] + bias[:, None, None]
        ctx.save_for_backward(x, mean, r, weight, var_raw > 0)
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, mean, r, weight, var_live = ctx.saved_tensors
        dims = (0, 2, 3)
        count = x.numel() // x.shape[1]
        xc = x.float() - mean[:, None, None]
        dyf = dy.float()
        sum_dy = dyf.sum(dims)
        sum_dy_xc = (dyf * xc).sum(dims)
        k1 = weight * r
        # the variance term carries no gradient where the clip at 0 held
        k3 = torch.where(var_live, weight * r ** 3, torch.zeros_like(r))
        dx = (dyf * k1[:, None, None] - (k1 * sum_dy / count)[:, None, None]
              - xc * (k3 * sum_dy_xc / count)[:, None, None])
        return dx.to(x.dtype), sum_dy_xc * r, sum_dy, None


@contextlib.contextmanager
def recomputing(module: nn.Module):
    """The context of a remat recompute of `module` (`torch.utils.checkpoint`'s
    recompute context): its BatchNorms compute their batch statistics but
    leave their running statistics alone, which the first forward already
    moved (in flax the recompute is pure)."""
    norms = [m for m in module.modules() if isinstance(m, BatchNorm)]
    for m in norms:
        m.recomputing = True
    try:
        yield
    finally:
        for m in norms:
            m.recomputing = False


class BatchNorm(nn.Module):
    """BatchNorm (eps 1e-5, momentum 0.9) normalising in fp32; parameters
    weight/bias and buffers running_mean/running_var, as flax
    scale/bias + batch_stats mean/var. Evaluation mode normalises with the
    running statistics. Training mode normalises with the batch statistics
    (`_BatchNormTrain`) and updates r <- 0.9 r + 0.1 batch with the biased
    batch variance, as flax does (F.batch_norm would update running_var with
    the unbiased one), except inside a remat recompute (`recomputing`)."""

    MOMENTUM = 0.9  # flax's running-average decay

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.recomputing = False  # set by `recomputing`

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x.float(), self.running_mean, self.running_var, self.weight,
                                self.bias, False, 0.0, self.eps)
        y, mean, var = _BatchNormTrain.apply(x, self.weight, self.bias, self.eps)
        if self.recomputing:
            return y
        with torch.no_grad():
            m = self.MOMENTUM
            self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1 - m) * var)
        return y


class ConvBNAct(nn.Module):
    """Conv2d(bias=False) + BatchNorm + SiLU with explicit symmetric k//2
    padding."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 1,
                 strides: int = 1, groups: int = 1, dilation: int = 1, act: bool = True,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype, self.act = dtype, act
        self.conv = nn.Conv2d(in_features, features, kernel_size, strides,
                              autopad(kernel_size, None, dilation), dilation, groups,
                              bias=False)
        self.bn = BatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.conv
        x = F.conv2d(x.to(self.dtype), c.weight.to(self.dtype), None, c.stride, c.padding,
                     c.dilation, c.groups)
        x = self.bn(x).to(self.dtype)
        return F.silu(x) if self.act else x


class Bottleneck(nn.Module):
    """Two stacked convs with an optional residual add."""

    def __init__(self, in_features: int, features: int, shortcut: bool = True,
                 groups: int = 1, kernels: Tuple[int, int] = (3, 3),
                 expansion: float = 0.5, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        hidden = int(features * expansion)
        self.cv1 = ConvBNAct(in_features, hidden, kernels[0], dtype=dtype)
        self.cv2 = ConvBNAct(hidden, features, kernels[1], groups=groups, dtype=dtype)
        self.add = shortcut and in_features == features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C2f(nn.Module):
    """CSP bottleneck, 2-conv variant: 1x1 conv -> split halves -> chain n
    Bottlenecks (m0, m1, ...) on the running half -> concat -> 1x1 conv."""

    def __init__(self, in_features: int, features: int, n: int = 1,
                 shortcut: bool = False, groups: int = 1, expansion: float = 0.5,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.hidden = hidden = int(features * expansion)
        self.n = n
        self.cv1 = ConvBNAct(in_features, 2 * hidden, 1, dtype=dtype)
        for i in range(n):
            setattr(self, f"m{i}", Bottleneck(hidden, hidden, shortcut, groups, (3, 3), 1.0,
                                              dtype=dtype))
        self.cv2 = ConvBNAct((2 + n) * hidden, features, 1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv1(x)
        parts = [y[:, :self.hidden], y[:, self.hidden:]]
        for i in range(self.n):
            parts.append(getattr(self, f"m{i}")(parts[-1]))
        return self.cv2(torch.cat(parts, dim=1))


class SPPF(nn.Module):
    """Spatial pyramid pooling, fast variant (max pools pad with -inf)."""

    def __init__(self, in_features: int, features: int, pool_size: int = 5,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.pool_size = pool_size
        self.cv1 = ConvBNAct(in_features, in_features // 2, 1, dtype=dtype)
        self.cv2 = ConvBNAct(in_features // 2 * 4, features, 1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.pool_size
        pools = [self.cv1(x)]
        for _ in range(3):
            pools.append(F.max_pool2d(pools[-1], k, 1, k // 2))
        return self.cv2(torch.cat(pools, dim=1))


def dfl_expectation(dist_logits: torch.Tensor, reg_max: int = 16) -> torch.Tensor:
    """Distribution-focal decode: softmax over bins -> expected distance.
    (..., 4, reg_max) logits -> (..., 4), in fp32."""
    probs = torch.softmax(dist_logits.float(), dim=-1)
    proj = torch.arange(reg_max, dtype=torch.float32, device=dist_logits.device)
    return probs @ proj


def _linear(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


class CBAM(nn.Module):
    """Channel gate (avg+max pool -> shared bias-free MLP of width
    max(C//16, 1) -> sigmoid) then spatial gate ([mean, max] over channels ->
    7x7 conv -> sigmoid)."""

    def __init__(self, features: int, reduction: int = 16, kernel_size: int = 7,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        hidden = max(features // reduction, 1)
        self.fc1 = nn.Linear(features, hidden, bias=False)
        self.fc2 = nn.Linear(hidden, features, bias=False)
        self.spatial = nn.Conv2d(2, 1, kernel_size, padding=kernel_size // 2, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        mlp = lambda t: _linear(F.relu(_linear(t, self.fc1, dt)), self.fc2, dt)
        gate_c = torch.sigmoid(mlp(x.mean(dim=(2, 3))) + mlp(x.amax(dim=(2, 3))))
        x = x * gate_c[:, :, None, None]
        pooled = torch.cat([x.mean(dim=1, keepdim=True), x.amax(dim=1, keepdim=True)], dim=1)
        sp = self.spatial
        gate_s = F.conv2d(pooled, sp.weight.to(dt), None, 1, sp.padding)
        return x * torch.sigmoid(gate_s)


def _to_tokens(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, H*W, C); a view for channels_last memory."""
    b, c, h, w = x.shape
    return x.permute(0, 2, 3, 1).reshape(b, h * w, c)


def _from_tokens(t: torch.Tensor, h: int, w: int) -> torch.Tensor:
    b, _, c = t.shape
    return t.reshape(b, h, w, c).permute(0, 3, 1, 2)


class SelfAttention(nn.Module):
    """Non-local self-attention: q/k at max(C//8, 1) channels, v at C,
    unscaled softmax, residual gated by the learnable scalar gamma (init 0).
    int8_attn: the int8 flash route on large maps (serving; in training
    mode the differentiable bf16 route runs instead, as in JAX)."""

    def __init__(self, features: int, dtype: torch.dtype = torch.bfloat16,
                 attention_impl: Optional[str] = None, int8_attn: bool = False):
        super().__init__()
        self.dtype, self.attention_impl, self.int8_attn = dtype, attention_impl, int8_attn
        cq = max(features // 8, 1)
        self.query = nn.Linear(features, cq)
        self.key = nn.Linear(features, cq)
        self.value = nn.Linear(features, features)
        self.gamma = nn.Parameter(torch.zeros(1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        h, w = x.shape[2:]
        tokens = _to_tokens(x)
        q = _linear(tokens, self.query, dt)
        k = _linear(tokens, self.key, dt)
        v = _linear(tokens, self.value, dt)
        out = attention(q, k, v, scale=1.0, impl=self.attention_impl, int8=self.int8_attn,
                        train=self.training)
        out = self.gamma.to(dt) * out + tokens
        return _from_tokens(out, h, w)


def _pick_num_heads(channels: int, requested: int, lane_align: bool = True) -> int:
    """Head count <= requested dividing the channel width; with lane_align,
    the largest one whose head width is a multiple of 128 when one exists
    (the JAX package's rule, kept because the grouping is part of the
    function: 6 heads of 256 on the phi='s' 1536-channel TEBs)."""
    if lane_align:
        for h in range(min(requested, channels), 0, -1):
            if channels % h == 0 and (channels // h) % 128 == 0:
                return h
    for h in range(min(requested, channels), 0, -1):
        if channels % h == 0:
            return h
    return 1


class TransformerEncoderBlock(nn.Module):
    """Pre-LN transformer encoder over the H*W tokens of each image (not
    tensor-parallel). Attention reads the packed qkv projection output in
    place; in training mode through the differentiable flash route, whose
    gradient is one packed d(qkv).

    int8_dense: the four projections run as int8 GEMMs (ops/quant_matmul.py)
    with the JAX int8 branch's handoffs: mlp1's quant_out payload into mlp2
    always, and the routes that `int8_variants` selects (the LN2-normalized
    attn_out -> mlp1 payload from its row floor up by default; the
    attention handoff, the attention quant_out and the w4a4 mlp1 when
    switched on). None reads `Int8Variants.from_env()` once, here. The
    parameters are the bf16 branch's, so one checkpoint serves both.
    int8_attn: the int8 flash route. Both int8 flags are serving-only:
    training mode runs the bf16 branch, as JAX does."""

    def __init__(self, features: int, num_heads: int = 8, mlp_ratio: int = 4,
                 dtype: torch.dtype = torch.bfloat16, attention_impl: Optional[str] = None,
                 norm_dtype: torch.dtype = torch.float32, lane_align_heads: bool = True,
                 int8_dense: bool = False, int8_attn: bool = False,
                 int8_variants: Optional[Int8Variants] = None):
        super().__init__()
        c = features
        self.dtype, self.norm_dtype, self.attention_impl = dtype, norm_dtype, attention_impl
        self.int8_dense, self.int8_attn = int8_dense, int8_attn
        self.int8_variants = int8_variants or Int8Variants.from_env()
        self.heads = _pick_num_heads(c, num_heads, lane_align_heads)
        self.scale = 1.0 / math.sqrt(c // self.heads)
        self.norm1 = nn.LayerNorm(c, eps=1e-6)
        self.qkv = nn.Linear(c, 3 * c)
        self.attn_out = nn.Linear(c, c)
        self.norm2 = nn.LayerNorm(c, eps=1e-6)
        self.mlp1 = nn.Linear(c, c * mlp_ratio)
        self.mlp2 = nn.Linear(c * mlp_ratio, c)
        self._int8_cache = None

    def _norm(self, x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
        nd = self.norm_dtype
        return F.layer_norm(x.to(nd), ln.normalized_shape, ln.weight.to(nd), ln.bias.to(nd),
                            ln.eps).to(self.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        h, w = x.shape[2:]
        tokens = _to_tokens(x)
        if self.int8_dense and not self.training:
            return _from_tokens(self._forward_int8(tokens), h, w)
        qkv = _linear(self._norm(tokens, self.norm1), self.qkv, dt)
        o = attention_qkv(qkv, scale=self.scale, impl=self.attention_impl,
                          num_heads=self.heads, int8=self.int8_attn, train=self.training)
        tokens = tokens + _linear(o, self.attn_out, dt)
        z = _linear(self._norm(tokens, self.norm2), self.mlp1, dt)
        z = _linear(F.gelu(z, approximate="tanh"), self.mlp2, dt)
        return _from_tokens(tokens + z, h, w)

    def _int8_weights(self):
        """The projections' int8 weights (LN1 folded into qkv, LN2 into
        mlp1; with w4a4, also mlp1's int4-range weights), made once and again
        whenever a parameter changes."""
        params = [p for m in (self.norm1, self.qkv, self.attn_out, self.norm2, self.mlp1,
                              self.mlp2) for p in m.parameters()]
        key = tuple((p.data_ptr(), p._version) for p in params)
        if self._int8_cache is None or self._int8_cache[0] != key:
            with torch.no_grad():
                prep = {
                    "qkv": prepare_weights(self.qkv.weight, self.qkv.bias, self.norm1.weight,
                                           self.norm1.bias),
                    "attn_out": prepare_weights(self.attn_out.weight, self.attn_out.bias),
                    "mlp1": prepare_weights(self.mlp1.weight, self.mlp1.bias,
                                            self.norm2.weight, self.norm2.bias),
                    "mlp2": prepare_weights(self.mlp2.weight, self.mlp2.bias),
                }
                if self.int8_variants.w4a4_mlp1:
                    prep["mlp1_w4"] = prepare_weights4(self.mlp1.weight, self.mlp1.bias,
                                                       self.norm2.weight, self.norm2.bias)
            self._int8_cache = (key, prep)
        return self._int8_cache[1]

    def _forward_int8(self, tokens: torch.Tensor) -> torch.Tensor:
        """The JAX int8 TEB branch (blocks.py:566-747) with its routes as
        `int8_variants` selects them. impl="plain" takes the same routes with
        the plain versions (JAX takes them for impl None or "pallas")."""
        dt, impl, var = self.dtype, self.attention_impl, self.int8_variants
        b, n, c = tokens.shape
        heads = self.heads
        dh = c // heads
        wts = self._int8_weights()
        qmm = lambda x, name, **kw: quant_matmul(x, wts[name], out_dtype=dt, impl=impl, **kw)
        w4a4 = (var.w4a4_mlp1 and (b * n) % 128 == 0 and c % 128 == 0
                and self.mlp1.out_features % 128 == 0)
        ln_out = (not w4a4 and var.ln_handoff
                  and ln_handoff(b * n, c, var.ln_handoff_min_rows))

        def attn_out_call(o_val, o_quant=None):
            """attn_out + residual -> (tokens, LN2-normalized payload for
            mlp1 or None); o_quant is an int8 attention output (x_quant)."""
            if ln_out:
                t, zq, zs = qmm(o_val, "attn_out", residual=tokens, x_quant=o_quant,
                                ln_quant_out=True, ln_eps=self.norm2.eps)
                return t, (zq, zs)
            return qmm(o_val, "attn_out", residual=tokens, x_quant=o_quant), None

        big = self.int8_attn and n > 1024
        handoff = None
        if big and var.attn_handoff:
            # qkv emits int8 + scale groups that cover whole heads; attention
            # consumes them (k/v requantized per key block)
            qkv8 = qmm(tokens, "qkv", ln=True, ln_eps=self.norm1.eps, quant_out=True,
                       quant_out_align=(c, dh))
            handoff = teb_attention_handoff(qkv8[0], qkv8[1], heads, self.scale,
                                            quant_out=True, out_dtype=dt, impl=impl)
            if handoff is None:
                qkv = dequantize(qkv8[0], qkv8[1], dt)
        else:
            qkv = qmm(tokens, "qkv", ln=True, ln_eps=self.norm1.eps)
        if handoff is not None:
            tokens, z_in = attn_out_call(None, handoff)
        else:
            oq = None
            if big and dh % 128 == 0 and var.attn_qout:
                oq = attention_int8_quant_out(qkv, qkv[..., c:2 * c], qkv[..., 2 * c:],
                                              self.scale, heads, q_width=c, impl=impl)
            if oq is not None:
                tokens, z_in = attn_out_call(None, oq)
            else:
                o = attention_qkv(qkv, scale=self.scale, impl=impl, num_heads=heads,
                                  int8=self.int8_attn)
                tokens, z_in = attn_out_call(o)
        if z_in is not None:
            z8 = qmm(None, "mlp1", ln=True, act="gelu", quant_out=True, x_quant=z_in,
                     x_quant_normalized=True)
        elif w4a4:
            z8 = quant_matmul_w4a4(tokens, wts["mlp1_w4"], ln=True, ln_eps=self.norm2.eps,
                                   act="gelu", out_dtype=dt, quant_out=True, impl=impl)
        else:
            z8 = qmm(tokens, "mlp1", ln=True, ln_eps=self.norm2.eps, act="gelu",
                     quant_out=True)
        return qmm(None, "mlp2", residual=tokens, x_quant=z8)
