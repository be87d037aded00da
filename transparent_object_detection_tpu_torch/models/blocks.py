"""Network blocks of the PyTorch port (bf16 and int8 serving branches).

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

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from transparent_object_detection_tpu_torch.ops.attention import attention, attention_qkv
from transparent_object_detection_tpu_torch.ops.quant_matmul import (
    ln_handoff,
    prepare_weights,
    quant_matmul,
)


def autopad(k: int, p: Optional[int] = None, d: int = 1) -> int:
    """'same'-output padding for odd kernels, dilation included."""
    if d > 1:
        k = d * (k - 1) + 1
    if p is None:
        p = k // 2
    return p


class BatchNorm(nn.Module):
    """Inference BatchNorm (eps 1e-5) normalising in fp32; parameters
    weight/bias and buffers running_mean/running_var, as flax
    scale/bias + batch_stats mean/var."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x.float(), self.running_mean, self.running_var, self.weight,
                            self.bias, False, 0.0, self.eps)


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
    int8_attn: the int8 flash route on large maps (serving)."""

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
        out = attention(q, k, v, scale=1.0, impl=self.attention_impl, int8=self.int8_attn)
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
    """Pre-LN transformer encoder over the H*W tokens of each image
    (evaluation only; not tensor-parallel). Attention reads the packed qkv
    projection output in place.

    int8_dense: the four projections run as int8 GEMMs (ops/quant_matmul.py)
    with the JAX int8 branch's handoffs at their defaults: the LN2-normalized
    attn_out -> mlp1 payload from LN_HANDOFF_MIN_ROWS rows up, and mlp1's
    quant_out payload into mlp2. The parameters are the bf16 branch's, so
    one checkpoint serves both. int8_attn: the int8 flash route."""

    def __init__(self, features: int, num_heads: int = 8, mlp_ratio: int = 4,
                 dtype: torch.dtype = torch.bfloat16, attention_impl: Optional[str] = None,
                 norm_dtype: torch.dtype = torch.float32, lane_align_heads: bool = True,
                 int8_dense: bool = False, int8_attn: bool = False):
        super().__init__()
        c = features
        self.dtype, self.norm_dtype, self.attention_impl = dtype, norm_dtype, attention_impl
        self.int8_dense, self.int8_attn = int8_dense, int8_attn
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
        if self.int8_dense:
            return _from_tokens(self._forward_int8(tokens), h, w)
        qkv = _linear(self._norm(tokens, self.norm1), self.qkv, dt)
        o = attention_qkv(qkv, scale=self.scale, impl=self.attention_impl,
                          num_heads=self.heads, int8=self.int8_attn)
        tokens = tokens + _linear(o, self.attn_out, dt)
        z = _linear(self._norm(tokens, self.norm2), self.mlp1, dt)
        z = _linear(F.gelu(z, approximate="tanh"), self.mlp2, dt)
        return _from_tokens(tokens + z, h, w)

    def _int8_weights(self):
        """The projections' int8 weights (LN1 folded into qkv, LN2 into
        mlp1), made once and again whenever a parameter changes."""
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
            self._int8_cache = (key, prep)
        return self._int8_cache[1]

    def _forward_int8(self, tokens: torch.Tensor) -> torch.Tensor:
        """The JAX int8 TEB branch at its defaults (blocks.py:566-747)."""
        dt, impl = self.dtype, self.attention_impl
        b, n, c = tokens.shape
        wts = self._int8_weights()
        qmm = lambda x, name, **kw: quant_matmul(x, wts[name], out_dtype=dt, impl=impl, **kw)
        qkv = qmm(tokens, "qkv", ln=True, ln_eps=self.norm1.eps)
        o = attention_qkv(qkv, scale=self.scale, impl=impl, num_heads=self.heads,
                          int8=self.int8_attn)
        if ln_handoff(b * n, c):
            tokens, zq, zs = qmm(o, "attn_out", residual=tokens, ln_quant_out=True,
                                 ln_eps=self.norm2.eps)
            z8 = qmm(None, "mlp1", ln=True, act="gelu", quant_out=True, x_quant=(zq, zs),
                     x_quant_normalized=True)
        else:
            tokens = qmm(o, "attn_out", residual=tokens)
            z8 = qmm(tokens, "mlp1", ln=True, ln_eps=self.norm2.eps, act="gelu",
                     quant_out=True)
        return qmm(None, "mlp2", residual=tokens, x_quant=z8)
