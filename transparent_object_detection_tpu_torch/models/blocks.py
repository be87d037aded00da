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
from transparent_object_detection_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    all_reduce_sum,
    copy_to_model,
    gather_from_model,
)


def _tracing() -> bool:
    """True while a tracer runs the module (torch.export, torch.compile, a
    fake-tensor mode): tensors hold no data to key a cache on."""
    from torch._guards import detect_fake_mode

    return torch.compiler.is_compiling() or detect_fake_mode() is not None


def _cached(module: nn.Module, tensors, make):
    """`make()` (a module's int8 weights) made once and again whenever one
    of `tensors` changes (its storage or its version), kept in
    `module._int8_cache`. While a tracer runs (torch.export, fake tensors)
    it is made in the traced program and not cached."""
    if _tracing():
        return make()
    key = tuple((t.data_ptr(), t._version) for t in tensors)
    if module._int8_cache is None or module._int8_cache[0] != key:
        module._int8_cache = (key, make())
    return module._int8_cache[1]


def int8_1x1_profitable(m: int, cin: int, cout: int, narrow: bool = False) -> bool:
    """Which eligible 1x1 convs the int8 route takes: the JAX package's
    per-shape table (`_int8_1x1_profitable`, models/blocks.py:36-58), kept
    as a numerics contract (the routed set is part of the function
    computed), not as a tuning for this card. K >= 1,536 with N >= 1,024
    (the C2f cv2, SPPF cv2 and fusion-node reduce family); with `narrow`
    (TOD_INT8_1X1_NARROW) also 512 -> 256 at 100,000 rows and more. `m` is
    the global batch's rows."""
    if cin >= 1536 and cout >= 1024:
        return True
    return narrow and cin == 512 and cout == 256 and m >= 100_000


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
    def forward(ctx, x, weight, bias, eps: float, mesh=None):
        xf = x.float()
        dims = (0, 2, 3)
        count = x.numel() // x.shape[1]
        if mesh is None:
            mean = xf.mean(dims)
            var_raw = (xf * xf).mean(dims) - mean * mean
        else:
            # the global batch's statistics: sums and counts over the data
            # axis (float64 on the wire: the count stays exact)
            stats = torch.cat([xf.sum(dims), (xf * xf).sum(dims),
                               xf.new_full((1,), float(count))]).double()
            all_reduce_sum(stats, mesh, DATA_AXIS)
            c = x.shape[1]
            count = stats[-1]  # kept on the device: a compiled step reads no host value
            mean = (stats[:c] / count).float()
            var_raw = (stats[c:2 * c] / count).float() - mean * mean
        var = var_raw.clamp(min=0.0)
        r = torch.rsqrt(var + eps)
        mul = r * weight
        y = (xf - mean[:, None, None]) * mul[:, None, None] + bias[:, None, None]
        ctx.save_for_backward(x, mean, r, weight, var_raw > 0)
        ctx.mark_non_differentiable(mean, var)
        ctx.mesh, ctx.count = mesh, count
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, mean, r, weight, var_live = ctx.saved_tensors
        dims = (0, 2, 3)
        count = ctx.count
        xc = x.float() - mean[:, None, None]
        dyf = dy.float()
        sum_dy = dyf.sum(dims)
        sum_dy_xc = (dyf * xc).sum(dims)
        # dx takes the global sums (the statistics depend on every rank's
        # rows); the weight and bias gradients stay this rank's share, which
        # the gradient all-reduce sums
        g_dy, g_dy_xc = sum_dy, sum_dy_xc
        if ctx.mesh is not None:
            sums = all_reduce_sum(torch.cat([sum_dy, sum_dy_xc]), ctx.mesh, DATA_AXIS)
            g_dy, g_dy_xc = sums.chunk(2)
        k1 = weight * r
        # the variance term carries no gradient where the clip at 0 held
        k3 = torch.where(var_live, weight * r ** 3, torch.zeros_like(r))
        dx = (dyf * k1[:, None, None] - (k1 * g_dy / count)[:, None, None]
              - xc * (k3 * g_dy_xc / count)[:, None, None])
        return dx.to(x.dtype), sum_dy_xc * r, sum_dy, None, None


@contextlib.contextmanager
def global_batchnorm(module: nn.Module, mesh):
    """Training-mode BatchNorm of `module` on the statistics of the global
    batch: each BatchNorm sums its statistics (and, in the backward, its
    gradient sums) over the mesh's data axis while the context is open. A
    no-op for mesh None."""
    norms = [m for m in module.modules() if isinstance(m, BatchNorm)]
    for m in norms:
        m.mesh = mesh
    try:
        yield
    finally:
        for m in norms:
            m.mesh = None


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
    the unbiased one), except inside a remat recompute (`recomputing`).
    Under `global_batchnorm` the batch is the global one of the data axis."""

    MOMENTUM = 0.9  # flax's running-average decay

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.recomputing = False  # set by `recomputing`
        self.mesh = None  # set by `global_batchnorm`

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x.float(), self.running_mean, self.running_var, self.weight,
                                self.bias, False, 0.0, self.eps)
        y, mean, var = _BatchNormTrain.apply(x, self.weight, self.bias, self.eps, self.mesh)
        if self.recomputing:
            return y
        with torch.no_grad():
            m = self.MOMENTUM
            self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1 - m) * var)
        return y


def model_input(x: torch.Tensor, layer: nn.Module) -> torch.Tensor:
    """The input of `layer` where it is column-parallel (parallel/tp.py's
    generic rule; `tp_mesh` set): its gradient summed over the model axis
    in training; else, and in the forward, `x` itself."""
    mesh = getattr(layer, "tp_mesh", None)
    return x if mesh is None else copy_to_model(x, mesh)


def gather_outputs(y: torch.Tensor, layer: nn.Module, dim: int) -> torch.Tensor:
    """`layer`'s output with its channels (`dim`) all-gathered over the
    model axis, where tensor parallelism keeps only this rank's output
    channels of its weight (parallel/tp.py's generic rule; `tp_mesh` set;
    in training this rank's slice of the gradient passes back); else `y`
    itself."""
    mesh = getattr(layer, "tp_mesh", None)
    return y if mesh is None else gather_from_model(y, mesh, dim)


class ConvBNAct(nn.Module):
    """Conv2d(bias=False) + BatchNorm + SiLU with explicit symmetric k//2
    padding.

    int8_1x1 (serving): an eligible conv (evaluation mode, 1x1, stride 1,
    no groups or dilation, C_in % 128 == 0, C_out % 256 == 0, rows % 256 ==
    0 and `int8_1x1_profitable`) runs as one int8 GEMM (ops/quant_matmul.py)
    with BatchNorm folded into its weights and bias (eps 1e-5) and SiLU in
    its epilogue: the JAX route (blocks.py:101-137). The rows are the global
    batch's, this rank's times `data_shards` (set by `global_rows` for a
    Predictor on a data mesh). `int8_variants.int8_1x1_narrow` is read
    once, here (None reads `Int8Variants.from_env()`). The int8 weights are
    made once and again whenever a parameter changes. Where tensor
    parallelism shards the conv (`tp_mesh`), the route runs on this rank's
    output columns (per-column weight scales, row scales over the whole K:
    those columns of the whole product) and all-gathers them.
    `attention_impl` "plain" runs the route's plain versions
    (`set_attention_impl`)."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 1,
                 strides: int = 1, groups: int = 1, dilation: int = 1, act: bool = True,
                 dtype: torch.dtype = torch.bfloat16, int8_1x1: bool = False,
                 int8_variants: Optional[Int8Variants] = None):
        super().__init__()
        self.dtype, self.act = dtype, act
        self.conv = nn.Conv2d(in_features, features, kernel_size, strides,
                              autopad(kernel_size, None, dilation), dilation, groups,
                              bias=False)
        self.bn = BatchNorm(features)
        self.int8_1x1 = int8_1x1
        self.int8_narrow = int8_1x1 and (int8_variants or Int8Variants.from_env()).int8_1x1_narrow
        self.data_shards = 1  # set by `global_rows`
        self.attention_impl = None
        self._int8_cache = None

    def int8_route(self, x: torch.Tensor) -> bool:
        """Whether this call takes the int8 route (the gates above)."""
        c = self.conv
        if not (self.int8_1x1 and not self.training and c.kernel_size == (1, 1)
                and c.stride == (1, 1) and c.groups == 1 and c.dilation == (1, 1)):
            return False
        b, cin, h, w = x.shape
        m = b * h * w * self.data_shards
        return (cin % 128 == 0 and c.out_channels % 256 == 0 and m % 256 == 0
                and int8_1x1_profitable(m, cin, c.out_channels, self.int8_narrow))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.int8_route(x):
            return self._forward_int8(x)
        c = self.conv
        x = F.conv2d(model_input(x, c).to(self.dtype), c.weight.to(self.dtype), None, c.stride,
                     c.padding, c.dilation, c.groups)
        x = self.bn(gather_outputs(x, c, 1)).to(self.dtype)
        return F.silu(x) if self.act else x

    @torch.no_grad()
    def _prepare_int8(self):
        c, bn = self.conv, self.bn
        w = c.weight.float().reshape(c.weight.shape[0], -1)
        # the fold of `fuse_conv_bn` (gamma / sqrt(var + eps); JAX takes
        # gamma * rsqrt, an ulp away): a fused model, whose BatchNorm holds
        # weight 1, mean 0 and var 1 - eps, folds to the same bits
        factor = bn.weight / torch.sqrt(bn.running_var + bn.eps)
        bias = bn.bias - bn.running_mean * factor
        n = w.shape[0]
        if n != factor.numel():  # a tensor-parallel shard: this rank's output columns
            r = c.tp_mesh.index(MODEL_AXIS)
            factor, bias = factor[r * n:(r + 1) * n], bias[r * n:(r + 1) * n]
        return prepare_weights(w * factor[:, None], bias)

    def _forward_int8(self, x: torch.Tensor) -> torch.Tensor:
        bn = self.bn
        wts = _cached(self, (self.conv.weight, bn.weight, bn.bias, bn.running_mean,
                             bn.running_var), self._prepare_int8)
        y = quant_matmul(x.permute(0, 2, 3, 1), wts, act="silu" if self.act else None,
                         out_dtype=self.dtype, impl=self.attention_impl)
        return gather_outputs(y, self.conv, -1).permute(0, 3, 1, 2)


@contextlib.contextmanager
def global_rows(module: nn.Module, shards: int):
    """The int8 1x1 route of `module`'s convs gated on the global batch's
    rows while the context is open: `shards` data ranks, each running its
    rows (a Predictor on a data mesh), or `shards` equal parts of a batch
    (inference.run_program). Nested contexts multiply (a mesh batch in
    parts). A no-op for one shard."""
    convs = ([m for m in module.modules() if isinstance(m, ConvBNAct) and m.int8_1x1]
             if shards > 1 else [])
    before = [m.data_shards for m in convs]
    for m in convs:
        m.data_shards *= shards
    try:
        yield
    finally:
        for m, n in zip(convs, before):
            m.data_shards = n


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
    Bottlenecks (m0, m1, ...) on the running half -> concat -> 1x1 conv.
    int8_1x1: the int8 route for cv1 and cv2 (see ConvBNAct)."""

    def __init__(self, in_features: int, features: int, n: int = 1,
                 shortcut: bool = False, groups: int = 1, expansion: float = 0.5,
                 dtype: torch.dtype = torch.bfloat16, int8_1x1: bool = False,
                 int8_variants: Optional[Int8Variants] = None):
        super().__init__()
        self.hidden = hidden = int(features * expansion)
        self.n = n
        i8 = dict(int8_1x1=int8_1x1, int8_variants=int8_variants)
        self.cv1 = ConvBNAct(in_features, 2 * hidden, 1, dtype=dtype, **i8)
        for i in range(n):
            setattr(self, f"m{i}", Bottleneck(hidden, hidden, shortcut, groups, (3, 3), 1.0,
                                              dtype=dtype))
        self.cv2 = ConvBNAct((2 + n) * hidden, features, 1, dtype=dtype, **i8)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv1(x)
        parts = [y[:, :self.hidden], y[:, self.hidden:]]
        for i in range(self.n):
            parts.append(getattr(self, f"m{i}")(parts[-1]))
        return self.cv2(torch.cat(parts, dim=1))


class SPPF(nn.Module):
    """Spatial pyramid pooling, fast variant (max pools pad with -inf).
    int8_1x1: the int8 route for cv1 and cv2 (see ConvBNAct)."""

    def __init__(self, in_features: int, features: int, pool_size: int = 5,
                 dtype: torch.dtype = torch.bfloat16, int8_1x1: bool = False,
                 int8_variants: Optional[Int8Variants] = None):
        super().__init__()
        self.pool_size = pool_size
        i8 = dict(int8_1x1=int8_1x1, int8_variants=int8_variants)
        self.cv1 = ConvBNAct(in_features, in_features // 2, 1, dtype=dtype, **i8)
        self.cv2 = ConvBNAct(in_features // 2 * 4, features, 1, dtype=dtype, **i8)

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
    if getattr(layer, "tp_mesh", None) is not None:  # outputs sharded: bias after the gather
        y = F.linear(model_input(x, layer).to(dtype), layer.weight.to(dtype))
        y = gather_outputs(y, layer, -1)
        return y if bias is None else y + bias
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
    training mode runs the bf16 branch, as JAX does.

    tp_serving: the block runs tensor-parallel (ops/teb_tp.py) on the mesh
    in `tp_mesh`, its parameters holding this rank's shards with the qkv
    rows canonicalized (parallel/tp.py): the serving form in evaluation
    mode, the training form in training mode. Only `inference.Predictor`
    (`tp_serving_copy`) and `parallel.tp.shard_train_state_tp` set it up;
    without a mesh the forward raises."""

    def __init__(self, features: int, num_heads: int = 8, mlp_ratio: int = 4,
                 dtype: torch.dtype = torch.bfloat16, attention_impl: Optional[str] = None,
                 norm_dtype: torch.dtype = torch.float32, lane_align_heads: bool = True,
                 int8_dense: bool = False, int8_attn: bool = False,
                 int8_variants: Optional[Int8Variants] = None, tp_serving: bool = False):
        super().__init__()
        c = features
        self.dtype, self.norm_dtype, self.attention_impl = dtype, norm_dtype, attention_impl
        self.int8_dense, self.int8_attn = int8_dense, int8_attn
        self.mlp_ratio = mlp_ratio
        self.tp_serving, self.tp_mesh = tp_serving, None
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
        if self.tp_serving:
            from transparent_object_detection_tpu_torch.ops import teb_tp

            fn = teb_tp.teb_tp_train_forward if self.training else teb_tp.teb_tp_forward
            return _from_tokens(fn(tokens, self), h, w)
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
        whenever a parameter changes. While a tracer runs (torch.export,
        fake tensors) they are made in the traced program and not cached."""
        params = [p for m in (self.norm1, self.qkv, self.attn_out, self.norm2, self.mlp1,
                              self.mlp2) for p in m.parameters()]
        return _cached(self, params, self._prepare_int8)

    @torch.no_grad()
    def _prepare_int8(self):
        if self.tp_serving:
            # JAX's TP routes: the LN folds into the column-parallel qkv and
            # mlp1 shards; the row-parallel shards carry no bias (it is added
            # after the all-reduce) and quantize their rows over K/tp
            return {
                "qkv": prepare_weights(self.qkv.weight, self.qkv.bias, self.norm1.weight,
                                       self.norm1.bias),
                "attn_out": prepare_weights(self.attn_out.weight),
                "mlp1": prepare_weights(self.mlp1.weight, self.mlp1.bias, self.norm2.weight,
                                        self.norm2.bias),
                "mlp2": prepare_weights(self.mlp2.weight),
            }
        prep = {
            "qkv": prepare_weights(self.qkv.weight, self.qkv.bias, self.norm1.weight,
                                   self.norm1.bias),
            "attn_out": prepare_weights(self.attn_out.weight, self.attn_out.bias),
            "mlp1": prepare_weights(self.mlp1.weight, self.mlp1.bias, self.norm2.weight,
                                    self.norm2.bias),
            "mlp2": prepare_weights(self.mlp2.weight, self.mlp2.bias),
        }
        if self.int8_variants.w4a4_mlp1:
            prep["mlp1_w4"] = prepare_weights4(self.mlp1.weight, self.mlp1.bias,
                                               self.norm2.weight, self.norm2.bias)
        return prep

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


class QuantDense(nn.Module):
    """Dense layer on int8 weights and activations (JAX `QuantDense`,
    blocks.py:347-395), with nn.Linear's parameters (`weight` (out, in) and
    `bias`, fp32), so one checkpoint serves it and a Dense: the weight
    bridge maps a JAX Dense or QuantDense tree onto it. Weights per output
    channel at absmax / 127, rows of x per token at absmax / 127, int32
    products, then acc * x_scale * w_scale + bias in `dtype`. It runs
    `quant_matmul` (quant_rows then qmm on the card): the weights are
    quantized as JAX does; a row is quantized by a multiply with 127 / amax
    where JAX divides by amax / 127, so a value on a rounding boundary may
    land one step away. The int8 weights are made once and again whenever a
    parameter changes. No gradient reaches the weights (JAX's has no
    training form either). `attention_impl` "plain" runs the plain
    versions."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(features, in_features))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
        nn.init.kaiming_uniform_(self.weight, a=math.sqrt(5))
        self.attention_impl = None
        self._int8_cache = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        params = [p for p in (self.weight, self.bias) if p is not None]
        wts = _cached(self, params, lambda: prepare_weights(self.weight.detach(),
                                                            None if self.bias is None
                                                            else self.bias.detach()))
        return quant_matmul(x, wts, out_dtype=self.dtype, impl=self.attention_impl)


@torch.no_grad()
def fuse_conv_bn(state_dict, eps: float = 1e-5):
    """Fold every {conv, bn} ConvBNAct pair of a state_dict: a transform of
    the names and tensors only (JAX `fuse_conv_bn`, a pytree transform of
    {params, batch_stats}). The conv weight absorbs gamma / sqrt(var + eps)
    per output channel; the BN collapses to a per-channel bias (weight 1,
    bias beta - mean * factor, running_mean 0, running_var 1 - eps). The
    keys are unchanged, so the same modules run the fused state. Returns a
    new dict; other entries are passed through."""
    out = dict(state_dict)
    for key in state_dict:
        if not key.endswith(".bn.running_mean"):
            continue
        prefix = key[: -len("bn.running_mean")]
        conv = prefix + "conv.weight"
        if conv not in state_dict:
            continue
        gamma, beta = state_dict[prefix + "bn.weight"], state_dict[prefix + "bn.bias"]
        mean, var = state_dict[key], state_dict[prefix + "bn.running_var"]
        factor = gamma / torch.sqrt(var + eps)
        out[conv] = state_dict[conv] * factor[:, None, None, None]
        out[prefix + "bn.weight"] = torch.ones_like(gamma)
        out[prefix + "bn.bias"] = beta - mean * factor
        out[key] = torch.zeros_like(mean)
        out[prefix + "bn.running_var"] = torch.ones_like(var) - eps
    return out
