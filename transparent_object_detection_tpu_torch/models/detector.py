"""Full detector (counterpart of
transparent_object_detection_tpu/models/detector.py): FocusModel = Backbone
-> Neck -> Head; the evaluation forward ends in the on-device DFL decode,
the training forward (`model.train()`) in the raw maps."""
from __future__ import annotations

import dataclasses
import operator
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from transparent_object_detection_tpu_torch.config import Int8Variants, ModelConfig
from transparent_object_detection_tpu_torch.models.backbone import Backbone
from transparent_object_detection_tpu_torch.models.blocks import ConvBNAct
from transparent_object_detection_tpu_torch.models.head import BranchTower, Head
from transparent_object_detection_tpu_torch.models.neck import Neck


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. Without a card and without an explicit device, raise; there is
    no silent CPU fallback."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the GPU; pass device='cpu' "
                "explicitly to run the plain PyTorch versions on the CPU"
            )
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    return device


class FocusModel(nn.Module):
    """The FOCUS detector graph."""

    def __init__(self, num_classes: int = 1, base_channels: int = 128, base_depth: int = 2,
                 deep_mul: float = 0.5, num_heads: int = 8, reg_max: int = 16,
                 strides: Tuple[int, int, int] = (8, 16, 32),
                 dtype: torch.dtype = torch.bfloat16, norm_dtype: torch.dtype = torch.float32,
                 lane_align_heads: bool = True, attention_impl: Optional[str] = None,
                 int8_dense: bool = False, int8_attn: bool = False,
                 int8_variants: Optional[Int8Variants] = None, remat: bool = False,
                 tp_serving: bool = False, int8_1x1: bool = False):
        super().__init__()
        self.dtype = dtype
        # tensor-parallel serving of the neck TEBs (ops/teb_tp.py): set, with
        # the mesh and the sharded weights, on a Predictor's own copy
        # (parallel.tp.tp_serving_copy); a model built with it alone raises
        self.tp_serving = tp_serving
        self.backbone = Backbone(base_channels, base_depth, deep_mul, dtype, attention_impl,
                                 int8_attn, int8_1x1, int8_variants)
        self.neck = Neck(base_channels, base_depth, deep_mul, num_heads, dtype, norm_dtype,
                         lane_align_heads, attention_impl, int8_dense, int8_attn,
                         int8_variants, remat, tp_serving, int8_1x1)
        filters = (base_channels * 4, base_channels * 8, int(base_channels * 16 * deep_mul))
        self.head = Head(num_classes, filters, strides, reg_max, dtype)

    def forward(self, images: torch.Tensor, decode: bool = True) -> Dict[str, Any]:
        """images: (B, H, W, 3) float in [0, 1], H and W divisible by 32.
        Returns {"raw": per-level (B, h, w, 4*reg_max + nc) maps,
        "decoded": (B, sum(hw), 4 + nc)} (decoded only in evaluation mode
        with decode=True; training mode returns the raw maps alone)."""
        x = images.to(self.dtype).permute(0, 3, 1, 2)
        if x.is_cuda:
            x = x.contiguous(memory_format=torch.channels_last)
        raw = self.head(self.neck(self.backbone(x)))
        out: Dict[str, Any] = {"raw": tuple(raw)}
        if decode and not self.training:
            out["decoded"] = self.head.decode(raw)
        return out


def _model_of(cfg: ModelConfig, attention_impl: Optional[str] = None,
              int8_variants: Optional[Int8Variants] = None) -> FocusModel:
    return FocusModel(
        num_classes=cfg.num_classes, base_channels=cfg.base_channels,
        base_depth=cfg.base_depth, deep_mul=cfg.deep_mul, num_heads=cfg.num_heads,
        reg_max=cfg.reg_max, strides=cfg.strides, dtype=getattr(torch, cfg.compute_dtype),
        norm_dtype=getattr(torch, cfg.norm_dtype), lane_align_heads=cfg.lane_align_heads,
        attention_impl=attention_impl, int8_dense=cfg.int8_dense, int8_attn=cfg.int8_attn,
        int8_variants=int8_variants or Int8Variants.from_env(), remat=cfg.remat,
        int8_1x1=cfg.int8_1x1,
    )


def int8_1x1_routes(cfg: ModelConfig, batch: int,
                    int8_variants: Optional[Int8Variants] = None) -> Dict[str, Tuple[int, int, int]]:
    """The route table of the int8 1x1 convs: {module name: (rows, K, N)} of
    the convs that take the int8 route in one serving forward of `cfg` (with
    int8_1x1 on) at `batch` on one device, each one quant_rows and one qmm
    launch. From shapes alone: the model runs on the meta device."""
    cfg = dataclasses.replace(cfg, int8_1x1=True)
    with torch.device("meta"):
        model = _model_of(cfg, int8_variants=int8_variants).eval()
    routes: Dict[str, Tuple[int, int, int]] = {}

    def record(name):
        def hook(conv, args):
            x = args[0]
            if conv.int8_route(x):
                b, k, h, w = x.shape
                routes[name] = (b * h * w, k, conv.conv.out_channels)
        return hook
    for name, m in model.named_modules():
        if isinstance(m, ConvBNAct) and m.int8_1x1:
            m.register_forward_pre_hook(record(name))
    with torch.no_grad():
        model(torch.zeros(batch, *cfg.input_shape, 3, device="meta"))
    return routes


def build_model(cfg: ModelConfig, device=None, attention_impl: Optional[str] = None,
                seed: Optional[int] = 0,
                int8_variants: Optional[Int8Variants] = None,
                init_on_device: bool = False) -> FocusModel:
    """FocusModel at `cfg`'s scale, in evaluation mode on `device` (CUDA
    unless given; a trainer puts it in training mode). Weights are the
    seeded initialisation of `init_weights` (seed=None keeps PyTorch's
    defaults; `init_on_device` draws them on the device, as phi='l''s 8.33 B
    parameters want, from the device's generator: other numbers than the
    CPU's from the same seed); load a JAX checkpoint with
    weights.load_jax_variables. attention_impl="plain" runs the attention
    kernels' plain PyTorch versions (comparison only). int8_dense,
    int8_attn and int8_1x1 select the int8 serving paths, alone or
    together; `int8_variants` their variants (None reads
    `Int8Variants.from_env()`, the JAX package's TOD_* variables, once
    here); they change nothing with the int8 flags off. `cfg.remat`
    recomputes each neck fusion node's activations in the backward."""
    device = resolve_device(device)
    with device:  # parameters made where they live (1.35 B at phi='m')
        model = _model_of(cfg, attention_impl, int8_variants)
    if seed is not None:
        init_weights(model, seed, on_device=init_on_device)
    if attention_impl is not None:  # the int8 1x1 convs too
        set_attention_impl(model, attention_impl)
    return model.eval()


def set_attention_impl(model: nn.Module, impl: Optional[str]) -> nn.Module:
    """Switch every kernel of `model` (attention forward and backward, the
    int8 projections of the TEBs, the int8 1x1 convs, QuantDense) between
    the kernels (None) and their plain versions ("plain"), weights
    untouched."""
    for m in model.modules():
        if hasattr(m, "attention_impl"):
            m.attention_impl = impl
    return model


# what a module's forward reads besides its tensors and its input's shape to
# choose the kernels it launches: the kernel switch (`set_attention_impl`),
# the int8 variants, the compute dtype, the data shards (blocks.global_rows)
# and the mode. The Predictor's captured CUDA graphs (inference.py) are keyed
# on them, so an attribute that changes a forward's launches belongs here.
TRACED_ATTRS = ("attention_impl", "int8_variants", "dtype", "data_shards", "training")


class TracedModules:
    """A model's modules (and a wrapper's wrapped model's: eval/callbacks.py's
    _ModelOn) flattened once, so that a call reads what its forward reads at
    trace time without walking the module tree: each module's TRACED_ATTRS,
    the dict slot of each parameter and buffer, the modules whose int8
    weight caches are made from them (blocks._cached), and each module's
    children (`current` is false once a child is replaced or added). It
    holds no reference to `model` itself, so that a cache keyed weakly on the
    model may keep it."""

    def __init__(self, model: nn.Module):
        wrapped = model.__dict__.get("wrapped")
        self.wrapped = [wrapped] if isinstance(wrapped, nn.Module) else []
        mods, stack = [], [model, *self.wrapped]
        while stack:
            m = stack.pop()
            mods.append(m)
            stack += [c for c in m._modules.values() if c is not None]
        self._children = [(m._modules, tuple(m._modules.values())) for m in mods if m._modules]
        self._attrs = []
        for m in mods:
            keys = [a for a in TRACED_ATTRS if a in m.__dict__]
            if keys:
                self._attrs.append((m.__dict__, operator.itemgetter(*keys)))
        self._slots = [(d, k) for m in mods for d in (m._parameters, m._buffers)
                       for k, t in d.items() if t is not None]
        self._caches = [m.__dict__ for m in mods if "_int8_cache" in m.__dict__]
        self._root = model.__dict__

    def current(self) -> bool:
        return all(tuple(d.values()) == kids for d, kids in self._children)

    def traced(self) -> tuple:
        """Every module's TRACED_ATTRS."""
        return tuple(get(d) for d, get in self._attrs)

    def fingerprint(self) -> tuple:
        """The tensors a forward reads: the pointers of the parameters,
        buffers and a wrapper's `variables`, and, once any int8 weight cache
        is made, their versions (a cache is made from them outside a captured
        graph, so an update in place must make it again)."""
        tensors = [d[k] for d, k in self._slots]
        tensors += self._root.get("variables", {}).values()
        out = [t.data_ptr() for t in tensors]
        if any(d["_int8_cache"] is not None for d in self._caches):
            out += [t._version for t in tensors if not t.is_inference()]
        return tuple(out)


# std of a standard normal truncated at +-2 (flax's variance_scaling)
TRUNCATED_NORMAL_STD = 0.87962566103423978


@torch.no_grad()
def init_weights(model: nn.Module, seed: int = 0, on_device: bool = False) -> nn.Module:
    """Seeded initialisation after the flax defaults: conv and dense kernels
    LeCun-normal as flax draws it (a normal truncated at +-2 of its std,
    the std raised by 1/0.87962566 so the variance is 1/fan_in), dense biases
    0, norms at identity, SelfAttention gamma 0, head output biases at their
    prior values. The draws come from a CPU generator, or with `on_device`
    from one on the parameters' device, where they are made."""
    device = next(model.parameters()).device if on_device else torch.device("cpu")
    gen = torch.Generator(device=device).manual_seed(seed)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "weight" and p.dim() >= 2:
            std = p[0].numel() ** -0.5 / TRUNCATED_NORMAL_STD
            w = torch.empty(p.shape, device=device)
            torch.nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=gen)
            p.copy_(w)
        elif leaf == "weight":
            p.fill_(1.0)
        elif leaf == "gamma" or leaf == "bias":
            p.zero_()
    for m in model.modules():
        if isinstance(m, BranchTower):
            m.out.bias.fill_(m.bias_init_value)
    return model


def count_params(model: nn.Module) -> int:
    """Number of parameters: conv, dense and norm weights and biases, not
    the BatchNorm running statistics (JAX's `params` collection, without
    `batch_stats`)."""
    return sum(p.numel() for p in model.parameters())
