"""Training at every scale in the PyTorch port against the JAX package, on
the CPU.

  * The training route table: at 640x640 and 480x576 each attention site of
    phi 'n', 's', 'm', 'l' and 'x' takes the route JAX's own `attention`
    (the front end of the flax TEB and SelfAttention in training) takes on a
    TPU, read off its dispatch traced abstractly with recorders in place of
    the kernels (`test_torch_scales._jax_route`). The one difference kept on
    purpose is asserted: where the TPU's VMEM fit fails (at 640x640 phi='l'
    h1, phi='x' h1 and h4; at 480x576, whose blocks are divisors of 4,320,
    phi='l' and 'x' dark3, phi='x' h1 and h2) JAX falls to its chunked
    route and the port keeps its kernels.
  * The training kernels' domain (`attention_vjp.kernel_supports`) admits
    every training call of those sites in bf16 and fp32; shapes outside it
    are refused.
  * One make_train_step of a tiny fp32 model whose head widths are odd
    (base channels 8: h1 2 heads of 53, h2 and h4 8 of 12, dark3 q/k 4; at
    512x544 h1 has 1,088 tokens, so every attention site but h6 takes the
    folded or single-head flash route with its widths zero-padded) against
    JAX's make_train_step from the same numpy weights, at
    tests/test_torch_train.py's bars: losses 1e-4, and each leaf's change
    (the first SGD step's fixed linear map of its gradient) within 1e-3 of
    the leaf's largest JAX change.
  * remat: the port's remat=True loss and gradient (tests/test_remat.py's
    model, input and loss) against its remat=False ones at test_remat.py's
    bars (loss rtol 1e-5, gradients 1e-4 of the largest: the same arithmetic
    in another order), and against JAX's remat=True ones at the loss rtol
    1e-5 and gradients 1e-3 of the largest, the factor of ten between the
    in-framework and the cross-framework gradient bars of
    tests/test_torch_train.py: on this model (sum of squares of the raw
    maps) the port's backbone conv gradients read 4.7e-4 of the largest
    against JAX, with and without remat alike, the BatchNorm stack
    amplifying the two frameworks' rounding. The BatchNorm running statistics after a remat
    step equal those after a plain one (the recompute must not move them a
    second time).
"""
from __future__ import annotations

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import random_variables, to_jax
from test_torch_scales import KEPT_PACKED, PHIS, _jax_route, sites
from transparent_object_detection_tpu import config as jcfg
from transparent_object_detection_tpu.models import FocusModel as JFocusModel
from transparent_object_detection_tpu.train import optimizer as jopt
from transparent_object_detection_tpu.train import trainer as jtr
from transparent_object_detection_tpu_torch import config as tcfg
from transparent_object_detection_tpu_torch.models import blocks as tb
from transparent_object_detection_tpu_torch.models.detector import FocusModel
from transparent_object_detection_tpu_torch.ops import attention as tattn
from transparent_object_detection_tpu_torch.ops import attention_vjp as tvjp
from transparent_object_detection_tpu_torch.train import optimizer as topt
from transparent_object_detection_tpu_torch.train import trainer as ttr
from transparent_object_detection_tpu_torch.weights import load_jax_variables, params_from_jax

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

HWS = ((640, 640), (480, 576))


@pytest.fixture(scope="module", autouse=True)
def _standard_profile_module():
    """remat's torch.utils.checkpoint imports torch._dynamo at its first
    call, and with it the standard library's cProfile and profile modules;
    tests/test_yolo_import.py puts the repo's tools/, which holds a
    profile.py, first on sys.path when it is collected. Import them here
    with only the standard library's profile.py in reach."""
    saved = list(sys.path)
    stdlib = os.path.dirname(os.__file__)
    sys.path[:] = [d for d in saved
                   if d == stdlib or not os.path.isfile(os.path.join(d or os.curdir, "profile.py"))]
    try:
        import torch._dynamo  # noqa: F401
    finally:
        sys.path[:] = saved
# the sites where JAX on a TPU leaves for its chunked route (its VMEM fit
# fails) and the port keeps its kernels, which score in fp32
KEPT = {(640, 640): KEPT_PACKED,
        (480, 576): {("l", "dark3"), ("x", "dark3"), ("x", "h1"), ("x", "h2")}}


# ---------------------------------------------------------------- routes and domain
@pytest.mark.parametrize("hw", HWS, ids=["640x640", "480x576"])
def test_train_route_table_matches_jax(monkeypatch, hw):
    table = {}
    for phi in PHIS:
        for name, (n, cq, cv, heads, _) in sites(phi, hw).items():
            want, _ = _jax_route(monkeypatch, n, cq, cv, heads, False, False)
            want = "packed" if want == "mha" else want
            got = tattn.train_route(n, cq, heads, cv)
            table[phi, name] = got
            if (phi, name) in KEPT[hw]:
                assert want == "chunked" and got in ("packed", "single"), (phi, name, want)
            else:
                assert got == want, (phi, name, got, want)
    if hw == (640, 640):
        assert [table["n", s] for s in ("dark3", "h1", "h2", "h4", "h6")] == [
            "single", "folded", "packed", "packed", "naive"]
        assert [table["m", s] for s in ("dark3", "h1", "h2", "h4")] == [
            "single", "folded", "packed", "packed"]
        assert [table[p, "h1"] for p in ("s", "l", "x")] == ["packed"] * 3


def _calls(phi, hw):
    """(route, N, q/k width, v width, heads) of each training kernel call:
    folded heads as the fold copy hands them over (single heads, widths
    padded to a multiple of 8)."""
    out = []
    for n, cq, cv, heads, _ in sites(phi, hw).values():
        route = tattn.train_route(n, cq, heads, cv)
        if route == "naive":
            continue
        if route == "folded":
            pad = lambda d: -(-d // heads // 8) * 8
            out.append((route, n, pad(cq), pad(cv), 1))
        else:
            out.append((route, n, cq // heads, cv // heads, heads))
    return out


def test_kernel_domain_admits_every_training_site():
    seen = set()
    for hw in HWS:
        for phi in PHIS:
            for route, n, dq, dv, heads in _calls(phi, hw):
                seen.add(route)
                for dtype in (torch.bfloat16, torch.float32):
                    assert tvjp.kernel_supports(n, dq, dv, heads, dtype), (phi, hw, dq, dv)
    assert seen == {"packed", "single", "folded"}
    # named widths: phi='n' dark3 and h1 (padded), phi='m' h1 (padded), phi='x' dark3, N = 4,320
    assert ("single", 6400, 32, 256, 1) in _calls("n", (640, 640))
    assert ("folded", 1600, 288, 288, 1) in _calls("n", (640, 640))
    assert ("folded", 1600, 600, 600, 1) in _calls("m", (640, 640))
    assert ("single", 6400, 512, 4096, 1) in _calls("x", (640, 640))
    assert ("packed", 4320, 384, 384, 8) in _calls("m", (480, 576))


def test_kernel_domain_refuses_other_shapes():
    assert not tvjp.kernel_supports(1600, 283, 283, 1, torch.bfloat16)  # unpadded fold
    assert not tvjp.kernel_supports(1600, 256, 260, 1, torch.bfloat16)
    assert not tvjp.kernel_supports(1600, 256, 256, 1, torch.float16)
    assert not tvjp.kernel_supports(0, 256, 256, 1, torch.bfloat16)
    q = torch.zeros(1, 1100, 3 * 283)
    with pytest.raises(ValueError):
        tvjp._widths(q, q, q, 3)
    with pytest.raises(ValueError):  # a CUDA-only check, before anything launches
        tvjp._check_view("q", q, torch.float32)


def test_folded_route_pads_and_cuts():
    """The fold copy pads 53-wide heads to 56 with zeros; the gradient that
    reaches the leaves has the unpadded shape and no contribution of the
    padded columns."""
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((1, 8, 106)).astype(np.float32))
    folded = tattn._fold_heads(q, 2)
    assert tuple(folded.shape) == (2, 8, 56)
    assert float(folded[..., 53:].abs().max()) == 0.0
    assert torch.equal(folded[1, :, :53], q[0, :, 53:])
    leaf = q.clone().requires_grad_()
    tattn._fold_heads(leaf, 2).sum().backward()
    assert torch.equal(leaf.grad, torch.ones_like(q))


# ---------------------------------------------------------------- odd widths, one train step
KW = dict(num_classes=2, base_channels=8, base_depth=1, deep_mul=0.33)
HW = (512, 544)  # h1: 32 x 34 = 1,088 tokens, past the naive route's 1,024
LR = 1e-2
# zero but for rounding (see tests/test_torch_train.py): held against the weight's gradient
ZERO_GRAD_LEAVES = ("attn.key.bias", "teb.mlp2.bias")


def _leaf_err(got, want, scale) -> float:
    return float((got.double() - want.double()).abs().max()
                 / max(float(scale.double().abs().max()), 1e-30))


def test_odd_width_fp32_train_step_matches_jax(monkeypatch):
    mc = jcfg.ModelConfig(num_classes=2, input_shape=HW, compute_dtype="float32")
    tc = jcfg.TrainConfig(max_boxes=8, optimizer_type="sgd")
    jmodel = JFocusModel(**KW, dtype=jnp.float32)
    variables = random_variables(jmodel, jnp.zeros((1, 64, 64, 3), jnp.float32), train=True)
    rng = np.random.default_rng(11)
    boxes = np.zeros((2, 8, 4), np.float32)
    boxes[:, 0] = [0.5, 0.5, 0.4, 0.4]
    boxes[1, 1] = [0.3, 0.6, 0.25, 0.3]
    batch = {"image": rng.uniform(-0.5, 0.5, (2, *HW, 3)).astype(np.float32), "boxes": boxes,
             "labels": np.array([[0] * 8, [1] * 8], np.int32)}
    tx = jopt.build_optimizer(tc, to_jax(variables["params"]))
    jstate = jtr.create_train_state(jmodel, to_jax(variables), tx)
    jstep = jtr.make_train_step(jmodel, tx, jtr.loss_config_from(mc, tc), tc, donate=False)
    new, jcomps = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                        jnp.asarray(LR, jnp.float32))

    model = load_jax_variables(FocusModel(**KW, dtype=torch.float32), variables)
    teb1 = model.neck.h1.teb
    assert (teb1.heads, teb1.qkv.in_features // teb1.heads) == (2, 53)
    assert tattn.train_route(HW[0] // 16 * (HW[1] // 16), 106, 2) == "folded"
    ttc = tcfg.TrainConfig(**dataclasses.asdict(tc))
    tmc = tcfg.ModelConfig(num_classes=2, input_shape=HW, compute_dtype="float32")
    opt = topt.build_optimizer(ttc, model)
    state = ttr.create_train_state(model, opt)
    step = ttr.make_train_step(model, opt, ttr.loss_config_from(tmc, ttc), ttc)
    calls = []
    real = tvjp.flash_attention
    monkeypatch.setattr(tvjp, "flash_attention",
                        lambda q, *a: (calls.append(q.shape[-1]), real(q, *a))[1])
    _, comps = step(state, {"image": torch.from_numpy(batch["image"]),
                            "boxes": torch.from_numpy(boxes),
                            "labels": torch.from_numpy(batch["labels"]).long()}, LR)
    # dark3 (q/k 4 padded to 8), h1 (53 -> 56), h2, h4 (12 -> 16) on the
    # flash route; h6 (fewer than 1,024 tokens) naive
    assert sorted(calls) == [8, 16, 16, 56]

    for name in ("loss", "loss_iou", "loss_cls", "loss_dfl"):
        assert abs(float(comps[name]) - float(jcomps[name])) <= 1e-4 * abs(float(jcomps[name]))
    # the first SGD step moves each leaf by a fixed linear map of its
    # gradient: the change to 1e-3 of the largest JAX change of the leaf
    # (of its weight for the zero-gradient biases) plus the two float32
    # roundings of p + change (tests/test_torch_train.py's bar)
    old = params_from_jax(variables["params"], model)
    new_p = params_from_jax(new.params, model)
    for name, p in model.named_parameters():
        ref = name.replace(".bias", ".weight") if name.endswith(ZERO_GRAD_LEAVES) else name
        change = float((new_p[ref] - old[ref]).abs().max())
        ulp = float(np.spacing(np.float32(old[name].abs().max())))
        assert float((p.detach() - new_p[name]).abs().max()) <= 1e-3 * change + 2 * ulp, name


# ---------------------------------------------------------------- remat
REMAT_KW = dict(num_classes=1, base_channels=8, base_depth=1, deep_mul=0.5, num_heads=2)


@pytest.fixture(scope="module")
def remat_case():
    """tests/test_remat.py's model, input and loss: JAX's remat=True loss
    and gradient, and the variables."""
    x = np.random.default_rng(12).standard_normal((1, 64, 64, 3)).astype(np.float32)
    jmodel = JFocusModel(**REMAT_KW, dtype=jnp.float32, remat=True)
    variables = random_variables(jmodel, jnp.zeros((1, 64, 64, 3), jnp.float32), train=True)

    def loss(params):
        out, _ = jmodel.apply({"params": params, "batch_stats": to_jax(variables["batch_stats"])},
                              jnp.asarray(x), train=True, mutable=["batch_stats"])
        return sum(jnp.sum(r.astype(jnp.float32) ** 2) for r in out["raw"])

    jloss_value, jgrads = jax.jit(jax.value_and_grad(loss))(to_jax(variables["params"]))
    return x, variables, float(jloss_value), jgrads


def _port_loss_and_grads(variables, x, remat: bool):
    model = load_jax_variables(FocusModel(**REMAT_KW, dtype=torch.float32, remat=remat),
                               variables).train()
    raw = model(torch.from_numpy(x))["raw"]
    loss = sum(r.float().square().sum() for r in raw)
    loss.backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    return model, float(loss.detach()), grads


def test_remat_step_matches_no_remat_and_jax(remat_case):
    x, variables, jloss_value, jgrads = remat_case
    m0, l0, g0 = _port_loss_and_grads(variables, x, False)
    m1, l1, g1 = _port_loss_and_grads(variables, x, True)
    assert m1.neck.remat and not m0.neck.remat
    np.testing.assert_allclose(l1, l0, rtol=1e-5)
    gmax = max(float(g.abs().max()) for g in g0.values())
    assert max(float((g1[n] - g0[n]).abs().max()) for n in g0) < 1e-4 * gmax
    np.testing.assert_allclose(l1, jloss_value, rtol=1e-5)
    want = params_from_jax(jgrads, m1)
    gmax = max(float(g.abs().max()) for g in want.values())
    assert max(float((g1[n] - want[n]).abs().max()) for n in want) < 1e-3 * gmax


def test_remat_moves_batchnorm_statistics_once(remat_case, monkeypatch):
    """After a remat step the running statistics equal those after a step
    without remat: the recompute computes the batch statistics but writes
    nothing. The recompute does run (each neck BatchNorm's forward is called
    twice under remat)."""
    x, variables, _, _ = remat_case
    calls = {False: 0, True: 0}
    real = tb.BatchNorm.forward

    def counting(self, t):
        calls[self.recomputing] += 1
        return real(self, t)

    monkeypatch.setattr(tb.BatchNorm, "forward", counting)
    m0, _, _ = _port_loss_and_grads(variables, x, False)
    plain_calls = dict(calls)
    m1, _, _ = _port_loss_and_grads(variables, x, True)
    recomputed = calls[True] - plain_calls[True]
    assert plain_calls[True] == 0 and recomputed > 0
    assert calls[False] - plain_calls[False] == plain_calls[False]
    moved = 0
    for (name, b0), (_, b1) in zip(m0.named_buffers(), m1.named_buffers()):
        assert torch.equal(b0, b1), name
    start = dict(load_jax_variables(FocusModel(**REMAT_KW, dtype=torch.float32),
                                    variables).named_buffers())
    for name, b1 in m1.named_buffers():
        moved += int(not torch.equal(b1, start[name]))
    assert moved == len(start)  # every statistic moved once, by the first forward
