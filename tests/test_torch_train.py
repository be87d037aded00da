"""The PyTorch port's training step, and each of its parts, against the JAX
package on the CPU, in fp32 (TF32 off), on numpy inputs made from a seed.

Bars, each relative to the largest magnitude of the JAX array it is held
against (rel_err) unless said otherwise:
  * geometry values 1e-5 and gradients 1e-4, the loss components 1e-5 and
    their gradient 1e-4, optimizer updates and EMA 1e-5: the same fp32
    formulas, summed in another order;
  * assigner: fg_mask, target_gt_idx and target_labels identical (integers;
    a case with tied zero metrics included), target boxes and scores 1e-5;
  * BatchNorm in training mode (ConvBNAct): output 2e-4, gradients 1e-3,
    new running statistics 1e-5 in fp32; 2e-2 in bf16 (the JAX tests' bf16
    bar: the frameworks round the conv output to bf16 at other points);
  * one train step of the tiny model of tests/test_train.py (64 x 64, two
    images, compute_dtype float32): loss components 1e-4, every gradient
    leaf 1e-3 of the leaf's largest magnitude, the updated parameters and
    their EMA within 1e-3 of the largest JAX change plus two float32 ulps of
    the leaf, BatchNorm statistics and their EMA 1e-5. The JAX variables
    come from tests/_torch_parity.py::random_variables.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import random_variables, rel_err, to_jax
from transparent_object_detection_tpu import config as jcfg
from transparent_object_detection_tpu.models import FocusModel as JFocusModel
from transparent_object_detection_tpu.models import blocks as jb
from transparent_object_detection_tpu.ops import geometry as jgeo
from transparent_object_detection_tpu.train import assigner as jas
from transparent_object_detection_tpu.train import ema as jema
from transparent_object_detection_tpu.train import loss as jloss
from transparent_object_detection_tpu.train import optimizer as jopt
from transparent_object_detection_tpu.train import schedule as jsched
from transparent_object_detection_tpu.train import trainer as jtr
from transparent_object_detection_tpu_torch import config as tcfg
from transparent_object_detection_tpu_torch.models import blocks as tb
from transparent_object_detection_tpu_torch.models.detector import FocusModel
from transparent_object_detection_tpu_torch.ops import geometry as tgeo
from transparent_object_detection_tpu_torch.train import assigner as tas
from transparent_object_detection_tpu_torch.train import ema as tema
from transparent_object_detection_tpu_torch.train import loss as tloss
from transparent_object_detection_tpu_torch.train import optimizer as topt
from transparent_object_detection_tpu_torch.train import schedule as tsched
from transparent_object_detection_tpu_torch.train import trainer as ttr
from transparent_object_detection_tpu_torch.weights import (
    load_jax_variables,
    params_from_jax,
    state_dict_from_jax,
)

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _np(t) -> np.ndarray:
    return t.detach().double().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float64)


def leaf_err(got, want, scale=None) -> float:
    """max |got - want| over max |scale| (scale defaults to want)."""
    ref = _np(want if scale is None else scale)
    return float(np.abs(_np(got) - _np(want)).max() / max(np.abs(ref).max(), 1e-30))


def _boxes(rng, n, lo=0.0, hi=50.0):
    xy = rng.uniform(lo, hi, (n, 2))
    wh = rng.uniform(1.0, 30.0, (n, 2))
    return np.concatenate([xy, xy + wh], axis=-1).astype(np.float32)


# ---------------------------------------------------------------- geometry
@pytest.mark.parametrize("kind", ["iou", "giou", "diou", "ciou"])
def test_bbox_iou_kinds_and_gradient(kind):
    rng = np.random.default_rng(0)
    b1, b2 = _boxes(rng, 64), _boxes(rng, 64)
    ref = jgeo.bbox_iou(jnp.asarray(b1), jnp.asarray(b2), xywh=False, kind=kind)
    g_ref = jax.grad(lambda a: jgeo.bbox_iou(a, jnp.asarray(b2), xywh=False, kind=kind).sum())(
        jnp.asarray(b1))
    t = torch.from_numpy(b1).requires_grad_()
    out = tgeo.bbox_iou(t, torch.from_numpy(b2), xywh=False, kind=kind)
    out.sum().backward()
    assert rel_err(out.detach().numpy(), ref) <= 1e-5
    assert rel_err(t.grad.numpy(), g_ref) <= 1e-4
    xywh = tgeo.xyxy2xywh(torch.from_numpy(b1))
    assert rel_err(xywh.numpy(), jgeo.xyxy2xywh(jnp.asarray(b1))) <= 1e-6
    assert rel_err(tgeo.bbox_iou(xywh, tgeo.xyxy2xywh(torch.from_numpy(b2)), kind=kind).numpy(),
                   ref) <= 1e-5


def test_bbox2dist_dist2bbox():
    rng = np.random.default_rng(1)
    anchors = rng.uniform(0, 40, (50, 2)).astype(np.float32)
    boxes = _boxes(rng, 50, 0.0, 40.0)
    dist = rng.uniform(0, 20, (50, 4)).astype(np.float32)
    ta, tbx, td = map(torch.from_numpy, (anchors, boxes, dist))
    assert rel_err(tgeo.bbox2dist(ta, tbx, 15).numpy(),
                   jgeo.bbox2dist(jnp.asarray(anchors), jnp.asarray(boxes), 15)) <= 1e-6
    for xywh in (True, False):
        assert rel_err(tgeo.dist2bbox(td, ta, xywh).numpy(),
                       jgeo.dist2bbox(jnp.asarray(dist), jnp.asarray(anchors), xywh)) <= 1e-6


# ---------------------------------------------------------------- BatchNorm in training
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv_bn_train_matches_flax(dtype):
    """ConvBNAct in training: batch statistics (fast variance), output,
    gradients of input and parameters, and the updated running statistics
    (0.9 r + 0.1 batch, biased variance)."""
    bar = {"float32": (2e-4, 1e-3, 1e-5), "bfloat16": (2e-2, 2e-2, 2e-2)}[dtype]
    jmod = jb.ConvBNAct(24, 3, strides=2, dtype=jnp.dtype(dtype))
    tmod = tb.ConvBNAct(16, 24, 3, strides=2, dtype=getattr(torch, dtype))
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((2, 15, 17, 16)) * 2 + 0.5).astype(np.float32)
    g = rng.standard_normal((2, 8, 9, 24)).astype(np.float32)
    variables = random_variables(jmod, jnp.zeros(x.shape, jnp.float32), train=True)

    def f(params, xx):
        y, mut = jmod.apply({"params": params, "batch_stats": to_jax(variables["batch_stats"])},
                            xx, train=True, mutable=["batch_stats"])
        return y, mut["batch_stats"]

    ref, vjp, new_bs = jax.vjp(f, to_jax(variables["params"]), jnp.asarray(x), has_aux=True)
    ref_gp, ref_gx = vjp(jnp.asarray(g, ref.dtype))
    load_jax_variables(tmod, variables)
    tmod.train()
    tx = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    out = tmod(tx).permute(0, 2, 3, 1)
    out.backward(torch.from_numpy(g).to(out.dtype))
    assert out.dtype == getattr(torch, dtype)
    assert rel_err(out.detach().float().numpy(), np.asarray(ref, np.float32)) <= bar[0]
    assert rel_err(tx.grad.permute(0, 2, 3, 1).numpy(), np.asarray(ref_gx, np.float32)) <= bar[1]
    want = params_from_jax(ref_gp, tmod)
    for name, p in tmod.named_parameters():
        assert leaf_err(p.grad, want[name]) <= bar[1], name
    stats = state_dict_from_jax({"params": variables["params"], "batch_stats": new_bs}, tmod)
    for name, buf in tmod.named_buffers():
        assert leaf_err(buf, stats[name]) <= bar[2], name


# ---------------------------------------------------------------- assigner and loss
def _assign_inputs(seed: int, zero_share: float):
    """Anchors on a 20 x 15 grid (stride 8), two images with 4 real and 2
    padded GT slots, the first over the lowest-index anchors; `zero_share`
    of the anchors get a class score of exactly 0, so their alignment metric
    ties at 0 and the top-k fills with them in index order."""
    rng = np.random.default_rng(seed)
    b, m, c = 2, 6, 3
    gx, gy = np.meshgrid(np.arange(20) + 0.5, np.arange(15) + 0.5)
    anchors = (np.stack([gx, gy], -1).reshape(-1, 2) * 8).astype(np.float32)
    a = anchors.shape[0]
    scores = rng.uniform(0.05, 1.0, (b, a, c)).astype(np.float32)
    scores[rng.uniform(size=(b, a)) < zero_share] = 0.0
    centre = anchors[None] + rng.normal(0, 4, (b, a, 2))
    half = rng.uniform(4, 30, (b, a, 2))
    pd = np.concatenate([centre - half, centre + half], -1).astype(np.float32)
    gt = np.zeros((b, m, 4), np.float32)
    for i in range(b):
        gt[i, :4] = _boxes(rng, 4, 0.0, 100.0) * np.array([1.2, 1.0, 1.2, 1.0], np.float32) * 1.5
        gt[i, 0] = [0.0, 0.0, 60.0, 20.0]  # anchors 0-6 and 20-26
    labels = rng.integers(0, c, (b, m)).astype(np.int32)
    return scores, pd, anchors, labels, gt, gt.sum(-1) > 0


@pytest.mark.parametrize("zero_share", [0.0, 0.9])
def test_task_aligned_assign_matches_jax(zero_share):
    inputs = _assign_inputs(3, zero_share)
    ref = jax.jit(jas.task_aligned_assign, static_argnames="num_classes")(
        *map(jnp.asarray, inputs), num_classes=3)
    out = tas.task_aligned_assign(*map(torch.from_numpy, inputs), num_classes=3)
    assert int(np.asarray(ref.fg_mask).sum()) > 0
    for name in ("fg_mask", "target_gt_idx", "target_labels"):
        np.testing.assert_array_equal(getattr(out, name).numpy(),
                                      np.asarray(getattr(ref, name)), err_msg=name)
    for name in ("target_bboxes", "target_scores"):
        assert rel_err(getattr(out, name).numpy(), getattr(ref, name)) <= 1e-5, name


def test_topk_membership_ties_take_lower_indices():
    metrics = np.zeros((1, 2, 30), np.float32)
    metrics[0, 0, [3, 17]] = 0.5  # two nonzero, the rest tied at 0
    mask = np.array([[True, False]])
    ref = jas.topk_membership(jnp.asarray(metrics), 10, jnp.asarray(mask))
    out = tas.topk_membership(torch.from_numpy(metrics), 10, torch.from_numpy(mask))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert out[0, 0].nonzero().flatten().tolist() == [0, 1, 2, 3, 4, 5, 6, 7, 8, 17]


def test_detection_loss_matches_jax():
    """Components and the gradient with respect to the raw maps (64 x 64
    input, 2 classes, 3 real boxes and 2 padded slots per image)."""
    rng = np.random.default_rng(4)
    no = 4 * 16 + 2
    maps = [(rng.standard_normal((2, s, s, no)) * 2).astype(np.float32) for s in (8, 4, 2)]
    boxes = np.zeros((2, 5, 4), np.float32)
    boxes[:, :3, :2] = rng.uniform(0.2, 0.8, (2, 3, 2))
    boxes[:, :3, 2:] = rng.uniform(0.1, 0.5, (2, 3, 2))
    labels = rng.integers(0, 2, (2, 5)).astype(np.int32)
    cfg = jloss.LossConfig(num_classes=2)

    def f(ms):
        return jloss.detection_loss(ms, jnp.asarray(boxes), jnp.asarray(labels), cfg)

    (_, ref), g_ref = jax.jit(jax.value_and_grad(f, has_aux=True))([jnp.asarray(m) for m in maps])
    tm = [torch.from_numpy(m).requires_grad_() for m in maps]
    total, comps = tloss.detection_loss(tm, torch.from_numpy(boxes), torch.from_numpy(labels),
                                        tloss.LossConfig(num_classes=2))
    total.backward()
    assert float(ref["num_fg"]) > 0 and float(comps["num_fg"]) == float(ref["num_fg"])
    for name in ("loss", "loss_iou", "loss_cls", "loss_dfl"):
        got = float(comps[name].detach())
        assert abs(got - float(ref[name])) <= 1e-5 * abs(float(ref[name])), name
    for t, g in zip(tm, g_ref):
        assert rel_err(t.grad.numpy(), g) <= 1e-4


# ---------------------------------------------------------------- optimizer, EMA, schedules
def tiny_jax_model(**kw):
    """tests/test_train.py::tiny_model."""
    return JFocusModel(num_classes=1, base_channels=8, base_depth=1, deep_mul=0.5, num_heads=2,
                       dtype=jnp.float32, **kw)


def tiny_port_model(**kw):
    return FocusModel(num_classes=1, base_channels=8, base_depth=1, deep_mul=0.5, num_heads=2,
                      dtype=torch.float32, **kw)


@pytest.fixture(scope="module")
def tiny_vars():
    return random_variables(tiny_jax_model(), jnp.zeros((1, 64, 64, 3), jnp.float32), train=True)


def _mask_by_name(jmask, params, model):
    """A JAX mask tree (bools) as {port parameter name: bool}."""
    arrays = jax.tree_util.tree_map(lambda f, p: np.full(p.shape, float(f), np.float32),
                                    jmask, params)
    return {n: bool(t.flatten()[0]) for n, t in params_from_jax(arrays, model).items()}


def test_decay_and_freeze_masks_match_jax(tiny_vars):
    model = tiny_port_model()
    params = tiny_vars["params"]
    assert topt.weight_decay_mask(model) == _mask_by_name(jopt.weight_decay_mask(params), params,
                                                          model)
    assert topt.backbone_frozen_mask(model) == _mask_by_name(jopt.backbone_frozen_mask(params),
                                                             params, model)
    decayed = {n for n, f in topt.weight_decay_mask(model).items() if f}
    assert "backbone.stem.bn.weight" not in decayed and "neck.h1.teb.norm1.weight" not in decayed
    assert "backbone.dark3_attn.gamma" not in decayed and "head.box0.out.bias" not in decayed
    assert {"backbone.stem.conv.weight", "neck.h1.teb.qkv.weight",
            "backbone.dark2_cbam.spatial.weight"} <= decayed


# (grad scale, clip norm): clip active; inactive; active on a tiny norm, where
# an epsilon in the divisor (torch's clip_grad_norm_ adds 1e-6) would show
CLIP_CASES = {"clip_active": (1.0, 10.0), "clip_inactive": (1e-4, 10.0),
              "clip_tiny_norm": (1e-7, 1e-6)}


@pytest.mark.parametrize("opt", ["sgd", "adam"])
@pytest.mark.parametrize("case", sorted(CLIP_CASES))
def test_optimizer_matches_optax(tiny_vars, opt, case):
    """The chains on the tiny model's last fusion node (neck h6: LayerNorms,
    dense layers, a conv with BatchNorm, CBAM), two steps on the same
    seeded gradients."""
    scale, clip = CLIP_CASES[case]
    params = tiny_vars["params"]["neck"]["h6"]
    rng = np.random.default_rng(5)
    grads = jax.tree_util.tree_map(
        lambda p: (rng.standard_normal(p.shape) * scale).astype(np.float32), params)
    kw = dict(optimizer_type=opt, grad_clip_norm=clip)
    tx = jopt.build_optimizer(jcfg.TrainConfig(**kw), to_jax(params))
    model = load_jax_variables(tiny_port_model(), tiny_vars).neck.h6
    topt_ = topt.build_optimizer(tcfg.TrainConfig(**kw), model)
    tparams = {n: p.detach() for n, p in model.named_parameters()}
    tgrads = params_from_jax(grads, model)
    jstate, tstate = tx.init(to_jax(params)), topt_.init(tparams)
    update = jax.jit(tx.update)
    for _ in range(2):  # the second step reads the momentum / moments
        ju, jstate = update(to_jax(grads), jstate, to_jax(params))
        tu, tstate = topt_.update(tgrads, tstate, tparams)
        want = params_from_jax(ju, model)
        for name in tparams:
            assert leaf_err(tu[name], want[name]) <= 1e-5, name


def test_ema_schedule_and_config_match_jax():
    # 1 - exp(-u / tau) cancels in float32: one ulp of exp near 1 (6e-8) is
    # 1.2e-4 of the decay at u = 1, and the two exps may differ by one ulp
    for u in (1, 7, 2000, 20000):
        assert abs(tema.ema_decay(u) - float(jema.ema_decay(jnp.asarray(u)))) <= 1.2e-7
    rng = np.random.default_rng(6)
    old = {"a": rng.standard_normal((3, 4)).astype(np.float32), "b": np.ones(5, np.float32)}
    new = {"a": rng.standard_normal((3, 4)).astype(np.float32), "b": np.zeros(5, np.float32)}
    ref = jema.ema_update(jema.ema_init(to_jax(old)), to_jax(new), jnp.asarray(3))
    out = tema.ema_update(tema.ema_init({k: torch.from_numpy(v) for k, v in old.items()}),
                          {k: torch.from_numpy(v) for k, v in new.items()}, 3)
    for k in old:
        assert rel_err(out[k].numpy(), ref[k]) <= 1e-6
    for kind, kw in (("cos", {}), ("step", {"step_num": 4})):
        jfn = jsched.get_lr_scheduler(kind, 1e-2, 1e-4, 100, **kw)
        tfn = tsched.get_lr_scheduler(kind, 1e-2, 1e-4, 100, **kw)
        assert [tfn(i) for i in range(100)] == [jfn(i) for i in range(100)]
    assert dataclasses.asdict(tcfg.TrainConfig()) == dataclasses.asdict(jcfg.TrainConfig())
    for opt in ("sgd", "adam"):
        for bs in (2, 16, 64, 256):
            t = tcfg.TrainConfig(optimizer_type=opt)
            j = jcfg.TrainConfig(optimizer_type=opt)
            assert t.fit_lr(bs) == j.fit_lr(bs) and t.min_lr == j.min_lr


# ---------------------------------------------------------------- the train step
LR = 1e-2
# Leaves whose gradient is zero but for rounding: SelfAttention's key bias
# (the softmax ignores a per-query constant) and the TEBs' last bias (a
# per-channel constant that the next layer's training-mode BatchNorm
# subtracts). Each is held against the gradient of its layer's weight.
ZERO_GRAD_LEAVES = ("attn.key.bias", "teb.mlp2.bias")


def grad_scale(name: str, grads):
    if name.endswith(ZERO_GRAD_LEAVES):
        return grads[name.replace(".bias", ".weight")]
    return grads[name]


@pytest.fixture(scope="module")
def step_inputs(tiny_vars):
    """The configurations of tests/test_train.py (64 x 64, max_boxes 8, SGD,
    EMA on), two images with one and two boxes, and JAX's loss gradient at
    the initial variables. The images are centred on 0: on [0, 1] images the
    stem's batch mean is large against its spread, and the fast variance
    E[x^2] - E[x]^2 turns the float32 rounding of JAX's sums into a 3e-6
    error of the stem's output (the port's is 5e-7 against float64), which
    the network's later BatchNorms amplify past the gradient bar."""
    mc = jcfg.ModelConfig(num_classes=1, input_shape=(64, 64), compute_dtype="float32")
    tc = jcfg.TrainConfig(max_boxes=8, optimizer_type="sgd")
    rng = np.random.default_rng(7)
    boxes = np.zeros((2, 8, 4), np.float32)
    boxes[:, 0] = [0.5, 0.5, 0.4, 0.4]
    boxes[1, 1] = [0.3, 0.6, 0.25, 0.3]
    batch = {"image": rng.uniform(-0.5, 0.5, (2, 64, 64, 3)).astype(np.float32), "boxes": boxes,
             "labels": np.zeros((2, 8), np.int32)}
    jmodel = tiny_jax_model()
    lc = jtr.loss_config_from(mc, tc)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(params):
        out, _ = jmodel.apply({"params": params, "batch_stats": to_jax(tiny_vars["batch_stats"])},
                              jbatch["image"], train=True, mutable=["batch_stats"])
        return jloss.detection_loss(out["raw"], jbatch["boxes"], jbatch["labels"], lc)[0]

    grads = jax.jit(jax.grad(loss_fn))(to_jax(tiny_vars["params"]))
    return dict(mc=mc, tc=tc, batch=batch, jbatch=jbatch, jmodel=jmodel, lc=lc, grads=grads)


def _port_step(tiny_vars, inp, freeze: bool):
    mc, tc = inp["mc"], inp["tc"]
    tmc = tcfg.ModelConfig(num_classes=1, input_shape=(64, 64), compute_dtype="float32")
    ttc = tcfg.TrainConfig(**dataclasses.asdict(tc))
    model = load_jax_variables(tiny_port_model(), tiny_vars)
    opt = topt.build_optimizer(ttc, model, freeze_backbone=freeze)
    state = ttr.create_train_state(model, opt)
    lc = ttr.loss_config_from(tmc, ttc)
    step = ttr.make_train_step(model, opt, lc, ttc, freeze_backbone=freeze)
    batch = {"image": torch.from_numpy(inp["batch"]["image"]),
             "boxes": torch.from_numpy(inp["batch"]["boxes"]),
             "labels": torch.from_numpy(inp["batch"]["labels"]).long()}
    state, comps = step(state, batch, LR)
    return model, state, comps, batch, lc


@pytest.mark.parametrize("freeze", [False, True])
def test_train_step_matches_jax(tiny_vars, step_inputs, freeze):
    inp = step_inputs
    jmodel, tc = inp["jmodel"], inp["tc"]
    tx = jopt.build_optimizer(tc, to_jax(tiny_vars["params"]), freeze_backbone=freeze)
    jstate = jtr.create_train_state(jmodel, to_jax(tiny_vars), tx)
    jstep = jtr.make_train_step(jmodel, tx, inp["lc"], tc, freeze_backbone=freeze, donate=False)
    new, jcomps = jstep(jstate, inp["jbatch"], jnp.asarray(LR, jnp.float32))
    model, state, comps, batch, lc = _port_step(tiny_vars, inp, freeze)

    assert state.step == 1 and state.ema_updates == 1
    assert float(comps["num_fg"]) == float(jcomps["num_fg"]) > 0
    for name in ("loss", "loss_iou", "loss_cls", "loss_dfl"):
        assert abs(float(comps[name]) - float(jcomps[name])) <= 1e-4 * abs(float(jcomps[name]))
    frozen = topt.backbone_frozen_mask(model)
    want_g = params_from_jax(inp["grads"], model)
    old = params_from_jax(tiny_vars["params"], model)
    new_p = params_from_jax(new.params, model)
    new_ema = params_from_jax(new.ema_params, model)
    for name, p in model.named_parameters():
        if freeze and frozen[name]:
            assert float(p.grad.abs().max()) == 0.0 and torch.equal(p.detach(), old[name]), name
            continue
        assert leaf_err(p.grad, want_g[name], grad_scale(name, want_g)) <= 1e-3, name
        # the change, to 1e-3 of the largest JAX change plus the two float32
        # roundings of p + change on either side (one ulp of the leaf each)
        delta = {n: new_p[n] - old[n] for n in (name, name.replace(".bias", ".weight"))}
        ulp = float(np.spacing(np.float32(old[name].abs().max())))
        tol = 1e-3 * float(grad_scale(name, delta).abs().max()) + 2 * ulp
        assert float((p.detach() - new_p[name]).abs().max()) <= tol, name
        # after one update the EMA is 0.9995 of the new parameters
        assert float((state.ema_params[name] - new_ema[name]).abs().max()) <= tol, name
    stats = state_dict_from_jax({"params": new.params, "batch_stats": new.batch_stats}, model)
    ema_stats = state_dict_from_jax({"params": new.params, "batch_stats": new.ema_batch_stats},
                                    model)
    for name, buf in model.named_buffers():
        assert leaf_err(buf, stats[name]) <= 1e-5, name
        assert leaf_err(state.ema_batch_stats[name], ema_stats[name]) <= 1e-5, name
    if freeze:  # frozen leaves keep exactly zero momentum
        assert all(float(state.opt_state["trace"][n].abs().max()) == 0.0
                   for n, f in frozen.items() if f)
    else:  # the validation step on the EMA weights with running statistics
        ref = jtr.make_eval_step(jmodel, inp["lc"])(new, inp["jbatch"])
        out = ttr.make_eval_step(model, lc)(state, batch)
        for name in ("loss", "loss_iou", "loss_cls", "loss_dfl"):
            assert abs(float(out[name]) - float(ref[name])) <= 1e-4 * abs(float(ref[name]))
        assert model.training  # restored after the evaluation


def test_int8_flags_train_the_bf16_function(tiny_vars, monkeypatch):
    """int8_dense / int8_attn are serving-only: in training mode a model
    built with them computes exactly what the model without them computes
    (the int8 projections are never called)."""
    def refuse(*args, **kwargs):
        raise AssertionError("an int8 projection ran in training mode")

    monkeypatch.setattr(tb, "quant_matmul", refuse)
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.uniform(size=(2, 64, 64, 3)).astype(np.float32))
    results = []
    for kw in ({}, {"int8_dense": True, "int8_attn": True}):
        model = load_jax_variables(tiny_port_model(**kw), tiny_vars).train()
        raw = model(x)["raw"]
        assert set(model(x)) == {"raw"}
        sum(m.square().mean() for m in raw).backward()
        results.append((raw, [p.grad for p in model.parameters()],
                        [b.clone() for b in model.buffers()]))
    (raw0, g0, b0), (raw1, g1, b1) = results
    assert all(torch.equal(a, b) for a, b in zip(raw0, raw1))
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    assert all(torch.equal(a, b) for a, b in zip(b0, b1))
