"""The compiled train and eval steps (train/trainer.py through inference.py's
program cache: one captured CUDA graph a key, the counterpart of JAX's
`jax.jit(step, donate_argnums=(0,))` and `jax.jit(eval_step)`), on the CPU.

The CPU has no CUDA graphs, so the capture (`inference._capture_graph`) is
stubbed by `FakeTrainGraph`: the capture runs the step's Python once (its
host effects happen) and puts back every tensor the step wrote in place, as
a capture records kernels without running them; a replay runs the step again
on the static input buffers and writes the static output in place. Held
here, on the tiny fp32 model of tests/test_torch_train.py (64 x 64, JAX's
random variables through the weight bridge):
  * three graphed steps (warm-up, capture and replay, replay) equal three
    eager steps bit for bit in every leaf: parameters, `.grad`, BatchNorm
    statistics, optimizer state, EMA shadows, counters and components, the
    lr changed between steps; SGD and Adam, frozen and unfrozen, remat; the
    eval step graphed against eager on the state they reach;
  * neither step reads the host (no `aten._local_scalar_dense`, no tensor
    made from host data);
  * the device EMA decay and Adam's bias corrections against the numpy
    references, within two ulps of their exp and pow terms;
  * the host counter (`step`) and the device counters (`ema_updates`, Adam's
    `count`) advance once a call across warm-up, capture and replay;
  * a resume (`load_state_tree`) warms up and captures anew, and a
    `last_state` in the file format (counters as numbers) restores exactly;
  * the unfreeze boundary's `ema_updates` reset, written into the counter,
    is read by the replay;
  * a key whose graph is predicted not to fit runs eagerly, recorded in
    `programs_of`; a failed capture raises;
  * remat: the step with preserve_rng_state False equals the step with True
    bit for bit, and both the step without remat within
    tests/test_torch_train_scales.py's remat bars;
  * against JAX: three graphed steps, lr changed between them as
    `jnp.asarray(lr, jnp.float32)`, each from the starting weights (through
    weights.py) against JAX's jitted make_train_step, at
    tests/test_torch_train.py's bars (test_train_step_matches_jax);
    Trainer.fit with the graphed path forced against
    JAX's fit at tests/test_torch_fit.py's float32 bars, and against the
    port's eager fit bit for bit (per-epoch losses included: a per-step loss
    aliasing the graph's output would make the epoch's loss its last step's).
"""
from __future__ import annotations

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_graph_stubs import FakeTrainGraph
from _torch_graph_stubs import HostReads as _HostReads
from _torch_parity import random_variables, to_jax
from transparent_object_detection_tpu import config as jcfg
from transparent_object_detection_tpu.models import FocusModel as JFocusModel
from transparent_object_detection_tpu.train import loss as jloss
from transparent_object_detection_tpu.train import optimizer as jopt
from transparent_object_detection_tpu.train import trainer as jtr
from transparent_object_detection_tpu_torch import config as tcfg
from transparent_object_detection_tpu_torch import inference
from transparent_object_detection_tpu_torch.models import neck as tneck
from transparent_object_detection_tpu_torch.models.detector import FocusModel
from transparent_object_detection_tpu_torch.train import checkpoints as tck
from transparent_object_detection_tpu_torch.train import ema as tema
from transparent_object_detection_tpu_torch.train import optimizer as topt
from transparent_object_detection_tpu_torch.train import trainer as ttr
from transparent_object_detection_tpu_torch.weights import (
    load_jax_variables,
    params_from_jax,
    state_dict_from_jax,
)

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TINY = dict(num_classes=1, base_channels=8, base_depth=1, deep_mul=0.5, num_heads=2)
MODEL_CFG = tcfg.ModelConfig(num_classes=1, input_shape=(64, 64), compute_dtype="float32")
LRS = (1e-2, 5e-3, 2e-2)  # one lr a step: one graph serves them all


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
                   if not os.path.isfile(os.path.join(d or ".", "profile.py"))
                   or os.path.abspath(d or ".") == stdlib]
    try:
        import cProfile  # noqa: F401
        import profile  # noqa: F401
    finally:
        sys.path[:] = saved
    yield


@pytest.fixture
def captures(monkeypatch):
    made = []

    def capture(step, model, inputs):
        graph = FakeTrainGraph(step, model, inputs)
        made.append(graph)
        return graph, graph.output, 0

    monkeypatch.setattr(inference, "_capture_graph", capture)
    return made


@pytest.fixture(scope="module")
def tiny_vars():
    model = JFocusModel(**TINY, dtype=jnp.float32)
    return random_variables(model, jnp.zeros((1, 64, 64, 3), jnp.float32), train=True)


def _batch(seed: int, b: int = 2):
    """Two images centred on 0 (tests/test_torch_train.py's step_inputs)
    with one and two boxes."""
    rng = np.random.default_rng(seed)
    boxes = np.zeros((b, 8, 4), np.float32)
    boxes[:, 0] = [0.5, 0.5, 0.4, 0.4]
    boxes[1:, 1] = [0.3, 0.6, 0.25, 0.3]
    return {"image": rng.uniform(-0.5, 0.5, (b, 64, 64, 3)).astype(np.float32),
            "boxes": boxes, "labels": np.zeros((b, 8), np.int32)}


def _torch_batch(batch):
    return {"image": torch.from_numpy(batch["image"]), "boxes": torch.from_numpy(batch["boxes"]),
            "labels": torch.from_numpy(batch["labels"]).long()}


def _setup(tiny_vars, opt="sgd", freeze=False, remat=False, graphs=True, **tc):
    model = load_jax_variables(FocusModel(**TINY, dtype=torch.float32, remat=remat), tiny_vars)
    ttc = tcfg.TrainConfig(max_boxes=8, optimizer_type=opt, **tc)
    optimizer = topt.build_optimizer(ttc, model, freeze_backbone=freeze)
    state = ttr.create_train_state(model, optimizer)
    lc = ttr.loss_config_from(MODEL_CFG, ttc)
    step = ttr.make_train_step(model, optimizer, lc, ttc, freeze_backbone=freeze, graphs=graphs)
    eval_step = ttr.make_eval_step(model, lc, graphs=graphs)
    return model, state, step, eval_step


def _leaves(model, state, comps=None):
    """Every leaf a step reads or writes, copied."""
    out = {f"param {n}": p.detach().clone() for n, p in model.named_parameters()}
    out.update({f"grad {n}": p.grad.clone() for n, p in model.named_parameters()
                if p.grad is not None})
    out.update({f"stat {n}": b.clone() for n, b in model.named_buffers()})
    for key, value in state.opt_state.items():
        for n, t in (value.items() if isinstance(value, dict) else [("", value)]):
            out[f"opt {key} {n}"] = t.clone()
    out.update({f"ema {n}": t.clone() for n, t in state.ema_params.items()})
    out.update({f"ema stat {n}": t.clone() for n, t in state.ema_batch_stats.items()})
    out["ema_updates"] = state.ema_updates.clone()
    out["step"] = torch.tensor(state.step)
    for k, v in (comps or {}).items():
        out[f"comp {k}"] = v.clone()
    return out


def _same(a: dict, b: dict):
    assert a.keys() == b.keys()
    for key in a:
        assert a[key].dtype == b[key].dtype and torch.equal(a[key], b[key]), key


def _run(tiny_vars, graphs, steps=3, **kw):
    model, state, step, eval_step = _setup(tiny_vars, graphs=graphs, **kw)
    records, comps_seen = [], []
    for i in range(steps):
        state, comps = step(state, _torch_batch(_batch(10 + i)), LRS[i % len(LRS)])
        comps_seen.append(comps)
        records.append(_leaves(model, state, comps))
    evals = [eval_step(state, _torch_batch(_batch(20))) for _ in range(3)]
    return model, state, records, comps_seen, evals


STEP_CASES = {"sgd": {}, "adam": {"opt": "adam"}, "sgd frozen": {"freeze": True},
              "adam frozen": {"opt": "adam", "freeze": True}, "remat": {"remat": True}}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_graphed_steps_equal_eager_bit_for_bit(tiny_vars, captures, case):
    kw = STEP_CASES[case]
    eager = _run(tiny_vars, False, **kw)
    assert not captures
    graphed = _run(tiny_vars, True, **kw)
    # the train key and the eval key, each captured once
    assert len(captures) == 2
    for got, want in zip(graphed[2], eager[2]):
        _same(got, want)
    for got, want in zip(graphed[4], eager[4]):
        _same({k: v for k, v in got.items()}, want)
    # each call's components its own tensors, not the graph's output
    losses = [c["loss"] for c in graphed[3]]
    assert len({t.data_ptr() for t in losses}) == 3
    assert not any(t.data_ptr() == captures[0].output["loss"].data_ptr() for t in losses)
    entries = {e["entry"]: e for e in inference.programs_of(graphed[0])}
    assert entries["trainer.train_step"]["captured"]
    assert entries["trainer.train_step"]["replays"] == 2
    assert entries["trainer.eval_step"]["replays"] == 2
    if "frozen" in case:  # the backbone never moved
        model = graphed[0]
        first = load_jax_variables(FocusModel(**TINY, dtype=torch.float32), tiny_vars)
        for (n, p), q in zip(model.named_parameters(), first.parameters()):
            if n.startswith("backbone."):
                assert torch.equal(p.detach(), q.detach()), n


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_steps_read_nothing_from_the_host(tiny_vars, opt):
    model, state, step, eval_step = _setup(tiny_vars, opt=opt, graphs=False)
    batch = _torch_batch(_batch(0))
    lr = torch.tensor(LRS[0], dtype=torch.float32)
    state, _ = step(state, batch, lr)  # the gradients and counters exist
    with _HostReads() as guard:
        state, comps = step(state, batch, lr)
        out = eval_step(state, batch)
    assert guard.reads == []
    assert set(comps) == set(out) and torch.isfinite(comps["loss"])


def test_device_decay_and_bias_correction_match_numpy():
    """Within two ulps of the exp (pow) term, the most two results within
    one ulp of the true value can differ (torch's vectorized exp against
    numpy's differs by two at u = 18), and the roundings after it: the
    float32 cancellation in 1 - exp(-u / tau) spreads one ulp of exp to up
    to 1,024 ulps of the decay at u = 1, as it does in JAX's formula."""
    u = np.arange(1, 10001)
    got = tema.ema_decay_device(torch.from_numpy(u.astype(np.int32))).numpy()
    want = np.array([tema.ema_decay(int(k)) for k in u], np.float32)
    e = np.exp(-u.astype(np.float32) / np.float32(2000))
    assert got.dtype == np.float32
    assert np.all(np.abs(got.astype(np.float64) - want)
                  <= 2.0 * np.spacing(e) + 2.0 * np.spacing(want))
    for decay in (0.937, topt.ADAM_B2):
        got = topt._bias_correction_device(decay, torch.from_numpy(u.astype(np.int32))).numpy()
        want = np.array([topt._bias_correction(decay, int(k)) for k in u], np.float32)
        p = np.float32(decay) ** u.astype(np.float32)
        assert np.all(np.abs(got.astype(np.float64) - want)
                      <= 2.0 * np.spacing(p) + 2.0 * np.spacing(want)), decay
    # a 0-d counter, as the step holds it
    assert float(tema.ema_decay_device(torch.tensor(7, dtype=torch.int32))) == pytest.approx(
        tema.ema_decay(7), abs=1e-9)


def test_counters_advance_once_a_call(tiny_vars, captures):
    model, state, step, _ = _setup(tiny_vars, opt="adam", graphs=True)
    for n in range(1, 5):  # warm-up, capture and replay, replay, replay
        state, _ = step(state, _torch_batch(_batch(n)), LRS[0])
        assert state.step == n
        assert int(state.ema_updates) == n and state.ema_updates.dtype == torch.int32
        assert int(state.opt_state["count"]) == n
    assert len(captures) == 1
    (entry,) = inference.programs_of(model)
    assert entry["replays"] == 3 and entry["replayed_calls"] == 2


def test_resume_warms_up_and_captures_anew(tiny_vars, captures, tmp_path):
    model, state, step, _ = _setup(tiny_vars, opt="adam", graphs=True)
    for i in range(3):
        state, _ = step(state, _torch_batch(_batch(i)), LRS[i])
    ckpt = tck.CheckpointManager(str(tmp_path))
    ckpt.save_tree("last_state", tck.state_tree(state))
    raw = ckpt.load_tree("last_state")  # the file format: counters as numbers
    assert raw["ema_updates"] == 3 and raw["step"] == 3 and raw["opt_state"]["count"] == 3
    saved = _leaves(model, state)
    tck.load_state_tree(state, ckpt.restore_like("last_state", tck.state_tree(state)))
    assert state.opt_state["count"].dtype == torch.int32
    after = _leaves(model, state)
    _same({k: v for k, v in after.items() if not k.startswith("grad")},
          {k: v for k, v in saved.items() if not k.startswith("grad")})
    eager_model, eager_state, eager_step, _ = _setup(tiny_vars, opt="adam", graphs=False)
    tck.load_state_tree(eager_state, ckpt.restore_like("last_state", tck.state_tree(eager_state)))
    for i in range(3):
        batch, lr = _torch_batch(_batch(5 + i)), LRS[i]
        state, comps = step(state, batch, lr)
        assert len(captures) == (1 if i == 0 else 2)  # a warm-up, then the new capture
        eager_state, eager_comps = eager_step(eager_state, batch, lr)
        _same(_leaves(model, state, comps), _leaves(eager_model, eager_state, eager_comps))


def test_unfreeze_reset_of_ema_updates_is_replayed(tiny_vars, captures):
    runs = []
    for graphs in (True, False):
        model, state, step, _ = _setup(tiny_vars, graphs=graphs)
        for i in range(4):
            if i == 3:  # Trainer.fit's reset at the unfreeze boundary
                state.ema_updates = 100
            state, comps = step(state, _torch_batch(_batch(i)), LRS[0])
        assert int(state.ema_updates) == 101
        runs.append(_leaves(model, state, comps))
    assert len(captures) == 1
    _same(*runs)


@pytest.mark.parametrize("value", ["number", "tensor"])
def test_counter_assignment_writes_into_the_counter(tiny_vars, value):
    """A state's counter is its own tensor: assigning another state's
    counter (a snapshot restored) copies its value, and a step of one state
    leaves the other's counter as it was."""
    _, state, step, _ = _setup(tiny_vars, graphs=False)
    _, other, _, _ = _setup(tiny_vars, graphs=False)
    other.ema_updates = 5
    counter = state.ema_updates
    state.ema_updates = other.ema_updates if value == "tensor" else int(other.ema_updates)
    assert state.ema_updates is counter and int(counter) == 5
    state, _ = step(state, _torch_batch(_batch(0)), LRS[0])
    assert int(state.ema_updates) == 6 and int(other.ema_updates) == 5


def test_key_over_the_memory_runs_eagerly(tiny_vars, captures, monkeypatch):
    warm_up = inference._warm_up
    monkeypatch.setattr(inference, "_warm_up", lambda *a: (warm_up(*a)[0], 1000))
    monkeypatch.setattr(inference, "_free_bytes", lambda device: 1599)  # 1.6 x 1000 > 1599
    model, state, step, _ = _setup(tiny_vars, graphs=True)
    eager_model, eager_state, eager_step, _ = _setup(tiny_vars, graphs=False)
    for i in range(3):
        batch = _torch_batch(_batch(i))
        state, comps = step(state, batch, LRS[i])
        eager_state, eager_comps = eager_step(eager_state, batch, LRS[i])
    _same(_leaves(model, state, comps), _leaves(eager_model, eager_state, eager_comps))
    assert not captures
    (entry,) = inference.programs_of(model)
    assert entry["eager"] and not entry["captured"] and entry["replays"] == 0
    assert entry["predicted_bytes"] == 1600 and entry["free_bytes"] == 1599


def test_failed_train_capture_raises(tiny_vars, monkeypatch):
    def broken(step, model, inputs):
        raise RuntimeError("operation not permitted when stream is capturing")

    monkeypatch.setattr(inference, "_capture_graph", broken)
    model, state, step, _ = _setup(tiny_vars, graphs=True)
    state, _ = step(state, _torch_batch(_batch(0)), LRS[0])
    with pytest.raises(RuntimeError, match="CUDA graph capture of trainer.train_step"):
        step(state, _torch_batch(_batch(1)), LRS[0])
    assert inference.programs_of(model) == []


@pytest.mark.parametrize("preserve", [False, True])
def test_remat_step_without_rng_state(tiny_vars, monkeypatch, preserve):
    """The remat step with the RNG state stashed (torch's default) or not
    (what a capture needs) gives the same bits; against the step without
    remat, tests/test_torch_train_scales.py's remat bars (gradients 1e-4 of
    the largest, the rest 1e-5 of each leaf's largest: the recompute sums
    in another order)."""
    real = tneck.checkpoint
    flags = []

    def checkpoint(*args, **kw):
        flags.append(kw["preserve_rng_state"])
        return real(*args, **{**kw, "preserve_rng_state": preserve})

    monkeypatch.setattr(tneck, "checkpoint", checkpoint)
    _, _, (remat,), _, _ = _run(tiny_vars, False, steps=1, remat=True)
    assert flags and not any(flags)  # the neck asks for no RNG state
    monkeypatch.setattr(tneck, "checkpoint", real)
    _, _, (stashed,), _, _ = _run(tiny_vars, False, steps=1, remat=True)
    _same(remat, stashed)
    _, _, (plain,), _, _ = _run(tiny_vars, False, steps=1)
    gmax = max(float(v.abs().max()) for k, v in plain.items() if k.startswith("grad"))
    for key, want in plain.items():
        bar = 1e-4 * gmax if key.startswith("grad") else 1e-5 * max(float(want.abs().max()),
                                                                     1e-30)
        assert float((remat[key].double() - want.double()).abs().max()) <= bar, key


ZERO_GRAD_LEAVES = ("attn.key.bias", "teb.mlp2.bias")  # tests/test_torch_train.py's


def _jax_step_batch():
    """tests/test_torch_train.py's step_inputs batch (seed 7), on which its
    bars were set."""
    rng = np.random.default_rng(7)
    boxes = np.zeros((2, 8, 4), np.float32)
    boxes[:, 0] = [0.5, 0.5, 0.4, 0.4]
    boxes[1, 1] = [0.3, 0.6, 0.25, 0.3]
    return {"image": rng.uniform(-0.5, 0.5, (2, 64, 64, 3)).astype(np.float32), "boxes": boxes,
            "labels": np.zeros((2, 8), np.int32)}


def test_graphed_steps_match_jax(tiny_vars, captures):
    """Three graphed steps (the warm-up, the capture's replay, a replay), the
    lr changed between them, each from the starting state (written back in
    place, so the graph reads it) against JAX's jitted step with
    `jnp.asarray(lr, jnp.float32)` from the same variables, at
    test_train_step_matches_jax's bars on its batch: losses 1e-4, gradients
    1e-3 of the leaf's largest JAX gradient (ZERO_GRAD_LEAVES against their
    weight's), parameters and EMA within 1e-3 of the largest JAX change plus
    two float32 ulps of the leaf, BatchNorm statistics and their EMA 1e-5.
    Each step starts from the same state because those bars are one step's:
    after two steps at these rates the float32 rounding of either framework
    is amplified past them (at the third state the port's float32 gradient
    of neck.h6's CBAM conv reads 1.6e-3 of its largest from the port's own
    float64 step, and JAX's stem gradient 4.4e-2)."""
    mc = jcfg.ModelConfig(num_classes=1, input_shape=(64, 64), compute_dtype="float32")
    tc = jcfg.TrainConfig(max_boxes=8, optimizer_type="sgd")
    lc = jtr.loss_config_from(mc, tc)
    jmodel = JFocusModel(**TINY, dtype=jnp.float32)
    tx = jopt.build_optimizer(tc, to_jax(tiny_vars["params"]))
    jstate = jtr.create_train_state(jmodel, to_jax(tiny_vars), tx)
    jstep = jtr.make_train_step(jmodel, tx, lc, tc, donate=False)
    batch = _jax_step_batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(params):
        out, _ = jmodel.apply({"params": params, "batch_stats": to_jax(tiny_vars["batch_stats"])},
                              jbatch["image"], train=True, mutable=["batch_stats"])
        return jloss.detection_loss(out["raw"], jbatch["boxes"], jbatch["labels"], lc)[0]

    model, state, step, _ = _setup(tiny_vars, graphs=True)
    want_g = params_from_jax(jax.jit(jax.grad(loss_fn))(to_jax(tiny_vars["params"])), model)
    old = params_from_jax(tiny_vars["params"], model)
    start = _leaves(model, state)
    for i, lr in enumerate(LRS):
        with torch.no_grad():  # the starting state, written into the step's tensors
            for n, p in model.named_parameters():
                p.copy_(start[f"param {n}"])
            for n, b in model.named_buffers():
                b.copy_(start[f"stat {n}"])
            for key, tensors in state.opt_state.items():
                for n, t in tensors.items():
                    t.copy_(start[f"opt {key} {n}"])
            for n, t in state.ema_params.items():
                t.copy_(start[f"ema {n}"])
            for n, t in state.ema_batch_stats.items():
                t.copy_(start[f"ema stat {n}"])
            state.ema_updates = 0
        new, jcomps = jstep(jstate, jbatch, jnp.asarray(lr, jnp.float32))
        state, comps = step(state, _torch_batch(batch), lr)
        for name in ("loss", "loss_iou", "loss_cls", "loss_dfl"):
            assert abs(float(comps[name]) - float(jcomps[name])) <= 1e-4 * abs(
                float(jcomps[name])), (i, name)
        new_p = params_from_jax(new.params, model)
        new_ema = params_from_jax(new.ema_params, model)
        for name, p in model.named_parameters():
            weight = name.replace(".bias", ".weight")
            of = lambda d: d[weight] if name.endswith(ZERO_GRAD_LEAVES) else d[name]
            err = float((p.grad - want_g[name]).abs().max())
            assert err <= 1e-3 * float(of(want_g).abs().max()), (i, "grad", name, err)
            delta = {k: new_p[k] - old[k] for k in (name, weight)}
            ulp = float(np.spacing(np.float32(old[name].abs().max())))
            tol = 1e-3 * float(of(delta).abs().max()) + 2 * ulp
            assert float((p.detach() - new_p[name]).abs().max()) <= tol, (i, name)
            assert float((state.ema_params[name] - new_ema[name]).abs().max()) <= tol, (i, name)
        stats = state_dict_from_jax({"params": new.params, "batch_stats": new.batch_stats},
                                    model)
        ema_stats = state_dict_from_jax({"params": new.params,
                                         "batch_stats": new.ema_batch_stats}, model)
        for name, buf in model.named_buffers():
            for got, want in ((buf, stats[name]), (state.ema_batch_stats[name], ema_stats[name])):
                err = float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)
                assert err <= 1e-5, (i, name)
        assert int(state.ema_updates) == int(new.ema_updates) == 1
    assert len(captures) == 1 and state.step == 3


# ---------------------------------------------------------------- Trainer.fit

FIT_TINY = dict(num_classes=2, base_channels=8, base_depth=1, deep_mul=0.5, num_heads=2)
FIT_MODEL_CFG = dict(num_classes=2, input_shape=(64, 64), compute_dtype="float32")
FIT_TRAIN_CFG = dict(init_epoch=0, freeze_epoch=1, unfreeze_epoch=2, freeze_train=True,
                     freeze_batch_size=2, unfreeze_batch_size=4, num_workers=2, mosaic=True,
                     mosaic_prob=0.5, mixup=True, mixup_prob=0.5, max_boxes=8, save_period=1,
                     optimizer_type="sgd")
# tests/test_torch_fit.py's JAX_FP32_STRAYS: where JAX's float32 fit strays
# past 1e-3 of a leaf from its own float64 run (BatchNorm's fast variance)
JAX_FP32_STRAYS = {"head.cls0.out.bias", "head.box2.conv2.bn.running_mean",
                   "neck.h1.reduce.bn.running_var", "neck.h4.reduce.bn.running_mean",
                   "neck.h4.reduce.bn.running_var", "neck.h6.reduce.bn.running_mean",
                   "neck.h6.reduce.bn.running_var"}


@pytest.fixture(scope="module")
def fit_lines(tmp_path_factory):
    """tests/test_torch_fit.py's set: 12 images of odd sizes, one to three
    boxes of two classes each, written from seed 0."""
    import cv2

    root = tmp_path_factory.mktemp("graphfit")
    rng = np.random.default_rng(0)
    out = []
    for i in range(12):
        h, w = int(rng.integers(61, 131)), int(rng.integers(61, 131))
        img = np.clip(rng.normal(110, 40, (h, w, 3)), 0, 255).astype(np.uint8)
        tokens = []
        for _ in range(int(rng.integers(1, 4))):
            x1, y1 = int(rng.integers(0, w - 20)), int(rng.integers(0, h - 20))
            x2, y2 = x1 + int(rng.integers(12, w - x1 + 1)), y1 + int(rng.integers(12, h - y1 + 1))
            c = int(rng.integers(0, 2))
            img[y1:y2, x1:x2] = (240, 30, 30) if c else (30, 200, 60)
            tokens.append(f"{x1},{y1},{x2},{y2},{c}")
        path = str(root / f"img{i}.{'png' if i % 2 else 'jpg'}")
        cv2.imwrite(path, img[..., ::-1])
        out.append(" ".join([path] + tokens))
    return out


@pytest.fixture(scope="module")
def fit_vars():
    model = JFocusModel(**FIT_TINY, dtype=jnp.float32)
    return random_variables(model, jnp.zeros((1, 64, 64, 3), jnp.float32), train=True)


@pytest.fixture(scope="module")
def fits(fit_lines, fit_vars):
    """JAX's fit and the port's, eager and with the graphed path forced
    (the capture stubbed), on the same lines."""
    jtrainer = jtr.Trainer(jcfg.ModelConfig(**FIT_MODEL_CFG), jcfg.TrainConfig(**FIT_TRAIN_CFG),
                           model=JFocusModel(**FIT_TINY, dtype=jnp.float32),
                           variables=to_jax(fit_vars), verbose=False)
    jhist = jtrainer.fit(fit_lines[:10], fit_lines[8:])
    out = {"jtrainer": jtrainer, "jhist": jhist}
    made = []

    def capture(step, model, inputs):
        graph = FakeTrainGraph(step, model, inputs)
        made.append(graph)
        return graph, graph.output, 0

    real = inference._capture_graph
    inference._capture_graph = capture
    try:
        for graphs in (False, True):
            model = load_jax_variables(FocusModel(**FIT_TINY, dtype=torch.float32), fit_vars)
            trainer = ttr.Trainer(tcfg.ModelConfig(**FIT_MODEL_CFG),
                                  tcfg.TrainConfig(**FIT_TRAIN_CFG), model=model, verbose=False,
                                  device="cpu")
            trainer.graphs = graphs
            out["graphed" if graphs else "eager"] = (trainer, trainer.fit(fit_lines[:10],
                                                                        fit_lines[8:]))
            out["programs" if graphs else "eager_programs"] = inference.programs_of(model)
    finally:
        inference._capture_graph = real
    out["captures"] = len(made)
    return out


def test_graphed_fit_equals_eager_fit(fits):
    (graphed, ghist), (eager, ehist) = fits["graphed"], fits["eager"]
    assert fits["eager_programs"] == []
    # the freeze and unfreeze train steps and the eval step at batch 2 and 4
    entries = {(p["entry"], p["key"][-1][0][0][0]): p for p in fits["programs"]}
    assert set(entries) == {("trainer.train_step", 2), ("trainer.train_step", 4),
                            ("trainer.eval_step", 2), ("trainer.eval_step", 4)}
    assert fits["captures"] == 3  # unfrozen: 2 steps (warm-up, capture); eval at 4: 1 call
    assert entries[("trainer.train_step", 2)]["replayed_calls"] == 3  # 5 steps
    for g, e in zip(ghist, ehist):
        for key in ("loss", "val_loss", "lr"):
            assert g[key] == e[key], (key, g, e)
    for kind in ("variables", "ema_variables"):
        for group in ("params", "batch_stats"):
            for name, t in getattr(graphed, kind)[group].items():
                assert torch.equal(t, getattr(eager, kind)[group][name]), (kind, name)


def test_graphed_fit_matches_jax(fits):
    """tests/test_torch_fit.py's bars against JAX's float32 fit: history
    within 1e-3 relative, every leaf within 1e-3 of its largest magnitude
    but JAX_FP32_STRAYS (held there to the port's eager fit, above, and
    through it to JAX's float64 fit in tests/test_torch_fit.py)."""
    jtrainer, jhist = fits["jtrainer"], fits["jhist"]
    trainer, thist = fits["graphed"]
    assert len(thist) == len(jhist) == 2
    for j, t in zip(jhist, thist):
        for key in ("loss", "val_loss", "lr"):
            assert np.isfinite(t[key]) and abs(t[key] - float(j[key])) <= 1e-3 * abs(
                float(j[key])), (key, t, j)
    model = trainer.model
    for kind in ("variables", "ema_variables"):
        jv = getattr(jtrainer, kind)
        want = {**params_from_jax(jv["params"], model), **state_dict_from_jax(jv, model)}
        for group in ("params", "batch_stats"):
            for name, t in getattr(trainer, kind)[group].items():
                if name in JAX_FP32_STRAYS:
                    continue
                w = want[name].double()
                err = float((t.double() - w).abs().max())
                assert err <= 1e-3 * max(float(w.abs().max()), 1e-30), (kind, name, err)
