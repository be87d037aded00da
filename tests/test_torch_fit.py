"""The port's epoch loop (`Trainer.fit`), checkpoints, the shape-filtered
partial load and `weights_init` against the JAX package on the CPU, in fp32
(TF32 off), on a synthetic set written with numpy and cv2.

Bars:
  * Trainer.fit against JAX's Trainer.fit on the same lines (the tiny model
    of tests/test_train.py, 64 x 64, JAX variables bridged by
    weights.load_jax_variables; freeze for 1 epoch at batch 2, then unfreeze
    at batch 4; mosaic and mixup on): per-epoch loss, val_loss and lr
    within 1e-3 relative; step and ema_updates equal. Every parameter and
    EMA leaf within 1e-4 of the leaf's largest magnitude of JAX's fit run
    in float64 (tests/_jax_fit_float64.py, its own process), and of the
    port's fit in float64; and within 1e-3 of JAX's float32 fit wherever
    JAX's float32 fit is itself within 1e-3 of its float64 run. On [0, 1]
    images flax's fast variance E[x^2] - E[x]^2 cancels in float32, which
    puts JAX's float32 fit up to 3.8e-3 of a leaf's magnitude from its own
    float64 run at a few BatchNorm statistics and the head's class bias
    (JAX_FP32_STRAYS); there the bar against JAX's float32 fit carries
    that distance, and the float64 bar holds;
  * exact resume: two epochs against one epoch plus a resume from its
    `last_state`: the same bits for parameters, BatchNorm statistics, EMA
    and optimizer state;
  * load_weights_partial: the same merged values and the same loaded and
    skipped paths as JAX's;
  * weights_init at a (3, 3, 64, 4096) kernel: std within 1% of JAX's draw
    and of the target, the he and glorot draws truncated at 2 of their
    pre-truncation std (the largest |w| within 1% of JAX's), orthogonal
    rows times the gain, norm scales N(1, 0.02) and biases 0, and on the
    tiny model the same set of leaves touched as JAX's.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import subprocess
import sys

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import random_variables, to_jax
from transparent_object_detection_tpu import config as jcfg
from transparent_object_detection_tpu.models import FocusModel as JFocusModel
from transparent_object_detection_tpu.train import checkpoints as jck
from transparent_object_detection_tpu.train import init as jinit
from transparent_object_detection_tpu.train import trainer as jtr
from transparent_object_detection_tpu_torch import config as tcfg
from transparent_object_detection_tpu_torch.models.detector import FocusModel
from transparent_object_detection_tpu_torch.train import checkpoints as tck
from transparent_object_detection_tpu_torch.train import init as tinit
from transparent_object_detection_tpu_torch.train import trainer as ttr
from transparent_object_detection_tpu_torch.weights import (
    load_jax_variables,
    params_from_jax,
    state_dict_from_jax,
)

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

NAMES = {"best_weights", "last_weights", "last_state", "ep001_weights", "ep002_weights"}


TINY = dict(num_classes=2, base_channels=8, base_depth=1, deep_mul=0.5, num_heads=2)


def fresh_port_model():
    return FocusModel(**TINY, dtype=torch.float32)


@pytest.fixture(scope="module")
def lines(tmp_path_factory):
    """12 images of odd sizes (PNG and JPEG), one to three boxes of two
    classes each, written from seed 0."""
    root = tmp_path_factory.mktemp("fitds")
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


MODEL_CFG = dict(num_classes=2, input_shape=(64, 64), compute_dtype="float32")
TRAIN_CFG = dict(init_epoch=0, freeze_epoch=1, unfreeze_epoch=2, freeze_train=True,
                 freeze_batch_size=2, unfreeze_batch_size=4, num_workers=2, mosaic=True,
                 mosaic_prob=0.5, mixup=True, mixup_prob=0.5, max_boxes=8, save_period=1,
                 optimizer_type="sgd")
# The leaves where JAX's float32 fit strays past 1e-3 of the leaf's largest
# magnitude from JAX's float64 fit (2.6e-3 at the class bias, 1.1e-3 to
# 3.8e-3 at these BatchNorm statistics): BatchNorm's float32 fast variance.
JAX_FP32_STRAYS = {"head.cls0.out.bias", "head.box2.conv2.bn.running_mean",
                   "neck.h1.reduce.bn.running_var", "neck.h4.reduce.bn.running_mean",
                   "neck.h4.reduce.bn.running_var", "neck.h6.reduce.bn.running_mean",
                   "neck.h6.reduce.bn.running_var"}


def fit_cfgs(**over):
    tc = {**TRAIN_CFG, **over}
    return (jcfg.ModelConfig(**MODEL_CFG), jcfg.TrainConfig(**tc),
            tcfg.ModelConfig(**MODEL_CFG), tcfg.TrainConfig(**tc))


@pytest.fixture(scope="module")
def tiny_vars():
    model = JFocusModel(**TINY, dtype=jnp.float32)
    return random_variables(model, jnp.zeros((1, 64, 64, 3), jnp.float32), train=True)


def bridged_port_model(tiny_vars):
    return load_jax_variables(fresh_port_model(), tiny_vars)


def _err(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


def leaf_close(got: torch.Tensor, want, bar: float, what: str, slack: float = 0.0) -> None:
    """max |got - want| <= bar * max |want| + slack."""
    want = np.asarray(want, np.float64)
    err = _err(got.detach().double().numpy(), want)
    assert err <= bar * max(float(np.abs(want).max()), 1e-30) + slack, (what, err, slack)


@pytest.fixture(scope="module")
def fits(lines, tiny_vars, tmp_path_factory):
    """JAX's and the port's fit on the same lines, each with its
    checkpointer: freeze 1 epoch at batch 2 (5 steps), unfreeze 1 at batch 4
    (2 steps), the validation loss on 4 lines. Beside them, unsaved, JAX's
    fit in float64 in its own process and the port's in float64."""
    jmc, jtc, tmc, ttc = fit_cfgs()
    root = tmp_path_factory.mktemp("fits")
    spec, out = root / "jax64_in.pkl", root / "jax64_out.pkl"
    with open(spec, "wb") as f:
        pickle.dump({"lines": lines[:10], "val_lines": lines[8:], "variables": tiny_vars,
                     "tiny": TINY, "model_cfg": MODEL_CFG, "train_cfg": TRAIN_CFG}, f)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [repo] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p])}
    jax64 = subprocess.Popen(
        [sys.executable, os.path.join(repo, "tests", "_jax_fit_float64.py"), str(spec), str(out)],
        cwd=repo, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        jtrainer = jtr.Trainer(jmc, jtc, model=JFocusModel(**TINY, dtype=jnp.float32),
                               variables=to_jax(tiny_vars), verbose=False)
        jckpt = jck.CheckpointManager(str(root / "jax"))
        jhist = jtrainer.fit(lines[:10], lines[8:], checkpointer=jckpt)
        ttrainer = ttr.Trainer(tmc, ttc, model=bridged_port_model(tiny_vars), verbose=False,
                               device="cpu")
        tckpt = tck.CheckpointManager(str(root / "port"))
        thist = ttrainer.fit(lines[:10], lines[8:], checkpointer=tckpt)
        m64 = FocusModel(**TINY, dtype=torch.float64, norm_dtype=torch.float64)
        f64 = ttr.Trainer(tmc, ttc, model=load_jax_variables(m64, tiny_vars).double(),
                          verbose=False, device="cpu")
        f64.fit(lines[:10], lines[8:])
        log, _ = jax64.communicate(timeout=600)
    finally:
        jax64.kill()
    assert jax64.returncode == 0, log[-4000:]
    with open(out, "rb") as f:
        jax64_fit = pickle.load(f)
    return dict(jtrainer=jtrainer, jckpt=jckpt, jhist=jhist, ttrainer=ttrainer, tckpt=tckpt,
                thist=thist, root=root, f64=f64, jax64=jax64_fit)


def test_fit_history_matches_jax(fits):
    jhist, thist, whist = fits["jhist"], fits["thist"], fits["jax64"]["history"]
    assert len(thist) == len(jhist) == len(whist) == 2
    for j, t, w in zip(jhist, thist, whist):
        assert t["epoch"] == j["epoch"] == w["epoch"]
        for key in ("loss", "val_loss", "lr"):
            assert np.isfinite(t[key])
            assert abs(t[key] - float(j[key])) <= 1e-3 * abs(float(j[key])), (key, t, j)
            # JAX's float64 fit: the float32 fast variance's error gone
            assert abs(t[key] - w[key]) <= 1e-5 * abs(w[key]), (key, t, w)


def test_fit_state_matches_jax(fits):
    jstate = fits["jckpt"].load_tree("last_state")
    tstate = fits["tckpt"].load_tree("last_state")
    assert tstate["step"] == int(jstate["step"]) == 7
    assert tstate["ema_updates"] == int(jstate["ema_updates"]) == 2 * 1 + 2
    model = fits["ttrainer"].model
    strays = set()
    for kind in ("variables", "ema_variables"):
        jv = getattr(fits["jtrainer"], kind)
        wv = fits["jax64"][kind]
        tv = getattr(fits["ttrainer"], kind)
        ref = getattr(fits["f64"], kind)
        want = {**params_from_jax(jv["params"], model), **state_dict_from_jax(jv, model)}
        # (the bridge hands leaves over in float32: 6e-8 of a leaf, far under the bars)
        want64 = {**params_from_jax(wv["params"], model), **state_dict_from_jax(wv, model)}
        for group in ("params", "batch_stats"):
            for name, t in tv[group].items():
                w64 = want64[name].double().numpy()
                leaf_close(t, w64, 1e-4, f"{kind} {name} against JAX's float64 fit")
                leaf_close(t, ref[group][name].double().numpy(), 1e-4,
                           f"{kind} {name} against the port's float64 fit")
                # JAX's float32 fit: its own distance from its float64 run
                own = _err(want[name], w64)
                if own <= 1e-3 * float(np.abs(w64).max()):
                    leaf_close(t, want[name], 1e-3, f"{kind} {name}")
                else:
                    strays.add(name)
                    leaf_close(t, want[name], 1e-3, f"{kind} {name}", slack=own)
    assert strays <= JAX_FP32_STRAYS, strays - JAX_FP32_STRAYS
    # the model trained in place holds the fit's variables
    for name, p in model.named_parameters():
        assert torch.equal(p.detach(), fits["ttrainer"].variables["params"][name])


def test_checkpoint_names_match_jax(fits):
    root = fits["root"]
    assert set(os.listdir(root / "port")) == set(os.listdir(root / "jax")) == NAMES
    best = fits["tckpt"].load_tree("best_weights")
    assert set(best) == {"params", "batch_stats"}
    # with EMA on, best/last hold the EMA weights
    last = fits["tckpt"].load_tree("last_weights")
    for name, t in fits["ttrainer"].ema_variables["params"].items():
        assert torch.equal(last["params"][name], t)


class _KeepFirstState(tck.CheckpointManager):
    """Keeps epoch 1's last_state under a second name."""

    def save_epoch(self, state, epoch, is_best, period):
        super().save_epoch(state, epoch, is_best, period)
        if epoch == 1:
            self.save_tree("ep001_state", tck.state_tree(state))


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_resume_is_exact(lines, tiny_vars, tmp_path, optimizer):
    _, _, tmc, ttc = fit_cfgs(optimizer_type=optimizer)
    full = _KeepFirstState(str(tmp_path / "full"))
    ttr.Trainer(tmc, ttc, model=bridged_port_model(tiny_vars), verbose=False,
                device="cpu").fit(lines[:10], lines[8:], checkpointer=full)
    resumed = tck.CheckpointManager(str(tmp_path / "resumed"))
    hist = ttr.Trainer(tmc, dataclasses.replace(ttc, init_epoch=1), model=fresh_port_model(),
                       verbose=False, device="cpu").fit(
        lines[:10], lines[8:], checkpointer=resumed,
        resume_from=str(tmp_path / "full" / "ep001_state"))
    assert [h["epoch"] for h in hist] == [1]
    a, b = full.load_tree("last_state"), resumed.load_tree("last_state")
    assert a["step"] == b["step"] == 7 and a["ema_updates"] == b["ema_updates"] == 4

    def leaves(tree, path=()):
        if isinstance(tree, dict):
            for k in sorted(tree):
                yield from leaves(tree[k], path + (k,))
        else:
            yield path, tree

    la, lb = dict(leaves(a)), dict(leaves(b))
    assert la.keys() == lb.keys()
    assert any(p[0] == "opt_state" for p in la)
    for path, va in la.items():
        if isinstance(va, torch.Tensor):
            assert torch.equal(va, lb[path]), path
        else:
            assert va == lb[path], path


def test_resume_requires_checkpointer_and_matching_tree(lines, tiny_vars, tmp_path):
    _, _, tmc, ttc = fit_cfgs()
    trainer = ttr.Trainer(tmc, ttc, model=fresh_port_model(), verbose=False, device="cpu")
    with pytest.raises(ValueError, match="checkpointer"):
        trainer.fit(lines[:10], lines[8:], resume_from="last_state")
    ck = tck.CheckpointManager(str(tmp_path))
    ck.save_tree("small", {"params": {"a": torch.zeros(2)}})
    with pytest.raises(ValueError, match="leaves"):
        trainer.fit(lines[:10], lines[8:], checkpointer=ck, resume_from="small")


def test_trainer_raises_without_a_card(monkeypatch):
    _, _, tmc, ttc = fit_cfgs()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttr.Trainer(tmc, ttc, model=fresh_port_model())


# ---------------------------------------------------------------- partial load
PARTIAL_CASES = {
    "test_train": ({"a": np.zeros((2, 2)), "b": {"k": np.zeros(3)}, "c": np.zeros(1)},
                   {"a": np.ones((2, 2)), "b": {"k": np.ones(4)}, "d": np.ones(1)}),
    "dtypes": ({"z": np.zeros(3, np.float32), "y": {"k": np.zeros((2, 3), np.float64)}},
               {"z": np.arange(3, dtype=np.int64), "y": {"k": np.ones((2, 3), np.float32)}}),
}


@pytest.mark.parametrize("case", sorted(PARTIAL_CASES))
def test_load_weights_partial_matches_jax(case):
    target, source = PARTIAL_CASES[case]
    jm, jl, js = jck.load_weights_partial(target, source)
    tm, tl, ts = tck.load_weights_partial(target, source)
    assert (tl, ts) == (jl, js)
    jflat = jax.tree_util.tree_flatten_with_path(jm)[0]
    tflat = jax.tree_util.tree_flatten_with_path(tm)[0]
    assert [jax.tree_util.keystr(p) for p, _ in jflat] == [jax.tree_util.keystr(p)
                                                          for p, _ in tflat]
    for (_, a), (_, b) in zip(jflat, tflat):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_load_weights_partial_on_a_state_dict(tiny_vars):
    model = bridged_port_model(tiny_vars)
    target = fresh_port_model().state_dict()
    source = dict(model.state_dict())
    source["head.cls0.out.weight"] = torch.zeros(3, 3)  # shape mismatch
    del source["neck.h3.bn.running_mean"]
    merged, loaded, skipped = tck.load_weights_partial(target, source)
    assert skipped == ["['head.cls0.out.weight']", "['neck.h3.bn.running_mean']"]
    assert len(loaded) == len(target) - 2
    for name, t in merged.items():
        want = target[name] if f"['{name}']" in skipped else source[name]
        assert torch.equal(t, want) and t.dtype == target[name].dtype, name


# ---------------------------------------------------------------- weights_init
KERNEL = (3, 3, 64, 4096)  # (kh, kw, in, out) as JAX stores it


@pytest.fixture(scope="module")
def big_params():
    """One large conv kernel, a dense kernel, a norm and a leaf no rule
    touches, as a JAX tree and as the port's dict of the same zeros."""
    jtree = {"stem": {"conv": {"kernel": np.zeros(KERNEL, np.float32)},
                      "bn": {"scale": np.zeros(4096, np.float32),
                             "bias": np.ones(4096, np.float32)}},
             "fc": {"kernel": np.zeros((300, 200), np.float32),
                    "bias": np.ones(200, np.float32)}}
    tparams = {"stem.conv.weight": torch.zeros(4096, 64, 3, 3),
               "stem.bn.weight": torch.zeros(4096), "stem.bn.bias": torch.ones(4096),
               "fc.weight": torch.zeros(200, 300), "fc.bias": torch.ones(200)}
    return jtree, tparams


@pytest.mark.parametrize("kind", ["normal", "xavier", "kaiming", "orthogonal"])
def test_weights_init_draws_jax_distributions(big_params, kind):
    jtree, tparams = big_params
    jout = jinit.weights_init(to_jax(jtree), jax.random.key(1), kind)
    tout = tinit.weights_init(tparams, seed=1, init_type=kind)
    jk = np.asarray(jout["stem"]["conv"]["kernel"], np.float64)
    tk = tout["stem.conv.weight"].double().numpy()
    assert tk.shape == (4096, 64, 3, 3) and tout["stem.conv.weight"].dtype == torch.float32
    fan_in, fan_out = 64 * 9, 4096 * 9
    target = {"normal": 0.02, "xavier": (2 / (fan_in + fan_out)) ** 0.5,
              "kaiming": (2 / fan_in) ** 0.5, "orthogonal": 0.02 / 4096 ** 0.5}[kind]
    for draw in (jk, tk):
        assert abs(draw.std() / target - 1) <= 0.01, (kind, draw.std(), target)
    assert abs(tk.std() / jk.std() - 1) <= 0.01
    if kind in ("xavier", "kaiming"):  # truncated at 2 of the pre-truncation std
        cut = 2 * target / tinit.TRUNCATED_NORMAL_STD
        assert np.abs(tk).max() <= cut * (1 + 1e-6) and np.abs(jk).max() <= cut * (1 + 1e-6)
        assert abs(np.abs(tk).max() / np.abs(jk).max() - 1) <= 0.01
    if kind == "normal":  # untruncated: the tails reach past 4 std
        assert np.abs(tk).max() > 4 * target and np.abs(jk).max() > 4 * target
    if kind == "orthogonal":
        # rows of (out, in * kh * kw) orthonormal times the gain, as JAX's
        # columns of (kh * kw * in, out) are
        m = tk.reshape(4096, -1)
        jm = jk.reshape(-1, 4096).T
        for mat in (m, jm):  # 4096 rows of 576: the columns are orthonormal
            np.testing.assert_allclose(mat.T @ mat / 0.02**2, np.eye(576), atol=2e-4)
        fc = tout["fc.weight"].double().numpy()  # (200, 300): orthonormal rows
        np.testing.assert_allclose(fc @ fc.T / 0.02**2, np.eye(200), atol=2e-4)
    # norm scales N(1, 0.02), norm biases 0, a dense bias untouched
    for scale in (np.asarray(jout["stem"]["bn"]["scale"]), tout["stem.bn.weight"].numpy()):
        assert abs(scale.mean() - 1) <= 2e-3 and abs(scale.std() / 0.02 - 1) <= 0.05
    assert float(np.abs(np.asarray(jout["stem"]["bn"]["bias"])).max()) == 0.0
    assert torch.equal(tout["stem.bn.bias"], torch.zeros(4096))
    assert torch.equal(tout["fc.bias"], torch.ones(200))
    assert np.array_equal(np.asarray(jout["fc"]["bias"]), np.ones(200, np.float32))


def test_weights_init_touches_jax_leaves(tiny_vars):
    """On the whole tiny model: the leaves JAX re-draws are the leaves the
    port re-draws (JAX's run on a tree of the same names and ranks with
    small leaves: the rule reads names and ranks only); unknown kinds raise;
    the tensors keep device and dtype."""
    model = bridged_port_model(tiny_vars)
    old = dict(model.named_parameters())
    small = jax.tree_util.tree_map(lambda a: np.full((2,) * a.ndim, 0.5, np.float32),
                                   tiny_vars["params"])
    jnew = jinit.weights_init(to_jax(small), jax.random.key(2), "kaiming")
    jchanged = set()
    for path, leaf in jax.tree_util.tree_flatten_with_path(jnew)[0]:
        keys = [p.key for p in path]
        if np.any(np.asarray(leaf) != 0.5):
            last = {"kernel": "weight", "scale": "weight"}.get(keys[-1], keys[-1])
            jchanged.add(".".join(keys[:-1] + [last]))
    tnew = tinit.weights_init(old, seed=2, init_type="kaiming")
    tchanged = {n for n in old if not torch.equal(tnew[n], old[n].detach())}
    assert tchanged == jchanged
    assert {"backbone.stem.conv.weight", "backbone.stem.bn.weight", "neck.h1.teb.norm1.bias",
            "neck.h1.teb.qkv.weight"} <= tchanged
    assert not {"backbone.dark3_attn.gamma", "head.box0.out.bias",
                "neck.h1.teb.qkv.bias"} & tchanged
    assert all(tnew[n].dtype == old[n].dtype for n in old)
    with pytest.raises(NotImplementedError):
        tinit.weights_init(old, init_type="bogus")
