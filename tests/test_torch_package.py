"""Boundaries of the PyTorch port: it imports neither JAX nor the JAX
package, its entry points run on CUDA unless told otherwise, the weight
bridge refuses trees it cannot map, and chip_smoke.py refuses to report
without a GPU."""
from __future__ import annotations

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import transparent_object_detection_tpu_torch as port
from transparent_object_detection_tpu_torch.config import ModelConfig
from transparent_object_detection_tpu_torch.inference import Predictor
from transparent_object_detection_tpu_torch.models import blocks
from transparent_object_detection_tpu_torch.models.detector import (
    FocusModel,
    build_model,
    resolve_device,
)
from transparent_object_detection_tpu_torch.weights import load_jax_variables

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
PKG = Path(port.__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "transparent_object_detection_tpu")


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def test_import_pulls_in_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import transparent_object_detection_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "print(len(list(pkgutil.walk_packages(p.__path__))))\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 5


def test_no_forbidden_import_in_source():
    files = sorted(PKG.rglob("*.py"))
    assert len(files) >= 15
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            assert not any(_forbidden(n) for n in names), f"{path}: imports {names}"


def test_entry_points_default_to_cuda(monkeypatch):
    cfg = ModelConfig(phi="n", input_shape=(64, 64))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(ModelConfig(phi="n", input_shape=(64, 64), int8_dense=True, int8_attn=True))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    model = build_model(cfg, device="cpu", seed=None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Predictor(model, cfg)
    assert Predictor(model, cfg, device="cpu").device == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device(None) == torch.device("cuda")


def _cbam_variables(c: int = 32):
    rng = np.random.default_rng(0)
    return {"params": {
        "fc1": {"kernel": rng.standard_normal((c, c // 16)).astype(np.float32)},
        "fc2": {"kernel": rng.standard_normal((c // 16, c)).astype(np.float32)},
        "spatial": {"kernel": rng.standard_normal((7, 7, 2, 1)).astype(np.float32)},
    }}


def test_weights_bridge_layouts_and_refusals():
    v = _cbam_variables()
    cbam = load_jax_variables(blocks.CBAM(32, dtype=torch.float32), v)
    np.testing.assert_array_equal(cbam.fc1.weight.detach().numpy(), v["params"]["fc1"]["kernel"].T)
    np.testing.assert_array_equal(cbam.spatial.weight.detach().numpy(),
                                  v["params"]["spatial"]["kernel"].transpose(3, 2, 0, 1))

    extra = _cbam_variables()
    extra["params"]["fc3"] = {"kernel": np.zeros((32, 2), np.float32)}
    with pytest.raises(KeyError, match="fc3"):
        load_jax_variables(blocks.CBAM(32), extra)
    odd = _cbam_variables()
    odd["params"]["fc1"]["weird"] = np.zeros(2, np.float32)
    with pytest.raises(KeyError, match="unmapped JAX leaf"):
        load_jax_variables(blocks.CBAM(32), odd)
    missing = _cbam_variables()
    del missing["params"]["spatial"]
    with pytest.raises(KeyError, match="unfilled"):
        load_jax_variables(blocks.CBAM(32), missing)
    wrong = _cbam_variables()
    wrong["params"]["fc2"]["kernel"] = np.zeros((3, 32), np.float32)
    with pytest.raises(ValueError, match="shape"):
        load_jax_variables(blocks.CBAM(32), wrong)


def test_module_names_follow_the_flax_tree():
    names = dict(FocusModel(base_channels=8, base_depth=1, dtype=torch.float32).named_parameters())
    for key in ("backbone.dark3_attn.query.weight", "backbone.dark3_attn.gamma",
                "backbone.dark2_c2f.m0.cv1.conv.weight", "neck.h2.teb.qkv.weight",
                "neck.h2.teb.norm1.weight", "neck.h3.bn.weight", "head.box0.out.bias",
                "head.cls2.cbam2.spatial.weight"):
        assert key in names, key


def test_chip_smoke_refuses_without_gpu(tmp_path):
    """No card: non-zero exit and no result line, in the repo and in a
    directory holding chip_smoke.py alone."""
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(REPO / "chip_smoke.py", alone)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for cwd, script in ((REPO, REPO / "chip_smoke.py"), (tmp_path, alone)):
        res = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                             capture_output=True, text=True, timeout=120)
        assert res.returncode != 0
        assert '"ok"' not in res.stdout
