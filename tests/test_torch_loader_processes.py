"""The port's process-pool loader after an OpenMP region in the thread that
starts it.

libgomp keeps its thread pool's state across `fork`: a worker forked from a
thread that has run one of the native library's OpenMP regions (a mixup
blend, native/fused_preprocess.cpp `blend_half_u8`) waits forever in its own
first region. The port's loader forks its workers from a fresh interpreter
(the `forkserver` start method) and hands them the dataset through the
pool's initializer, so the same sequence completes there, with the threaded
loader's batches bit for bit. The check runs in its own interpreter under a timeout, so that a
regression shows as a timeout and not as a hung test run."""
from __future__ import annotations

import json
import os
import signal
import subprocess
import sys

import cv2
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_AFTER_OPENMP = """
import json, sys
import numpy as np
from transparent_object_detection_tpu_torch.data import dataset as tds, loader as tld
from transparent_object_detection_tpu_torch.data import native
lines = json.loads(sys.argv[1])
# an OpenMP region of the native library in this (the loader's) thread
assert native.available(), "the native library did not build"
a = np.arange(3 * 64 * 64, dtype=np.uint8).reshape(64, 64, 3)
native.blend_half_u8(a, a[::-1].copy())
dkw = dict(input_shape=(64, 64), num_classes=2, max_boxes=6, epoch_length=4, mixup=True)
kw = dict(batch_size=3, shuffle=True, num_workers=2, seed=5)
pool = tld.DataLoader(tds.DetectionDataset(lines * 2, **dkw), use_processes=True, **kw)
threads = tld.DataLoader(tds.DetectionDataset(lines * 2, **dkw), **kw)
n = 0
for epoch in (0, 1):
    pool.set_epoch(epoch)
    threads.set_epoch(epoch)
    got, want = list(pool), list(threads)
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k])
            n += 1
print("compared", n)
"""


@pytest.fixture(scope="module")
def lines(tmp_path_factory):
    """6 images of odd sizes with one or two boxes of two classes, seed 0."""
    root = tmp_path_factory.mktemp("loaderds")
    rng = np.random.default_rng(0)
    out = []
    for i in range(6):
        h, w = int(rng.integers(41, 97)) | 1, int(rng.integers(41, 97)) | 1
        img = np.clip(rng.normal(120, 50, (h, w, 3)), 0, 255).astype(np.uint8)
        tokens = []
        for _ in range(int(rng.integers(1, 3))):
            x1, y1 = int(rng.integers(0, w - 12)), int(rng.integers(0, h - 12))
            x2, y2 = x1 + int(rng.integers(8, w - x1 + 1)), y1 + int(rng.integers(8, h - y1 + 1))
            c = int(rng.integers(0, 2))
            img[y1:y2, x1:x2] = (250, 20, 40) if c else (20, 220, 90)
            tokens.append(f"{x1},{y1},{x2},{y2},{c}")
        path = str(root / f"img{i}.{'png' if i % 2 else 'jpg'}")
        cv2.imwrite(path, img[..., ::-1])
        out.append(" ".join([path] + tokens))
    return out


def test_process_pool_after_openmp_matches_threads(lines):
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [REPO] + os.environ.get("PYTHONPATH", "").split(os.pathsep))}
    # its own session, so that a hang ends with its workers
    proc = subprocess.Popen([sys.executable, "-c", _AFTER_OPENMP, json.dumps(lines)], cwd=REPO,
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=120)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        pytest.fail("the process-pool epoch did not finish in 120 s after an OpenMP region")
    assert proc.returncode == 0, err[-3000:]
    assert out.split() == ["compared", "32"]
