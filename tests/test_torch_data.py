"""The port's data pipeline against the JAX package's on the CPU: the same
annotation parsing and COCO conversion, every augmentation bit for bit on
odd-sized images with generators of the same seed, the same dataset arrays
over seeds, epochs and indices (train and eval, the mosaic phase on and off,
mixup, the image cache), the same loader batches (threads, processes,
shards), the same native library results, and `device_prefetch` (values
and dtypes, a producer's exception relayed, no device without a card).
Equality is exact throughout: the port's copies compute the same arrays."""
from __future__ import annotations

import json
import os
import subprocess
import sys
import threading

import cv2
import numpy as np
import pytest
import torch

from transparent_object_detection_tpu.data import annotations as jann
from transparent_object_detection_tpu.data import augment as jaug
from transparent_object_detection_tpu.data import dataset as jds
from transparent_object_detection_tpu.data import loader as jld
from transparent_object_detection_tpu.data import native as jnative
from transparent_object_detection_tpu_torch import data as tdata
from transparent_object_detection_tpu_torch.data import annotations as tann
from transparent_object_detection_tpu_torch.data import augment as taug
from transparent_object_detection_tpu_torch.data import dataset as tds
from transparent_object_detection_tpu_torch.data import loader as tld
from transparent_object_detection_tpu_torch.data import native as tnative

SEEDS = (0, 1, 2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def assert_same(a, b, what=""):
    """Arrays (or dicts of arrays) equal in dtype, shape and every bit."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            assert_same(a[k], b[k], f"{what}[{k}]")
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype, a.shape, b.shape)
    np.testing.assert_array_equal(a, b, err_msg=what)


@pytest.fixture(scope="module")
def lines(tmp_path_factory):
    """8 images of odd sizes (PNG and JPEG) with one to three boxes of two
    classes, one image without boxes, from seed 0."""
    root = tmp_path_factory.mktemp("datads")
    rng = np.random.default_rng(0)
    out = []
    for i in range(8):
        h, w = int(rng.integers(41, 97)) | 1, int(rng.integers(41, 97)) | 1
        img = np.clip(rng.normal(120, 50, (h, w, 3)), 0, 255).astype(np.uint8)
        tokens = []
        for _ in range(0 if i == 5 else int(rng.integers(1, 4))):
            x1, y1 = int(rng.integers(0, w - 12)), int(rng.integers(0, h - 12))
            x2, y2 = x1 + int(rng.integers(8, w - x1 + 1)), y1 + int(rng.integers(8, h - y1 + 1))
            c = int(rng.integers(0, 2))
            img[y1:y2, x1:x2] = (250, 20, 40) if c else (20, 220, 90)
            tokens.append(f"{x1},{y1},{x2},{y2},{c}")
        path = str(root / f"img{i}.{'png' if i % 2 else 'jpg'}")
        cv2.imwrite(path, img[..., ::-1])
        out.append(" ".join([path] + tokens))
    return out


# ---------------------------------------------------------------- annotations
def test_annotations_match_jax(lines, tmp_path):
    extra = ["/x/y.png", "  /ab/c.jpg 1.5,2,30.25,40,3  ", "/p.png 0,0,10,10,0 5,5,9,9,1"]
    for line in lines + extra:
        jp, jb = jann.parse_annotation_line(line)
        tp, tb = tann.parse_annotation_line(line)
        assert jp == tp
        assert_same(jb, tb, line)
    for bad in ("", "/p.png 1,2,3,4"):
        for mod in (jann, tann):
            with pytest.raises(ValueError):
                mod.parse_annotation_line(bad)
    tann.write_annotation_file(lines + extra, str(tmp_path / "t.txt"))
    jann.write_annotation_file(lines + extra, str(tmp_path / "j.txt"))
    assert (tmp_path / "t.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()
    assert tann.read_annotation_file(str(tmp_path / "t.txt")) == jann.read_annotation_file(
        str(tmp_path / "j.txt"))


def test_coco_conversion_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    cats = [{"id": int(c), "name": f"c{c}"} for c in (90, 7, 13, 1)]
    coco = {"images": [{"id": i, "file_name": f"im{i}.jpg"} for i in range(6)],
            "annotations": [{"image_id": int(rng.integers(0, 6)),
                             "category_id": int(rng.choice([90, 7, 13, 1])),
                             "bbox": [float(v) for v in rng.uniform(0, 50, 4)],
                             "iscrowd": int(rng.random() < 0.2)} for _ in range(20)],
            "categories": cats}
    p = tmp_path / "inst.json"
    p.write_text(json.dumps(coco))
    assert tann.coco_category_remap(cats) == jann.coco_category_remap(cats)
    for kw in ({}, {"skip_crowd": False}, {"remap": {90: 0, 7: 1, 13: 2, 1: 3}}):
        assert (tann.coco_to_annotation_lines(str(p), "/imgs", **kw)
                == jann.coco_to_annotation_lines(str(p), "/imgs", **kw))


# ---------------------------------------------------------------- augmentation
def _image(seed, h, w):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)


def _boxes(seed, h, w, n=4):
    rng = np.random.default_rng(seed + 100)
    xy = rng.uniform(0, [w * 0.7, h * 0.7], (n, 2))
    wh = rng.uniform(2, [w * 0.5, h * 0.5], (n, 2))
    return np.concatenate([xy, xy + wh, rng.integers(0, 3, (n, 1))], 1).astype(np.float32)


def test_load_rgb_matches_jax(lines):
    for line in lines:
        path = line.split()[0]
        assert_same(taug.load_rgb(path), jaug.load_rgb(path), path)
    for mod in (jaug, taug):
        with pytest.raises(FileNotFoundError):
            mod.load_rgb("/nonexistent/image.png")


@pytest.mark.parametrize("seed", SEEDS)
def test_augmentations_match_jax_bit_for_bit(seed):
    sizes = ((37, 53), (101, 67), (75, 75))
    sizes = sizes[seed % 3:] + sizes[:seed % 3]
    img, boxes = _image(seed, *sizes[0]), _boxes(seed, *sizes[0])
    # hsv_jitter
    out = [mod.hsv_jitter(img, np.random.default_rng(seed)) for mod in (jaug, taug)]
    assert_same(*out, "hsv_jitter")
    # letterbox_deterministic, to square and non-square inputs
    for shape in ((64, 64), (48, 80)):
        j = jaug.letterbox_deterministic(img, boxes, shape)
        t = taug.letterbox_deterministic(img, boxes, shape)
        assert_same(j[0], t[0], "letterbox canvas")
        assert_same(j[1], t[1], "letterbox boxes")
    # random_affine: random, centred and quadrant placement; the generators
    # must also be left in the same state (every draw in the same order)
    for kw in ({}, {"place_random": False}, {"quadrant_offset": (-7, 11)},
               {"jitter": 0.0, "scale_range": (1.0, 1.0), "flip_prob": 1.0}):
        gj, gt = np.random.default_rng(seed), np.random.default_rng(seed)
        j = jaug.random_affine(img, boxes, (64, 64), gj, **kw)
        t = taug.random_affine(img, boxes, (64, 64), gt, **kw)
        assert_same(j[0], t[0], f"random_affine {kw}")
        assert_same(j[1], t[1], f"random_affine boxes {kw}")
        assert j[2] == t[2] and gj.random() == gt.random()
    # mixup of uint8 images (the native blend) and of a float one (numpy)
    other = _image(seed + 7, *img.shape[:2])
    for a in (img, img.astype(np.float32)):
        j = jaug.mixup(a, boxes, other, boxes[:2])
        t = taug.mixup(a, boxes, other, boxes[:2])
        assert_same(j[0], t[0], "mixup")
        assert_same(j[1], t[1], "mixup boxes")


@pytest.mark.parametrize("native_mosaic", ["0", "1"])
@pytest.mark.parametrize("seed", SEEDS)
def test_mosaic4_matches_jax_bit_for_bit(seed, native_mosaic, monkeypatch):
    """Both pixel routes (cv2 and, with TOD_NATIVE_MOSAIC=1, the native
    kernel), with empty and full box sets among the tiles."""
    monkeypatch.setenv("TOD_NATIVE_MOSAIC", native_mosaic)
    sizes = ((37, 53), (101, 67), (75, 75), (49, 131))
    imgs = [_image(seed * 10 + i, *s) for i, s in enumerate(sizes)]
    boxes = [_boxes(seed * 10 + i, *s, n=i) for i, s in enumerate(sizes)]
    for shape in ((64, 64), (96, 64)):
        gj, gt = np.random.default_rng(seed), np.random.default_rng(seed)
        j = jaug.mosaic4(imgs, boxes, shape, gj)
        t = taug.mosaic4(imgs, boxes, shape, gt)
        assert_same(j[0], t[0], "mosaic canvas")
        assert_same(j[1], t[1], "mosaic boxes")
        assert gj.random() == gt.random()


# ---------------------------------------------------------------- native library
def test_native_build_matches_jax_binding():
    assert tnative.available() and jnative.available()
    assert tnative._OUT != jnative._OUT
    assert os.sep + os.path.join("build", "torch_native", "") in tnative._OUT
    assert os.path.exists(tnative._OUT)
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (45, 77, 3), dtype=np.uint8)
    batch = rng.integers(0, 256, (3, 45, 77, 3), dtype=np.uint8)
    for shape in ((64, 64), (32, 96)):
        assert_same(tnative.letterbox_u8(img, shape), jnative.letterbox_u8(img, shape))
        assert_same(tnative.letterbox_batch_u8(batch, shape),
                    jnative.letterbox_batch_u8(batch, shape))
    assert_same(tnative.blend_half_u8(img, img[::-1].copy()),
                jnative.blend_half_u8(img, img[::-1].copy()))
    assert_same(tnative.hsv_jitter_u8(img.copy(), 1.05, 0.8, 1.2),
                jnative.hsv_jitter_u8(img.copy(), 1.05, 0.8, 1.2))
    srcs = [rng.integers(0, 256, s + (3,), dtype=np.uint8)
            for s in ((37, 53), (101, 67), (75, 75), (49, 131))]
    geom = np.array([[30, 20, 2, 4, 0], [25, 40, 2, 24, 1], [40, 35, 32, 24, 0],
                     [33, 27, 32, -3, 1]], np.int32)
    for gains in ((1.0, 1.0, 1.0), (0.97, 1.3, 0.7)):
        assert_same(tnative.mosaic4_u8(srcs, geom, (64, 64), 32, 24, 128, gains),
                    jnative.mosaic4_u8(srcs, geom, (64, 64), 32, 24, 128, gains))


# ---------------------------------------------------------------- dataset
DATASET_CASES = {
    "eval": dict(train=False),
    "train_no_mosaic": dict(mosaic=False, mixup=False),
    # mosaic on at epoch 0, phased out at epoch 1 (1 >= 2 * 0.5)
    "mosaic_phase": dict(mosaic_prob=1.0, mixup=False, epoch_length=2, special_aug_ratio=0.5),
    "mosaic_mixup": dict(mosaic_prob=0.7, mixup=True, mixup_prob=0.6),
    "mosaic_mixup_cached": dict(mosaic_prob=0.7, mixup=True, mixup_prob=0.6, cache_images=True),
}


@pytest.mark.parametrize("case", sorted(DATASET_CASES))
def test_dataset_matches_jax(lines, case):
    """Every index, 3 seeds x 2 epochs: the same keys, dtypes, shapes, bits."""
    kw = {**dict(input_shape=(64, 64), num_classes=2, max_boxes=6, epoch_length=10),
          **DATASET_CASES[case]}
    for seed in SEEDS:
        j = jds.DetectionDataset(lines, seed=seed, **kw)
        t = tds.DetectionDataset(lines, seed=seed, **kw)
        for epoch in (0, 1):
            j.epoch_now = t.epoch_now = epoch
            for i in range(len(lines) + 1):  # the last index wraps
                js, ts = j[i], t[i]
                assert_same(js, ts, f"{case} seed {seed} epoch {epoch} index {i}")
                assert ts["image"].dtype == np.float32 and ts["labels"].dtype == np.int32
                assert ts["num_boxes"].dtype == np.int32 and ts["boxes"].shape == (6, 4)
        if kw.get("cache_images"):
            assert len(t._image_cache) == len(lines)
    with pytest.raises(ValueError):
        tds.DetectionDataset([])


def test_collate_matches_jax(lines):
    ds = tds.DetectionDataset(lines, input_shape=(64, 64), max_boxes=6)
    ds.epoch_now = 0
    samples = [ds[i] for i in range(3)]
    assert_same(tds.collate(samples), jds.collate(samples))


# ---------------------------------------------------------------- loader
def _loaders(lines, **kw):
    dkw = dict(input_shape=(64, 64), num_classes=2, max_boxes=6, epoch_length=4, mixup=True)
    return (jld.DataLoader(jds.DetectionDataset(lines * 2, **dkw), **kw),
            tld.DataLoader(tds.DetectionDataset(lines * 2, **dkw), **kw))


def test_loader_batches_match_jax(lines):
    kw = dict(batch_size=3, shuffle=True, num_workers=2, seed=5)
    jl, tl = _loaders(lines, **kw)
    for epoch in (0, 1):
        jl.set_epoch(epoch)
        tl.set_epoch(epoch)
        jb, tb = list(jl), list(tl)
        assert len(tb) == len(jb) == len(tl) == 5
        for a, b in zip(jb, tb):
            assert_same(a, b, f"threads epoch {epoch}")
    assert tdata.DataLoader is tld.DataLoader and tld.DataLoader is not torch.utils.data.DataLoader


# The process pool forks. A forked worker deadlocks in the native library's
# first OpenMP region when the forking thread has run one before (libgomp
# keeps its thread pool's state across fork), which this test process has
# (mixup's blend above); both packages' loaders share that limit. So the
# process-pool loaders are held against each other, and against the
# threaded one, in a fresh interpreter.
_PROCESS_POOL_CHECK = """
import json, sys
import numpy as np
from transparent_object_detection_tpu.data import dataset as jds, loader as jld
from transparent_object_detection_tpu_torch.data import dataset as tds, loader as tld
lines = json.loads(sys.argv[1])
dkw = dict(input_shape=(64, 64), num_classes=2, max_boxes=6, epoch_length=4, mixup=True)
kw = dict(batch_size=3, shuffle=True, num_workers=2, seed=5)
jp = jld.DataLoader(jds.DetectionDataset(lines * 2, **dkw), use_processes=True, **kw)
tp = tld.DataLoader(tds.DetectionDataset(lines * 2, **dkw), use_processes=True, **kw)
n = 0
for epoch in (0, 1):
    jp.set_epoch(epoch)
    tp.set_epoch(epoch)
    jb, tb = list(jp), list(tp)
    assert len(jb) == len(tb) == 5
    tt = tld.DataLoader(tds.DetectionDataset(lines * 2, **dkw), **kw)
    tt.set_epoch(epoch)
    for a, b, c in zip(jb, tb, list(tt)):
        for k in a:
            assert a[k].dtype == b[k].dtype == c[k].dtype and a[k].shape == b[k].shape
            np.testing.assert_array_equal(a[k], b[k])
            np.testing.assert_array_equal(b[k], c[k])
            n += 1
print("compared", n)
"""


def test_process_pool_loader_matches_jax(lines):
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.pathsep.join([REPO] + os.environ.get("PYTHONPATH", "").split(
               os.pathsep))}
    res = subprocess.run([sys.executable, "-c", _PROCESS_POOL_CHECK, json.dumps(lines)],
                         cwd=REPO, env=env, capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.split() == ["compared", "40"]


@pytest.mark.parametrize("drop_last", [True, False])
def test_loader_shards_match_jax(lines, drop_last):
    for num_shards in (1, 3, 4):
        for shard in range(num_shards):
            kw = dict(batch_size=2, shuffle=True, num_workers=1, seed=11, shard_id=shard,
                      num_shards=num_shards, drop_last=drop_last)
            jl, tl = _loaders(lines, **kw)
            for epoch in (0, 3):
                jl.set_epoch(epoch)
                tl.set_epoch(epoch)
                np.testing.assert_array_equal(tl._epoch_indices(), jl._epoch_indices())
                assert len(tl) == len(jl)
            jb, tb = list(jl), list(tl)
            assert len(tb) == len(jb)
            for a, b in zip(jb, tb):
                assert_same(a, b, f"shard {shard}/{num_shards}")


# ---------------------------------------------------------------- device_prefetch
def _batches(n):
    rng = np.random.default_rng(9)
    return [{"image": rng.uniform(size=(2, 8, 8, 3)).astype(np.float32),
             "boxes": rng.uniform(size=(2, 4, 4)).astype(np.float32),
             "labels": rng.integers(0, 3, (2, 4)).astype(np.int32),
             "num_boxes": np.array([1, 4], np.int32)} for _ in range(n)]


def test_device_prefetch_yields_the_batches():
    want = _batches(5)
    got = list(tld.device_prefetch(iter(want), size=2, device="cpu"))
    assert len(got) == 5
    for w, g in zip(want, got):
        assert g.keys() == w.keys()
        for k in w:
            assert isinstance(g[k], torch.Tensor) and g[k].device.type == "cpu"
            assert g[k].numpy().dtype == w[k].dtype
            np.testing.assert_array_equal(g[k].numpy(), w[k])


def test_device_prefetch_relays_producer_errors(lines):
    def failing():
        yield _batches(1)[0]
        raise FileNotFoundError("missing.jpg")

    it = tld.device_prefetch(failing(), device="cpu")
    next(it)
    with pytest.raises(FileNotFoundError, match="missing.jpg"):
        next(it)
    # a missing image in the annotations fails the epoch loudly
    bad = tld.DataLoader(tds.DetectionDataset(["/nope.jpg 1,1,9,9,0"] + lines[:1],
                                              input_shape=(64, 64), train=False),
                         batch_size=2, shuffle=False, num_workers=1)
    with pytest.raises(FileNotFoundError):
        list(tld.device_prefetch(iter(bad), device="cpu"))


def test_device_prefetch_stops_its_producer_on_early_exit():
    started = threading.active_count()
    it = tld.device_prefetch(iter(_batches(50)), size=1, device="cpu")
    next(it)
    it.close()
    for t in threading.enumerate():
        if t.name != threading.current_thread().name and t.daemon:
            t.join(timeout=5)
    assert threading.active_count() <= started


def test_device_prefetch_needs_a_device_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(tld.device_prefetch(iter(_batches(1))))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        next(tld.device_prefetch(iter(_batches(1)), device="cuda"))
