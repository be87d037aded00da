"""The exact NMS kernel for Hopper (csrc/nms_exact.cu) against its plain
version (ops/nms.py::nms_exact_plain).

On the CPU, where the kernel cannot run, what is held here is:
  * the plain version against the full K-step greedy loop (JAX's
    `lax.fori_loop` over every row, written out in numpy), identical keep
    sets: K = 1,024 with every candidate valid and with none, suppression
    chains, tied and duplicated boxes, IoU exactly at the threshold, valid
    prefixes of different lengths at B = 32;
  * the kernel's design emulated word by word (pass 0's count of valid
    rows, pass 1's over-threshold bitmask of the rows before that count,
    pass 2's scan with removed and kept words) equal to the plain version
    on every case, and each planted fault of the design (a suppressed box
    allowed to suppress, `>=` for `>`, the last valid row skipped) giving
    another keep set on at least one case;
  * the wrapper: a CPU tensor runs the plain version through the operator
    focus::nms_exact without counting a launch; any other tensor is
    checked and refused before anything launches (K past 1,024, a wrong
    dtype or shape, a device other than CUDA).
Marked `cuda` (skipped without a card): the kernel against the plain
version on the card, on every case, twice for the same bits.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from transparent_object_detection_tpu_torch.ops import nms as tnms
from transparent_object_detection_tpu_torch.ops.geometry import pairwise_iou

torch.set_num_threads(1)

THRES = 0.4
K = 1024


def _iou_of(xy, wh):
    boxes = torch.from_numpy(np.concatenate([xy, xy + wh], axis=-1).astype(np.float32))
    return pairwise_iou(boxes, boxes)


def _case(name: str):
    """(iou (B, K, K) fp32, valid (B, K) bool) of one named case."""
    rng = np.random.default_rng(sum(map(ord, name)))
    b = 32 if name == "prefixes_b32" else 2
    valid = torch.ones(b, K, dtype=torch.bool)
    if name in ("all_valid", "none_valid", "prefixes_b32"):  # a crowded scene
        iou = _iou_of(rng.uniform(0, 300, (b, K, 2)), rng.uniform(10, 80, (b, K, 2)))
        if name == "none_valid":
            valid[:] = False
        if name == "prefixes_b32":
            counts = torch.from_numpy(rng.integers(0, K + 1, b))
            valid = torch.arange(K)[None, :] < counts[:, None]
    elif name == "chains":  # 12 px steps of 40 px boxes: IoU 0.54 with the last, 0.25 before
        start = rng.uniform(0, 2000, (b, K // 32, 1, 2))
        steps = np.arange(32)[None, None, :, None] * np.array([12.0, 0.0])
        iou = _iou_of((start + steps).reshape(b, K, 2), np.full((b, K, 2), 40.0))
    elif name == "ties":  # every box three times over, and equal IoUs between copies
        xy = np.repeat(rng.uniform(0, 400, (b, K // 3 + 1, 2)), 3, axis=1)[:, :K]
        iou = _iou_of(xy, np.full((b, K, 2), 30.0))
    elif name == "at_threshold":  # a third of the entries exactly at the fp32 threshold
        iou = torch.from_numpy(rng.uniform(0, 0.8, (b, K, K)).astype(np.float32))
        iou[torch.from_numpy(rng.uniform(size=(b, K, K)) < 1 / 3)] = float(np.float32(THRES))
        valid = torch.arange(K)[None, :] < torch.tensor([[K], [700]])
    return iou.contiguous(), valid


CASES = ("all_valid", "none_valid", "chains", "ties", "at_threshold", "prefixes_b32")
FAULTS = ("suppressed_box_suppresses", "ge_for_gt", "last_valid_row_skipped")


def _full_loop(iou: torch.Tensor, valid: torch.Tensor) -> np.ndarray:
    """JAX's `_exact_greedy_keep`: the greedy loop over all K rows."""
    over = iou.numpy() > np.float32(THRES)
    keep = np.ones(valid.shape, bool)
    v = valid.numpy()
    j = np.arange(K)
    for i in range(K):
        alive = keep[:, i] & v[:, i]
        keep &= ~(over[:, i, :] & (j > i)[None, :] & alive[:, None])
    return keep & v


def _words(bits: np.ndarray) -> np.ndarray:
    """(..., K) bools -> (..., K/32) uint32 words, element 32w + t at bit t."""
    packed = np.packbits(bits.reshape(*bits.shape[:-1], K // 32, 32), axis=-1, bitorder="little")
    return packed.view("<u4")[..., 0].astype(np.uint32)


def _kernel_emulation(iou: torch.Tensor, valid: torch.Tensor, fault: str = None) -> np.ndarray:
    """csrc/nms_exact.cu's three passes, a block an image, in 32-bit words;
    `fault` plants one mistake of FAULTS."""
    x, v = iou.numpy(), valid.numpy()
    keep = np.zeros(v.shape, bool)
    for b in range(v.shape[0]):
        count = int(v[b].sum())  # pass 0
        rows = x[b, :count]
        over = rows >= np.float32(THRES) if fault == "ge_for_gt" else rows > np.float32(THRES)
        masks = _words(over & (np.arange(K)[None, :] > np.arange(count)[:, None]))  # pass 1
        vbits = _words(v[b])
        removed = np.zeros(K // 32, np.uint32)
        kept = np.zeros(K // 32, np.uint32)
        for i in range(count - 1 if fault == "last_valid_row_skipped" else count):  # pass 2
            w, bit = i >> 5, np.uint32(1 << (i & 31))
            if not vbits[w] & bit:
                continue
            was_removed = bool(removed[w] & bit)
            if fault == "suppressed_box_suppresses" or not was_removed:
                removed |= masks[i]
            if not was_removed:
                kept[w] |= bit
        keep[b] = np.unpackbits(kept.astype("<u4").view(np.uint8), bitorder="little").astype(bool)
    return keep


@pytest.fixture(scope="module")
def cases():
    return {name: _case(name) for name in CASES}


@pytest.mark.parametrize("name", CASES)
def test_plain_matches_full_loop(cases, name):
    iou, valid = cases[name]
    keep = tnms.nms_exact_plain(iou, valid, THRES)
    np.testing.assert_array_equal(keep.numpy(), _full_loop(iou, valid))
    if name not in ("none_valid",):
        assert 0 < int(keep.sum()) < int(valid.sum())  # the case suppresses something


@pytest.mark.parametrize("name", CASES)
def test_kernel_design_matches_plain(cases, name):
    iou, valid = cases[name]
    np.testing.assert_array_equal(_kernel_emulation(iou, valid),
                                  tnms.nms_exact_plain(iou, valid, THRES).numpy())


@pytest.mark.parametrize("fault", FAULTS)
def test_planted_faults_change_the_keep_set(cases, fault):
    moved = [name for name, (iou, valid) in cases.items()
             if not np.array_equal(_kernel_emulation(iou, valid, fault),
                                   tnms.nms_exact_plain(iou, valid, THRES).numpy())]
    assert moved, f"{fault} leaves every case's keep set as it was"


def test_operator_runs_plain_on_cpu(cases):
    iou, valid = cases["chains"]
    tnms.reset_launch_counts()
    keep = torch.ops.focus.nms_exact(iou, valid, THRES)
    assert torch.equal(keep, tnms.nms_exact_plain(iou, valid, THRES))
    assert tnms._exact_greedy_keep(iou, valid, THRES).dtype == torch.bool
    assert tnms.nms_exact.launches == 0


@pytest.mark.parametrize("bad", ["k_past_1024", "fp16_iou", "ragged", "meta_device"])
def test_wrapper_refuses_before_launch(bad):
    k = 1025 if bad == "k_past_1024" else 64
    iou = torch.empty(2, k, k, device="meta",
                      dtype=torch.float16 if bad == "fp16_iou" else torch.float32)
    valid = torch.empty(2, k - (bad == "ragged"), dtype=torch.bool, device="meta")
    tnms.reset_launch_counts()
    with pytest.raises(ValueError):
        tnms.nms_exact(iou, valid, THRES)
    assert tnms.nms_exact.launches == 0


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: csrc/nms_exact.cu runs only there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CASES)
def test_kernel_matches_plain_on_card(card, cases, name):
    iou, valid = (t.to(card) for t in cases[name])
    tnms.reset_launch_counts()
    keep = tnms.nms_exact(iou, valid, THRES)
    again = tnms.nms_exact(iou, valid, THRES)
    torch.cuda.synchronize()
    assert tnms.nms_exact.launches == 2
    assert torch.equal(keep, again)
    assert torch.equal(keep.cpu(), tnms.nms_exact_plain(*cases[name], THRES))
