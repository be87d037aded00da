"""The port's process-group bring-up (parallel/distributed.py) and its rank
launcher (parallel/launch.py), the counterparts of tests/test_distributed.py:
two real processes on gloo, an all-reduce, the loader's file shards
disjoint and covering, each rank's rows of the same global batches; the
single-process no-op; the refusal of NCCL for ranks that share a card; and
the launcher stopping every rank, with the failing rank's error, when one
rank raises or a collective outlives its timeout."""
from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from transparent_object_detection_tpu_torch.data.loader import DataLoader
from transparent_object_detection_tpu_torch.parallel import distributed
from transparent_object_detection_tpu_torch.parallel.launch import RankFailure, run_ranks

torch.set_num_threads(1)

TESTS = os.path.dirname(__file__)
OPTS = dict(device="cpu", threads=1, paths=[TESTS])
N_ITEMS = 12


@pytest.fixture(scope="module")
def ranks():
    return run_ranks("_torch_ranks:collectives", 2, {"n_items": N_ITEMS}, timeout=120, **OPTS)


def test_two_process_bootstrap_and_all_reduce(ranks):
    assert [r["rank"] for r in ranks] == [0, 1]
    assert all(r["world"] == 2 for r in ranks)
    assert all(r["total"] == 32.0 for r in ranks)  # ones(4, 4) summed over 2 ranks


def test_loader_file_shards_disjoint_and_covering(ranks):
    seen0, seen1 = (set(r["files"]) for r in ranks)
    assert seen0.isdisjoint(seen1)
    assert seen0 | seen1 == set(range(N_ITEMS))


def test_loader_row_shards_split_each_global_batch(ranks):
    """Each rank assembles its rows of the same global batches (shuffled
    with the same seed and epoch) that one process would load whole."""

    class _Stub:
        epoch_now = 0

        def __len__(self):
            return N_ITEMS

        def __getitem__(self, i):
            return {"index": np.asarray(i)}

    whole = DataLoader(_Stub(), batch_size=4, shuffle=True, num_workers=1, seed=3)
    whole.set_epoch(1)
    batches = [b["index"].tolist() for b in whole]
    assert len(batches) == 3
    for b, (r0, r1) in enumerate(zip(ranks[0]["rows"], ranks[1]["rows"])):
        assert r0 + r1 == batches[b]
    with pytest.raises(ValueError, match="not divisible"):
        DataLoader(_Stub(), batch_size=5, row_shards=2)


def test_single_process_is_a_no_op(monkeypatch):
    for name in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    assert distributed.initialize_multihost(device="cpu") is False
    assert distributed.process_index() == 0 and distributed.process_count() == 1


def test_nccl_refuses_ranks_that_share_a_card(monkeypatch):
    """Two ranks on one card cannot use NCCL; the code says so and never
    swaps in gloo by itself."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setenv("LOCAL_RANK", "1")

    def refuse(*args, **kwargs):
        raise AssertionError("init_process_group reached")

    monkeypatch.setattr(distributed.dist, "init_process_group", refuse)
    with pytest.raises(RuntimeError, match="backend='gloo'"):
        distributed.initialize_multihost("127.0.0.1:1", num_processes=2, process_id=1)


def test_launcher_stops_every_rank_when_one_fails():
    with pytest.raises(RankFailure, match="planted failure on rank 1"):
        run_ranks("_torch_ranks:one_rank_fails", 2, timeout=60, **OPTS)


def test_launcher_timeout_ends_a_hung_collective():
    with pytest.raises(RankFailure, match="still running after 10"):
        run_ranks("_torch_ranks:hangs", 2, timeout=10, **OPTS)
