"""Threaded / multi-process batch loader with device prefetch: the port's own
copy of transparent_object_detection_tpu/data/loader.py's `DataLoader` (the
same batches for the same seed and epoch; not torch's DataLoader) and a
PyTorch `device_prefetch`.

A thread pool assembles batches ahead of consumption; cv2/numpy release the
GIL in the hot paths, making threads the default concurrency primitive — no
pickling, shared memory for free. The GIL-bound sections (python-level box
math, mosaic bookkeeping) cap the threaded loader near one core's rate, so
`use_processes=True` adds a process pool for multi-core hosts: workers
are forked from a fresh interpreter (the `forkserver` start method, this
module preloaded there, so that a pool after the first starts in
milliseconds), receive the dataset (including the decoded-image cache)
pickled once through the pool's initializer, assemble WHOLE batches
in-process, and ship them back with the image payload re-packed as uint8
(exact: pixel values are k/255) to quarter the IPC bytes. The JAX package's
loader forks its workers from the calling process instead; a worker forked
from a thread that has run one of the native library's OpenMP regions waits
forever in its own first region (libgomp's pool state survives the fork),
which the fork server, having run none, never hands on. The fork server
imports the main script, whose entry point must therefore sit under `if
__name__ == "__main__":`.

`device_prefetch` copies each batch to the device ahead of the step that
reads it: pinned host memory and `non_blocking` copies on a side CUDA
stream, `size` batches deep.

Shuffling is seeded per epoch (the DistributedSampler.set_epoch analog);
pass shard_id/num_shards to give each host its slice of the files. For
data-parallel training on one set of files, row_shard/row_shards give each
rank its rows of every global batch: the same shuffled indices and samples
(keyed on seed, epoch and index) as one process loading the whole batch.
"""
from __future__ import annotations

import multiprocessing
import queue
import threading
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from transparent_object_detection_tpu_torch.data.dataset import DetectionDataset, collate
from transparent_object_detection_tpu_torch.models.detector import resolve_device

# The dataset of a process-pool worker, set once in each worker by
# `_init_worker` (the pool's initializer); never set in the parent.
_WORKER_DATASET: Optional[DetectionDataset] = None


def _init_worker(dataset: DetectionDataset) -> None:
    global _WORKER_DATASET
    _WORKER_DATASET = dataset


def _process_batch(batch_idx) -> Dict[str, np.ndarray]:
    """Worker-side: fetch + collate one whole batch; image shipped as uint8
    (values are exact multiples of 1/255, so the round trip is lossless)."""
    ds = _WORKER_DATASET
    batch = collate([ds[int(i)] for i in batch_idx])
    batch["image"] = np.round(batch["image"] * 255.0).astype(np.uint8)
    return batch


def _unpack_batch(batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    batch["image"] = np.multiply(
        batch["image"], np.float32(1.0 / 255.0), dtype=np.float32
    )
    return batch


class DataLoader:
    def __init__(
        self,
        dataset: DetectionDataset,
        batch_size: int,
        shuffle: bool = True,
        num_workers: int = 4,
        drop_last: bool = True,
        seed: int = 11,
        shard_id: int = 0,
        num_shards: int = 1,
        use_processes: bool = False,
        row_shard: int = 0,
        row_shards: int = 1,
    ):
        if batch_size % row_shards:
            raise ValueError(f"global batch {batch_size} not divisible by {row_shards} row shards")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.seed = seed
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.use_processes = use_processes
        self.row_shard, self.row_shards = row_shard, row_shards
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        self.dataset.epoch_now = epoch

    def __len__(self) -> int:
        n = len(self.dataset) // self.num_shards
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _epoch_indices(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(idx)
        # contiguous per-host shard (even split, truncating the remainder)
        per = len(idx) // self.num_shards
        return idx[self.shard_id * per : (self.shard_id + 1) * per]

    def _batch_indices(self, indices: np.ndarray, bi: int) -> np.ndarray:
        """This loader's rows of global batch `bi`."""
        batch = indices[bi * self.batch_size : (bi + 1) * self.batch_size]
        per = len(batch) // self.row_shards
        return batch[self.row_shard * per : (self.row_shard + 1) * per]

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        if self.use_processes:
            yield from self._iter_processes()
            return
        indices = self._epoch_indices()
        nb = len(self)
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            # pipeline batches: submit all sample fetches lazily per batch,
            # keep a small window of in-flight batches
            window = 2
            futures = []

            def submit(bi):
                batch_idx = self._batch_indices(indices, bi)
                return [pool.submit(self.dataset.__getitem__, int(i)) for i in batch_idx]

            for bi in range(min(window, nb)):
                futures.append(submit(bi))
            for bi in range(nb):
                samples = [f.result() for f in futures[0]]
                futures.pop(0)
                nxt = bi + window
                if nxt < nb:
                    futures.append(submit(nxt))
                yield collate(samples)

    def _iter_processes(self) -> Iterator[Dict[str, np.ndarray]]:
        """Process pool forked from the fork server (a fresh interpreter):
        one task per BATCH (amortizes IPC), 2x workers of batches in
        flight. The pool is created per epoch and each worker is handed the
        dataset as it stands (epoch_now: the mosaic phase-out state) by its
        initializer.
        Same batches as the threaded path for a given (seed, epoch): the
        per-sample RNG is keyed on (seed, epoch, index), not on worker
        identity."""
        indices = self._epoch_indices()
        nb = len(self)
        ctx = multiprocessing.get_context("forkserver")
        ctx.set_forkserver_preload([__name__])  # read when the server starts
        with ProcessPoolExecutor(max_workers=self.num_workers, mp_context=ctx,
                                 initializer=_init_worker, initargs=(self.dataset,)) as pool:
            window = max(2, 2 * self.num_workers)
            futures = []

            def submit(bi):
                batch_idx = self._batch_indices(indices, bi)
                return pool.submit(_process_batch, list(map(int, batch_idx)))

            for bi in range(min(window, nb)):
                futures.append(submit(bi))
            for bi in range(nb):
                batch = futures.pop(0).result()
                nxt = bi + window
                if nxt < nb:
                    futures.append(submit(nxt))
                yield _unpack_batch(batch)


def device_prefetch(iterator, size: int = 2, device=None):
    """Wrap a host batch iterator (dicts of numpy arrays) so that each batch
    is on `device` (CUDA unless the caller names another; without a card
    and without a device this raises) before the consumer asks for it, with
    its dtypes kept.

    On CUDA a producer thread (which sets the device itself) copies each
    array into pinned host memory and from there with a `non_blocking` copy
    on a side stream, and records an event after the batch's copies; the
    consumer's current stream waits on that event before the batch is
    yielded, and every tensor is marked as used by that stream
    (`record_stream`), so the caching allocator never hands a batch's
    memory back while a step still reads it. At most `size` batches wait in
    the queue. On the CPU the arrays are wrapped without a copy. An
    exception of the producer (a missing image, an augmentation bug) is
    raised in the consumer, never a silently short epoch.
    """
    device = resolve_device(device)
    cuda = device.type == "cuda"
    if cuda and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    side = torch.cuda.Stream(device) if cuda else None
    q: "queue.Queue" = queue.Queue(maxsize=size)
    sentinel = object()
    stop = threading.Event()  # set when the consumer leaves early

    def put(item) -> None:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def produce():
        try:
            if cuda:
                torch.cuda.set_device(device)
            for batch in iterator:
                if stop.is_set():
                    break
                if cuda:
                    with torch.cuda.stream(side):
                        out = {k: torch.from_numpy(np.asarray(v)).pin_memory()
                               .to(device, non_blocking=True) for k, v in batch.items()}
                        ready = torch.cuda.Event()
                        ready.record(side)
                else:
                    out = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
                    ready = None
                put((out, ready))
        except BaseException as exc:  # noqa: BLE001 - relayed, not swallowed
            put(exc)
        finally:
            put(sentinel)

    t = threading.Thread(target=produce, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                break
            if isinstance(item, BaseException):
                raise item
            batch, ready = item
            if ready is not None:
                stream = torch.cuda.current_stream(device)
                stream.wait_event(ready)
                for tensor in batch.values():
                    tensor.record_stream(stream)
            yield batch
    finally:
        stop.set()
