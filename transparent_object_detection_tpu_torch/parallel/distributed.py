"""Process-group bring-up (counterpart of
transparent_object_detection_tpu/parallel/distributed.py).

One process per rank, as torchrun starts them: RANK, WORLD_SIZE, LOCAL_RANK
and MASTER_ADDR / MASTER_PORT in the environment. `initialize_multihost`
turns that into `torch.distributed.init_process_group`, the counterpart of
`jax.distributed.initialize`; a single process is a no-op, so one entry
point serves both.

The backend is the caller's, or NCCL when the ranks run on CUDA (each rank
on its own card, `LOCAL_RANK`) and gloo on the CPU. Ranks that share one
card cannot use NCCL; gloo, which also reduces CUDA tensors, serves them,
and only an explicit `backend="gloo"` selects it.
"""
from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

# How long a collective waits for the other ranks before it raises: a rank
# that fails leaves the others in a collective, and this ends their wait.
DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None, backend: Optional[str] = None,
                         device=None, timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> bool:
    """Join the process group when running as one of several processes.

    Returns False, and does nothing, in a single process with no
    coordinator named. coordinator_address is host:port, or a URL
    torch.distributed takes as its init method (file://path: a rendezvous
    file of this group alone). The arguments default to torchrun's
    environment: coordinator_address to MASTER_ADDR:MASTER_PORT, num_processes to
    WORLD_SIZE, process_id to RANK. `device`: CUDA unless the caller names
    another (without a card this raises unless device="cpu"); on CUDA each
    rank selects card LOCAL_RANK before anything is made on it (with an
    explicit gloo backend, LOCAL_RANK modulo the cards, so ranks may share
    one). A coordinator with num_processes=1 makes a world of one rank. In a
    process that has joined already, returns True and does nothing."""
    if dist.is_available() and dist.is_initialized():
        return True
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if num_processes <= 1 and coordinator_address is None:
        return False
    if process_id is None:
        process_id = int(os.environ.get("RANK", "0"))
    if coordinator_address is None:
        coordinator_address = (f"{os.environ.get('MASTER_ADDR', 'localhost')}:"
                               f"{os.environ['MASTER_PORT']}")
    from transparent_object_detection_tpu_torch.models.detector import resolve_device

    device = resolve_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if device.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", process_id))
        cards = torch.cuda.device_count()
        if backend == "nccl" and local >= cards:
            raise RuntimeError(
                f"LOCAL_RANK {local} has no card of its own ({cards} visible): NCCL needs one "
                "card a rank; ranks that share a card need backend='gloo'")
        torch.cuda.set_device(local % cards)
    init = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=init, world_size=num_processes,
                            rank=process_id, timeout=timeout)
    return True


def shutdown_multihost() -> None:
    """Leave the process group, if this process joined one."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def process_index() -> int:
    """This process's rank; 0 without a process group."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def process_count() -> int:
    """The number of ranks; 1 without a process group."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
