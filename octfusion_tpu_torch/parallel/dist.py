"""Process groups for data parallelism over ``torch.distributed`` (port of
``octfusion_tpu/parallel/dist.py``): one process per GPU, launched by
``torchrun``, as the reference (``options/base_options.py:106-116``).

A process joins a group only when its environment asks for one, so a
single-process run never touches ``torch.distributed``:

* ``torchrun`` sets ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` /
  ``MASTER_ADDR`` / ``MASTER_PORT`` (``init_method="env://"``);
* the JAX package's opt-in is read as well: ``OCTFUSION_COORDINATOR=
  host:port``, ``OCTFUSION_NUM_PROCESSES=N``, ``OCTFUSION_PROCESS_ID=i``
  (``LOCAL_RANK`` defaults to ``i``), or ``OCTFUSION_COORDINATOR=auto``
  with ``torchrun``'s variables.

The backend is NCCL for a process on a GPU and gloo on the CPU, and
gloo too where the host runs more ranks than it has cards
(``LOCAL_WORLD_SIZE`` or the local rank beyond ``device_count``): gloo
also reduces CUDA tensors, which is how several ranks share one card
(NCCL refuses two ranks on one GPU), and there :func:`local_device` gives
local rank r the card ``r % device_count``.  ``backend=`` chooses another.
A failing join raises: nothing carries on as a single process."""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as tdist

TIMEOUT_S = 900     # seconds a collective may wait before it raises

_local_rank = 0


def requested() -> Optional[tuple]:
    """(init_method, world, rank, local rank) that the environment asks
    for, or None."""
    addr = os.environ.get("OCTFUSION_COORDINATOR")
    if addr and addr != "auto":
        rank = int(os.environ["OCTFUSION_PROCESS_ID"])
        return (f"tcp://{addr}", int(os.environ["OCTFUSION_NUM_PROCESSES"]),
                rank, int(os.environ.get("LOCAL_RANK", rank)))
    if addr == "auto" or "WORLD_SIZE" in os.environ:
        missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                               "MASTER_PORT") if k not in os.environ]
        if missing:
            raise RuntimeError(f"a process group needs {missing} in the "
                               "environment (set by torchrun)")
        return ("env://", int(os.environ["WORLD_SIZE"]),
                int(os.environ["RANK"]), int(os.environ.get("LOCAL_RANK", 0)))
    return None


def maybe_initialize(device="cuda", backend: Optional[str] = None) -> bool:
    """Join the process group the environment asks for; ``device`` is the
    kind of device the process computes on (it picks the default
    backend).  Returns True when this call joined it (the caller then
    calls :func:`shutdown`), False when there is none to join or it was
    joined before."""
    global _local_rank
    if tdist.is_initialized():
        return False
    req = requested()
    if req is None:
        return False
    init_method, world, rank_, local = req
    dev = torch.device(device)
    _local_rank = local
    backend = backend or default_backend(dev)
    if dev.type == "cuda" and backend == "nccl":
        torch.cuda.set_device(local_device(dev, backend))
    tdist.init_process_group(
        backend, init_method=init_method, world_size=world, rank=rank_,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return True


def default_backend(device) -> str:
    """NCCL for a process on a card of its own, gloo on the CPU or where
    this host's ranks outnumber its cards."""
    if torch.device(device).type != "cuda":
        return "gloo"
    local_world = max(int(os.environ.get("LOCAL_WORLD_SIZE", 1)),
                      _local_rank + 1)
    return "gloo" if local_world > torch.cuda.device_count() else "nccl"


def local_device(device, backend: Optional[str] = None) -> torch.device:
    """This process's device: ``"cuda"`` (no index) in a process group is
    ``cuda:$LOCAL_RANK``; under gloo, ranks beyond the visible cards share
    them (``LOCAL_RANK % device_count``), under NCCL that raises.  Any
    other device is returned as given."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None or not (
            tdist.is_initialized() or backend is not None):
        return dev
    backend = backend or tdist.get_backend()
    count = torch.cuda.device_count()
    if _local_rank >= count:
        if backend != "gloo":
            raise RuntimeError(
                f"local rank {_local_rank} has no card of its own ({count} "
                f"visible) under {backend}; only gloo shares a card")
        return torch.device("cuda", _local_rank % count)
    return torch.device("cuda", _local_rank)


def rank() -> int:
    return tdist.get_rank() if tdist.is_initialized() else 0


def world_size() -> int:
    return tdist.get_world_size() if tdist.is_initialized() else 1


def is_main() -> bool:
    return rank() == 0


def barrier() -> None:
    """Wait for every rank (nothing to wait for in one process)."""
    if tdist.is_initialized():
        tdist.barrier()


def shutdown() -> None:
    if tdist.is_initialized():
        tdist.destroy_process_group()


def announce(device) -> None:
    """Print this rank's place in the process group and its device (one
    line per rank)."""
    if tdist.is_initialized():
        print(f"[*] rank {rank()} of {world_size()} ({tdist.get_backend()})"
              f" on {device}", flush=True)


def broadcast_modules(*modules, src: int = 0) -> None:
    """Every parameter and buffer of ``modules`` from rank ``src`` to all
    ranks, in place (the JAX package replicates its state with ``P()``)."""
    if world_size() == 1:
        return
    with torch.no_grad():
        for mod in modules:
            for t in list(mod.parameters()) + list(mod.buffers()):
                tdist.broadcast(t.data, src)
