"""Run a function on several ranks of one host, each in a fresh process
joined to one process group: the in-process counterpart of ``torchrun``
for tests and checks.

    results = spawn(fn, 2, args=(path,), backend="gloo", device="cpu",
                    timeout=300)

Rank r runs ``fn(r, *args)`` (``fn`` must be importable by name) with
``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` / ``MASTER_ADDR`` /
``MASTER_PORT`` set and the group joined through
``dist.maybe_initialize``; its return value (tensors, numbers and plain
containers) comes back through a ``torch.save`` file.  Nothing waits
without bound: when a rank fails or the ``timeout`` (seconds, for the
whole run) passes, every rank still running is killed and ``spawn``
raises with each failed rank's traceback."""

from __future__ import annotations

import os
import socket
import tempfile
import time
import traceback

import torch
import torch.multiprocessing as mp


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _entry(fn, rank, world, port, backend, device, args, out, err):
    from . import dist

    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    try:
        dist.maybe_initialize(device, backend)
        torch.save(fn(rank, *args), out)
    except BaseException:
        with open(err, "w") as fh:
            fh.write(traceback.format_exc())
        raise
    finally:
        dist.shutdown()


def spawn(fn, nprocs: int, args=(), backend: str = "gloo",
          device: str = "cpu", timeout: float = 600.0) -> list:
    """-> [rank 0's result, rank 1's, ...]."""
    ctx = mp.get_context("spawn")
    port = free_port()
    with tempfile.TemporaryDirectory() as tmp:
        outs = [os.path.join(tmp, f"rank{r}.pt") for r in range(nprocs)]
        errs = [os.path.join(tmp, f"rank{r}.err") for r in range(nprocs)]
        procs = [ctx.Process(target=_entry, daemon=True, args=(
            fn, r, nprocs, port, backend, device, tuple(args), outs[r],
            errs[r])) for r in range(nprocs)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        failed = None
        while any(p.exitcode is None for p in procs):
            bad = [r for r, p in enumerate(procs) if p.exitcode not in
                   (None, 0)]
            if bad:
                failed = f"rank {bad[0]} exited with {procs[bad[0]].exitcode}"
                break
            if time.monotonic() > deadline:
                failed = f"ranks did not finish within {timeout:g} s"
                break
            time.sleep(0.05)
        if failed is None:
            bad = [r for r, p in enumerate(procs) if p.exitcode != 0]
            if bad:
                failed = f"rank {bad[0]} exited with {procs[bad[0]].exitcode}"
        if failed is not None:
            for p in procs:
                if p.exitcode is None:
                    p.kill()
            for p in procs:
                p.join(10)
            logs = "".join(f"\n--- rank {r} ---\n" + open(e).read()
                           for r, e in enumerate(errs) if os.path.exists(e))
            raise RuntimeError(f"spawn: {failed}{logs}")
        return [torch.load(o, weights_only=False) for o in outs]
