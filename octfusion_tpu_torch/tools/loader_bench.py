"""The training data path's host pace on a ShapeNet-format set, beside
the lr train step it feeds.

Writes ``SHAPES`` seeded lumpy spheres in the reference's per-shape
ShapeNet layout (``utils/shapes.write_shapenet_set``, ``POINTS`` surface
points and SDF samples each, as the reference's files hold) into a
temporary directory, reads them through ``--config`` (default
``configs/octfusion_snet_uncond.yaml``; its ``data`` section read as
``shapenet`` at its batch size) and prints, each on a line of its own:

* ``samples``: one sample after another on this thread, the wall and
  CPU seconds of ``ShapeNetDataset.__getitem__`` (npz reads and point
  draws) and of ``fits_capacity`` (the capacity filter's node and edge
  counts);
* ``loader``: the ``DataLoader`` alone (``data.num_workers`` threads,
  no step), the wall and process CPU seconds per batch over ``RUN``
  batches after the first ``loader.PREFETCH``;
* ``ab``: ``train.train_loop`` on one lr solver for ``RUN`` steps
  over batches loaded beforehand, over the ``DataLoader``, and over the
  preloaded batches again: the median ms/step after the first, the mean
  ``data_s`` and the process CPU seconds per step.

A loader whose batch alone takes longer than a preloaded step cannot
keep up; one that keeps up alone but slows the step beside it contends
with the step's thread for the host (its cores or the interpreter lock).
Ends with one JSON line of every number.

    python -m octfusion_tpu_torch.tools.loader_bench

Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import os
import statistics
import tempfile
import time

import torch

from ..config import load_config
from ..data import loader
from ..data.dataset import CapacityFilteredDataset, fits_capacity, get_dataset
from ..models.union_solver import UnionSolver
from ..train import train_loop
from ..utils.device import resolve_device
from ..utils.shapes import write_shapenet_set

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SHAPES = 8
POINTS = 100000    # surface points and SDF samples per shape file
RUN = 12           # batches, and steps a run: 3x the loader's prefetch


def _clocks():
    return time.perf_counter(), time.process_time()


def sample_seconds(ds, spec, edge_factor) -> dict:
    """Per sample on this thread: wall and CPU seconds of the read and of
    the capacity check (means; the check's wall maximum)."""
    t = {"load_s": [], "load_cpu_s": [], "check_s": [], "check_cpu_s": []}
    for i in range(len(ds)):
        w0, c0 = time.perf_counter(), time.thread_time()
        item = ds[i]
        w1, c1 = time.perf_counter(), time.thread_time()
        if not fits_capacity(item["points"], spec, edge_factor):
            raise SystemExit(f"sample {i} exceeds the capacities")
        w2, c2 = time.perf_counter(), time.thread_time()
        for k, v in zip(t, (w1 - w0, c1 - c0, w2 - w1, c2 - c1)):
            t[k].append(v)
    out = {k: statistics.mean(v) for k, v in t.items()}
    out["check_max_s"] = max(t["check_s"])
    return out


def loader_seconds(dl, n_batches) -> dict:
    """The loader alone: wall and process CPU seconds per batch over
    ``n_batches`` batches after the first ``loader.PREFETCH``."""
    it = iter(dl)
    try:
        for _ in range(loader.PREFETCH):
            next(it)
        w0, c0 = _clocks()
        for _ in range(n_batches):
            next(it)
        w1, c1 = _clocks()
    finally:
        it.close()
    return {"batch_s": (w1 - w0) / n_batches,
            "batch_cpu_s": (c1 - c0) / n_batches}


def ab(step, dl, n_steps, seed, dev) -> list:
    """``train_loop`` over preloaded batches, the loader, preloaded again
    -> per run {"source", "ms_per_step", "data_s", "cpu_s_per_step"}."""
    it = iter(dl)
    batches = [next(it) for _ in range(loader.PREFETCH)]
    it.close()
    gen = torch.Generator(device=dev).manual_seed(seed)
    runs = []
    for source in ("preloaded", "loader", "preloaded"):
        src = iter(dl) if source == "loader" else itertools.cycle(batches)
        c0 = time.process_time()
        try:
            stats = train_loop(step, src, n_steps, generator=gen, device=dev)
        finally:
            if source == "loader":
                src.close()
        cpu = time.process_time() - c0
        runs.append({
            "source": source,
            "ms_per_step": statistics.median(stats["step_s"][1:]) * 1e3,
            "data_s": statistics.mean(stats["data_s"][1:]),
            "cpu_s_per_step": cpu / n_steps})
    return runs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default=os.path.join(
        REPO, "configs", "octfusion_snet_uncond.yaml"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = load_config(args.config)
    m = cfg.model
    spec = cfg.capacity.octree_spec(m.depth, m.full_depth)
    res = {"config": args.config, "shapes": SHAPES, "points": POINTS,
           "batch_size": cfg.data.batch_size,
           "num_workers": cfg.data.num_workers, "device": str(dev)}
    with tempfile.TemporaryDirectory() as root:
        location, filelist = write_shapenet_set(
            root, SHAPES, POINTS, cfg.data.point_scale, args.seed)
        cfg = dataclasses.replace(cfg, data=dataclasses.replace(
            cfg.data, name="shapenet", location=location, filelist=filelist))
        ds = get_dataset(cfg.data)
        res["samples"] = sample_seconds(ds, spec, cfg.capacity.edge_factor)
        print(f"samples: {res['samples']}", flush=True)
        dl = loader.DataLoader(
            CapacityFilteredDataset(ds, spec,
                                    edge_factor=cfg.capacity.edge_factor),
            cfg.data.batch_size, True, cfg.train.seed, cfg.data.num_workers)
        res["loader"] = loader_seconds(dl, RUN)
        print(f"loader: {res['loader']}", flush=True)
        torch.manual_seed(args.seed)
        step = UnionSolver(cfg, stage_flag="lr", device=dev).make_train_step()
        res["ab"] = ab(step, dl, RUN, args.seed, dev)
        print(f"ab: {res['ab']}", flush=True)
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
