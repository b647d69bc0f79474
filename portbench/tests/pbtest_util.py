"""Helpers of the benchmark's own tests (run with
``python -m pytest portbench/tests``): a temporary checkout root that holds
``BENCHMARK.json`` and the benchmark's data files, with the cells pointed
at tiny configurations, so a whole run fits the CPU."""

import json
import os
import shutil

import pytest
import torch

PB = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(PB)
TINY = {"snet-uncond": "tiny-2s", "obja-3t-d10": "tiny-3t"}


def make_root(tmp: str, bench_edit=None) -> str:
    """A checkout root under ``tmp``: the repository's BENCHMARK.json
    (edited by ``bench_edit`` if given) with every configuration swapped
    for its tiny stand-in, and copies of the data directories."""
    os.makedirs(os.path.join(tmp, "portbench", "configs"))
    for d in ("traffic", "limits", "metrics", "end_to_end"):
        shutil.copytree(os.path.join(PB, d), os.path.join(tmp, "portbench", d))
    for name in TINY.values():
        shutil.copy(os.path.join(PB, "tests", "data", name + ".json"),
                    os.path.join(tmp, "portbench", "configs", name + ".json"))
    with open(os.path.join(REPO, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    bench["configs"] = [{"name": n, "source": "tests/data",
                         "file": f"portbench/configs/{n}.json",
                         "reduced": [], "why": "CPU test"}
                        for n in TINY.values()]
    for w in bench["workloads"]:
        w["config"] = TINY[w["config"]]
    if bench_edit is not None:
        bench_edit(bench)
    with open(os.path.join(tmp, "BENCHMARK.json"), "w") as fh:
        json.dump(bench, fh)
    return tmp


@pytest.fixture
def root(tmp_path):
    return make_root(str(tmp_path))


@pytest.fixture(autouse=True)
def few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def run_tiny(root: str, workload: str, seed: int = 987654321987,
             seconds: float = 0.0):
    """One CPU run of ``workload`` under ``root``: every window item is
    checked (``check_range`` = 1 item, the first)."""
    import time

    from portbench import run as pr

    cell = pr.Cell(root, workload)
    cell.traffic = dict(cell.traffic, check_range=1, trace_items=1)
    lines = []
    return pr.run_cell(cell, seed, seconds, False, torch.device("cpu"),
                       log=lines.append, t_start=time.perf_counter())
