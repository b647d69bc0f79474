"""The program's own spans (``octfusion_tpu_torch/utils/trace.py``) in a
traced run: the gather backward split by the gather that made it, the
sampler's per-step host and device time, and the solver's build time.

:func:`read` takes the profiler's events (:func:`portbench.trace.events_of`)
and two snapshots of the program's recorder, one taken at the end of
set-up and one after the unprofiled items, and returns keys for the traced
run's summary:

* ``index_bwd_by_span_s``: device seconds under autograd's backward of
  indexing (``evaluate_function: Index*Backward*``, as ``reduce`` counts
  ``index_bwd_s``) by the ``octf.gather.*`` span its forward operation
  lay under, matched by sequence number and forward thread as ``reduce``
  matches a graph conv's backward; ``other`` for a forward under none;
* ``denoise_step``: the denoising steps (``octf.sampler.step``) of the
  graph stages (``octf.sample.hr`` / ``octf.sample.feature``): ``host_ms``,
  the recorder's mean host milliseconds a step over the unprofiled items;
  ``host_ms_profiled``, the same from the profiled items' trace;
  ``device_ms``, the mean over profiled steps of the union of the
  intervals of the device operations launched under a step; ``count``
  and ``count_profiled``;
* ``step_split_ms``: for each sampling stage (``octf.sample.<stage>``)
  whose steps the recorder holds from the unprofiled items, the mean host
  milliseconds a step (``octf.sampler.step``), of its U-Net call within
  it (``octf.sampler.denoise``) and of the rest, the update arithmetic
  between U-Net calls (``update``: step - denoise);
* ``solver_build_s`` and ``kernels_build_s``: the recorder's host seconds
  in ``octf.setup.solver`` (the solver's modules built) and in
  ``octf.setup.kernels`` (the CUDA libraries built and loaded) during
  set-up.

:data:`METRICS` reads the per-layer metrics from a summary extended so.
The benchmark's run does not enable the program's tracing yet, so these
metrics are measured by this module's command, which runs a cell's traced
run as ``run.py --trace 1`` does, with the program's tracing on (it relies
on ``run_cell``'s order: set-up, the unprofiled items, ``modules()``, the
profiled items, ``reduce``, and checks that order as it goes):

    python3 -m portbench.program_spans --workload <cell> --seed <n> \\
        --seconds <s>

``--cost N`` instead measures what the tracing costs: after set-up it runs
N pairs of unprofiled items, one with the tracing off and one with it on,
in turns, and prints their walls.
"""

from __future__ import annotations

import argparse
import bisect
import copy
import json
import statistics
import sys
import time
import types
from typing import Dict, List, Optional

from .frozen import idle
from .trace import INDEX_BWD, NODE

GATHERS = ("octf.gather.norm", "octf.gather.embed", "octf.gather.move",
           "octf.gather.mpu")
STEP = "octf.sampler.step"
DENOISE = "octf.sampler.denoise"
GRAPH_STAGES = ("octf.sample.hr", "octf.sample.feature")


def _index_bwd_by_span(evs, cpu, index, lo, hi) -> Dict[str, float]:
    fwd = {}          # (thread, seq) of a forward operation -> its span
    for e in evs:
        if e.device or e.seq < 0 or e.name.startswith(NODE):
            continue
        si = index.get(e.thread)
        k = si.key(si.innermost(e.start)) if si else None
        if k is not None and k[0] in GATHERS:
            fwd[(e.thread, e.seq)] = k[0]
    out = dict.fromkeys(GATHERS + ("other",), 0.0)
    for e in evs:
        if not e.device or not (e.end > lo and e.start < hi):
            continue
        origin = cpu.get(e.linked)
        si = index.get(origin[0]) if origin else None
        k = si.key(si.innermost(origin[1])) if si else None
        if k is None or not k[0].startswith(NODE) or \
                not INDEX_BWD.search(k[0]):
            continue
        out[fwd.get((k[2], k[1]), "other")] += (e.end - e.start) * 1e-9
    return out


def _steps(evs, cpu, spans, lo, hi) -> Dict:
    """Host and device time of the profiled graph stages' steps."""
    stages = [(th, a, b) for th, a, b, k in spans if k[0] in GRAPH_STAGES]
    steps = sorted((th, a, b) for th, a, b, k in spans
                   if k[0] == STEP and lo <= a < hi
                   and any(t == th and s <= a < e for t, s, e in stages))
    if not steps:
        return {}
    starts = [(th, a) for th, a, _ in steps]
    launched: List[list] = [[] for _ in steps]
    for e in evs:
        if not e.device:
            continue
        origin = cpu.get(e.linked)
        if origin is None:
            continue
        i = bisect.bisect_right(starts, origin) - 1
        if i >= 0 and steps[i][0] == origin[0] and \
                origin[1] < steps[i][2]:
            launched[i].append((e.start, e.end))
    return {"count_profiled": len(steps),
            "host_ms_profiled": 1e-6 * statistics.fmean(
                b - a for _, a, b in steps),
            "device_ms": 1e-6 * statistics.fmean(
                idle.union_length(iv) for iv in launched)}


def _step_split(window: Optional[Dict]) -> Dict[str, Dict[str, float]]:
    """Mean host ms a step, of its U-Net call and of the update between
    calls, by sampling stage, from the recorder's spans by stage."""
    out = {}
    for stage, names in (window or {}).get("by_stage", {}).items():
        step, denoise = names.get(STEP), names.get(DENOISE)
        if not stage.startswith("octf.sample.") or not step or not denoise:
            continue
        n = step["count"]
        out[stage[len("octf.sample."):]] = {
            "step": 1e3 * step["host_s"] / n,
            "denoise": 1e3 * denoise["host_s"] / n,
            "update": 1e3 * (step["host_s"] - denoise["host_s"]) / n}
    return out


def read(evs, setup: Optional[Dict], window: Optional[Dict]) -> Dict:
    """Summary keys from the profiled items' events and the recorder's
    snapshots at the end of set-up and after the unprofiled items (None
    where the program records no spans)."""
    out: Dict = {}
    for key, name in (("solver_build_s", "octf.setup.solver"),
                      ("kernels_build_s", "octf.setup.kernels")):
        if setup and name in setup["spans"]:
            out[key] = setup["spans"][name]["host_s"]
    split = _step_split(window)
    if split:
        out["step_split_ms"] = split
    cpu, spans = {}, []
    for e in evs:
        if e.device:
            continue
        cpu[e.corr] = (e.thread, e.start)
        if e.user or e.name.startswith(NODE):
            spans.append((e.thread, e.start, e.end,
                          (e.name, e.seq, e.fwd_thread)))
    items = [(a, b) for _, a, b, k in spans if k[0] == "pb.item"]
    if not items:
        return out
    lo, hi = min(a for a, _ in items), max(b for _, b in items)
    index = idle.by_thread(spans)
    if any(k[0] in GATHERS for _, _, _, k in spans):
        out["index_bwd_by_span_s"] = _index_bwd_by_span(evs, cpu, index,
                                                        lo, hi)
    steps = _steps(evs, cpu, spans, lo, hi)
    recorded = [window["by_stage"].get(s, {}).get(STEP) for s in
                GRAPH_STAGES] if window else []
    recorded = [r for r in recorded if r]
    if recorded:
        count = sum(r["count"] for r in recorded)
        steps.update(count=count, host_ms=1e3 * sum(
            r["host_s"] for r in recorded) / count)
    if steps:
        out["denoise_step"] = steps
    return out


def _gather_share(kind: str):
    def share(t):
        by = t.get("index_bwd_by_span_s")
        if t["kind"] != "train" or not by or t["device_s"] <= 0.0:
            return None
        return 100.0 * by[f"octf.gather.{kind}"] / t["device_s"]
    return share


def _step(key: str):
    def ms(t):
        v = t.get("denoise_step", {}).get(key)
        return v if t["kind"] == "gen" else None
    return ms


# name -> (unit, reader of the extended summary), as BENCHMARK.json would
# declare them
METRICS = {
    "gather_bwd_norm_share.train": ("%", _gather_share("norm")),
    "gather_bwd_embed_share.train": ("%", _gather_share("embed")),
    "gather_bwd_move_share.train": ("%", _gather_share("move")),
    "denoise_step_host_ms.gen": ("ms/step", _step("host_ms")),
    "denoise_step_device_ms.gen": ("ms/step", _step("device_ms")),
    "solver_build_s": ("s", lambda t: t.get("solver_build_s")),
}


def traced_run(cell, seed: int, seconds: float, device, log=print,
               t_start: Optional[float] = None) -> Dict:
    """``run.run_cell``'s traced run of ``cell`` with the program's tracing
    on from before set-up, the summary extended by :func:`read` as
    ``reduce`` returns it: the result, its ``metrics`` joined by
    :data:`METRICS`, and ``program``, what :func:`read` found with the
    recorder's spans of the unprofiled items."""
    from octfusion_tpu_torch.utils import trace as octf

    from . import run, trace as pb_trace

    snaps: Dict[str, Dict] = {}
    window_items = [0]
    gen = cell.generator()

    class Traffic(gen.Traffic):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            snaps["setup"] = octf.snapshot()
            octf.reset()

        def item(self, *a, **k):
            if "setup" in snaps:      # set-up's own items come before
                window_items[0] += 1
            return super().item(*a, **k)

        def modules(self):
            # run_cell asks for the modules once, right after the
            # unprofiled items and before the profiled ones
            assert window_items[0] > 0 and "window" not in snaps, \
                "modules() asked for out of run_cell's order"
            snaps["window"] = octf.snapshot()
            octf.reset()
            return super().modules()

    span_cell = copy.copy(cell)
    span_cell.generator = lambda: types.SimpleNamespace(KIND=gen.KIND,
                                                        Traffic=Traffic)
    summaries: List[Dict] = []
    reduce = pb_trace.reduce

    def reduce_with_spans(evs, *a, **k):
        assert "window" in snaps, "reduce before the window's snapshot"
        summary = reduce(evs, *a, **k)
        summary.update(read(evs, snaps.get("setup"), snaps.get("window")))
        summaries.append(summary)
        return summary

    octf.reset()
    octf.enable()
    pb_trace.reduce = reduce_with_spans
    try:
        result = run.run_cell(span_cell, seed, seconds, True, device,
                              log=log, t_start=t_start or run.T_START)
    finally:
        pb_trace.reduce = reduce
        octf.disable()
    summary = summaries[0]
    for name, (unit, reader) in METRICS.items():
        value = reader(summary)
        if value is not None:
            result["metrics"][name] = {"value": value, "unit": unit}
    result["program"] = {
        k: summary[k] for k in ("index_bwd_by_span_s", "denoise_step",
                                "step_split_ms", "solver_build_s",
                                "kernels_build_s") if k in summary}
    result["program"]["window_spans"] = snaps.get("window")
    return result


def cost(cell, seed: int, pairs: int, device, log=print) -> Dict:
    """What the program's tracing costs: the walls of ``pairs`` pairs of
    unprofiled items after set-up, one item with the tracing off and one
    with it on, the order alternating pair by pair; the spans an item
    records; and one span's enter and exit in microseconds, off and on
    (no profiler), over 20000 of them."""
    from octfusion_tpu_torch.utils import trace as octf

    drv = cell.generator().Traffic(cell.config_file, cell.traffic, seed,
                                   device, check_range=0)
    walls: Dict[str, List[float]] = {"off": [], "on": []}
    octf.reset()
    for i in range(pairs):
        for flag in (("off", "on") if i % 2 == 0 else ("on", "off")):
            (octf.enable if flag == "on" else octf.disable)()
            ts = time.perf_counter()
            drv.item(2 * i + (flag == "on"))
            walls[flag].append(time.perf_counter() - ts)
            octf.disable()
    spans = octf.snapshot()["spans"]
    per_span = {}
    for flag in ("off", "on"):
        (octf.enable if flag == "on" else octf.disable)()
        ts = time.perf_counter()
        for _ in range(20000):
            with octf.span("octf.cost.probe"):
                pass
        per_span[flag] = (time.perf_counter() - ts) / 20000 * 1e6
        octf.disable()
    octf.reset()
    med = {k: statistics.median(v) for k, v in walls.items()}
    n = sum(v["count"] for v in spans.values()) / pairs
    log("[program_spans] cost " + json.dumps(walls))
    return {"walls": walls, "median_s": med,
            "on_over_off_pct": 100.0 * (med["on"] / med["off"] - 1.0),
            "spans_per_item": n, "span_us": per_span,
            "recorder_pct": 100.0 * n * (per_span["on"] - per_span["off"])
            * 1e-6 / med["off"]}


def main(argv=None) -> int:
    from . import run

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--cost", type=int, default=0,
                    help="pairs of items with the tracing off and on")
    args = ap.parse_args(argv)
    cell = run.Cell(run.ROOT, args.workload)
    run.cache_dirs(run.ROOT)
    import torch

    if not torch.cuda.is_available():
        print("program_spans: no CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    device = torch.device("cuda", 0)
    info = {"kind": torch.cuda.get_device_name(device),
            "power_limit": run.power_limit()}
    if args.cost:
        out = cost(cell, args.seed, args.cost, device)
    else:
        out = traced_run(cell, args.seed, args.seconds, device)
    out["device"] = dict(out.get("device", {}), **info)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
