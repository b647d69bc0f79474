"""portbench: the benchmark of ``octfusion_tpu_torch`` on NVIDIA GPUs.

One command runs one cell once:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

(or ``python3 -m portbench.run ...``) from the root of a checkout.  The
cell (``workloads`` of ``BENCHMARK.json``) names a configuration
(``configs`` -> its file) and a traffic mix
(``portbench/traffic/<mix>.json``, whose ``generator`` names
``portbench/generators/<generator>.py``).  Set-up builds the program's
solver, loads weights drawn from the seed on the device, makes the inputs
and warms up; then the window drives the generator's items back to back
for ``--seconds`` (``--trace 0``), or runs ``trace_items`` of them
unprofiled, for their walls and stage laps, then profiles as many more
under the instruments (``--trace 1``).  Afterwards the program's state is
freed and the plain reference (``portbench/reference/``) judges what the
window produced against the limits of ``portbench/limits/<cell>.json``.

End-to-end metrics are read by ``portbench/end_to_end/<name>.py``, per-layer
metrics by ``portbench/metrics/<name>.py``, each found by its name in
``BENCHMARK.json``; a reader that finds nothing returns None and the metric
is left out.  The last line of standard output is one JSON object.

Without a CUDA device, or with fewer than the cell asks for, the run exits
with code 2 and prints no result; if ``jax``, ``jaxlib``, ``flax`` or
``octfusion_tpu`` is loaded once the window has closed, with code 3.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "octfusion_tpu")
PEAK_FLOPS = {"float32": 495e12, "bfloat16": 989e12}


def forbidden_modules():
    """Top-level names of loaded modules that the port must not load,
    compared whole (``octfusion_tpu_torch`` is not ``octfusion_tpu``)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def cache_dirs(root: str) -> None:
    """Fixed build and kernel cache directories inside the checkout, so
    that only a cell's first run there builds or compiles."""
    base = os.path.join(root, ".portbench_cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(base, sub)


def _load_file(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json(path: str):
    with open(path) as fh:
        return json.load(fh)


class Cell:
    """A cell of ``BENCHMARK.json`` under ``root``, with its configuration
    file, traffic mix, limits and metric declarations, all found by
    name."""

    def __init__(self, root: str, workload: str):
        self.root = root
        bench = _json(os.path.join(root, "BENCHMARK.json"))
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise SystemExit(f"portbench: no workload {workload!r} in "
                             f"BENCHMARK.json (have {sorted(cells)})")
        self.entry = cells[workload]
        configs = {c["name"]: c for c in bench["configs"]}
        self.config_file = _json(os.path.join(
            root, configs[self.entry["config"]]["file"]))
        pb = os.path.join(root, "portbench")
        self.traffic = _json(os.path.join(
            pb, "traffic", self.entry["traffic"] + ".json"))
        self.limits = _json(os.path.join(pb, "limits", workload + ".json"))
        name = self.entry["name"]

        def mine(m):
            return "workloads" not in m or name in m["workloads"]

        self.end_to_end = [m for m in bench["end_to_end"] if mine(m)]
        self.per_layer = [m for m in bench["per_layer"] if mine(m)]

    def reader(self, kind: str, name: str):
        return _load_file(os.path.join(self.root, "portbench", kind,
                                       name + ".py"), f"pb_{kind}_{name}")

    def generator(self):
        return importlib.import_module(
            f"portbench.generators.{self.traffic['generator']}")


def power_limit() -> str:
    """The card's power limit as ``nvidia-smi`` reads it, or ``unknown``."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.SubprocessError):
        return "unknown"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else "unknown"


def collect(cell: Cell, kind: str, declared, data) -> dict:
    """name -> {value, unit} of each declared metric whose reader
    (``portbench/<kind>/<name>.py``) finds something in ``data``."""
    out = {}
    for m in declared:
        value = cell.reader(kind, m["name"]).read(data)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             log=print, t_start: float = T_START,
             device_info: dict = None) -> dict:
    """Set-up, window and check of one run -> the result object, its
    ``device`` entry ``device_info`` with the peak memory (and, traced,
    the busy and window seconds) added."""
    import torch

    drv_mod = cell.generator()
    traffic = cell.traffic
    check_range = traffic["trace_items"] if trace else traffic["check_range"]
    drv = drv_mod.Traffic(cell.config_file, traffic, seed, device,
                         check_range=check_range)
    setup_s = time.perf_counter() - t_start
    run = {"kind": drv_mod.KIND, "setup_s": setup_s}
    times, laps = [], []
    summary = None
    if not trace:
        t0 = time.perf_counter()
        while True:
            ts = time.perf_counter()
            drv.item(len(times))
            te = time.perf_counter()
            times.append(te - ts)
            if te - t0 >= seconds and len(times) >= drv.min_items:
                break
        run["window_s"] = te - t0
    else:
        from torch.profiler import ProfilerActivity, profile

        from portbench import trace as trace_mod

        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        n = traffic["trace_items"]
        # n items unprofiled, with their stage laps: their walls and laps
        # are what the instruments and the profiler would stretch
        for i in range(n):
            ts = time.perf_counter()
            laps.append(drv.item(i, timed=True))
            times.append(time.perf_counter() - ts)
        plain_s = sum(times)
        ins = trace_mod.Instruments(drv.modules(), drv.stage_spans(),
                                    backward=drv_mod.KIND == "train")
        t0 = time.perf_counter()
        with profile(activities=acts) as prof:
            for i in range(n, 2 * n):
                ts = time.perf_counter()
                with torch.autograd.profiler.record_function("pb.item"):
                    drv.item(i, timed=True)
                times.append(time.perf_counter() - ts)
        ins.close()
        run["window_s"] = time.perf_counter() - t0 + plain_s
        dtype = cell.config_file["config"].get("diffusion", {}).get(
            "compute_dtype", "float32")
        summary = trace_mod.reduce(trace_mod.events_of(prof), ins.convs,
                                   ins.model_flops, laps, drv.per_item,
                                   PEAK_FLOPS[dtype])
        summary.update(kind=drv_mod.KIND, plain_s=plain_s, plain_items=n)
        del prof
    run["items"] = len(times)
    run["shapes"] = len(times) * drv.per_item
    run["peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                         if device.type == "cuda" else 0)
    failed = drv.failed()
    med = statistics.median(times)
    log(f"[portbench] {drv_mod.KIND} items={len(times)} "
        f"per_item={drv.per_item} failed={failed} "
        f"item_s median={med:.6f} max={max(times):.6f} "
        f"window_s={run['window_s']:.6f} setup_s={setup_s:.6f}")
    log("[portbench] item_s " + " ".join(f"{t:.6f}" for t in times))
    if laps:
        log("[portbench] laps " + json.dumps(laps))

    metrics = (collect(cell, "metrics", cell.per_layer, summary) if trace
               else collect(cell, "end_to_end", cell.end_to_end, run))

    t_check = time.perf_counter()
    try:
        numbers = drv.check()
        error = None
    except Exception:                      # a judge that fails is a fail
        numbers, error = {}, traceback.format_exc()
        log(error)
    log(f"[portbench] check_s={time.perf_counter() - t_check:.3f}")
    checks = {}
    for name, limit in cell.limits.items():
        value = numbers.get(name, float("inf"))
        checks[name] = {"value": value, "limit": limit}
    correct = (error is None and bool(numbers)
               and all(c["value"] <= c["limit"] for c in checks.values()))
    result = {"correct": correct, "attempted": run["shapes"]
              if drv_mod.KIND == "gen" else run["items"],
              "failed": failed, "metrics": metrics}
    dev = dict(device_info or {}, memory_peak_bytes=int(run["peak_bytes"]))
    if summary is not None:
        result["breakdown"] = summary["breakdown"]
        dev.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
    result["device"] = dev
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = Cell(ROOT, args.workload)
    cache_dirs(ROOT)
    import torch

    chips = cell.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    # one host thread: the window's host work is one Python loop, and idle
    # intra-op threads spinning beside it made runs of one cell spread
    torch.set_num_threads(1)
    device = torch.device("cuda", 0)
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": chips, "power_limit": power_limit()}
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      device, device_info=info)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: forbidden modules loaded: {bad}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
