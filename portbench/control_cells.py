"""The control of the correctness check of the cells whose generators
``control.py`` does not know (``gen_cascade_cond``, ``train_vae``), read
on the chip at the cell's own size, as ``control.py`` reads the others:

    python3 portbench/control_cells.py --workload <cell> --seeds 1,2,3 \\
        [--faults half_batch]

For each seed the plain reference, in TF32 (the nearest precision below
the configuration's fp32), takes the program's place in the cell's own
items and is judged by the fp32 reference as a run is judged: a
conditional generation cell's item 0 with the mix's labels, a VAE cell's
checked steps.  ``--faults half_batch`` (VAE cells) also plants a fault in
the fp32 reference in the program's place: the SDF regression over the
first half of the batch's shapes alone.  One JSON line per seed and
reading, with the reading's ``checks`` and ``correct`` against the cell's
limits (``limits/<cell>.json``) as ``run.py`` compares them.  The exit code
is 1 where a reading is ``correct``: the limits do not catch it.

The benchmark's runs never run this.
"""

import argparse
import contextlib
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from portbench import inputs, record  # noqa: E402
from portbench.control import tf32  # noqa: E402
from portbench.generators import train_vae  # noqa: E402
from portbench.reference import judge, judge_cond, judge_vae  # noqa: E402
from portbench.reference.models import vae_solver as ref_vae  # noqa: E402


@contextlib.contextmanager
def half_batch():
    """The reference VAE's SDF samples of the first half of the batch's
    shapes alone."""
    orig = ref_vae.VAESolver.loss_fn

    def loss_fn(self, batch, eps=None):
        keep = max(batch["pos"].shape[0] // 2, 1)
        batch = dict(batch, **{k: batch[k][:keep]
                               for k in ("pos", "sdf", "grad")})
        return orig(self, batch, eps)

    ref_vae.VAESolver.loss_fn = loss_fn
    try:
        yield
    finally:
        ref_vae.VAESolver.loss_fn = orig


def cond_reading(raw, traffic, seed, device):
    """Item 0 of a conditional generation cell by the reference in TF32
    in the program's place, judged."""
    cfg, solver = judge.reference_solver(raw, seed, device)
    noise = judge.item_noise(raw, traffic, seed, 0, device)
    with tf32(True), torch.no_grad():
        rec = record.DenoiseRecorder(solver.df)
        out = solver.sample(batch_size=traffic["batch_size"],
                            label=judge_cond.labels_of(traffic, device),
                            steps=traffic["steps"], compute_sdf=True,
                            **noise)
        rec = {"index": 0, "calls": rec.close(),
               **record.sample_outputs(out, cfg.model.depth_out)}
    del solver, out
    return judge_cond.judge_gen(raw, traffic, seed, [rec], device)


def vae_reading(cfg_file, traffic, seed, device, lower: bool, fault=None):
    """The checked steps of a VAE cell by the reference in the program's
    place (TF32 on where ``lower``; ``fault`` planted), judged."""
    raw = cfg_file["config"]
    n = traffic["checked_steps"]
    _, solver = judge_vae.reference_vae(raw, seed, device)
    b = traffic["batch_size"]
    scale = cfg_file.get("inputs", {}).get("shape_scale", 1.0)
    batches = [train_vae.vae_batch(b, raw["data"]["points_per_shape"],
                                   traffic["sdf_samples"], scale, seed, j,
                                   traffic["pool"]) for j in range(n)]
    eps = [train_vae.vae_eps(solver.code_shape(b), seed, j)
           for j in range(n)]
    with tf32(lower), (fault() if fault else contextlib.nullcontext()):
        run = judge_vae.run_steps(solver.make_train_step(), batches, eps,
                                  device)
    del solver
    return judge_vae.judge_train(raw, seed, run, batches, eps, device)


def judged(limits, numbers):
    """``numbers`` against a cell's ``limits`` as ``run.py`` compares them:
    -> (checks, correct)."""
    checks = {name: {"value": numbers.get(name, float("inf")),
                     "limit": limit} for name, limit in limits.items()}
    correct = bool(numbers) and all(c["value"] <= c["limit"]
                                    for c in checks.values())
    return checks, correct


def readings(cell, seeds, faults, device):
    """-> (seed, reading, numbers) for each seed: the TF32 control, and
    the faults asked for."""
    traffic = cell.traffic
    kind = traffic["generator"]
    if kind not in ("gen_cascade_cond", "train_vae"):
        raise SystemExit(f"control_cells: {kind} is control.py's")
    for seed in seeds:
        if kind == "gen_cascade_cond":
            raw = inputs.sampling_config(cell.config_file["config"], traffic)
            yield seed, "control", cond_reading(raw, traffic, seed, device)
        else:
            yield seed, "control", vae_reading(cell.config_file, traffic,
                                               seed, device, True)
            if "half_batch" in faults:
                yield seed, "half_batch", vae_reading(
                    cell.config_file, traffic, seed, device, False,
                    half_batch)
        if device.type == "cuda":
            torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--faults", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control_cells: no CUDA device", file=sys.stderr)
        return 2
    from portbench.run import Cell

    device = torch.device("cuda", 0)
    cell = Cell(ROOT, args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    caught = True
    for seed, what, numbers in readings(cell, seeds, args.faults.split(","),
                                        device):
        checks, correct = judged(cell.limits, numbers)
        caught = caught and not correct
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "reading": what, "correct": correct,
                          "numbers": numbers, "checks": checks}), flush=True)
    if not caught:
        print("control_cells: a reading is correct under the cell's limits",
              file=sys.stderr)
    return 0 if caught else 1


if __name__ == "__main__":
    sys.exit(main())
