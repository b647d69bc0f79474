"""The control of a cell's correctness check, and the faults its limits
are held against, read on the chip at the cell's own size.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 \\
        [--faults half_batch]

For each seed it puts the plain reference in the program's place,
computed in the nearest precision below the configuration's fp32 with
TF32 off, that is with TF32 on (``torch.backends.cuda.matmul`` and
``cudnn``), drives it through the cell's own items (a generation cell:
item 0 of the window, recorded as the harness records the program; a
training cell: the checked steps) and judges it with the fp32
reference as a run is judged.  ``--faults half_batch`` (training cells)
also plants a fault in the fp32 reference put in the program's place:
the loss over the first half of the batch alone.  It prints one JSON line
per seed and reading; the limits in ``limits/<cell>.json`` lie between the
program's readings (the harness's own runs) and these.

The benchmark's runs never run this.  ``tests/test_portbench_parts.py``
runs it at a small size on a card.
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
from portbench.reference import judge  # noqa: E402
from portbench.reference.diffusion import sampler as ref_sampler  # noqa


@contextlib.contextmanager
def tf32(on: bool):
    """TF32 matmuls and convolutions on (or off) for the block."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


@contextlib.contextmanager
def half_batch():
    """The reference's loss over the first half of the batch alone: the
    mean taken over the rest."""
    orig = ref_sampler.diffusion_loss

    def loss(denoise_fn, x0, batch_id, batch_size, *a, mask=None, **k):
        keep = batch_id < max(batch_size // 2, 1)
        mask = keep if mask is None else mask & keep
        return orig(denoise_fn, x0, batch_id, batch_size, *a, mask=mask,
                    **k)

    ref_sampler.diffusion_loss = loss
    try:
        yield
    finally:
        ref_sampler.diffusion_loss = orig


def gen_reading(raw, traffic, seed, device, lower: bool):
    """Item 0 of a generation cell by the reference put in the program's
    place (TF32 on where ``lower``), judged."""
    cfg, solver = judge.reference_solver(raw, seed, device)
    noise = judge.item_noise(raw, traffic, seed, 0, device)
    with tf32(lower), torch.no_grad():
        rec = record.DenoiseRecorder(solver.df)
        out = solver.sample(batch_size=traffic["batch_size"],
                            steps=traffic["steps"],
                            compute_sdf=True, **noise)
        rec = {"index": 0, "calls": rec.close(),
               **record.sample_outputs(out, cfg.model.depth_out)}
    del solver, out
    return judge.judge_gen(raw, traffic, seed, [rec], device)


def train_reading(raw, traffic, scale, seed, device, lower: bool,
                  fault=None):
    """The checked steps of a training cell (batches of lumpy spheres
    scaled by ``scale``) by the reference put in the program's place (TF32
    on where ``lower``; ``fault`` planted), judged."""
    stage = traffic["stage"]
    cfg = inputs.build_config(raw)
    b = traffic["batch_size"]
    shape = inputs.train_target_shape(cfg, stage, b)
    with_eps = not (stage == "hr" and "feature" in cfg.diffusion.unet_type)
    n = traffic["checked_steps"]
    batches = [inputs.train_batch(b, cfg.data.points_per_shape, scale, seed,
                                  j, traffic["pool"]) for j in range(n)]
    draws = [inputs.train_draws(b, shape, with_eps, seed, j)
             for j in range(n)]
    _, solver = judge.reference_solver(raw, seed, device, stage)
    with tf32(lower), (fault() if fault else contextlib.nullcontext()):
        run = judge.run_train_steps(solver.make_train_step(), batches,
                                    draws, device)
    del solver
    return judge.judge_train(raw, stage, seed, run, batches, draws, device)


def readings(root, workload, seeds, faults, device):
    from portbench.run import Cell

    cell = Cell(root, workload)
    raw = cell.config_file["config"]
    traffic = cell.traffic
    scale = cell.config_file.get("inputs", {}).get("shape_scale", 1.0)
    gen = traffic["generator"] == "gen_cascade"
    if gen:
        raw = inputs.sampling_config(raw, traffic)
    for seed in seeds:
        if gen:
            yield seed, "control", gen_reading(raw, traffic, seed, device,
                                               True)
        else:
            yield seed, "control", train_reading(raw, traffic, scale, seed,
                                                 device, True)
            if "half_batch" in faults:
                yield seed, "half_batch", train_reading(
                    raw, traffic, scale, seed, device, False, half_batch)
        if device.type == "cuda":
            torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--faults", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    seeds = [int(s) for s in args.seeds.split(",")]
    for seed, what, numbers in readings(ROOT, args.workload, seeds,
                                        args.faults.split(","), device):
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "reading": what, "numbers": numbers}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
