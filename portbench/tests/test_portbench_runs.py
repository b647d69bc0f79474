"""Whole runs of every cell at tiny sizes on the CPU: the reference agrees
with the port, each fault a cell can have turns ``correct`` false, and a
new configuration, traffic mix or metric is found by its name alone."""

import json
import os

import pytest
import torch

from pbtest_util import few_threads, make_root, root, run_tiny  # noqa: F401

CELLS = ["snet-gen-dpmpp25", "obja3t-gen-dpmpp25", "snet-train-hr",
         "obja3t-train-feature"]


@pytest.mark.parametrize("workload", CELLS)
def test_reference_agrees_with_the_port(root, workload):
    res = run_tiny(root, workload)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    names = set(res["metrics"])
    assert "setup_s" in names and "peak_mem_gib" in names
    assert names & {"gen_s_per_shape", "train_shapes_per_s"}
    assert list(res)[-1] == "checks"


@pytest.fixture
def denoiser_returns_input():
    """A fault: the program's U-Net call of one step returns its input."""
    from octfusion_tpu_torch.nn.unet_union import UNetUnion

    calls = []

    def hook(module, args, output):
        calls.append(1)
        return args[1].clone() if len(calls) % 5 == 3 else output

    h = torch.nn.modules.module.register_module_forward_hook(
        lambda m, a, o: hook(m, a, o) if isinstance(m, UNetUnion) else None)
    yield
    h.remove()


@pytest.fixture
def sdf_altered(monkeypatch):
    """A fault: one value of the SDF grid altered where it is made."""
    from octfusion_tpu_torch.utils import sdf as sdf_utils

    orig = sdf_utils.calc_sdf

    def calc(*a, **k):
        out = orig(*a, **k)
        out.view(-1)[out.numel() // 2] += out.abs().max() + 1.0
        return out

    monkeypatch.setattr(sdf_utils, "calc_sdf", calc)


@pytest.fixture
def state_unchanged(monkeypatch):
    """A fault: the train step returns the model's state unchanged (no
    optimizer update; schedule, EMA and count go on)."""
    from octfusion_tpu_torch.diffusion import ema as ema_lib
    from octfusion_tpu_torch.models import union_solver

    def apply_gradients(self):
        self.scheduler.step()
        ema_lib.ema_update(self.ema,
                           dict(self.solver.df.named_parameters()),
                           self.ema_rate)
        self.step += 1

    monkeypatch.setattr(union_solver.TrainStep, "apply_gradients",
                        apply_gradients)


@pytest.fixture
def window_state_unchanged(monkeypatch, request):
    """A fault: past set-up's checked steps, the train step returns the
    model's state unchanged."""
    from octfusion_tpu_torch.models import union_solver
    from portbench import run as pr

    cell = pr.Cell(request.getfixturevalue("root"),
                   request.node.callspec.params["workload"])
    n = cell.traffic["checked_steps"]
    orig = union_solver.TrainStep.apply_gradients

    def apply_gradients(self):
        if self.step < n:
            return orig(self)
        self.optimizer.zero_grad(set_to_none=True)
        self.step += 1

    monkeypatch.setattr(union_solver.TrainStep, "apply_gradients",
                        apply_gradients)


@pytest.fixture
def half_batch(monkeypatch):
    """A fault: half of the batch left out, the loss's mean taken over
    the rest."""
    from octfusion_tpu_torch.diffusion import sampler

    orig = sampler.diffusion_loss

    def loss(fn, x0, batch_id, batch_size, *a, mask=None, **k):
        keep = batch_id < max(batch_size // 2, 1)
        return orig(fn, x0, batch_id, batch_size, *a,
                    mask=keep if mask is None else mask & keep, **k)

    monkeypatch.setattr(sampler, "diffusion_loss", loss)


@pytest.mark.parametrize("workload,fault", [
    ("snet-gen-dpmpp25", "denoiser_returns_input"),
    ("snet-gen-dpmpp25", "sdf_altered"),
    ("obja3t-gen-dpmpp25", "denoiser_returns_input"),
    ("obja3t-gen-dpmpp25", "sdf_altered"),
    ("snet-train-hr", "state_unchanged"),
    ("snet-train-hr", "window_state_unchanged"),
    ("snet-train-hr", "half_batch"),
    ("obja3t-train-feature", "state_unchanged"),
    ("obja3t-train-feature", "window_state_unchanged"),
    ("obja3t-train-feature", "half_batch"),
])
def test_a_fault_turns_correct_false(root, workload, fault, request):
    request.getfixturevalue(fault)
    res = run_tiny(root, workload)
    assert not res["correct"], res["checks"]


def test_new_files_are_found_by_name(tmp_path):
    """A configuration, a traffic mix and a per-layer metric added as new
    files plus new BENCHMARK.json entries, with no edit to the harness."""
    from portbench import run as pr

    def edit(bench):
        bench["configs"].append({"name": "tiny-new", "source": "test",
                                 "file": "portbench/configs/tiny-new.json",
                                 "reduced": [], "why": "test"})
        bench["workloads"].append({"name": "tiny-new-gen", "config":
                                   "tiny-new", "traffic": "gen-new",
                                   "chips": 1, "why": "test"})
        bench["per_layer"].append({
            "name": "items_seen.gen", "unit": "items", "better": "higher",
            "source": "device_trace", "layer": "solver",
            "moves": "gen_s_per_shape", "workloads": ["tiny-new-gen"]})

    root = make_root(str(tmp_path), edit)
    pb = os.path.join(root, "portbench")
    with open(os.path.join(pb, "configs", "tiny-2s.json")) as fh:
        cfg = json.load(fh)
    cfg["config"]["model"]["resblk_num"] = 2
    with open(os.path.join(pb, "configs", "tiny-new.json"), "w") as fh:
        json.dump(cfg, fh)
    with open(os.path.join(pb, "traffic", "gen-dpmpp25.json")) as fh:
        mix = json.load(fh)
    with open(os.path.join(pb, "traffic", "gen-new.json"), "w") as fh:
        json.dump(dict(mix, steps=3), fh)
    with open(os.path.join(pb, "limits", "tiny-new-gen.json"), "w") as fh:
        json.dump({"hr_gap": 1e-3}, fh)
    with open(os.path.join(pb, "metrics", "items_seen.gen.py"), "w") as fh:
        fh.write("def read(t):\n    return float(t['items'])\n")

    res = run_tiny(root, "tiny-new-gen")
    assert res["correct"], res["checks"]
    assert set(res["checks"]) == {"hr_gap"}
    cell = pr.Cell(root, "tiny-new-gen")
    assert cell.traffic["steps"] == 3
    assert cell.config_file["config"]["model"]["resblk_num"] == 2
    got = pr.collect(cell, "metrics", cell.per_layer,
                     {"kind": "gen", "items": 4, "laps": [], "shapes": 4,
                      "launches": 8, "window_s": 0.0, "busy_s": 0.0,
                      "conv_device_s": 0.0, "model_flops": 0.0})
    # the cell's only per-layer metric: the others list their cells
    assert got == {"items_seen.gen": {"value": 4.0, "unit": "items"}}
