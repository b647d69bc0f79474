"""Whole runs of the conditional generation cell and the VAE training cell
at tiny sizes on the CPU: the reference agrees with the port, each fault
such a cell can have turns ``correct`` false, and a timed item reads the
program's lr-middle span and label counter."""

import pytest
import torch

from pbtest_util import few_threads, root, run_tiny  # noqa: F401
from test_portbench_runs import denoiser_returns_input  # noqa: F401

CELLS = ["snetcond-gen-b5", "snet-train-vae"]


@pytest.mark.parametrize("workload", CELLS)
def test_reference_agrees_with_the_port(root, workload):  # noqa: F811
    res = run_tiny(root, workload)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    names = set(res["metrics"])
    assert {"setup_s", "peak_mem_gib"} <= names
    assert names & {"gen_s_per_shape", "train_shapes_per_s"}


@pytest.fixture
def labels_rolled(monkeypatch):
    """A fault: the program is given each shape's label rolled by one."""
    from octfusion_tpu_torch.models.union_solver import UnionSolver

    orig = UnionSolver.sample

    def sample(self, *a, label=None, **k):
        return orig(self, *a, label=label.roll(1), **k)

    monkeypatch.setattr(UnionSolver, "sample", sample)


@pytest.fixture
def vae_state_unchanged(monkeypatch):
    """A fault: the VAE step leaves the parameters unchanged (schedule
    and count go on)."""
    from octfusion_tpu_torch.models.vae_solver import VAETrainStep

    def apply_gradients(self):
        self.scheduler.step()
        self.step += 1

    monkeypatch.setattr(VAETrainStep, "apply_gradients", apply_gradients)


@pytest.fixture
def vae_half_batch(monkeypatch):
    """A fault: the SDF regression over the first half of the batch's
    shapes alone."""
    from octfusion_tpu_torch.models.vae_solver import VAESolver

    orig = VAESolver.loss_fn

    def loss_fn(self, batch, *a, **k):
        keep = max(batch["pos"].shape[0] // 2, 1)
        batch = dict(batch, **{n: batch[n][:keep]
                               for n in ("pos", "sdf", "grad")})
        return orig(self, batch, *a, **k)

    monkeypatch.setattr(VAESolver, "loss_fn", loss_fn)


@pytest.mark.parametrize("workload,fault", [
    ("snetcond-gen-b5", "labels_rolled"),
    ("snetcond-gen-b5", "denoiser_returns_input"),
    ("snet-train-vae", "vae_state_unchanged"),
    ("snet-train-vae", "vae_half_batch"),
])
def test_a_fault_turns_correct_false(root, workload, fault,  # noqa: F811
                                     request):
    request.getfixturevalue(fault)
    res = run_tiny(root, workload)
    assert not res["correct"], res["checks"]


def test_timed_item_reads_the_program(root):  # noqa: F811
    """A timed, unprofiled item returns the lr middle's host seconds, one
    span an hr step, and the label rows embedded: B a U-Net embedding, an
    lr step embeds once and an hr step twice (hr U-Net and lr middle).
    The program's tracing is off again afterwards."""
    from octfusion_tpu_torch.utils import trace as octf
    from portbench import run as pr

    cell = pr.Cell(root, "snetcond-gen-b5")
    traffic = dict(cell.traffic, warmup=0)
    drv = cell.generator().Traffic(cell.config_file, traffic, 3,
                                   torch.device("cpu"), check_range=0)
    laps = drv.item(0, timed=True)
    steps, b = traffic["steps"], traffic["batch_size"]
    assert laps["lr_middle_calls"] == steps
    assert laps["label_embeds"] == 3 * steps * b
    assert 0 < laps["lr_middle_host_s"] < laps["hr"]
    read = cell.reader("metrics", "lr_middle_host_ms.gen").read
    assert read({"kind": "gen", "laps": [laps, {"hr": 1.0}]}) == \
        pytest.approx(1e3 * laps["lr_middle_host_s"] / steps)
    assert read({"kind": "gen", "laps": [{"hr": 1.0}]}) is None
    assert octf.span("x") is octf.span("y")
    assert "lr_middle_calls" not in drv.item(1)


def test_control_readings_are_judged_by_the_cells_limits(root):  # noqa: F811
    """``control_cells`` judges each reading by the cell's limits as
    ``run.py`` does.  On the CPU, where TF32 changes nothing, the control
    reads as a sound run and is ``correct``; the half-batch fault is not."""
    from portbench import control_cells as cc
    from portbench import run as pr

    cell = pr.Cell(root, "snet-train-vae")
    got = {what: cc.judged(cell.limits, numbers) for _, what, numbers in
           cc.readings(cell, [3], ["half_batch"], torch.device("cpu"))}
    assert set(got) == {"control", "half_batch"}
    assert set(got["half_batch"][0]) == set(cell.limits)
    assert got["control"][1] and not got["half_batch"][1]
    assert cc.judged(cell.limits, {}) == (
        {k: {"value": float("inf"), "limit": v}
         for k, v in cell.limits.items()}, False)
