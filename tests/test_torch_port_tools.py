"""The port's diagnosis tools on the CPU at a tiny size:
``tools/lr_occupancy`` (the sampled split grids' occupancy beside the
dataset's, for each sampler, from an lr run's checkpoint) and
``tools/class_purity`` (each generated mesh's nearest reference class)."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from octfusion_tpu_torch import config as config_lib
from octfusion_tpu_torch.data.dataset import SyntheticDataset
from octfusion_tpu_torch.generate import shape_seed
from octfusion_tpu_torch.models.union_solver import UnionSolver
from octfusion_tpu_torch.tools import class_purity, lr_occupancy
from octfusion_tpu_torch.utils import ckpt as ckpt_lib
from octfusion_tpu_torch.utils import mesh as mesh_utils
from octfusion_tpu_torch.utils import params as params_lib

from test_torch_port_helpers import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_lr_occupancy_runs_on_the_cpu(tmp_path):
    """The ground truth's occupancy is the dataset's split grids', every
    sampler reports its count of samples, and a checkpoint's EMA lr U-Net
    (not its live one) is what samples: the ancestral occupancies are
    those of a solver holding the EMA, at the tool's seeds."""
    path = os.path.join(REPO, "configs", "synthetic_tiny.yaml")
    cfg = config_lib.load_config(path)
    torch.manual_seed(0)
    live = UnionSolver(cfg, "lr", device="cpu")
    torch.manual_seed(1)
    held = UnionSolver(cfg, "lr", device="cpu")
    ema = {f"unet_lr.{n}": p.detach()
           for n, p in held.df.unet_lr.named_parameters()}
    ckpt_lib.save(str(tmp_path / "run" / "ckpt"),
                  params_lib.union_checkpoint(live.df, ema), step=1)
    res = lr_occupancy.main(["--config", path, "--run",
                             str(tmp_path / "run"), "--count", "2",
                             "--gt_count", "2", "--steps", "4",
                             "--device", "cpu"])
    assert sorted(res) == ["ancestral", "ddim", "dpmpp", "gt"]
    assert 0 < res["gt"]["mean"] < 0.5
    for name in ("ancestral", "ddim", "dpmpp"):
        r = res[name]
        assert r["n"] == 2 and r["steps"] == (2 if name == "dpmpp" else 4)
        assert r["gt_ratio"] == pytest.approx(r["mean"] / res["gt"]["mean"])
    fracs = []
    for i in range(2):
        gen = torch.Generator().manual_seed(shape_seed(42, i))
        split = held.sample_lr(1, steps=4, generator=gen)
        fracs.append(float((split > 0).float().mean()))
    assert res["ancestral"]["mean"] == pytest.approx(np.mean(fracs))
    assert res["ancestral"]["min"] == pytest.approx(min(fracs))


def test_class_purity_runs_on_the_cpu(tmp_path):
    """Meshes marched from the five class families' SDFs (a 24^3 grid),
    two per class: the counts add up, and the families, which are far apart
    under Chamfer distance, score well above chance."""
    cfg = config_lib.load_config(os.path.join(REPO, "configs",
                                              "synthetic_cond.yaml"))
    cfg = dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, points_per_shape=1024))
    cfg_path = str(tmp_path / "cfg.yaml")
    config_lib.dump_config(cfg, cfg_path)
    ds = SyntheticDataset(class_families=True)
    lin = np.linspace(-0.9, 0.9, 24)
    grid = np.stack(np.meshgrid(lin, lin, lin, indexing="ij"), -1)
    names = ["airplane", "car", "chair", "table", "rifle"]
    for label, cat in enumerate(names):
        os.makedirs(tmp_path / "run" / f"results_{cat}")
        for i in range(2):
            idx = 100 + 5 * i + label
            sdf = ds._make_family_sdf(np.random.RandomState(idx), label)
            vals = sdf(grid.reshape(-1, 3)).reshape(grid.shape[:3])
            verts, faces = mesh_utils.marching_tetrahedra(
                torch.tensor(vals, dtype=torch.float32))
            mesh_utils.save_obj(
                str(tmp_path / "run" / f"results_{cat}" / f"{i}.obj"),
                verts.numpy(), faces.numpy())
    out = str(tmp_path / "purity.json")
    res = class_purity.main(["--root", str(tmp_path / "run"), "--config",
                             cfg_path, "--refs_per_class", "2", "--points",
                             "256", "--out", out, "--device", "cpu"])
    assert os.path.getsize(out) > 0
    assert res["n_total"] == 10 and res["chance"] == pytest.approx(0.2)
    assert sorted(res["per_class"]) == sorted(names)
    pure = 0
    for cat in names:
        r = res["per_class"][cat]
        assert r["n"] == 2 and sum(r["confusion"].values()) == 2
        assert r["purity"] == r["confusion"][cat] / 2
        assert r["margin"] >= 1.0
        pure += r["confusion"][cat]
    assert res["overall_purity"] == pure / 10
    assert res["overall_purity"] >= 0.8
