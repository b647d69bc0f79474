"""The port's entry points compute in fp32, as the reference does
(``compute_dtype: float32``): ``UnionSolver(...)``, ``train.main``,
``generate.main`` and ``evaluate.main`` turn off TF32 for float32
matmuls and cuDNN convolutions, whatever the flags were before (PyTorch
lets cuDNN run a float32 convolution in TF32 by default).  On the CPU, with both flags set
to True first; the card-only test of the lr denoise step in
``test_torch_port_cuda.py`` checks the numbers.  No JAX here."""

import os

import numpy as np
import pytest
import torch

from octfusion_tpu_torch import evaluate, generate, train
from octfusion_tpu_torch.config import load_config
from octfusion_tpu_torch.models.union_solver import UnionSolver
from octfusion_tpu_torch.utils import mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_YAML = os.path.join(REPO, "configs", "synthetic_tiny.yaml")


@pytest.fixture
def tf32_on():
    """Both TF32 flags on for the test, restored after it."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


def _tetrahedra(root, n):
    """``n`` small tetrahedra as ``.obj`` files under ``root`` -> glob."""
    os.makedirs(root)
    faces = np.array([[0, 1, 2], [0, 1, 3], [0, 2, 3], [1, 2, 3]])
    rng = np.random.RandomState(len(root))
    for i in range(n):
        verts = rng.rand(4, 3).astype(np.float32)
        mesh.save_obj(os.path.join(root, f"{i}.obj"), verts, faces)
    return os.path.join(root, "*.obj")


def _run(entry, tmp_path):
    if entry == "solver":
        UnionSolver(load_config(TINY_YAML), device="cpu")
    elif entry == "train":
        stats = train.main([
            "--model", "union", "--stage", "lr", "--config", TINY_YAML,
            "--name", "fp32", "--logs_dir", str(tmp_path), "--max_steps",
            "1", "--device", "cpu"])
        assert len(stats["loss"]) == 1
    elif entry == "generate":
        written = generate.main([
            "--config", TINY_YAML, "--name", "fp32", "--logs_dir",
            str(tmp_path), "--count", "1", "--sampler", "dpmpp",
            "--sample_steps", "2", "--device", "cpu"])
        assert len(written) <= 1
    else:
        res = evaluate.main([
            "--samples", _tetrahedra(str(tmp_path / "s"), 2),
            "--reference", _tetrahedra(str(tmp_path / "r"), 2),
            "--points", "32", "--batch", "2", "--device", "cpu"])
        assert 0.0 <= res["cov_cd"] <= 1.0


@pytest.mark.parametrize("entry", ["solver", "train", "generate",
                                   "evaluate"])
def test_entry_points_turn_tf32_off(entry, tmp_path, tf32_on):
    _run(entry, tmp_path)
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
