"""The port imports nothing of JAX: no module of ``octfusion_tpu_torch``
and not ``chip_smoke.py`` imports ``jax``, ``orbax`` or the JAX package
``octfusion_tpu`` (its numpy-only modules included), read from their
source with ``ast`` (``test_torch_port_cascade.py`` checks what a run
actually loads)."""

import ast
import glob
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "octfusion_tpu")
FILES = sorted(
    glob.glob(os.path.join(REPO, "octfusion_tpu_torch", "**", "*.py"),
              recursive=True)) + [os.path.join(REPO, "chip_smoke.py")]


def imported_modules(path):
    """Every absolute module name that ``path`` imports."""
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def forbidden(name):
    root = name.split(".")[0]
    return root in FORBIDDEN


@pytest.mark.parametrize("path", FILES,
                         ids=[os.path.relpath(f, REPO) for f in FILES])
def test_port_imports_no_jax(path):
    bad = [m for m in imported_modules(path) if forbidden(m)]
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"


def test_guard_sees_the_forbidden_forms(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import os\nimport jax.numpy as jnp\n"
                   "from octfusion_tpu.data import dataset\n"
                   "from octfusion_tpu_torch import config\n"
                   "from . import sibling\n"
                   "def f():\n    import orbax.checkpoint\n")
    got = [m for m in imported_modules(str(src)) if forbidden(m)]
    assert got == ["jax.numpy", "octfusion_tpu.data", "orbax.checkpoint"]
    assert len(FILES) > 40


@pytest.mark.parametrize("module", [
    "octfusion_tpu_torch/models/union_3t_solver.py",
    "octfusion_tpu_torch/tools/lr_occupancy.py",
    "octfusion_tpu_torch/tools/class_purity.py"])
def test_scan_covers_the_three_stage_modules(module):
    """The 3-stage solver and the tools that came with it are scanned."""
    assert os.path.join(REPO, module) in FILES


@pytest.mark.parametrize("module", [
    "octfusion_tpu_torch/metrics/render.py",
    "octfusion_tpu_torch/metrics/fid.py",
    "octfusion_tpu_torch/utils/jax_prng.py",
    "octfusion_tpu_torch/tools/prepare_dataset.py"])
def test_scan_covers_the_fid_and_preparation_modules(module):
    """The renderer, shading FID, the copy of JAX's generator (which
    draws the stand-in's weights without JAX) and dataset preparation are
    scanned."""
    assert os.path.join(REPO, module) in FILES
