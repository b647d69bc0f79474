"""The port's generation cascade against the JAX package's, on the tiny
configuration (``configs/synthetic_tiny.yaml`` values), with JAX-initialised
parameters (perturbed with seeded noise so zero-initialised layers carry
signal) carried over by the parameter bridge and the noise of both stages
injected from numpy.

Stage by stage, each port stage is fed the JAX output of the stage before
it, so a sign or argmax near-tie cannot make the test flaky: lr split grid,
hr codes, decoder logits and planes and the SDF grid to rtol = atol = 1e-4,
octrees and dual graphs exactly.  Then one end-to-end pass of the port at
the same seed, which asserts its own margins (lr pre-snap values and
decoder split logits away from zero by more than 1e-3) and must reproduce
the JAX octree, depth-stop graph, codes (1e-4) and SDF grid (1e-4).
Finally a subprocess runs the port alone (sampling, training and
evaluation) and checks that it imported nothing of JAX."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_port_helpers import (TINY, assert_graph_equal,
                                     assert_octree_equal, jax_cascade, np_,
                                     port_octree, union_solvers)

TOL = dict(rtol=1e-4, atol=1e-4)
STEPS = 6
RES = 24
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def run():
    """Both solvers with the same weights, the JAX cascade stage by stage,
    and the injected noise."""
    sj, st, params, vae_params, rng = union_solvers()
    return (st,) + jax_cascade(sj, params, vae_params, rng, STEPS, RES)


def test_cascade_stage_by_stage(run):
    st, j, lr_noise, hr_noise = run
    split = st.sample_lr(1, steps=STEPS, noise_stream=lr_noise)
    np.testing.assert_allclose(np_(split), np_(j["split"]), **TOL)

    octree, g = st._grow_fn(1)(torch.tensor(np_(j["split"])))
    assert_octree_equal(octree, j["octree"])
    assert_graph_equal(g, j["g"])

    code = st.sample_hr(g, 1, steps=STEPS, noise_stream=hr_noise)
    np.testing.assert_allclose(np_(code), np_(j["code"]), **TOL)

    with torch.no_grad():
        dec = st.vae.decode_grow(torch.tensor(np_(j["code"])), g)
    jd = j["dec"]
    for d in (3, 4):
        np.testing.assert_allclose(np_(dec["logits"][d]),
                                   np_(jd["logits"][d]), **TOL)
    assert_graph_equal(dec["graph_out"], jd["graph_out"])
    for dd, v in jd["reg_voxs"][4].items():
        np.testing.assert_allclose(np_(dec["reg_voxs"][4][dd]), np_(v), **TOL)

    reg = {dd: torch.tensor(np_(v)) for dd, v in jd["reg_voxs"][4].items()}
    from octfusion_tpu_torch.utils import sdf as tsdf
    sdf = tsdf.calc_sdf(reg, port_octree(jd["octree_out"]), 2, 4, size=RES)
    np.testing.assert_allclose(np_(sdf), np_(j["sdf"]), **TOL)


def test_cascade_end_to_end(run):
    st, j, lr_noise, hr_noise = run
    pre_snap = []

    def record(mod, args, kwargs, out):
        if not kwargs.get("as_middle", False):
            pre_snap.append(np_(out))

    hook = st.df.unet_lr.register_forward_hook(record, with_kwargs=True)
    try:
        out = st.sample(steps=STEPS, resolution=RES, lr_noise=lr_noise,
                        hr_noise=hr_noise, mesh=True)
    finally:
        hook.remove()
    # lr outputs at the snapped steps (t < 0.7) are away from the sign tie
    snapped = [o for i, o in enumerate(pre_snap) if 1 - i / STEPS < 0.7]
    assert snapped and min(np.abs(o).min() for o in snapped) > 1e-3
    # decoder split logits are away from the argmax tie
    lg = np_(out["decode_out"]["logits"][3])
    valid = np_(out["graph"].level(3).node_mask)[-lg.shape[0]:]
    assert np.abs(lg[:, 1] - lg[:, 0])[valid].min() > 1e-3

    assert_octree_equal(out["octree_small"], j["octree"])
    assert_graph_equal(out["graph"], j["g"])
    np.testing.assert_allclose(np_(out["code"]), np_(j["code"]), **TOL)
    assert_octree_equal(out["decode_out"]["octree_out"], j["dec"]["octree_out"])
    np.testing.assert_allclose(np_(out["sdfs"]), np_(j["sdf"]), **TOL)
    assert set(out["seconds"]) == {"lr", "grow", "hr", "decode", "sdf",
                                   "marching"}
    verts, faces = out["meshes"][0]
    assert verts.shape[1] == 3 and faces.shape[1] == 3


def test_port_imports_no_jax():
    """The port alone: a tiny cascade, two hr train steps, a tiny
    evaluation (CD and EMD metrics) and the generate CLI (DPM-Solver++,
    packed levels) from a checkpoint of the cascade's weights."""
    code = (
        "import sys, torch\n"
        "from octfusion_tpu_torch import config as C\n"
        "from octfusion_tpu_torch.models import common\n"
        "from octfusion_tpu_torch.models.union_solver import UnionSolver\n"
        "from octfusion_tpu_torch.utils.shapes import lumpy_spheres\n"
        f"TINY = {TINY!r}\n"
        "cfg = C.Config(solver=C.SolverConfig(**TINY['solver']),\n"
        "    model=C.VAEConfig(**TINY['model']),\n"
        "    capacity=C.CapacityConfig(**TINY['capacity']),\n"
        "    diffusion=C.DiffusionConfig(**TINY['diffusion']))\n"
        "solver = UnionSolver(cfg, device='cpu')\n"
        "out = solver.sample(steps=2, mesh=True,\n"
        "    generator=torch.Generator().manual_seed(0))\n"
        "assert torch.isfinite(out['sdfs']).all()\n"
        "pts, nrm = lumpy_spheres(2, 1024, seed=0)\n"
        "octree = common.batch_to_octree(pts, nrm, solver.spec1)\n"
        "assert not octree.overflow.any()\n"
        "step = solver.make_train_step()\n"
        "gen = torch.Generator().manual_seed(1)\n"
        "for _ in range(2):\n"
        "    ld = step({'points': pts, 'normals': nrm}, generator=gen)\n"
        "assert torch.isfinite(ld['loss']) and ld['overflow'] == 0\n"
        "import numpy as np\n"
        "from octfusion_tpu_torch import evaluate\n"
        "from octfusion_tpu_torch.metrics import evaluation\n"
        "rng = np.random.RandomState(0)\n"
        "pts = rng.normal(size=(2, 5, 32, 3)).astype(np.float32)\n"
        "res = evaluation.evaluate_point_sets(pts[0], pts[1], batch=4,\n"
        "                                     device='cpu')\n"
        "assert all(np.isfinite(v) for v in res.values()), res\n"
        "import os, tempfile\n"
        "from octfusion_tpu_torch import generate\n"
        "from octfusion_tpu_torch.utils import ckpt, params\n"
        "os.environ['OCTFUSION_CONV_KPACK'] = '1'\n"
        "with tempfile.TemporaryDirectory() as d:\n"
        "    ckpt.save(os.path.join(d, 'run', 'ckpt'),\n"
        "              params.union_checkpoint(solver.df), step=1)\n"
        "    generate.main(['--config', 'configs/synthetic_tiny.yaml',\n"
        "        '--logs_dir', d, '--name', 'run', '--count', '1',\n"
        "        '--sampler', 'dpmpp', '--sample_steps', '2',\n"
        "        '--device', 'cpu'])\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'flax', 'optax', 'octfusion_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().endswith("ok")
