"""The port's generation path outside the cascade itself: the packed
forward graph conv (K5's plain version on a packed level), checkpoints,
reference-layout weights and the generate CLI.

* a packed level's conv against the JAX package's K5 run as
  ``tests/test_pallas_conv.py`` runs it (``with_conv_plans(g,
  packed=True)`` through ``graph_ops.graph_conv``, Pallas in interpret
  mode) on the same graph from both packages, at (d, C, C') = (3, 16, 8)
  and (4, 8, 24): rtol = atol = 1e-4 (float32, another summation order);
* a packed level raises where autograd would need a gradient;
* ``utils/ckpt``: save / rotate / latest_path / restore;
* a reference-layout ``.pth`` loads through ``load_union_checkpoint`` /
  ``load_vae_checkpoint`` into exactly the tensors that
  ``torch_convert`` and the parameter bridge give, and loading is strict;
* ``python -m octfusion_tpu_torch.generate --device cpu`` on the tiny
  configuration from a checkpoint in the run directory: writes both
  indices, skips written ones, and regenerates one index byte for byte.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import torch_ref_unet as tru
import torch_ref_vae as tref

from octfusion_tpu.octree.dual_graph import with_conv_plans
from octfusion_tpu.ops import graph_ops as jgraph_ops
from octfusion_tpu.utils import torch_convert as tc
from octfusion_tpu_torch.models.union_solver import UnionSolver
from octfusion_tpu_torch.octree.dual_graph import (N_EDGE_TYPE,
                                                   build_dual_graph,
                                                   with_packed_levels)
from octfusion_tpu_torch.ops import graph_conv_cuda, graph_ops, roofline
from octfusion_tpu_torch.utils import ckpt
from octfusion_tpu_torch.utils import params as bridge

from test_torch_port_helpers import (assert_graph_equal, make_graph, np_,
                                     port_octree, tcfg, tiny_config)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_YAML = os.path.join(REPO, "configs", "synthetic_tiny.yaml")
LR_CFG = {"model_channels": 8, "channel_mult": (1, 2),
          "attention_resolutions": (2,)}
HR_CFG = {"model_channels": 16, "channel_mult": (1, 1),
          "num_res_blocks": (1, 0), "input_depth": 3}
VAE = dict(depth=4, depth_stop=3, depth_out=4, resblk_num=1)


@pytest.fixture(scope="module")
def graphs():
    """The graph of ``test_pallas_conv.test_packed_kernel_forward_parity``
    in both packages, and the JAX one with its packed plans."""
    jg = make_graph(seed=13, n=400)
    jgp = jax.jit(lambda g: with_conv_plans(g, packed=True))(jg)
    tg = build_dual_graph(port_octree(jg.octree), 9)
    assert_graph_equal(tg, jg)
    return jg, jgp, tg


def test_packed_level_matches_jax_k5(graphs, monkeypatch):
    _, jgp, tg = graphs
    tp = with_packed_levels(tg)
    calls = [0]
    plain = graph_conv_cuda.graph_conv_packed_plain

    def counting(*args):
        calls[0] += 1
        return plain(*args)

    monkeypatch.setattr(graph_conv_cuda, "graph_conv_packed_plain", counting)
    rng = np.random.RandomState(17)
    for n, (d, c, cout) in enumerate(((3, 16, 8), (4, 8, 24)), 1):
        assert not bool(jgp.level(d).conv_plan.overflow), d
        x = rng.normal(size=(tg.level(d).g_cap, c)).astype(np.float32)
        w = (rng.normal(size=(N_EDGE_TYPE * c, cout)) * 0.1).astype(
            np.float32)
        ref = jgraph_ops.graph_conv(jnp.asarray(x), jnp.asarray(w),
                                    jgp.level(d))
        got = graph_ops.graph_conv(torch.tensor(x), torch.tensor(w),
                                   tp.level(d))
        assert calls[0] == n
        np.testing.assert_allclose(np_(got), np_(ref), rtol=1e-4, atol=1e-4)


def test_packed_level_is_forward_only(graphs):
    _, _, tg = graphs
    lvl = with_packed_levels(tg, depths=(3,)).level(3)
    assert lvl.packed and not tg.level(3).packed
    x = torch.randn(lvl.g_cap, 4)
    w = torch.randn(N_EDGE_TYPE * (4 + 2), 5)
    with torch.no_grad():
        ref = graph_ops.graph_conv(x.requires_grad_(), w, lvl, 2)
    for xr, wr in ((True, False), (False, True)):
        with pytest.raises(RuntimeError, match="forward-only"):
            graph_ops.graph_conv(x.detach().requires_grad_(xr),
                                 w.detach().requires_grad_(wr), lvl, 2)
    got = graph_ops.graph_conv(x.detach(), w, lvl, 2)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
    # the unpacked level stays differentiable
    out = graph_ops.graph_conv(x.detach().requires_grad_(), w, tg.level(3), 2)
    assert out.grad_fn is not None


def test_checkpoint_round_trip(tmp_path):
    d = str(tmp_path / "ckpt")
    assert ckpt.latest_path(d) is None
    for step in range(1, 8):
        ckpt.save(d, {"w": torch.full((2,), float(step)), "step": step},
                  step, ckpt_num=3)
    files = sorted(n for n in os.listdir(d) if n != "steps-latest")
    assert files == ["steps-5.pth", "steps-6.pth", "steps-7.pth"]
    latest = ckpt.latest_path(d)
    assert latest == os.path.join(d, "steps-latest")
    tree = ckpt.restore(latest)
    assert tree["step"] == 7 and torch.equal(tree["w"], torch.full((2,), 7.))
    # a temporary file of a killed save is swept; without the symlink the
    # newest step file is the latest
    open(os.path.join(d, "steps-8.pth.123.tmp"), "w").close()
    os.remove(latest)
    assert ckpt.latest_path(d) == os.path.join(d, "steps-7.pth")
    ckpt.rotate(d, 2)
    assert sorted(os.listdir(d)) == ["steps-6.pth", "steps-7.pth"]
    assert ckpt.restore(os.path.join(d, "steps-6.pth"))["step"] == 6


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k].reshape(got[k].shape)), k


def test_reference_checkpoints_load_as_torch_convert(tmp_path):
    """A reference-layout diffusion ``.pth`` and a VAE ``.pth`` (the
    reference's ``autoencoder`` entry, and a bare state dict) load into the
    port bit for bit as ``torch_convert`` + the parameter bridge read
    them."""
    rng = np.random.RandomState(0)
    tree = {}
    for prefix in ("df_", "ema_df_"):
        tree[prefix + "unet_lr"] = tru.lr_make_state_dict(rng, LR_CFG)
        tree[prefix + "unet_hr"] = tru.hr_make_state_dict(
            rng, HR_CFG, in_channels=2, out_channels=2, lr_model_channels=8)
    path = str(tmp_path / "df_steps-union.pth")
    torch.save(tree, path)
    solver = UnionSolver(tiny_config(tcfg), device="cpu")
    for ema in (True, False):
        bridge.load_union_checkpoint(solver.df, ckpt.restore(path), ema=ema)
        want = bridge.union_state_dict(tc.convert_union_ckpt(
            tc.load_torch_file(path), LR_CFG["channel_mult"],
            LR_CFG["attention_resolutions"], HR_CFG["channel_mult"],
            HR_CFG["num_res_blocks"], ema=ema), solver.union_cfg)
        _assert_same(solver.df.state_dict(), want)

    sd = tref.make_state_dict(rng, channels=(4, 8, 8, 8, 8), embed_dim=2,
                              **VAE)
    for name, content in (("vae.pth", {"autoencoder": sd}),
                          ("vae_bare.pth", sd)):
        path = str(tmp_path / name)
        torch.save(content, path)
        bridge.load_vae_checkpoint(solver.vae, path)
        want = bridge.vae_state_dict(tc.load_vae_checkpoint(path, **VAE),
                                     **VAE)
        _assert_same(solver.vae.state_dict(), want)


def test_checkpoint_loading_is_strict(tmp_path):
    solver = UnionSolver(tiny_config(tcfg), device="cpu")
    tree = bridge.union_checkpoint(solver.df)
    bridge.load_union_checkpoint(solver.df, tree)
    missing = dict(tree, ema_df_unet_hr=dict(tree["ema_df_unet_hr"]))
    missing["ema_df_unet_hr"].pop("out.weights")
    extra = dict(tree, ema_df_unet_lr=dict(tree["ema_df_unet_lr"],
                                           unknown=torch.zeros(1)))
    no_stage = {k: v for k, v in tree.items() if k != "ema_df_unet_lr"}
    for bad, err in ((missing, RuntimeError), (extra, RuntimeError),
                     (no_stage, KeyError)):
        with pytest.raises(err):
            bridge.load_union_checkpoint(solver.df, bad)
    path = str(tmp_path / "vae.pth")
    sd = solver.vae.state_dict()
    sd.pop(next(iter(sd)))
    torch.save(sd, path)
    with pytest.raises(RuntimeError):
        bridge.load_vae_checkpoint(solver.vae, path)


def _generate(logs, *extra):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OCTFUSION_CONV_KPACK"] = "1"
    res = subprocess.run(
        [sys.executable, "-m", "octfusion_tpu_torch.generate", "--config",
         TINY_YAML, "--logs_dir", logs, "--name", "run", "--sampler",
         "dpmpp", "--sample_steps", "3", "--device", "cpu", *extra],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return res.stdout.splitlines()


def test_generate_cli(tmp_path):
    """Two shapes from a checkpoint in the run directory (auto-resume); a
    rerun skips them; index 1 alone regenerates the same bytes."""
    logs = str(tmp_path)
    torch.manual_seed(0)
    solver = UnionSolver(tiny_config(tcfg), device="cpu")
    ckpt.save(os.path.join(logs, "run", "ckpt"),
              bridge.union_checkpoint(solver.df), step=3)
    rdir = os.path.join(logs, "run", "results_airplane")
    out = _generate(logs, "--count", "2")
    assert any(ln.startswith("[*] loaded EMA diffusion weights from")
               for ln in out)
    assert "[warn] no --vq_ckpt given; using random VAE weights" in out
    for i in range(2):
        path = os.path.join(rdir, f"{i}.obj")
        assert (f"[*] wrote {path}" in out) != \
            (f"[!] empty mesh, skipped {path}" in out)
    assert any(ln.startswith("[*] generated 2 shapes on cpu") for ln in out)
    # these seeded weights give two non-empty meshes
    assert sorted(os.listdir(rdir)) == ["0.obj", "1.obj"]

    out = _generate(logs, "--count", "2")
    assert out == ["[*] 2/2 meshes already present; generating the rest"]

    path = os.path.join(rdir, "1.obj")
    with open(path, "rb") as fh:
        first = fh.read()
    os.remove(path)
    out = _generate(logs, "--count", "2")
    assert f"[*] wrote {path}" in out
    assert not any(ln.startswith("[*] wrote") and "0.obj" in ln for ln in out)
    with open(path, "rb") as fh:
        assert fh.read() == first


def test_k5_bound_uses_the_tf32_rate():
    """K5 computes K1's function: the same operations and bytes, with the
    operations at the dense TF32 tensor-core rate."""
    cost = roofline.graph_conv_fwd_cost(4096, 515, 512, 27136)
    ops_ms, _ = roofline.times_ms(*cost, flops_rate=roofline.TF32_FLOPS)
    assert ops_ms == pytest.approx(15_148_416_000 / 495e12 * 1e3, rel=1e-9)
    assert roofline.TF32_FLOPS > roofline.FP32_FLOPS
