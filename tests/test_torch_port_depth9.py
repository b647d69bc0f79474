"""Depth 9 in the port against the JAX package
(``tests/test_depth9.py::test_depth9_build_encode_decode_grow`` at its
tiny caps), and the generate CLI's report of a capacity overflow in the
growing decode, which a depth-9 run with random weights meets.

The JAX side runs jitted (the octree and both graphs in one jit, the
encode + growing decode in another; eager it takes minutes)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from octfusion_tpu.nn.vae import GraphVAE as JGraphVAE
from octfusion_tpu.nn.vae import copy_topology_octree as j_copy_topology
from octfusion_tpu.octree.dual_graph import build_dual_graph as j_build_graph
from octfusion_tpu.octree.octree import OctreeSpec as JOctreeSpec
from octfusion_tpu.octree.octree import build_octree as j_build_octree
from octfusion_tpu_torch import generate
from octfusion_tpu_torch.config import dump_config, load_config
from octfusion_tpu_torch.nn.vae import GraphVAE, copy_topology_octree
from octfusion_tpu_torch.octree.dual_graph import build_dual_graph
from octfusion_tpu_torch.octree.octree import OctreeSpec, build_octree
from octfusion_tpu_torch.utils import params as bridge

from test_torch_port_helpers import assert_graph_equal, assert_octree_equal, np_

# the VAE tests' tolerance: fp32 through a few dozen layers, another
# summation order
TOL = dict(rtol=1e-4, atol=1e-4)
DEPTH, FULL_DEPTH, STOP = 9, 3, 8
CHANNELS = (4, 8, 8, 8, 8, 8, 8, 8, 8, 8)
# the depth-9 cap absorbs 8 x the depth-8 nodes, as in the JAX test
CAPS = (1, 8, 64, 512, 2048, 8192, 8192, 8192, 8192, 65536)


def _sphere():
    rng = np.random.RandomState(0)
    v = rng.normal(size=(600, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return (0.6 * v).astype(np.float32), v.astype(np.float32)


def test_depth9_build_encode_decode_grow_matches_jax():
    """Sphere -> depth-9 octree -> graphs (to depth 9, and to depth_stop 8
    on the copied topology) -> tiny VAE encode -> growing decode to depth
    9: octrees, graphs, overflow flags and the grown keys exactly as JAX's;
    codes, logits and SDF coefficients within ``TOL``."""
    pts, nrm = _sphere()
    jspec = JOctreeSpec.create(DEPTH, FULL_DEPTH, 1, caps_override=CAPS)

    @jax.jit
    def j_graphs(p, n):
        o = j_build_octree(p, n, jspec)
        return o, j_build_graph(o), j_build_graph(
            j_copy_topology(o, STOP), up_to=STOP)

    jo, jg, jg_small = j_graphs(jnp.asarray(pts), jnp.asarray(nrm))
    assert not bool(jnp.any(jo.overflow)) and int(jo.nnum[DEPTH]) > 0
    jvae = JGraphVAE(depth=DEPTH, full_depth=FULL_DEPTH, depth_stop=STOP,
                     depth_out=DEPTH, embed_dim=2, resblk_num=1,
                     channels=CHANNELS, use_checkpoint=False)
    key = jax.random.PRNGKey(0)
    params = jax.jit(jvae.init)(key, jg, jg, key)

    @jax.jit
    def j_run(p, g, g_small):
        mean, _ = jvae.apply(p, g, method=JGraphVAE.encode)
        return mean, jvae.apply(p, mean, g_small,
                                method=JGraphVAE.decode_grow)

    jmean, jout = j_run(params, jg, jg_small)

    spec = OctreeSpec.create(DEPTH, FULL_DEPTH, 1, caps_override=CAPS)
    o = build_octree(torch.tensor(pts), torch.tensor(nrm), spec)
    assert_octree_equal(o, jo)
    g = build_dual_graph(o)
    assert_graph_equal(g, jg)
    g_small = build_dual_graph(copy_topology_octree(o, STOP), up_to=STOP)
    assert_graph_equal(g_small, jg_small)

    vae = GraphVAE(depth=DEPTH, full_depth=FULL_DEPTH, depth_stop=STOP,
                   depth_out=DEPTH, embed_dim=2, resblk_num=1,
                   channels=CHANNELS, use_checkpoint=False)
    vae.load_state_dict(bridge.vae_state_dict(
        jax.device_get(params), DEPTH, STOP, DEPTH, 1), strict=True)
    with torch.no_grad():
        mean, _ = vae.encode(g)
        out = vae.decode_grow(mean, g_small)
    np.testing.assert_allclose(np_(mean), np_(jmean), **TOL)
    # the grown topology follows argmax(logits[8]): every decision's
    # margin (the smallest is ~2.5e-4 for these weights) must exceed twice
    # the port's error on the logits, so no decision sits on a tie
    lg = np_(jout["logits"][STOP])
    valid = np_(jg_small.octree.node_mask(STOP))
    err = np.abs(np_(out["logits"][STOP]) - lg)[valid].max()
    assert np.abs(lg[:, 1] - lg[:, 0])[valid].min() > 2 * err
    for d in (STOP, DEPTH):
        np.testing.assert_allclose(np_(out["logits"][d]),
                                   np_(jout["logits"][d]), **TOL)
        for dd in jout["reg_voxs"][d]:
            np.testing.assert_allclose(np_(out["reg_voxs"][d][dd]),
                                       np_(jout["reg_voxs"][d][dd]), **TOL)
    assert_graph_equal(out["graph_out"], jout["graph_out"])
    oc = out["octree_out"]
    assert int(oc.nnum[DEPTH]) == 8 * int(oc.nnum_nempty[STOP])


def test_generate_reports_a_decode_overflow(tmp_path, capsys):
    """A shape whose growing decode hits a cap while its grown graph does
    not: the CLI warns and its per-shape line shows the decoded level's
    flag (it once checked the grown graph alone, so such a shape was
    truncated silently).  The tiny config at depth 5: the decode grows
    levels 4 and 5, and 4096 slots at depth 5 are too few for random
    weights, which split most nodes."""
    cfg = load_config("configs/synthetic_tiny.yaml")
    cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, depth=5, depth_out=5,
                                       channels=(4, 8, 8, 8, 8, 8)),
        capacity=dataclasses.replace(cfg.capacity, finest_cap=4096),
        solver=dataclasses.replace(cfg.solver, resolution=24))
    path = str(tmp_path / "depth5.yaml")
    dump_config(cfg, path)
    generate.main(["--config", path, "--logs_dir", str(tmp_path), "--name",
                   "run", "--count", "1", "--sampler", "dpmpp",
                   "--sample_steps", "2", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    shape = [ln for ln in out if ln.startswith("[*] shape 0: nnum ")]
    assert len(shape) == 1, out
    fields = dict(tok.split("=", 1) for tok in shape[0].split() if "=" in tok)
    assert fields["grow_graph"] == "0" and fields["decoded_graph"] == "1"
    assert "[0, 0, 0, 0, 0, 1]" in shape[0]
    assert int(fields["d5"]) == 4096 and fields["sdf_finite"] == "True"
    assert any(ln.startswith("[!] static capacity overflow") for ln in out)
