"""Shared helpers of the port's parity tests: the tiny configuration in
both packages, conversions between JAX and port containers, and
field-by-field comparisons of octrees and dual graphs."""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octfusion_tpu import config as jcfg  # noqa: F401  (re-exported)
from octfusion_tpu.octree.octree import Octree as JOctree
from octfusion_tpu_torch import config as tcfg  # noqa: F401  (re-exported)
from octfusion_tpu_torch.octree.octree import Octree as TOctree
from octfusion_tpu_torch.octree.octree import OctreeSpec as TOctreeSpec

# the values of configs/synthetic_tiny.yaml (solver resolution and steps cut
# for test time)
TINY = dict(
    solver=dict(resolution=24, sdf_scale=0.9),
    model=dict(depth=4, full_depth=2, depth_stop=3, depth_out=4, embed_dim=2,
               resblk_num=1, channels=(4, 8, 8, 8, 8), use_checkpoint=False),
    capacity=dict(finest_cap=2048, decay=1.0, edge_factor=10),
    diffusion=dict(ddim_steps=6, input_depth=(2, 3), input_channels=(8, 2),
                   out_channels=(8, 2), model_channels=(8, 16),
                   channel_mult=((1, 2), (1, 1)),
                   num_res_blocks=((1, 1), (1, 0)),
                   attention_resolutions=(2,)),
)


@pytest.fixture(scope="module")
def one_torch_thread():
    """PyTorch on one intra-op thread for a module's tests, restored
    after: the suite runs several workers on the CPU's cores at once, and
    an oversubscribed thread pool made small-step training tests ~50x
    slower there (1 s alone, 80 s beside five busy workers)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def tiny_config(mod):
    """``Config`` of the tiny setting from module ``jcfg`` or ``tcfg``."""
    return mod.Config(
        solver=mod.SolverConfig(**TINY["solver"]),
        model=mod.VAEConfig(**TINY["model"]),
        capacity=mod.CapacityConfig(**TINY["capacity"]),
        diffusion=mod.DiffusionConfig(**TINY["diffusion"]),
    )


def np_(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def port_octree(o: JOctree) -> TOctree:
    """A JAX octree as a port octree (same values, int64 indices)."""
    s = o.spec
    i64 = lambda a: torch.tensor(np.asarray(a).astype(np.int64))
    return TOctree(
        spec=TOctreeSpec(s.depth, s.full_depth, s.batch_size, s.node_caps),
        keys=[i64(k) for k in o.keys], batch=[i64(b) for b in o.batch],
        child=[i64(c) for c in o.child], nnum=i64(o.nnum),
        nnum_nempty=i64(o.nnum_nempty),
        signal=torch.tensor(np.asarray(o.signal)),
        overflow=torch.tensor(np.asarray(o.overflow)),
    )


def assert_octree_equal(t: TOctree, j: JOctree):
    assert t.spec.node_caps == j.spec.node_caps
    for name in ("nnum", "nnum_nempty", "overflow"):
        np.testing.assert_array_equal(np_(getattr(t, name)),
                                      np_(getattr(j, name)), err_msg=name)
    for d in range(j.spec.depth + 1):
        for name in ("keys", "batch", "child"):
            np.testing.assert_array_equal(
                np_(getattr(t, name)[d]), np_(getattr(j, name)[d]),
                err_msg=f"{name}[{d}]")


_LEVEL_EXACT = ("edge_row", "edge_col", "edge_dir", "n_edges", "node_type",
                "node_batch", "node_mask", "node_depthv", "node_slot",
                "n_nodes", "overflow")


def assert_level_equal(t, j):
    assert t.d == j.d and t.g_cap == j.g_cap
    for name in _LEVEL_EXACT:
        np.testing.assert_array_equal(np_(getattr(t, name)),
                                      np_(getattr(j, name)), err_msg=name)
    # 1/count in float32 on both sides
    np.testing.assert_allclose(np_(t.edge_scale), np_(j.edge_scale),
                               rtol=0, atol=1e-7)


def assert_graph_equal(t, j):
    assert t.last_depth == j.last_depth
    assert_octree_equal(t.octree, j.octree)
    for lt, lj in zip(t.levels, j.levels):
        assert_level_equal(lt, lj)
    for name in ("row", "col", "dir", "overflow"):
        np.testing.assert_array_equal(np_(getattr(t.carried, name)),
                                      np_(getattr(j.carried, name)),
                                      err_msg=f"carried.{name}")
    np.testing.assert_array_equal(np_(t.lnum), np_(j.lnum))
    for a, b in zip(t.leaf_rank, j.leaf_rank):
        np.testing.assert_array_equal(np_(a), np_(b))
    for a, b in zip(t.leaf_pos, j.leaf_pos):
        np.testing.assert_array_equal(np_(a), np_(b))
    assert bool(t.any_overflow()) == bool(j.any_overflow())


def random_split(rng, batch, s, p):
    """[B, S, S, S, 8] grid of +-1 with occupancy probability ``p``."""
    return np.where(rng.rand(batch, s, s, s, 8) < p, 1.0, -1.0).astype(
        np.float32)


def perturb(tree, rng, scale=0.05):
    """Add seeded noise to every leaf of a param tree, so zero-initialised
    layers (the hr output conv, res-block conv2s) carry signal too."""
    if isinstance(tree, dict):
        return {k: perturb(v, rng, scale) for k, v in tree.items()}
    a = np.asarray(tree)
    return jnp.asarray(a + scale * rng.normal(size=a.shape).astype(a.dtype))


def make_graph(seed=0, depth=4, full_depth=2, n=300, up_to=None,
               edge_factor=9):
    """``tests/test_pallas_conv.make_graph`` under one ``jax.jit``: the JAX
    dual graph of an octree built from a seeded lumpy-sphere point cloud."""
    import jax

    from octfusion_tpu.octree.dual_graph import build_dual_graph
    from octfusion_tpu.octree.octree import OctreeSpec, build_octree

    rng = np.random.RandomState(seed)
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    r = 0.55 + 0.2 * np.sin(4 * v[:, 0])
    spec = OctreeSpec.create(
        depth, full_depth, 1, finest_cap_per_sample=2048, decay=1.0
    )
    build = jax.jit(lambda p, nrm: build_dual_graph(
        build_octree(p, nrm, spec), edge_factor, up_to=up_to or depth))
    return build(jnp.asarray((r[:, None] * v).astype(np.float32)),
                 jnp.asarray(v.astype(np.float32)))


def jspec_of(tspec):
    from octfusion_tpu.octree.octree import OctreeSpec
    return OctreeSpec(**dataclasses.asdict(tspec))



# widen the lr outputs so that few sit near the sign-snap tie
LR_OUT_GAIN = 10.0


def union_solvers(sampler: str = "ancestral"):
    """The JAX and port solvers of the tiny configuration with
    ``diffusion.sampler`` = ``sampler`` and the same weights: JAX-initialised
    U-Nets and VAE, perturbed with seeded noise so zero-initialised layers
    carry signal, carried over by the parameter bridge -> (JAX solver, port
    solver, U-Net params, VAE params, the numpy generator after the
    perturbations)."""
    import jax

    from octfusion_tpu.data.dataset import SyntheticDataset, collate
    from octfusion_tpu.models.union_solver import UnionSolver as JSolver
    from octfusion_tpu_torch.models.union_solver import UnionSolver as TSolver
    from octfusion_tpu_torch.utils import params as bridge

    cj, ct = tiny_config(jcfg), tiny_config(tcfg)
    cj = dataclasses.replace(cj, diffusion=dataclasses.replace(
        cj.diffusion, sampler=sampler))
    ct = dataclasses.replace(ct, diffusion=dataclasses.replace(
        ct.diffusion, sampler=sampler))
    sj = JSolver(cj)
    ds = SyntheticDataset(size=1, point_sample_num=256, points_per_shape=2048)
    batch = {k: jnp.asarray(v) for k, v in collate([ds[0]]).items()
             if k != "filename"}
    rng = np.random.RandomState(0)
    params = perturb(jax.device_get(
        sj.init_params(jax.random.PRNGKey(0), batch)), rng)
    out = params["params"]["unet_lr"]["out"]["conv"]
    out["kernel"] = out["kernel"] * LR_OUT_GAIN
    g_in = make_graph(seed=1, depth=4, full_depth=2, n=400)
    vae_params = perturb(jax.device_get(jax.jit(sj.vae.init)(
        jax.random.PRNGKey(1), g_in, None, jax.random.PRNGKey(2))), rng)

    st = TSolver(ct, device="cpu")
    st.df.load_state_dict(bridge.union_state_dict(params, st.union_cfg),
                          strict=True)
    st.vae.load_state_dict(
        bridge.vae_state_dict(vae_params, 4, 3, 4, 1), strict=True)
    return sj, st, params, vae_params, rng


def jax_cascade(sj, params, vae_params, rng, steps, res):
    """The JAX cascade of the tiny configuration stage by stage, each stage
    jitted, with lr and hr noise drawn from ``rng`` -> (the stage outputs,
    lr noise, hr noise)."""
    import jax

    from octfusion_tpu.nn.vae import GraphVAE as JGraphVAE
    from octfusion_tpu.ops import mpu as jmpu

    lr_noise = rng.normal(size=(steps + 1, 1, 8, 4, 4, 4)).astype(np.float32)
    g_cap = sj.cfg.capacity.octree_spec(4, 2).node_caps[2:4]
    hr_noise = rng.normal(size=(1, sum(g_cap), 2)).astype(np.float32)

    key = jax.random.PRNGKey(3)
    split = jax.jit(sj.sample_lr, static_argnames=("batch_size", "steps"))(
        params, key, batch_size=1, steps=steps, noise_stream=lr_noise)
    octree, g = jax.jit(sj._grow_fn(1))(split)
    code = jax.jit(sj.sample_hr, static_argnames=("batch_size", "steps"))(
        params, key, g, batch_size=1, steps=steps, noise_stream=hr_noise)
    dec = jax.jit(lambda p, c, g: sj.vae.apply(
        p, c, g, method=JGraphVAE.decode_grow))(vae_params, code, g)
    sdf = jax.jit(lambda r, o: jmpu.mpu_grid_eval(
        r, o, 2, 4, res, -0.9, 0.9))(dec["reg_voxs"][4], dec["octree_out"])
    return (dict(split=split, octree=octree, g=g, code=code, dec=dec,
                 sdf=sdf), lr_noise, hr_noise)
