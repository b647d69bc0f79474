"""The port's training loop against the JAX package's, stage by stage
(``vae``, ``lr``, ``hr``), on ``configs/synthetic_tiny.yaml`` with the
synthetic dataset.

The JAX side is the loop of the JAX ``train.py``: ``get_dataset`` ->
``CapacityFilteredDataset`` -> ``DataLoader`` (one worker) -> the
solver's ``make_train_step``, its first batch taken for ``init_state``
(``train.py:162``), and step ``it``'s key split from
``PRNGKey(seed)`` (``train.py:125``, ``:407``).  The port gets JAX's
initial weights through ``utils/params``, its own loader's batches after
the same first one, and each step's draws (VAE eps; lr times and noise;
hr eps, times and noise) replayed from that step's key into
``train.train_loop``.  After 3 steps: each step's loss within rtol 1e-4,
and every parameter within rtol = atol = 1e-4 of the parameters' largest
|value|, but for the leaves whose exact gradient is zero (the lr U-Net's
time embedding and the conv biases right before a per-channel group
norm, named in ``ZERO_GRAD_LEAVES``): both packages step them by their
fp32 noise, which AdamW turns into steps of about the learning rate with
either sign, so they are held to differ by at most 3 x lr, either way."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octfusion_tpu.data import dataset as jds
from octfusion_tpu.data import loader as jloader
from octfusion_tpu.models.union_solver import UnionSolver as JUnion
from octfusion_tpu.models.vae_solver import VAESolver as JVAE
from octfusion_tpu_torch import train as ttrain
from octfusion_tpu_torch.data import dataset as tds
from octfusion_tpu_torch.data import loader as tloader
from octfusion_tpu_torch.models.union_solver import UnionSolver as TUnion
from octfusion_tpu_torch.models.vae_solver import VAESolver as TVAE
from octfusion_tpu_torch.utils import params as bridge

from test_torch_port_helpers import (TINY, jcfg, np_,  # noqa: F401
                                     one_torch_thread, tcfg, tiny_config)

STEPS = 3
pytestmark = pytest.mark.usefixtures("one_torch_thread")
SEED = 42
TOL = 1e-4
M = TINY["model"]
VAE_ARGS = (M["depth"], M["depth_stop"], M["depth_out"], M["resblk_num"])
# the leaves of the tiny lr U-Net whose exact gradient is zero: the time
# embedding enters each ResnetBlock as a shift right before a GroupNorm
# of one channel per group, as do the conv biases below, and no other
# path reaches them (test_zero_gradient_leaves_are_exact holds the list)
ZERO_GRAD_LEAVES = tuple("unet_lr." + n for n in (
    "time_pos_emb.weights", "time_emb.0.weight", "time_emb.0.bias",
    "time_emb.2.weight", "time_emb.2.bias",
    "downs.0.0.block1.2.bias", "downs.0.0.time_mlp.1.weight",
    "downs.0.0.time_mlp.1.bias", "downs.0.2.op.bias",
    "downs.1.0.block1.2.bias", "downs.1.0.time_mlp.1.weight",
    "downs.1.0.time_mlp.1.bias", "downs.1.0.block2.3.bias",
    "downs.1.0.res_conv.bias", "downs.1.1.2.proj_out.bias",
    "mid_block1.block1.2.bias", "mid_block1.time_mlp.1.weight",
    "mid_block1.time_mlp.1.bias", "mid_block1.block2.3.bias",
    "mid_self_attn.2.proj_out.bias",
    "mid_block2.block1.2.bias", "mid_block2.time_mlp.1.weight",
    "mid_block2.time_mlp.1.bias", "mid_block2.block2.3.bias",
    "ups.0.0.block1.2.bias", "ups.0.0.time_mlp.1.weight",
    "ups.0.0.time_mlp.1.bias", "ups.0.0.block2.3.bias",
    "ups.0.0.res_conv.bias", "ups.0.2.conv.bias"))


def configs():
    data = dict(name="synthetic", batch_size=2, point_sample_num=256,
                points_per_shape=2048, num_workers=1)
    return tuple(dataclasses.replace(
        tiny_config(mod), data=mod.DataConfig(**data),
        train=mod.TrainConfig(lr=1e-3)) for mod in (jcfg, tcfg))


def jax_loop(stage, cj):
    """JAX's loop -> (initial params, final state, losses, step keys, VAE
    params (hr), the loader's first batch)."""
    spec1 = cj.capacity.octree_spec(cj.model.depth, cj.model.full_depth)
    ds = jds.CapacityFilteredDataset(jds.get_dataset(cj.data), spec1,
                                     edge_factor=cj.capacity.edge_factor)
    dl = jloader.DataLoader(ds, cj.data.batch_size, cj.data.shuffle,
                            cj.train.seed, cj.data.num_workers)
    data_iter = iter(dl)
    first = next(data_iter)
    jb_one = {k: jnp.asarray(v) for k, v in first.items() if k != "filename"}
    key = jax.random.PRNGKey(SEED)
    vae_params = None
    if stage == "vae":
        solver = JVAE(cj)
        state = solver.init_state(key, jb_one, total_steps=STEPS)
        step_fn = solver.make_train_step(STEPS)
    else:
        solver = JUnion(cj, stage_flag=stage)
        state = solver.init_state(key, jb_one)
        if stage == "hr":
            vae_params = JVAE(cj).init_state(key, jb_one,
                                             total_steps=10).params
        step_fn = solver.make_train_step()
    params0 = jax.device_get(state.params)
    losses, keys = [], []
    for _ in range(STEPS):
        batch = next(data_iter)
        key, k = jax.random.split(key)
        jb = {k2: jnp.asarray(v) for k2, v in batch.items()
              if k2 != "filename"}
        if stage == "vae":
            state, ld = step_fn(state, jb, k)
        else:
            state, ld = step_fn(state, vae_params, jb, k)
        losses.append(float(ld["loss"]))
        keys.append(k)
    dl.stop()
    return params0, state, losses, keys, vae_params, first


def draws_of(stage, key, b, code_shape, split_shape):
    """The draws JAX's step takes from its key ``key`` (``distributions.py
    :16-18``, ``union_solver.py:206``, ``sampler.py:226-228``)."""
    @jax.jit
    def draw(key):
        if stage == "vae":
            return {"eps": jax.random.normal(key, code_shape)}
        if stage == "hr":
            ekey, key = jax.random.split(key)
        tkey, nkey = jax.random.split(key)
        out = {"times": jax.random.uniform(tkey, (b,)),
               "noise": jax.random.normal(
                   nkey, code_shape if stage == "hr" else split_shape)}
        if stage == "hr":
            out["eps"] = jax.random.normal(ekey, code_shape)
        return out

    return {k: torch.tensor(np_(v)) for k, v in draw(key).items()}


def port_state(stage, ct, params0, vae_params):
    """The port's solver and step with JAX's initial weights -> (step,
    the module whose parameters train)."""
    if stage == "vae":
        solver = TVAE(ct, device="cpu")
        solver.vae.load_state_dict(bridge.vae_state_dict(params0, *VAE_ARGS),
                                   strict=True)
        return solver.make_train_step(STEPS), solver.vae
    solver = TUnion(ct, stage_flag=stage, device="cpu")
    solver.df.load_state_dict(bridge.union_state_dict(params0,
                                                      solver.union_cfg),
                              strict=True)
    if vae_params is not None:
        solver.vae.load_state_dict(
            bridge.vae_state_dict(vae_params, *VAE_ARGS), strict=True)
    return solver.make_train_step(), solver.df


@pytest.mark.parametrize("stage", ["vae", "lr", "hr"])
def test_train_loop_matches_jax(stage):
    cj, ct = configs()
    params0, state, losses, keys, vae_params, first = jax_loop(stage, cj)
    step, net = port_state(stage, ct, params0, vae_params)

    ds = tds.CapacityFilteredDataset(
        tds.get_dataset(ct.data),
        ct.capacity.octree_spec(ct.model.depth, ct.model.full_depth),
        edge_factor=ct.capacity.edge_factor)
    batches = iter(tloader.DataLoader(ds, 2, True, ct.train.seed, 3))
    assert next(batches)["filename"] == first["filename"]
    b = ct.data.batch_size
    s = 2 ** ct.model.full_depth
    draws = [draws_of(stage, k, b, step.solver.code_shape(b),
                      (b, s, s, s, 8)) for k in keys]
    try:
        stats = ttrain.train_loop(step, batches, STEPS,
                                  draws=lambda it: draws[it])
    finally:
        batches.close()
    np.testing.assert_allclose(stats["loss"], losses, rtol=TOL, atol=0)
    assert step.step == STEPS
    assert float(stats["last"]["overflow"]) == 0.0

    if stage == "vae":
        want = bridge.vae_state_dict(jax.device_get(state.params), *VAE_ARGS)
    else:
        want = bridge.union_state_dict(jax.device_get(state.params),
                                       step.solver.union_cfg)
    # rtol = atol = 1e-4 of the parameters' largest |value|
    atol = TOL * max(np.abs(np_(v)).max() for v in want.values())
    assert sorted(want) == sorted(n for n, _ in net.named_parameters())
    lr = ct.train.lr
    for n, p in net.named_parameters():
        got, ref = np_(p), np_(want[n]).reshape(p.shape)
        if n in ZERO_GRAD_LEAVES:
            assert np.abs(got - ref).max() <= 3 * lr, n
            continue
        np.testing.assert_allclose(got, ref, rtol=TOL, atol=atol, err_msg=n)


def test_zero_gradient_leaves_are_exact():
    """``ZERO_GRAD_LEAVES`` are exactly the leaves whose gradient is zero
    in float64 (below 1e-9 of the largest), at seeded weights with no
    zero entry."""
    from octfusion_tpu_torch.diffusion import sampler
    from octfusion_tpu_torch.models.common import batch_to_octree
    from octfusion_tpu_torch.octree import split_codec
    from octfusion_tpu_torch.utils.shapes import lumpy_spheres

    _, ct = configs()
    torch.manual_seed(0)
    solver = TUnion(ct, stage_flag="lr", device="cpu")
    df = solver.df.double()
    with torch.no_grad():
        for p in df.parameters():
            p.add_(0.05 * torch.randn_like(p))
    pts, nrm = lumpy_spheres(2, 2048, seed=1)
    split = split_codec.octree2split_small(
        batch_to_octree(pts, nrm, solver.spec1)).double()
    gen = torch.Generator().manual_seed(0)
    loss = sampler.diffusion_loss(
        lambda x, snr: df("lr", x, snr), split, None, 2, solver.log_snr,
        "x0", times=torch.rand(2, generator=gen, dtype=torch.float64),
        noise=torch.randn(split.shape, generator=gen, dtype=torch.float64))
    loss.backward()
    top = max(p.grad.abs().max().item() for p in df.parameters())
    zero = [n for n, p in df.named_parameters()
            if p.grad.abs().max().item() < 1e-9 * top]
    assert sorted(zero) == sorted(ZERO_GRAD_LEAVES)
