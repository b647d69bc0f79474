"""The port's hr-stage training against the JAX package's, on the tiny
configuration (``configs/synthetic_tiny.yaml`` values; the graph conv's
gradients are held in ``test_torch_port_conv_grad.py``):

* ``diffusion_loss``, graph and dense forms and the dense form with the
  lr stage's per-element weights (1e-5: one fp32 reduction);
* ``octree2split_small`` of a batch-2 octree, exactly;
* one lr train step of each package (``stage_flag="lr"``) with the same
  seeded lr U-Net and the JAX step's times and noise, at
  ``lr_pos_weight`` 1.0 and 1.75 from points and at 1.75 from a
  precomputed ``split_small``: the loss to 1e-4, the overflow flag where
  the split was built, and every gradient as in the hr step, but for the
  leaves whose exact gradient is zero (conv biases and time shifts before
  a per-channel norm), which must stay below 1e-5 of the step's largest
  gradient on both sides;
* one hr train step of each package, with the same seeded
  reference-layout weights (through ``utils/torch_convert.py`` into flax
  and the parameter bridge into the port) and the JAX step's random draws
  (encoder eps, times, noise) replicated from its key: the loss to 1e-4
  and every trainable gradient to 1e-3, and each leaf's largest error
  within 1e-4 of that leaf's largest |gradient|;
* the optimizer and EMA on identical gradients against optax's
  ``multi_transform(adamw, set_to_zero)`` (1e-6: the same arithmetic in
  another order);
* ``use_checkpoint`` on and off give the same gradients (1e-6)."""

import dataclasses
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch

from octfusion_tpu.diffusion import ema as jema
from octfusion_tpu.diffusion import sampler as jsampler
from octfusion_tpu.diffusion import schedule as jschedule
from octfusion_tpu.models.common import TrainState
from octfusion_tpu.models.union_solver import UnionSolver as JSolver
from octfusion_tpu.nn.unet_union import UNetUnion as JUNetUnion
from octfusion_tpu.utils import torch_convert as tc
from octfusion_tpu_torch.config import Config, load_config
from octfusion_tpu_torch.diffusion import sampler as tsampler
from octfusion_tpu_torch.diffusion import schedule as tschedule
from octfusion_tpu_torch.models.union_solver import UnionSolver as TSolver
from octfusion_tpu_torch.nn import modules as tmodules
from octfusion_tpu_torch.nn.unet_union import UNetUnion, UnionConfig
from octfusion_tpu_torch.models.common import batch_to_graph
from octfusion_tpu_torch.utils import params as bridge
from octfusion_tpu_torch.utils.shapes import lumpy_spheres

import torch_ref_unet as tru
import torch_ref_vae as tref
from test_torch_port_helpers import (TINY, jcfg, np_, perturb, tcfg,
                                     tiny_config)

GRAD_TOL = dict(rtol=1e-3, atol=1e-3)
# each leaf's largest gradient error, over that leaf's largest |gradient|:
# the absolute atol alone would pass a leaf whose gradients are all below it
GRAD_SCALE_TOL = 1e-4
# a leaf gradient below this share of the step's largest is fp32 noise
# (see test_lr_train_step_matches_jax)
NOISE_FLOOR = 1e-5
B = 2
LR_CFG = {"model_channels": 8, "channel_mult": (1, 2),
          "attention_resolutions": (2,)}
HR_CFG = {"model_channels": 16, "channel_mult": (1, 1),
          "num_res_blocks": (1, 0), "input_depth": 3, "full_depth": 2}


# ----------------------------------------------------------------------
# the loss
# ----------------------------------------------------------------------
@pytest.mark.parametrize("form", ["graph", "dense", "dense_weighted"])
def test_diffusion_loss_matches_jax(form):
    rng = np.random.RandomState(7)
    key = jax.random.PRNGKey(7)
    weight = None
    if form == "graph":
        x0 = rng.normal(size=(40, 3)).astype(np.float32)
        bid = np.repeat([0, 1, 2], [15, 15, 10]).astype(np.int32)
        mask = np.arange(40) < 33
        bid[~mask] = 2
        df_type = "eps"
    else:
        x0 = rng.normal(size=(2, 4, 4, 4, 8)).astype(np.float32)
        bid = mask = None
        df_type = "x0"
        if form == "dense_weighted":
            weight = np.where(x0 > 0.8, 1.75, 1.0).astype(np.float32)
    bsz = 3 if form == "graph" else 2
    mix = rng.normal(size=(x0.shape[-1], x0.shape[-1])).astype(np.float32)

    def jdenoise(noised, snr):
        e = snr[jnp.clip(jnp.asarray(bid), 0, bsz - 1)][:, None] \
            if form == "graph" else snr.reshape((bsz,) + (1,) * 4)
        return jnp.tanh(noised @ mix) * (1 + 0.1 * e)

    @jax.jit
    def jrun(key):
        loss = jsampler.diffusion_loss(
            jdenoise, key, jnp.asarray(x0),
            None if bid is None else jnp.asarray(bid), bsz,
            jschedule.get_log_snr("linear"), df_type,
            mask=None if mask is None else jnp.asarray(mask),
            elem_weight=weight)
        # the JAX draws, replicated from its key
        tkey, nkey = jax.random.split(key)
        return (loss, jax.random.uniform(tkey, (bsz,)),
                jax.random.normal(nkey, x0.shape, jnp.float32))

    ref, times, noise = (np_(a) for a in jrun(key))

    tbid = None if bid is None else torch.tensor(bid.astype(np.int64))

    def tdenoise(noised, snr):
        e = snr[tbid.clamp(0, bsz - 1)][:, None] \
            if form == "graph" else snr.reshape((bsz,) + (1,) * 4)
        return torch.tanh(noised @ torch.tensor(mix)) * (1 + 0.1 * e)

    got = tsampler.diffusion_loss(
        tdenoise, torch.tensor(x0), tbid, bsz,
        tschedule.get_log_snr("linear"), df_type,
        mask=None if mask is None else torch.tensor(mask),
        times=torch.tensor(times), noise=torch.tensor(noise),
        elem_weight=None if weight is None else torch.tensor(weight))
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-5, atol=1e-5)


def test_octree2split_small_matches_jax():
    from octfusion_tpu.octree import split_codec as jsplit
    from octfusion_tpu_torch.octree import split_codec as tsplit

    from test_torch_port_helpers import make_graph, port_octree

    jg = make_graph(seed=2, n=400)
    jo = jg.octree
    want = jax.jit(jsplit.octree2split_small)(jo)
    got = tsplit.octree2split_small(port_octree(jo))
    np.testing.assert_array_equal(np_(got), np_(want))
    occ = np_(got) > 0
    assert occ.any() and not occ.all()
    # its inverse regrows the same occupancy
    regrown = tsplit.split2octree_small(got, port_octree(jo).spec)
    np.testing.assert_array_equal(np_(tsplit.octree2split_small(regrown)),
                                  np_(want))


# ----------------------------------------------------------------------
# the train step
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def solvers():
    """Both solvers with the same reference-layout weights (seeded, none
    zero), one fixed batch and the JAX step's key.  The JAX U-Net runs
    without remat, which changes no gradient
    (``tests/test_remat_policy.py``) and costs compile time."""
    cj, ct = tiny_config(jcfg), tiny_config(tcfg)
    sj = JSolver(cj)
    sj.df = JUNetUnion(
        dataclasses.replace(sj.union_cfg, use_checkpoint=False), "hr")
    rng = np.random.RandomState(0)
    lr_sd = tru.lr_make_state_dict(rng, LR_CFG)
    hr_sd = tru.hr_make_state_dict(rng, HR_CFG, in_channels=2,
                                   out_channels=2, lr_model_channels=8)
    params = {"params": {
        "unet_lr": tc.convert_unet_lr(lr_sd, LR_CFG["channel_mult"],
                                      LR_CFG["attention_resolutions"]),
        "unet_hr": tc.convert_unet_hr(hr_sd, HR_CFG["channel_mult"],
                                      HR_CFG["num_res_blocks"])}}
    m = TINY["model"]
    vae_params = tc.convert_vae(
        tref.make_state_dict(rng, m["depth"], m["depth_stop"],
                             m["depth_out"], m["resblk_num"], m["channels"],
                             m["embed_dim"]),
        m["depth"], m["depth_stop"], m["depth_out"], m["resblk_num"])
    pts, nrm = lumpy_spheres(B, 2048, seed=3)

    def port_solver():
        st = TSolver(ct, device="cpu")
        st.df.load_state_dict(bridge.union_state_dict(params, st.union_cfg),
                              strict=True)
        st.vae.load_state_dict(bridge.vae_state_dict(
            vae_params, m["depth"], m["depth_stop"], m["depth_out"],
            m["resblk_num"]), strict=True)
        return st

    return dict(sj=sj, params=params, vae_params=vae_params,
                batch={"points": pts, "normals": nrm},
                port_solver=port_solver, key=jax.random.PRNGKey(5))


def _jax_draws(key, code_shape):
    """The encoder eps and the loss's times and noise that the JAX hr
    ``loss_fn`` draws from ``key`` (``union_solver.py:206``,
    ``sampler.py:226-228``, ``distributions.py:16-18``)."""
    @jax.jit
    def draws(key):
        ekey, dkey = jax.random.split(key)
        tkey, nkey = jax.random.split(dkey)
        return dict(eps=jax.random.normal(ekey, code_shape),
                    times=jax.random.uniform(tkey, (B,)),
                    noise=jax.random.normal(nkey, code_shape))

    return {k: torch.tensor(np_(v)) for k, v in draws(key).items()}


def _first_moment(opt_state):
    """AdamW's first moment in an optax state (one ``ScaleByAdamState``):
    after one update from zero it is (1 - b1) * grads."""
    is_adam = lambda s: isinstance(s, optax.ScaleByAdamState)
    states = [s for s in jax.tree_util.tree_leaves(opt_state, is_leaf=is_adam)
              if is_adam(s)]
    assert len(states) == 1
    return states[0].mu


def test_train_step_matches_jax(solvers):
    """One step of JAX ``make_train_step`` against the port's: the loss,
    and every trainable gradient (the JAX one read back from AdamW's first
    moment, mu = 0.1 * grads after the first update)."""
    s = solvers
    sj = s["sj"]
    tx = sj.make_optimizer()
    state = TrainState(step=jnp.asarray(0, jnp.int32), params=s["params"],
                       opt_state=tx.init(s["params"]),
                       ema_params=s["params"])
    jbatch = {k: jnp.asarray(np_(v)) for k, v in s["batch"].items()}
    new_state, ld = sj.make_train_step()(state, s["vae_params"], jbatch,
                                         s["key"])
    mu = _first_moment(new_state.opt_state)["params"]["unet_hr"]
    grads = {"params": {"unet_hr": jax.tree_util.tree_map(
        lambda m: np_(m) / np.float32(0.1), mu)}}

    st = s["port_solver"]()
    step = st.make_train_step()
    out = step(s["batch"], **_jax_draws(s["key"], st.code_shape(B)))
    np.testing.assert_allclose(float(out["loss"]), float(ld["loss"]),
                               rtol=1e-4, atol=1e-4)
    assert float(out["overflow"]) == float(ld["overflow"]) == 0.0

    ref = bridge.union_state_dict(grads, st.union_cfg)
    trainable = {n: p for n, p in st.df.named_parameters() if p.requires_grad}
    assert sorted(trainable) == sorted(ref)
    assert all(n.startswith("unet_hr.") for n in trainable)
    for n, p in trainable.items():
        assert p.grad is not None, n
        want = np_(ref[n]).reshape(p.shape)
        np.testing.assert_allclose(np_(p.grad), want, err_msg=n, **GRAD_TOL)
        err, scale = np.abs(np_(p.grad) - want).max(), np.abs(want).max()
        assert scale > 0, n
        assert err <= GRAD_SCALE_TOL * scale, (n, err, scale)
    for p in st.df.unet_lr.parameters():
        assert p.grad is None


@pytest.fixture(scope="module")
def lr_setup():
    """The lr stage of both packages with the same seeded lr U-Net, and a
    fixed batch of points."""
    rng = np.random.RandomState(1)
    params = {"params": {"unet_lr": tc.convert_unet_lr(
        tru.lr_make_state_dict(rng, LR_CFG), LR_CFG["channel_mult"],
        LR_CFG["attention_resolutions"])}}
    pts, nrm = lumpy_spheres(B, 2048, seed=6)
    return dict(params=params, batch={"points": pts, "normals": nrm},
                key=jax.random.PRNGKey(11))


@pytest.mark.parametrize("source,pos_weight", [("points", 1.0),
                                               ("points", 1.75),
                                               ("split_small", 1.75)])
def test_lr_train_step_matches_jax(lr_setup, source, pos_weight):
    """One lr step of JAX ``make_train_step`` against the port's, with the
    JAX loss's times and noise (``sampler.py:226-228``, from the step's
    key) injected; the JAX gradients read back from AdamW's first
    moment.  Nothing is frozen in the lr stage."""
    from octfusion_tpu.models.common import batch_to_octree_jit
    from octfusion_tpu.octree import split_codec as jsplit

    s = lr_setup
    cj, ct = tiny_config(jcfg), tiny_config(tcfg)
    cj = dataclasses.replace(cj, diffusion=dataclasses.replace(
        cj.diffusion, lr_pos_weight=pos_weight))
    ct = dataclasses.replace(ct, diffusion=dataclasses.replace(
        ct.diffusion, lr_pos_weight=pos_weight))
    sj = JSolver(cj, stage_flag="lr")
    jbatch = {k: jnp.asarray(np_(v)) for k, v in s["batch"].items()}
    split = jax.jit(lambda p, n: jsplit.octree2split_small(
        batch_to_octree_jit(p, n, sj.spec1)))(jbatch["points"],
                                              jbatch["normals"])
    batch = dict(s["batch"])
    if source == "split_small":
        jbatch = {"split_small": split}
        batch = {"split_small": torch.tensor(np_(split))}
    tx = sj.make_optimizer()
    state = TrainState(step=jnp.asarray(0, jnp.int32), params=s["params"],
                       opt_state=tx.init(s["params"]),
                       ema_params=s["params"])
    new_state, ld = sj.make_train_step()(state, None, jbatch, s["key"])
    grads = {"params": jax.tree_util.tree_map(
        lambda m: np_(m) / np.float32(0.1),
        _first_moment(new_state.opt_state)["params"])}

    @jax.jit
    def draws(key):
        tkey, nkey = jax.random.split(key)
        return (jax.random.uniform(tkey, (B,)),
                jax.random.normal(nkey, split.shape))

    times, noise = (torch.tensor(np_(a)) for a in draws(s["key"]))
    st = TSolver(ct, stage_flag="lr", device="cpu")
    st.df.load_state_dict(bridge.union_state_dict(s["params"], st.union_cfg),
                          strict=True)
    out = st.make_train_step()(batch, times=times, noise=noise)
    np.testing.assert_allclose(float(out["loss"]), float(ld["loss"]),
                               rtol=1e-4, atol=1e-4)
    assert sorted(out) == sorted(ld)
    if source == "points":
        assert float(out["overflow"]) == float(ld["overflow"]) == 0.0

    ref = bridge.union_state_dict(grads, st.union_cfg)
    named = dict(st.df.named_parameters())
    assert sorted(named) == sorted(ref)
    assert all(n.startswith("unet_lr.") for n in named)
    # the lr U-Net normalises per channel after its conv biases and time
    # shifts, so their exact gradients are zero and both packages return
    # fp32 rounding noise there: a leaf whose largest |gradient| is below
    # NOISE_FLOOR of the step's largest must be below it on both sides;
    # every other leaf meets the relative bound
    floor = NOISE_FLOOR * max(np.abs(np_(g)).max() for g in ref.values())
    for n, p in named.items():
        assert p.grad is not None, n
        want = np_(ref[n]).reshape(p.shape)
        np.testing.assert_allclose(np_(p.grad), want, err_msg=n, **GRAD_TOL)
        err, scale = np.abs(np_(p.grad) - want).max(), np.abs(want).max()
        if scale <= floor:
            assert np.abs(np_(p.grad)).max() <= floor, (n, scale, floor)
            continue
        assert err <= GRAD_SCALE_TOL * scale, (n, err, scale)


def test_optimizer_and_ema_match_optax(solvers):
    """Two updates from identical gradients (every leaf seeded, the frozen
    lr U-Net's too) against the JAX ``make_optimizer`` and ``ema_update``;
    the lr U-Net stays bit-identical on the port's side."""
    s = solvers
    sj, params = s["sj"], s["params"]
    tx = sj.make_optimizer()
    st = s["port_solver"]()
    step = st.make_train_step()
    lr_before = {n: p.detach().clone()
                 for n, p in st.df.unet_lr.named_parameters()}
    rate = sj.cfg.diffusion.ema_rate

    @jax.jit
    def update(grads, opt_state, p, ema):
        updates, opt_state = tx.update(grads, opt_state, p)
        p = optax.apply_updates(p, updates)
        return p, opt_state, jema.ema_update(ema, p, rate)

    rng = np.random.RandomState(9)
    jparams, opt_state, ema = params, tx.init(params), params
    for _ in range(2):
        grads = perturb(jax.tree_util.tree_map(np.zeros_like, params), rng,
                        scale=1.0)
        jparams, opt_state, ema = update(grads, opt_state, jparams, ema)
        tg = bridge.union_state_dict(jax.device_get(grads), st.union_cfg)
        for n, p in st.df.named_parameters():
            if p.requires_grad:
                p.grad = tg[n].reshape(p.shape)
        step.apply_gradients()

    want = bridge.union_state_dict(jax.device_get(jparams), st.union_cfg)
    want_ema = bridge.union_state_dict(jax.device_get(ema), st.union_cfg)
    for n, p in st.df.named_parameters():
        np.testing.assert_allclose(np_(p), np_(want[n]).reshape(p.shape),
                                   rtol=1e-6, atol=1e-6, err_msg=n)
        np.testing.assert_allclose(np_(step.ema[n]),
                                   np_(want_ema[n]).reshape(p.shape),
                                   rtol=1e-6, atol=1e-6, err_msg=n)
    for n, p in st.df.unet_lr.named_parameters():
        assert torch.equal(p, lr_before[n]), n
    assert step.scheduler.get_last_lr() == [sj.cfg.train.lr]


# ----------------------------------------------------------------------
# rematerialisation
# ----------------------------------------------------------------------
@pytest.mark.parametrize("module", ["unet_union_hr", "vae_resblocks"])
def test_use_checkpoint_keeps_gradients(module):
    pts, nrm = lumpy_spheres(1, 1024, seed=4)
    spec = tiny_config(tcfg).capacity.octree_spec(4, 2)
    _, tg = batch_to_graph(pts, nrm, spec, 10)
    d = TINY["diffusion"]
    rng = np.random.RandomState(11)

    def build(use_checkpoint):
        torch.manual_seed(0)
        if module == "vae_resblocks":
            return tmodules.GraphResBlocks(6, 6, 2, n_node_type=3,
                                           use_checkpoint=use_checkpoint)
        cfg = UnionConfig(
            input_depth=d["input_depth"], full_depth=2,
            input_channels=d["input_channels"],
            out_channels=d["out_channels"],
            model_channels=d["model_channels"],
            num_res_blocks=d["num_res_blocks"],
            channel_mult=d["channel_mult"],
            attention_resolutions=d["attention_resolutions"], num_heads=2,
            use_checkpoint=use_checkpoint)
        return UNetUnion(cfg, "hr")

    ref_net, ck_net = build(False), build(True)
    ck_net.load_state_dict(ref_net.state_dict())
    with torch.no_grad():
        for p in ref_net.parameters():
            p.add_(0.05 * torch.tensor(rng.normal(size=tuple(p.shape)),
                                       dtype=p.dtype))
    ck_net.load_state_dict(ref_net.state_dict())
    lvl = tg.level(3)
    c = 6 if module == "vae_resblocks" else 2
    x = torch.tensor(rng.normal(size=(lvl.g_cap, c)).astype(np.float32))
    t = torch.tensor([0.3])
    grads = []
    for net in (ref_net, ck_net):
        xi = x.clone().requires_grad_()
        out = (net(xi, lvl) if module == "vae_resblocks"
               else net("hr", xi, t, g=tg))
        (out**2).sum().backward()
        grads.append([xi.grad] + [p.grad for p in net.parameters()])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    assert grads[0][0].abs().sum() > 0


def test_snet_uncond_yaml_is_the_default_model():
    """The YAML the card trains on loads into the port's default
    ``Config()`` (depth 8, full width, batch 4 of 65536 points) but for
    ``capacity.edge_factor`` 10 and the dataset's location and SDF sample
    count, which the port does not read."""
    path = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                        "configs", "octfusion_snet_uncond.yaml")
    got = load_config(path)
    assert got.capacity.edge_factor == 10
    data = dataclasses.replace(got.data, location="", filelist="",
                               point_sample_num=10000)
    assert dataclasses.replace(got, data=data,
                               capacity=Config().capacity) == Config()
