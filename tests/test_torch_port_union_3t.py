"""The port's 3-stage solver (``union_3t``) against the JAX package's, on
``tests/test_union_3t.py``'s tiny configuration (depth 5, full depth 2,
depth_stop 4; U-Nets 8-16 wide), JAX side jitted:

* ``octree2split_large`` of a built octree (empty and padded rows) and
  ``split2octree_large`` of seeded splits (empty rows, set bits on padded
  rows, one split that overflows the caps): keys, ``nnum`` and the
  overflow flags exactly;
* the feature stage's forward of ``UNetUnion`` (the hr U-Net as its
  middle), weights carried across by ``utils/params.union_state_dict``, to
  rtol = atol = 1e-4;
* one hr (split_large) and one feature train step with the JAX step's
  random draws injected: the loss to 1e-4, the overflow flag, every
  trainable gradient to 1e-3 and within 1e-4 of its leaf's largest
  |gradient|; the frozen U-Nets get no gradient and stay bit for bit;
* the three-hop cascade with each stage's noise replicated from JAX's key:
  ``split_small``, ``split_large``, the codes and the SDF grid to 1e-4
  against ``Union3TSolver.sample``, the grown octrees exactly, under the
  ancestral sampler (every sign and argmax decision away from its tie)
  and under ``sampler: dpmpp`` on keys 7-14 (the few decisions near a tie
  counted); and ``dp_cascade`` (one shape,
  data-parallel generation's body) against JAX's;
* ``configs/octfusion_obja_uncond.yaml`` alone fails both packages'
  assertion, and its merge with ``configs/vae_obja_depth1084.yaml``
  builds in both."""

import dataclasses
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from octfusion_tpu import config as jcfg
from octfusion_tpu.models.common import TrainState
from octfusion_tpu.models.union_3t_solver import Union3TSolver as JSolver
from octfusion_tpu.nn.unet_union import UNetUnion as JUNetUnion
from octfusion_tpu.octree import split_codec as jsplit
from octfusion_tpu.ops import mpu as jmpu
from octfusion_tpu.utils import torch_convert as tc
from octfusion_tpu_torch import config as tcfg
from octfusion_tpu_torch.models.union_3t_solver import Union3TSolver as TSolver
from octfusion_tpu_torch.nn.unet_union import UNetUnion
from octfusion_tpu_torch.octree import split_codec as tsplit
from octfusion_tpu_torch.octree.dual_graph import GraphSpec
from octfusion_tpu_torch.octree.dual_graph import build_dual_graph as t_build
from octfusion_tpu_torch.utils import params as bridge
from octfusion_tpu_torch.utils.shapes import lumpy_spheres

import torch_ref_unet as tru
import torch_ref_vae as tref
from test_torch_port_helpers import (LR_OUT_GAIN, assert_octree_equal,
                                     make_graph, np_, port_octree,
                                     random_split)
from test_torch_port_helpers import one_torch_thread  # noqa: F401
from test_torch_port_train import (GRAD_SCALE_TOL, GRAD_TOL, _first_moment,
                                   _jax_draws)

pytestmark = pytest.mark.usefixtures("one_torch_thread")
TOL = dict(rtol=1e-4, atol=1e-4)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 2
STEPS = 3
RES = 16
MODEL = dict(depth=5, full_depth=2, depth_stop=4, depth_out=5, embed_dim=2,
             resblk_num=1, channels=(4, 8, 8, 8, 8, 8), use_checkpoint=False)
DIFF = dict(ddim_steps=4, unet_type=("lr", "hr", "feature"),
            df_type=("x0", "x0", "x0"), input_depth=(2, 3, 4),
            input_channels=(8, 8, 2), out_channels=(8, 8, 2),
            model_channels=(8, 16, 16), num_res_blocks=((1, 1), (1, 0), (1, 0)),
            channel_mult=((1, 2), (1, 1), (1, 1)), attention_resolutions=(2,))
LR_CFG = {"model_channels": 8, "channel_mult": (1, 2),
          "attention_resolutions": (2,)}
HR_CFG = {"model_channels": 16, "channel_mult": (1, 1),
          "num_res_blocks": (1, 0), "input_depth": 3, "full_depth": 2}
FEAT_CFG = dict(HR_CFG, input_depth=4)


def tiny_3t(mod, sampler="ancestral"):
    """``tests/test_union_3t.tiny_3t_config`` in module ``jcfg`` or
    ``tcfg``, sampling with ``sampler``."""
    return mod.Config(
        solver=mod.SolverConfig(resolution=RES),
        model=mod.VAEConfig(**MODEL),
        capacity=mod.CapacityConfig(finest_cap=4096, decay=1.0),
        data=mod.DataConfig(name="synthetic", batch_size=B,
                            point_sample_num=128, points_per_shape=2048),
        diffusion=mod.DiffusionConfig(**DIFF, sampler=sampler),
        train=mod.TrainConfig(lr=1e-3))


@pytest.fixture(scope="module")
def weights():
    """Seeded reference-layout weights of the three U-Nets and the VAE, in
    the JAX package's trees."""
    rng = np.random.RandomState(0)
    params = {"params": {
        "unet_lr": tc.convert_unet_lr(tru.lr_make_state_dict(rng, LR_CFG),
                                      LR_CFG["channel_mult"],
                                      LR_CFG["attention_resolutions"]),
        "unet_hr": tc.convert_unet_hr(
            tru.hr_make_state_dict(rng, HR_CFG, in_channels=8,
                                   out_channels=8, lr_model_channels=8),
            HR_CFG["channel_mult"], HR_CFG["num_res_blocks"]),
        "unet_feature": tc.convert_unet_hr(
            tru.hr_make_state_dict(rng, FEAT_CFG, in_channels=2,
                                   out_channels=2, lr_model_channels=16),
            FEAT_CFG["channel_mult"], FEAT_CFG["num_res_blocks"])}}
    # widen the lr outputs so that few sit near the sign-snap tie
    out = params["params"]["unet_lr"]["out"]["conv"]
    out["kernel"] = out["kernel"] * LR_OUT_GAIN
    m = MODEL
    arch = (m["depth"], m["depth_stop"], m["depth_out"], m["resblk_num"])
    vae = tc.convert_vae(
        tref.make_state_dict(rng, *arch[:3], m["resblk_num"], m["channels"],
                             m["embed_dim"]), *arch)
    return params, vae, arch


def stage_params(params, stage):
    kinds = {"hr": ("lr", "hr"), "feature": ("lr", "hr", "feature")}[stage]
    return {"params": {f"unet_{k}": params["params"][f"unet_{k}"]
                       for k in kinds}}


def solvers(weights, stage, sampler="ancestral"):
    """The JAX solver (no remat: it changes no value and costs compile
    time) and the port solver of ``stage`` with the same weights."""
    params, vae, arch = weights
    sj = JSolver(tiny_3t(jcfg, sampler), stage)
    sj.df = JUNetUnion(
        dataclasses.replace(sj.union_cfg, use_checkpoint=False), stage)
    st = TSolver(tiny_3t(tcfg, sampler), stage, device="cpu")
    st.df.load_state_dict(bridge.union_state_dict(
        stage_params(params, stage), st.union_cfg), strict=True)
    st.vae.load_state_dict(bridge.vae_state_dict(vae, *arch), strict=True)
    return sj, st


# ----------------------------------------------------------------------
# the split_large codec
# ----------------------------------------------------------------------
def test_octree2split_large_matches_jax():
    jg = make_graph(seed=2, depth=5, full_depth=2, n=500)
    o = jg.octree
    want = jax.jit(jsplit.octree2split_large, static_argnums=1)(o, 3)
    got = tsplit.octree2split_large(port_octree(o), 3)
    np.testing.assert_array_equal(np_(got), np_(want))
    valid = np_(o.node_mask(3))
    rows = np_(got)
    assert (rows[~valid] == -1).all() and (~valid).any()
    assert ((rows[valid] == -1).all(1)).any()       # empty nodes
    assert (rows > 0).any()


@pytest.mark.parametrize("p", [0.02, 0.5], ids=["sparse", "overflowing"])
def test_split2octree_large_matches_jax(p):
    """From the depth-3 octree a split grid grows (as the cascade's grow6
    gives it), seeded split vectors with empty rows and set bits on padded
    rows: the grown octrees equal exactly; at p = 0.5 depth 4 overflows."""
    rng = np.random.RandomState(int(p * 100))
    cfg = tiny_3t(jcfg)
    spec = cfg.capacity.octree_spec(5, 2, 1)
    small = jax.jit(lambda s: jsplit.split2octree_small(s, spec))(
        jnp.asarray(random_split(rng, 1, 4, 0.3)))
    cap = spec.node_caps[3]
    split = np.where(rng.rand(cap, 8) < p, 1.0, -1.0).astype(np.float32)
    n3 = int(small.nnum[3])
    split[rng.rand(cap) < 0.3] = -1.0
    split[n3:] = 1.0            # must not grow: padded rows
    want = jax.jit(jsplit.split2octree_large, static_argnums=2)(
        small, jnp.asarray(split), 3)
    got = tsplit.split2octree_large(port_octree(small), torch.tensor(split),
                                    3)
    assert_octree_equal(got, want)
    assert bool(np_(want.overflow).any()) == (p == 0.5)
    assert int(want.nnum[5]) > 0


# ----------------------------------------------------------------------
# the feature stage's U-Net
# ----------------------------------------------------------------------
def test_feature_forward_matches_jax(weights):
    params = weights[0]
    jg = make_graph(seed=4, depth=5, full_depth=2, n=400, up_to=4)
    tg = t_build(port_octree(jg.octree), 9, up_to=4)
    jc = JSolver(tiny_3t(jcfg), "feature").union_cfg
    jm = JUNetUnion(dataclasses.replace(jc, use_checkpoint=False), "feature")
    tm = UNetUnion(TSolver(tiny_3t(tcfg), "lr", device="cpu").union_cfg,
                   "feature")
    tm.load_state_dict(bridge.union_state_dict(params, tm.config),
                       strict=True)
    rng = np.random.RandomState(3)
    x = rng.normal(size=(tg.level(4).g_cap, 2)).astype(np.float32)
    t = np.array([0.7], np.float32)
    ref = jax.jit(lambda p, x, t, g: jm.apply(p, "feature", x, t, g=g))(
        params, jnp.asarray(x), jnp.asarray(t), jg)
    with torch.no_grad():
        got = tm("feature", torch.tensor(x), torch.tensor(t), g=tg)
    assert np.abs(np_(ref)).max() > 0.1
    np.testing.assert_allclose(np_(got), np_(ref), **TOL)


# ----------------------------------------------------------------------
# the train steps
# ----------------------------------------------------------------------
@pytest.mark.parametrize("stage", ["hr", "feature"])
def test_train_step_matches_jax(weights, stage):
    """One step of JAX ``make_train_step`` against the port's, with the
    JAX loss's draws (hr: times and noise from the step's key; feature:
    the encoder's eps, then times and noise, ``union_3t_solver.py:
    109-147``); the JAX gradients read back from AdamW's first moment."""
    params = stage_params(weights[0], stage)
    sj, st = solvers(weights, stage)
    pts, nrm = lumpy_spheres(B, 2048, seed=3)
    key = jax.random.PRNGKey(5)
    tx = sj.make_optimizer()
    state = TrainState(step=jnp.asarray(0, jnp.int32), params=params,
                       opt_state=tx.init(params), ema_params=params)
    jbatch = {"points": jnp.asarray(np_(pts)), "normals": jnp.asarray(np_(nrm))}
    new_state, ld = sj.make_train_step()(state, weights[1], jbatch, key)
    mu = _first_moment(new_state.opt_state)["params"][f"unet_{stage}"]
    grads = {"params": {f"unet_{stage}": jax.tree_util.tree_map(
        lambda m: np_(m) / np.float32(0.1), mu)}}

    shape = st.train_shape(B)
    if stage == "feature":
        draws = _jax_draws(key, shape)
    else:
        @jax.jit
        def hr_draws(key):
            tkey, nkey = jax.random.split(key)
            return dict(times=jax.random.uniform(tkey, (B,)),
                        noise=jax.random.normal(nkey, shape))

        draws = {k: torch.tensor(np_(v)) for k, v in hr_draws(key).items()}
    frozen = {n: p.detach().clone() for n, p in st.df.named_parameters()
              if not n.startswith(f"unet_{stage}.")}
    out = st.make_train_step()({"points": pts, "normals": nrm}, **draws)
    np.testing.assert_allclose(float(out["loss"]), float(ld["loss"]),
                               rtol=1e-4, atol=1e-4)
    assert float(out["overflow"]) == float(ld["overflow"]) == 0.0

    ref = bridge.union_state_dict(grads, st.union_cfg)
    named = dict(st.df.named_parameters())
    trainable = {n: p for n, p in named.items() if p.requires_grad}
    assert sorted(trainable) == sorted(ref)
    assert all(n.startswith(f"unet_{stage}.") for n in trainable)
    for n, p in trainable.items():
        want = np_(ref[n]).reshape(p.shape)
        np.testing.assert_allclose(np_(p.grad), want, err_msg=n, **GRAD_TOL)
        err, scale = np.abs(np_(p.grad) - want).max(), np.abs(want).max()
        assert scale > 0, n
        assert err <= GRAD_SCALE_TOL * scale, (n, err, scale)
    # the frozen U-Nets: no gradient, and bit for bit after the step
    assert sorted({n.split(".")[0] for n in frozen}) == (
        ["unet_lr"] if stage == "hr" else ["unet_hr", "unet_lr"])
    for n, before in frozen.items():
        assert named[n].grad is None, n
        assert torch.equal(named[n], before), n


# ----------------------------------------------------------------------
# the three-hop cascade
# ----------------------------------------------------------------------
@jax.jit
def _stage_keys(key):
    return jax.random.split(key, 3)


def jax_stream(key, shape, steps):
    """The noise ``sampler.sample_loop`` draws from ``key`` (its initial
    state, then one draw per step), as a stream."""
    @jax.jit
    def draw(key):
        key, nkey = jax.random.split(key)
        first = jax.random.normal(nkey, shape, jnp.float32)
        rest = jax.vmap(lambda k: jax.random.normal(k, shape, jnp.float32))(
            jax.random.split(key, steps))
        return jnp.concatenate([first[None], rest])

    return np.array(draw(key))


def test_cascade_matches_jax(weights):
    near = check_cascade(weights, solvers(weights, "feature"), seed=7)
    assert not any(near.values()), near


@pytest.fixture(scope="module")
def dpmpp_solvers(weights):
    """The dpmpp solvers, shared by the keys: JAX compiles the cascade
    once."""
    return solvers(weights, "feature", "dpmpp")


@pytest.mark.parametrize("seed", range(7, 15))
def test_dpmpp_cascade_matches_jax(weights, dpmpp_solvers, seed):
    """The cascade under ``sampler: dpmpp`` (DPM-Solver++(2M), which draws
    only each stage's initial state) on keys 7-14, with the ancestral
    test's tolerances: every key holds split_small, split_large, the
    codes, the grid and the decoded octree.  A decision that sits within
    its margin of a tie is counted, not held; keys 7-13 have one to four
    (depth-4 split logits, one 2e-6 from its tie; an lr output;
    split_large signs) among thousands, key 14 none.  More than eight
    would mean the packages' difference grew (it is 2e-5 on split_large
    and the codes here, 1e-5 under the ancestral sampler)."""
    near = check_cascade(weights, dpmpp_solvers, seed)
    assert sum(near.values()) <= 8, near


def check_cascade(weights, pair, seed):
    """The 3-hop cascade of key ``seed`` from the feature-stage solvers
    ``pair`` (JAX's, the port's) -> the number of decisions within their
    margin of a tie, per kind."""
    sj, st = pair
    params, vae = weights[0], weights[1]
    key = jax.random.PRNGKey(seed)
    want = sj.sample(params, vae, key, batch_size=1, steps=STEPS,
                     resolution=RES)

    k1, k2, k3 = _stage_keys(key)
    gspec = GraphSpec(st.spec1, st.edge_factor)
    lr = jax_stream(k1, (1, 4, 4, 4, 8), STEPS).transpose(0, 1, 5, 2, 3, 4)
    hr = jax_stream(k2, (gspec.g_cap(3), 8), STEPS)
    feat = jax_stream(k3, (gspec.g_cap(4), 2), STEPS)
    pre_snap = []

    def record(mod, args, kwargs, out):
        if not kwargs.get("as_middle", False):
            pre_snap.append(np_(out))

    hook = st.df.unet_lr.register_forward_hook(record, with_kwargs=True)
    try:
        got = st.sample(steps=STEPS, resolution=RES, lr_noise=lr,
                        hr_noise=hr, feature_noise=feat)
    finally:
        hook.remove()

    # the decisions and their margins from the tie: the lr outputs at the
    # snapped steps (t < 0.7) by 1e-3; split_large's signs on the valid
    # depth-3 nodes by ten times the packages' largest difference there,
    # the decoder's depth-4 split logits by twenty times (thousands of
    # entries: the nearest sits ~1e-3 from its tie); outside its margin a
    # decision is the same in both packages, inside it fp32 rounding
    # could flip it
    snapped = [o for i, o in enumerate(pre_snap) if 1 - i / STEPS < 0.7]
    assert snapped
    near = {"lr": int(sum((np.abs(o) <= 1e-3).sum() for o in snapped))}
    g6 = got["graph_small"]
    cur = np_(got["split_large"])[gspec.cur_off(3):]
    wcur = np_(want["split_large"])[gspec.cur_off(3):]
    valid = np.broadcast_to(np_(g6.octree.node_mask(3))[:, None], cur.shape)
    diff = np.abs(cur - wcur).max()
    far = valid & (np.abs(cur) > 10 * diff)
    assert (np.sign(cur) == np.sign(wcur))[far].all()
    near["split_large"] = int((valid & ~far).sum())
    lg = np_(got["decode_out"]["logits"][4])
    wlg = np_(want["decode_out"]["logits"][4])
    diff = np.abs(lg - wlg).max()
    valid = np_(got["graph"].level(4).node_mask)[-lg.shape[0]:]
    far = valid & (np.abs(lg[:, 1] - lg[:, 0]) > 20 * diff)
    assert (lg.argmax(1) == wlg.argmax(1))[far].all()
    near["split_logits"] = int((valid & ~far).sum())

    for k in ("split_small", "split_large", "code"):
        np.testing.assert_allclose(np_(got[k]), np_(want[k]), err_msg=k,
                                   **TOL)
    # the JAX grid is the fp32 grid of its decode stored in fp16, within
    # one fp16 step of it (``utils/sdf._sdf_grid_dense``); the port's
    # holds to the fp32 grid
    dec = want["decode_out"]
    grid = np_(jax.jit(lambda r, o: jmpu.mpu_grid_eval(
        r, o, 2, 5, RES, -0.9, 0.9))(dec["reg_voxs"][5], dec["octree_out"]))
    np.testing.assert_allclose(np_(want["sdfs"]), grid, rtol=2.0**-10,
                               atol=2.0**-24)
    np.testing.assert_allclose(np_(got["sdfs"]), grid, **TOL)
    assert_octree_equal(got["decode_out"]["octree_out"],
                        want["decode_out"]["octree_out"])
    assert bool(got["overflow"]) == bool(want["overflow"])
    assert set(got["seconds"]) == {"lr", "grow6", "hr", "grow8", "feature",
                                   "decode", "sdf"}
    # the hr stage grows the lr split to input_depth[1], not depth_stop
    assert got["graph_small"].last_depth == 3
    assert got["graph"].last_depth == 4
    assert np.isfinite(np_(got["sdfs"])).all()
    return near


def assert_dp_cascade_equal(got, want):
    """A port ``dp_cascade``'s dict against JAX's: the decoded octree
    exactly, every depth's split logits and the last depth's planes to the
    cascade's tolerance, the decoded graph's overflow flag as JAX's (the
    random weights may split past a cap: both packages truncate alike)."""
    assert_octree_equal(got["octree_out"], want["octree_out"])
    assert sorted(got["logits"]) == sorted(want["logits"])
    for d in want["logits"]:
        np.testing.assert_allclose(np_(got["logits"][d]),
                                   np_(want["logits"][d]), err_msg=str(d),
                                   **TOL)
    last = max(want["reg_voxs"])
    for dd, r in want["reg_voxs"][last].items():
        np.testing.assert_allclose(np_(got["reg_voxs"][last][dd]), np_(r),
                                   err_msg=f"{last}/{dd}", **TOL)
    assert bool(got["graph_out"].any_overflow()) == bool(
        want["graph_out"].any_overflow())


def test_dp_cascade_matches_jax(weights):
    """One shape's ``dp_cascade`` (the per-rank body of data-parallel
    generation) against JAX's, each stage's noise the stream JAX draws
    from its split key."""
    sj, st = solvers(weights, "feature")
    params, vae = weights[0], weights[1]
    key = jax.random.PRNGKey(11)
    want = jax.jit(lambda p, v, k: sj.dp_cascade(p, v, k, steps=STEPS))(
        params, vae, key)
    k1, k2, k3 = _stage_keys(key)
    gspec = GraphSpec(st.spec1, st.edge_factor)
    got = st.dp_cascade(
        steps=STEPS,
        lr_noise=jax_stream(k1, (1, 4, 4, 4, 8), STEPS).transpose(
            0, 1, 5, 2, 3, 4),
        hr_noise=jax_stream(k2, (gspec.g_cap(3), 8), STEPS),
        feature_noise=jax_stream(k3, (gspec.g_cap(4), 2), STEPS))
    assert_dp_cascade_equal(got, want)


# ----------------------------------------------------------------------
# the Objaverse configuration
# ----------------------------------------------------------------------
OBJA = os.path.join(REPO, "configs", "octfusion_obja_uncond.yaml")
VAE10 = os.path.join(REPO, "configs", "vae_obja_depth1084.yaml")


@pytest.mark.parametrize("merged", [False, True], ids=["alone", "merged"])
def test_obja_config(merged):
    """``octfusion_obja_uncond.yaml`` alone sets depth_stop 6 under an
    ``input_depth[2]`` of 8: both packages refuse it.  Over the depth-10
    VAE's ``model`` and ``capacity`` both build (no forward pass)."""
    cj, ct = jcfg.load_config(OBJA), tcfg.load_config(OBJA)
    if not merged:
        with pytest.raises(AssertionError):
            JSolver(cj, "feature")
        with pytest.raises(AssertionError):
            TSolver(ct, "feature", device="cpu")
        return
    vj = jcfg.load_config(VAE10)
    cj = dataclasses.replace(cj, model=vj.model, capacity=vj.capacity)
    ct = tcfg.with_vae(ct, tcfg.load_config(VAE10))
    assert dataclasses.asdict(ct.model) == dataclasses.asdict(cj.model)
    sj = JSolver(cj, "feature")
    st = TSolver(ct, "feature", device="cpu")
    assert (st.hr_depth, st.code_depth, st.small_depth) == (6, 8, 6)
    assert (sj.hr_depth, sj.code_depth) == (6, 8)
    assert st.spec1.node_caps == sj.spec1.node_caps
    assert st.spec1.node_caps[10] == 1048576
    nets = {n: sum(p.numel() for p in getattr(st.df, f"unet_{n}").parameters())
            for n in ("lr", "hr", "feature")}
    assert all(v > 0 for v in nets.values())
