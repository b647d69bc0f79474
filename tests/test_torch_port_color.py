"""The port's colour VAE against the JAX package's, on the CPU at the tiny
size (``configs/synthetic_tiny.yaml``'s model with ``channel_in`` 7 and
``loss.name: color``, as ``tests/test_color.py``), from the same seeded
inputs and weights (flax's init perturbed with seeded noise, so no layer
is zero, through ``utils/params.vae_state_dict`` into the port):

* ``build_octree(features=)`` / ``batch_to_octree``: every node's signal,
  the averaged colours included, exactly;
* ``mpu_interp``: random per-node values (1e-6: the same fp32 blend) and
  the constant field of ``tests/test_color.py`` (0.25 to 1e-4 where the
  field is covered);
* the VAE forward's ``colors`` on the fixed topology and growing (1e-4:
  fp32 through ~15 layers, as ``test_torch_port_vae_train.py``);
* ``geometry_color_loss`` on the same decoded arrays (1e-5 relative:
  sums of the same fp32 terms in another order);
* one colour-VAE train step against JAX ``make_train_step`` with its
  posterior draw injected: every loss term (1e-4) and every gradient
  (1e-3, and each leaf's largest error within 1e-4 of its largest
  |gradient|), the colour heads' included;
* the train CLI for 2 CPU steps on a synthetic colour set, then its
  reconstruction."""

import dataclasses
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch

from octfusion_tpu.data.dataset import SyntheticDataset as JDataset
from octfusion_tpu.data.dataset import collate as jcollate
from octfusion_tpu.models.common import TrainState
from octfusion_tpu.models.common import batch_to_graph_jit as jbatch_to_graph
from octfusion_tpu.models.vae_solver import VAESolver as JSolver
from octfusion_tpu.nn import losses as jlosses
from octfusion_tpu.octree import octree as joctree
from octfusion_tpu.ops import mpu as jmpu
from octfusion_tpu_torch import config as config_lib
from octfusion_tpu_torch import train as ttrain
from octfusion_tpu_torch.models.common import batch_to_graph, batch_to_octree
from octfusion_tpu_torch.models.vae_solver import VAESolver as TSolver
from octfusion_tpu_torch.nn import losses as tlosses
from octfusion_tpu_torch.octree import octree as toctree
from octfusion_tpu_torch.ops import mpu as tmpu
from octfusion_tpu_torch.utils import ckpt as ckpt_lib
from octfusion_tpu_torch.utils import params as bridge

from test_torch_port_helpers import (TINY, assert_octree_equal, jcfg, np_,
                                     one_torch_thread, perturb, port_octree,
                                     tcfg, tiny_config)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL_OUT = dict(rtol=1e-4, atol=1e-4)
TOL_INTERP = dict(rtol=1e-6, atol=1e-6)
TOL_LOSS = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-3, atol=1e-3)
GRAD_SCALE_TOL = 1e-4
B = 2
N_POINTS, N_SDF = 1024, 64
TOTAL_STEPS = 10
M = TINY["model"]
VAE_ARGS = (M["depth"], M["depth_stop"], M["depth_out"], M["resblk_num"])
FD, DS, DOUT = M["full_depth"], M["depth_stop"], M["depth_out"]


def color_config(mod):
    """The tiny configuration's colour VAE in module ``jcfg`` or ``tcfg``."""
    cfg = tiny_config(mod)
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, channel_in=7),
        loss=dataclasses.replace(cfg.loss, name="color"),
        data=dataclasses.replace(cfg.data, load_color=True))


@pytest.fixture(scope="module")
def setup():
    sj = JSolver(color_config(jcfg))
    ds = JDataset(size=B, point_sample_num=N_SDF, points_per_shape=N_POINTS,
                  load_color=True)
    batch = {k: v for k, v in jcollate([ds[i] for i in range(B)]).items()
             if k != "filename"}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.PRNGKey(0)
    params = perturb(sj.init_state(key, jb, TOTAL_STEPS).params,
                     np.random.RandomState(1))
    tb = {k: torch.tensor(v) for k, v in batch.items()}
    tb["label"] = tb["label"].to(torch.int64)

    def port_solver():
        st = TSolver(color_config(tcfg), device="cpu")
        st.vae.load_state_dict(bridge.vae_state_dict(params, *VAE_ARGS),
                               strict=True)
        return st

    _, jg = jbatch_to_graph(jb["points"], jb["normals"], sj.spec1,
                            sj.edge_factor, features=jb["point_colors"])
    return dict(sj=sj, jb=jb, tb=tb, params=params, key=key,
                port_solver=port_solver, jg=jg)


def _sphere(rng, n):
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return v


def test_build_octree_features_exact():
    """One sample's octree with 3 and 5 feature channels, and a batch
    through ``batch_to_octree``: keys, children, counts and every signal
    channel equal JAX's bit for bit.  JAX runs eagerly: under ``jax.jit``
    XLA's fusion moves the ND channels (not the features) by an ulp."""
    rng = np.random.RandomState(0)
    jspec = joctree.OctreeSpec.create(5, 2, 1, finest_cap_per_sample=4096,
                                      decay=1.0)
    tspec = toctree.OctreeSpec(jspec.depth, jspec.full_depth, 1,
                               jspec.node_caps)
    for f in (3, 5):
        v = _sphere(rng, 700)
        pts = (0.6 * v).astype(np.float32)
        feat = rng.uniform(0, 1, size=(700, f)).astype(np.float32)
        want = joctree.build_octree(
            jnp.asarray(pts), jnp.asarray(v.astype(np.float32)), jspec,
            jnp.asarray(feat))
        got = toctree.build_octree(torch.tensor(pts),
                                   torch.tensor(v.astype(np.float32)), tspec,
                                   torch.tensor(feat))
        assert_octree_equal(got, want)
        assert got.signal.shape == (jspec.node_caps[5], 4 + f)
        np.testing.assert_array_equal(np_(got.signal), np_(want.signal))
        assert np.abs(np_(got.signal[:, 4:])).max() > 0

    s = JSolver(color_config(jcfg)).spec1
    ds = JDataset(size=B, point_sample_num=N_SDF, points_per_shape=N_POINTS,
                  load_color=True)
    b = jcollate([ds[i] for i in range(B)])
    p, n, c = (jnp.asarray(b[k]) for k in ("points", "normals",
                                           "point_colors"))
    want = joctree.merge_octrees([joctree.build_octree(p[i], n[i], s, c[i])
                                  for i in range(B)])
    tspec1 = toctree.OctreeSpec(s.depth, s.full_depth, 1, s.node_caps)
    got = batch_to_octree(torch.tensor(b["points"]),
                          torch.tensor(b["normals"]), tspec1,
                          torch.tensor(b["point_colors"]))
    assert_octree_equal(got, want)
    np.testing.assert_array_equal(np_(got.signal), np_(want.signal))


def test_mpu_interp_matches_jax(setup):
    """Random per-node values on the colour batch's octree, at every
    target depth, against JAX's blend."""
    jo = setup["jg"].octree
    to = port_octree(jo)
    rng = np.random.RandomState(2)
    pos = rng.uniform(-0.7, 0.7, size=(300, 3)).astype(np.float32)
    pb = rng.randint(0, B, size=300).astype(np.int32)
    vals = {dd: rng.normal(size=(jo.spec.node_caps[dd], 3)).astype(
        np.float32) for dd in range(FD, DOUT + 1)}
    for d in range(DS, DOUT + 1):
        want = jax.jit(lambda p, b, v, o: jmpu.mpu_interp(p, b, v, o, FD, d))(
            pos, pb, vals, jo)
        got = tmpu.mpu_interp(torch.tensor(pos), torch.tensor(pb).long(),
                              {k: torch.tensor(v) for k, v in vals.items()},
                              to, FD, d)
        np.testing.assert_allclose(np_(got), np_(want), **TOL_INTERP)
        assert np.abs(np_(got)).max() > 0


def test_mpu_interp_constant_field():
    """``tests/test_color.py``'s constant field: a constant per-node value
    interpolates to itself (partition of unity), on the port and JAX."""
    rng = np.random.RandomState(0)
    v = _sphere(rng, 300)
    jspec = joctree.OctreeSpec.create(4, 2, 1, finest_cap_per_sample=2048,
                                      decay=1.0)
    jo = joctree.build_octree(jnp.asarray((0.6 * v).astype(np.float32)),
                              jnp.asarray(v.astype(np.float32)), jspec)
    to = port_octree(jo)
    vals = {dd: torch.full((jspec.node_caps[dd], 3), 0.25)
            for dd in range(2, 5)}
    pos = rng.uniform(-0.5, 0.5, size=(32, 3)).astype(np.float32)
    got = tmpu.mpu_interp(torch.tensor(pos), torch.zeros(32, dtype=torch.long),
                          vals, to, 2, 4)
    np.testing.assert_allclose(np_(got), 0.25, atol=1e-4)
    want = jmpu.mpu_interp(jnp.asarray(pos), jnp.zeros((32,), jnp.int32),
                           {k: jnp.asarray(np_(x)) for k, x in vals.items()},
                           jo, 2, 4)
    np.testing.assert_allclose(np_(got), np_(want), **TOL_INTERP)


def _eps(key, shape):
    """The posterior draw the JAX ``GraphVAE.__call__`` takes from
    ``key``."""
    return torch.tensor(np_(jax.jit(
        lambda k: jax.random.normal(k, shape))(key)))


@pytest.mark.parametrize("topology", ["fixed", "grow"])
def test_forward_colors_match_jax(setup, topology):
    s = setup
    sj, st = s["sj"], s["port_solver"]()
    fixed = topology == "fixed"
    want = jax.jit(lambda p, g, k: sj.vae.apply(
        p, g, g if fixed else None, k))(s["params"], s["jg"], s["key"])
    g = batch_to_graph(s["tb"]["points"], s["tb"]["normals"], st.spec1,
                       st.edge_factor, features=s["tb"]["point_colors"])[1]
    with torch.no_grad():
        got = st.vae(g, g if fixed else None,
                     eps=_eps(s["key"], tuple(want["code"].shape)))
    assert_octree_equal(got["octree_out"], want["octree_out"])
    assert sorted(got["colors"]) == sorted(want["colors"]) == list(
        range(DS, DOUT + 1))
    for d in want["colors"]:
        np.testing.assert_allclose(np_(got["logits"][d]),
                                   np_(want["logits"][d]), **TOL_OUT)
        for dd, c in want["colors"][d].items():
            assert got["colors"][d][dd].shape == (c.shape[0], 3)
            np.testing.assert_allclose(np_(got["colors"][d][dd]), np_(c),
                                       err_msg=f"{d}/{dd}", **TOL_OUT)
        assert np.abs(np_(got["colors"][d][d])).max() > 0


def test_geometry_color_loss_matches_jax(setup):
    """Both packages' loss on the same seeded decoder arrays over the
    colour batch's octree and the same supervision."""
    s = setup
    jo = s["jg"].octree
    to = port_octree(jo)
    rng = np.random.RandomState(3)
    caps = jo.spec.node_caps
    arr = lambda n, c: rng.normal(size=(n, c)).astype(np.float32)
    logits = {d: arr(caps[d], 2) for d in range(DS, DOUT + 1)}
    reg = {d: {dd: 0.3 * arr(caps[dd], 4) for dd in range(FD, d + 1)}
           for d in range(DS, DOUT + 1)}
    col = {d: {dd: arr(caps[dd], 3) for dd in range(FD, d + 1)}
           for d in range(DS, DOUT + 1)}
    jb = s["jb"]
    m, k = N_SDF, 500
    sup = dict(
        pos=np_(jb["pos"]).reshape(-1, 3),
        pb=np.repeat(np.arange(B), m).astype(np.int32),
        sdf=np_(jb["sdf"]).reshape(-1), grad=np_(jb["grad"]).reshape(-1, 3),
        cpos=np_(jb["points"])[:, :k].reshape(-1, 3),
        cb=np.repeat(np.arange(B), k).astype(np.int32),
        cgt=np_(jb["point_colors"])[:, :k].reshape(-1, 3))
    order = ("pos", "pb", "sdf", "grad", "cpos", "cb", "cgt")

    def jloss(lg, rg, cl, o, *a):
        out = {"logits": lg, "reg_voxs": rg, "colors": cl, "octree_out": o,
               "kl_loss": jnp.float32(0.7)}
        return jlosses.geometry_color_loss(out, *a, FD, DS, DOUT)

    want = jax.jit(jloss)(logits, reg, col, jo, *(sup[n] for n in order))
    tt = lambda x: torch.tensor(x)
    tsup = {n: tt(sup[n]).long() if n in ("pb", "cb") else tt(sup[n])
            for n in order}
    got = tlosses.geometry_color_loss(
        {"logits": {d: tt(v) for d, v in logits.items()},
         "reg_voxs": {d: {dd: tt(v) for dd, v in r.items()}
                      for d, r in reg.items()},
         "colors": {d: {dd: tt(v) for dd, v in c.items()}
                    for d, c in col.items()},
         "octree_out": to, "kl_loss": torch.tensor(0.7)},
        *(tsup[n] for n in order), FD, DS, DOUT)
    assert sorted(got) == sorted(want)
    assert list(got)[-1] == "loss"
    for name in want:
        np.testing.assert_allclose(np_(got[name]), np_(want[name]),
                                   err_msg=name, **TOL_LOSS)
    for d in range(DS, DOUT + 1):
        assert float(got[f"color_loss_{d}"]) > 0


def _first_moment(opt_state):
    is_adam = lambda x: isinstance(x, optax.ScaleByAdamState)
    states = [x for x in jax.tree_util.tree_leaves(opt_state, is_leaf=is_adam)
              if is_adam(x)]
    assert len(states) == 1
    return states[0].mu


def test_color_train_step_matches_jax(setup):
    """One step of JAX ``make_train_step`` (``tests/test_color.py``'s
    step) against the port's, the JAX gradients read back from AdamW's
    first moment (mu = 0.1 * grads after the first update)."""
    s = setup
    sj = s["sj"]
    tx = sj.make_optimizer(TOTAL_STEPS)
    state = TrainState(step=jnp.asarray(0, jnp.int32), params=s["params"],
                       opt_state=tx.init(s["params"]))
    new_state, ld = sj.make_train_step(TOTAL_STEPS)(state, s["jb"], s["key"])
    grads = jax.tree_util.tree_map(lambda m: np_(m) / np.float32(0.1),
                                   _first_moment(new_state.opt_state))

    st = s["port_solver"]()
    before = {n: p.detach().clone() for n, p in st.vae.named_parameters()}
    out = st.make_train_step(TOTAL_STEPS)(s["tb"],
                                          eps=_eps(s["key"], st.code_shape(B)))
    assert sorted(out) == sorted(ld)
    for k in ld:
        np.testing.assert_allclose(np_(out[k]), np_(ld[k]), err_msg=k,
                                   **TOL_OUT)
    for d in range(DS, DOUT + 1):
        assert float(out[f"color_loss_{d}"]) > 0
    assert float(out["overflow"]) == 0.0

    ref = bridge.vae_state_dict(grads, *VAE_ARGS)
    named = dict(st.vae.named_parameters())
    assert sorted(named) == sorted(ref)
    assert any(n.startswith("color.") for n in named)
    for n, p in named.items():
        want = np_(ref[n]).reshape(p.shape)
        np.testing.assert_allclose(np_(p.grad), want, err_msg=n, **GRAD_TOL)
        err, scale = np.abs(np_(p.grad) - want).max(), np.abs(want).max()
        assert scale > 0, n
        assert err <= GRAD_SCALE_TOL * scale, (n, err, scale)
    # the colour heads were updated
    w = "color.0.1.linear.weight"
    assert not torch.equal(named[w].detach(), before[w])


def test_train_cli_trains_the_color_vae(tmp_path, capsys):
    """``python -m octfusion_tpu_torch.train --model vae`` on a colour
    config of synthetic data: 2 steps with finite losses and colour
    terms, a checkpoint holding the colour heads, then ``--mode
    generate`` reconstructs a shape."""
    root = str(tmp_path)
    cfg = color_config(config_lib)
    cfg = dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, name="synthetic",
                                      batch_size=B, point_sample_num=N_SDF,
                                      points_per_shape=N_POINTS,
                                      num_workers=1),
        train=dataclasses.replace(cfg.train, print_freq=1,
                                  save_latest_freq=2))
    config_lib.dump_config(cfg, os.path.join(root, "cfg.yaml"))
    argv = ["--model", "vae", "--name", "cvae", "--config",
            os.path.join(root, "cfg.yaml"), "--logs_dir", root, "--device",
            "cpu"]
    stats = ttrain.main(argv + ["--max_steps", "2"])
    assert len(stats["loss"]) == 2 and np.isfinite(stats["loss"]).all()
    for d in range(DS, DOUT + 1):
        assert np.isfinite(float(stats["last"][f"color_loss_{d}"]))
    assert "color_loss_" in capsys.readouterr().out
    tree = ckpt_lib.restore(os.path.join(root, "cvae", "ckpt",
                                         "steps-latest"))
    assert "color.0.1.linear.weight" in tree["autoencoder"]
    written = ttrain.main(argv + ["--mode", "generate", "--count", "1"])
    assert len(written) == 1 and os.path.getsize(written[0]) > 0
