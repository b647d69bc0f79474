"""The port's graph VAE training and reconstruction against the JAX
package's, on the tiny configuration (``configs/synthetic_tiny.yaml``
values), with the same seeded reference-layout weights (none zero, through
``utils/torch_convert.py`` into flax and the parameter bridge into the
port), the same batch (two seeded lumpy spheres of 2048 points and 256 SDF
samples each) and the JAX draws injected:

* ``copy_topology_octree``, exactly;
* ``GraphVAE.decode`` on a seeded code, and ``forward`` on the fixed
  topology and growing from the input's: logits, planes, KL and codes to
  1e-4 (fp32 through ~15 layers);
* one ``VAESolver`` train step: every term of the loss dict to 1e-4 and
  every gradient at ``test_torch_port_train.py``'s tolerances (1e-3, and
  each leaf's largest error within 1e-4 of its largest |gradient|);
* two AdamW + poly(0.9) updates from identical gradients against optax
  (1e-6: the same arithmetic in another order);
* ``reconstruct``'s grown octree exactly and its SDF grid (1e-4 against
  JAX's planes resampled in fp32; JAX's own grid is rounded to fp16)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch

from octfusion_tpu.models.common import TrainState, batch_to_graph_jit
from octfusion_tpu.models.vae_solver import VAESolver as JSolver
from octfusion_tpu.nn import vae as jvae
from octfusion_tpu.ops import mpu as jmpu
from octfusion_tpu.utils import torch_convert as tc
from octfusion_tpu_torch.models.common import batch_to_graph
from octfusion_tpu_torch.models.vae_solver import VAESolver as TSolver
from octfusion_tpu_torch.nn import vae as tvae
from octfusion_tpu_torch.utils import params as bridge
from octfusion_tpu_torch.utils.shapes import (lumpy_sphere_sdf_samples,
                                              lumpy_spheres)

import torch_ref_vae as tref
from test_torch_port_helpers import (TINY, assert_octree_equal, jcfg, np_,
                                     perturb, tcfg, tiny_config)

GRAD_TOL = dict(rtol=1e-3, atol=1e-3)
GRAD_SCALE_TOL = 1e-4
TOL_OUT = dict(rtol=1e-4, atol=1e-4)
B = 2
TOTAL_STEPS = 10    # the poly decay visibly moves over two updates
M = TINY["model"]
VAE_ARGS = (M["depth"], M["depth_stop"], M["depth_out"], M["resblk_num"])


@pytest.fixture(scope="module")
def setup():
    cj, ct = tiny_config(jcfg), tiny_config(tcfg)
    sj = JSolver(cj)
    rng = np.random.RandomState(0)
    params = tc.convert_vae(
        tref.make_state_dict(rng, M["depth"], M["depth_stop"],
                             M["depth_out"], M["resblk_num"], M["channels"],
                             M["embed_dim"]), *VAE_ARGS)
    pts, nrm = lumpy_spheres(B, 2048, seed=3)
    batch = {"points": pts, "normals": nrm,
             **lumpy_sphere_sdf_samples(B, 256, seed=3, points_per_shape=2048)}

    def port_solver():
        st = TSolver(ct, device="cpu")
        st.vae.load_state_dict(bridge.vae_state_dict(params, *VAE_ARGS),
                               strict=True)
        return st

    jbatch = {k: jnp.asarray(np_(v)) for k, v in batch.items()}
    _, jg = batch_to_graph_jit(jbatch["points"], jbatch["normals"], sj.spec1,
                               sj.edge_factor)
    return dict(sj=sj, params=params, batch=batch, jbatch=jbatch, jg=jg,
                port_solver=port_solver, key=jax.random.PRNGKey(5))


def _eps(key, shape):
    """The posterior draw the JAX ``GraphVAE.__call__`` takes from
    ``key`` (``distributions.py:16-18``)."""
    return torch.tensor(np_(jax.jit(
        lambda k: jax.random.normal(k, shape))(key)))


def _assert_decoded_equal(got, want):
    assert sorted(got["logits"]) == sorted(want["logits"])
    for d in want["logits"]:
        np.testing.assert_allclose(np_(got["logits"][d]),
                                   np_(want["logits"][d]), err_msg=str(d),
                                   **TOL_OUT)
        for dd, r in want["reg_voxs"][d].items():
            np.testing.assert_allclose(np_(got["reg_voxs"][d][dd]), np_(r),
                                       err_msg=f"{d}/{dd}", **TOL_OUT)
    assert_octree_equal(got["octree_out"], want["octree_out"])


def test_copy_topology_octree_matches_jax(setup):
    s = setup
    st = s["port_solver"]()
    to, _ = batch_to_graph(s["batch"]["points"], s["batch"]["normals"],
                           st.spec1, st.edge_factor)
    jo = s["jg"].octree
    for d in (M["full_depth"] + 1, M["depth_stop"]):
        want = jax.jit(lambda o: jvae.copy_topology_octree(o, d))(jo)
        got = tvae.copy_topology_octree(to, d)
        assert_octree_equal(got, want)
        np.testing.assert_array_equal(np_(got.child[d - 1]),
                                      np_(to.child[d - 1]))


def test_decode_matches_jax(setup):
    s = setup
    sj = s["sj"]
    st = s["port_solver"]()
    g = batch_to_graph(s["batch"]["points"], s["batch"]["normals"], st.spec1,
                       st.edge_factor)[1]
    shape = (g.level(M["depth_stop"]).g_cap, M["embed_dim"])
    code = np.random.RandomState(1).normal(size=shape).astype(np.float32)
    want = jax.jit(lambda p, c, g: sj.vae.apply(
        p, c, g, method=jvae.GraphVAE.decode))(s["params"], code, s["jg"])
    with torch.no_grad():
        got = st.vae.decode(torch.tensor(code), g)
    _assert_decoded_equal(got, want)


@pytest.mark.parametrize("topology", ["fixed", "grow"])
def test_forward_matches_jax(setup, topology):
    s = setup
    sj = s["sj"]
    st = s["port_solver"]()
    g = batch_to_graph(s["batch"]["points"], s["batch"]["normals"], st.spec1,
                       st.edge_factor)[1]
    fixed = topology == "fixed"
    want = jax.jit(lambda p, g, k: sj.vae.apply(
        p, g, g if fixed else None, k))(s["params"], s["jg"], s["key"])
    eps = _eps(s["key"], tuple(want["code"].shape))
    with torch.no_grad():
        got = st.vae(g, g if fixed else None, eps=eps)
    _assert_decoded_equal(got, want)
    for k in ("kl_loss", "code", "code_max", "code_min"):
        np.testing.assert_allclose(np_(got[k]), np_(want[k]), err_msg=k,
                                   **TOL_OUT)
    assert float(got["kl_loss"]) > 0


def _first_moment(opt_state):
    """AdamW's first moment in an optax state: after one update from zero
    it is (1 - b1) * grads."""
    is_adam = lambda x: isinstance(x, optax.ScaleByAdamState)
    states = [x for x in jax.tree_util.tree_leaves(opt_state, is_leaf=is_adam)
              if is_adam(x)]
    assert len(states) == 1
    return states[0].mu


def test_train_step_matches_jax(setup):
    """One step of JAX ``make_train_step`` against the port's: every term
    of the loss dict, and every gradient (the JAX one read back from
    AdamW's first moment, mu = 0.1 * grads after the first update)."""
    s = setup
    sj = s["sj"]
    tx = sj.make_optimizer(TOTAL_STEPS)
    state = TrainState(step=jnp.asarray(0, jnp.int32), params=s["params"],
                       opt_state=tx.init(s["params"]))
    new_state, ld = sj.make_train_step(TOTAL_STEPS)(state, s["jbatch"],
                                                    s["key"])
    grads = jax.tree_util.tree_map(lambda m: np_(m) / np.float32(0.1),
                                   _first_moment(new_state.opt_state))

    st = s["port_solver"]()
    step = st.make_train_step(TOTAL_STEPS)
    out = step(s["batch"], eps=_eps(s["key"], st.code_shape(B)))
    assert sorted(out) == sorted(ld)
    for k in ld:
        np.testing.assert_allclose(np_(out[k]), np_(ld[k]), err_msg=k,
                                   **TOL_OUT)
    assert float(out["overflow"]) == 0.0

    ref = bridge.vae_state_dict(grads, *VAE_ARGS)
    named = dict(st.vae.named_parameters())
    assert sorted(named) == sorted(ref)
    for n, p in named.items():
        assert p.grad is not None, n
        want = np_(ref[n]).reshape(p.shape)
        np.testing.assert_allclose(np_(p.grad), want, err_msg=n, **GRAD_TOL)
        err, scale = np.abs(np_(p.grad) - want).max(), np.abs(want).max()
        assert scale > 0, n
        assert err <= GRAD_SCALE_TOL * scale, (n, err, scale)


def test_optimizer_matches_optax(setup):
    """Two AdamW + poly(0.9) updates from identical seeded gradients
    against the JAX ``make_optimizer``: the second update runs at the
    decayed rate, so an off-by-one in the schedule's count shows."""
    s = setup
    tx = s["sj"].make_optimizer(TOTAL_STEPS)
    st = s["port_solver"]()
    step = st.make_train_step(TOTAL_STEPS)

    @jax.jit
    def update(grads, opt_state, p):
        updates, opt_state = tx.update(grads, opt_state, p)
        return optax.apply_updates(p, updates), opt_state

    rng = np.random.RandomState(9)
    jparams, opt_state = s["params"], tx.init(s["params"])
    for _ in range(2):
        grads = perturb(jax.tree_util.tree_map(np.zeros_like, s["params"]),
                        rng, scale=1.0)
        jparams, opt_state = update(grads, opt_state, jparams)
        tg = bridge.vae_state_dict(jax.device_get(grads), *VAE_ARGS)
        for n, p in st.vae.named_parameters():
            p.grad = tg[n].reshape(p.shape)
        step.apply_gradients()
    want = bridge.vae_state_dict(jax.device_get(jparams), *VAE_ARGS)
    for n, p in st.vae.named_parameters():
        np.testing.assert_allclose(np_(p), np_(want[n]).reshape(p.shape),
                                   rtol=1e-6, atol=1e-6, err_msg=n)
    lr = s["sj"].cfg.train.lr
    assert step.scheduler.get_last_lr()[0] == pytest.approx(
        lr * (1.0 - 2 / TOTAL_STEPS) ** 0.9, rel=1e-12)


def test_reconstruct_matches_jax(setup):
    """The grid against the JAX decode's planes resampled in fp32 (1e-4),
    and against the grid JAX ``reconstruct`` returns, which it rounds to
    fp16 (within half an fp16 ulp of 1: 2^-11 relative)."""
    s = setup
    sj = s["sj"]
    res = 20
    want16, jout = sj.reconstruct(s["params"], s["jbatch"], s["key"],
                                  resolution=res)
    fd, dout = M["full_depth"], M["depth_out"]
    want = jax.jit(lambda r, o: jmpu.mpu_grid_eval(r, o, fd, dout, res, -0.9,
                                                   0.9))(
        jout["reg_voxs"][dout], jout["octree_out"])
    st = s["port_solver"]()
    got, out = st.reconstruct(s["batch"], resolution=res)
    assert got.shape == (B, res, res, res)
    assert_octree_equal(out["octree_out"], jout["octree_out"])
    np.testing.assert_allclose(np_(got), np_(want), **TOL_OUT)
    np.testing.assert_allclose(np_(got), np_(want16).astype(np.float32),
                               rtol=2.0**-11, atol=1e-4)
    assert sorted(out["seconds"]) == ["decode", "encode", "graph", "sdf"]
    assert np.abs(np_(got)).max() > 0
