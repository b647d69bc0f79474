"""The port's DPM-Solver++(2M) loop and DPM-Solver++ cascade against the
JAX package's.

* ``sample_loop(solver="dpmpp")`` on a toy denoiser from the same initial
  noise, for the x0 and eps parameterisations with the sign snap on and
  off: rtol = atol = 1e-5 (float32 arithmetic in the same order);
* the tiny cascade (``configs/synthetic_tiny.yaml`` values) with
  ``sampler="dpmpp"`` and injected noise, the port's grown graph packed
  (its convs take K5's plain version): the same octree and depth-stop
  graph, codes and SDF grid to the cascade test's rtol = atol = 1e-4, with
  its margins (lr pre-snap values and decoder split logits away from
  their ties by more than 1e-3)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from octfusion_tpu.diffusion import sampler as jsampler
from octfusion_tpu.diffusion import schedule as jschedule
from octfusion_tpu_torch.diffusion import sampler as tsampler
from octfusion_tpu_torch.diffusion import schedule as tschedule
from octfusion_tpu_torch.ops import graph_conv_cuda

from test_torch_port_helpers import (assert_graph_equal, assert_octree_equal,
                                     jax_cascade, np_, union_solvers)

TOL = dict(rtol=1e-4, atol=1e-4)
STEPS = 6
RES = 24


# the sign snap from t < 0.5: from 0.7, as the lr stage snaps, an eps
# model's snapped +-1 over alpha ~ 0.09 turns the last-bit differences of
# the schedule scalars (XLA's and PyTorch's float32 log / expm1 / sigmoid)
# into ~1e-4 absolute errors on the values that later cancel
TRUNC = 0.5


def _denoisers():
    """A smooth toy denoiser near the true eps of a pure-noise input
    (sigma x), so neither parameterisation's x0 estimate blows up."""

    def jfn(x, tb, xs):
        return jnp.sqrt(jax.nn.sigmoid(-tb[0])) * x + 0.1 * jnp.tanh(xs)

    def tfn(x, tb, xs):
        return torch.sqrt(torch.sigmoid(-tb[0])) * x + 0.1 * torch.tanh(xs)

    return jfn, tfn


@pytest.mark.parametrize("df_type", ["x0", "eps"])
@pytest.mark.parametrize("snap", [True, False])
def test_dpmpp_loop_matches_jax(df_type, snap):
    steps, shape = 8, (2, 4, 4, 4, 8)
    noise = np.random.RandomState(0).normal(size=(1,) + shape).astype(
        np.float32)
    jfn, tfn = _denoisers()
    trunc = TRUNC if snap else 0.0
    ref = jax.jit(lambda n: jsampler.sample_loop(
        jfn, jax.random.PRNGKey(0), shape, 2, steps,
        jschedule.beta_linear_log_snr, df_type=df_type,
        truncated_index=trunc, snap_sign=snap, noise_stream=n,
        solver="dpmpp"))(jnp.asarray(noise))
    got = tsampler.sample_loop(
        tfn, shape, 2, steps, tschedule.beta_linear_log_snr, df_type=df_type,
        truncated_index=trunc, snap_sign=snap, noise_stream=noise,
        solver="dpmpp", device="cpu")
    np.testing.assert_allclose(np_(got), np_(ref), rtol=1e-5, atol=1e-5)


def test_dpmpp_draws_only_the_initial_state():
    """Without a noise stream the generator's first draw is the initial
    state, as in the ancestral loop, and nothing is drawn after it."""
    _, tfn = _denoisers()
    shape = (1, 3)
    kw = dict(solver="dpmpp", device="cpu")
    gen = torch.Generator().manual_seed(5)
    got = tsampler.sample_loop(tfn, shape, 1, 4,
                               tschedule.beta_linear_log_snr,
                               generator=gen, **kw)
    after = torch.randn(shape, generator=gen)
    gen = torch.Generator().manual_seed(5)
    x0 = torch.randn(shape, generator=gen)
    ref = tsampler.sample_loop(tfn, shape, 1, 4,
                               tschedule.beta_linear_log_snr,
                               noise_stream=x0[None], **kw)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
    torch.testing.assert_close(after, torch.randn(shape, generator=gen),
                               rtol=0, atol=0)


def test_dpmpp_cascade_matches_jax(monkeypatch):
    sj, st, params, vae_params, rng = union_solvers(sampler="dpmpp")
    j, lr_noise, hr_noise = jax_cascade(sj, params, vae_params, rng, STEPS,
                                        RES)
    packed_calls = [0]
    packed_plain = graph_conv_cuda.graph_conv_packed_plain

    def counting(*args):
        packed_calls[0] += 1
        return packed_plain(*args)

    monkeypatch.setattr(graph_conv_cuda, "graph_conv_packed_plain", counting)
    pre_snap = []

    def record(mod, args, kwargs, out):
        if not kwargs.get("as_middle", False):
            pre_snap.append(np_(out))

    hook = st.df.unet_lr.register_forward_hook(record, with_kwargs=True)
    try:
        out = st.sample(steps=STEPS, resolution=RES, lr_noise=lr_noise,
                        hr_noise=hr_noise, kpack=True)
    finally:
        hook.remove()
    snapped = [o for i, o in enumerate(pre_snap) if 1 - i / STEPS < 0.7]
    assert snapped and min(np.abs(o).min() for o in snapped) > 1e-3
    lg = np_(out["decode_out"]["logits"][3])
    valid = np_(out["graph"].level(3).node_mask)[-lg.shape[0]:]
    assert np.abs(lg[:, 1] - lg[:, 0])[valid].min() > 1e-3

    assert all(lvl.packed for lvl in out["graph"].levels)
    assert packed_calls[0] > 0
    np.testing.assert_allclose(np_(out["split_small"]), np_(j["split"]),
                               **TOL)
    assert_octree_equal(out["octree_small"], j["octree"])
    assert_graph_equal(out["graph"], j["g"])
    np.testing.assert_allclose(np_(out["code"]), np_(j["code"]), **TOL)
    assert_octree_equal(out["decode_out"]["octree_out"],
                        j["dec"]["octree_out"])
    np.testing.assert_allclose(np_(out["sdfs"]), np_(j["sdf"]), **TOL)
