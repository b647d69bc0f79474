"""Parity of the port's sampler, dense MPU grid and marching tetrahedra
with the JAX package.

* ``sample_loop`` (ancestral x0 with truncation and sign snap, eps) with the
  same injected ``noise_stream`` and a fixed denoiser: rtol = atol = 1e-4;
* ``mpu_grid_eval`` on a 48³ grid: rtol = atol = 1e-5;
* ``marching_tetrahedra`` against the numpy version: the same faces, and
  vertices to 1e-6 (both interpolate in float32)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from octfusion_tpu.diffusion import sampler as jsampler
from octfusion_tpu.diffusion import schedule as jschedule
from octfusion_tpu.ops import mpu as jmpu
from octfusion_tpu.utils import mesh as jmesh
from octfusion_tpu_torch.diffusion import sampler as tsampler
from octfusion_tpu_torch.diffusion import schedule as tschedule
from octfusion_tpu_torch.ops import mpu as tmpu
from octfusion_tpu_torch.utils import mesh as tmesh

from test_torch_port_helpers import make_graph, np_, port_octree


def _denoisers():
    def jfn(x, tb, xs):
        return jnp.tanh(0.8 * x + 0.3 * xs + 0.01 * tb[0])

    def tfn(x, tb, xs):
        return torch.tanh(0.8 * x + 0.3 * xs + 0.01 * tb[0])

    return jfn, tfn


@pytest.mark.parametrize("df_type,snap,eta", [("x0", True, 1.0),
                                              ("x0", False, 0.0),
                                              ("eps", False, 1.0)])
def test_sample_loop_matches_jax(df_type, snap, eta):
    steps, shape = 8, (2, 4, 4, 4, 8)
    rng = np.random.RandomState(0)
    noise = rng.normal(size=(steps + 1,) + shape).astype(np.float32)
    jfn, tfn = _denoisers()
    trunc = 0.7 if snap else 0.0
    ref = jax.jit(lambda n: jsampler.sample_loop(
        jfn, jax.random.PRNGKey(0), shape, 2, steps,
        jschedule.beta_linear_log_snr, df_type=df_type,
        truncated_index=trunc, snap_sign=snap, noise_stream=n, eta=eta))(
            jnp.asarray(noise))
    got = tsampler.sample_loop(
        tfn, shape, 2, steps, tschedule.beta_linear_log_snr, df_type=df_type,
        truncated_index=trunc, snap_sign=snap, noise_stream=noise, eta=eta,
        device="cpu")
    np.testing.assert_allclose(np_(got), np_(ref), rtol=1e-4, atol=1e-4)


def test_sample_loop_rejects_short_noise_stream():
    _, tfn = _denoisers()
    with pytest.raises(ValueError, match="steps\\+1"):
        tsampler.sample_loop(tfn, (1, 3), 1, 4, tschedule.beta_linear_log_snr,
                             noise_stream=np.zeros((2, 1, 3), np.float32),
                             device="cpu")


def test_mpu_grid_eval_matches_jax():
    jg = make_graph(seed=8, depth=4, full_depth=2, n=400)
    octree = jg.octree
    rng = np.random.RandomState(9)
    reg = {dd: rng.normal(size=(octree.spec.node_caps[dd], 4)).astype(
        np.float32) for dd in range(2, 5)}
    ref = jax.jit(lambda r, o: jmpu.mpu_grid_eval(r, o, 2, 4, 48, -0.9, 0.9))(
        {k: jnp.asarray(v) for k, v in reg.items()}, octree)
    got = tmpu.mpu_grid_eval({k: torch.tensor(v) for k, v in reg.items()},
                             port_octree(octree), 2, 4, 48, -0.9, 0.9)
    assert got.shape == (1, 48, 48, 48)
    np.testing.assert_allclose(np_(got), np_(ref), rtol=1e-5, atol=1e-5)


def test_marching_tetrahedra_matches_numpy():
    n = 24
    c = (np.arange(n, dtype=np.float32) - n / 2 + 0.3) / (n / 2)
    x, y, z = np.meshgrid(c, c, c, indexing="ij")
    r = np.sqrt(x * x + y * y + z * z)
    sdf = (r - 0.6 - 0.08 * np.sin(5 * x) * np.cos(4 * y)).astype(np.float32)
    vr, fr = jmesh.marching_tetrahedra(sdf)
    vt, ft = tmesh.marching_tetrahedra(torch.tensor(sdf))
    assert len(fr) > 0
    np.testing.assert_array_equal(np_(ft), fr)
    np.testing.assert_allclose(np_(vt), vr, rtol=0, atol=1e-6)
