"""The port's networks against the JAX package's, given the same weights.

A random reference-layout state dict (``tests/torch_ref_*.make_state_dict``)
goes through ``utils/torch_convert.py`` into flax and back through the
port's parameter bridge; the bridge must return the reference tensors bit
for bit and they must load with ``strict=True``.  The forwards are then held
to rtol = atol = 1e-4 (fp32 through a few dozen layers, different
summation order)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import torch_ref_unet as tru
import torch_ref_vae as tref

from octfusion_tpu.nn.unet_lr import UNetLR as JUNetLR
from octfusion_tpu.nn.unet_union import UNetUnion as JUNetUnion
from octfusion_tpu.nn.unet_union import UnionConfig as JUnionConfig
from octfusion_tpu.nn.vae import GraphVAE as JGraphVAE
from octfusion_tpu.nn.vae import copy_topology_octree
from octfusion_tpu.octree.dual_graph import build_dual_graph as j_build
from octfusion_tpu.utils import torch_convert as tc
from octfusion_tpu_torch.nn.unet_hr import UNetHR
from octfusion_tpu_torch.nn.unet_lr import UNetLR
from octfusion_tpu_torch.nn.unet_union import UNetUnion, UnionConfig
from octfusion_tpu_torch.nn.vae import GraphVAE
from octfusion_tpu_torch.octree.dual_graph import build_dual_graph as t_build
from octfusion_tpu_torch.utils import params as bridge

from test_torch_port_helpers import (TINY, assert_graph_equal, make_graph, np_,
                                     port_octree)

TOL = dict(rtol=1e-4, atol=1e-4)
DIFF = TINY["diffusion"]
LR_CFG = {"model_channels": 8, "channel_mult": (1, 2),
          "attention_resolutions": (2,), "num_heads": 2}
HR_CFG = {"model_channels": 16, "channel_mult": (1, 1),
          "num_res_blocks": (1, 0), "input_depth": 3, "full_depth": 2}
VAE = dict(depth=4, depth_stop=3, depth_out=4, resblk_num=1,
           channels=(4, 8, 8, 8, 8))
# an encoder with residual blocks at every level and a channel change at
# its downsample (the tiny VAE above has neither)
VAE_ENC = dict(depth=4, depth_stop=3, depth_out=4, resblk_num=2,
               channels=(4, 8, 8, 12, 8))


def _jtree(t):
    return jax.tree_util.tree_map(jnp.asarray, t)


def _assert_same_tensors(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k].reshape(got[k].shape)), k
        assert got[k].shape == want[k].shape, k


def test_bridge_roundtrips_reference_state_dicts():
    rng = np.random.RandomState(0)
    for cfg in (VAE, VAE_ENC):
        sd = tref.make_state_dict(rng, embed_dim=2, **cfg)
        arch = {k: cfg[k] for k in ("depth", "depth_stop", "depth_out",
                                    "resblk_num")}
        got = bridge.vae_state_dict(tc.convert_vae(sd, **arch), **arch)
        _assert_same_tensors(got, sd)
        GraphVAE(embed_dim=2, **cfg).load_state_dict(got, strict=True)

    sd = tru.lr_make_state_dict(rng, LR_CFG, num_classes=3)
    flax = tc.convert_unet_lr(sd, LR_CFG["channel_mult"],
                              LR_CFG["attention_resolutions"])
    got = bridge.unet_lr_state_dict(flax, LR_CFG["channel_mult"],
                                    LR_CFG["attention_resolutions"])
    _assert_same_tensors(got, sd)
    UNetLR(full_depth=2, model_channels=8, channel_mult=(1, 2),
           attention_resolutions=(2,), num_heads=2,
           num_classes=3).load_state_dict(got, strict=True)

    sd = tru.hr_make_state_dict(rng, HR_CFG, in_channels=2, out_channels=2,
                                lr_model_channels=8)
    flax = tc.convert_unet_hr(sd, HR_CFG["channel_mult"],
                              HR_CFG["num_res_blocks"])
    got = bridge.unet_hr_state_dict(flax, HR_CFG["channel_mult"],
                                    HR_CFG["num_res_blocks"])
    _assert_same_tensors(got, sd)
    UNetHR(input_depth=3, full_depth=2, in_channels=2, model_channels=16,
           lr_model_channels=8, out_channels=2, num_res_blocks=(1, 0),
           channel_mult=(1, 1)).load_state_dict(got, strict=True)


def _union_cfgs():
    kw = dict(input_depth=DIFF["input_depth"], full_depth=2,
              input_channels=DIFF["input_channels"],
              out_channels=DIFF["out_channels"],
              model_channels=DIFF["model_channels"],
              num_res_blocks=DIFF["num_res_blocks"],
              channel_mult=DIFF["channel_mult"],
              attention_resolutions=DIFF["attention_resolutions"],
              num_heads=2)
    return JUnionConfig(use_checkpoint=False, **kw), UnionConfig(**kw)


@pytest.fixture(scope="module")
def union_params():
    rng = np.random.RandomState(1)
    lr = tc.convert_unet_lr(tru.lr_make_state_dict(rng, LR_CFG),
                            LR_CFG["channel_mult"],
                            LR_CFG["attention_resolutions"])
    hr = tc.convert_unet_hr(
        tru.hr_make_state_dict(rng, HR_CFG, in_channels=2, out_channels=2,
                               lr_model_channels=8),
        HR_CFG["channel_mult"], HR_CFG["num_res_blocks"])
    return {"params": {"unet_lr": lr, "unet_hr": hr}}


def test_unet_lr_matches_jax(union_params):
    rng = np.random.RandomState(2)
    x = rng.normal(size=(2, 4, 4, 4, 8)).astype(np.float32)      # NDHWC
    sc = rng.normal(size=(2, 4, 4, 4, 8)).astype(np.float32)
    t = np.array([0.3, -1.1], np.float32)
    jm = JUNetLR(full_depth=2, model_channels=8, channel_mult=(1, 2),
                 attention_resolutions=(2,), num_heads=2)
    lr = union_params["params"]["unet_lr"]
    ref = jax.jit(jm.apply)({"params": _jtree(lr)}, jnp.asarray(x),
                            jnp.asarray(t), jnp.asarray(sc))
    tm = UNetLR(full_depth=2, model_channels=8, channel_mult=(1, 2),
                attention_resolutions=(2,), num_heads=2)
    tm.load_state_dict(bridge.unet_lr_state_dict(lr, (1, 2), (2,)))
    ncdhw = lambda a: torch.tensor(a).permute(0, 4, 1, 2, 3)
    with torch.no_grad():
        got = tm(ncdhw(x), torch.tensor(t), x_self_cond=ncdhw(sc))
    np.testing.assert_allclose(np_(got.permute(0, 2, 3, 4, 1)), np_(ref),
                               **TOL)


def test_unet_hr_with_lr_middle_matches_jax(union_params):
    jg = make_graph(seed=4, depth=4, full_depth=2, n=300, up_to=3)
    tg = t_build(port_octree(jg.octree), 9, up_to=3)
    jcfg, tcfg = _union_cfgs()
    rng = np.random.RandomState(3)
    x = rng.normal(size=(tg.level(3).g_cap, 2)).astype(np.float32)
    t = np.array([0.7], np.float32)
    jm = JUNetUnion(jcfg, "hr")
    ref = jax.jit(lambda p, x, t, g: jm.apply(p, "hr", x, t, g=g))(
        _jtree(union_params), jnp.asarray(x), jnp.asarray(t), jg)
    tm = UNetUnion(tcfg, "hr")
    tm.load_state_dict(bridge.union_state_dict(union_params, tcfg),
                       strict=True)
    with torch.no_grad():
        got = tm("hr", torch.tensor(x), torch.tensor(t), g=tg)
    np.testing.assert_allclose(np_(got), np_(ref), **TOL)


def test_vae_decode_grow_matches_jax():
    rng = np.random.RandomState(5)
    sd = tref.make_state_dict(rng, embed_dim=2, **VAE)
    flax = tc.convert_vae(sd, depth=4, depth_stop=3, depth_out=4,
                          resblk_num=1)
    jm = JGraphVAE(depth=4, full_depth=2, depth_stop=3, depth_out=4,
                   embed_dim=2, resblk_num=1, channels=VAE["channels"],
                   use_checkpoint=False)

    @jax.jit
    def j_decode(params, code, octree):
        g = j_build(copy_topology_octree(octree, 3), 9, up_to=3)
        return g, jm.apply(params, code, g, method=JGraphVAE.decode_grow)

    src = make_graph(seed=6, depth=4, full_depth=2, n=300)
    g_cap = src.spec.g_cap(3)
    code = rng.normal(size=(g_cap, 2)).astype(np.float32)
    jg, ref = j_decode(_jtree(flax), jnp.asarray(code), src.octree)

    tm = GraphVAE(embed_dim=2, **VAE)
    tm.load_state_dict(bridge.vae_state_dict(flax, 4, 3, 4, 1), strict=True)
    tg = t_build(port_octree(jg.octree), 9, up_to=3)
    with torch.no_grad():
        got = tm.decode_grow(torch.tensor(code), tg)
    # the split decision must not sit on a near-tie for this seed
    lg = np_(ref["logits"][3])
    valid = np_(jg.octree.node_mask(3))
    assert np.abs(lg[:, 1] - lg[:, 0])[valid].min() > 1e-3
    for d in (3, 4):
        np.testing.assert_allclose(np_(got["logits"][d]),
                                   np_(ref["logits"][d]), **TOL)
        for dd in ref["reg_voxs"][d]:
            np.testing.assert_allclose(np_(got["reg_voxs"][d][dd]),
                                       np_(ref["reg_voxs"][d][dd]), **TOL)
    assert_graph_equal(got["graph_out"], ref["graph_out"])


def test_vae_encode_and_extract_code_match_jax():
    rng = np.random.RandomState(8)
    sd = tref.make_state_dict(rng, embed_dim=2, **VAE_ENC)
    arch = {k: VAE_ENC[k] for k in ("depth", "depth_stop", "depth_out",
                                    "resblk_num")}
    flax = _jtree(tc.convert_vae(sd, **arch))
    jm = JGraphVAE(full_depth=2, embed_dim=2, channels=VAE_ENC["channels"],
                   use_checkpoint=False, **arch)
    jg = make_graph(seed=9, depth=4, full_depth=2, n=400)
    key = jax.random.PRNGKey(3)
    (mean, logvar), code, eps = jax.jit(lambda p, g, k: (
        jm.apply(p, g, method=JGraphVAE.encode),
        jm.apply(p, g, k, method=JGraphVAE.extract_code),
        jax.random.normal(k, (g.level(3).g_cap, 2))))(flax, jg, key)

    tm = GraphVAE(embed_dim=2, **VAE_ENC)
    tm.load_state_dict(bridge.vae_state_dict(flax, **arch), strict=True)
    tg = t_build(port_octree(jg.octree), 9)
    with torch.no_grad():
        tmean, tlogvar = tm.encode(tg)
        tcode = tm.extract_code(tg, eps=torch.tensor(np_(eps)))
    assert np.abs(np_(mean)).max() > 0.1
    for got, ref in ((tmean, mean), (tlogvar, logvar), (tcode, code)):
        np.testing.assert_allclose(np_(got), np_(ref), **TOL)
