"""The class-conditional 2-stage model (``configs/octfusion_snet_cond.yaml``'s
structure at a tiny size: a four-level lr body with attention at its
bottom, hr ResBlocks ``[2, 2, 0]``, 5 classes), fp32 on the CPU, at B = 5
with labels 0-4.  The lr body reaches 64 channels: its group norms take
``min(32, C)`` groups, and a group of one channel takes out the time and
label shift whole.

* against the JAX package, with reference-layout weights carried over by
  the parameter bridge: one lr call and one hr call (its lr middle
  included) agree, with the labels and with the labels rolled by one,
  and rolling them changes both U-Nets' outputs, so the label path is
  live;
* against the benchmark's plain reference (``portbench/reference``), with
  the same seeded weights: one lr call and one hr call agree, which is the
  benchmark judge's own check of that reference;
* a 2-step DPM-Solver++ cascade through decode, judged as the benchmark
  judges ``snetcond-gen-b5`` (each U-Net call recomputed by the reference
  with the labels asked for), is within the judge's rounding;
* the cascade counts ``unet.label_embeds`` B for each U-Net embedding
  (lr calls once, hr calls twice) and, with tracing on, one
  ``octf.unet.lr_middle`` span an hr step.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import torch_ref_unet as tru

from octfusion_tpu.nn.unet_lr import UNetLR as JUNetLR
from octfusion_tpu.nn.unet_union import UNetUnion as JUNetUnion
from octfusion_tpu.nn.unet_union import UnionConfig as JUnionConfig
from octfusion_tpu.octree.dual_graph import build_dual_graph as j_build
from octfusion_tpu.octree.octree import OctreeSpec as JSpec
from octfusion_tpu.octree.octree import build_octree, merge_octrees
from octfusion_tpu.utils import torch_convert as tc
from octfusion_tpu_torch.config import Config, _build
from octfusion_tpu_torch.models.union_solver import UnionSolver
from octfusion_tpu_torch.nn.unet_lr import UNetLR
from octfusion_tpu_torch.nn.unet_union import UNetUnion, UnionConfig
from octfusion_tpu_torch.octree.dual_graph import build_dual_graph as t_build
from octfusion_tpu_torch.utils import params as bridge
from octfusion_tpu_torch.utils import trace
from portbench import inputs, record
from portbench.reference import judge, judge_cond

from test_torch_port_helpers import np_, port_octree

SEED = 2147500123
STEPS = 2
LABELS = [0, 1, 2, 3, 4]
RAW = {
    "solver": {"resolution": 16, "sdf_scale": 0.9},
    "model": {"depth": 6, "full_depth": 3, "depth_stop": 5, "depth_out": 6,
              "embed_dim": 2, "resblk_num": 1, "channels": [4] + [8] * 7,
              "use_checkpoint": False},
    "capacity": {"finest_cap": 1024, "decay": 2.0, "edge_factor": 10},
    "data": {"name": "synthetic", "batch_size": 2, "point_sample_num": 256,
             "points_per_shape": 2048},
    "diffusion": {"input_depth": [3, 5], "input_channels": [8, 2],
                  "out_channels": [8, 2], "model_channels": [16, 16],
                  "channel_mult": [[1, 2, 4, 4], [1, 1, 1]],
                  "num_res_blocks": [[1, 1, 1], [2, 2, 0]],
                  "attention_resolutions": [8], "num_classes": 5,
                  "sampler": "dpmpp"},
}
TRAFFIC = {"batch_size": len(LABELS), "labels": LABELS, "sampler": "dpmpp",
           "steps": STEPS}
CPU = torch.device("cpu")
DIFF = RAW["diffusion"]
TOL = dict(rtol=1e-4, atol=1e-4)
# the lr U-Net of RAW as the JAX UNetLR and the reference layout take it
LR_CFG = {"model_channels": 16, "channel_mult": (1, 2, 4, 4),
          "attention_resolutions": (8,), "num_heads": 4}
HR_CFG = {"model_channels": 16, "channel_mult": (1, 1, 1),
          "num_res_blocks": (2, 2, 0), "input_depth": 5}


@pytest.fixture(scope="module")
def solvers():
    """The port's and the reference's solver with the seeded weights, and
    the port's traced cascade with its record."""
    port = UnionSolver(_build(Config, RAW), device="cpu")
    ref_cfg, ref = judge.reference_solver(RAW, SEED, CPU)
    w = inputs.model_weights(ref_cfg, "hr", SEED, CPU)
    inputs.load_weights(port.df, w["df"])
    inputs.load_weights(port.vae, w["vae"])
    labels = judge_cond.labels_of(TRAFFIC, CPU)
    noise = judge.item_noise(RAW, TRAFFIC, SEED, 0, CPU)
    rec = record.DenoiseRecorder(port.df)
    trace.disable()
    trace.reset()
    embeds = trace.snapshot()["counters"]["unet.label_embeds"]
    trace.enable()
    try:
        out = port.sample(batch_size=len(LABELS), label=labels, steps=STEPS,
                          **noise)
    finally:
        trace.disable()
    snap = trace.snapshot()
    # the cascade's label rows (the counter counts since import)
    snap["counters"]["unet.label_embeds"] -= embeds
    trace.reset()
    rec = {"index": 0, "calls": rec.close(),
           **record.sample_outputs(out, ref_cfg.model.depth_out)}
    return port, ref, labels, out, rec, snap


@pytest.fixture(scope="module")
def union_params():
    """Reference-layout weights with ``label_emb`` in both U-Nets, as the
    JAX package's params (through ``utils/torch_convert``)."""
    rng = np.random.RandomState(7)
    lr = tc.convert_unet_lr(
        tru.lr_make_state_dict(rng, LR_CFG, num_classes=5),
        LR_CFG["channel_mult"], LR_CFG["attention_resolutions"])
    hr = tc.convert_unet_hr(
        tru.hr_make_state_dict(rng, HR_CFG, num_classes=5, in_channels=2,
                               out_channels=2, lr_model_channels=16),
        HR_CFG["channel_mult"], HR_CFG["num_res_blocks"])
    return {"params": {"unet_lr": lr, "unet_hr": hr}}


def _jtree(t):
    return jax.tree_util.tree_map(jnp.asarray, t)


def _jax_and_port(run_jax, run_port, labels):
    """The JAX and port outputs with ``labels`` and with them rolled by one:
    each pair agrees, and the roll moves the output.

    The absolute tolerance is taken relative to the output's largest value:
    the seeded weights drive the four-level body's outputs to |20|, and the
    JAX package's group norms take the variance as E[x^2] - E[x]^2 in fp32
    (flax's fast variance), which leaves a gap of about 1.5e-5 of that
    largest value here.  The port computes the variance directly, as the
    reference layout's oracle (``torch_ref_unet``) does."""
    outs = []
    for lb in (labels, np.roll(labels, 1)):
        want = np_(run_jax(jnp.asarray(lb)))
        with torch.no_grad():
            got = np_(run_port(torch.tensor(lb)))
        np.testing.assert_allclose(got, want, rtol=TOL["rtol"],
                                   atol=TOL["atol"] * np.abs(want).max())
        outs.append(got)
    moved = np.abs(outs[1] - outs[0]).max() / np.abs(outs[0]).max()
    assert moved > 1e-3


def test_lr_call_with_labels_matches_jax(union_params):
    rng = np.random.RandomState(8)
    b = len(LABELS)
    x = rng.normal(size=(b, 8, 8, 8, 8)).astype(np.float32)       # NDHWC
    sc = rng.normal(size=(b, 8, 8, 8, 8)).astype(np.float32)
    t = np.linspace(-3.0, 3.0, b).astype(np.float32)
    kw = dict(full_depth=3, model_channels=16, num_classes=5,
              channel_mult=LR_CFG["channel_mult"],
              attention_resolutions=LR_CFG["attention_resolutions"],
              num_heads=LR_CFG["num_heads"])
    lr = union_params["params"]["unet_lr"]
    jm = JUNetLR(**kw)
    j_apply = jax.jit(lambda p, lb: jm.apply(
        p, jnp.asarray(x), jnp.asarray(t), jnp.asarray(sc), label=lb))
    tm = UNetLR(**kw)
    tm.load_state_dict(bridge.unet_lr_state_dict(
        lr, LR_CFG["channel_mult"], LR_CFG["attention_resolutions"]),
        strict=True)
    ncdhw = lambda a: torch.tensor(a).permute(0, 4, 1, 2, 3)
    _jax_and_port(
        lambda lb: j_apply({"params": _jtree(lr)}, lb),
        lambda lb: tm(ncdhw(x), torch.tensor(t), x_self_cond=ncdhw(sc),
                      label=lb).permute(0, 2, 3, 4, 1),
        np.array(LABELS))


def test_hr_call_with_lr_middle_and_labels_matches_jax(union_params):
    """B = 5 merged spheres of other radii, so each sample has its own
    rows on every level."""
    b = len(LABELS)
    spec = JSpec.create(5, 3, 1, finest_cap_per_sample=2048, decay=1.0)
    rng = np.random.RandomState(9)
    v = rng.normal(size=(b, 300, 3))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    pts = np.linspace(0.4, 0.7, b)[:, None, None] * v
    one = jax.jit(lambda p, n: build_octree(p, n, spec))
    octrees = [one(jnp.asarray(pts[i].astype(np.float32)),
                   jnp.asarray(v[i].astype(np.float32))) for i in range(b)]
    assert not any(bool(o.overflow.any()) for o in octrees)
    jg = jax.jit(lambda os_: j_build(merge_octrees(os_), 9, up_to=5))(octrees)
    tg = t_build(port_octree(jg.octree), 9, up_to=5)
    kw = dict(input_depth=tuple(DIFF["input_depth"]), full_depth=3,
              input_channels=tuple(DIFF["input_channels"]),
              out_channels=tuple(DIFF["out_channels"]),
              model_channels=tuple(DIFF["model_channels"]),
              num_res_blocks=((1, 1, 1),
                              HR_CFG["num_res_blocks"]),
              channel_mult=(LR_CFG["channel_mult"], HR_CFG["channel_mult"]),
              attention_resolutions=LR_CFG["attention_resolutions"],
              num_heads=LR_CFG["num_heads"], num_classes=5)
    jcfg, tcfg = JUnionConfig(use_checkpoint=False, **kw), UnionConfig(**kw)
    x = rng.normal(size=(tg.level(5).g_cap, 2)).astype(np.float32)
    t = np.linspace(0.2, 1.8, b).astype(np.float32)
    jm = JUNetUnion(jcfg, "hr")
    j_apply = jax.jit(lambda p, lb, g: jm.apply(
        p, "hr", jnp.asarray(x), jnp.asarray(t), g=g, label=lb))
    tm = UNetUnion(tcfg, "hr")
    tm.load_state_dict(bridge.union_state_dict(union_params, tcfg),
                       strict=True)
    _jax_and_port(
        lambda lb: j_apply(_jtree(union_params), lb, jg),
        lambda lb: tm("hr", torch.tensor(x), torch.tensor(t), g=tg,
                      label=lb),
        np.array(LABELS))


def _gap(a, b):
    return ((a - b).abs().max() / b.abs().max()).item()


def test_lr_call_and_labels(solvers):
    port, ref, labels, _, _, _ = solvers
    g = torch.Generator().manual_seed(1)
    x = torch.randn(len(LABELS), 8, 8, 8, 8, generator=g)
    cond = torch.randn(x.shape, generator=g)
    t = torch.full((len(LABELS),), -3.0)
    with torch.no_grad():
        got = port.df("lr", x, t, x_self_cond=cond, label=labels)
        want = ref.df("lr", x, t, x_self_cond=cond, label=labels)
        rolled = port.df("lr", x, t, x_self_cond=cond,
                         label=labels.roll(1))
    assert _gap(got, want) < 1e-5
    assert _gap(rolled, got) > 1e-3


def test_hr_call_and_labels(solvers):
    port, ref, labels, out, _, _ = solvers
    g_port = out["graph"]
    _, g_ref = ref._grow_fn(len(LABELS))(out["split_small"])
    lvl = g_port.level(port.small_depth)
    x = torch.randn(lvl.g_cap, 2, generator=torch.Generator().manual_seed(2))
    t = torch.full((len(LABELS),), 1.5)
    with torch.no_grad():
        got = port.df("hr", x, t, g=g_port, label=labels)
        want = ref.df("hr", x, t, g=g_ref, label=labels)
        rolled = port.df("hr", x, t, g=g_port, label=labels.roll(1))
    mask = lvl.node_mask
    assert mask.sum() > 0
    assert _gap(got[mask], want[mask]) < 1e-5
    assert _gap(rolled[mask], got[mask]) > 1e-3


def test_cascade_as_the_benchmark_judges_it(solvers):
    _, _, _, out, rec, _ = solvers
    assert torch.isfinite(out["sdfs"]).all()
    gaps = judge_cond.judge_gen(RAW, TRAFFIC, SEED, [rec], CPU)
    assert set(gaps) == {"lr_gap", "hr_gap", "decode_gap", "sdf_gap"}
    assert max(gaps.values()) < 1e-5, gaps


def test_label_embeds_and_lr_middle_counted(solvers):
    _, _, _, _, _, snap = solvers
    b = len(LABELS)
    # lr calls embed once, hr calls in the hr U-Net and its lr middle
    assert snap["counters"]["unet.label_embeds"] == STEPS * b + 2 * STEPS * b
    mid = snap["by_stage"]["octf.sample.hr"]["octf.unet.lr_middle"]
    assert mid["count"] == STEPS and mid["host_s"] > 0
    assert snap["spans"]["octf.unet.lr_middle"]["count"] == STEPS
    assert "octf.unet.lr_middle" not in trace.snapshot()["spans"]
