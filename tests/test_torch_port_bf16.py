"""The bf16 compute mode (``diffusion.compute_dtype: bfloat16``) of the
port against the JAX package's, at ``configs/synthetic_tiny.yaml`` widths
(and the snet hr widths for the dtype flow), JAX side jitted or traced:

* (a) the dtype flow: the (dtype, C, C') of every graph conv of the hr
  U-Net, recorded in the port and in JAX (``octfusion_tpu.ops.graph_ops.
  graph_conv`` patched for one ``jax.eval_shape`` trace of the module's
  ``init``), at the tiny widths and at the snet hr widths on a small
  depth-6 graph: the same sequence, 6 of 24 convs in bf16 at snet widths;
  the lr U-Net's output in bf16 mode equals its fp32 output on the
  bf16-rounded inputs, bit for bit (its first conv promotes to fp32, as
  flax's does);
* (b) the plain versions of K1 (C = 3 and C = 16), K5, K2, K3 (``dx``)
  and ``dW`` against the Pallas kernels in interpret mode at bf16
  (``with_conv_plans``, ``with_conv_plans(packed=True)``, ``jax.vjp``):
  within one bf16 ulp of the reference's largest magnitude, 2^-8 of it
  (they follow the Pallas arithmetic, so they meet it bit for bit here);
* (c) one hr and one lr U-Net call, and one hr train step's loss and
  every gradient, against JAX at bf16, from one jitted JAX function.
  The lr U-Net computes in fp32 after rounding its inputs, in both
  packages: within a hundredth of JAX's own bf16-vs-fp32 gap (measured
  under a thousandth).  The hr U-Net runs its finest levels in bf16, and
  there the packages round differently: off the TPU JAX runs the
  segment-sum conv (bf16 products and sums), the port the Pallas
  semantics (fp32 sums), and XLA's bf16 sigmoid differs from PyTorch's
  in about a third of its outputs by an ulp; carried through the U-Net,
  these ulps make the two bf16 results about as far apart as each is
  from the fp32 result.  So the hr results are held two ways: within
  twice JAX's gap of JAX's bf16 result, and at least a quarter of that
  gap from the port's own fp32 result on the same inputs (a port that
  computed the hr U-Net in fp32 would sit on it).  Gradient leaves are
  each within twice their own gap, plus 1e-6 of the step's largest
  gradient for leaves whose exact gradient is zero;
* (d) the 8-step cascade with injected noise at bf16 against JAX, stage
  by stage: the split grid exactly unless a sign decision sits within
  its margin (counted, at most 8), the grown graph exactly, the codes
  held as the hr call in (c); the decode and SDF (fp32 VAE code, held by
  ``test_torch_port_cascade.py``) finite;
* (e) one feature denoise step of the 3-stage model at bf16 against JAX,
  as the hr call in (c);
* (f) ``compute_dtype: float16`` raises a clear ``ValueError``;
* the bounds of the bf16 kernels (``ops/roofline.py``): the bf16
  tensor-core rate and 2-byte operands."""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from octfusion_tpu.models.union_solver import UnionSolver as JSolver
from octfusion_tpu.nn.unet_union import UNetUnion as JUNetUnion
from octfusion_tpu.nn.unet_union import UnionConfig as JUnionConfig
from octfusion_tpu.octree.dual_graph import with_conv_plans
from octfusion_tpu.ops import graph_ops as jops
from octfusion_tpu.ops.pallas import graph_conv_kernel as pallas_conv
from octfusion_tpu.utils import torch_convert as tc
from octfusion_tpu_torch import config as tconfig
from octfusion_tpu_torch.models.union_solver import UnionSolver as TSolver
from octfusion_tpu_torch.nn.unet_union import UNetUnion, UnionConfig
from octfusion_tpu_torch.octree.dual_graph import build_dual_graph as t_build
from octfusion_tpu_torch.ops import graph_conv_cuda as gc
from octfusion_tpu_torch.ops import graph_ops as tops
from octfusion_tpu_torch.ops import roofline
from octfusion_tpu_torch.utils import params as bridge

import torch_ref_unet as tru
import torch_ref_vae as tref
from test_torch_port_helpers import (TINY, jcfg, make_graph,
                                     np_, port_octree, tcfg, tiny_config)
from test_torch_port_helpers import one_torch_thread  # noqa: F401
from test_torch_port_union_3t import tiny_3t
from test_torch_port_union_3t import weights  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")
BF16_ULP = 2.0 ** -8
# the port's bf16 result against JAX's: each is about one bf16-vs-fp32 gap
# from the fp32 result (JAX's segment-sum conv rounds its products and sums
# in bf16, the port's Pallas semantics sum in fp32), so they sit within
# twice the gap of each other
GAP_FACTOR = 2.0
# ... and a port that computes in bf16 sits at least this share of the gap
# from its own fp32 result
GAP_FLOOR = 0.25
# the lr U-Net in bf16 mode is fp32 on rounded inputs in both packages
LR_GAP_SHARE = 1e-2
# the cascade's snapped lr decisions within their margin of the tie, at
# most (of 5 x 512)
NEAR_MAX = 8
DIFF = TINY["diffusion"]
LR_CFG = {"model_channels": 8, "channel_mult": (1, 2),
          "attention_resolutions": (2,)}
HR_CFG = {"model_channels": 16, "channel_mult": (1, 1),
          "num_res_blocks": (1, 0), "input_depth": 3, "full_depth": 2}
STEPS = 8
# the snet hr U-Net (configs/octfusion_snet_uncond.yaml, UnionConfig()
# defaults): its 24 graph convs as (dtype, C, C'), node-type channels left
# out, in call order
SNET_FLOW = ([("bfloat16", 3, 128), ("bfloat16", 128, 128),
              ("bfloat16", 128, 128), ("bfloat16", 128, 128),
              ("bfloat16", 128, 256), ("bfloat16", 256, 256)]
             + [("float32", c, cp) for c, cp in (
                 (256, 256), (256, 64), (64, 64), (128, 256), (256, 256),
                 (512, 512), (512, 512), (512, 512), (768, 256), (256, 256),
                 (384, 256), (256, 256), (256, 256), (384, 128), (128, 128),
                 (256, 128), (128, 128), (128, 3))])


def _bf16(cfg, mod):
    """``cfg`` (a ``Config`` of module ``mod``) with compute_dtype bf16."""
    return dataclasses.replace(cfg, diffusion=dataclasses.replace(
        cfg.diffusion, compute_dtype="bfloat16"))


def _union_cfgs(dtype, **over):
    kw = dict(input_depth=DIFF["input_depth"], full_depth=2,
              input_channels=DIFF["input_channels"],
              out_channels=DIFF["out_channels"],
              model_channels=DIFF["model_channels"],
              num_res_blocks=DIFF["num_res_blocks"],
              channel_mult=DIFF["channel_mult"],
              attention_resolutions=DIFF["attention_resolutions"],
              compute_dtype=dtype)
    kw.update(over)
    return (JUnionConfig(use_checkpoint=False, **kw),
            UnionConfig(**{**kw, "use_checkpoint": False}))


@pytest.fixture(scope="module")
def tiny():
    """The tiny U-Nets' seeded reference-layout weights (no zero layer),
    the VAE's, and one depth-4 graph in both packages.  The lr output is
    not widened as the fp32 cascade tests widen it: in bf16 a state of
    magnitude ~60 is quantised in steps of 0.25, which makes an 8-step lr
    trajectory chaotic across packages."""
    rng = np.random.RandomState(1)
    lr = tc.convert_unet_lr(tru.lr_make_state_dict(rng, LR_CFG),
                            LR_CFG["channel_mult"],
                            LR_CFG["attention_resolutions"])
    hr = tc.convert_unet_hr(
        tru.hr_make_state_dict(rng, HR_CFG, in_channels=2, out_channels=2,
                               lr_model_channels=8),
        HR_CFG["channel_mult"], HR_CFG["num_res_blocks"])
    m = TINY["model"]
    arch = (m["depth"], m["depth_stop"], m["depth_out"], m["resblk_num"])
    vae = tc.convert_vae(tref.make_state_dict(
        rng, *arch[:3], m["resblk_num"], m["channels"], m["embed_dim"]),
        *arch)
    jg = make_graph(seed=4, depth=4, full_depth=2, n=300)
    tg = t_build(port_octree(jg.octree), 9)
    return dict(params={"params": {"unet_lr": lr, "unet_hr": hr}}, vae=vae,
                arch=arch, jg=jg, tg=tg)


def _record_flow(monkeypatch, module):
    """Patches ``module.graph_conv`` to note each call's (dtype, C, C')."""
    flow = []
    inner = module.graph_conv

    def conv(x, w, lvl, n_node_type=0):
        flow.append((str(x.dtype).replace("torch.", ""), x.shape[1],
                     w.shape[1]))
        return inner(x, w, lvl, n_node_type)

    monkeypatch.setattr(module, "graph_conv", conv)
    return flow


def _jax_flow(monkeypatch, jcfg_, jgraph, x_shape):
    """The JAX hr U-Net's conv flow from one abstract trace of its
    ``init``, which runs the forward on the parameters it makes."""
    flow = _record_flow(monkeypatch, jops)
    jm = JUNetUnion(jcfg_, "hr")
    x = jax.ShapeDtypeStruct(x_shape, jnp.float32)
    t = jax.ShapeDtypeStruct((1,), jnp.float32)
    jax.eval_shape(
        lambda x, t, g: jm.init(jax.random.PRNGKey(0), "hr", x, t, g=g),
        x, t, jgraph)
    monkeypatch.undo()
    return flow


def _port_flow(monkeypatch, tcfg_, tgraph, c_in, device="cpu"):
    """The port's hr U-Net's conv flow from one forward on ``device``
    (``meta``: shapes and dtypes only)."""
    flow = _record_flow(monkeypatch, tops)
    torch.manual_seed(0)
    with torch.device(device):
        net = UNetUnion(tcfg_, "hr")
        x = torch.randn(tgraph.level(tcfg_.input_depth[1]).g_cap, c_in)
        t = torch.tensor([0.5])
    with torch.no_grad():
        out = net("hr", x, t, g=tgraph.to(device))
    monkeypatch.undo()
    assert out.dtype == torch.float32
    return flow


def test_dtype_flow_tiny(tiny, monkeypatch):
    jc, tc_ = _union_cfgs("bfloat16")
    got = _port_flow(monkeypatch, tc_, tiny["tg"], 2)
    want = _jax_flow(monkeypatch, jc, tiny["jg"],
                     (tiny["tg"].level(3).g_cap, 2))
    assert got == want
    n_bf16 = sum(d == "bfloat16" for d, _, _ in got)
    assert n_bf16 == 6 and got[n_bf16:][0][0] == "float32"
    assert all(d == "float32" for d, _, _ in got[n_bf16:])


def test_dtype_flow_snet_widths(monkeypatch):
    """The snet hr U-Net (input depth 6, full depth 4, 128 channels, mult
    (1, 2, 4)) on a small depth-6 graph: both graphs from one sphere of
    points, JAX's only traced, the port's run on the meta device (its
    arithmetic at 512 channels on the full depth-4 level would take
    seconds on the CPU, and the flow is the modules' casts)."""
    from octfusion_tpu.octree.dual_graph import build_dual_graph as j_build
    from octfusion_tpu.octree.octree import build_octree as j_octree
    from octfusion_tpu_torch.models.common import batch_to_graph
    from octfusion_tpu_torch.utils.shapes import lumpy_spheres

    spec = tconfig.CapacityConfig(finest_cap=8192, decay=4.0).octree_spec(
        6, 4)
    pts, nrm = lumpy_spheres(1, 2048, seed=2)
    _, tg = batch_to_graph(pts, nrm, spec, 10)
    jspec = jcfg.CapacityConfig(finest_cap=8192, decay=4.0).octree_spec(6, 4)
    jg = jax.eval_shape(lambda p, n: j_build(j_octree(p[0], n[0], jspec), 10),
                        jnp.asarray(np_(pts)), jnp.asarray(np_(nrm)))
    kw = dict(full_depth=4, compute_dtype="bfloat16")
    got = _port_flow(monkeypatch, UnionConfig(use_checkpoint=False, **kw),
                     tg, 3, device="meta")
    want = _jax_flow(monkeypatch, JUnionConfig(use_checkpoint=False, **kw),
                     jg, (tg.level(6).g_cap, 3))
    assert got == want == SNET_FLOW


def test_lr_unet_is_fp32_on_rounded_inputs(tiny):
    _, bf = _union_cfgs("bfloat16")
    _, f32 = _union_cfgs("float32")
    nets = []
    for cfg in (bf, f32):
        net = UNetUnion(cfg, "lr")
        net.load_state_dict(bridge.union_state_dict(
            {"params": {"unet_lr": tiny["params"]["params"]["unet_lr"]}},
            cfg), strict=True)
        nets.append(net)
    rng = np.random.RandomState(2)
    x, sc = (torch.tensor(rng.normal(size=(2, 4, 4, 4, 8)).astype(np.float32))
             for _ in range(2))
    t = torch.tensor([0.3, -1.1])
    rnd = lambda a: a.to(torch.bfloat16).to(torch.float32)
    with torch.no_grad():
        got = nets[0]("lr", x, t, x_self_cond=sc)
        want = nets[1]("lr", rnd(x), t, x_self_cond=rnd(sc))
        plain = nets[1]("lr", x, t, x_self_cond=sc)
    assert got.dtype == torch.float32
    assert torch.equal(got, want)
    assert not torch.equal(got, plain)


# ----------------------------------------------------------------------
# (b) the plain versions against the Pallas kernels at bf16
# ----------------------------------------------------------------------
def test_plain_versions_match_pallas_bf16(tiny):
    jg, tg = tiny["jg"], tiny["tg"]
    d = 3
    lvl = tg.level(d)
    g = lvl.g_cap
    jp = with_conv_plans(jg, depths=(d,))
    jk = with_conv_plans(jg, depths=(d,), packed=True)
    rng = np.random.RandomState(0)
    arr = lambda *s: rng.normal(size=s).astype(np.float32)
    x16, w16, cot = arr(g, 16), arr(7 * 16, 24) * 0.3, arr(g, 24)
    x3, w3 = arr(g, 3), arr(7 * 3, 16) * 0.3
    bf = jnp.bfloat16

    @jax.jit
    def pallas(x16, w16, x3, w3, cot, jp, jk):
        x16, w16, x3, w3, cot = (a.astype(bf) for a in (x16, w16, x3, w3, cot))
        out, vjp = jax.vjp(lambda x, w: jops.graph_conv(x, w, jp.level(d)),
                           x16, w16)
        dx, dw = vjp(cot)
        return dict(
            k1=out, dx=dx, dw=dw,
            k1_c3=jops.graph_conv(x3, w3, jp.level(d)),
            k5=jops.graph_conv(x16, w16, jk.level(d)),
            k2=pallas_conv._run_col(jp.level(d).conv_plan, x16, True)[:g])

    want = pallas(x16, w16, x3, w3, cot, jp, jk)
    edges = (lvl.edge_row, lvl.edge_col, lvl.edge_dir, lvl.edge_scale)
    t = lambda a: torch.tensor(a).to(torch.bfloat16)
    xt, wt = t(x16).requires_grad_(), t(w16).requires_grad_()
    out = gc.GraphConvFunction.apply(xt, wt, lvl)
    out.backward(t(cot))
    got = dict(k1=out, dx=xt.grad, dw=wt.grad,
               k1_c3=gc.graph_conv_plain(t(x3), t(w3), *edges),
               k5=gc.graph_conv_packed_plain(t(x16), t(w16), *edges),
               k2=gc.graph_conv_col_plain(t(x16), *edges))
    for k, ref in want.items():
        assert got[k].dtype == torch.bfloat16, k
        ref = np.asarray(ref.astype(jnp.float32))
        err = np.abs(np_(got[k].float()) - ref).max()
        scale = np.abs(ref).max()
        assert scale > 0, k
        assert err <= BF16_ULP * scale, (k, err, scale)


# ----------------------------------------------------------------------
# (c) U-Net calls and the hr train step against JAX at bf16
# ----------------------------------------------------------------------
def _within_gap(got, want, want_f32, what, floor=0.0, got_f32=None):
    """``got`` (the port's bf16 result) within ``GAP_FACTOR`` times JAX's
    own bf16-vs-fp32 gap (the largest |``want`` - ``want_f32``|) of
    ``want``, plus ``floor``; the gap is not zero unless ``floor`` is
    given.  With ``got_f32``, the port's fp32 result on the same inputs,
    ``got`` also sits at least ``GAP_FLOOR`` times the gap from it."""
    got, want, want_f32 = (np.asarray(a, np.float64)
                           for a in (got, want, want_f32))
    gap = np.abs(want - want_f32).max()
    err = np.abs(got - want).max()
    assert gap > 0 or floor > 0, what
    assert err <= GAP_FACTOR * gap + floor, (what, err, gap)
    if got_f32 is not None:
        off = np.abs(got - np.asarray(got_f32, np.float64)).max()
        assert off >= GAP_FLOOR * gap, (what, off, gap)


def _port_unets(params):
    """The port's tiny U-Nets at bf16 and at fp32 on ``params``."""
    nets = {}
    for dt in ("bfloat16", "float32"):
        nets[dt] = UNetUnion(_union_cfgs(dt)[1], "hr")
        nets[dt].load_state_dict(
            bridge.union_state_dict(params, nets[dt].config), strict=True)
    return nets


@pytest.fixture(scope="module")
def jax_step(tiny):
    """JAX at bf16 and at fp32, from one jitted function: the hr train
    step's loss, gradients and U-Net call (output, noised input, log-SNR)
    on one graph and code, with JAX's own draws, and one lr U-Net call ->
    {"code", "times", "noise", "xl", "sc", "tl", dtype: {"loss", "grads",
    "hr", "noised", "snr", "lr"}}, as numpy."""
    from octfusion_tpu.diffusion import sampler as jsampler
    from octfusion_tpu.diffusion import schedule as jschedule

    params, jg, tg = tiny["params"], tiny["jg"], tiny["tg"]
    lvl = tg.level(3)
    rng = np.random.RandomState(6)
    code = np.where(np_(lvl.node_mask)[:, None],
                    rng.normal(size=(lvl.g_cap, 2)), 0).astype(np.float32)
    xl, sc = (rng.normal(size=(2, 4, 4, 4, 8)).astype(np.float32)
              for _ in range(2))
    tl = np.array([0.7, -0.4], np.float32)
    key = jax.random.PRNGKey(5)
    log_snr = jschedule.get_log_snr("linear")
    jms = [JUNetUnion(_union_cfgs(dt)[0], "hr")
           for dt in ("bfloat16", "float32")]

    @jax.jit
    def run(p, code, xl, sc, tl, g, key):
        jl = g.level(3)
        tkey, nkey = jax.random.split(key)
        draws = (jax.random.uniform(tkey, (1,)),
                 jax.random.normal(nkey, code.shape))

        def loss(hr, m):
            q = {"params": {**p["params"], "unet_hr": hr}}
            seen = []

            def denoise(noised, snr):
                seen.append((m.apply(q, "hr", noised, snr, g=g), noised,
                             snr))
                return seen[-1][0]

            return jsampler.diffusion_loss(
                denoise, key, code, jl.node_batch, 1, log_snr, "eps",
                mask=jl.node_mask), seen[0]

        return draws, [
            (jax.value_and_grad(loss, has_aux=True)(p["params"]["unet_hr"],
                                                    m),
             m.apply(p, "lr", xl, tl, x_self_cond=sc)) for m in jms]

    (times, noise), per_dtype = jax.device_get(
        run(params, code, xl, sc, tl, jg, key))
    out = dict(code=code, times=np_(times), noise=np_(noise), xl=xl, sc=sc,
               tl=tl)
    for dt, (((loss_, (hr, noised, snr)), grads), lr) in zip(
            ("bfloat16", "float32"), per_dtype):
        out[dt] = dict(loss=float(loss_), grads=grads, hr=np_(hr),
                       noised=np_(noised), snr=np_(snr), lr=np_(lr))
    return out


def test_unet_calls_match_jax(tiny, jax_step):
    """The hr U-Net on the train step's noised code, and the lr U-Net on
    a batch of 2: the hr output as the module docstring's (c) says; the
    lr output within ``LR_GAP_SHARE`` of JAX's lr bf16-vs-fp32 gap."""
    b, f = jax_step["bfloat16"], jax_step["float32"]
    assert np.array_equal(b["noised"], f["noised"])
    nets = _port_unets(tiny["params"])
    with torch.no_grad():
        hr = {dt: np_(net("hr", torch.tensor(b["noised"]),
                          torch.tensor(b["snr"]), g=tiny["tg"]))
              for dt, net in nets.items()}
        lr = nets["bfloat16"]("lr", torch.tensor(jax_step["xl"]),
                              torch.tensor(jax_step["tl"]),
                              x_self_cond=torch.tensor(jax_step["sc"]))
    assert lr.dtype == torch.float32
    _within_gap(hr["bfloat16"], b["hr"], f["hr"], "hr",
                got_f32=hr["float32"])
    lr_gap = np.abs(b["lr"] - f["lr"]).max()
    assert lr_gap > 0
    assert np.abs(np_(lr) - b["lr"]).max() <= LR_GAP_SHARE * lr_gap


def test_hr_train_step_matches_jax(tiny, jax_step):
    """The hr train step's loss and gradients, the part the compute dtype
    reaches: the port's ``UnionSolver.hr_loss`` (what ``TrainStep``
    differentiates, after the dtype-free graph build and frozen encode)
    and its backward against ``jax.value_and_grad`` of JAX's
    ``diffusion_loss`` over the same U-Net at bf16 and at fp32, on one
    graph and code, with JAX's times and noise injected: the loss and
    every trainable gradient within twice JAX's bf16-vs-fp32 gap (plus
    1e-6 of the step's largest gradient for leaves whose exact gradient
    is zero); the port's bf16 gradients, over all leaves, at least
    ``GAP_FLOOR`` times JAX's largest leaf gap from its fp32 ones."""
    params, tg = tiny["params"], tiny["tg"]
    grads = {}
    for dt, cfg in (("bfloat16", _bf16(tiny_config(tcfg), tcfg)),
                    ("float32", tiny_config(tcfg))):
        st = TSolver(cfg, device="cpu")
        st.df.load_state_dict(bridge.union_state_dict(params, st.union_cfg),
                              strict=True)
        st.df.unet_lr.requires_grad_(False)
        loss = st.hr_loss(tg, torch.tensor(jax_step["code"]),
                          times=torch.tensor(jax_step["times"]),
                          noise=torch.tensor(jax_step["noise"]))
        loss.backward()
        grads[dt] = {n: np_(p.grad) for n, p in st.df.named_parameters()
                     if p.requires_grad}
        if dt == "bfloat16":
            _within_gap(loss.item(), jax_step[dt]["loss"],
                        jax_step["float32"]["loss"], "loss")
    wrap = lambda gr: bridge.union_state_dict(
        {"params": {"unet_hr": gr}}, st.union_cfg)
    ref_b = wrap(jax_step["bfloat16"]["grads"])
    ref_f = wrap(jax_step["float32"]["grads"])
    assert sorted(grads["bfloat16"]) == sorted(ref_b)
    floor = 1e-6 * max(np.abs(np_(r)).max() for r in ref_b.values())
    gap = off = 0.0
    for n, got in grads["bfloat16"].items():
        want, want_f = (np_(r[n]).reshape(got.shape) for r in (ref_b, ref_f))
        _within_gap(got, want, want_f, n, floor)
        gap = max(gap, np.abs(want - want_f).max())
        off = max(off, np.abs(got - grads["float32"][n]).max())
    assert off >= GAP_FLOOR * gap, (off, gap)


# ----------------------------------------------------------------------
# (d) the cascade's lr and hr stages
# ----------------------------------------------------------------------
def test_cascade_matches_jax(tiny):
    """8 steps of the cascade with injected noise, both packages at bf16.
    The port's ``sample`` runs whole (its decode and SDF are the fp32 VAE
    code that ``test_torch_port_cascade.py`` holds: finite here); it is
    held stage by stage, each port stage fed JAX's output of the stage
    before, so that a sign decision near its tie cannot carry over:

    * lr: the port's split grid equals JAX's unless one of its snapped
      pre-snap outputs sits within its margin of the tie, twice the
      largest difference at that step between the port's lr U-Net and
      JAX's on the port's inputs of that step (one batched JAX call);
      such decisions are counted, at most 8;
    * grow: the port's octree and graph from JAX's split equal JAX's;
    * hr: the codes on that graph held as the hr call in (c), against
      JAX's hr stage at bf16 and at fp32 on the same graph and noise, and
      the port's at fp32."""
    from test_torch_port_helpers import assert_graph_equal

    params = tiny["params"]
    rng = np.random.RandomState(4)
    lr_noise = rng.normal(size=(STEPS + 1, 1, 8, 4, 4, 4)).astype(np.float32)
    sjs = []
    for cfg in (_bf16(tiny_config(jcfg), jcfg), tiny_config(jcfg)):
        sj = JSolver(cfg)
        sj.df = JUNetUnion(
            dataclasses.replace(sj.union_cfg, use_checkpoint=False), "hr")
        sjs.append(sj)
    key = jax.random.PRNGKey(3)
    split = jax.jit(lambda p, n: sjs[0].sample_lr(
        p, key, batch_size=1, steps=STEPS, noise_stream=n))(params, lr_noise)
    octree, g = jax.jit(sjs[0]._grow_fn(1))(split)
    # the eps path reads the initial state only
    hr_noise = rng.normal(size=(1, g.level(3).g_cap, 2)).astype(np.float32)
    code_b, code_f = jax.jit(lambda p, g, n: [s.sample_hr(
        p, key, g, batch_size=1, steps=STEPS, noise_stream=n) for s in sjs])(
            params, g, hr_noise)

    sts = {}
    for dt, cfg in (("bfloat16", _bf16(tiny_config(tcfg), tcfg)),
                    ("float32", tiny_config(tcfg))):
        sts[dt] = TSolver(cfg, device="cpu")
        sts[dt].df.load_state_dict(
            bridge.union_state_dict(params, sts[dt].union_cfg), strict=True)
    st = sts["bfloat16"]
    st.vae.load_state_dict(bridge.vae_state_dict(tiny["vae"],
                                                 *tiny["arch"]), strict=True)
    calls = []

    def record(mod, args, kwargs, out):
        if args[0] == "lr":
            calls.append((args[1], args[2], kwargs["x_self_cond"], out))

    hook = st.df.register_forward_hook(record, with_kwargs=True)
    try:
        got = st.sample(steps=STEPS, resolution=16, lr_noise=lr_noise,
                        hr_noise=hr_noise)
    finally:
        hook.remove()
    assert len(calls) == STEPS
    x, t, sc, out = (np.concatenate([np_(c[i]) for c in calls])
                     for i in range(4))
    ref = np.asarray(jax.jit(lambda p, x, t, sc: sjs[0].df.apply(
        p, "lr", x, t, x_self_cond=sc))(params, x, t, sc))
    near = 0
    for i in range(STEPS):
        if 1 - i / STEPS < 0.7:         # a snapped step
            margin = 2 * np.abs(out[i] - ref[i]).max()
            near += int((np.abs(out[i]) <= margin).sum())
    flips = int((np.sign(np_(got["split_small"])) != np.sign(np_(split)))
                .sum())
    assert flips <= near <= NEAR_MAX, (flips, near)
    assert np.isfinite(np_(got["sdfs"])).all()

    octree_t, g_t = st._grow_fn(1)(torch.tensor(np_(split)))
    assert_graph_equal(g_t, g)
    code, code32 = (s_.sample_hr(g_t, 1, steps=STEPS, noise_stream=hr_noise)
                    for s_ in sts.values())
    _within_gap(np_(code), code_b, code_f, "code", got_f32=np_(code32))


# ----------------------------------------------------------------------
# (e) the 3-stage model's feature denoise step
# ----------------------------------------------------------------------
def test_feature_step_matches_jax(tiny, weights):  # noqa: F811
    params = weights[0]
    jg, tg = tiny["jg"], tiny["tg"]
    base = TSolver(tiny_3t(tconfig), "lr", device="cpu").union_cfg
    jms = [JUNetUnion(dataclasses.replace(
        JSolver(tiny_3t(jcfg), "feature").union_cfg, use_checkpoint=False,
        compute_dtype=dt), "feature") for dt in ("bfloat16", "float32")]
    rng = np.random.RandomState(3)
    x = rng.normal(size=(tg.level(4).g_cap, 2)).astype(np.float32)
    t = np.array([0.7], np.float32)
    want = jax.jit(lambda p, x, t, g: [m.apply(p, "feature", x, t, g=g)
                                       for m in jms])(params, x, t, jg)
    got = {}
    for dt in ("bfloat16", "float32"):
        tm = UNetUnion(dataclasses.replace(base, compute_dtype=dt),
                       "feature")
        tm.load_state_dict(bridge.union_state_dict(params, tm.config),
                           strict=True)
        with torch.no_grad():
            got[dt] = np_(tm("feature", torch.tensor(x), torch.tensor(t),
                             g=tg))
    assert np.abs(np_(want[0])).max() > 0.1
    _within_gap(got["bfloat16"], *want, "feature", got_f32=got["float32"])


# ----------------------------------------------------------------------
# (f) the dtypes the port offers
# ----------------------------------------------------------------------
def test_float16_raises():
    with pytest.raises(ValueError, match="compute_dtype"):
        tconfig.DiffusionConfig(compute_dtype="float16")
    with pytest.raises(ValueError, match="compute_dtype"):
        UNetUnion(dataclasses.replace(UnionConfig(), compute_dtype="float16"))
    assert tconfig.DiffusionConfig(compute_dtype="bfloat16")


def test_bf16_bounds():
    """The bf16 entry points' bounds: K1 / K3 / K5's products at the bf16
    tensor-core rate, K2's sums at the fp32 rate; x, W and the outputs 2
    bytes an element, the CSR 4; fp32 costs unchanged."""
    rate = roofline.FLOPS_RATE
    for name in ("graph_conv_fwd_bf16", "graph_conv_bwd_dx_bf16",
                 "graph_conv_fwd_packed_bf16"):
        assert rate[name] == roofline.BF16_FLOPS == 989e12
    assert rate["graph_conv_col_bf16"] == roofline.FP32_FLOPS
    # K1 at the snet hr U-Net's level 6, (128 + 5) -> 128, G = 16384,
    # E = 102663
    g, c, cout, e = 16384, 133, 128, 102663
    csr = 4 * (7 * g + 1 + 2 * e)
    flops, nbytes = roofline.graph_conv_fwd_cost(g, c, cout, e, roofline.BF16)
    assert flops == 2 * g * 7 * c * cout + 2 * e * c
    assert nbytes == 2 * (g * c + 7 * c * cout + g * cout) + csr
    assert roofline.graph_conv_fwd_cost(g, c, cout, e) == (
        flops, 4 * (g * c + 7 * c * cout + g * cout) + csr)
    ops_ms, bytes_ms = roofline.bound_times("graph_conv_fwd_bf16", flops,
                                            nbytes)
    assert ops_ms == pytest.approx(flops / 989e12 * 1e3, rel=1e-12)
    assert bytes_ms == pytest.approx(nbytes / 3.35e12 * 1e3, rel=1e-12)
    # K2 writes [G, 7C] bf16
    assert roofline.graph_conv_col_cost(g, c, e, roofline.BF16) == (
        2 * e * c, 2 * (g * c + g * 7 * c) + csr)
    # K3: K1 with C and C' exchanged
    assert roofline.graph_conv_bwd_dx_cost(g, c, cout, e, roofline.BF16) == \
        roofline.graph_conv_fwd_cost(g, cout, c, e, roofline.BF16)
