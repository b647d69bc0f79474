"""The benchmark's parts on the CPU: the import guard, the frozen cost
functions against the program's, and the interval, roofline and FLOP
arithmetic on synthetic traces.  The control test needs the card and
skips without one."""

import json
import os
import subprocess
import sys

import pytest
import torch

from pbtest_util import PB, REPO, few_threads, make_root  # noqa: F401

GUARD = r"""
import glob, importlib, json, os, sys
sys.path.insert(0, {repo!r})
mods = {mods!r}
for m in mods:
    importlib.import_module(m)
from portbench import run as pr
for kind in ("metrics", "end_to_end"):
    for path in sorted(glob.glob(os.path.join({pb!r}, kind, "*.py"))):
        pr._load_file(path, "x_" + os.path.basename(path))
for path in glob.glob(os.path.join({pb!r}, "configs", "*.json")) + \
        glob.glob(os.path.join({pb!r}, "traffic", "*.json")):
    json.load(open(path))
print(json.dumps(sorted({{n.split(".")[0] for n in sys.modules}})))
"""

REFERENCE = ["portbench.reference.judge", "portbench.inputs",
             "portbench.record", "portbench.frozen.idle",
             "portbench.frozen.roofline", "portbench.frozen.shapes"] + [
    "portbench.reference." + os.path.splitext(p)[0].replace(os.sep, ".")
    for p in sorted(
        os.path.relpath(os.path.join(d, f), os.path.join(PB, "reference"))
        for d, _, fs in os.walk(os.path.join(PB, "reference"))
        for f in fs if f.endswith(".py") and f != "__init__.py")]


def _loaded(mods):
    code = GUARD.format(repo=REPO, pb=PB, mods=mods)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_import_guard_harness():
    """The harness, every generator, config, traffic and metric file, the
    control and the reference load no JAX and not the JAX package (the
    program itself is imported too, as the generators import it)."""
    mods = ["portbench.run", "portbench.trace", "portbench.control",
            "portbench.generators.gen_cascade", "portbench.generators.train_step",
            "octfusion_tpu_torch.models.union_3t_solver"] + REFERENCE
    loaded = _loaded(mods)
    assert not loaded & {"jax", "jaxlib", "flax", "octfusion_tpu"}, loaded
    assert "octfusion_tpu_torch" in loaded


def test_import_guard_reference():
    """The reference takes nothing from the program."""
    loaded = _loaded(REFERENCE)
    assert not loaded & {"jax", "jaxlib", "flax", "octfusion_tpu",
                         "octfusion_tpu_torch"}, loaded


def test_forbidden_names_are_whole():
    from portbench import run as pr

    before = set(sys.modules)
    sys.modules["octfusion_tpu_torchx"] = sys
    try:
        assert "octfusion_tpu" not in pr.forbidden_modules()
    finally:
        del sys.modules["octfusion_tpu_torchx"]
    assert before <= set(sys.modules)


SHAPES = [(16384, 3, 128, 150000), (16384, 128, 128, 150000),
          (8192, 512, 512, 60000), (131072, 64, 64, 1200000),
          (1048576, 8, 16, 9000000)]


@pytest.mark.parametrize("g,c,cout,e", SHAPES)
def test_frozen_costs_equal_the_programs(g, c, cout, e):
    from octfusion_tpu_torch.ops import roofline as prog
    from portbench.frozen import roofline as frozen

    for elem in (frozen.F32, frozen.BF16):
        assert frozen.graph_conv_fwd_cost(g, c, cout, e, elem) == \
            prog.graph_conv_fwd_cost(g, c, cout, e, elem)
        assert frozen.graph_conv_bwd_dx_cost(g, c, cout, e, elem) == \
            prog.graph_conv_bwd_dx_cost(g, c, cout, e, elem)
        assert frozen.graph_conv_col_cost(g, c, e, elem) == \
            prog.graph_conv_col_cost(g, c, e, elem)
    for name in prog.FLOPS_RATE:
        assert frozen.FLOPS_RATE[name] == prog.FLOPS_RATE[name]
        assert frozen.bound_times(name, 1e12, 1e9) == \
            prog.bound_times(name, 1e12, 1e9)
    assert frozen.HBM_BYTES == prog.HBM_BYTES
    fl, by = prog.graph_conv_fwd_cost(g, c, cout, e)
    assert frozen.conv_bound_s("fwd", g, c, cout, e) == max(
        fl / prog.TF32_FLOPS, by / prog.HBM_BYTES)


def test_intervals():
    from portbench.frozen import idle

    iv = [(0, 10), (5, 20), (30, 40), (35, 36), (50, 50)]
    assert idle.merged(iv) == [(0, 20), (30, 40)]
    assert idle.union_length(iv) == 30
    assert idle.gaps(iv, -5, 45) == [(-5, 0), (20, 30), (40, 45)]
    assert idle.clip(iv, 8, 32) == [(8, 10), (8, 20), (30, 32)]
    si = idle.SpanIndex([(0, 100, "a"), (10, 20, "b"), (12, 15, "c"),
                         (30, 40, "d")])
    assert [si.key(si.innermost(t)) for t in (5, 11, 13, 16, 25, 35, 100)] \
        == ["a", "b", "c", "b", "a", "d", None]


def test_reduce_charges_devices_ops_to_their_spans():
    from portbench.trace import NODE, Event, reduce

    E = Event
    evs = [
        E("pb.item", False, 0, 1000, corr=1, thread=1, user=True),
        E("pb.graph_conv#0", False, 100, 300, corr=2, thread=1, user=True),
        E("GraphConvFunction", False, 110, 290, corr=3, thread=1, seq=7),
        E("k1", True, 150, 250, linked=3),
        E("aten::add", False, 400, 410, corr=4, thread=1, seq=8),
        E("add", True, 420, 430, linked=4),
        E(NODE + "GraphConvFunctionBackward", False, 500, 700, corr=5,
          thread=2, seq=7, fwd_thread=1),
        E("GraphConvFunctionBackward", False, 505, 690, corr=6, thread=2,
          seq=7, fwd_thread=1),
        E("pb.fwd", False, 510, 540, corr=9, thread=2, user=True),
        E("aten::mul", False, 515, 535, corr=10, thread=2),
        E("recomputed", True, 520, 530, linked=10),
        E("k3", True, 600, 650, linked=6),
        E(NODE + "IndexBackward0", False, 710, 800, corr=7, thread=2,
          seq=9, fwd_thread=1),
        E("aten::index_put_", False, 720, 790, corr=8, thread=2),
        E("idx", True, 730, 780, linked=8),
        E("k3", True, 1500, 1600, linked=6),          # outside the window
    ]
    convs = [{"g": 1000, "c": 32, "cout": 32, "e": 7000, "bf16": False}]
    s = reduce(evs, convs, 4.95e5, [{}], 2, 495e12)
    assert s["launches"] == 5 and s["shapes"] == 2
    assert s["window_s"] == pytest.approx(1e-6)
    assert s["busy_s"] == pytest.approx(220e-9)
    assert s["conv_device_s"] == pytest.approx(150e-9)   # k1 + k3
    assert s["index_bwd_s"] == pytest.approx(50e-9)
    from portbench.frozen import roofline

    bound = sum(roofline.conv_bound_s(r, 1000, 32, 32, 7000)
                for r in ("fwd", "col", "dx", "dw"))
    assert s["conv_bound_s"] == pytest.approx(bound)
    gaps = dict(s["breakdown"]["idle_gaps"])
    assert gaps["backward: IndexBackward0"] == pytest.approx(220e-9)
    # walls of items timed unprofiled: 2 items of 2 us each
    plain = dict(s, plain_s=4e-6, plain_items=2)
    mfu = _read("mfu.gen", dict(plain, kind="gen"))
    assert mfu == pytest.approx(100 * 4.95e5 / (2e-6 * 495e12))
    idle_share = _read("device_idle.train", dict(plain, kind="train"))
    assert idle_share == pytest.approx(100 * (1 - 220e-9 / 2e-6))
    assert _read("device_idle.gen", dict(plain, kind="train")) is None


def _read(metric, summary):
    from portbench import run as pr

    return pr._load_file(os.path.join(PB, "metrics", metric + ".py"),
                         "t_" + metric).read(summary)


def test_module_flops():
    from octfusion_tpu_torch.nn import modules
    from portbench.trace import module_flops

    lin = torch.nn.Linear(8, 16)
    x = torch.zeros(5, 8)
    assert module_flops(lin, (x,), lin(x)) == 2 * 5 * 8 * 16
    conv = torch.nn.Conv3d(4, 6, 3, padding=1)
    v = torch.zeros(1, 4, 5, 5, 5)
    assert module_flops(conv, (v,), conv(v)) == 2 * 125 * 6 * 4 * 27
    gc = modules.GraphConv(8, 16)
    y = torch.zeros(10, 16)
    assert module_flops(gc, (torch.zeros(10, 8), None), y) == \
        2 * 10 * 7 * 8 * 16
    down = modules.ChildDownsample(4)
    assert module_flops(down, (torch.zeros(16, 4),), torch.zeros(2, 4)) == \
        2 * 16 * 4 * 4
    att = modules.AttentionBlock3D(8, 2)
    v = torch.zeros(1, 8, 2, 2, 2)
    assert module_flops(att, (v,), att(v)) == 4 * 8 * 8 * 8


def test_no_card_no_result(tmp_path):
    """Without a card the command exits non-zero and prints no result."""
    root = make_root(str(tmp_path))
    out = subprocess.run(
        [sys.executable, os.path.join(PB, "run.py"), "--workload",
         "snet-gen-dpmpp25", "--seed", "3", "--seconds", "1", "--trace",
         "0"], capture_output=True, text=True, timeout=300, cwd=root,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert "{" not in out.stdout


def test_control_fails_its_check(tmp_path):
    """The control (the reference in TF32 in the program's place) comes
    out not correct at a small size; needs the card."""
    if not torch.cuda.is_available():
        pytest.skip("the control's TF32 exists only on a CUDA card")
    from portbench import control
    from portbench import run as pr

    root = make_root(str(tmp_path))
    dev = torch.device("cuda", 0)
    for workload in ("snet-gen-dpmpp25", "snet-train-hr"):
        limits = pr.Cell(root, workload).limits
        for seed, what, nums in control.readings(root, workload, [5, 6, 7],
                                                 ["half_batch"], dev):
            assert any(nums[k] > lim for k, lim in limits.items()), \
                (workload, seed, what, nums)
