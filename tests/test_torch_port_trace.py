"""The port's program-side tracing (``octfusion_tpu_torch/utils/trace.py``)
on the tiny configuration, on the CPU:

* off (the default) nothing is recorded and ``record_function`` is never
  entered;
* on, ``sample()`` gives the same outputs bit for bit and the same
  ``seconds`` keys as off, and each sampling stage records one
  ``octf.sampler.step`` a step;
* ``Laps`` synchronises once a stage end with ``sync`` and never without;
* under a CPU ``torch.profiler``, every ``Index*Backward`` node of an hr
  train step (with checkpointed blocks) has its forward under an
  ``octf.gather.*`` span, and no ``octf.*`` span opens inside a graph
  conv's call or inside autograd's backward;
* the counter of the per-sample broadcasts' one-hot backward
  (``graph_ops.batch_broadcast.backward_calls``) rises in a train step
  and stays put while sampling.
"""

import os
import re

import pytest
import torch

from octfusion_tpu_torch.config import load_config
from octfusion_tpu_torch.models.common import Laps
from octfusion_tpu_torch.models.union_solver import UnionSolver
from octfusion_tpu_torch.nn.modules import GraphConv
from octfusion_tpu_torch.utils import trace
from octfusion_tpu_torch.utils.shapes import lumpy_spheres

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_YAML = os.path.join(REPO, "configs", "synthetic_tiny.yaml")
STEPS = 2
NODE = "autograd::engine::evaluate_function: "
INDEX_BWD = re.compile(r"evaluate_function: Index\w*Backward")
BCAST = "graph_ops.batch_broadcast.backward_calls"


@pytest.fixture(autouse=True)
def tracing_off():
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


@pytest.fixture(scope="module")
def solver():
    return UnionSolver(load_config(TINY_YAML), device="cpu")


def _sample(solver):
    out = solver.sample(batch_size=1, steps=STEPS,
                        generator=torch.Generator().manual_seed(5))
    return out, {k: out[k] for k in ("split_small", "code", "sdfs")}


def _batch():
    pts, nrm = lumpy_spheres(2, 2048, seed=3)
    return {"points": pts, "normals": nrm}


def test_off_records_nothing(solver, monkeypatch):
    entered = []
    for mod in (torch.profiler, torch.autograd.profiler):
        def watch(name, *a, orig=mod.record_function, **k):
            entered.append(name)
            return orig(name, *a, **k)

        monkeypatch.setattr(mod, "record_function", watch)
    assert trace.span("a") is trace.span("b")
    _sample(solver)
    solver.make_train_step()(_batch(),
                             generator=torch.Generator().manual_seed(1))
    assert trace.snapshot()["spans"] == {}
    assert not [n for n in entered if n.startswith("octf.")]


def test_on_and_off_sample_alike(solver):
    n0 = trace.snapshot()["counters"][BCAST]
    off, off_t = _sample(solver)
    trace.enable()
    on, on_t = _sample(solver)
    trace.disable()
    for k in off_t:
        assert torch.equal(off_t[k], on_t[k]), k
    assert list(off["seconds"]) == list(on["seconds"]) == [
        "lr", "grow", "hr", "decode", "sdf"]
    snap = trace.snapshot()
    for stage in ("lr", "hr"):
        steps = snap["by_stage"][f"octf.sample.{stage}"]
        assert steps["octf.sampler.step"]["count"] == STEPS
        assert steps["octf.sampler.denoise"]["count"] == STEPS
    assert {f"octf.sample.{k}" for k in on["seconds"]} <= set(snap["spans"])
    assert snap["spans"]["octf.gather.norm"]["count"] > 0
    assert snap["counters"]["graph_conv.calls"] == GraphConv.calls
    assert snap["counters"][BCAST] == n0


def test_laps_sync_points(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: calls.append(device))
    for sync, expect in ((True, 3), (False, 0)):
        calls.clear()
        with Laps("cuda", "train", sync=sync) as lap:
            lap("graph")
            lap("forward_backward")
            lap("optimizer_ema")
        assert len(calls) == expect
        assert list(lap.seconds) == ["graph", "forward_backward",
                                     "optimizer_ema"]


def _ancestor_span(ev, prefixes):
    """The nearest enclosing event of ``ev`` whose name starts with one of
    ``prefixes``, or None."""
    p = ev.cpu_parent
    while p is not None:
        if p.name.startswith(prefixes):
            return p.name
        p = p.cpu_parent
    return None


def test_gather_backward_maps_to_spans():
    cfg = load_config(TINY_YAML)
    cfg = cfg.__class__(**{**cfg.__dict__, "model": cfg.model.__class__(
        **{**cfg.model.__dict__, "use_checkpoint": True})})
    solver = UnionSolver(cfg, device="cpu")
    step = solver.make_train_step()
    batch, gen = _batch(), torch.Generator().manual_seed(1)
    # a span around each graph conv call, as the benchmark's hooks open one
    open_spans = []

    def pre(mod, args):
        open_spans.append(torch.profiler.record_function("test.graph_conv"))
        open_spans[-1].__enter__()

    def post(mod, args, out):
        open_spans.pop().__exit__(None, None, None)

    handles = [h for m in solver.df.modules() if isinstance(m, GraphConv)
               for h in (m.register_forward_pre_hook(pre),
                         m.register_forward_hook(post))]
    trace.enable()
    n0 = trace.snapshot()["counters"][BCAST]
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        step(batch, generator=gen)
    for h in handles:
        h.remove()
    assert trace.snapshot()["counters"][BCAST] > n0
    events = prof.events()
    octf = [e for e in events if e.name.startswith("octf.")]
    assert {"octf.train.graph", "octf.train.encode",
            "octf.train.forward_backward", "octf.train.optimizer_ema",
            "octf.gather.norm", "octf.gather.embed",
            "octf.gather.move"} <= {e.name for e in octf}
    for e in octf:
        assert _ancestor_span(e, ("test.graph_conv", NODE)) is None, e.name
    fwd = {}
    for e in events:
        if e.sequence_nr >= 0 and not e.name.startswith(NODE):
            span = _ancestor_span(e, ("octf.", "test."))
            if span is not None and span.startswith("octf.gather."):
                fwd[(e.thread, e.sequence_nr)] = span
    nodes = [e for e in events if INDEX_BWD.search(e.name)]
    assert nodes
    missing = [e.name for e in nodes
               if (e.fwd_thread, e.sequence_nr) not in fwd]
    assert not missing
