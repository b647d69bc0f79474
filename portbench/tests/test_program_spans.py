"""``portbench/program_spans.py``: the program's spans read from synthetic
trace events, ``reduce``'s fields unchanged with program spans nested at
the places the program opens them, and a tiny traced run on the CPU with
the program's tracing on."""

import time

import pytest
import torch

from pbtest_util import few_threads, root  # noqa: F401

from portbench import program_spans as ps
from portbench.trace import NODE, Event, reduce

E = Event

# reduce's own test events (tests/test_portbench_parts.py) and the forward
# op of their IndexBackward0 node (seq 9 on thread 1)
BASE = [
    E("pb.item", False, 0, 1000, corr=1, thread=1, user=True),
    E("pb.graph_conv#0", False, 100, 300, corr=2, thread=1, user=True),
    E("GraphConvFunction", False, 110, 290, corr=3, thread=1, seq=7),
    E("k1", True, 150, 250, linked=3),
    E("aten::index", False, 325, 345, corr=11, thread=1, seq=9),
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
]
# the program's spans: a train stage around the forward, a gather span
# around the indexing forward
SPANS = [
    E("octf.train.forward_backward", False, 50, 450, corr=20, thread=1,
      user=True),
    E("octf.gather.norm", False, 320, 350, corr=21, thread=1, user=True),
]
CONVS = [{"g": 1000, "c": 32, "cout": 32, "e": 7000, "bf16": False}]


def _reduce(evs):
    return reduce(evs, CONVS, 4.95e5, [{}], 2, 495e12)


def test_reduce_fields_unchanged_with_program_spans():
    plain, spanned = _reduce(BASE), _reduce(BASE + SPANS)
    assert plain.keys() == spanned.keys()
    for k in plain:
        if k != "breakdown":
            assert plain[k] == spanned[k], k
    assert plain["breakdown"]["device_ops"] == \
        spanned["breakdown"]["device_ops"]
    # an idle gap that starts inside a program span is labelled by it
    gaps = dict(spanned["breakdown"]["idle_gaps"])
    assert gaps["octf.train.forward_backward"] == pytest.approx(90e-9)
    assert "octf.train.forward_backward" not in dict(
        plain["breakdown"]["idle_gaps"])


def test_gather_backward_by_span():
    evs = BASE + SPANS
    out = ps.read(evs, None, None)
    by = out["index_bwd_by_span_s"]
    assert by["octf.gather.norm"] == pytest.approx(50e-9)
    assert sum(by.values()) == pytest.approx(_reduce(evs)["index_bwd_s"])
    t = dict(_reduce(evs), **out, kind="train")
    norm = ps.METRICS["gather_bwd_norm_share.train"][1](t)
    assert norm == pytest.approx(100 * 50e-9 / t["device_s"])
    assert ps.METRICS["gather_bwd_embed_share.train"][1](t) == 0.0
    assert ps.METRICS["denoise_step_host_ms.gen"][1](t) is None
    # the same events from a program that opens no spans: nothing to read
    bare = dict(_reduce(BASE), **ps.read(BASE, None, None), kind="train")
    assert all(read(bare) is None for _, read in ps.METRICS.values())


def test_denoise_steps():
    def span(name, a, b, corr):
        return E(name, False, a, b, corr=corr, thread=1, user=True)

    evs = [
        span("pb.item", 0, 1000, 1),
        span("octf.sample.lr", 0, 100, 2),
        span("octf.sampler.step", 10, 90, 3),
        E("aten::sign", False, 20, 25, corr=4, thread=1),
        E("sign", True, 30, 60, linked=4),
        span("octf.sample.hr", 100, 900, 5),
        span("octf.sampler.step", 100, 400, 6),
        E("aten::mm", False, 150, 155, corr=7, thread=1),
        E("mm", True, 200, 300, linked=7),
        E("aten::add", False, 160, 165, corr=8, thread=1),
        E("add", True, 250, 350, linked=8),
        span("octf.sampler.step", 400, 700, 9),
        E("aten::mul", False, 450, 455, corr=10, thread=1),
        E("mul", True, 500, 520, linked=10),
    ]
    setup = {"spans": {"octf.setup.solver": {"count": 1, "host_s": 2.5},
                       "octf.setup.kernels": {"count": 2, "host_s": 21.0}},
             "by_stage": {}}
    window = {"spans": {}, "by_stage": {
        "octf.sample.hr": {"octf.sampler.step": {"count": 4,
                                                 "host_s": 0.12},
                           "octf.sampler.denoise": {"count": 4,
                                                    "host_s": 0.11}},
        "octf.sample.lr": {"octf.sampler.step": {"count": 4,
                                                 "host_s": 9.0}},
        "octf.sample.decode": {"octf.gather.move": {"count": 1,
                                                    "host_s": 1.0}}}}
    out = ps.read(evs, setup, window)
    assert out["solver_build_s"] == 2.5
    assert out["kernels_build_s"] == 21.0
    # update = step - denoise, a step; lr recorded no denoise span here
    assert out["step_split_ms"] == {"hr": pytest.approx(
        {"step": 30.0, "denoise": 27.5, "update": 2.5})}
    step = out["denoise_step"]
    assert step["count_profiled"] == 2 and step["count"] == 4
    assert step["device_ms"] == pytest.approx(1e-6 * (150 + 20) / 2)
    assert step["host_ms_profiled"] == pytest.approx(1e-6 * 300)
    assert step["host_ms"] == pytest.approx(30.0)
    t = dict(out, kind="gen")
    assert ps.METRICS["denoise_step_host_ms.gen"][1](t) == \
        pytest.approx(30.0)
    assert ps.METRICS["solver_build_s"][1](t) == 2.5


@pytest.mark.parametrize("workload", ["snet-gen-dpmpp25", "snet-train-hr"])
def test_traced_run_on_the_cpu(root, workload, monkeypatch):  # noqa: F811
    """The traced run's plumbing with the program's tracing on: reduce is
    handed one stand-in device operation, as the CPU has none."""
    from portbench import run as pr
    from portbench import trace as pb_trace

    real = pb_trace.reduce

    def one_device_op(evs, *a, **k):
        lo = min(e.start for e in evs if e.name == "pb.item")
        return real(evs + [E("stand-in", True, lo, lo + 1, linked=-1)],
                    *a, **k)

    monkeypatch.setattr(pb_trace, "reduce", one_device_op)
    cell = pr.Cell(root, workload)
    cell.traffic = dict(cell.traffic, check_range=1, trace_items=1)
    res = ps.traced_run(cell, 987654321987, 0.0, torch.device("cpu"),
                        log=lambda *a: None, t_start=time.perf_counter())
    assert res["correct"], res["checks"]
    assert res["metrics"]["solver_build_s"]["value"] > 0
    prog = res["program"]
    assert prog["window_spans"]["spans"]
    if workload.startswith("snet-gen"):
        assert res["metrics"]["denoise_step_host_ms.gen"]["value"] > 0
        assert prog["denoise_step"]["count_profiled"] > 0
        for split in (prog["step_split_ms"]["lr"],
                      prog["step_split_ms"]["hr"]):
            assert split["denoise"] > 0 and split["update"] > 0
            assert split["step"] == pytest.approx(
                split["denoise"] + split["update"])
    else:
        assert prog["index_bwd_by_span_s"]
        assert "octf.train.forward_backward" in \
            prog["window_spans"]["spans"]
    assert pb_trace.reduce is one_device_op
    from octfusion_tpu_torch.utils import trace as octf
    assert octf.span("x") is octf.span("y")          # tracing off again


def test_traced_run_checks_run_cells_order(root, monkeypatch):  # noqa: F811
    """traced_run's snapshots rely on run_cell asking for the modules
    after the unprofiled items: another order fails loudly."""
    from portbench import run as pr

    def out_of_order(cell, seed, seconds, trace, device, **k):
        cell.generator().Traffic(cell.config_file, cell.traffic, seed,
                                 device, check_range=1).modules()

    monkeypatch.setattr(pr, "run_cell", out_of_order)
    cell = pr.Cell(root, "snet-gen-dpmpp25")
    with pytest.raises(AssertionError, match="order"):
        ps.traced_run(cell, 5, 0.0, torch.device("cpu"),
                      log=lambda *a: None, t_start=time.perf_counter())
    from octfusion_tpu_torch.utils import trace as octf
    assert octf.span("x") is octf.span("y")          # tracing off again


def test_cost_on_the_cpu(root):  # noqa: F811
    from portbench import run as pr

    out = ps.cost(pr.Cell(root, "snet-train-hr"), 987654321987, 2,
                  torch.device("cpu"), log=lambda *a: None)
    assert len(out["walls"]["off"]) == len(out["walls"]["on"]) == 2
    assert out["spans_per_item"] > 0
    assert out["span_us"]["on"] > out["span_us"]["off"] > 0
    from octfusion_tpu_torch.utils import trace as octf
    assert octf.snapshot()["spans"] == {}
