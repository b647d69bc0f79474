"""Program-side tracing: named spans where the port's work happens.

Off by default.  Off, :func:`span` returns one shared no-op context: it
tests a module-level bool and does nothing else (no clock read, no
profiler call, no allocation).  On (:func:`enable`), a span

* times itself on the host with ``time.perf_counter_ns()`` at enter and
  exit and adds its count and host seconds to its name, once in all and
  once within the innermost stage span around it (``octf.sample.*`` /
  ``octf.train.*``).  It never synchronises and reads nothing from the
  device;
* while a ``torch.profiler`` is recording, also opens
  ``torch.profiler.record_function(name)``, so the span lies in the
  profiler's trace on the clock of the device operations it launched.
  Without a profiler that costs about 10 µs an enter and exit, which is
  why it is left out then.

Inside autograd's backward (a checkpoint's recomputation included) a span
is the no-op: the benchmark charges the device operations launched there
to the autograd node being evaluated, and a span nested there would move
them.  For the same reason no span opens inside a graph conv's forward.

Names are ``octf.<layer>.<what>``:

* ``octf.sample.<stage>`` / ``octf.train.<stage>``: the solvers' stages
  (``models/common.Laps``) and ``octf.train.allreduce`` (``GradSync``);
* ``octf.sampler.step`` around one denoising step and
  ``octf.sampler.denoise`` around its U-Net call (``diffusion/sampler``);
* ``octf.gather.norm`` (``dual_group_norm``'s broadcasts of the
  per-sample statistics), ``octf.gather.embed``
  (``add_batch_embedding``), ``octf.gather.move`` (the splices,
  ``graph_to_level_arrays``, ``Octree.to_voxel`` / ``from_voxel``) and
  ``octf.gather.mpu`` (the MPU's corner gathers);
* ``octf.setup.solver`` (a solver's modules built on the device) and
  ``octf.setup.kernels`` (a CUDA library built and loaded).

:func:`snapshot` returns the recorded spans with the counters the port
keeps where it counts (graph-conv calls and backward calls, kernel
launches), read there; :func:`reset` clears the spans only.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict

import torch

_STAGES = ("octf.sample.", "octf.train.")

_on = False
_NOOP = contextlib.nullcontext()
_lock = threading.Lock()
_local = threading.local()
# (enclosing stage or None, name) -> [count, host nanoseconds]
_totals: Dict[tuple, list] = {}


def enable() -> None:
    """Record spans from now on."""
    global _on
    _on = True


def disable() -> None:
    """Stop recording; spans already open still record their exit."""
    global _on
    _on = False


def reset() -> None:
    """Forget the spans recorded so far (the counters keep their own
    resets)."""
    with _lock:
        _totals.clear()


def _stages() -> list:
    stack = getattr(_local, "stages", None)
    if stack is None:
        stack = _local.stages = []
    return stack


class _Span:
    __slots__ = ("name", "stage", "rf", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stages = _stages()
        self.stage = stages[-1] if stages else None
        if self.name.startswith(_STAGES):
            stages.append(self.name)
        self.rf = None
        if torch._C._autograd._profiler_enabled():
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        ns = time.perf_counter_ns() - self.t0
        if self.rf is not None:
            self.rf.__exit__(*exc)
        if self.name.startswith(_STAGES):
            _stages().pop()
        with _lock:
            rec = _totals.get((self.stage, self.name))
            if rec is None:
                _totals[(self.stage, self.name)] = [1, ns]
            else:
                rec[0] += 1
                rec[1] += ns
        return False


def span(name: str):
    """A context manager around the work of ``name``: the shared no-op
    while tracing is off or inside autograd's backward, else a recorded
    span."""
    if not _on or torch._C._current_autograd_node() is not None:
        return _NOOP
    return _Span(name)


def _counters() -> Dict:
    """The counters the port keeps where it counts, read there."""
    from ..nn.modules import GraphConv
    from ..ops import chamfer_cuda, graph_conv_cuda

    fn = graph_conv_cuda.GraphConvFunction
    return {"graph_conv.calls": GraphConv.calls,
            "graph_conv.calls_bf16": GraphConv.calls_bf16,
            "graph_conv.backward_calls": fn.backward_calls,
            "graph_conv.backward_calls_bf16": fn.backward_calls_bf16,
            "graph_conv_cuda.launches": dict(graph_conv_cuda.launches),
            "chamfer_cuda.launches": dict(chamfer_cuda.launches)}


def snapshot() -> Dict:
    """-> ``{"spans": {name: {"count", "host_s"}}, "by_stage": {stage:
    {name: {"count", "host_s"}}}, "counters": ...}``: the spans recorded
    since the last :func:`reset`, in all and within their innermost
    enclosing stage span, and the counters the port keeps where it
    counts (graph-conv calls and backward calls, kernel launches)."""
    spans: Dict[str, Dict] = {}
    by_stage: Dict[str, Dict] = {}
    with _lock:
        items = [(k, list(v)) for k, v in _totals.items()]
    for (stage, name), (count, ns) in items:
        tot = spans.setdefault(name, {"count": 0, "host_s": 0.0})
        tot["count"] += count
        tot["host_s"] += ns * 1e-9
        if stage is not None:
            by_stage.setdefault(stage, {})[name] = {"count": count,
                                                    "host_s": ns * 1e-9}
    return {"spans": spans, "by_stage": by_stage, "counters": _counters()}
