"""The traced run's instrumentation and its reduction to per-layer
numbers.

Instrumentation (:class:`Instruments`), all from the benchmark's side,
and only on the profiled items (the traced run times as many items before
them with none of it, as the window runs them):
* a span ``pb.item`` around each profiled shape or step;
* forward hooks on every graph conv of the program: a span
  ``pb.graph_conv#<j>`` around call j, and a record of its work (rows G,
  the kernel's C and C', the edges present, the dtype), so that the
  roofline reads the same work whatever implements it;
* spans ``pb.unet.<stage>`` around the U-Nets' calls and ``pb.<method>``
  around the solver methods a generator names;
* model FLOPs by formula from module shapes (graph convs 2 G 7C C',
  ``Conv3d``/``Conv1d``, ``Linear``, the child mixes, the attention
  products), times 3 for a module whose weights train (forward and
  backward), 2 for one that only passes gradients on, 1 under
  ``no_grad``; a forward that a checkpoint recomputes is not counted.
  Only the module kinds counted carry these hooks;
* in a training run's backward, a span ``pb.fwd`` around each module of
  the U-Nets that a checkpoint recomputes, so that its kernels are not
  charged to the backward node that recomputes it (these hooks test one
  flag in the forward and do nothing else there).

Reduction (:func:`reduce`): each device operation of the profiler's trace
is charged to the innermost span open on the host thread where its
launching operation ran; a graph conv's backward is the autograd node
whose sequence number one of its forward's operations carries.
"""

from __future__ import annotations

import math
import re
import threading
from typing import Dict, List, NamedTuple

import torch
from torch.autograd import DeviceType

from .frozen import idle, roofline

INDEX_BWD = re.compile(r"evaluate_function: Index\w*Backward")
NODE = "autograd::engine::evaluate_function: "


def _annotation(e) -> bool:
    """A device-side copy of a host span, not a device operation."""
    kind = getattr(e, "activity_type", lambda: "")()
    return kind == "gpu_user_annotation" or e.is_user_annotation()


def _in_backward() -> bool:
    return torch._C._current_autograd_node() is not None


class _Span:
    """A ``record_function`` scope opened in a pre-hook and closed in the
    matching post-hook, kept per thread."""

    def __init__(self):
        self._open: Dict[int, List] = {}

    def enter(self, name: str) -> None:
        rf = torch.autograd.profiler.record_function(name)
        rf.__enter__()
        self._open.setdefault(threading.get_ident(), []).append(rf)

    def exit(self) -> None:
        stack = self._open.get(threading.get_ident())
        if stack:
            stack.pop().__exit__(None, None, None)


def counted(module) -> bool:
    """Whether :func:`module_flops` counts ``module``'s kind."""
    return (type(module).__name__ in ("GraphConv", "ChildDownsample",
                                      "ChildUpsample")
            or isinstance(module, (torch.nn.Linear, torch.nn.Conv1d,
                                   torch.nn.Conv3d))
            or (hasattr(module, "qkv") and hasattr(module, "num_heads")))


def module_flops(module, args, output) -> float:
    """Model FLOPs of one forward call of ``module`` by formula, or 0 for a
    module whose work is not counted (norms, activations, containers)."""
    kind = type(module).__name__
    x = args[0] if args and isinstance(args[0], torch.Tensor) else None
    if x is None or not isinstance(output, torch.Tensor):
        return 0.0
    if kind == "GraphConv":
        w = module.weights
        return 2.0 * x.shape[0] * w.shape[0] * w.shape[1]
    if kind in ("ChildDownsample", "ChildUpsample"):
        c = module.weights.shape[0]
        return 2.0 * max(x.shape[0], output.shape[0]) * c * c
    if isinstance(module, torch.nn.Linear):
        return 2.0 * (x.numel() / module.in_features) * module.in_features \
            * module.out_features
    if isinstance(module, (torch.nn.Conv1d, torch.nn.Conv3d)):
        k = math.prod(module.kernel_size)
        return 2.0 * output.numel() * (module.in_channels
                                       // module.groups) * k
    if hasattr(module, "qkv") and hasattr(module, "num_heads"):
        b, c = x.shape[:2]
        length = x[0, 0].numel()
        return 4.0 * b * length * length * c
    return 0.0


class Instruments:
    """Hooks and spans of one traced run over the program's modules."""

    def __init__(self, roots: Dict[str, torch.nn.Module],
                 methods: Dict[str, tuple], backward: bool):
        self.span = _Span()
        self.convs: List[Dict] = []
        self.model_flops = 0.0
        self._handles = []
        self._methods = []
        df = roots.get("df")
        if df is not None:
            self._handles.append(df.register_forward_pre_hook(
                lambda m, a: self.span.enter(f"pb.unet.{a[0]}")))
            self._handles.append(df.register_forward_hook(
                lambda m, a, o: self.span.exit()))
        self.backward = backward
        seen = set()
        for root in roots.values():
            for mod in root.modules():
                if id(mod) in seen or mod is df:
                    continue
                seen.add(id(mod))
                if counted(mod):
                    pre, post = self._pre, self._post
                elif backward and root is df:
                    pre, post = self._pre_recomputed, self._post_recomputed
                else:
                    continue
                self._handles.append(mod.register_forward_pre_hook(pre))
                self._handles.append(mod.register_forward_hook(post))
        for name, (obj, attr) in methods.items():
            self._wrap(obj, attr, f"pb.{name}")

    def _wrap(self, obj, attr: str, span: str) -> None:
        fn = getattr(obj, attr)

        def wrapped(*a, **k):
            with torch.autograd.profiler.record_function(span):
                return fn(*a, **k)

        setattr(obj, attr, wrapped)
        self._methods.append((obj, attr))

    def _pre(self, module, args):
        if type(module).__name__ == "GraphConv":
            self.span.enter(f"pb.graph_conv#{len(self.convs)}")
            x, lvl = args[0], args[1]
            w = module.weights
            self.convs.append({
                "g": x.shape[0], "c": w.shape[0] // 7, "cout": w.shape[1],
                "lvl": lvl, "bf16": x.dtype == torch.bfloat16})
        elif self.backward and _in_backward():
            self.span.enter("pb.fwd")

    def _pre_recomputed(self, module, args):
        if _in_backward():
            self.span.enter("pb.fwd")

    def _post_recomputed(self, module, args, output):
        if _in_backward():
            self.span.exit()

    def _post(self, module, args, output):
        conv = type(module).__name__ == "GraphConv"
        recomputed = _in_backward()
        if conv or (self.backward and recomputed):
            self.span.exit()
        if recomputed:
            return
        flops = module_flops(module, args, output)
        if flops:
            if not torch.is_grad_enabled():
                mult = 1
            else:
                trains = any(p.requires_grad
                             for p in module.parameters(recurse=False))
                mult = 3 if trains else 2
            self.model_flops += mult * flops

    def close(self) -> None:
        for h in self._handles:
            h.remove()
        for obj, attr in self._methods:
            delattr(obj, attr)
        self._handles, self._methods = [], []


class Event(NamedTuple):
    """One event of the trace: a device operation (``device``) with the
    correlation id of the host operation that launched it (``linked``),
    or a host operation or span with its thread, autograd sequence number
    and forward thread."""
    name: str
    device: bool
    start: int
    end: int
    corr: int = 0
    linked: int = 0
    thread: int = 0
    seq: int = -1
    fwd_thread: int = 0
    user: bool = False


def events_of(prof) -> List[Event]:
    """The profiler's raw events as :class:`Event` (device-side copies of
    host spans left out)."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            if not _annotation(e):
                out.append(Event(e.name(), True, e.start_ns(), e.end_ns(),
                                 linked=e.linked_correlation_id()))
            continue
        out.append(Event(e.name(), False, e.start_ns(), e.end_ns(),
                         corr=e.correlation_id(),
                         thread=e.start_thread_id(), seq=e.sequence_nr(),
                         fwd_thread=e.fwd_thread_id(),
                         user=e.is_user_annotation()))
    return out


def reduce(evs: List[Event], convs: List[Dict], model_flops: float,
           laps: List[Dict], per_item: int, peak_flops: float) -> Dict:
    """The traced run's summary, which the per-layer readers
    (``metrics/<name>.py``) read: ``items`` and ``shapes`` profiled,
    ``window_s`` (first item's start to last item's end) and ``busy_s``
    (union of device operations inside it), ``device_s`` (their summed
    durations) and ``launches`` (their count), the stage ``laps`` of the
    items run before the profiled ones, the graph convs' summed roofline bound ``conv_bound_s`` and the
    device time charged to them ``conv_device_s``, ``index_bwd_s`` (device
    time under autograd's backward of indexing), ``model_flops`` and
    ``peak_flops``, and the ``breakdown``.  ``convs`` are the
    instruments' records of the graph conv calls (``g``, ``c``, ``cout``,
    ``e`` or ``lvl``, ``bf16``)."""
    cpu = {}          # correlation id -> (thread, start)
    spans = []        # (thread, start, end, (name, seq, fwd_thread))
    dev = []          # (name, start, end, linked correlation id)
    for e in evs:
        if e.device:
            dev.append((e.name, e.start, e.end, e.linked))
            continue
        cpu[e.corr] = (e.thread, e.start)
        if e.user or e.name.startswith(NODE):
            spans.append((e.thread, e.start, e.end,
                          (e.name, e.seq, e.fwd_thread)))
    index = idle.by_thread(spans)
    items = [(a, b) for th, a, b, k in spans if k[0] == "pb.item"]
    if not items or not dev:
        raise RuntimeError("the trace holds no profiled item or no device "
                           "operation")
    lo, hi = min(a for a, _ in items), max(b for _, b in items)
    main = next(th for th, a, b, k in spans if k[0] == "pb.item")
    dev = [d for d in dev if d[2] > lo and d[1] < hi]

    # forward sequence numbers of each graph conv call (original forward)
    seq_conv = {}
    for e in evs:
        if e.device or e.seq < 0:
            continue
        si = index.get(e.thread)
        k = si.key(si.innermost(e.start)) if si else None
        if k and k[0].startswith("pb.graph_conv#"):
            seq_conv[(e.thread, e.seq)] = int(k[0].split("#")[1])

    conv_dev = [0.0] * len(convs)
    conv_bwd = [False] * len(convs)
    by_name: Dict[str, float] = {}
    index_bwd = 0.0
    device_s = 0.0
    for name, a, b, link in dev:
        dur = (b - a) * 1e-9
        device_s += dur
        by_name[name] = by_name.get(name, 0.0) + dur
        origin = cpu.get(link)
        if origin is None:
            continue
        si = index.get(origin[0])
        k = si.key(si.innermost(origin[1])) if si else None
        if k is None:
            continue
        if k[0].startswith("pb.graph_conv#"):
            conv_dev[int(k[0].split("#")[1])] += dur
        elif k[0].startswith(NODE):
            j = seq_conv.get((k[2], k[1]))
            if j is not None:
                conv_dev[j] += dur
                conv_bwd[j] = True
            if INDEX_BWD.search(k[0]):
                index_bwd += dur

    bound = 0.0
    timed = 0.0
    for j, c in enumerate(convs):
        if conv_dev[j] <= 0.0:
            continue
        e = c["e"] if "e" in c else int(c["lvl"].n_edges)
        roles = ("fwd", "col", "dx", "dw") if conv_bwd[j] else ("fwd",)
        bound += sum(roofline.conv_bound_s(r, c["g"], c["c"], c["cout"], e,
                                           c["bf16"]) for r in roles)
        timed += conv_dev[j]

    busy = idle.union_length(
        idle.clip([(a, b) for _, a, b, _ in dev], lo, hi)) * 1e-9
    window = (hi - lo) * 1e-9
    gap_by_label: Dict[str, float] = {}
    main_index = index[main]
    for a, b in idle.gaps([(d[1], d[2]) for d in dev], lo, hi):
        k = main_index.key(main_index.innermost(a))
        label = k[0] if k else "host"
        if label == "pb.item":
            for th, si in index.items():
                if th == main:
                    continue
                kk = si.key(si.innermost(a))
                if kk is not None:
                    label = kk[0].replace(NODE, "backward: ")
                    break
        if label.startswith("pb.graph_conv#"):
            label = "pb.graph_conv"
        gap_by_label[label] = gap_by_label.get(label, 0.0) + (b - a) * 1e-9

    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gtop = sorted(gap_by_label.items(), key=lambda kv: -kv[1])[:10]
    return {
        "items": len(items), "shapes": len(items) * per_item,
        "window_s": window, "busy_s": busy, "device_s": device_s,
        "launches": len(dev), "laps": laps,
        "conv_bound_s": bound, "conv_device_s": timed,
        "convs": len(convs), "index_bwd_s": index_bwd,
        "model_flops": model_flops, "peak_flops": peak_flops,
        "breakdown": {"device_ops": [[n[:160], s] for n, s in top],
                      "idle_gaps": [[n[:160], s] for n, s in gtop]},
    }
