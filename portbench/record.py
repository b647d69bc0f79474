"""What a generation run keeps of a checked shape for the judge: every call
of the solver's U-Nets (``solver.df``: stage, input, time, self-condition,
output) and the stage outputs of the cascade, moved to the host once the
shape has returned.

The same recorder serves the program and the reference put in its place
(the control), since both solvers hold their U-Nets as ``df`` and return
the same dict from ``sample``.  Imports nothing of the program.
"""

from __future__ import annotations

from typing import Dict, List

import torch


def _host(t):
    return None if t is None else t.detach().to("cpu", copy=True)


class DenoiseRecorder:
    """A forward hook on ``df`` that clones each call's tensors (on the
    device while the shape runs; :meth:`calls` moves them to the host)."""

    def __init__(self, df: torch.nn.Module):
        self._calls: List[Dict] = []
        self._handle = df.register_forward_hook(self._hook, with_kwargs=True)

    def _hook(self, module, args, kwargs, output):
        kind, x, t = args[:3]
        cond = kwargs.get("x_self_cond")
        self._calls.append({"kind": kind, "x": x.detach().clone(),
                            "t": t.detach().clone(),
                            "cond": None if cond is None
                            else cond.detach().clone(),
                            "out": output.detach().clone()})

    def close(self) -> List[Dict]:
        """Remove the hook -> the calls, on the host."""
        self._handle.remove()
        return [{k: (_host(v) if isinstance(v, torch.Tensor) or v is None
                     else v) for k, v in c.items()} for c in self._calls]


def sample_outputs(out: Dict, depth_out: int) -> Dict:
    """The stage outputs of one ``sample`` result, on the host: the lr
    split grid, the 3-stage model's ``split_large``, the codes, the
    decoder's split logits by depth, its finest planes as per-depth node
    arrays, and the SDF grid."""
    dec = out["decode_out"]
    rec = {"split_small": _host(out["split_small"]),
           "code": _host(out["code"]),
           "logits": {d: _host(v) for d, v in dec["logits"].items()},
           "reg_voxs": {d: _host(v) for d, v in
                        dec["reg_voxs"][depth_out].items()},
           "sdfs": _host(out["sdfs"])}
    if "split_large" in out:
        rec["split_large"] = _host(out["split_large"])
    return rec
