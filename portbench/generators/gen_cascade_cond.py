"""Traffic generator ``gen_cascade_cond``: :mod:`gen_cascade` for a
class-conditional model, each ``solver.sample`` call given the mix's
``labels``, one a shape (so ``batch_size`` is their number), the same in
every call.

The judge (``reference/judge_cond.py``) gives the reference's U-Nets these
labels itself.  A traced run's unprofiled items also turn the program's
own tracing on (``utils/trace.py``; off in the timed window and under the
profiler) and return in their laps the host seconds and count of the
spans ``octf.unet.lr_middle`` (``lr_middle_host_s``, ``lr_middle_calls``)
and the counter ``unet.label_embeds`` (``label_embeds``) that the item
added, each where the program has it.

Traffic parameters (``traffic/<mix>.json``): those of :mod:`gen_cascade`
and ``labels``, the class of each shape of a call.
"""

from __future__ import annotations

from typing import Dict

import torch

from . import gen_cascade

KIND = gen_cascade.KIND


class Traffic(gen_cascade.Traffic):
    def __init__(self, cfg_file: Dict, traffic: Dict, seed: int, device,
                 check_range: int):
        from ..reference.judge_cond import labels_of

        if len(traffic["labels"]) != traffic["batch_size"]:
            raise ValueError("a conditional mix gives one label a shape")
        self.labels = labels_of(traffic, device)
        super().__init__(cfg_file, traffic, seed, device, check_range)

    def _sample(self, index: int) -> Dict:
        return self.solver.sample(batch_size=self.batch_size,
                                  label=self.labels, steps=self.steps,
                                  mesh=False, compute_sdf=True,
                                  **self.noise(index))

    def item(self, index: int, timed: bool = False) -> Dict[str, float]:
        """:meth:`gen_cascade.Traffic.item`; timed and unprofiled, with
        the program's spans and counters read around it."""
        if not timed or torch._C._autograd._profiler_enabled():
            return super().item(index, timed)
        from octfusion_tpu_torch.utils import trace

        def read(snap):
            mid = snap["spans"].get("octf.unet.lr_middle", {})
            return {"lr_middle_host_s": mid.get("host_s"),
                    "lr_middle_calls": mid.get("count"),
                    "label_embeds": snap["counters"].get("unet.label_embeds")}

        # left on where a caller traces the whole run (program_spans.py)
        was_on = getattr(trace, "_on", False)
        before = read(trace.snapshot())
        trace.enable()
        try:
            laps = super().item(index, timed)
        finally:
            if not was_on:
                trace.disable()
        for key, value in read(trace.snapshot()).items():
            if value is not None:
                laps[key] = value - (before[key] or 0)
        return laps

    def check(self) -> Dict[str, float]:
        """Free the program's state, then judge the checked shapes with
        the mix's labels."""
        from ..reference import judge_cond

        del self.solver
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return judge_cond.judge_gen(self.raw, self.traffic, self.seed,
                                    self.records, self.device)
