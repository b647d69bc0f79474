"""Traffic generator ``gen_cascade``: the program's generation cascade, one
``solver.sample`` call per item, back to back (a closed loop of one
caller), each with its stage noise drawn from the seed and handed in.

Traffic parameters (``traffic/<mix>.json``):
  batch_size  shapes per ``sample`` call
  sampler     ``dpmpp`` or ``ancestral`` (``diffusion.sampler``)
  steps       denoising steps a stage
  warmup      untimed calls in set-up (each with its own noise)
  check_shapes, check_range  how many shapes the judge checks, drawn from
              the seed among the first ``check_range`` of the window
"""

from __future__ import annotations

import random
from typing import Dict, List

import torch

from .. import inputs, record

KIND = "gen"


def checked_items(seed: int, count: int, upto: int) -> List[int]:
    """The window's items the judge checks: ``count`` of the first
    ``upto``, drawn from the seed."""
    rng = random.Random(inputs.mix(seed, inputs.SALT["pick"]))
    return sorted(rng.sample(range(upto), min(count, upto)))


class Traffic:
    def __init__(self, cfg_file: Dict, traffic: Dict, seed: int, device,
                 check_range: int):
        from octfusion_tpu_torch.config import _build, Config
        from octfusion_tpu_torch.models.union_3t_solver import Union3TSolver
        from octfusion_tpu_torch.models.union_solver import UnionSolver

        self.traffic, self.seed, self.device = traffic, seed, device
        self.raw = inputs.sampling_config(cfg_file["config"], traffic)
        self.ref_cfg = inputs.build_config(self.raw)
        cfg = _build(Config, self.raw)
        self.three_stage = "feature" in cfg.diffusion.unet_type
        self.stage = cfg.diffusion.unet_type[-1]
        solver_cls = Union3TSolver if self.three_stage else UnionSolver
        self.solver = solver_cls(cfg, stage_flag=self.stage, device=device)
        w = inputs.model_weights(self.ref_cfg, self.stage, seed, device)
        inputs.load_weights(self.solver.df, w["df"])
        inputs.load_weights(self.solver.vae, w["vae"])
        del w
        self.batch_size = traffic["batch_size"]
        self.per_item = self.batch_size
        self.steps = traffic["steps"]
        self.shapes = inputs.noise_shapes(self.ref_cfg, self.batch_size,
                                   traffic["sampler"], self.steps)
        self.depth_out = cfg.model.depth_out
        self.checks = checked_items(seed, traffic["check_shapes"],
                                    check_range)
        self.min_items = max(self.checks, default=-1) + 1
        self.records: List[Dict] = []
        self._bad = torch.zeros((), dtype=torch.int64, device=device)
        for k in range(traffic["warmup"]):
            self._sample(-1 - k)
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def noise(self, index: int) -> Dict[str, torch.Tensor]:
        return {key: inputs.stage_noise(shape, self.seed, index, j,
                                        self.device)
                for j, (key, shape) in enumerate(self.shapes)}

    def _sample(self, index: int) -> Dict:
        return self.solver.sample(batch_size=self.batch_size,
                                  steps=self.steps, mesh=False,
                                  compute_sdf=True, **self.noise(index))

    def item(self, index: int, timed: bool = False) -> Dict[str, float]:
        """Generate one batch of shapes -> the solver's stage seconds (the
        solver always times its stages).  A checked item also keeps its
        U-Net calls and stage outputs."""
        rec = (record.DenoiseRecorder(self.solver.df)
               if index in self.checks else None)
        out = self._sample(index)
        self._bad += (~torch.isfinite(out["sdfs"])).any()
        if rec is not None:
            self.records.append({"index": index, "calls": rec.close(),
                                 **record.sample_outputs(out,
                                                         self.depth_out)})
        return dict(out["seconds"])

    def failed(self) -> int:
        """Items whose SDF grid holds a value that is not finite."""
        return int(self._bad)

    def modules(self) -> Dict[str, torch.nn.Module]:
        return {"df": self.solver.df, "vae": self.solver.vae}

    def stage_spans(self) -> Dict:
        """The solver's methods the traced run wraps in spans, by name."""
        s = self.solver
        names = (["sample_lr", "sample_stage", "grow_large"]
                 if self.three_stage else ["sample_lr", "sample_hr"])
        return {**{n: (s, n) for n in names},
                "decode_grow": (s.vae, "decode_grow")}

    def check(self) -> Dict[str, float]:
        """Free the program's state, then judge the checked shapes."""
        from ..reference import judge

        del self.solver
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return judge.judge_gen(self.raw, self.traffic, self.seed,
                               self.records, self.device)

