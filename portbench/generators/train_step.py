"""Traffic generator ``train_step``: the program's train step of one stage,
called once per item, back to back (a closed loop of one caller that
sends the next step when the last returns), on a pool of distinct seeded
batches made in set-up and handed over from the host as a loader hands
them, each with its loss draws (``times``, ``noise``) and the encoder's
``eps``.

Set-up builds one train step object, drives it through the first
``checked_steps`` steps by the window's own call and feed (batches 0, 1,
2: they warm it up, and the judge follows them from the seeded weights),
keeps its state at the window's start on the host, and hands that same
object to the window, which goes on with the next batches of the pool.
The judge also takes the window's first ``window_checked`` steps from
that state and compares their losses.

Traffic parameters (``traffic/<mix>.json``):
  stage           the solver stage that trains (``hr`` or ``feature``)
  batch_size      shapes a step
  pool            distinct batches made in set-up, the same for every
                  seed, in an order drawn from the seed
  checked_steps   steps of set-up the judge follows (three)
  window_checked  steps of the window the judge follows (two: the second
                  shows the first one's update)
The configuration file's ``inputs.shape_scale`` scales the lumpy spheres.
"""

from __future__ import annotations

from typing import Dict

import torch

from .. import inputs

KIND = "train"


class Traffic:
    def __init__(self, cfg_file: Dict, traffic: Dict, seed: int, device,
                 check_range: int):
        from octfusion_tpu_torch.config import _build, Config
        from octfusion_tpu_torch.models.union_3t_solver import Union3TSolver
        from octfusion_tpu_torch.models.union_solver import UnionSolver
        from ..reference import judge

        cfg_raw = cfg_file["config"]
        shape_scale = cfg_file.get("inputs", {}).get("shape_scale", 1.0)
        self.raw, self.seed, self.device = cfg_raw, seed, device
        self.stage = traffic["stage"]
        cfg = _build(Config, cfg_raw)
        ref_cfg = inputs.build_config(cfg_raw)
        solver_cls = (Union3TSolver if "feature" in cfg.diffusion.unet_type
                      else UnionSolver)
        self.solver = solver_cls(cfg, stage_flag=self.stage, device=device)
        w = inputs.model_weights(ref_cfg, self.stage, seed, device)
        inputs.load_weights(self.solver.df, w["df"])
        inputs.load_weights(self.solver.vae, w["vae"])
        del w
        b = self.per_item = traffic["batch_size"]
        shape = inputs.train_target_shape(ref_cfg, self.stage, b)
        with_eps = not (self.stage == "hr" and "feature" in
                        cfg.diffusion.unet_type)
        pin = device.type == "cuda"
        self.pool = []
        for j in range(traffic["pool"]):
            batch = inputs.train_batch(b, cfg.data.points_per_shape,
                                       shape_scale, seed, j,
                                       traffic["pool"])
            draws = inputs.train_draws(b, shape, with_eps, seed, j)
            self.pool.append(
                {k: (v.pin_memory() if pin else v)
                 for k, v in {**batch, **draws}.items()})
        self.step = self.solver.make_train_step()
        n = traffic["checked_steps"]
        self.window_checked = self.min_items = traffic["window_checked"]
        self._bad = 0
        self.losses, self.keep, self.offset = [], n, 0
        for j in range(n):
            self.item(j)
            if j == 0:
                grad1 = judge.first_gradient(self.step)
        self.run = {"losses": self.losses[:n], "grad1": grad1,
                    "state3": judge.trained_state(self.step),
                    "moments": judge.adam_moments(self.step)}
        self.losses, self.keep, self.offset = [], self.window_checked, n
        self._bad = 0
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def _split(self, j: int):
        entry = self.pool[j % len(self.pool)]
        batch = {k: entry[k] for k in ("points", "normals")}
        draws = {k: v for k, v in entry.items() if k not in batch}
        return batch, draws

    def item(self, index: int, timed: bool = False) -> Dict[str, float]:
        """One train step on the pool's next batch (synchronised) -> with
        ``timed``, the step's stage seconds."""
        batch, draws = self._split(self.offset + index)
        dev = self.device
        out = self.step({k: v.to(dev, non_blocking=True)
                         for k, v in batch.items()},
                        timed=timed,
                        **{k: v.to(dev, non_blocking=True)
                           for k, v in draws.items()})
        loss = float(out["loss"])         # the step's end: synchronises
        if loss != loss or loss in (float("inf"), float("-inf")):
            self._bad += 1
        if len(self.losses) < self.keep:
            self.losses.append(loss)
        return dict(out.get("seconds", {}))

    def failed(self) -> int:
        """Steps whose loss is not finite."""
        return self._bad

    def modules(self) -> Dict[str, torch.nn.Module]:
        return {"df": self.solver.df, "vae": self.solver.vae}

    def stage_spans(self) -> Dict:
        s = self.solver
        return {"batch_graph": (s, "batch_graph"),
                "extract_code": (s.vae, "extract_code")}

    def check(self) -> Dict[str, float]:
        """Free the program's state, then let the reference take the same
        first steps, and the window's first steps from the program's state
        at the window's start, and compare."""
        from ..reference import judge

        del self.step, self.solver
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        n, w = self.offset, self.window_checked
        steps = [self._split(j) for j in range(n + w)]
        run = dict(self.run, window_losses=self.losses[:w])
        return judge.judge_train(self.raw, self.stage, self.seed, run,
                                 [c[0] for c in steps],
                                 [c[1] for c in steps], self.device)
