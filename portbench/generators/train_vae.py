"""Traffic generator ``train_vae``: the program's VAE train step
(``VAESolver.make_train_step``), called once per item, back to back (a
closed loop of one caller), on a pool of distinct seeded batches made in
set-up and handed over from the host as a loader hands them: the lumpy
spheres' points and normals and their SDF samples (frozen copies,
``frozen/shapes.py`` and ``frozen/sdf_samples.py``), with the encoder's
``eps`` drawn from the seed.

Set-up drives the step object through its first ``checked_steps`` steps,
keeps its state at the window's start on the host and hands the same
object to the window; the judge (``reference/judge_vae.py``) follows
those steps from the seeded weights and the window's first
``window_checked`` steps from that state, as :mod:`train_step`'s does.
A timed item's laps are the step's own (graph, forward, backward,
optimizer) and ``forward_backward``, forward plus backward.

Traffic parameters (``traffic/<mix>.json``):
  batch_size      shapes a step
  sdf_samples     SDF samples a shape
  pool            distinct batches made in set-up, the same for every
                  seed, in an order drawn from the seed
  checked_steps, window_checked  as in :mod:`train_step`
The configuration's ``data.points_per_shape`` gives the points a shape,
its ``inputs.shape_scale`` scales the shapes.
"""

from __future__ import annotations

from typing import Dict

import torch

from .. import inputs
from ..frozen.sdf_samples import lumpy_sphere_sdf_samples
from ..frozen.shapes import lumpy_spheres

KIND = "train"


def vae_batch(batch_size: int, n_points: int, n_sdf: int, scale: float,
              seed: int, index: int, pool: int) -> Dict[str, torch.Tensor]:
    """VAE training batch ``index`` of a run, on the host: the shapes of
    ``inputs.train_batch`` (the same ``pool`` for every seed, in the
    seed's order), scaled by ``scale``, with ``n_sdf`` SDF samples a
    shape of the same surfaces."""
    k = inputs.pool_order(seed, pool)[index % pool]
    shape_seed = inputs.mix(0, inputs.SALT["batch"], k) & 0x7FFFFFFF
    pts, nrm = lumpy_spheres(batch_size, n_points, shape_seed)
    sdf = lumpy_sphere_sdf_samples(batch_size, n_sdf, shape_seed,
                                   points_per_shape=n_points)
    return {"points": pts * scale, "normals": nrm, "pos": sdf["pos"] * scale,
            "sdf": sdf["sdf"] * scale, "grad": sdf["grad"]}


def vae_eps(shape, seed: int, index: int) -> torch.Tensor:
    """The posterior's draw for training batch ``index``, on the host."""
    gen = torch.Generator().manual_seed(
        inputs.mix(seed, inputs.SALT["draws"], index))
    return torch.randn(shape, generator=gen)


class Traffic:
    def __init__(self, cfg_file: Dict, traffic: Dict, seed: int, device,
                 check_range: int):
        from octfusion_tpu_torch.config import _build, Config
        from octfusion_tpu_torch.models.vae_solver import VAESolver
        from ..reference import judge_vae

        self.raw, self.seed, self.device = cfg_file["config"], seed, device
        cfg = _build(Config, self.raw)
        self.solver = VAESolver(cfg, device=device)
        inputs.load_weights(self.solver.vae, judge_vae.vae_weights(
            inputs.build_config(self.raw), seed, device))
        b = self.per_item = traffic["batch_size"]
        scale = cfg_file.get("inputs", {}).get("shape_scale", 1.0)
        pin = device.type == "cuda"
        self.pool = []
        for j in range(traffic["pool"]):
            batch = vae_batch(b, cfg.data.points_per_shape,
                              traffic["sdf_samples"], scale, seed, j,
                              traffic["pool"])
            eps = vae_eps(self.solver.code_shape(b), seed, j)
            if pin:
                batch = {k: v.pin_memory() for k, v in batch.items()}
                eps = eps.pin_memory()
            self.pool.append((batch, eps))
        self.step = self.solver.make_train_step()
        n = traffic["checked_steps"]
        self.window_checked = self.min_items = traffic["window_checked"]
        self._bad = 0
        self.losses, self.keep, self.offset = [], n, 0
        for j in range(n):
            self.item(j)
            if j == 0:
                grad1 = judge_vae.first_gradient(self.step)
        self.run = {"losses": self.losses[:n], "grad1": grad1,
                    "state3": judge_vae.trained_state(self.step),
                    "moments": judge_vae.adam_moments(self.step)}
        self.losses, self.keep, self.offset = [], self.window_checked, n
        self._bad = 0
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def item(self, index: int, timed: bool = False) -> Dict[str, float]:
        """One VAE train step on the pool's next batch (synchronised) ->
        with ``timed``, the step's stage seconds."""
        batch, eps = self.pool[(self.offset + index) % len(self.pool)]
        dev = self.device
        out = self.step({k: v.to(dev, non_blocking=True)
                         for k, v in batch.items()},
                        eps=eps.to(dev, non_blocking=True), timed=timed)
        loss = float(out["loss"])         # the step's end: synchronises
        if loss != loss or loss in (float("inf"), float("-inf")):
            self._bad += 1
        if len(self.losses) < self.keep:
            self.losses.append(loss)
        laps = dict(out.get("seconds", {}))
        if "forward" in laps and "backward" in laps:
            laps["forward_backward"] = laps["forward"] + laps["backward"]
        return laps

    def failed(self) -> int:
        """Steps whose loss is not finite."""
        return self._bad

    def modules(self) -> Dict[str, torch.nn.Module]:
        return {"vae": self.solver.vae}

    def stage_spans(self) -> Dict:
        s = self.solver
        return {"loss_fn": (s, "loss_fn"), "encode": (s.vae, "encode"),
                "decode": (s.vae, "decode")}

    def check(self) -> Dict[str, float]:
        """Free the program's state, then let the reference take the same
        checked steps, and the window's first steps from the program's
        state at the window's start, and compare."""
        from ..reference import judge_vae

        del self.step, self.solver
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        n, w = self.offset, self.window_checked
        steps = [self.pool[j % len(self.pool)] for j in range(n + w)]
        run = dict(self.run, window_losses=self.losses[:w])
        return judge_vae.judge_train(self.raw, self.seed, run,
                                     [b for b, _ in steps],
                                     [e for _, e in steps], self.device)
