"""Graph VAE training and reconstruction (port of
``octfusion_tpu/models/vae_solver.py``).

Training: a batch's point clouds become an octree and its dual graph on
the device, the VAE autoencodes it on that fixed topology, and the
geometry loss (split cross-entropy, MPU SDF and gradient regression at the
batch's SDF samples, KL) is minimised by AdamW with a poly(0.9) decay.
The colour VAE (``loss.name: color``) reads per-point colours
(``point_colors``) as 3 more input channels, predicts per-node colours
and adds their regression at the first ``COLOR_POINTS`` surface points of
each sample (``losses.geometry_color_loss``).
Reconstruction encodes, copies the input's topology up to ``depth_stop``,
grows the rest in the decoder, evaluates the dense SDF grid and, on
request, writes meshes.  The JAX package's jit caches and compact-cell
meshing have no counterpart here.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..config import Config
from ..nn import losses
from ..nn.vae import GraphVAE, copy_topology_octree
from ..octree.dual_graph import build_dual_graph
from ..utils import sdf as sdf_utils
from ..utils.device import resolve_device, use_fp32_math
from .common import Laps, batch_to_graph, code_shape, flatten_pos

# surface points per sample that supervise the colour VAE's colours
COLOR_POINTS = 4096


class VAESolver:
    def __init__(self, cfg: Config, device="cuda"):
        """Runs on the card unless ``device="cpu"``; without a card the
        default raises."""
        self.cfg = cfg
        self.use_color = cfg.loss.name == "color"
        self.device = resolve_device(device)
        use_fp32_math()
        m = cfg.model
        self.vae = GraphVAE(
            depth=m.depth, channel_in=m.channel_in, full_depth=m.full_depth,
            depth_stop=m.depth_stop, depth_out=m.depth_out,
            embed_dim=m.embed_dim, resblk_num=m.resblk_num,
            channels=tuple(m.channels), use_checkpoint=m.use_checkpoint,
            color_channel=3 if self.use_color else 0,
        ).to(self.device)
        self.spec1 = cfg.capacity.octree_spec(m.depth, m.full_depth, 1)
        self.edge_factor = cfg.capacity.edge_factor

    # ------------------------------------------------------------------
    # training
    # ------------------------------------------------------------------
    def make_optimizer(self, total_steps: int):
        """AdamW over the VAE and the poly(0.9) decay: update k (from 0)
        runs at lr · (1 - min(k / total_steps, 1))^0.9, as optax counts,
        with the scheduler stepped once after each optimizer step."""
        t = self.cfg.train
        opt = torch.optim.AdamW(self.vae.parameters(), lr=t.lr,
                                betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=t.weight_decay)
        steps = max(total_steps, 1)
        return opt, torch.optim.lr_scheduler.LambdaLR(
            opt, lambda k: (1.0 - min(k / steps, 1.0)) ** 0.9)

    def _features(self, batch):
        """The octree's per-point input features: the colours of a colour
        VAE's batch, else none."""
        if self.use_color and "point_colors" in batch:
            return batch["point_colors"]
        return None

    def loss_fn(self, batch, eps: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None, lap=None):
        """-> (loss, dict of every loss term, "loss" and "overflow") of one
        batch: ``points`` / ``normals`` [B, N, 3] and the SDF samples
        ``pos`` [B, M, 3], ``sdf`` [B, M], ``grad`` [B, M, 3] (and, for the
        colour VAE, ``point_colors`` [B, N, 3]).  The
        posterior's ``eps`` comes from ``generator`` unless given;
        ``lap(name)``, if given, is called after the graph build and after
        the loss."""
        lap = lap or (lambda name: None)
        m = self.cfg.model
        _, g = batch_to_graph(batch["points"], batch["normals"], self.spec1,
                              self.edge_factor,
                              features=self._features(batch))
        lap("graph")
        out = self.vae(g, g, eps=eps, generator=generator)
        pos, pb = flatten_pos(batch["pos"])
        sdf_gt, grad_gt = batch["sdf"].reshape(-1), batch["grad"].reshape(-1, 3)
        kw = dict(kl_weight=self.cfg.loss.kl_weight,
                  loss_type=self.cfg.loss.loss_type)
        if self.use_color:
            k = min(COLOR_POINTS, batch["points"].shape[1])
            cpos, cb = flatten_pos(batch["points"][:, :k])
            ld = losses.geometry_color_loss(
                out, pos, pb, sdf_gt, grad_gt, cpos, cb,
                batch["point_colors"][:, :k].reshape(-1, 3), m.full_depth,
                m.depth_stop, m.depth_out, **kw)
        else:
            ld = losses.geometry_loss(
                out, pos, pb, sdf_gt, grad_gt, m.full_depth, m.depth_stop,
                m.depth_out, spatial_grad=self.cfg.loss.spatial_grad, **kw)
        # a capacity overflow dropped nodes or edges: the caller must see it
        ld["overflow"] = g.any_overflow().to(torch.float32)
        lap("forward")
        return ld["loss"], ld

    def code_shape(self, batch_size: int):
        """Shape of the posterior's ``eps`` for a batch of ``batch_size``."""
        return code_shape(self.cfg, batch_size)

    def make_train_step(self, total_steps: int = 100_000) -> "VAETrainStep":
        return VAETrainStep(self, total_steps)

    # ------------------------------------------------------------------
    # reconstruction
    # ------------------------------------------------------------------
    @torch.no_grad()
    def reconstruct(self, batch, resolution: Optional[int] = None,
                    save_paths=None):
        """Encode (the posterior mean) -> the input's topology up to
        ``depth_stop`` and its dual graph -> growing decode -> the dense
        SDF grid [B, R, R, R] (R = ``resolution`` or
        ``solver.resolution``) -> one mesh per path of ``save_paths``, if
        given.  Returns (sdfs, the decoder's dict with "seconds", the wall
        seconds of graph / encode / decode / sdf / mesh); the colour VAE's
        dict holds the decoded per-node "colors", and its encoder reads the
        batch's ``point_colors``."""
        m = self.cfg.model
        s = self.cfg.solver
        self.vae.eval()
        lap = Laps(self.device)
        octree, g = batch_to_graph(batch["points"], batch["normals"],
                                   self.spec1, self.edge_factor,
                                   features=self._features(batch))
        lap("graph")
        mean, _ = self.vae.encode(g)
        lap("encode")
        g_small = build_dual_graph(copy_topology_octree(octree, m.depth_stop),
                                   self.edge_factor, up_to=m.depth_stop)
        out = self.vae.decode_grow(mean, g_small)
        lap("decode")
        sdfs = sdf_utils.calc_sdf(
            out["reg_voxs"][m.depth_out], out["octree_out"], m.full_depth,
            m.depth_out, size=resolution or s.resolution,
            bbmin=-s.sdf_scale, bbmax=s.sdf_scale)
        lap("sdf")
        if save_paths is not None:
            sdf_utils.export_meshes(
                sdfs, save_paths, bbmin=-s.sdf_scale, bbmax=s.sdf_scale,
                mesh_scale=self.cfg.data_test.point_scale)
            lap("mesh")
        out["seconds"] = lap.seconds
        return sdfs, out


class VAETrainStep:
    """One optimisation step of the VAE: the loss and its backward, an
    AdamW step and the poly decay.  Holds the optimizer, its scheduler
    and ``step``, the updates applied so far."""

    def __init__(self, solver: VAESolver, total_steps: int):
        self.solver = solver
        self.optimizer, self.scheduler = solver.make_optimizer(total_steps)
        self.step = 0

    def apply_gradients(self) -> None:
        """The optimizer and schedule updates from the ``.grad`` of the
        VAE's parameters."""
        self.optimizer.step()
        self.scheduler.step()
        self.step += 1

    def state_dict(self) -> Dict:
        """The training state beside the weights: ``step`` and the AdamW
        and poly-decay state dicts."""
        return {"step": self.step, "optimizer": self.optimizer.state_dict(),
                "scheduler": self.scheduler.state_dict()}

    def load_state_dict(self, state: Dict) -> None:
        """Restore :meth:`state_dict`'s entries (the VAE's weights are
        loaded apart).  The decay goes on from the restored step under
        this step's ``total_steps``, which may differ from the saved run's,
        as optax's schedule recomputes its rate from the restored count."""
        self.optimizer.load_state_dict(state["optimizer"])
        self.scheduler.load_state_dict(state["scheduler"])
        k = self.scheduler.last_epoch
        rates = [base * fn(k) for base, fn in zip(self.scheduler.base_lrs,
                                                  self.scheduler.lr_lambdas)]
        for group, lr in zip(self.optimizer.param_groups, rates):
            group["lr"] = lr
        self.scheduler._last_lr = rates
        self.step = int(state["step"])

    def __call__(self, batch, eps=None, generator=None,
                 timed: bool = False) -> Dict:
        """-> the loss dict, detached (device scalars); with ``timed`` also
        "seconds" of the stages graph / forward / backward / optimizer (the
        device is synchronised at each stage end)."""
        s = self.solver
        s.vae.train()
        lap = Laps(s.device) if timed else (lambda name: None)
        self.optimizer.zero_grad(set_to_none=True)
        loss, ld = s.loss_fn(batch, eps, generator, lap)
        loss.backward()
        lap("backward")
        self.apply_gradients()
        lap("optimizer")
        out = {k: v.detach() if isinstance(v, torch.Tensor) else v
               for k, v in ld.items()}
        if timed:
            out["seconds"] = lap.seconds
        return out
