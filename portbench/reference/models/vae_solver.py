"""Graph VAE training, as the VAE training cell runs it: a batch's point
clouds become an octree and its dual graph, the VAE autoencodes it on that
fixed topology, and the geometry loss (``nn/losses.py``) is minimised by
AdamW with a poly(0.9) decay over ``total_steps``.

Only the geometry VAE's training is here: no colour VAE, no
reconstruction, no checkpoint state.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..config import Config
from ..nn import losses
from ..nn.vae import GraphVAE
from ..utils.device import resolve_device, use_fp32_math
from .common import batch_to_graph, code_shape, flatten_pos


class VAESolver:
    def __init__(self, cfg: Config, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        use_fp32_math()
        m = cfg.model
        self.vae = GraphVAE(
            depth=m.depth, channel_in=m.channel_in, full_depth=m.full_depth,
            depth_stop=m.depth_stop, depth_out=m.depth_out,
            embed_dim=m.embed_dim, resblk_num=m.resblk_num,
            channels=tuple(m.channels), use_checkpoint=m.use_checkpoint,
        ).to(self.device)
        self.spec1 = cfg.capacity.octree_spec(m.depth, m.full_depth, 1)
        self.edge_factor = cfg.capacity.edge_factor

    def make_optimizer(self, total_steps: int):
        """AdamW over the VAE and the poly(0.9) decay: update k (from 0)
        runs at lr · (1 - min(k / total_steps, 1))^0.9."""
        t = self.cfg.train
        opt = torch.optim.AdamW(self.vae.parameters(), lr=t.lr,
                                betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=t.weight_decay)
        steps = max(total_steps, 1)
        return opt, torch.optim.lr_scheduler.LambdaLR(
            opt, lambda k: (1.0 - min(k / steps, 1.0)) ** 0.9)

    def loss_fn(self, batch, eps: Optional[torch.Tensor] = None):
        """-> (loss, dict of every loss term) of one batch: ``points`` /
        ``normals`` [B, N, 3] and the SDF samples ``pos`` [B, M, 3],
        ``sdf`` [B, M], ``grad`` [B, M, 3]; ``eps`` the posterior's
        draw."""
        m = self.cfg.model
        _, g = batch_to_graph(batch["points"], batch["normals"], self.spec1,
                              self.edge_factor)
        out = self.vae(g, g, eps=eps)
        pos, pb = flatten_pos(batch["pos"])
        ld = losses.geometry_loss(
            out, pos, pb, batch["sdf"].reshape(-1),
            batch["grad"].reshape(-1, 3), m.full_depth, m.depth_stop,
            m.depth_out, kl_weight=self.cfg.loss.kl_weight,
            loss_type=self.cfg.loss.loss_type,
            spatial_grad=self.cfg.loss.spatial_grad)
        return ld["loss"], ld

    def code_shape(self, batch_size: int):
        return code_shape(self.cfg, batch_size)

    def make_train_step(self, total_steps: int = 100_000) -> "VAETrainStep":
        return VAETrainStep(self, total_steps)


class VAETrainStep:
    """One optimisation step: the loss and its backward, an AdamW step and
    the poly decay."""

    def __init__(self, solver: VAESolver, total_steps: int):
        self.solver = solver
        self.optimizer, self.scheduler = solver.make_optimizer(total_steps)
        self.step = 0

    def __call__(self, batch, eps=None) -> Dict:
        s = self.solver
        s.vae.train()
        self.optimizer.zero_grad(set_to_none=True)
        loss, ld = s.loss_fn(batch, eps)
        loss.backward()
        self.optimizer.step()
        self.scheduler.step()
        self.step += 1
        return {k: v.detach() if isinstance(v, torch.Tensor) else v
                for k, v in ld.items()}
