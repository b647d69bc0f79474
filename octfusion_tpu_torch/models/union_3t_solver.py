"""Three-stage ("union_3t") diffusion solver
(port of ``octfusion_tpu/models/union_3t_solver.py``): a middle stage
diffuses per-node 8-bit split vectors on the depth-``input_depth[1]``
graph, so the VAE latents (the feature stage) live at depth
``depth_stop`` (8 for Objaverse) and decode to depth 10.

Stage layout (``configs/octfusion_obja_uncond.yaml``'s diffusion):
  lr      — dense split grid at full_depth (16^3 x 8), grown to depth 6;
  hr      — split_large vectors on the depth-6 graph (lr U-Net as middle);
  feature — VAE codes on the depth-``depth_stop`` graph (hr U-Net as
            middle).

Training freezes the U-Nets of the earlier stages (``UnionSolver``'s
``FROZEN``).  ``UnionSolver.dp_cascade`` runs this solver's three-hop
cascade for one shape (data-parallel generation).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import Config
from ..diffusion import sampler
from ..octree import split_codec
from ..octree.dual_graph import (GraphSpec, build_dual_graph,
                                 with_packed_levels)
from ..utils import mesh as mesh_utils
from ..utils import sdf as sdf_utils
from .common import Laps, batch_to_graph
from .union_solver import UnionSolver, use_kpack


class Union3TSolver(UnionSolver):
    def __init__(self, cfg: Config, stage_flag: str = "feature",
                 device="cuda"):
        """Runs on the card unless ``device="cpu"``; without a card the
        default raises."""
        d = cfg.diffusion
        assert tuple(d.unet_type)[:3] == ("lr", "hr", "feature")
        # the feature stage's codes are the VAE's latents
        assert d.input_depth[2] == cfg.model.depth_stop, (
            f"diffusion.input_depth[2] ({d.input_depth[2]}) must equal "
            f"model.depth_stop ({cfg.model.depth_stop})")
        super().__init__(cfg, stage_flag, device)
        self.hr_depth = d.input_depth[1]          # 6
        self.code_depth = d.input_depth[2]        # == model.depth_stop
        self.small_depth = self.hr_depth

    # ------------------------------------------------------------------
    # training
    # ------------------------------------------------------------------
    def loss_fn(self, batch, times=None, noise=None, eps=None,
                generator=None, lap=None):
        """-> (loss, {"loss", "overflow"}) of one batch of the solver's
        stage.  lr: :meth:`UnionSolver.lr_loss`.  hr: the batch's
        ``split_large`` at ``input_depth[1]`` on that graph's vertex
        layout (zero targets on the coarser leaves' rows), masked to the
        valid vertices.  feature: the frozen VAE's codes of the full-depth
        graph.  ``times`` / ``noise`` / ``eps`` / ``generator`` / ``lap``
        as in :meth:`UnionSolver.loss_fn` (the hr stage draws no
        ``eps``)."""
        lap = lap or (lambda name: None)
        label = (batch.get("label")
                 if self.union_cfg.num_classes is not None else None)
        if self.stage_flag == "lr":
            return self.lr_loss(batch, label, times, noise, generator, lap)
        b = batch["points"].shape[0]
        if self.stage_flag == "hr":
            octree, g = batch_to_graph(batch["points"], batch["normals"],
                                       self.spec1, self.edge_factor,
                                       up_to=self.hr_depth)
            lap("graph")
            split = split_codec.octree2split_large(octree, self.hr_depth)
            pad = split.new_zeros(g.spec.cur_off(self.hr_depth), 8)
            x, depth = torch.cat([pad, split], dim=0), self.hr_depth
        else:
            g = self.batch_graph(batch)
            lap("graph")
            with torch.no_grad():   # the frozen VAE's codes are the target
                x = self.vae.extract_code(g, eps=eps, generator=generator)
            lap("encode")
            depth = self.code_depth
        lvl = g.level(depth)
        kind = self.stage_flag
        loss = sampler.diffusion_loss(
            lambda noised, snr: self.df(kind, noised, snr, g=g, label=label),
            x, lvl.node_batch, b, self.log_snr, self.df_type[kind],
            mask=lvl.node_mask, times=times, noise=noise,
            generator=generator)
        return loss, {"loss": loss.detach(),
                      "overflow": g.any_overflow().to(torch.float32)}

    def train_shape(self, batch_size: int):
        """Shape of the stage's diffusion target (and of the loss's
        ``noise``) for a training batch of ``batch_size``: the hr stage's
        ``split_large`` on the depth-``input_depth[1]`` layout, the
        feature stage's codes (also the VAE's ``eps``)."""
        spec = GraphSpec(self.spec1.with_batch_size(batch_size),
                         self.edge_factor)
        if self.stage_flag == "hr":
            return (spec.g_cap(self.hr_depth), 8)
        return (spec.g_cap(self.code_depth), self.cfg.model.embed_dim)

    # ------------------------------------------------------------------
    # sampling
    # ------------------------------------------------------------------
    @torch.no_grad()
    def sample_stage(self, g, depth: int, channels: int, unet_type: str,
                     batch_size: int, label=None,
                     steps: Optional[int] = None, noise_stream=None,
                     generator=None) -> torch.Tensor:
        """-> [G_cap(depth), channels]: ``unet_type``'s sample on ``g``'s
        level ``depth``, zero on padding.  ``noise_stream`` [steps+1,
        G_cap, channels] as in ``sampler.sample_loop``."""
        lvl = g.level(depth)
        dcfg = self.cfg.diffusion

        def denoise(x, tb, x_start):
            return self.df(unet_type, x, tb, g=g, label=label)

        out = sampler.sample_loop(
            denoise, (lvl.g_cap, channels), batch_size,
            steps or dcfg.ddim_steps, self.log_snr,
            df_type=self.df_type[unet_type], noise_stream=noise_stream,
            solver=dcfg.sampler, generator=generator, device=self.device)
        return torch.where(lvl.node_mask[:, None], out, torch.zeros_like(out))

    def grow_large(self, octree_small, g_small, split_large,
                   packed: bool = False):
        """(the depth-``input_depth[1]`` octree and its graph, the hr
        stage's ``split_large`` on that graph's layout) -> (the octree
        grown two levels, its dual graph up to ``depth_stop``); with
        ``packed`` every level is marked for K5."""
        cur = split_large[g_small.spec.cur_off(self.hr_depth):]
        octree = split_codec.split2octree_large(octree_small, cur,
                                                self.hr_depth)
        g = build_dual_graph(octree, self.edge_factor, up_to=self.code_depth)
        if packed:
            g = with_packed_levels(g)
        return octree, g

    @torch.no_grad()
    def sample(self, batch_size: int = 1, label=None,
               steps: Optional[int] = None,
               resolution: Optional[int] = None, mesh: bool = False,
               generator=None, split_small=None, lr_noise=None,
               hr_noise=None, feature_noise=None,
               kpack: Optional[bool] = None, compute_sdf: bool = True):
        """The three-hop cascade: lr sampling (or the given
        ``split_small`` [B, S, S, S, 8]), the grid grown to depth
        ``input_depth[1]`` (``grow6``), hr sampling of ``split_large``,
        the octree grown to ``depth_stop`` (``grow8``), feature sampling
        of the codes, the growing decode to ``depth_out``, then the SDF
        grid and, on request, meshes.  ``lr_noise`` / ``hr_noise`` /
        ``feature_noise`` inject each stage's noise stream (``lr_noise``
        NCDHW as in :meth:`UnionSolver.sample_lr`); otherwise
        ``generator`` draws it.  ``kpack`` (default ``use_kpack``) marks
        both grown graphs packed, so their convs run K5; the decoder's
        grown levels keep K1.  The result holds the stage outputs,
        ``overflow_small`` / ``overflow_large`` (device bools: a static
        cap of the depth-``input_depth[1]`` / depth-``depth_stop`` graph
        truncated this shape), ``overflow`` (either) and ``seconds``, the
        wall time of each stage.  An lr or hr solver stops after its
        stage's grow."""
        m = self.cfg.model
        if kpack is None:
            kpack = use_kpack()
        self.df.eval()
        lap = Laps(self.device)
        if split_small is None:
            split_small = self.sample_lr(
                batch_size, label=label, steps=steps, noise_stream=lr_noise,
                generator=generator)
        else:
            split_small = split_small.to(self.device, torch.float32)
        lap("lr")
        octree_small, g_small = self._grow_fn(batch_size, kpack)(split_small)
        lap("grow6")
        out = {"split_small": split_small, "octree_small": octree_small,
               "graph_small": g_small, "seconds": lap.seconds}
        if self.stage_flag == "lr":
            return out
        split_large = self.sample_stage(
            g_small, self.hr_depth, 8, "hr", batch_size, label, steps,
            hr_noise, generator)
        lap("hr")
        octree_large, g = self.grow_large(octree_small, g_small, split_large,
                                          kpack)
        lap("grow8")
        ovf_small, ovf_large = g_small.any_overflow(), g.any_overflow()
        out.update(split_large=split_large, octree_large=octree_large,
                   graph=g, overflow_small=ovf_small,
                   overflow_large=ovf_large, overflow=ovf_small | ovf_large)
        if self.stage_flag == "hr":
            return out
        code = self.sample_stage(
            g, self.code_depth, m.embed_dim, "feature", batch_size, label,
            steps, feature_noise, generator)
        lap("feature")
        dec = self.vae.decode_grow(code, g)
        lap("decode")
        out.update(code=code, decode_out=dec)
        if not compute_sdf:
            return out
        out["sdfs"] = sdf_utils.calc_sdf(
            dec["reg_voxs"][m.depth_out], dec["octree_out"],
            m.full_depth, m.depth_out,
            size=resolution or self.cfg.solver.resolution,
            bbmin=-self.cfg.solver.sdf_scale,
            bbmax=self.cfg.solver.sdf_scale,
        )
        lap("sdf")
        if mesh:
            out["meshes"] = [mesh_utils.marching_tetrahedra(s)
                             for s in out["sdfs"]]
            lap("marching")
        return out
