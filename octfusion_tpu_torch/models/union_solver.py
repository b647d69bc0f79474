"""Two-stage ("union") diffusion solver
(port of ``octfusion_tpu/models/union_solver.py``).

Sampling: the lr stage denoises the dense split grid, the grown octree's
dual graph carries the hr stage, which denoises VAE latents with the frozen
lr U-Net as its middle, and the growing VAE decode plus the dense MPU
produce an SDF grid (and, on request, a mesh).

Training: in the lr stage the batch's split grid (precomputed as
``split_small``, or built from its points' octree) is the dense target of
the lr U-Net, with occupied entries weighted by
``diffusion.lr_pos_weight``; in the hr stage a point-cloud batch becomes
an octree and its dual graph on the device, the frozen VAE encoder gives
the latent codes, and the hr U-Net learns to denoise them (``loss_fn``).
``make_train_step`` adds the backward pass, AdamW with StepLR(1000, 0.9)
over the stage's trainable U-Nets (the hr stage freezes the lr U-Net) and
the EMA.  ``dp_cascade`` is one shape's cascade, the body of data-parallel
generation.  Modules own their parameters; the JAX package's jit caches
and compile warm-up have no counterpart here.
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict, Optional

import torch

from ..config import Config
from ..diffusion import ema as ema_lib
from ..diffusion import sampler, schedule
from ..nn.unet_union import UNetUnion, UnionConfig
from ..nn.vae import GraphVAE
from ..octree import split_codec
from ..octree.dual_graph import build_dual_graph, with_packed_levels
from ..utils import mesh as mesh_utils
from ..utils import sdf as sdf_utils
from ..utils.device import resolve_device, use_fp32_math
from .common import Laps, batch_to_graph, batch_to_octree, code_shape


def use_kpack() -> bool:
    """Packed forward convs (K5) on sampling graphs; off unless
    ``OCTFUSION_CONV_KPACK=1``, as in the JAX package."""
    return os.environ.get("OCTFUSION_CONV_KPACK", "0") == "1"


# the U-Nets each stage's training freezes (the JAX package's
# ``optax.set_to_zero`` subtrees, ``union_3t_solver.py:74-98``)
FROZEN = {"lr": (), "hr": ("lr",), "feature": ("lr", "hr")}


class UnionSolver:
    def __init__(self, cfg: Config, stage_flag: str = "hr", device="cuda"):
        """Runs on the card unless ``device="cpu"``; without a card the
        default raises."""
        self.cfg = cfg
        self.stage_flag = stage_flag
        self.device = resolve_device(device)
        use_fp32_math()
        d = cfg.diffusion
        m = cfg.model
        self.union_cfg = UnionConfig(
            unet_type=tuple(d.unet_type), df_type=tuple(d.df_type),
            input_depth=tuple(d.input_depth), full_depth=m.full_depth,
            input_channels=tuple(d.input_channels),
            out_channels=tuple(d.out_channels),
            model_channels=tuple(d.model_channels),
            num_res_blocks=tuple(tuple(x) for x in d.num_res_blocks),
            channel_mult=tuple(tuple(x) for x in d.channel_mult),
            attention_resolutions=tuple(d.attention_resolutions),
            num_heads=d.num_heads, num_classes=d.num_classes,
            compute_dtype=d.compute_dtype,
        )
        self.df = UNetUnion(self.union_cfg, stage_flag).to(self.device).eval()
        self.vae = GraphVAE(
            depth=m.depth, channel_in=m.channel_in, full_depth=m.full_depth,
            depth_stop=m.depth_stop, depth_out=m.depth_out,
            embed_dim=m.embed_dim, resblk_num=m.resblk_num,
            channels=tuple(m.channels), use_checkpoint=m.use_checkpoint,
        ).to(self.device).eval()
        if "hr" in d.unet_type and "feature" not in d.unet_type:
            # (the 3-stage model's hr stage denoises split_large instead)
            i = d.unet_type.index("hr")
            assert d.input_channels[i] == m.embed_dim, (
                "hr stage denoises VAE codes: diffusion.input_channels[hr] "
                f"({d.input_channels[i]}) must equal model.embed_dim "
                f"({m.embed_dim})"
            )
        self.spec1 = cfg.capacity.octree_spec(m.depth, m.full_depth, 1)
        self.edge_factor = cfg.capacity.edge_factor
        self.log_snr = schedule.get_log_snr(d.noise_schedule)
        # the depth the lr split grid is grown to: the hr stage's graph
        # (the 3-stage solver sets input_depth[1])
        self.small_depth = m.depth_stop
        self.df_type = dict(zip(d.unet_type, d.df_type))

    # ------------------------------------------------------------------
    # training (hr stage)
    # ------------------------------------------------------------------
    def code_shape(self, batch_size: int):
        """Shape of the level-``depth_stop`` latent codes of a training
        batch (the shape of the VAE's ``eps`` and of the loss's noise)."""
        return code_shape(self.cfg, batch_size)

    def batch_graph(self, batch):
        """points / normals [B, N, 3] -> the batch's dual graph of every
        level (full_depth..depth), built on the device."""
        return batch_to_graph(batch["points"], batch["normals"], self.spec1,
                              self.edge_factor)[1]

    def hr_loss(self, g, code, label=None, times=None, noise=None,
                generator=None) -> torch.Tensor:
        """Denoising MSE of the hr U-Net over the valid level-``depth_stop``
        vertices; ``times`` / ``noise`` as in ``sampler.diffusion_loss``."""
        lvl = g.level(self.small_depth)
        return sampler.diffusion_loss(
            lambda noised, snr: self.df("hr", noised, snr, g=g, label=label),
            code, lvl.node_batch, g.spec.ospec.batch_size, self.log_snr,
            self.df_type["hr"], mask=lvl.node_mask, times=times, noise=noise,
            generator=generator)

    def lr_loss(self, batch, label=None, times=None, noise=None,
                generator=None, lap=None):
        """-> (loss, {"loss"[, "overflow"]}) of one lr-stage batch: the
        x0-MSE of the lr U-Net on the split grid, ``batch["split_small"]``
        [B, S, S, S, 8] when present, else built from the points' octree
        (whose overflow flag is then reported).  With
        ``diffusion.lr_pos_weight`` != 1 the occupied (+1) entries weigh
        that much; ``times`` / ``noise`` (NDHWC) as in
        ``sampler.diffusion_loss``; ``lap`` as in :meth:`loss_fn`."""
        lap = lap or (lambda name: None)
        octree = None
        if "split_small" in batch:
            split = batch["split_small"].to(self.device, torch.float32)
        else:
            octree = batch_to_octree(batch["points"], batch["normals"],
                                     self.spec1)
            split = split_codec.octree2split_small(octree)
        lap("graph")
        pw = self.cfg.diffusion.lr_pos_weight
        elem_w = (torch.where(split > 0, pw, 1.0) if pw != 1.0 else None)
        loss = sampler.diffusion_loss(
            lambda noised, snr: self.df("lr", noised, snr, label=label),
            split, None, split.shape[0], self.log_snr, self.df_type["lr"],
            times=times, noise=noise, generator=generator,
            elem_weight=elem_w)
        out = {"loss": loss.detach()}
        if octree is not None:
            out["overflow"] = octree.overflow.any().to(torch.float32)
        return loss, out

    def loss_fn(self, batch, times=None, noise=None, eps=None,
                generator=None, lap=None):
        """-> (loss, {"loss", "overflow"}) of one batch of the solver's
        stage (the lr stage: :meth:`lr_loss`, whose ``overflow`` is absent
        with a precomputed ``split_small``).  The random draws (the hr
        encoder's ``eps``, then the loss's ``times`` and ``noise``) come
        from ``generator`` unless given; ``lap(name)``, if given, is called
        after the graph build and after the encode."""
        lap = lap or (lambda name: None)
        label = (batch.get("label")
                 if self.union_cfg.num_classes is not None else None)
        if self.stage_flag == "lr":
            return self.lr_loss(batch, label, times, noise, generator, lap)
        if self.stage_flag != "hr":
            raise NotImplementedError(
                f"stage {self.stage_flag!r} does not train in the port")
        g = self.batch_graph(batch)
        lap("graph")
        with torch.no_grad():   # the frozen VAE's codes are the target
            code = self.vae.extract_code(g, eps=eps, generator=generator)
        lap("encode")
        loss = self.hr_loss(g, code, label, times, noise, generator)
        return loss, {"loss": loss.detach(),
                      "overflow": g.any_overflow().to(torch.float32)}

    def make_optimizer(self):
        """AdamW + StepLR(1000, 0.9) over the trainable parameters.  Each
        stage freezes the U-Nets of the stages before it (:data:`FROZEN`:
        the hr stage the lr U-Net, the 3-stage feature stage the lr and hr
        U-Nets): they are left out of the optimizer (no update, no weight
        decay) and get no gradient, while gradients still flow through
        their activations.  The lr stage trains all of ``df`` (the lr
        U-Net alone)."""
        for kind in FROZEN[self.stage_flag]:
            net = getattr(self.df, f"unet_{kind}")
            if net is not None:
                net.requires_grad_(False)
        t = self.cfg.train
        opt = torch.optim.AdamW(
            [p for p in self.df.parameters() if p.requires_grad], lr=t.lr,
            betas=(0.9, 0.999), eps=1e-8, weight_decay=t.weight_decay)
        return opt, torch.optim.lr_scheduler.StepLR(opt, 1000, 0.9)

    def make_train_step(self) -> "TrainStep":
        return TrainStep(self)

    @torch.no_grad()
    def sample_lr(self, batch_size: int, label=None,
                  steps: Optional[int] = None, noise_stream=None,
                  eta: float = 1.0, generator=None) -> torch.Tensor:
        """-> [B, S, S, S, 8] split grid (NDHWC).  ``noise_stream`` is in
        the reference's NCDHW layout, [steps+1, B, 8, S, S, S], as in the
        JAX package, and is transposed here."""
        s = 2**self.cfg.model.full_depth
        dcfg = self.cfg.diffusion

        def denoise(x, tb, x_start):
            return self.df("lr", x, tb, x_self_cond=x_start, label=label)

        if noise_stream is not None:
            noise_stream = torch.as_tensor(noise_stream).permute(
                0, 1, 3, 4, 5, 2)
        return sampler.sample_loop(
            denoise, (batch_size, s, s, s, 8), batch_size,
            steps or dcfg.ddim_steps, self.log_snr,
            df_type=self.df_type["lr"],
            truncated_index=dcfg.truncated_time, snap_sign=True,
            noise_stream=noise_stream, eta=eta, solver=dcfg.sampler,
            generator=generator, device=self.device,
        )

    @torch.no_grad()
    def sample_hr(self, g, batch_size: int, label=None,
                  steps: Optional[int] = None, noise_stream=None,
                  eta: float = 1.0, generator=None) -> torch.Tensor:
        """-> [G_cap(depth_stop), embed_dim] latent codes, zero on padding."""
        lvl = g.level(self.small_depth)
        dcfg = self.cfg.diffusion

        def denoise(x, tb, x_start):
            return self.df("hr", x, tb, g=g, label=label)

        code = sampler.sample_loop(
            denoise, (lvl.g_cap, self.cfg.model.embed_dim), batch_size,
            steps or dcfg.ddim_steps, self.log_snr,
            df_type=self.df_type["hr"],
            noise_stream=noise_stream, eta=eta, solver=dcfg.sampler,
            generator=generator, device=self.device,
        )
        return torch.where(lvl.node_mask[:, None], code,
                           torch.zeros_like(code))

    def _grow_fn(self, batch_size: int, packed: bool = False):
        """split grid -> (octree, dual graph up to depth_stop); with
        ``packed`` every level of the graph is marked for K5."""
        spec = self.spec1.with_batch_size(batch_size)

        def grow(split):
            octree_small = split_codec.split2octree_small(split, spec)
            g_small = build_dual_graph(octree_small, self.edge_factor,
                                       up_to=self.small_depth)
            if packed:
                g_small = with_packed_levels(g_small)
            return octree_small, g_small

        return grow

    @torch.no_grad()
    def sample(self, batch_size: int = 1, label=None,
               steps: Optional[int] = None,
               resolution: Optional[int] = None, mesh: bool = False,
               generator=None, lr_noise=None, hr_noise=None,
               kpack: Optional[bool] = None, compute_sdf: bool = True):
        """Full generation cascade.  ``lr_noise`` / ``hr_noise`` inject the
        two stages' noise streams (see :meth:`sample_lr` /
        :meth:`sample_hr`); otherwise ``generator`` draws it.  ``kpack``
        (default :func:`use_kpack`) marks the grown depth-``depth_stop``
        graph packed, so its convs (the hr U-Net's and the decoder's at
        that depth) run K5; the decoder's grown levels keep K1.  The
        result holds the stage outputs, ``overflow`` (a device bool: a
        static cap of the grown depth-``depth_stop`` graph truncated this
        shape; the decoder's levels report through
        ``decode_out["graph_out"].any_overflow()``) and ``seconds``, the
        wall time of each stage (the device is synchronised at stage
        ends).  ``compute_sdf=False`` stops after the decode: no SDF grid
        and no mesh."""
        m = self.cfg.model
        if kpack is None:
            kpack = use_kpack()
        self.df.eval()
        lap = Laps(self.device)
        split_small = self.sample_lr(
            batch_size, label=label, steps=steps, noise_stream=lr_noise,
            generator=generator)
        lap("lr")
        octree_small, g_small = self._grow_fn(batch_size, kpack)(split_small)
        lap("grow")
        out = {"split_small": split_small, "octree_small": octree_small,
               "seconds": lap.seconds}
        if self.stage_flag == "lr":
            return out
        code = self.sample_hr(g_small, batch_size, label=label, steps=steps,
                              noise_stream=hr_noise, generator=generator)
        lap("hr")
        dec = self.vae.decode_grow(code, g_small)
        lap("decode")
        out.update(code=code, decode_out=dec, graph=g_small,
                   overflow=g_small.any_overflow())
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


    @torch.no_grad()
    def dp_cascade(self, label=None, steps: Optional[int] = None,
                   generator=None, kpack: Optional[bool] = None,
                   **noise) -> Dict:
        """One shape's whole cascade at batch 1 from one ``generator``, the
        per-rank body of data-parallel generation (``generate.py`` and
        ``parallel.train_step.make_dp_sample``): lr sampling, grow (+ the
        packed levels under ``kpack``), hr sampling (the 3-stage solver:
        grow6, hr, grow8, feature), and ``decode_grow``.  ``noise`` takes
        the stage noise streams of :meth:`sample`.  -> the growing decode's
        dict, with "overflow" (a grown graph's cap truncated the shape) and
        "seconds" (per stage); the caller evaluates the SDF grid."""
        out = self.sample(batch_size=1, label=label, steps=steps,
                          generator=generator, kpack=kpack,
                          compute_sdf=False, **noise)
        if "decode_out" not in out:
            raise ValueError(f"the {self.stage_flag} stage decodes no shape")
        return {**out["decode_out"], "overflow": out["overflow"],
                "seconds": out["seconds"]}


class TrainStep:
    """One optimisation step of the solver's stage: the loss (hr: batch ->
    graph, the frozen encoder under ``torch.no_grad``, the hr loss; lr:
    the split grid and the lr loss) and its backward, an AdamW step,
    StepLR and an EMA update of the U-Nets' parameters with
    ``diffusion.ema_rate``.  Holds the optimizer state, the EMA (``ema``:
    name -> tensor over every parameter of ``solver.df``) and ``step``,
    the updates applied so far."""

    def __init__(self, solver: UnionSolver):
        self.solver = solver
        self.optimizer, self.scheduler = solver.make_optimizer()
        self.ema_rate = solver.cfg.diffusion.ema_rate
        self.ema = {n: p.detach().clone()
                    for n, p in solver.df.named_parameters()}
        self.step = 0

    def apply_gradients(self) -> None:
        """The optimizer, schedule and EMA updates from the ``.grad`` of
        the trainable parameters."""
        self.optimizer.step()
        self.scheduler.step()
        ema_lib.ema_update(self.ema, dict(self.solver.df.named_parameters()),
                           self.ema_rate)
        self.step += 1

    def state_dict(self) -> Dict:
        """The training state beside the weights: ``step``, the AdamW and
        StepLR state dicts and the EMA tensors (by parameter name)."""
        return {"step": self.step, "optimizer": self.optimizer.state_dict(),
                "scheduler": self.scheduler.state_dict(),
                "ema": {n: e.detach() for n, e in self.ema.items()}}

    def load_state_dict(self, state: Dict) -> None:
        """Restore :meth:`state_dict`'s entries (the weights of
        ``solver.df`` are loaded apart).  Every EMA tensor must be there;
        the optimizer's moments come back on their parameters' device."""
        self.optimizer.load_state_dict(state["optimizer"])
        self.scheduler.load_state_dict(state["scheduler"])
        with torch.no_grad():
            for n, e in self.ema.items():
                e.copy_(state["ema"][n])
        self.step = int(state["step"])

    @contextlib.contextmanager
    def ema_weights(self):
        """Run the block with the EMA in ``solver.df``'s parameters (as
        the JAX package samples from ``ema_params``); the live weights
        come back after it."""
        named = dict(self.solver.df.named_parameters())
        live = {n: p.detach().clone() for n, p in named.items()}
        with torch.no_grad():
            for n, p in named.items():
                p.copy_(self.ema[n])
        try:
            yield
        finally:
            with torch.no_grad():
                for n, p in named.items():
                    p.copy_(live[n])

    def __call__(self, batch, times=None, noise=None, eps=None,
                 generator=None, timed: bool = False) -> Dict:
        """-> {"loss", "overflow"} (device scalars, as the JAX step's; the
        lr stage has no "overflow" with a precomputed split); with
        ``timed`` also "seconds" of the stages graph / encode (hr) /
        forward_backward / optimizer_ema (the device is synchronised at
        each stage end)."""
        s = self.solver
        s.df.train()
        lap = Laps(s.device) if timed else (lambda name: None)
        self.optimizer.zero_grad(set_to_none=True)
        loss, out = s.loss_fn(batch, times, noise, eps, generator, lap)
        loss.backward()
        lap("forward_backward")
        self.apply_gradients()
        lap("optimizer_ema")
        if timed:
            out["seconds"] = lap.seconds
        return out
