"""Union wrapper bundling the per-stage U-Nets
(port of ``octfusion_tpu/nn/unet_union.py``).

Stages are configured by parallel per-stage lists; construction stops at
``stage_flag``.  The lr stage's public layout is NDHWC, as in the JAX
package; the lr U-Net itself runs NCDHW.  The hr U-Net's middle is the lr
U-Net run body-only; the 3-stage model's feature U-Net (a graph U-Net at
``input_depth[2]``) has the whole hr U-Net, without its input and output
convs and without its own middle, as its middle.

``compute_dtype: bfloat16`` is the JAX package's mixed-precision flow:
the input is cast to bf16 and the output back; parameters stay fp32.  The
graph convs and child mixes cast their weights to the input's dtype and
stay in bf16, the dense layers (``Conv1x1``, the dense 3D convs) promote
to fp32 as flax's ``Dense`` / ``Conv`` do, and the norms take fp32
statistics and return the input's dtype (``nn/modules.py``), so the hr
U-Net runs bf16 on its finest encoder levels up to the first dense
layer, and the lr U-Net computes in fp32 on bf16-rounded inputs.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from ..config import check_compute_dtype
from ..octree.dual_graph import DualGraph
from . import unet_hr, unet_lr


@dataclasses.dataclass(frozen=True)
class UnionConfig:
    unet_type: Tuple[str, ...] = ("lr", "hr")
    df_type: Tuple[str, ...] = ("x0", "eps")
    input_depth: Tuple[int, ...] = (4, 6)
    full_depth: int = 4
    input_channels: Tuple[int, ...] = (8, 3)
    out_channels: Tuple[int, ...] = (8, 3)
    model_channels: Tuple[int, ...] = (64, 128)
    num_res_blocks: Tuple[Tuple[int, ...], ...] = ((1, 1, 1), (1, 1, 0))
    channel_mult: Tuple[Tuple[int, ...], ...] = ((1, 2, 4), (1, 2, 4))
    attention_resolutions: Tuple[int, ...] = (2, 4)
    num_heads: int = 4
    num_classes: Optional[int] = None
    compute_dtype: str = "float32"
    use_checkpoint: bool = True


class UNetUnion(nn.Module):
    def __init__(self, config: UnionConfig, stage_flag: str = "hr"):
        super().__init__()
        # bf16 casts the input; float32 leaves its dtype as it is (an fp32
        # input is the JAX cast's, and a float64 model stays float64)
        dt = check_compute_dtype(config.compute_dtype)
        self.compute_dtype = None if dt == torch.float32 else dt
        self.config = config
        self.unet_lr = None
        self.unet_hr = None
        self.unet_feature = None
        cfg = config
        for i, kind in enumerate(cfg.unet_type):
            if kind == "lr":
                self.unet_lr = unet_lr.UNetLR(
                    full_depth=cfg.full_depth,
                    in_channels=cfg.input_channels[i],
                    model_channels=cfg.model_channels[i],
                    out_channels=cfg.out_channels[i],
                    channel_mult=tuple(cfg.channel_mult[i]),
                    attention_resolutions=tuple(cfg.attention_resolutions),
                    num_heads=cfg.num_heads,
                    num_classes=cfg.num_classes,
                )
            elif kind in ("hr", "feature"):
                net = unet_hr.UNetHR(
                    input_depth=cfg.input_depth[i],
                    full_depth=cfg.full_depth,
                    in_channels=cfg.input_channels[i],
                    model_channels=cfg.model_channels[i],
                    lr_model_channels=cfg.model_channels[i - 1],
                    out_channels=cfg.out_channels[i],
                    num_res_blocks=tuple(cfg.num_res_blocks[i]),
                    channel_mult=tuple(cfg.channel_mult[i]),
                    num_classes=cfg.num_classes,
                    use_checkpoint=cfg.use_checkpoint,
                )
                setattr(self, f"unet_{kind}", net)
            else:
                raise ValueError(kind)
            if kind == stage_flag:
                break

    def forward(self, unet_type: str, x, timesteps,
                g: Optional[DualGraph] = None, x_self_cond=None, label=None,
                with_lr_middle: bool = True):
        """The stage ``unet_type``'s U-Net on ``x``, which (and
        ``x_self_cond``) it casts to the compute dtype; the output comes
        back in x's dtype, as the JAX ``UNetUnion.__call__`` returns it."""
        in_dt = x.dtype
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
            if x_self_cond is not None:
                x_self_cond = x_self_cond.to(self.compute_dtype)
        if unet_type == "lr":
            # NDHWC at the boundary, NCDHW inside
            if x_self_cond is not None:
                x_self_cond = x_self_cond.permute(0, 4, 1, 2, 3)
            out = self.unet_lr(x.permute(0, 4, 1, 2, 3), timesteps,
                               x_self_cond=x_self_cond, label=label)
            return out.permute(0, 2, 3, 4, 1).to(in_dt)
        if unet_type == "hr":
            lr_apply = (self.unet_lr.forward_as_middle
                        if with_lr_middle else None)
            return self.unet_hr(x, g, timesteps, lr_apply=lr_apply,
                                label=label).to(in_dt)
        if unet_type == "feature":
            hr_apply = ((lambda h, gg, d, t, lb: self.unet_hr(
                h, gg, t, lr_apply=None, label=lb, as_middle=True))
                if with_lr_middle else None)
            return self.unet_feature(x, g, timesteps, lr_apply=hr_apply,
                                     label=label).to(in_dt)
        raise ValueError(unet_type)
