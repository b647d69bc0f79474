"""Graph ("hr") U-Net over the dual octree
(port of ``octfusion_tpu/nn/unet_hr.py``).

The encoder descends graph levels ``input_depth ..`` with timestep-
conditioned graph residual blocks; the middle block is the (frozen) lr
voxel U-Net run body-only on the voxelised bottom level; the decoder
mirrors upward with skip concats; the output conv is zero-initialised.
With ``use_checkpoint`` the residual blocks recompute their bodies in the
backward.
``input_blocks[0]`` is the input conv, as in the reference's key layout.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..octree.dual_graph import DualGraph
from . import modules
from .modules import swish, timestep_embedding


class UNetHR(nn.Module):
    # class rows its time embeddings added since import (B a call with a
    # label; read by utils/trace as unet.label_embeds)
    label_embeds = 0

    def __init__(
        self,
        input_depth: int = 6,
        full_depth: int = 4,
        in_channels: int = 3,
        model_channels: int = 128,
        lr_model_channels: int = 64,
        out_channels: int = 3,
        num_res_blocks: Tuple[int, ...] = (1, 1, 0),
        channel_mult: Tuple[int, ...] = (1, 2, 4),
        dropout: float = 0.0,
        num_classes: Optional[int] = None,
        use_checkpoint: bool = True,
    ):
        super().__init__()
        self.input_depth = input_depth
        self.model_channels = model_channels
        mc = model_channels
        ted = mc * 4
        self.time_embed = nn.Sequential(
            modules._linear(mc, ted), nn.SiLU(), modules._linear(ted, ted))
        self.label_emb = (nn.Embedding(num_classes, ted)
                          if num_classes is not None else None)

        d = input_depth
        blocks = [modules.GraphConv(in_channels, mc, n_node_type=d - 1)]
        kinds = [("conv", d)]
        chans = [mc]
        ch = mc
        for level, mult in enumerate(channel_mult):
            for _ in range(num_res_blocks[level]):
                blocks.append(modules.GraphResBlockEmbed(
                    ch, ted, mult * mc, dropout, d - 1, use_checkpoint))
                kinds.append(("res", d))
                ch = mult * mc
                chans.append(ch)
            if level != len(channel_mult) - 1:
                d -= 1
                # consumes the source level d+1, produces level d
                blocks.append(modules.GraphDownsampleDiff(
                    ch, ch, n_node_type=d - 1))
                kinds.append(("down", d + 1))
                chans.append(ch)
        self.input_blocks = nn.ModuleList(blocks)
        self._input_kinds = kinds
        self._bottom_depth = d

        self.middle_block1 = modules.GraphResBlockEmbed(
            ch, ted, lr_model_channels, dropout, d - 1, use_checkpoint)
        self.middle_block2 = modules.GraphResBlockEmbed(
            lr_model_channels * 2, ted, ch, dropout, d - 1, use_checkpoint)

        out_blocks, out_kinds = [], []
        for level, mult in list(enumerate(channel_mult))[::-1]:
            for i in range(num_res_blocks[level] + 1):
                ich = chans.pop()
                out_blocks.append(modules.GraphResBlockEmbed(
                    ch + ich, ted, mc * mult, dropout, d - 1, use_checkpoint))
                out_kinds.append(("res", d))
                ch = mc * mult
                if level and i == num_res_blocks[level]:
                    d += 1
                    out_blocks.append(modules.GraphUpsampleDiff(
                        ch, ch, n_node_type=d - 1))
                    out_kinds.append(("up", d))
        self.output_blocks = nn.ModuleList(out_blocks)
        self._output_kinds = out_kinds
        self.end_norm = modules.DualOctreeGroupNorm(ch)
        self.out = modules.GraphConv(ch, out_channels,
                                     n_node_type=input_depth - 1,
                                     zero_init=True)

    def _embed(self, timesteps, label):
        e = timestep_embedding(timesteps, self.model_channels)
        e = self.time_embed(e)
        if self.label_emb is not None:
            assert label is not None
            UNetHR.label_embeds += label.shape[0]
            e = e + self.label_emb(label)
        return e

    def forward(self, x, g: DualGraph, timesteps, lr_apply=None, label=None,
                as_middle: bool = False):
        """x: [G_cap(input_depth), C]; ``lr_apply(h, g, d, t, label)`` maps
        the bottom-level layout to middle features on the same layout."""
        emb = self._embed(timesteps, label)
        blocks = iter(zip(self.input_blocks, self._input_kinds))
        input_conv, (_, d0) = next(blocks)
        h = x if as_middle else input_conv(x, g.level(d0))
        hs = [h]
        for mod, (kind, d) in blocks:
            h = mod(h, emb, g.level(d)) if kind == "res" else mod(h, g, d)
            hs.append(h)

        d = self._bottom_depth
        if lr_apply is not None:
            h = self.middle_block1(h, emb, g.level(d))
            h_lr = lr_apply(h, g, d, timesteps, label)
            h = self.middle_block2(torch.cat([h, h_lr], dim=-1), emb,
                                   g.level(d))

        for mod, (kind, d) in zip(self.output_blocks, self._output_kinds):
            if kind == "res":
                h = mod(torch.cat([h, hs.pop()], dim=-1), emb, g.level(d))
            else:
                h = mod(h, g, d)

        h = swish(self.end_norm(h, g.level(self.input_depth)))
        return h if as_middle else self.out(h, g.level(self.input_depth))
