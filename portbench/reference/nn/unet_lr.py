"""Dense voxel ("lr") 3D U-Net (port of ``octfusion_tpu/nn/unet_lr.py``).

Runs NCDHW on the ``[B, 8, S, S, S]`` split grid (S = 2**full_depth);
``forward_as_middle`` lets the hr graph U-Net use this network as its
middle block: hr features are voxelised at full_depth, run through the
body, and gathered back at the node coordinates.  As in the reference, the
training-time self-conditioning is inert; sampling feeds the previous x0
estimate.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..ops import graph_ops
from . import modules


class UNetLR(nn.Module):
    def __init__(
        self,
        full_depth: int = 4,
        in_channels: int = 8,
        model_channels: int = 64,
        out_channels: int = 8,
        channel_mult: Tuple[int, ...] = (1, 2, 4),
        attention_resolutions: Tuple[int, ...] = (2, 4),
        num_heads: int = 4,
        dropout: float = 0.0,
        num_classes: Optional[int] = None,
    ):
        super().__init__()
        self.full_depth = full_depth
        mc = model_channels
        channels = [mc] + [mc * m for m in channel_mult]
        in_out = list(zip(channels[:-1], channels[1:]))
        ted = mc * 4
        self.time_pos_emb = modules.LearnedSinusoidalPosEmb(mc)
        self.time_emb = nn.Sequential(
            modules._linear(mc + 1, ted), nn.SiLU(), modules._linear(ted, ted))
        self.label_emb = (nn.Embedding(num_classes, ted)
                          if num_classes is not None else None)
        self.input_emb = modules._conv3d(2 * in_channels, mc)

        num_res = len(in_out)
        ds = 1
        downs = []
        for ind, (dim_in, dim_out) in enumerate(in_out):
            is_last = ind >= num_res - 1
            downs.append(nn.ModuleList([
                modules.ResnetBlock3D(dim_in, dim_out, ted, dropout),
                modules.attention_3d(dim_out, num_heads)
                if ds in attention_resolutions else nn.Identity(),
                modules.ConvDownsample3D(dim_out) if not is_last
                else nn.Identity(),
            ]))
            if not is_last:
                ds *= 2
        self.downs = nn.ModuleList(downs)

        mid = channels[-1]
        self.mid_block1 = modules.ResnetBlock3D(mid, mid, ted, dropout)
        self.mid_self_attn = (modules.attention_3d(mid, num_heads)
                              if ds in attention_resolutions else nn.Identity())
        self.mid_block2 = modules.ResnetBlock3D(mid, mid, ted, dropout)

        ups = []
        for dim_in, dim_out in reversed(in_out[1:]):
            # every ups entry carries an upsample (the reference's is_last
            # test there can never fire)
            ups.append(nn.ModuleList([
                modules.ResnetBlock3D(dim_out * 2, dim_in, ted, dropout),
                modules.attention_3d(dim_in, num_heads)
                if ds in attention_resolutions else nn.Identity(),
                modules.ConvUpsample3D(dim_in),
            ]))
            ds //= 2
        self.ups = nn.ModuleList(ups)
        self.end = nn.Sequential(modules.voxel_group_norm(mc), nn.SiLU())
        self.out = modules._conv3d(mc, out_channels)

    def _embed_time(self, timesteps, label):
        e = self.time_emb(self.time_pos_emb(timesteps))
        if self.label_emb is not None:
            assert label is not None
            e = e + self.label_emb(label)
        return e

    def forward(self, x, timesteps, x_self_cond=None, label=None,
                as_middle: bool = False):
        """x: [B, C, S, S, S] (NCDHW); timesteps: [B]."""
        if not as_middle:
            if x_self_cond is None:
                x_self_cond = torch.zeros_like(x)
            x = self.input_emb(torch.cat([x, x_self_cond], dim=1))
        emb = self._embed_time(timesteps, label)

        hs = []
        for res, attn, down in self.downs:
            x = attn(res(x, emb))
            hs.append(x)
            x = down(x)

        x = self.mid_block2(self.mid_self_attn(self.mid_block1(x, emb)), emb)

        for res, attn, up in self.ups:
            x = res(torch.cat([x, hs.pop()], dim=1), emb)
            x = up(attn(x))

        x = self.end(x)
        return x if as_middle else self.out(x)

    def forward_as_middle(self, h, g, d, timesteps, label):
        """Graph features of the bottom level (the full_depth voxel level)
        -> voxel body -> gathered back onto the same vertex layout."""
        octree = g.octree
        h_cur = graph_ops._cur_segment(h, g, d)
        grid = octree.to_voxel(h_cur, self.full_depth)      # NDHWC
        grid = self(grid.permute(0, 4, 1, 2, 3), timesteps, label=label,
                    as_middle=True)
        out_cur = octree.from_voxel(grid.permute(0, 2, 3, 4, 1),
                                    self.full_depth)
        pad = out_cur.new_zeros((g.spec.cur_off(d), out_cur.shape[-1]))
        return torch.cat([pad, out_cur], dim=0)
