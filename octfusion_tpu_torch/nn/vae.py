"""Graph VAE on the dual octree (port of ``octfusion_tpu/nn/vae.py``).

``encode`` / ``extract_code`` are the encoder: the ND input feature on
the level-``depth`` graph, a GraphConv stem, residual blocks and
leaf-preserving downsamples to ``depth_stop``, and a 1x1 head giving a
diagonal Gaussian over ``embed_dim`` channels per level-``depth_stop``
vertex.  The decoder predicts per-level split logits and MPU plane
parameters: ``decode`` on a fixed topology (training, the input's own
graph), ``decode_grow`` splitting and growing the octree level by level
and extending the dual graph as it goes (inference).  ``forward``
autoencodes with the KL term.  With ``color_channel`` > 0 (the colour
VAE) each decoder level also predicts per-node colours through the heads
``color.{i}``, beside ``predict.{i}`` / ``regress.{i}``, and the decoders
return them as "colors".  Module names follow the reference's keys, so a
whole reference state dict loads with ``strict=True``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..octree.dual_graph import DualGraph, build_dual_graph, extend_dual_graph
from ..octree.octree import Octree, create_full_octree
from ..ops import graph_ops
from . import distributions, modules

DEFAULT_CHANNELS = (4, 512, 512, 256, 128, 64, 32, 32, 24, 8)


def copy_topology_octree(octree_in: Octree, to_depth: int) -> Octree:
    """A fresh octree whose topology up to ``to_depth`` copies
    ``octree_in``'s (the reference's ``create_child_octree``)."""
    out = create_full_octree(octree_in.spec, octree_in.device)
    for d in range(octree_in.spec.full_depth, to_depth):
        label = octree_in.nempty_mask(d).to(torch.int64)
        out = out.octree_split(label, d).octree_grow(d + 1)
    return out


class PredictHead(nn.ModuleList):
    """Conv1x1GnGelu + Conv1x1 (the reference's two-entry Sequential)."""

    def __init__(self, channel_in: int, channel_out: int,
                 num_hidden: int = 32):
        super().__init__([
            modules.Conv1x1GnGelu(channel_in, num_hidden),
            modules.Conv1x1(num_hidden, channel_out, use_bias=True),
        ])

    def forward(self, x, lvl):
        return self[1](self[0](x, lvl))


class _DecoderMid(nn.Module):
    def __init__(self, channels: int, resblk_num: int, n_node_type: int,
                 use_checkpoint: bool):
        super().__init__()
        self.block_1 = modules.GraphResBlocks(
            channels, channels, resblk_num, n_node_type=n_node_type,
            use_checkpoint=use_checkpoint)
        self.block_2 = modules.GraphResBlocks(
            channels, channels, resblk_num, n_node_type=n_node_type,
            use_checkpoint=use_checkpoint)


class GraphVAE(nn.Module):
    def __init__(
        self,
        depth: int = 8,
        channel_in: int = 4,
        full_depth: int = 4,
        depth_stop: int = 6,
        depth_out: int = 8,
        embed_dim: int = 3,
        resblk_num: int = 2,
        channels: Tuple[int, ...] = DEFAULT_CHANNELS,
        use_checkpoint: bool = True,
        color_channel: int = 0,
    ):
        super().__init__()
        del full_depth  # the dual graph carries it
        self.depth = depth
        self.embed_dim = embed_dim
        ds = self.depth_stop = depth_stop
        self.depth_out = depth_out
        ch = channels
        ckpt = dict(use_checkpoint=use_checkpoint)
        # encoder
        self.conv1 = modules.GraphConv(channel_in, ch[depth],
                                       n_node_type=depth - 1)
        self.encoder = nn.ModuleList(
            modules.GraphResBlocks(ch[d], ch[d], resblk_num - 1,
                                   n_node_type=d - 1, **ckpt)
            for d in range(depth, ds - 1, -1))
        self.downsample = nn.ModuleList(
            modules.GraphDownsampleVAE(ch[d], ch[d - 1])
            for d in range(depth, ds, -1))
        self.encoder_norm_out = modules.DualOctreeGroupNorm(ch[ds])
        self.KL_conv = modules.Conv1x1(ch[ds], 2 * embed_dim, use_bias=True)
        # decoder
        self.post_KL_conv = modules.Conv1x1(embed_dim, ch[ds], use_bias=True)
        self.decoder_mid = _DecoderMid(ch[ds], resblk_num, ds - 1,
                                       use_checkpoint)
        levels = range(ds, depth_out + 1)
        self.decoder = nn.ModuleList(
            modules.GraphResBlocks(ch[d], ch[d], resblk_num, n_node_type=d - 1,
                                   **ckpt)
            for d in levels)
        self.upsample = nn.ModuleList(
            modules.GraphUpsampleVAE(ch[d - 1], ch[d])
            for d in range(ds + 1, depth_out + 1))
        self.predict = nn.ModuleList(PredictHead(ch[d], 2) for d in levels)
        self.regress = nn.ModuleList(PredictHead(ch[d], 4) for d in levels)
        self.color_channel = color_channel
        if color_channel > 0:
            self.color = nn.ModuleList(PredictHead(ch[d], color_channel)
                                       for d in levels)

    def encode(self, g: DualGraph):
        """-> (mean, logvar) [G_cap(depth_stop), embed_dim] on the
        level-``depth_stop`` vertex layout, zero on padding.  ``g`` must
        hold every level up to ``depth``."""
        ds = self.depth_stop
        x = graph_ops.level_input_feature(g)
        for i, d in enumerate(range(self.depth, ds - 1, -1)):
            if d == self.depth:
                x = self.conv1(x, g.level(d))
            x = self.encoder[i](x, g.level(d))
            if d > ds:
                x = self.downsample[i](x, g, d)
        x = F.gelu(self.encoder_norm_out(x, g.level(ds)))
        code = self.KL_conv(x)
        mask = g.level(ds).node_mask[:, None]
        code = torch.where(mask, code, torch.zeros_like(code))
        return distributions.split_params(code)

    def extract_code(self, g: DualGraph, eps: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None):
        """Sampled latent codes on the level-``depth_stop`` layout, the hr
        stage's diffusion target; ``eps`` or ``generator`` as in
        :func:`distributions.sample`."""
        mean, logvar = self.encode(g)
        return distributions.sample(mean, logvar, eps, generator)

    def _decode_start(self, code: torch.Tensor, g: DualGraph):
        x = self.post_KL_conv(code)
        x = self.decoder_mid.block_1(x, g.level(self.depth_stop))
        return self.decoder_mid.block_2(x, g.level(self.depth_stop))

    def _decode_level(self, i: int, d: int, x, g: DualGraph):
        """Level ``d``'s res blocks and split logits on its current-level
        vertices."""
        x = self.decoder[i](x, g.level(d))
        logit = self.predict[i](x, g.level(d))
        return x, graph_ops._cur_segment(logit, g, d)

    def _level_heads(self, i: int, d: int, x, g: DualGraph, reg_voxs,
                     colors) -> None:
        """Level ``d``'s planes (and colours) as per-depth node arrays."""
        reg_voxs[d] = graph_ops.graph_to_level_arrays(
            self.regress[i](x, g.level(d)), g, d)
        if self.color_channel > 0:
            colors[d] = graph_ops.graph_to_level_arrays(
                self.color[i](x, g.level(d)), g, d)

    def _decoded(self, logits, reg_voxs, colors, octree, g) -> Dict:
        out = {"logits": logits, "reg_voxs": reg_voxs, "octree_out": octree,
               "graph_out": g}
        if self.color_channel > 0:
            out["colors"] = colors
        return out

    def decode(self, code: torch.Tensor, g: DualGraph) -> Dict:
        """Fixed-topology decode (training): ``g`` holds every level up to
        ``depth_out`` of the octree the planes are predicted on."""
        ds = self.depth_stop
        x = self._decode_start(code, g)
        logits, reg_voxs, colors = {}, {}, {}
        for i, d in enumerate(range(ds, self.depth_out + 1)):
            if d > ds:
                x = self.upsample[i - 1](x, g, d)
            x, logits[d] = self._decode_level(i, d, x, g)
            self._level_heads(i, d, x, g, reg_voxs, colors)
        return self._decoded(logits, reg_voxs, colors, g.octree, g)

    def decode_grow(self, code: torch.Tensor, g: DualGraph) -> Dict:
        """Growing decode (inference): split each level from its predicted
        logits, grow, extend the dual graph, continue.  ``g`` covers levels
        up to ``depth_stop`` of an octree matching the code's layout."""
        ds = self.depth_stop
        octree = g.octree
        x = self._decode_start(code, g)
        logits, reg_voxs, colors = {}, {}, {}
        for i, d in enumerate(range(ds, self.depth_out + 1)):
            if d > ds:
                x = self.upsample[i - 1](x, g, d)
            x, logits[d] = self._decode_level(i, d, x, g)
            if d < self.depth_out:
                label = torch.argmax(logits[d], dim=-1)
                octree = octree.octree_split(label, d).octree_grow(d + 1)
                g = extend_dual_graph(g.replace(octree=octree), octree)
            self._level_heads(i, d, x, g, reg_voxs, colors)
        return self._decoded(logits, reg_voxs, colors, octree, g)

    def forward(self, g_in: DualGraph, g_out: Optional[DualGraph] = None,
                eps: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> Dict:
        """Autoencode: encode ``g_in``, sample the codes (``eps`` or
        ``generator`` as in :func:`distributions.sample`), and decode on
        ``g_out``'s fixed topology, or, without ``g_out``, grow from the
        input's topology up to ``depth_stop``.  Adds "kl_loss" (the mean
        over the valid level-``depth_stop`` vertices and ``embed_dim``),
        "code", "code_max" and "code_min" to the decoder's dict."""
        ds = self.depth_stop
        mean, logvar = self.encode(g_in)
        z = distributions.sample(mean, logvar, eps, generator)
        if g_out is None:
            octree_out = copy_topology_octree(g_in.octree, ds)
            out = self.decode_grow(z, build_dual_graph(
                octree_out, g_in.spec.edge_factor, up_to=ds))
        else:
            out = self.decode(z, g_out)
        mask = g_in.level(ds).node_mask[:, None]
        kl_elem = distributions.kl(mean, logvar)
        out["kl_loss"] = torch.where(mask, kl_elem, torch.zeros_like(
            kl_elem)).sum() / (mask.sum() * self.embed_dim).clamp(min=1)
        out["code"] = z
        out["code_max"] = torch.where(mask, z, -torch.inf).max()
        out["code_min"] = torch.where(mask, z, torch.inf).min()
        return out
