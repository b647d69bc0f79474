"""Graph and dense 3D modules (port of ``octfusion_tpu/nn/modules.py``).

Module and parameter names follow the reference PyTorch state-dict keys
(the layout ``tests/torch_ref_{vae,unet}.py`` use), so a reference state
dict loads with ``strict=True``: graph-norm ``weights``/``bias`` are
``[1, C]``, the child-mix tensors ``[C, C, 8]`` keep the reference's
``flatten(1)`` order, attention projections are ``Conv1d``.  Dense 3D
modules run NCDHW.  Initialisers follow the JAX package (LeCun-normal
dense and conv kernels, zero biases, zero-init where it zero-inits).
Graph residual blocks with ``use_checkpoint`` recompute their body in the
backward (``torch.utils.checkpoint``, the reference's ckpt_conv_wrapper
and the JAX package's ``remat``) whenever autograd records.

Dtypes follow the JAX modules', which the bf16 compute mode
(``compute_dtype: bfloat16``) exposes; parameters stay fp32 throughout:
the graph convs and child mixes cast their weights to the input's dtype
and compute in it; the dense layers (:class:`Linear`, :class:`Conv3d`)
compute in the promoted dtype of input and parameters, as flax's
``Dense`` / ``Conv`` with ``dtype=None`` do (PyTorch's would raise on a
bf16 input and fp32 weights), so a bf16 input is raised to fp32; the
norms take fp32 statistics and return the input's dtype; the attention
softmax is fp32; time embeddings are added in the features' dtype.  In
fp32 every cast is a no-op.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..octree.dual_graph import N_EDGE_TYPE, DualGraph, GraphLevel
from ..ops import graph_ops


def swish(x):
    return x * torch.sigmoid(x)


def lecun_normal_(w: torch.Tensor, fan_in: int) -> torch.Tensor:
    """flax's ``lecun_normal``: truncated normal (at 2 std) with variance
    1/fan_in after truncation."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std)


def _promoted(x, *params):
    """``x`` and ``params`` (None kept) in their promoted dtype, as flax's
    ``promote_dtype`` gives a layer whose ``dtype`` is None."""
    dt = x.dtype
    for p in params:
        if p is not None:
            dt = torch.promote_types(dt, p.dtype)
    return [None if t is None else t.to(dt) for t in (x, *params)]


class Linear(nn.Linear):
    """``nn.Linear`` computing in the promoted dtype of input and
    parameters (flax ``Dense``)."""

    def forward(self, x):
        return F.linear(*_promoted(x, self.weight, self.bias))


class Conv3d(nn.Conv3d):
    """``nn.Conv3d`` in the promoted dtype (flax ``Conv``)."""

    def forward(self, x):
        return self._conv_forward(*_promoted(x, self.weight, self.bias))


def _linear(cin: int, cout: int, bias: bool = True) -> Linear:
    lin = Linear(cin, cout, bias=bias)
    lecun_normal_(lin.weight, cin)
    if bias:
        nn.init.zeros_(lin.bias)
    return lin


def _conv3d(cin: int, cout: int, kernel: int = 3, stride: int = 1,
            zero_init: bool = False) -> Conv3d:
    """torch-style symmetric padding ``kernel // 2``, as the JAX ConvNd."""
    conv = Conv3d(cin, cout, kernel, stride=stride, padding=kernel // 2)
    if zero_init:
        nn.init.zeros_(conv.weight)
    else:
        lecun_normal_(conv.weight, cin * kernel**3)
    nn.init.zeros_(conv.bias)
    return conv


def _maybe_checkpoint(use: bool, fn, *args):
    """``fn(*args)``, rematerialised in the backward when ``use`` and
    autograd is recording."""
    if use and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def group_count(channels: int, group: int = 32) -> int:
    """Group-size rules of the reference."""
    group = min(group, channels)
    if channels <= 32:
        group = channels // 4
    elif channels % group != 0:
        group = 30
    assert channels % group == 0
    return group


# ----------------------------------------------------------------------
# graph modules
# ----------------------------------------------------------------------
class GraphConv(nn.Module):
    """7-edge-type graph convolution."""

    # forward calls since the last reset, and those on a bf16 input (cf.
    # graph_conv_cuda.launches)
    calls = 0
    calls_bf16 = 0

    def __init__(self, in_channels: int, out_channels: int,
                 avg_degree: int = 7, n_node_type: int = 0,
                 zero_init: bool = False):
        super().__init__()
        self.n_node_type = n_node_type
        node_ch = n_node_type if n_node_type > 1 else 0
        w = torch.empty(N_EDGE_TYPE * (in_channels + node_ch), out_channels)
        if zero_init:
            nn.init.zeros_(w)
        else:
            std = math.sqrt(2.0 / (avg_degree * (in_channels + out_channels)))
            nn.init.uniform_(w, -math.sqrt(3.0) * std, math.sqrt(3.0) * std)
        self.weights = nn.Parameter(w)

    def forward(self, x, lvl: GraphLevel):
        GraphConv.calls += 1
        GraphConv.calls_bf16 += x.dtype == torch.bfloat16
        return graph_ops.graph_conv(x, self.weights.to(x.dtype), lvl,
                                    self.n_node_type)


class DualOctreeGroupNorm(nn.Module):
    """Per-sample group norm over variable-length vertex sets."""

    def __init__(self, in_channels: int, group: int = 32):
        super().__init__()
        self.group = group_count(in_channels, group)
        self.weights = nn.Parameter(torch.ones(1, in_channels))
        self.bias = nn.Parameter(torch.zeros(1, in_channels))

    def forward(self, x, lvl: GraphLevel):
        return graph_ops.dual_group_norm(x, lvl, self.weights, self.bias,
                                         self.group)


class Conv1x1(nn.Module):
    """Per-vertex linear layer."""

    def __init__(self, in_channels: int, out_channels: int,
                 use_bias: bool = False):
        super().__init__()
        self.linear = _linear(in_channels, out_channels, use_bias)

    def forward(self, x):
        return self.linear(x)


class Conv1x1Gn(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = Conv1x1(in_channels, out_channels)
        self.gn = DualOctreeGroupNorm(out_channels)

    def forward(self, x, lvl):
        return self.gn(self.conv(x), lvl)


class Conv1x1GnGelu(Conv1x1Gn):
    def forward(self, x, lvl):
        # exact GELU, as the reference (the tanh form would drift)
        return F.gelu(super().forward(x, lvl))


class _ChildMix(nn.Module):
    """Learned mix between 8 children and their parent; ``weights`` keeps
    the reference's [C, C, 8] layout and its ``flatten(1)`` use."""

    def __init__(self, channels: int):
        super().__init__()
        self.channels = channels
        bound = math.sqrt(6.0 / (2 * 8 * channels))
        self.weights = nn.Parameter(
            torch.empty(channels, channels, 8).uniform_(-bound, bound))


class ChildDownsample(_ChildMix):
    def forward(self, x8):  # [N8, C] sibling-major -> [N8/8, C]
        w = self.weights.flatten(1).t().to(x8.dtype)
        return x8.reshape(-1, 8 * self.channels) @ w


class ChildUpsample(_ChildMix):
    def forward(self, x):  # [N, C] -> [8N, C]
        w = self.weights.flatten(1).to(x.dtype)
        return (x @ w).reshape(-1, self.channels)


class GraphDownsampleVAE(nn.Module):
    """Level d -> d-1 (VAE flavour): mix + optional Conv1x1GnGelu."""

    def __init__(self, channels_in: int, channels_out: int):
        super().__init__()
        self.downsample = ChildDownsample(channels_in)
        self.conv1x1 = (Conv1x1GnGelu(channels_in, channels_out)
                        if channels_in != channels_out else None)

    def forward(self, x, g: DualGraph, d: int):
        parents = self.downsample(graph_ops._cur_segment(x, g, d))
        out = graph_ops.downsample_splice(x, parents, g, d)
        if self.conv1x1 is not None:
            out = self.conv1x1(out, g.level(d - 1))
        return out


class GraphUpsampleVAE(nn.Module):
    """Level d-1 -> d (VAE flavour): mix + optional Conv1x1GnGelu."""

    def __init__(self, channels_in: int, channels_out: int):
        super().__init__()
        self.upsample = ChildUpsample(channels_in)
        self.conv1x1 = (Conv1x1GnGelu(channels_in, channels_out)
                        if channels_in != channels_out else None)

    def forward(self, x, g: DualGraph, d: int):
        out = graph_ops.upsample_splice(x, g, d, self.upsample)
        if self.conv1x1 is not None:
            out = self.conv1x1(out, g.level(d))
        return out


class GraphDownsampleDiff(nn.Module):
    """Diffusion flavour: mix + GraphConv at the coarser level."""

    def __init__(self, channels_in: int, channels_out: int,
                 n_node_type: int = 0):
        super().__init__()
        self.downsample = ChildDownsample(channels_in)
        self.conv = GraphConv(channels_in, channels_out,
                              n_node_type=n_node_type)

    def forward(self, x, g: DualGraph, d: int):
        parents = self.downsample(graph_ops._cur_segment(x, g, d))
        out = graph_ops.downsample_splice(x, parents, g, d)
        return self.conv(out, g.level(d - 1))


class GraphUpsampleDiff(nn.Module):
    """Diffusion flavour: mix + GraphConv at the finer level."""

    def __init__(self, channels_in: int, channels_out: int,
                 n_node_type: int = 0):
        super().__init__()
        self.upsample = ChildUpsample(channels_in)
        self.conv = GraphConv(channels_in, channels_out,
                              n_node_type=n_node_type)

    def forward(self, x, g: DualGraph, d: int):
        out = graph_ops.upsample_splice(x, g, d, self.upsample)
        return self.conv(out, g.level(d))


class GraphResBlock(nn.Module):
    """GN -> swish -> conv -> GN -> swish -> dropout -> conv (+1x1Gn skip)."""

    def __init__(self, channel_in: int, channel_out: int,
                 dropout: float = 0.0, n_node_type: int = 0,
                 use_checkpoint: bool = True):
        super().__init__()
        self.dropout = dropout
        self.use_checkpoint = use_checkpoint
        self.norm1 = DualOctreeGroupNorm(channel_in)
        self.conv1 = GraphConv(channel_in, channel_out, n_node_type=n_node_type)
        self.norm2 = DualOctreeGroupNorm(channel_out)
        self.conv2 = GraphConv(channel_out, channel_out,
                               n_node_type=n_node_type)
        self.conv1x1c = (Conv1x1Gn(channel_in, channel_out)
                         if channel_in != channel_out else None)

    def forward(self, x, lvl: GraphLevel):
        return _maybe_checkpoint(self.use_checkpoint, self._body, x, lvl)

    def _body(self, x, lvl: GraphLevel):
        h = self.conv1(swish(self.norm1(x, lvl)), lvl)
        h = swish(self.norm2(h, lvl))
        h = F.dropout(h, self.dropout, self.training)
        h = self.conv2(h, lvl)
        if self.conv1x1c is not None:
            x = self.conv1x1c(x, lvl)
        return h + x


class GraphResBlocks(nn.Module):
    def __init__(self, channel_in: int, channel_out: int, resblk_num: int,
                 dropout: float = 0.0, n_node_type: int = 0,
                 use_checkpoint: bool = True):
        super().__init__()
        channels = [channel_in] + [channel_out] * resblk_num
        self.resblks = nn.ModuleList(
            GraphResBlock(channels[i], channels[i + 1], dropout, n_node_type,
                          use_checkpoint)
            for i in range(resblk_num)
        )

    def forward(self, x, lvl: GraphLevel):
        for blk in self.resblks:
            x = blk(x, lvl)
        return x


class GraphResBlockEmbed(nn.Module):
    """Timestep-conditioned graph residual block; the per-sample embedding
    is a batched gather-add."""

    def __init__(self, channels: int, emb_channels: int, out_channels: int,
                 dropout: float = 0.0, n_node_type: int = 0,
                 use_checkpoint: bool = True):
        super().__init__()
        self.dropout = dropout
        self.use_checkpoint = use_checkpoint
        self.block1_norm = DualOctreeGroupNorm(channels)
        self.conv1 = GraphConv(channels, out_channels, n_node_type=n_node_type)
        self.emb_layers = nn.Sequential(
            nn.SiLU(), _linear(emb_channels, out_channels))
        self.block2_norm = DualOctreeGroupNorm(out_channels)
        self.conv2 = GraphConv(out_channels, out_channels,
                               n_node_type=n_node_type, zero_init=True)
        self.skip_connection = (Conv1x1(channels, out_channels)
                                if channels != out_channels else None)

    def forward(self, x, emb, lvl: GraphLevel):
        return _maybe_checkpoint(self.use_checkpoint, self._body, x, emb, lvl)

    def _body(self, x, emb, lvl: GraphLevel):
        h = self.conv1(swish(self.block1_norm(x, lvl)), lvl)
        h = graph_ops.add_batch_embedding(h, self.emb_layers(emb), lvl)
        h = swish(self.block2_norm(h, lvl))
        h = F.dropout(h, self.dropout, self.training)
        h = self.conv2(h, lvl)
        skip = x if self.skip_connection is None else self.skip_connection(x)
        return skip + h


# ----------------------------------------------------------------------
# time embeddings
# ----------------------------------------------------------------------
class LearnedSinusoidalPosEmb(nn.Module):
    """[t, sin(2π w t), cos(2π w t)] with learned frequencies."""

    def __init__(self, dim: int):
        super().__init__()
        self.weights = nn.Parameter(torch.randn(dim // 2))

    def forward(self, t):  # [B]
        f = t[:, None] * self.weights[None, :] * (2 * math.pi)
        return torch.cat([t[:, None], torch.sin(f), torch.cos(f)], dim=-1)


def timestep_embedding(t, dim, max_period=10000.0):
    """Fixed sinusoidal embedding."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=t.device) / half
    )
    args = t[:, None].to(torch.float32) * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


# ----------------------------------------------------------------------
# dense 3D modules (lr U-Net), NCDHW
# ----------------------------------------------------------------------
class VoxelGroupNorm(nn.GroupNorm):
    """GroupNorm32 with statistics in at least fp32, returning the input's
    dtype."""

    def forward(self, x):
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        return super().forward(xf).to(x.dtype)


def voxel_group_norm(channels: int) -> VoxelGroupNorm:
    return VoxelGroupNorm(min(32, channels), channels, eps=1e-5)


class ResnetBlock3D(nn.Module):
    """Dense resnet block with time-embedding shift."""

    def __init__(self, dim_in: int, dim_out: int, emb_dim: int,
                 dropout: float = 0.0):
        super().__init__()
        self.block1 = nn.Sequential(
            voxel_group_norm(dim_in), nn.SiLU(), _conv3d(dim_in, dim_out))
        self.time_mlp = nn.Sequential(nn.SiLU(), _linear(emb_dim, dim_out))
        self.block2 = nn.Sequential(
            voxel_group_norm(dim_out), nn.SiLU(), nn.Dropout(dropout),
            _conv3d(dim_out, dim_out, zero_init=True))
        self.res_conv = (_conv3d(dim_in, dim_out, kernel=1)
                         if dim_in != dim_out else None)

    def forward(self, x, emb):
        h = self.block1(x)
        h = h + self.time_mlp(emb)[:, :, None, None, None].to(h.dtype)
        h = self.block2(h)
        if self.res_conv is not None:
            x = self.res_conv(x)
        return h + x


class AttentionBlock3D(nn.Module):
    """Voxel self-attention: flattened spatial dims, one QKV projection,
    legacy head split, softmax in fp32."""

    def __init__(self, channels: int, num_heads: int = 1):
        super().__init__()
        self.num_heads = num_heads
        self.norm = voxel_group_norm(channels)
        self.qkv = nn.Conv1d(channels, 3 * channels, 1)
        self.proj_out = nn.Conv1d(channels, channels, 1)
        lecun_normal_(self.qkv.weight, channels)
        nn.init.zeros_(self.qkv.bias)
        nn.init.zeros_(self.proj_out.weight)
        nn.init.zeros_(self.proj_out.bias)

    def forward(self, x):
        b, c = x.shape[:2]
        xf = x.reshape(b, c, -1)
        qkv = self.qkv(self.norm(xf))
        qkv = qkv.reshape(b * self.num_heads, -1, qkv.shape[2])
        ch = qkv.shape[1] // 3
        q, k, v = torch.split(qkv, ch, dim=1)
        scale = 1.0 / math.sqrt(math.sqrt(ch))
        att = torch.einsum("bct,bcs->bts", q * scale, k * scale)
        att = torch.softmax(att.float(), dim=-1).to(x.dtype)
        h = torch.einsum("bts,bcs->bct", att, v).reshape(b, c, -1)
        return (xf + self.proj_out(h)).reshape(x.shape)


def attention_3d(channels: int, num_heads: int) -> nn.Sequential:
    """GroupNorm -> SiLU -> AttentionBlock3D (the reference's Sequential)."""
    return nn.Sequential(voxel_group_norm(channels), nn.SiLU(),
                         AttentionBlock3D(channels, num_heads))


class ConvDownsample3D(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.op = _conv3d(channels, channels, stride=2)

    def forward(self, x):
        return self.op(x)


class ConvUpsample3D(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = _conv3d(channels, channels)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))
