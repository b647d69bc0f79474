"""Parameter bridge: the JAX package's flax parameter trees -> this
port's ``state_dict``s; and the reference's own checkpoints, which load
into the port as they stand (:func:`load_union_checkpoint`,
:func:`load_vae_checkpoint`), since the port's modules use the
reference's state-dict keys.

It inverts ``octfusion_tpu/utils/torch_convert.py`` (which maps the
reference PyTorch checkpoints to flax): Linear kernels transpose back,
NDHWC conv kernels go back to NCDHW, graph-norm vectors regain their
``[1, C]`` shape, and the child-mix matrices are re-scrambled into the
reference's ``[C, C, 8]`` tensors.  Every mapping is a transpose or
reshape, so a round trip reproduces the reference tensors bit for bit.
Leaves may be numpy or JAX arrays (read with ``np.asarray``); nothing here
imports JAX.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from . import ckpt as ckpt_lib


class _Bridge:
    """Collects state-dict entries read from one flax tree."""

    def __init__(self, tree: Dict):
        self.tree = tree.get("params", tree)
        self.sd: Dict[str, torch.Tensor] = {}

    def get(self, path):
        node = self.tree
        for p in path:
            node = node[p]
        return np.asarray(node)

    def has(self, path) -> bool:
        node = self.tree
        for p in path:
            if not isinstance(node, dict) or p not in node:
                return False
            node = node[p]
        return True

    def put(self, key: str, a: np.ndarray):
        self.sd[key] = torch.tensor(np.ascontiguousarray(a))

    # --- layer mappings (inverse of torch_convert's) -------------------
    def linear(self, key, path, bias=True):
        self.put(key + ".weight", self.get(path + ("kernel",)).T)
        if bias and self.has(path + ("bias",)):
            self.put(key + ".bias", self.get(path + ("bias",)))

    def gn_graph(self, key, path):
        for name in ("weights", "bias"):
            self.put(f"{key}.{name}", self.get(path + (name,)).reshape(1, -1))

    def gn_voxel(self, key, path):
        self.put(key + ".weight", self.get(path + ("GroupNorm_0", "scale")))
        self.put(key + ".bias", self.get(path + ("GroupNorm_0", "bias")))

    def graph_conv(self, key, path):
        self.put(key + ".weights", self.get(path + ("weights",)))
        if self.has(path + ("bias",)):
            self.put(key + ".bias", self.get(path + ("bias",)))

    def conv3d(self, key, path):
        k = self.get(path + ("kernel",))                 # [D, H, W, I, O]
        self.put(key + ".weight", np.transpose(k, (4, 3, 0, 1, 2)))
        self.put(key + ".bias", self.get(path + ("bias",)))

    def conv1d(self, key, path):
        self.put(key + ".weight", self.get(path + ("kernel",)).T[..., None])
        self.put(key + ".bias", self.get(path + ("bias",)))

    def down_mix(self, key, path):
        m = self.get(path + ("weights",))                # M[q, a]
        c = m.shape[1]
        self.put(key + ".weights", m.T.reshape(c, c, 8))

    def up_mix(self, key, path):
        m = self.get(path + ("weights",))                # M[a, p]
        c = m.shape[0]
        self.put(key + ".weights", m.reshape(c, c, 8))

    def conv1x1(self, key, path, bias=False):
        self.linear(key + ".linear", path + ("linear",), bias)

    def conv1x1gn(self, key, path):
        self.conv1x1(key + ".conv", path + ("conv",))
        self.gn_graph(key + ".gn", path + ("gn",))

    def graph_resblocks(self, key, path, n):
        for j in range(n):
            k, p = f"{key}.resblks.{j}", path + (f"resblks_{j}",)
            self.gn_graph(k + ".norm1", p + ("norm1",))
            self.graph_conv(k + ".conv1", p + ("conv1",))
            self.gn_graph(k + ".norm2", p + ("norm2",))
            self.graph_conv(k + ".conv2", p + ("conv2",))
            if self.has(p + ("conv1x1c",)):
                self.conv1x1gn(k + ".conv1x1c", p + ("conv1x1c",))

    def resblock_embed(self, key, path):
        self.gn_graph(key + ".block1_norm", path + ("block1_norm",))
        self.graph_conv(key + ".conv1", path + ("conv1",))
        self.linear(key + ".emb_layers.1", path + ("emb_layers",))
        self.gn_graph(key + ".block2_norm", path + ("block2_norm",))
        self.graph_conv(key + ".conv2", path + ("conv2",))
        if self.has(path + ("skip_connection",)):
            self.conv1x1(key + ".skip_connection", path + ("skip_connection",))

    def predict_head(self, key, path):
        self.conv1x1(key + ".0.conv", path + ("head0", "conv"))
        self.gn_graph(key + ".0.gn", path + ("head0", "gn"))
        self.linear(key + ".1.linear", path + ("head1", "linear"))

    def resnet3d(self, key, path):
        self.gn_voxel(key + ".block1.0", path + ("norm1",))
        self.conv3d(key + ".block1.2", path + ("conv1", "conv"))
        self.linear(key + ".time_mlp.1", path + ("time_mlp",))
        self.gn_voxel(key + ".block2.0", path + ("norm2",))
        self.conv3d(key + ".block2.3", path + ("conv2", "conv"))
        if self.has(path + ("res_conv",)):
            self.conv3d(key + ".res_conv", path + ("res_conv", "conv"))

    def attention3d(self, key_norm, key_attn, path_norm, path_attn):
        self.gn_voxel(key_norm, path_norm)
        self.gn_voxel(key_attn + ".norm", path_attn + ("norm",))
        self.conv1d(key_attn + ".qkv", path_attn + ("qkv",))
        self.conv1d(key_attn + ".proj_out", path_attn + ("proj_out",))


def vae_state_dict(params: Dict, depth: int = 8, depth_stop: int = 6,
                   depth_out: int = 8, resblk_num: int = 2
                   ) -> Dict[str, torch.Tensor]:
    """flax ``GraphVAE`` params -> the port's ``GraphVAE`` state dict,
    encoder and decoder."""
    b = _Bridge(params)
    b.graph_conv("conv1", ("conv1",))
    for i in range(depth - depth_stop + 1):
        b.graph_resblocks(f"encoder.{i}", (f"encoder_{i}",), resblk_num - 1)
    for i in range(depth - depth_stop):
        b.down_mix(f"downsample.{i}.downsample",
                   (f"downsample_{i}", "downsample"))
        if b.has((f"downsample_{i}", "conv1x1")):
            b.conv1x1gn(f"downsample.{i}.conv1x1",
                        (f"downsample_{i}", "conv1x1"))
    b.gn_graph("encoder_norm_out", ("encoder_norm_out",))
    b.conv1x1("KL_conv", ("KL_conv",), bias=True)
    b.conv1x1("post_KL_conv", ("post_KL_conv",), bias=True)
    b.graph_resblocks("decoder_mid.block_1", ("decoder_mid_block_1",),
                      resblk_num)
    b.graph_resblocks("decoder_mid.block_2", ("decoder_mid_block_2",),
                      resblk_num)
    for i in range(depth_out - depth_stop + 1):
        b.graph_resblocks(f"decoder.{i}", (f"decoder_{i}",), resblk_num)
        b.predict_head(f"predict.{i}", (f"predict_{i}",))
        b.predict_head(f"regress.{i}", (f"regress_{i}",))
    for i in range(depth_out - depth_stop):
        b.up_mix(f"upsample.{i}.upsample", (f"upsample_{i}", "upsample"))
        if b.has((f"upsample_{i}", "conv1x1")):
            b.conv1x1gn(f"upsample.{i}.conv1x1", (f"upsample_{i}", "conv1x1"))
    return b.sd


def unet_lr_state_dict(params: Dict, channel_mult=(1, 2, 4),
                       attention_resolutions=(2, 4)) -> Dict[str, torch.Tensor]:
    """flax ``UNetLR`` params -> the port's ``UNetLR`` state dict."""
    b = _Bridge(params)
    b.put("time_pos_emb.weights", b.get(("time_pos_emb", "weights")))
    b.linear("time_emb.0", ("time_emb_1",))
    b.linear("time_emb.2", ("time_emb_2",))
    if b.has(("label_emb",)):
        b.put("label_emb.weight", b.get(("label_emb", "embedding")))
    b.conv3d("input_emb", ("input_emb", "conv"))
    num_res = len(channel_mult)
    ds = 1
    for ind in range(num_res):
        b.resnet3d(f"downs.{ind}.0", (f"down_{ind}_res",))
        if ds in attention_resolutions:
            b.attention3d(f"downs.{ind}.1.0", f"downs.{ind}.1.2",
                          (f"down_{ind}_attnnorm",), (f"down_{ind}_attn",))
        if ind < num_res - 1:
            b.conv3d(f"downs.{ind}.2.op", (f"down_{ind}_ds", "op", "conv"))
            ds *= 2
    b.resnet3d("mid_block1", ("mid_block1",))
    if ds in attention_resolutions:
        b.attention3d("mid_self_attn.0", "mid_self_attn.2", ("mid_attnnorm",),
                      ("mid_attn",))
    b.resnet3d("mid_block2", ("mid_block2",))
    for ind in range(num_res - 1):
        b.resnet3d(f"ups.{ind}.0", (f"up_{ind}_res",))
        if ds in attention_resolutions:
            b.attention3d(f"ups.{ind}.1.0", f"ups.{ind}.1.2",
                          (f"up_{ind}_attnnorm",), (f"up_{ind}_attn",))
        b.conv3d(f"ups.{ind}.2.conv", (f"up_{ind}_us", "conv", "conv"))
        ds //= 2
    b.gn_voxel("end.0", ("end_norm",))
    b.conv3d("out", ("out", "conv"))
    return b.sd


def unet_hr_state_dict(params: Dict, channel_mult=(1, 2, 4),
                       num_res_blocks=(1, 1, 0)) -> Dict[str, torch.Tensor]:
    """flax ``UNetHR`` params -> the port's ``UNetHR`` state dict."""
    b = _Bridge(params)
    b.linear("time_embed.0", ("time_embed_1",))
    b.linear("time_embed.2", ("time_embed_2",))
    if b.has(("label_emb",)):
        b.put("label_emb.weight", b.get(("label_emb", "embedding")))
    b.graph_conv("input_blocks.0", ("input_conv",))
    k = 1
    for level in range(len(channel_mult)):
        for _ in range(num_res_blocks[level]):
            b.resblock_embed(f"input_blocks.{k}", (f"input_{k - 1}",))
            k += 1
        if level != len(channel_mult) - 1:
            b.down_mix(f"input_blocks.{k}.downsample",
                       (f"input_{k - 1}", "downsample"))
            b.graph_conv(f"input_blocks.{k}.conv", (f"input_{k - 1}", "conv"))
            k += 1
    b.resblock_embed("middle_block1", ("middle_block1",))
    b.resblock_embed("middle_block2", ("middle_block2",))
    k = 0
    for level in reversed(range(len(channel_mult))):
        for i in range(num_res_blocks[level] + 1):
            b.resblock_embed(f"output_blocks.{k}", (f"output_{k}",))
            k += 1
            if level and i == num_res_blocks[level]:
                b.up_mix(f"output_blocks.{k}.upsample",
                         (f"output_{k}", "upsample"))
                b.graph_conv(f"output_blocks.{k}.conv", (f"output_{k}", "conv"))
                k += 1
    b.gn_graph("end_norm", ("end_norm",))
    b.graph_conv("out", ("out",))
    return b.sd


def union_state_dict(params: Dict, union_cfg) -> Dict[str, torch.Tensor]:
    """flax ``UNetUnion`` params -> the port's ``UNetUnion`` state dict
    (stages present in ``params``)."""
    tree = params.get("params", params)
    sd = {}
    for i, kind in enumerate(union_cfg.unet_type):
        if kind not in ("lr", "hr") or f"unet_{kind}" not in tree:
            continue
        if kind == "lr":
            part = unet_lr_state_dict(
                tree["unet_lr"], union_cfg.channel_mult[i],
                union_cfg.attention_resolutions)
        else:
            part = unet_hr_state_dict(
                tree["unet_hr"], union_cfg.channel_mult[i],
                union_cfg.num_res_blocks[i])
        sd.update({f"unet_{kind}.{k}": v for k, v in part.items()})
    return sd


# ----------------------------------------------------------------------
# the reference's checkpoint layout (octfusion_model_union.py:501-523)
# ----------------------------------------------------------------------
def union_checkpoint(df: torch.nn.Module,
                     ema: Optional[Dict[str, torch.Tensor]] = None) -> Dict:
    """A ``UNetUnion``'s weights in the reference's checkpoint layout, for
    each U-Net ``df`` holds: ``df_unet_<kind>``, its live state dict, and
    ``ema_df_unet_<kind>``, the same keys with each parameter taken from
    ``ema`` (name in ``df`` -> tensor, as ``TrainStep.ema`` holds them;
    buffers stay live, and a parameter missing from ``ema`` raises).  Without ``ema`` both entries hold the live
    weights.  Tensors on the host, under the reference keys."""
    tree = {}
    for kind in ("lr", "hr"):
        net = getattr(df, f"unet_{kind}", None)
        if net is None:
            continue
        sd = {k: v.detach().cpu() for k, v in net.state_dict().items()}
        tree[f"df_unet_{kind}"] = sd
        if ema is None:
            tree[f"ema_df_unet_{kind}"] = sd
            continue
        params = {n for n, _ in net.named_parameters()}
        tree[f"ema_df_unet_{kind}"] = {
            k: ema[f"unet_{kind}.{k}"].detach().cpu() if k in params else v
            for k, v in sd.items()}
    return tree


def union_ema(tree: Dict) -> Dict[str, torch.Tensor]:
    """The ``ema_df_unet_*`` entries of a reference-layout checkpoint as
    one dict keyed by the parameter names of ``UNetUnion``
    (``unet_<kind>.<key>``), as ``TrainStep.ema`` holds them."""
    return {f"unet_{kind}.{k}": v for kind in ("lr", "hr")
            for k, v in tree.get(f"ema_df_unet_{kind}", {}).items()}


def graft_union_checkpoint(df: torch.nn.Module,
                           ema: Dict[str, torch.Tensor], tree: Dict,
                           kinds=("lr",)) -> list:
    """Stage bootstrap (``train.py:219-234`` of the JAX package; the
    reference's ``octfusion_model_union.py:127-128``): for each U-Net kind
    of ``kinds`` that both ``df`` and the checkpoint ``tree`` hold, load
    ``df_unet_<kind>`` into ``df.unet_<kind>`` and ``ema_df_unet_<kind>``
    into its entries of ``ema``.  Strict.  -> the kinds grafted."""
    grafted = []
    for kind in kinds:
        net = getattr(df, f"unet_{kind}", None)
        if net is None or f"df_unet_{kind}" not in tree:
            continue
        net.load_state_dict(tree[f"df_unet_{kind}"], strict=True)
        src = tree[f"ema_df_unet_{kind}"]
        with torch.no_grad():
            for n, _ in net.named_parameters():
                ema[f"unet_{kind}.{n}"].copy_(src[n])
        grafted.append(kind)
    return grafted


def load_union_checkpoint(df: torch.nn.Module, tree: Dict,
                          ema: bool = True) -> None:
    """Load a reference-layout diffusion checkpoint (``tree``, as
    ``utils/ckpt.restore`` returns it) into ``df``: the ``ema_df_unet_*``
    entries, or ``df_unet_*`` with ``ema=False``.  Strict: a U-Net of
    ``df`` without an entry, an entry without a U-Net, or a missing or
    unexpected key raises."""
    prefix = "ema_df_" if ema else "df_"
    sd = {}
    for kind in ("lr", "hr"):
        entry = tree.get(f"{prefix}unet_{kind}")
        has = getattr(df, f"unet_{kind}", None) is not None
        if entry is None and has:
            raise KeyError(f"checkpoint has no {prefix}unet_{kind}")
        if entry is not None and not has:
            raise KeyError(f"checkpoint has {prefix}unet_{kind} but the "
                           f"model has no unet_{kind}")
        if entry is not None:
            sd.update({f"unet_{kind}.{k}": v for k, v in entry.items()})
    df.load_state_dict(sd, strict=True)


def load_vae_checkpoint(vae: torch.nn.Module, path: str) -> None:
    """Load a VAE checkpoint file into ``vae``: the reference's ``.pth``
    or this package's trainer checkpoint (their ``autoencoder`` entry), or
    a bare state dict.  Strict.  The JAX package's orbax checkpoint
    directories cannot be read here (that needs orbax): a directory
    raises."""
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory (an orbax checkpoint of the JAX "
            "package?); the port reads torch checkpoint files only")
    raw = ckpt_lib.restore(path)
    vae.load_state_dict(raw.get("autoencoder", raw), strict=True)
