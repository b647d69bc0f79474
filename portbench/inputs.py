"""The inputs the benchmark makes from ``--seed`` and hands to both sides,
the program and the plain reference: the models' weights, the denoising
noise of each generated shape, and the training batches with their draws.

Nothing here imports the program.  The weights follow the module layout of
the reference (``reference/``), whose parameter names and shapes are the
program's, and are drawn on the device from one generator in one call per
model, then scaled leaf by leaf by a rule on the owning module's kind.
"""

from __future__ import annotations

import math
import random
from typing import Dict, List

import torch

from .frozen.shapes import lumpy_spheres
from .reference import config as ref_config
from .reference.nn.unet_union import UNetUnion, UnionConfig
from .reference.nn.vae import GraphVAE
from .reference.octree.dual_graph import GraphSpec

MASK64 = (1 << 63) - 1
# salts that keep the seed's streams apart
SALT = {"df": 1, "vae": 2, "noise": 3, "batch": 4, "draws": 5, "pick": 6,
        "order": 7}


def mix(seed: int, salt: int, index: int = 0) -> int:
    """A 63-bit generator seed from the run's seed, a stream's salt and an
    item index (any whole numbers, negative ones too)."""
    h = (int(seed) * 0x9E3779B97F4A7C15 + salt * 0xBF58476D1CE4E5B9
         + index * 0x94D049BB133111EB) & MASK64
    h ^= h >> 31
    return (h * 0xD6E8FEB86659FD93) & MASK64


def build_config(raw: Dict):
    """The configuration tree of a ``configs/<name>.json`` file's
    ``config`` as the reference's ``Config``."""
    return ref_config._build(ref_config.Config, raw)


def sampling_config(raw: Dict, traffic: Dict) -> Dict:
    """A configuration tree with a generation mix's sampler."""
    raw = dict(raw)
    raw["diffusion"] = {**raw["diffusion"], "sampler": traffic["sampler"]}
    return raw


def union_config(cfg) -> UnionConfig:
    """The U-Nets' :class:`UnionConfig` of ``cfg``, as the solvers build
    it."""
    d, m = cfg.diffusion, cfg.model
    return UnionConfig(
        unet_type=tuple(d.unet_type), df_type=tuple(d.df_type),
        input_depth=tuple(d.input_depth), full_depth=m.full_depth,
        input_channels=tuple(d.input_channels),
        out_channels=tuple(d.out_channels),
        model_channels=tuple(d.model_channels),
        num_res_blocks=tuple(tuple(x) for x in d.num_res_blocks),
        channel_mult=tuple(tuple(x) for x in d.channel_mult),
        attention_resolutions=tuple(d.attention_resolutions),
        num_heads=d.num_heads, num_classes=d.num_classes,
        compute_dtype=d.compute_dtype)


def _leaf_rule(module: torch.nn.Module, pname: str, shape) -> tuple:
    """(mean, std) of a seeded leaf: biases small, norm scales near 1, a
    product's weight at 1/sqrt(fan-in) (LeCun's scale) by its layout."""
    kind = type(module).__name__
    if kind == "LearnedSinusoidalPosEmb":
        return 0.0, 1.0
    if pname == "bias":
        return 0.0, 0.02
    if len(shape) == 1 or (len(shape) == 2 and shape[0] == 1):
        return 1.0, 0.1                        # norm scales
    if kind == "GraphConv":                    # [7C, C']
        fan = shape[0]
    elif kind == "ChildDownsample":            # [C, C, 8]: [8C] -> [C]
        fan = shape[1] * shape[2]
    elif kind == "ChildUpsample":              # [C, C, 8]: [C] -> [8C]
        fan = shape[0]
    else:                                      # Linear, Conv1d/3d
        fan = math.prod(shape[1:])
    return 0.0, 1.0 / math.sqrt(fan)


def seeded_weights(layout: torch.nn.Module, seed: int, salt: int,
                   device) -> Dict[str, torch.Tensor]:
    """name -> weight of every parameter of ``layout`` (a module of the
    reference, on any device, ``meta`` too), drawn on ``device`` from one
    generator seeded by ``seed`` and ``salt``."""
    owners = dict(layout.named_modules())
    leaves = list(layout.named_parameters())
    total = sum(p.numel() for _, p in leaves)
    gen = torch.Generator(device=device)
    gen.manual_seed(mix(seed, salt))
    flat = torch.randn(total, generator=gen, device=device)
    out, off = {}, 0
    for name, p in leaves:
        mod_name, _, pname = name.rpartition(".")
        mean, std = _leaf_rule(owners[mod_name], pname, tuple(p.shape))
        n = p.numel()
        out[name] = flat[off:off + n].view(p.shape).mul(std).add(mean)
        off += n
    return out


def model_weights(cfg, stage_flag: str, seed: int, device):
    """{"df": the U-Nets' weights, "vae": the VAE's} for ``cfg``'s models
    up to ``stage_flag``."""
    m = cfg.model
    with torch.device("meta"):
        df = UNetUnion(union_config(cfg), stage_flag)
        vae = GraphVAE(depth=m.depth, channel_in=m.channel_in,
                       full_depth=m.full_depth, depth_stop=m.depth_stop,
                       depth_out=m.depth_out, embed_dim=m.embed_dim,
                       resblk_num=m.resblk_num, channels=tuple(m.channels),
                       use_checkpoint=m.use_checkpoint)
    return {"df": seeded_weights(df, seed, SALT["df"], device),
            "vae": seeded_weights(vae, seed, SALT["vae"], device)}


def load_weights(module: torch.nn.Module, weights: Dict[str, torch.Tensor]):
    """Copy ``weights`` into ``module``'s parameters; the two name sets
    must be equal."""
    params = dict(module.named_parameters())
    if set(params) != set(weights):
        missing = sorted(set(weights) ^ set(params))[:5]
        raise KeyError(f"weights and module differ in names: {missing}")
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(weights[name])


def stage_noise(shape, seed: int, index: int, stage: int, device):
    """The initial state of one denoising stage of generated shape
    ``index``: a standard normal of ``shape`` on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(mix(seed, SALT["noise"] * 16 + stage, index))
    return torch.randn(shape, generator=gen, device=device)


def pool_order(seed: int, pool: int) -> List[int]:
    """The order, drawn from the seed, in which a run takes the ``pool``
    training batches."""
    order = list(range(pool))
    random.Random(mix(seed, SALT["order"])).shuffle(order)
    return order


def train_batch(batch_size: int, n_points: int, scale: float, seed: int,
                index: int, pool: int):
    """Training batch ``index`` of a run: ``batch_size`` lumpy spheres of
    ``n_points`` points (scaled by ``scale``) and their normals, on the
    host.  Every seed trains on the same ``pool`` batches, whose shapes'
    sizes set a step's work, in the order :func:`pool_order` draws."""
    k = pool_order(seed, pool)[index % pool]
    pts, nrm = lumpy_spheres(batch_size, n_points,
                             mix(0, SALT["batch"], k) & 0x7FFFFFFF)
    return {"points": pts * scale, "normals": nrm}


def train_draws(batch_size: int, shape, with_eps: bool, seed: int,
                index: int):
    """The loss's ``times`` [B] and ``noise`` (the target's shape) and the
    encoder's ``eps`` for training batch ``index``, on the host."""
    gen = torch.Generator().manual_seed(mix(seed, SALT["draws"], index))
    out = {"times": torch.rand(batch_size, generator=gen),
           "noise": torch.randn(shape, generator=gen)}
    if with_eps:
        out["eps"] = torch.randn(shape, generator=gen)
    return out


def stream_len(sampler: str, df_type: str, steps: int) -> int:
    """Entries of a stage's noise stream the sampler reads: the initial
    state, plus one per step on the ancestral x0 path."""
    return steps + 1 if sampler == "ancestral" and df_type == "x0" else 1


def noise_shapes(cfg, batch_size: int, sampler: str, steps: int) -> List:
    """(sample keyword, shape) of each stage's noise stream, in stage
    order: the lr grid NCDHW, then each graph stage's [n, G_cap, C]."""
    d, m = cfg.diffusion, cfg.model
    s = 2**m.full_depth
    df = dict(zip(d.unet_type, d.df_type))
    out = [("lr_noise", (stream_len(sampler, df["lr"], steps), batch_size,
                         d.input_channels[0], s, s, s))]
    spec1 = cfg.capacity.octree_spec(m.depth, m.full_depth, 1)
    spec = GraphSpec(spec1.with_batch_size(batch_size),
                     cfg.capacity.edge_factor)
    for i, kind in enumerate(d.unet_type[1:], start=1):
        out.append((f"{kind}_noise",
                    (stream_len(sampler, df[kind], steps),
                     spec.g_cap(d.input_depth[i]), d.input_channels[i])))
    return out


def train_target_shape(cfg, stage: str, batch_size: int):
    """Shape of a training batch's diffusion target (the loss's ``noise``,
    and the encoder's ``eps`` where the target is the VAE's codes): the
    codes at ``depth_stop``, or the 3-stage hr stage's ``split_large`` on
    the depth-``input_depth[1]`` layout."""
    d, m = cfg.diffusion, cfg.model
    spec1 = cfg.capacity.octree_spec(m.depth, m.full_depth, 1)
    spec = GraphSpec(spec1.with_batch_size(batch_size),
                     cfg.capacity.edge_factor)
    if stage == "hr" and "feature" in d.unet_type:
        return (spec.g_cap(d.input_depth[1]), 8)
    return (spec.g_cap(m.depth_stop), m.embed_dim)
