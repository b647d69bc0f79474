"""Structured configuration tree (dataclasses + YAML).

Same dataclasses and defaults as ``octfusion_tpu/config.py``; the octree
spec comes from this package, and ``yaml`` is imported only by the YAML
loaders, so building a :class:`Config` in Python needs no PyYAML.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from .octree.octree import OctreeSpec


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    sdf_scale: float = 0.9
    resolution: int = 256
    save_sdf: bool = False


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    depth: int = 8
    channel_in: int = 4
    full_depth: int = 4
    depth_stop: int = 6
    depth_out: int = 8
    embed_dim: int = 3
    resblk_num: int = 2
    channels: Tuple[int, ...] = (4, 512, 512, 256, 128, 64, 32, 32, 24, 8)
    use_checkpoint: bool = True
    # kept so YAML files of the JAX package load unchanged; the port has no
    # rematerialisation policies
    remat_policy: str = "full"


@dataclasses.dataclass(frozen=True)
class CapacityConfig:
    """Static per-depth node capacities (per sample)."""

    finest_cap: int = 131072
    decay: float = 4.0
    # edges per graph vertex bound (overflow is flagged, never silent)
    edge_factor: int = 9
    caps_override: Optional[Tuple[Optional[int], ...]] = None

    def octree_spec(self, depth, full_depth, batch_size=1) -> OctreeSpec:
        return OctreeSpec.create(
            depth, full_depth, batch_size,
            finest_cap_per_sample=self.finest_cap,
            decay=self.decay,
            caps_override=self.caps_override,
        )


@dataclasses.dataclass(frozen=True)
class DataConfig:
    location: str = ""
    filelist: str = ""
    name: str = "shapenet"           # or "synthetic"
    batch_size: int = 4
    point_scale: float = 0.5
    point_sample_num: int = 10000
    points_per_shape: int = 65536    # static point-cloud size per sample
    load_sdf: bool = True
    load_pointcloud: bool = True
    load_split_small: bool = False
    load_color: bool = False
    shuffle: bool = True
    num_workers: int = 4
    in_memory: bool = False
    class_families: bool = False


# diffusion.compute_dtype -> the dtype the U-Nets run their bodies in
COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def check_compute_dtype(name: str) -> torch.dtype:
    """The torch dtype of a ``compute_dtype`` name; raises ``ValueError``
    for any name but float32 and bfloat16 (no config of the JAX package
    offers another)."""
    if name not in COMPUTE_DTYPES:
        raise ValueError(f"diffusion.compute_dtype must be one of "
                         f"{sorted(COMPUTE_DTYPES)}, not {name!r}")
    return COMPUTE_DTYPES[name]


@dataclasses.dataclass(frozen=True)
class DiffusionConfig:
    timesteps: int = 1000
    noise_schedule: str = "linear"
    ddim_steps: int = 200
    sampler: str = "ancestral"   # or "dpmpp": DPM-Solver++(2M)
    truncated_time: float = 0.7
    lr_pos_weight: float = 1.0
    ema_rate: float = 0.999
    unet_type: Tuple[str, ...] = ("lr", "hr")
    df_type: Tuple[str, ...] = ("x0", "eps")
    input_depth: Tuple[int, ...] = (4, 6)
    input_channels: Tuple[int, ...] = (8, 3)
    out_channels: Tuple[int, ...] = (8, 3)
    model_channels: Tuple[int, ...] = (64, 128)
    num_res_blocks: Tuple[Tuple[int, ...], ...] = ((1, 1, 1), (1, 1, 0))
    channel_mult: Tuple[Tuple[int, ...], ...] = ((1, 2, 4), (1, 2, 4))
    attention_resolutions: Tuple[int, ...] = (2, 4)
    num_heads: int = 4
    num_classes: Optional[int] = None
    # "bfloat16": the U-Nets' mixed-precision flow of the JAX package
    # (nn/unet_union.py); parameters, schedule and loss stay float32
    compute_dtype: str = "float32"

    def __post_init__(self):
        check_compute_dtype(self.compute_dtype)


@dataclasses.dataclass(frozen=True)
class LossConfig:
    name: str = "geometry"
    loss_type: str = "sdf_reg_loss"
    kl_weight: float = 0.1
    spatial_grad: str = "analytic"


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr: float = 2e-4
    epochs: int = 500
    seed: int = 42
    ckpt_num: int = 5
    print_freq: int = 25
    save_latest_freq: int = 500
    save_steps_freq: int = 3000
    display_freq: int = 100000
    logs_dir: str = "logs"
    name: str = "run"
    weight_decay: float = 0.01


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """The data-parallel mesh of a multi-process training run
    (``parallel.mesh.make_mesh``): ``data_axis`` x ``model_axis`` ranks,
    -1 = every rank the model axis leaves.  Their product must equal the
    number of processes (``make_mesh`` raises otherwise); a single process
    ignores them."""
    data_axis: int = -1
    model_axis: int = 1


@dataclasses.dataclass(frozen=True)
class Config:
    solver: SolverConfig = SolverConfig()
    model: VAEConfig = VAEConfig()
    capacity: CapacityConfig = CapacityConfig()
    data: DataConfig = DataConfig()
    data_test: DataConfig = DataConfig(batch_size=1, shuffle=False)
    diffusion: DiffusionConfig = DiffusionConfig()
    loss: LossConfig = LossConfig()
    train: TrainConfig = TrainConfig()
    mesh: MeshConfig = MeshConfig()


def _build(cls, d):
    if d is None:
        return cls()
    fields = {f.name: f for f in dataclasses.fields(cls)}
    kwargs = {}
    for k, v in d.items():
        if k not in fields:
            raise KeyError(f"unknown config key {k} for {cls.__name__}")
        default = fields[k].default
        if dataclasses.is_dataclass(default.__class__) and isinstance(v, dict):
            kwargs[k] = _build(default.__class__, v)
        elif isinstance(v, list):
            kwargs[k] = tuple(tuple(x) if isinstance(x, list) else x for x in v)
        else:
            kwargs[k] = v
    return cls(**kwargs)


def load_config(path: str) -> Config:
    import yaml

    with open(path) as fh:
        raw = yaml.safe_load(fh) or {}
    return _build(Config, raw)


def dump_config(cfg: Config, path: str):
    import yaml

    with open(path, "w") as fh:
        yaml.safe_dump(dataclasses.asdict(cfg), fh, sort_keys=False)


def with_vae(cfg: Config, vae_cfg: Config) -> Config:
    """``cfg`` with the ``model`` and ``capacity`` of ``vae_cfg``: a
    diffusion config paired with the VAE it runs over.  The 3-stage
    Objaverse model is ``configs/octfusion_obja_uncond.yaml`` over
    ``configs/vae_obja_depth1084.yaml`` (the first alone sets depth_stop
    6, which its ``input_depth[2]`` of 8 contradicts)."""
    return dataclasses.replace(cfg, model=vae_cfg.model,
                               capacity=vae_cfg.capacity)
