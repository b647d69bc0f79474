"""The ('data', 'model') mesh of a data-parallel run (port of
``octfusion_tpu/parallel/mesh.py``): one rank per device, rank r at data
index ``r // model`` and model index ``r % model``, the JAX mesh's
row-major layout of its devices.  The batch is split over the data axis;
the VAE's SDF queries also over the model axis."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from . import dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    data: int
    model: int

    @property
    def size(self) -> int:
        return self.data * self.model

    def coords(self, rank: Optional[int] = None) -> Tuple[int, int]:
        """(data index, model index) of ``rank`` (default: this process)."""
        r = dist.rank() if rank is None else rank
        if not 0 <= r < self.size:
            raise ValueError(f"rank {r} is outside the {self.data} x "
                             f"{self.model} mesh")
        return divmod(r, self.model)


def make_mesh(data: int = -1, model: int = 1,
              world: Optional[int] = None) -> Mesh:
    """The mesh over ``world`` ranks (default: the process group's size);
    ``data = -1`` takes every rank the model axis leaves.  ``data *
    model`` must equal the world (``mesh.data_axis`` / ``mesh.model_axis``
    of the config)."""
    world = dist.world_size() if world is None else world
    if model < 1 or world % model:
        raise ValueError(f"mesh.model_axis {model} does not divide the "
                         f"world of {world} processes")
    if data == -1:
        data = world // model
    if data * model != world:
        raise ValueError(f"mesh.data_axis {data} x mesh.model_axis {model} "
                         f"= {data * model}, but the world has {world} "
                         "processes (set data_axis to -1 or to world / "
                         "model_axis)")
    return Mesh(data, model)
