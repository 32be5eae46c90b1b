"""The device mesh of a parallel run (counterpart of
mpgcn_tpu/parallel/mesh.py).

The JAX mesh is a (dp, mp) grid of devices with the axes ("data",
"model"), all driven by one process. Here each rank of the process group
is one device, and the mesh is a small value: the axis sizes, this rank,
the world, the rank's device, and the rank's place on the grid. Rank r
sits at (r // mp, r % mp), the JAX grid's row-major order, so consecutive
ranks form a model group. The "data" axis splits a batch's rows; the
"model" axis splits the origin nodes of every window (parallel/sharding.py
``node_shard``). ``model_group`` is the ``torch.distributed`` subgroup of
this rank's model group (the mp ranks that share its data index),
``data_group`` that of its data group (the dp ranks that share its model
index); None where the axis has one rank.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.distributed as dist

AXIS_DATA = "data"
AXIS_MODEL = "model"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``shape`` {"data": dp, "model": mp}; ``rank`` of ``world`` ranks;
    ``device`` the rank's device; ``model_group`` / ``data_group`` the
    rank's subgroups (None for an axis of one rank, or a mesh built by
    hand, which then runs no collective on that axis)."""

    shape: dict
    rank: int
    world: int
    device: torch.device
    model_group: Any = None
    data_group: Any = None

    @property
    def data_index(self) -> int:
        """This rank's row of the grid: its block of a batch's rows."""
        return self.rank // self.shape[AXIS_MODEL]

    @property
    def model_index(self) -> int:
        """This rank's column of the grid: its block of origin nodes."""
        return self.rank % self.shape[AXIS_MODEL]


def _subgroups(dp: int, mp: int, rank: int):
    """(model group, data group) of ``rank``. ``new_group`` is collective
    over the world: every rank makes every group, in one order."""
    model = data = None
    if mp > 1:
        for i in range(dp):
            g = dist.new_group(list(range(i * mp, (i + 1) * mp)))
            if rank // mp == i:
                model = g
    if dp > 1 and mp > 1:
        for j in range(mp):
            g = dist.new_group(list(range(j, dp * mp, mp)))
            if rank % mp == j:
                data = g
    elif dp > 1:
        data = dist.group.WORLD
    return model, data


def make_mesh(num_devices: Optional[int] = None, model_parallel: int = 1,
              device=None) -> Mesh:
    """The (num_devices // model_parallel, model_parallel) mesh over the
    process group's ranks (one rank and no group: a mesh of one).
    ``num_devices`` None takes every rank; more than the world has raises,
    as the JAX ``make_mesh`` does for more devices than it sees, and so
    does a count ``model_parallel`` does not divide. ``device`` (default:
    the card of this process's local rank) is the rank's device."""
    from mpgcn_tpu_torch.parallel.distributed import local_rank

    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    n = num_devices or world
    if n > world:
        raise ValueError(f"requested {n} devices, only {world} visible")
    if n % model_parallel:
        raise ValueError(f"num_devices {n} not divisible by "
                         f"model_parallel {model_parallel}")
    if n < world:
        raise ValueError(f"requested {n} devices of a world of {world}: "
                         f"every rank of the process group holds a shard")
    if device is None:
        device = torch.device("cuda", local_rank())
    dp, mp = n // model_parallel, model_parallel
    model, data = (_subgroups(dp, mp, rank) if dist.is_initialized()
                   else (None, None))
    return Mesh(shape={AXIS_DATA: dp, AXIS_MODEL: mp}, rank=rank,
                world=world, device=torch.device(device), model_group=model,
                data_group=data)
