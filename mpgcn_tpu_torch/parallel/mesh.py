"""The device mesh of a data-parallel run (counterpart of
mpgcn_tpu/parallel/mesh.py).

The JAX mesh is a grid of devices with the axes ("data", "model"), all
driven by one process. Here each rank of the process group is one device,
so the mesh is a small value: the axis sizes, this rank, the world and
the rank's device. The "data" axis spans the ranks; the "model" axis
(sharded nodes, hidden widths or branches) is not ported yet
(ROADMAP.md Queue 1, item 1(b)), so it is 1.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

AXIS_DATA = "data"
AXIS_MODEL = "model"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``shape`` {"data": dp, "model": 1}; ``rank`` of ``world`` ranks;
    ``device`` the rank's device."""

    shape: dict
    rank: int
    world: int
    device: torch.device


def make_mesh(num_devices: Optional[int] = None, model_parallel: int = 1,
              device=None) -> Mesh:
    """The mesh over the process group's ranks (one rank and no group:
    a mesh of one). ``num_devices`` None takes every rank; more than the
    world has raises, as the JAX ``make_mesh`` does for more devices than
    it sees, and so does a count ``model_parallel`` does not divide.
    ``device`` (default: the card of this process's local rank) is the
    rank's device."""
    from mpgcn_tpu_torch.parallel.distributed import local_rank

    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    n = num_devices or world
    if n > world:
        raise ValueError(f"requested {n} devices, only {world} visible")
    if n % model_parallel:
        raise ValueError(f"num_devices {n} not divisible by "
                         f"model_parallel {model_parallel}")
    if model_parallel > 1:
        raise NotImplementedError(
            f"model_parallel {model_parallel}: the model axis is not ported "
            f"yet (ROADMAP.md Queue 1, item 1(b)); the port runs the data "
            f"axis only")
    if n < world:
        raise ValueError(f"requested {n} devices of a world of {world}: "
                         f"every rank of the process group holds a shard")
    if device is None:
        device = torch.device("cuda", local_rank())
    return Mesh(shape={AXIS_DATA: n, AXIS_MODEL: 1}, rank=rank, world=world,
                device=torch.device(device))
