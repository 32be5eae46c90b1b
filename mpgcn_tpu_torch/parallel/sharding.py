"""Where a batch's rows, its origin nodes and the training state live on
the mesh (counterpart of mpgcn_tpu/parallel/sharding.py).

The JAX ``batch_sharding`` lays a batch's rows over the "data" axis:
device (i, j) holds the contiguous block of rows [i * B / dp, (i + 1) * B
/ dp). ``batch_shard`` gives the same block for this rank's data index.
Whenever the model axis has more than one device (``shard_nodes``, the
JAX ``batch_sharding(..., shard_nodes=True)``) it also lays the
ORIGIN-node axis of the 5-D (B, T, N, N, F) windows over "model":
``node_shard`` gives this rank's block
of origins (a ``NodeShard``, mpgcn_tpu_torch/node_shard.py), [j * n_loc, (j + 1) * n_loc) with n_loc = ceil(N / mp); where
mp does not divide N the last block runs past N and its rows are padding
(zero in the windows; the loss and the metrics leave them out).

The weights, Adam's state and the support banks are replicated: every
rank holds all of them, so ``replicated`` is the identity. The JAX
``param_shardings`` and ``quantized_param_shardings`` also shard the
weights' hidden dimension over "model"; the port keeps them whole on every
rank (a departure kept on purpose, ROADMAP.md): the JAX kernel wrappers
take the weights whole too (``in_specs P()``), and what the model axis has
to split is the B*N^2 activations.
"""

from __future__ import annotations

from mpgcn_tpu_torch.node_shard import NodeShard
from mpgcn_tpu_torch.parallel.mesh import AXIS_DATA, AXIS_MODEL, Mesh


def batch_shard(mesh: Mesh, batch_size: int) -> slice:
    """The global rows of a batch of ``batch_size`` that this rank owns."""
    dp = mesh.shape[AXIS_DATA]
    if batch_size % dp:
        raise ValueError(f"batch of {batch_size} rows does not split over "
                         f"the data axis ({dp} devices)")
    b = batch_size // dp
    return slice(mesh.data_index * b, (mesh.data_index + 1) * b)


def shard_nodes(mesh: Mesh) -> bool:
    """Are the windows' origin nodes sharded over "model"? The JAX
    trainer's default: whenever the model axis has more than one device
    (branch parallelism, which would claim the axis, is not ported)."""
    return mesh.shape[AXIS_MODEL] > 1


def node_shard(mesh: Mesh, num_nodes: int) -> NodeShard:
    """This rank's origin block of an N = ``num_nodes`` grid and its
    padding (n_loc = ceil(N / mp) rows; the last blocks pad past N)."""
    mp = mesh.shape[AXIS_MODEL]
    return NodeShard(num_nodes, -(-num_nodes // mp), mp, mesh.model_index,
                     mesh.model_group)


def replicated(mesh: Mesh, value):
    """``value`` as every rank holds it: unchanged."""
    return value
