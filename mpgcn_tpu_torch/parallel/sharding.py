"""Where a batch's rows and the training state live on the mesh
(counterpart of mpgcn_tpu/parallel/sharding.py).

The JAX ``batch_sharding`` lays a batch's rows over the "data" axis as a
1-D ``NamedSharding``: device d holds the contiguous block of rows
[d * B / dp, (d + 1) * B / dp). ``batch_shard`` gives the same block for
this rank. The weights, Adam's state and the support banks are
replicated: every rank holds all of them, so ``replicated`` is the
identity. ``param_shardings`` and ``quantized_param_shardings`` shard
along the model axis and wait for it (ROADMAP.md Queue 1, item 1(b)).
"""

from __future__ import annotations

from mpgcn_tpu_torch.parallel.mesh import AXIS_DATA, Mesh


def batch_shard(mesh: Mesh, batch_size: int) -> slice:
    """The global rows of a batch of ``batch_size`` that this rank owns."""
    dp = mesh.shape[AXIS_DATA]
    if batch_size % dp:
        raise ValueError(f"batch of {batch_size} rows does not split over "
                         f"the data axis ({dp} devices)")
    b = batch_size // dp
    return slice(mesh.rank * b, (mesh.rank + 1) * b)


def replicated(mesh: Mesh, value):
    """``value`` as every rank holds it: unchanged."""
    return value
