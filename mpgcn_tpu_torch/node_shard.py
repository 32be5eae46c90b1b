"""A rank's block of origin nodes on the model axis, and the collectives
over its model group (the collectives GSPMD inserts between the JAX
package's node-sharded kernels). The layers (nn/) take a ``NodeShard``
as a value; ``parallel/sharding.py`` ``node_shard`` builds it from a
mesh.

``NodeShard``: rows [j * n_loc, (j + 1) * n_loc) of an origin axis of
N nodes, n_loc = ceil(N / mp); where mp does not divide N the last
blocks run past N and their rows are padding (zero in the windows and
in the supports' origin rows).

``gather_origins`` all-gathers every rank's block of an origin axis over
a model group, forward, and reduce-scatters (SUM) the cotangent back to
the blocks, backward: each rank's block then receives the gradient that
every rank's loss sends it, so the weight gradients a rank accumulates
through its own block are partial sums that one all-reduce over the
world completes (parallel/trainer.py ``_reduce_step``).

Where the tensors live: an NCCL group takes CUDA tensors as they are (and
the calls may be captured into a CUDA graph); gloo's collectives run on
the host, so a CUDA tensor is staged through host memory for the call and
copied back (the card's kernels still do all the compute).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

#: the tensor collectives under their current names (older releases have
#: only the ``*_tensor`` ones)
_ALL_GATHER = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


@dataclasses.dataclass(frozen=True)
class NodeShard:
    """This rank's block of origin nodes: rows [start, stop) of the padded
    origin axis of ``mp * n_loc`` rows, of which the first ``num_nodes``
    are real; ``group`` the model group the blocks are gathered over."""

    num_nodes: int
    n_loc: int
    mp: int
    index: int
    group: object = None

    @property
    def start(self) -> int:
        return self.index * self.n_loc

    @property
    def stop(self) -> int:
        return self.start + self.n_loc

    @property
    def padded(self) -> int:
        """The padded origin count, mp * n_loc."""
        return self.mp * self.n_loc

    @property
    def real(self) -> int:
        """How many of this block's rows are real nodes."""
        return max(0, min(self.stop, self.num_nodes) - self.start)

    def take(self, a, axis: int):
        """This block of ``a``'s origin ``axis`` (a numpy array or a
        tensor), its padded rows zero."""
        n = a.shape[axis]
        if n != self.num_nodes:
            raise ValueError(f"origin axis {axis} of {tuple(a.shape)} has "
                             f"{n} nodes, not {self.num_nodes}")
        idx = [slice(None)] * a.ndim
        idx[axis] = slice(self.start, min(self.stop, n))
        part = a[tuple(idx)]
        pad = self.n_loc - part.shape[axis]
        if not pad:
            return part
        shape = list(a.shape)
        shape[axis] = pad
        if torch.is_tensor(a):
            zeros = a.new_zeros(shape)
            return torch.cat([part, zeros], dim=axis)
        return np.concatenate([part, np.zeros(shape, a.dtype)], axis=axis)

    def mask(self, device=None) -> torch.Tensor:
        """(n_loc,) f32: 1 on this block's real rows, 0 on its padding."""
        m = torch.zeros(self.n_loc, device=device)
        m[:self.real] = 1.0
        return m


def staging_device(t: torch.Tensor, group) -> torch.device:
    """Where ``t`` goes for a collective over ``group``: its own device
    for NCCL (or a CPU tensor), else the host."""
    if t.device.type == "cuda" and dist.get_backend(group) != "nccl":
        return torch.device("cpu")
    return t.device


def all_gather_blocks(t: torch.Tensor, group, size: int) -> torch.Tensor:
    """The ``size`` ranks' ``t`` of ``group`` stacked along dim 0, in rank
    order (no autograd)."""
    comm = staging_device(t, group)
    buf = t.contiguous().to(comm)
    out = buf.new_empty((size * buf.shape[0],) + tuple(buf.shape[1:]))
    _ALL_GATHER(out, buf, group=group)
    return out.to(t.device)


def reduce_scatter_blocks(t: torch.Tensor, group, size: int) -> torch.Tensor:
    """The SUM over ``group``'s ``size`` ranks of ``t``, this rank's dim-0
    block of it (no autograd)."""
    comm = staging_device(t, group)
    buf = t.contiguous().to(comm)
    out = buf.new_empty((buf.shape[0] // size,) + tuple(buf.shape[1:]))
    _REDUCE_SCATTER(out, buf, op=dist.ReduceOp.SUM, group=group)
    return out.to(t.device)


class _GatherOrigins(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, size):
        ctx.dim, ctx.group, ctx.size = dim, group, size
        front = x.movedim(dim, 0)
        return all_gather_blocks(front, group, size).movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        front = g.movedim(ctx.dim, 0)
        return (reduce_scatter_blocks(front, ctx.group, ctx.size)
                .movedim(0, ctx.dim), None, None, None)


def gather_origins(x: torch.Tensor, shard: NodeShard,
                   dim: int = 1) -> torch.Tensor:
    """Every rank's origin block of ``x`` (axis ``dim``, ``shard.n_loc``
    rows) gathered over the model group, trimmed to the
    ``shard.num_nodes`` real origins: all-gather forward, reduce-scatter
    (SUM) backward. A shard of one rank trims only."""
    if shard.mp == 1:
        full = x
    elif shard.group is None:
        raise ValueError(f"a node shard over {shard.mp} ranks without its "
                         f"model group: build the mesh with make_mesh in "
                         f"a joined process group")
    else:
        full = _GatherOrigins.apply(x, dim, shard.group, shard.mp)
    return full.narrow(dim, 0, shard.num_nodes)
