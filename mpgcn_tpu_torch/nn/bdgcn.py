"""BDGCN: 2-D bilinear graph convolution over origin and destination
graphs (counterpart of mpgcn_tpu/nn/bdgcn.py).

For K supports it forms all K x K (origin, destination) contraction pairs
of the OD feature grid X (B, N, N, C), feat[o, d] = G_o^T X G_d, and
projects their channel concat with W (K^2 C, H). Five arms share the
weights:

  * "einsum": reference-shaped and plain -- the (K, K, B, N, N, C) bank
    and its (B, N, N, K^2 C) concat are built, then one projection GEMM;
    with ``fused`` the projection reads the bank directly
    (``einsum("odbmel,odlh->bmeh")``), without the concat copy.
  * "folded": plain, the JAX ``_bdgcn_folded``: concat_{o,d}(G_o^T X
    G_d) W == sum_{o,d} (G_o^T X G_d) W[o, d], accumulated per origin (K
    groups of two einsums, each under ``torch.utils.checkpoint``, so no
    K^2 bank lives in either direction); with ``fused`` the two stacked
    einsums of nn/fused.py under one checkpoint.
  * "kernel": the K origin contractions h1 = G_o^T X stay one
    ``torch.einsum``; then K-BDGCN (nn/cuda_bdgcn.py) folds the
    destination contractions into the projection,
    sum_{o, d} (G_o^T X G_d) W[o, d] with W reshaped (K, K, C, H), so the
    bank never reaches device memory.
    It ignores ``fused``: it is fused already, as the Pallas arm is in
    the JAX package.
  * "csr" / "ell": the same folded algebra over padded-CSR or blocked-ELL
    support containers, both node contractions as SpMMs (sparse/kernels.py
    ``bdgcn_sparse``, ``fused``: one destination SpMM a layer); G is then
    a container, or a pair of containers. "csr" is plain PyTorch, as the
    JAX ``csr_spmm`` is not a Pallas kernel; "ell" runs the ELL kernels.

``layer.W`` may be an int8 ``QuantizedTensor`` on every arm but
"kernel" (nn/mpgcn.py ``lazy_quant``): it is dequantised here, at its use.

On a node ``shard`` (mpgcn_tpu_torch/node_shard.py ``NodeShard``, the
model axis of parallel/): X holds this rank's n_loc origin rows,
(B, n_loc, N, C). The layer all-gathers X over the model group
(``gather_origins``: reduce-scatter backward), then runs the origin
contraction for this rank's output rows m only, on the support columns
G[..., m_loc] (zero past N: a padded row's h1 is zero), and hands the
local h1 to the arm's destination half unchanged: on "kernel" the
K-BDGCN kernel on (K, B, n_loc, N, C). The gather moves B N N C floats a
layer where reduce-scattering h1 would move K times as many. The "csr"
arm takes the padded-CSR rows m_loc of the origin operator; "ell" is
not sharded (the trainer routes it to "csr" at mp > 1, as the JAX
trainer does).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from mpgcn_tpu_torch.config import BDGCN_IMPLS
from mpgcn_tpu_torch.nn.cuda_bdgcn import folded_pair_project
from mpgcn_tpu_torch.nn.fused import (
    deq,
    fused_origin_project_dynamic,
    fused_origin_project_static,
)
from mpgcn_tpu_torch.nn.init import xavier_normal
from mpgcn_tpu_torch.node_shard import NodeShard, gather_origins
from mpgcn_tpu_torch.sparse.formats import PaddedCSR
from mpgcn_tpu_torch.sparse.kernels import bdgcn_sparse, checkpointed


class BDGCN(nn.Module):
    """W (input_dim * K^2, hidden) xavier-normal, b zeros
    (reference: MPGCN.py:16-21)."""

    def __init__(self, K: int, input_dim: int, hidden_dim: int,
                 use_bias: bool, generator: torch.Generator):
        super().__init__()
        self.W = nn.Parameter(xavier_normal((input_dim * K * K, hidden_dim),
                                            generator))
        self.b = (nn.Parameter(torch.zeros(hidden_dim)) if use_bias
                  else None)


def origin_contract(X: torch.Tensor, G, shard=None):
    """All K origin contractions as one einsum: h1[o] = G_o^T X.

    Returns (h1 (K, B, M, N, C), G_dest, K): G_dest is (K, N, N) for a
    static graph or (B, K, N, N) for per-sample dynamic graphs; M = N, or
    on a node ``shard`` its n_loc output rows (X then the gathered (B, N,
    N, C) input)."""
    if isinstance(G, tuple):
        G_o, G_d = G
        G_o = G_o if shard is None else shard.take(G_o, -1)
        return torch.einsum("bncl,bonm->obmcl", X, G_o), G_d, G_o.shape[-3]
    G_o = G if shard is None else shard.take(G, -1)
    return torch.einsum("bncl,onm->obmcl", X, G_o), G, G.shape[-3]


def origin_rows(G, shard):
    """The origin operator of a sparse container (or a dynamic pair of
    them) cut to a node ``shard``'s output rows: padded-CSR rows m_loc,
    pad rows id 0 and value 0 (exact zero rows); the destination
    container stays whole. Returns (origin, destination)."""
    Go, Gd = G if isinstance(G, tuple) else (G, G)
    return PaddedCSR(shard.take(Go.indices, -2), shard.take(Go.values, -2),
                     Go.n_cols), Gd


def _origin_group_static(h1o, G_dest, w_o):
    """All K destination partials of one origin, folded into the
    projection: sum_d (h1o G_d) W[o, d] as two einsums."""
    t = torch.einsum("bmcl,dce->bmdel", h1o, G_dest)     # (B, M, K, E, C)
    return torch.einsum("bmdel,dlh->bmeh", t, w_o)


def _origin_group_dynamic(h1o, G_dest, w_o):
    """Per-sample-support variant of one origin's folded partials."""
    t = torch.einsum("bmcl,bdce->bmdel", h1o, G_dest)
    return torch.einsum("bmdel,dlh->bmeh", t, w_o)


def bdgcn_folded(W, h1, G_dest, K: int, C: int, fused: bool = False):
    """The folded arm (JAX ``_bdgcn_folded``): the per-(o, d) partial
    products accumulated per origin, each group checkpointed; ``fused``:
    all K origins in two stacked einsums under one checkpoint."""
    Wr = W.reshape(K, K, C, -1)
    dynamic = G_dest.ndim == 4
    if fused:
        return checkpointed(fused_origin_project_dynamic if dynamic
                            else fused_origin_project_static,
                            h1, G_dest, Wr)
    group = _origin_group_dynamic if dynamic else _origin_group_static
    out = None
    for o in range(K):
        part = checkpointed(group, h1[o], G_dest, Wr[o])
        out = part if out is None else out + part
    return out


def bdgcn_apply(layer, X: torch.Tensor, G, activation=None,
                impl: str = "kernel", fused: bool = False,
                shard: Optional[NodeShard] = None) -> torch.Tensor:
    """X (B, N, N, C); G a static (K, N, N) stack or a dynamic pair of
    (B, K, N, N) origin/destination stacks (their sparse containers for
    "csr" and "ell"). ``fused``: the fused epilogue of the arm (module
    docstring; "kernel" ignores it). Returns (B, N, N, H). On a node
    ``shard``, X and the output hold this rank's origin rows,
    (B, n_loc, N, C) -> (B, n_loc, N, H) (module docstring)."""
    B, M, N, C = X.shape
    if shard is not None:
        if M != shard.n_loc:
            raise ValueError(f"X has {M} origin rows, not the shard's "
                             f"{shard.n_loc}")
        X = gather_origins(X, shard, dim=1)
    W = deq(layer.W, X.dtype)
    if impl == "einsum":
        h1, G_d, K = origin_contract(X, G, shard)
        if G_d.ndim == 4:
            h2 = torch.einsum("obmcl,bdce->odbmel", h1, G_d)
        else:
            h2 = torch.einsum("obmcl,dce->odbmel", h1, G_d)
        if fused:
            # the projection straight out of the bank: the (o, d,
            # channel)-major weight replaces the transposed concat copy
            out = torch.einsum("odbmel,odlh->bmeh", h2,
                               W.reshape(K, K, C, -1))
        else:
            # (o, d, channel) flattening matches the reference concat order
            feats = h2.permute(2, 3, 4, 0, 1, 5).reshape(B, M, N,
                                                         K * K * C)
            out = feats @ W
    elif impl == "folded":
        h1, G_dest, K = origin_contract(X, G, shard)
        out = bdgcn_folded(W, h1, G_dest, K, C, fused)
    elif impl == "kernel":
        h1, G_dest, K = origin_contract(X, G, shard)
        Wr = W.reshape(K, K, C, -1)
        Gk = G_dest if G_dest.ndim == 4 else G_dest[None]
        out = folded_pair_project(h1, Gk, Wr)
    elif impl in ("csr", "ell"):
        out = bdgcn_sparse(W, X, G, fused,
                           None if shard is None else origin_rows(G, shard))
    else:
        raise ValueError(f"unknown bdgcn impl {impl!r}: expected one of "
                         f"{BDGCN_IMPLS}")
    if layer.b is not None:
        out = out + layer.b
    if activation is not None:
        out = activation(out)
    return out
