"""BDGCN: 2-D bilinear graph convolution over origin and destination
graphs (counterpart of mpgcn_tpu/nn/bdgcn.py).

For K supports it forms all K x K (origin, destination) contraction pairs
of the OD feature grid X (B, N, N, C), feat[o, d] = G_o^T X G_d, and
projects their channel concat with W (K^2 C, H). Three arms share the
weights:

  * "einsum": reference-shaped and plain -- the (K, K, B, N, N, C) bank
    and its (B, N, N, K^2 C) concat are built, then one projection GEMM.
  * "kernel": the K origin contractions h1 = G_o^T X stay one
    ``torch.einsum``; then K-BDGCN (nn/cuda_bdgcn.py) folds the
    destination contractions into the projection,
    sum_{o, d} (G_o^T X G_d) W[o, d] with W reshaped (K, K, C, H), so the
    bank never reaches device memory.
  * "ell": the same folded algebra over blocked-ELL support containers,
    both node contractions as ELL SpMMs (sparse/kernels.py
    ``bdgcn_sparse``); G is then a container, or a pair of containers.
"""

from __future__ import annotations

import torch
from torch import nn

from mpgcn_tpu_torch.config import BDGCN_IMPLS
from mpgcn_tpu_torch.nn.cuda_bdgcn import folded_pair_project
from mpgcn_tpu_torch.nn.init import xavier_normal
from mpgcn_tpu_torch.sparse.kernels import bdgcn_sparse


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


def origin_contract(X: torch.Tensor, G):
    """All K origin contractions as one einsum: h1[o] = G_o^T X.

    Returns (h1 (K, B, N, N, C), G_dest, K): G_dest is (K, N, N) for a
    static graph or (B, K, N, N) for per-sample dynamic graphs."""
    if isinstance(G, tuple):
        G_o, G_d = G
        return torch.einsum("bncl,bonm->obmcl", X, G_o), G_d, G_o.shape[-3]
    return torch.einsum("bncl,onm->obmcl", X, G), G, G.shape[-3]


def bdgcn_apply(layer, X: torch.Tensor, G, activation=None,
                impl: str = "kernel") -> torch.Tensor:
    """X (B, N, N, C); G a static (K, N, N) stack or a dynamic pair of
    (B, K, N, N) origin/destination stacks (their blocked-ELL containers
    for "ell"). Returns (B, N, N, H)."""
    B, N, _, C = X.shape
    if impl == "einsum":
        if isinstance(G, tuple):
            G_o, G_d = G
            K = G_o.shape[-3]
            h1 = torch.einsum("bncl,bonm->obmcl", X, G_o)
            h2 = torch.einsum("obmcl,bdce->odbmel", h1, G_d)
        else:
            K = G.shape[-3]
            h1 = torch.einsum("bncl,onm->obmcl", X, G)
            h2 = torch.einsum("obmcl,dce->odbmel", h1, G)
        # (o, d, channel) flattening matches the reference concat order
        feats = h2.permute(2, 3, 4, 0, 1, 5).reshape(B, N, N, K * K * C)
        out = feats @ layer.W
    elif impl == "kernel":
        h1, G_dest, K = origin_contract(X, G)
        Wr = layer.W.reshape(K, K, C, -1)
        Gk = G_dest if G_dest.ndim == 4 else G_dest[None]
        out = folded_pair_project(h1, Gk, Wr)
    elif impl == "ell":
        out = bdgcn_sparse(layer.W, X, G)
    else:
        raise ValueError(f"unknown bdgcn impl {impl!r}: expected one of "
                         f"{BDGCN_IMPLS}")
    if layer.b is not None:
        out = out + layer.b
    if activation is not None:
        out = activation(out)
    return out
