"""Classic K-support graph convolution (counterpart of
mpgcn_tpu/nn/gcn.py; reference GCN.py:6-45, which MPGCN's forward never
uses). ``init_gcn`` and ``gcn_apply`` keep the JAX package's functions and
parameter names (``W`` (K C, H), ``b`` (H,)); ``GCN`` holds them as a
module. Features flatten support-major and channel-minor, the
reference's concat order (GCN.py:32-36). Not wired into MPGCN.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from mpgcn_tpu_torch.nn.init import xavier_normal


def init_gcn(K: int, input_dim: int, hidden_dim: int, use_bias: bool = True,
             generator: Optional[torch.Generator] = None) -> dict:
    """Xavier-normal ``W`` (K * input_dim, hidden_dim) and a zero ``b``."""
    params = {"W": xavier_normal((K * input_dim, hidden_dim), generator)}
    if use_bias:
        params["b"] = torch.zeros((hidden_dim,))
    return params


def gcn_apply(params: dict, G: torch.Tensor, x: torch.Tensor,
              activation: Optional[Callable] = None) -> torch.Tensor:
    """G (K, N, N) supports, x (B, N, C) -> (B, N, H)."""
    B, N, C = x.shape
    K = G.shape[0]
    support = torch.einsum("kij,bjp->bkip", G, x)          # (B, K, N, C)
    support = support.permute(0, 2, 1, 3).reshape(B, N, K * C)
    out = support @ params["W"]
    if "b" in params:
        out = out + params["b"]
    if activation is not None:
        out = activation(out)
    return out


class GCN(nn.Module):
    """``gcn_apply`` over its own ``W`` and ``b``."""

    def __init__(self, K: int, input_dim: int, hidden_dim: int,
                 use_bias: bool = True, activation: Optional[Callable] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        params = init_gcn(K, input_dim, hidden_dim, use_bias, generator)
        self.W = nn.Parameter(params["W"])
        self.b = nn.Parameter(params["b"]) if use_bias else None
        self.activation = activation

    def forward(self, G: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        params = {"W": self.W}
        if self.b is not None:
            params["b"] = self.b
        return gcn_apply(params, G, x, self.activation)
