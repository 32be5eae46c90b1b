"""MPGCN: the M-branch multi-perspective model (counterpart of the loop
path of mpgcn_tpu/nn/mpgcn.py).

Each branch is an LSTM temporal encoder over the B*N^2 OD-pair sequences,
gcn_num_layers BDGCN layers with ReLU, and an FC+ReLU head; the branch
outputs are averaged. ``lstm_impl``/``bdgcn_impl`` pick the hand-written
kernels ("kernel") or the plain arms ("plain"/"einsum"), which compute the
same function with stock PyTorch operations and which autograd
differentiates like any torch code. ``forward(..., inference=True)`` runs
under ``torch.no_grad()`` on the inference kernels (the serve and test
rollouts); ``inference=False`` records autograd through the training
kernels (``LSTMLayerFn`` and ``PairProjectFn``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mpgcn_tpu_torch.config import DEFAULT_LINEUPS, MPGCNConfig
from mpgcn_tpu_torch.device import resolve_device
from mpgcn_tpu_torch.nn.bdgcn import BDGCN, BDGCN_IMPLS, bdgcn_apply
from mpgcn_tpu_torch.nn.cuda_lstm import (
    lstm_last_step_fused,
    lstm_layer_infer,
    lstm_layer_infer_plain,
    lstm_layer_recorded,
)
from mpgcn_tpu_torch.nn.init import linear_uniform
from mpgcn_tpu_torch.nn.lstm import LSTM

#: lstm_impl -> the function that runs one LSTM layer, by inference flag
LSTM_LAYER_FNS = {
    "kernel": {True: lstm_layer_infer, False: lstm_layer_recorded},
    "plain": {True: lstm_layer_infer_plain, False: lstm_layer_infer_plain},
}


class Branch(nn.Module):
    def __init__(self, K: int, input_dim: int, hidden_dim: int,
                 lstm_num_layers: int, gcn_num_layers: int, use_bias: bool,
                 generator: torch.Generator):
        super().__init__()
        self.temporal = LSTM(input_dim, hidden_dim, lstm_num_layers,
                             generator)
        self.spatial = nn.ModuleList(
            BDGCN(K, hidden_dim, hidden_dim, use_bias, generator)
            for _ in range(gcn_num_layers))
        self.fc = nn.Linear(hidden_dim, input_dim)
        with torch.no_grad():
            self.fc.weight.copy_(linear_uniform((input_dim, hidden_dim),
                                                hidden_dim, generator))
            self.fc.bias.copy_(linear_uniform((input_dim,), hidden_dim,
                                              generator))


class MPGCN(nn.Module):
    """Parameters live on ``device`` (default the card). ``sources`` names
    each branch's graph perspective; the graphs passed to ``forward`` are
    in that order (train/predict.py ``graphs_for`` builds them)."""

    def __init__(self, M: int, K: int, input_dim: int, hidden_dim: int,
                 lstm_num_layers: int, gcn_num_layers: int,
                 use_bias: bool = True, sources=None,
                 lstm_impl: str = "kernel", bdgcn_impl: str = "kernel",
                 seed: int = 0, device="cuda"):
        super().__init__()
        if lstm_impl not in LSTM_LAYER_FNS:
            raise ValueError(f"lstm_impl={lstm_impl!r} is not one of "
                             f"{tuple(LSTM_LAYER_FNS)}")
        if bdgcn_impl not in BDGCN_IMPLS:
            raise ValueError(f"bdgcn_impl={bdgcn_impl!r} is not one of "
                             f"{BDGCN_IMPLS}")
        self.sources = tuple(sources) if sources else DEFAULT_LINEUPS[M]
        if len(self.sources) != M:
            raise ValueError(f"{len(self.sources)} branch sources for "
                             f"M={M} branches")
        self.lstm_impl, self.bdgcn_impl = lstm_impl, bdgcn_impl
        self._lstm_layer_fns = LSTM_LAYER_FNS[lstm_impl]
        device = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        self.branches = nn.ModuleList(
            Branch(K, input_dim, hidden_dim, lstm_num_layers,
                   gcn_num_layers, use_bias, gen)
            for _ in range(M))
        self.to(device)

    @classmethod
    def from_config(cls, cfg: MPGCNConfig, device="cuda",
                    **kw) -> "MPGCN":
        return cls(M=cfg.num_branches, K=cfg.support_K,
                   input_dim=cfg.input_dim, hidden_dim=cfg.hidden_dim,
                   lstm_num_layers=cfg.lstm_num_layers,
                   gcn_num_layers=cfg.gcn_num_layers, use_bias=cfg.use_bias,
                   sources=cfg.resolved_branch_sources, seed=cfg.seed,
                   device=device, **kw)

    def _branch(self, branch: Branch, lstm_in, G, B: int, N: int,
                inference: bool):
        """One branch: (B*N^2, T, F) rows -> pre-head (B, N, N, H) and
        the FC+ReLU output (B, N, N, F)."""
        h = lstm_last_step_fused(branch.temporal.layers, lstm_in,
                                 layer_fn=self._lstm_layer_fns[inference])
        h = h.reshape(B, N, N, -1)
        for layer in branch.spatial:
            h = bdgcn_apply(layer, h, G, activation=F.relu,
                            impl=self.bdgcn_impl)
        return h, F.relu(branch.fc(h))

    def forward(self, x_seq: torch.Tensor, graphs, return_hidden=False,
                inference: bool = True):
        """x_seq (B, T, N, N, F); graphs[m] is branch m's static (K, N, N)
        stack or dynamic ((B, K, N, N), (B, K, N, N)) pair. Returns the
        (B, 1, N, N, F) one-step prediction, and with ``return_hidden``
        also each branch's pre-head BDGCN output. ``inference`` runs under
        ``torch.no_grad()`` on the inference kernels; ``inference=False``
        is the differentiable training forward."""
        if inference:
            with torch.no_grad():
                return self._forward(x_seq, graphs, return_hidden, True)
        return self._forward(x_seq, graphs, return_hidden, False)

    def _forward(self, x_seq, graphs, return_hidden, inference):
        if x_seq.ndim != 5 or x_seq.shape[2] != x_seq.shape[3]:
            raise ValueError(f"x_seq must be (B, T, N, N, F), got "
                             f"{tuple(x_seq.shape)}")
        if len(graphs) != len(self.branches):
            raise ValueError(f"{len(graphs)} graph inputs for "
                             f"{len(self.branches)} branches")
        B, T, N, _, i = x_seq.shape
        # each OD pair is an independent temporal sequence (MPGCN.py:100)
        lstm_in = x_seq.permute(0, 2, 3, 1, 4).reshape(B * N * N, T, i)
        hidden, outs = [], []
        for branch, G in zip(self.branches, graphs):
            h, out = self._branch(branch, lstm_in, G, B, N, inference)
            hidden.append(h)
            outs.append(out)
        pred = torch.stack(outs, dim=-1).mean(dim=-1)[:, None]
        return (pred, hidden) if return_hidden else pred
