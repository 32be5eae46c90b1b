"""MPGCN: the M-branch multi-perspective model (counterpart of the loop
path of mpgcn_tpu/nn/mpgcn.py).

Each branch is an LSTM temporal encoder over the B*N^2 OD-pair sequences,
gcn_num_layers BDGCN layers with ReLU, and an FC+ReLU head; the branch
outputs are averaged. ``lstm_impl``/``bdgcn_impl`` pick the hand-written
kernels ("kernel") or the plain arms ("plain"/"einsum"), which compute the
same function with stock PyTorch operations and which autograd
differentiates like any torch code; ``bdgcn_impl="ell"`` runs the BDGCN
layers over blocked-ELL support containers through the ELL SpMM kernels,
``"csr"`` over padded-CSR containers and ``"folded"`` the bank-free plain
arm (nn/bdgcn.py). ``forward(..., inference=True)`` runs
under ``torch.no_grad()`` on the inference kernels (the serve and test
rollouts); ``inference=False`` records autograd through the training
kernels (``LSTMLayerFn`` and ``PairProjectFn``).

Precision (mpgcn_tpu/nn/mpgcn.py:231, 246-266): ``compute_dtype``
(bfloat16, or None for f32) casts the weights, ``x_seq`` and the graphs
(dense stacks, or the tiles of blocked-ELL containers) inside the forward,
so gradients flow back through the casts into the f32 master weights; the
branch outputs are cast back to x_seq's dtype before their mean. The
forward of a weight tree ``params`` in place of the module's own (the
``quant/int8.py`` tree of ``-infer-precision int8``) dequantizes it first
thing, so a captured rollout keeps only the int8 codes resident. With
``remat`` each branch of a training forward runs under
``torch.utils.checkpoint`` (where the JAX package puts ``jax.checkpoint``,
:149-150, 350-351, 432-433): its kernels run again inside the backward
instead of keeping their residuals.

``fused_epilogue`` (mpgcn_tpu/nn/mpgcn.py:238-253, 405-428): every BDGCN
layer takes its arm's fused epilogue (nn/bdgcn.py), and under ``-lstm
plain`` the M branches' LSTMs run as one stacked scan (nn/fused.py),
then each branch's spatial half; under ``remat`` that whole forward is
one checkpoint. ``lazy_quant``: with an int8 weight tree, the fused
epilogue, ``-lstm plain`` and a BDGCN arm other than "kernel" (whose
kernels take dense operands), the tree is not dequantised up front:
each weight is dequantised where it is used.

The model axis (parallel/, ``-mp`` above 1): with a node ``shard`` (the
model's attribute, mpgcn_tpu_torch/node_shard.py ``NodeShard``, which
``ParallelModelTrainer`` sets once), x_seq holds this rank's origin
rows, (B, T, n_loc, N, F). The LSTM rows (B n_loc N sequences), the FC
head and the branch mean are local and run no collective; each BDGCN
layer gathers its input over the model group (nn/bdgcn.py). The output holds this rank's origin rows, (B, 1, n_loc,
N, F).
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace
from typing import Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
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
from mpgcn_tpu_torch.nn.fused import stacked_lstm_last_step
from mpgcn_tpu_torch.nn.init import linear_uniform
from mpgcn_tpu_torch.nn.lstm import LSTM
from mpgcn_tpu_torch.node_shard import NodeShard
from mpgcn_tpu_torch.quant.int8 import (
    dequantize_params,
    has_quantized,
    is_quantized,
)
from mpgcn_tpu_torch.sparse.formats import BlockedELL, PaddedCSR

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
                 seed: int = 0, device="cuda", compute_dtype=None,
                 remat: bool = False, fused_epilogue: bool = False):
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
        #: the training and evaluation forwards' compute dtype (None: the
        #: weights' own, f32) and whether their branches are checkpointed
        self.compute_dtype, self.remat = compute_dtype, remat
        self.fused_epilogue = fused_epilogue
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
                   device=device,
                   compute_dtype=compute_dtype_of(cfg.dtype),
                   remat=cfg.remat, fused_epilogue=cfg.fused_epilogue,
                   **kw)

    @property
    def _stacked_lstm(self) -> bool:
        """Do the branches' LSTMs run as one stacked scan? Under the fused
        epilogue with the plain LSTM arm (the JAX ``lstm_impl ==
        "scan"``)."""
        return self.fused_epilogue and self.lstm_impl == "plain"

    def _lazy_quant(self, params) -> bool:
        """Dequantise an int8 tree's weights at their use sites (JAX:
        ``lazy_quant``) instead of up front?"""
        return (has_quantized(params) and self._stacked_lstm
                and self.bdgcn_impl != "kernel")

    def _spatial(self, branch, h, G, B: int, M: int, N: int):
        """A branch's BDGCN layers and head: LSTM output rows -> pre-head
        (B, M, N, H) and the FC+ReLU output (B, M, N, F), M the origin
        rows (N, or the node ``shard``'s n_loc)."""
        h = h.reshape(B, M, N, -1)
        for layer in branch.spatial:
            h = bdgcn_apply(layer, h, G, activation=F.relu,
                            impl=self.bdgcn_impl, fused=self.fused_epilogue,
                            shard=self.shard)
        return h, F.relu(F.linear(h, branch.fc.weight, branch.fc.bias))

    def _branch(self, branch, lstm_in, G, B: int, M: int, N: int,
                inference: bool):
        """One branch (its ``Branch`` module, or a view of the same names
        on other weights): (B*M*N, T, F) rows -> pre-head (B, M, N, H) and
        the FC+ReLU output (B, M, N, F)."""
        h = lstm_last_step_fused(branch.temporal.layers, lstm_in,
                                 layer_fn=self._lstm_layer_fns[inference])
        return self._spatial(branch, h, G, B, M, N)

    def _stacked(self, branches, lstm_in, graphs, B: int, M: int, N: int):
        """Every branch with the stacked LSTM scan (JAX ``fwd_fused``): the
        M LSTMs as one scan, then each branch's spatial half. Returns the
        pre-head outputs and the head outputs, per branch."""
        h_all = stacked_lstm_last_step(
            [b.temporal.layers for b in branches], lstm_in)
        pairs = [self._spatial(b, h_all[m], G, B, M, N)
                 for m, (b, G) in enumerate(zip(branches, graphs))]
        return [p[0] for p in pairs], [p[1] for p in pairs]

    def _views(self, params, dtype, lazy: bool = False) -> list:
        """The branches the forward runs: the modules themselves, or views
        of ``params`` (a ``{name: tensor}`` tree, dequantized when it holds
        int8, unless ``lazy`` keeps its codes for the use sites) or of the
        module's weights, cast to ``dtype``."""
        if params is None and dtype is None:
            return list(self.branches)
        w = dict(self.named_parameters()) if params is None else params
        if has_quantized(w) and not lazy:
            w = dequantize_params(w)
        if dtype is not None:
            w = {k: v if is_quantized(v) else v.to(dtype)
                 for k, v in w.items()}
        views = []
        for m, branch in enumerate(self.branches):
            p = f"branches.{m}"
            layers = [SimpleNamespace(**{
                n: w[f"{p}.temporal.layers.{i}.{n}"]
                for n in ("w_ih", "w_hh", "b_ih", "b_hh")})
                for i in range(len(branch.temporal.layers))]
            spatial = [SimpleNamespace(W=w[f"{p}.spatial.{i}.W"],
                                       b=w.get(f"{p}.spatial.{i}.b"))
                       for i in range(len(branch.spatial))]
            views.append(SimpleNamespace(
                temporal=SimpleNamespace(layers=layers), spatial=spatial,
                fc=SimpleNamespace(weight=w[f"{p}.fc.weight"],
                                   bias=w[f"{p}.fc.bias"])))
        return views

    #: this rank's block of origin nodes on a model axis (None: every
    #: origin; ParallelModelTrainer sets it)
    shard: Optional[NodeShard] = None

    def forward(self, x_seq: torch.Tensor, graphs, return_hidden=False,
                inference: bool = True, dtype="model", params=None):
        """x_seq (B, T, N, N, F); graphs[m] is branch m's static (K, N, N)
        stack or dynamic ((B, K, N, N), (B, K, N, N)) pair. Returns the
        (B, 1, N, N, F) one-step prediction, and with ``return_hidden``
        also each branch's pre-head BDGCN output. ``inference`` runs under
        ``torch.no_grad()`` on the inference kernels; ``inference=False``
        is the differentiable training forward. ``dtype``: the compute
        dtype, by default the model's ``compute_dtype`` (None: f32);
        ``params``: a weight tree in place of the module's own (the
        rollouts at ``-infer-precision int8``). On a node ``shard``, x_seq
        and the output hold this rank's origin rows (module docstring)."""
        if dtype == "model":
            dtype = self.compute_dtype
        if inference:
            with torch.no_grad():
                return self._forward(x_seq, graphs, return_hidden, True,
                                     dtype, params)
        return self._forward(x_seq, graphs, return_hidden, False, dtype,
                             params)

    def _forward(self, x_seq, graphs, return_hidden, inference, dtype=None,
                 params=None):
        shard = self.shard
        if x_seq.ndim != 5 or x_seq.shape[2] != (
                x_seq.shape[3] if shard is None else shard.n_loc):
            rows = "N" if shard is None else shard.n_loc
            raise ValueError(f"x_seq must be (B, T, {rows}, N, F), got "
                             f"{tuple(x_seq.shape)}")
        if len(graphs) != len(self.branches):
            raise ValueError(f"{len(graphs)} graph inputs for "
                             f"{len(self.branches)} branches")
        out_dtype = x_seq.dtype
        if dtype is not None and dtype != x_seq.dtype:
            x_seq = x_seq.to(dtype)
            graphs = [cast_graph(G, dtype) for G in graphs]
        else:
            dtype = None
        branches = self._views(params, dtype, self._lazy_quant(params))
        B, T, M, N, i = x_seq.shape
        # each OD pair is an independent temporal sequence (MPGCN.py:100)
        lstm_in = x_seq.permute(0, 2, 3, 1, 4).reshape(B * M * N, T, i)
        remat = self.remat and not inference and torch.is_grad_enabled()

        def run(fn, *args):
            if not remat:
                return fn(*args)
            return torch.utils.checkpoint.checkpoint(
                fn, *args, use_reentrant=False, preserve_rng_state=False)

        if self._stacked_lstm:
            hidden, outs = run(self._stacked, branches, lstm_in,
                               list(graphs), B, M, N)
        else:
            hidden, outs = [], []
            for branch, G in zip(branches, graphs):
                h, out = run(self._branch, branch, lstm_in, G, B, M, N,
                             inference)
                hidden.append(h)
                outs.append(out)
        pred = torch.stack(outs, dim=-1).to(out_dtype).mean(dim=-1)[:, None]
        return (pred, hidden) if return_hidden else pred


def compute_dtype_of(name: str):
    """The compute dtype a config's ``dtype`` names: None for float32 (the
    weights' own), torch.bfloat16 for bfloat16."""
    return None if name == "float32" else getattr(torch, name)


def infer_dtype_of(cfg):
    """The rollouts' compute dtype (the JAX trainer's
    ``_infer_compute_dtype``): bf16 for 'bf16', None (f32) for 'f32'; int8
    quantizes the weights and computes in the training dtype."""
    ip = cfg.resolved_infer_precision
    if ip == "bf16":
        return torch.bfloat16
    return None if ip == "f32" else compute_dtype_of(cfg.dtype)


def cast_graph(G, dtype):
    """A branch's graph input in ``dtype``: a dense stack, a dynamic pair,
    or sparse containers, whose CSR values or f32 or bf16 tiles are cast
    (int8 codes stay codes, as the JAX package leaves quantized
    leaves)."""
    if isinstance(G, tuple):
        return tuple(cast_graph(g, dtype) for g in G)
    if isinstance(G, PaddedCSR):
        return dataclasses.replace(G, values=G.values.to(dtype))
    if isinstance(G, BlockedELL):
        if isinstance(G.blocks, torch.Tensor):
            return dataclasses.replace(G, blocks=G.blocks.to(dtype))
        return G
    return G.to(dtype)
