"""The fused epilogues (counterpart of mpgcn_tpu/nn/fused.py): the
``fused_epilogue`` knob's operand-stacked LSTM gate scan and the
all-origin BDGCN projection as stacked contractions. They change the
floating-point summation order, not the math.

  * ``stacked_lstm_last_step``: the M branches' LSTMs as one scan whose
    step computes every branch's four gates in one stacked matmul
    (``einsum("mbh,mhg->mbg")``), in place of M scans. It runs under
    ``-lstm plain`` only (the JAX ``lstm_impl == "scan"`` condition); the
    hand-written LSTM kernels ignore the knob.
  * ``fused_origin_project_static`` / ``_dynamic``: the folded arm's K
    origin groups of two einsums as two stacked einsums over all K
    origins (the full (K, B, N, N, K, C) pair family in flight: fewer,
    larger contractions for more transient memory).
  * ``deq``: an int8 ``QuantizedTensor`` weight dequantised at its use
    site (``lazy_quant`` in nn/mpgcn.py), so at most one layer's dense
    weight exists at a time.

All of it is plain PyTorch, as it is XLA (not Pallas) in the JAX package.
"""

from __future__ import annotations

import torch

from mpgcn_tpu_torch.quant.int8 import is_quantized


def deq(leaf, dtype=None):
    """A possibly quantized weight as a dense tensor: int8 codes
    dequantised (then cast to ``dtype`` when given); dense leaves as they
    are."""
    if is_quantized(leaf):
        w = leaf.dequantize()
        return w if dtype is None else w.to(dtype)
    return leaf


# --- the stacked LSTM gate scan ---------------------------------------------


def _stacked_layer_scan(layer: dict, seq: torch.Tensor, collect: bool):
    """One layer of the branch-stacked LSTM over time.

    layer: (M, ...)-stacked torch-layout weights w_ih (M, 4H, F), w_hh
    (M, 4H, H), b_ih, b_hh (M, 4H). seq: (R, T, F) shared (layer 0) or
    (M, R, T, F) per branch. Returns (outputs (M, R, T, H) or None,
    h_T (M, R, H))."""
    w_ih, w_hh = layer["w_ih"], layer["w_hh"]
    bias = (layer["b_ih"] + layer["b_hh"])[:, None, None, :]
    # the input projection hoisted out of the scan: one stacked matmul
    if seq.ndim == 3:
        x_proj = torch.einsum("btf,mgf->mbtg", seq, w_ih) + bias
    else:
        x_proj = torch.einsum("mbtf,mgf->mbtg", seq, w_ih) + bias
    w_hh_t = w_hh.transpose(1, 2)                      # (M, H, 4H)
    M, R, T = x_proj.shape[:3]
    H = w_hh.shape[-1]
    h = x_proj.new_zeros((M, R, H))
    c = x_proj.new_zeros((M, R, H))
    hs = []
    for t in range(T):
        # one stacked matmul a step for every branch's four gates
        gates = x_proj[:, :, t] + torch.einsum("mbh,mhg->mbg", h, w_hh_t)
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        if collect:
            hs.append(h)
    return (torch.stack(hs, dim=2) if collect else None), h


def stacked_lstm_last_step(branch_layers, x: torch.Tensor) -> torch.Tensor:
    """The branch-stacked ``lstm_last_step``: ``branch_layers[m][i]`` is
    branch m's layer i (``w_ih``, ``w_hh``, ``b_ih``, ``b_hh``; int8
    codes welcome, dequantised per layer), x (R, T, F) the shared
    flattened OD-pair input. Returns h_T of the last layer, (M, R, H)."""
    seq, h = x, None
    n = len(branch_layers[0])
    for i in range(n):
        layer = {k: torch.stack([deq(getattr(b[i], k), x.dtype)
                                 for b in branch_layers])
                 for k in ("w_ih", "w_hh", "b_ih", "b_hh")}
        seq, h = _stacked_layer_scan(layer, seq, collect=i < n - 1)
    return h


# --- the fused BDGCN projection epilogue -------------------------------------


def fused_origin_project_static(h1, G_dest, Wr):
    """All K origins' destination partials and the projection as two
    stacked einsums: h1 (K, B, N, N, C) from the origin contraction,
    G_dest (K, N, N), Wr the (K, K, C, H) reference weight. Returns (B, N,
    N, H)."""
    t = torch.einsum("obmcl,dce->obmdel", h1, G_dest)
    return torch.einsum("obmdel,odlh->bmeh", t, Wr)


def fused_origin_project_dynamic(h1, G_dest, Wr):
    """Per-sample-support variant: G_dest (B, K, N, N)."""
    t = torch.einsum("obmcl,bdce->obmdel", h1, G_dest)
    return torch.einsum("obmdel,odlh->bmeh", t, Wr)
