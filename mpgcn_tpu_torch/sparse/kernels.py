"""The ELL SpMM over stacked containers and the sparse BDGCN arm
(counterpart of the blocked-ELL half of mpgcn_tpu/sparse/kernels.py).

``ell_spmm`` applies a ``BlockedELL`` stack to X in ONE launch with the
stack in the grid (what ``jax.vmap`` over the ``pallas_call`` gives), X
shared by the whole stack or one X per leading index (the per-sample
operators of the dynamic branch). ``bdgcn_sparse`` is the folded BDGCN
algebra with both node contractions as ELL SpMMs: 1 + K launches per layer
(the K origin contractions in one, then one per origin group over the K
destination supports), each differentiable through sparse/cuda_ell.py.
The (K, C, H) projections stay ``torch.einsum``, as they stay XLA in the
JAX package. The fused epilogue (one destination SpMM for all origins) is
not ported.

Under ``-dtype bfloat16`` X arrives in bf16 (and the tiles too: the model
casts its graphs). ``ell_spmm`` widens X exactly to f32 at the SpMM's
boundary and rounds the output to bf16, which is the Pallas kernel's
``promote(blocks, X)`` arithmetic (bf16 products summed in f32, stored in
X's dtype) on the same ELL kernels; autograd carries the casts' gradients.
"""

from __future__ import annotations

import math

import torch

from mpgcn_tpu_torch.quant.int8 import is_quantized
from mpgcn_tpu_torch.sparse.cuda_ell import (
    EllSpmmFn,
    EllSpmmQFn,
    ell_fwd,
)
from mpgcn_tpu_torch.sparse.formats import BlockedELL


def _recording(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def flat_stack(ell: BlockedELL):
    """A container's leading dims flattened to one stack of S operators, as
    the kernel entries take it: (cols (S, NB, MB), tiles (S, NB, MB, 8,
    BC), scale (S, NB, 1, 1, 1) or None, t_ptr (S, NBc + 1), t_slot (S,
    NB * MB)); int8 codes as the tiles of an int8 payload."""
    S = math.prod(ell.block_cols.shape[:-2])
    NB, MB = ell.block_cols.shape[-2:]
    blocks, scale = ell.blocks, None
    if is_quantized(blocks):
        blocks, scale = blocks.q, blocks.scale.reshape(S, NB, 1, 1, 1)
    return (ell.block_cols.reshape(S, NB, MB),
            blocks.reshape(S, NB, MB, *blocks.shape[-2:]), scale,
            ell.t_ptr.reshape(S, -1), ell.t_slot.reshape(S, -1))


def ell_spmm(ell: BlockedELL, X: torch.Tensor) -> torch.Tensor:
    """Apply a container stack with leading dims L to X.

    X is (n_cols, F), shared by the whole stack, or (L[:p]..., n_cols, F),
    one X per index of the first p leading dims, shared by the rest.
    Returns (L..., n_rows, F)."""
    if not isinstance(ell, BlockedELL):
        raise TypeError(
            f"the ell bdgcn impl needs a BlockedELL support container, got "
            f"{type(ell).__name__}: build one with "
            f"sparse.formats.sparsify_support_stack (the data pipeline does "
            f"this for its banks)")
    lead = tuple(ell.block_cols.shape[:-2])
    p = X.ndim - 2
    if (not 0 <= p <= len(lead) or tuple(X.shape[:p]) != lead[:p]
            or X.shape[-2] != ell.n_cols):
        raise ValueError(f"X {tuple(X.shape)} does not fit a stack of "
                         f"{lead} operators of {ell.n_cols} columns")
    S, G = math.prod(lead), math.prod(lead[:p])
    F = X.shape[-1]
    cols, tiles, scale, t_ptr, t_slot = flat_stack(ell)
    X3 = X.reshape(G, ell.n_cols, F)
    if X.dtype == torch.bfloat16:  # widened exactly; the output rounded
        return ell_spmm(ell, X.float()).to(torch.bfloat16)
    if scale is not None:
        if _recording(X, scale):
            out = EllSpmmQFn.apply(cols, tiles, scale, t_ptr, t_slot, X3,
                                   ell.n_rows, S // G)
        else:
            out = ell_fwd(cols, tiles, t_ptr, t_slot, X3, ell.n_rows,
                          S // G, scale)
    elif _recording(X, tiles):
        out = EllSpmmFn.apply(cols, tiles, t_ptr, t_slot, X3, ell.n_rows,
                              S // G)
    else:
        out = ell_fwd(cols, tiles, t_ptr, t_slot, X3, ell.n_rows, S // G)
    return out.reshape(*lead, ell.n_rows, F)


def _origin_sparse(X, G):
    """All K origin contractions h1[o] = G_o^T X: X (B, N, N, C) ->
    (K, B, M, N, C), and the destination container(s)."""
    B, N, _, C = X.shape
    if isinstance(G, tuple):                     # per-sample operators
        Go, Gd = G
        h1 = ell_spmm(Go, X.reshape(B, N, N * C))        # (B, K, M, N*C)
        return h1.reshape(B, -1, N, N, C).transpose(0, 1), Gd
    Xf = X.transpose(0, 1).reshape(N, B * N * C)
    h1 = ell_spmm(G, Xf)                                  # (K, M, B*N*C)
    return h1.reshape(-1, N, B, N, C).transpose(1, 2), G


def _dest_group_static(h1o, G_dest, w_o):
    """One origin's K destination partials, folded into the projection."""
    B, M, N, C = h1o.shape
    hf = h1o.permute(2, 0, 1, 3).reshape(N, B * M * C)
    t = ell_spmm(G_dest, hf).reshape(-1, N, B, M, C)     # (K, E, B, M, C)
    return torch.einsum("debml,dlh->bmeh", t, w_o)


def _dest_group_dynamic(h1o, G_dest, w_o):
    """Per-sample-support variant of one origin's folded partials."""
    B, M, N, C = h1o.shape
    hf = h1o.transpose(1, 2).reshape(B, N, M * C)
    t = ell_spmm(G_dest, hf).reshape(B, -1, N, M, C)     # (B, K, E, M, C)
    return torch.einsum("bdeml,dlh->bmeh", t, w_o)


def bdgcn_sparse(W: torch.Tensor, X: torch.Tensor, G) -> torch.Tensor:
    """Sparse folded BDGCN: out = sum_{o,d} (G_o^T X G_d) @ W[o, d] with
    both contractions as ELL SpMMs.

    X (B, N, N, C); G the container of the transposed (K, N, N) static
    stack, or a pair of containers of the transposed per-sample (B, K, N,
    N) stacks; W the reference-layout (K^2 C, H) weight, so checkpoints
    interchange with the dense arms. Returns (B, N, N, H)."""
    C = X.shape[-1]
    h1, G_dest = _origin_sparse(X, G)
    K = h1.shape[0]
    Wr = W.reshape(K, K, C, -1)
    dynamic = G_dest.block_cols.ndim - 2 == 2
    group = _dest_group_dynamic if dynamic else _dest_group_static
    out = None
    for o in range(K):
        part = group(h1[o], G_dest, Wr[o])
        out = part if out is None else out + part
    return out
