"""The SpMMs over stacked containers and the sparse BDGCN arms
(counterpart of mpgcn_tpu/sparse/kernels.py).

``csr_spmm`` applies a ``PaddedCSR`` stack as the JAX ``_csr_rows`` does:
a loop over the R pad slots, each gathering one slot's rows of X and
adding them times the slot's values, so the live set is two (N, F)
buffers a stack member, never the (N, R, F) bank. The JAX package
computes it outside any Pallas kernel, so it is plain PyTorch on both
devices (``index_select`` and a multiply-add; autograd gives dX).

``ell_spmm`` applies a ``BlockedELL`` stack to X in ONE launch with the
stack in the grid (what ``jax.vmap`` over the ``pallas_call`` gives), X
shared by the whole stack or one X per leading index (the per-sample
operators of the dynamic branch). ``bdgcn_sparse`` is the folded BDGCN
algebra with both node contractions as SpMMs over either container: 1 +
K SpMMs per layer (the K origin contractions in one, then one per origin
group over the K destination supports), or with ``fused`` (the
``fused_epilogue`` knob) 1 + 1: one destination SpMM over the K stacked
origins, F = K B N C wide, then one projection einsum, under one
``torch.utils.checkpoint`` whose residual is the h1 bank only (the JAX
``jax.checkpoint``), so its backward runs the destination SpMM again.
On the ELL arm each SpMM is differentiable through sparse/cuda_ell.py.
The (K, C, H) projections stay ``torch.einsum``, as they stay XLA in the
JAX package.

Under ``-dtype bfloat16`` X arrives in bf16 (and the tiles too: the model
casts its graphs). ``ell_spmm`` widens X exactly to f32 at the SpMM's
boundary and rounds the output to bf16, which is the Pallas kernel's
``promote(blocks, X)`` arithmetic (bf16 products summed in f32, stored in
X's dtype) on the same ELL kernels; autograd carries the casts' gradients.
"""

from __future__ import annotations

import math

import torch
import torch.utils.checkpoint

from mpgcn_tpu_torch.nn.fused import deq
from mpgcn_tpu_torch.quant.int8 import is_quantized
from mpgcn_tpu_torch.sparse.cuda_ell import (
    EllSpmmFn,
    EllSpmmQFn,
    ell_fwd,
)
from mpgcn_tpu_torch.sparse.formats import BlockedELL, PaddedCSR


def _recording(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def checkpointed(fn, *args):
    """``fn(*args)``, under a non-reentrant ``torch.utils.checkpoint`` when
    autograd records it (its backward runs ``fn`` again instead of keeping
    its intermediates: the JAX package's ``jax.checkpoint``)."""
    if _recording(*(a for a in args if torch.is_tensor(a))):
        return torch.utils.checkpoint.checkpoint(
            fn, *args, use_reentrant=False, preserve_rng_state=False)
    return fn(*args)


def _x_groups(lead: tuple, X: torch.Tensor, n_cols: int) -> int:
    """G, the product of X's leading dims, which must be the stack's
    first ones."""
    p = X.ndim - 2
    if (not 0 <= p <= len(lead) or tuple(X.shape[:p]) != lead[:p]
            or X.shape[-2] != n_cols):
        raise ValueError(f"X {tuple(X.shape)} does not fit a stack of "
                         f"{lead} operators of {n_cols} columns")
    return math.prod(lead[:p])


def csr_spmm(sp: PaddedCSR, X: torch.Tensor) -> torch.Tensor:
    """Apply a PaddedCSR stack with leading dims L to X, with
    ``ell_spmm``'s contract: X (n_cols, F) shared, or (L[:p]..., n_cols, F)
    one X per index of the first p leading dims. Returns (L..., N, F) in
    the promoted dtype of values and X."""
    lead = tuple(sp.indices.shape[:-2])
    N, R = sp.indices.shape[-2:]
    G = _x_groups(lead, X, sp.n_cols)
    S = math.prod(lead)
    F = X.shape[-1]
    X2 = X.reshape(G * sp.n_cols, F)
    idx = sp.indices.reshape(S, N, R).long()
    # stack member s reads X group s // (S / G): its rows start there
    base = (torch.arange(S, device=idx.device) // (S // G)
            * sp.n_cols)[:, None]
    vals = sp.values.reshape(S, N, R)
    acc = X.new_zeros((S, N, F),
                      dtype=torch.promote_types(vals.dtype, X.dtype))
    for r in range(R):
        rows = X2.index_select(0, (idx[:, :, r] + base).reshape(-1))
        acc = acc + vals[:, :, r, None] * rows.view(S, N, F)
    return acc.reshape(*lead, N, F)


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
    G = _x_groups(lead, X, ell.n_cols)
    S = math.prod(lead)
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


def _stack_lead(G) -> int:
    """Leading (stack) dims of a container: 1 for a static (K, N, N)
    stack, 2 for a per-sample (B, K, N, N) bank."""
    if isinstance(G, PaddedCSR):
        return G.indices.ndim - 2
    if isinstance(G, BlockedELL):
        return G.block_cols.ndim - 2
    raise TypeError(f"not a sparse container: {type(G).__name__}")


def _spmm_stack(G, X):
    """The SpMM of G's container type (``csr_spmm`` / ``ell_spmm``)."""
    if isinstance(G, PaddedCSR):
        return csr_spmm(G, X)
    if isinstance(G, BlockedELL):
        return ell_spmm(G, X)
    raise TypeError(
        f"the sparse bdgcn arms need a PaddedCSR or BlockedELL support "
        f"container, got {type(G).__name__}: build one with "
        f"sparse.formats.sparsify_support_stack (the data pipeline does "
        f"this for its banks)")


def _origin_sparse(X, G, rows=None):
    """All K origin contractions h1[o] = G_o^T X: X (B, N, N, C) ->
    (K, B, M, N, C), and the destination container(s). ``rows``: an
    (origin, destination) pair whose origin operator has only M output
    rows (a node shard's, nn/bdgcn.py ``origin_rows``)."""
    B, N, _, C = X.shape
    dynamic = isinstance(G, tuple)
    Go, Gd = rows if rows is not None else (G if dynamic else (G, G))
    if dynamic:                                  # per-sample operators
        h1 = _spmm_stack(Go, X.reshape(B, N, N * C))     # (B, K, M, N*C)
        M = h1.shape[-2]
        return h1.reshape(B, -1, M, N, C).transpose(0, 1), Gd
    Xf = X.transpose(0, 1).reshape(N, B * N * C)
    h1 = _spmm_stack(Go, Xf)                              # (K, M, B*N*C)
    M = h1.shape[-2]
    return h1.reshape(-1, M, B, N, C).transpose(1, 2), Gd


def _dest_group_static(h1o, G_dest, w_o):
    """One origin's K destination partials, folded into the projection."""
    B, M, N, C = h1o.shape
    hf = h1o.permute(2, 0, 1, 3).reshape(N, B * M * C)
    t = _spmm_stack(G_dest, hf).reshape(-1, N, B, M, C)  # (K, E, B, M, C)
    return torch.einsum("debml,dlh->bmeh", t, w_o)


def _dest_group_dynamic(h1o, G_dest, w_o):
    """Per-sample-support variant of one origin's folded partials."""
    B, M, N, C = h1o.shape
    hf = h1o.transpose(1, 2).reshape(B, N, M * C)
    t = _spmm_stack(G_dest, hf).reshape(B, -1, N, M, C)  # (B, K, E, M, C)
    return torch.einsum("bdeml,dlh->bmeh", t, w_o)


def _dest_fused_static(h1, G_dest, Wr):
    """All origins' destination partials as ONE SpMM: the K-origin h1 bank
    flattens into one (N, K B M C) block, and the projection folds out in
    one einsum."""
    K, B, M, N, C = h1.shape
    hf = h1.permute(3, 0, 1, 2, 4).reshape(N, K * B * M * C)
    t = _spmm_stack(G_dest, hf).reshape(-1, N, K, B, M, C)
    return torch.einsum("deobml,odlh->bmeh", t, Wr)


def _dest_fused_dynamic(h1, G_dest, Wr):
    """Per-sample-support variant of the fused destination epilogue."""
    K, B, M, N, C = h1.shape
    hf = h1.permute(1, 3, 0, 2, 4).reshape(B, N, K * M * C)
    t = _spmm_stack(G_dest, hf).reshape(B, -1, N, K, M, C)
    return torch.einsum("bdeoml,odlh->bmeh", t, Wr)


def bdgcn_sparse(W, X: torch.Tensor, G, fused: bool = False,
                 rows=None) -> torch.Tensor:
    """Sparse folded BDGCN: out = sum_{o,d} (G_o^T X G_d) @ W[o, d] with
    both contractions as SpMMs over the containers.

    X (B, N, N, C); G the container of the transposed (K, N, N) static
    stack, or a pair of containers of the transposed per-sample (B, K, N,
    N) stacks (``PaddedCSR`` or ``BlockedELL``); W the reference-layout
    (K^2 C, H) weight (int8 codes welcome: dequantised here), so
    checkpoints interchange with the dense arms. ``fused``: one
    destination SpMM over the stacked origins (module docstring).
    ``rows``: the (origin, destination) pair of a node shard, whose origin
    operator gives M < N output rows. Returns (B, M, N, H)."""
    C = X.shape[-1]
    h1, G_dest = _origin_sparse(X, G, rows)
    K = h1.shape[0]
    Wr = deq(W, X.dtype).reshape(K, K, C, -1)
    dynamic = _stack_lead(G_dest) == 2
    if fused:
        return checkpointed(
            _dest_fused_dynamic if dynamic else _dest_fused_static,
            h1, G_dest, Wr)
    group = _dest_group_dynamic if dynamic else _dest_group_static
    out = None
    for o in range(K):
        part = group(h1[o], G_dest, Wr[o])
        out = part if out is None else out + part
    return out
