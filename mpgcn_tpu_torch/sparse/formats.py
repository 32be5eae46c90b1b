"""Blocked-ELL support-stack containers (counterpart of the blocked-ELL
half of mpgcn_tpu/sparse/formats.py).

A ``BlockedELL`` holds a stack of sparse (n_rows, n_cols) operators with
any leading dims -- (K, N, N) static stacks, (7, K, N, N) day-of-week
banks -- as fixed-shape tensors: the rows in blocks of BR, the columns in
blocks of BC, and per row block only its populated (BR, BC) tiles with
their column-block ids. ``bank[keys]`` gathers the stack like a dense
bank.

Orientation: a container stores the operator A applied as
``out[m] = sum_n A[m, n] X[n]``. Both BDGCN contractions apply the
supports transposed, so ``sparsify_support_stack`` transposes the dense
stack first; callers hand it the (..., N, N) bank the dense path uses.

The containers are built in numpy and are byte for byte the JAX package's
for the same dense stack (block_cols, tiles, int8 codes and scales), with
its (8, 128) tiles: the tile shape is the TPU's and is kept so that the
two packages store the same bytes. One thing is added: a transposed block
index (``t_ptr``, ``t_slot``), the populated slots of each column block in
a fixed order, which the dX kernel walks instead of adding into dX with
atomics, and the forward kernel walks to find a row group's slots on each
column block (sparse/cuda_ell.py). Pad slots (all-zero tiles) are left out
of it: their contribution is exactly zero.

The padded-CSR container and the ``csr`` arm are not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from mpgcn_tpu_torch.config import SUPPORT_PAYLOADS
from mpgcn_tpu_torch.quant.int8 import QuantizedTensor, is_quantized

_PAD_BUCKET = 8      # pad-width granularity of the JAX package's planner
_ELL_BR = 8          # row-block height
_ELL_BC = 128        # column-block width


def plan_pad_width(max_row_nnz: int, bucket: int = _PAD_BUCKET) -> int:
    """Static pad width: the max row population rounded up to a ``bucket``
    multiple (at least one bucket)."""
    if bucket < 1:
        raise ValueError(f"bucket must be >= 1, got {bucket}")
    return max(bucket, -(-max(int(max_row_nnz), 1) // bucket) * bucket)


def _check_finite(A: np.ndarray, what: str):
    if not np.isfinite(A).all():
        raise ValueError(
            f"{what} has non-finite entries; sparsifying would bake the "
            f"poison into the container (validate_graph is the load-time "
            f"guard)")


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


@dataclasses.dataclass(frozen=True)
class BlockedELL:
    """Blocked-ELL operator stack.

    block_cols: (..., NB, MB) int32 column-block ids per row block (0 on
                pad slots).
    blocks:     (..., NB, MB, BR, BC) tiles (0 on pad slots), f32 or bf16,
                or a ``QuantizedTensor`` of int8 codes and (..., NB, 1, 1,
                1) f32 scales.
    t_ptr:      (..., NBc + 1) int32: column block c's populated slots are
                t_slot[..., t_ptr[c]:t_ptr[c + 1]].
    t_slot:     (..., NB * MB) int32 slot ids i * MB + j, by column block,
                then row block, then slot (0 past the last populated one).
    n_rows / n_cols: the unpadded dense dims.
    """

    block_cols: torch.Tensor
    blocks: Union[torch.Tensor, QuantizedTensor]
    t_ptr: torch.Tensor
    t_slot: torch.Tensor
    n_rows: int
    n_cols: int

    def __getitem__(self, key):
        """Slice the stack's leading dims (``bank[keys]`` gathers the
        per-batch day-of-week slots)."""
        return BlockedELL(self.block_cols[key], self.blocks[key],
                          self.t_ptr[key], self.t_slot[key], self.n_rows,
                          self.n_cols)

    def to(self, device) -> "BlockedELL":
        return BlockedELL(self.block_cols.to(device), self.blocks.to(device),
                          self.t_ptr.to(device), self.t_slot.to(device),
                          self.n_rows, self.n_cols)

    @property
    def pad_blocks(self) -> int:
        return self.block_cols.shape[-1]

    @property
    def shape(self) -> tuple:
        return (tuple(self.block_cols.shape[:-2])
                + (self.n_rows, self.n_cols))

    @property
    def device(self) -> torch.device:
        return self.block_cols.device

    def to_dense(self) -> np.ndarray:
        """The dense (..., n_rows, n_cols) stack, f32 (int8 dequantised)."""
        cols = _numpy(self.block_cols)
        blk = _numpy(self.blocks.dequantize() if is_quantized(self.blocks)
                     else self.blocks.float())
        nb, mb = cols.shape[-2:]
        br, bc = blk.shape[-2:]
        lead = cols.shape[:-2]
        flat_c = cols.reshape(-1, nb, mb)
        flat_b = blk.reshape(-1, nb, mb, br, bc)
        out = np.zeros((flat_c.shape[0], nb * br,
                        -(-self.n_cols // bc) * bc), blk.dtype)
        for s in range(flat_c.shape[0]):
            for i in range(nb):
                for j in range(mb):
                    c = flat_c[s, i, j]
                    out[s, i * br:(i + 1) * br, c * bc:(c + 1) * bc] += \
                        flat_b[s, i, j]
        out = out[:, :self.n_rows, :self.n_cols]
        return out.reshape(lead + (self.n_rows, self.n_cols))


def _transposed_index(cols: np.ndarray, taken: np.ndarray, nbc: int):
    """(t_ptr, t_slot) of a container: per stack slice, the populated slots
    i * MB + j sorted by (column block, i, j), and where each column
    block's run starts."""
    nb, mb = cols.shape[-2:]
    lead = cols.shape[:-2]
    n = nb * mb
    flat_c = cols.reshape(-1, n).astype(np.int64)
    flat_t = taken.reshape(-1, n)
    key = np.where(flat_t, flat_c * n + np.arange(n), nbc * n)
    order = np.argsort(key, axis=-1, kind="stable")
    t_slot = np.where(np.take_along_axis(flat_t, order, -1), order, 0)
    counts = np.stack([((flat_c == c) & flat_t).sum(-1)
                       for c in range(nbc)], -1)
    t_ptr = np.concatenate([np.zeros((flat_c.shape[0], 1), np.int64),
                            np.cumsum(counts, -1)], -1)
    return (t_ptr.astype(np.int32).reshape(lead + (nbc + 1,)),
            t_slot.astype(np.int32).reshape(lead + (n,)))


def _tiles(A: np.ndarray, br: int, bc: int) -> np.ndarray:
    """(..., N, M) -> its zero-padded (..., NB, NBc, br, bc) tiles."""
    n_rows, n_cols = A.shape[-2:]
    nrp, ncp = -(-n_rows // br) * br, -(-n_cols // bc) * bc
    pad = [(0, 0)] * (A.ndim - 2) + [(0, nrp - n_rows), (0, ncp - n_cols)]
    tiles = np.pad(A, pad).reshape(A.shape[:-2] + (nrp // br, br,
                                                   ncp // bc, bc))
    return np.moveaxis(tiles, -3, -2)


def _auto_pad(bmask: np.ndarray, bucket: int) -> int:
    """The pad-block count MB a (..., NB, NBc) tile mask needs: its most
    populated row block, planned to a ``bucket`` multiple, capped at NBc."""
    max_blocks = int(bmask.sum(-1).max()) if bmask.size else 0
    return min(plan_pad_width(max_blocks, bucket), bmask.shape[-1])


def ell_from_dense(A, br: int = _ELL_BR, bc: int = _ELL_BC,
                   bucket: int = 1,
                   pad_blocks: Optional[int] = None) -> BlockedELL:
    """(..., N, M) dense operator stack -> BlockedELL with (br, bc) tiles
    and one pad-block count MB shared by the whole stack (CPU tensors)."""
    A = _numpy(A)
    _check_finite(A, "dense operator")
    n_rows, n_cols = A.shape[-2:]
    tiles = _tiles(A, br, bc)                     # (..., nb, nbc, br, bc)
    nbc = tiles.shape[-3]
    bmask = tiles.any(axis=(-1, -2))              # (..., nb, nbc)
    max_blocks = int(bmask.sum(-1).max()) if A.size else 0
    MB = (min(pad_blocks, nbc) if pad_blocks is not None
          else _auto_pad(bmask, bucket))
    if max_blocks > MB:
        raise ValueError(
            f"pad_blocks {MB} < max populated blocks {max_blocks}")
    order = np.argsort(~bmask, axis=-1, kind="stable")[..., :MB]
    taken = np.take_along_axis(bmask, order, -1)
    cols = np.where(taken, order, 0)
    blocks = np.take_along_axis(tiles, order[..., None, None], axis=-3)
    blocks = np.where(taken[..., None, None], blocks, 0)
    t_ptr, t_slot = _transposed_index(cols, taken, nbc)
    return BlockedELL(torch.from_numpy(cols.astype(np.int32)),
                      torch.from_numpy(blocks.astype(A.dtype)),
                      torch.from_numpy(t_ptr), torch.from_numpy(t_slot),
                      int(n_rows), int(n_cols))


def _support_bc(n: int) -> int:
    """The column-block width of an N-node support container: graphs
    narrower than one column block get a single block of N rounded up to
    8, larger ones the 128 of the (8, 128) tile."""
    return _ELL_BC if n >= _ELL_BC else max(8, -(-n // 8) * 8)


def ell_pad_width(stack) -> int:
    """The pad-block count MB that ``sparsify_support_stack(stack, 'ell')``
    picks when given none. A bank build takes the max over its banks as
    the shared pad and packs each bank once."""
    A = np.swapaxes(_numpy(stack), -1, -2)
    bmask = _tiles(A, _ELL_BR, _support_bc(A.shape[-1])).any(axis=(-1, -2))
    return _auto_pad(bmask, 1)


def sparsify_support_stack(stack, fmt: str,
                           pad: Optional[int] = None) -> BlockedELL:
    """Dense (..., N, N) support bank -> the container of the TRANSPOSED
    operators. ``pad`` is the pad-block count MB, shared across banks when
    given; the column-block width follows ``_support_bc``."""
    stack = np.swapaxes(_numpy(stack), -1, -2)
    if fmt == "ell":
        return ell_from_dense(stack, br=_ELL_BR,
                              bc=_support_bc(stack.shape[-1]),
                              pad_blocks=pad)
    if fmt == "csr":
        raise ValueError("the padded-CSR format is not ported: use 'ell'")
    raise ValueError(f"unknown sparse format {fmt!r}: expected 'ell'")


def quantize_ell(ell: BlockedELL) -> BlockedELL:
    """int8 codes with one symmetric scale per row block (amax over the
    row block's MB tiles / 127); all-zero row blocks get scale 1."""
    if is_quantized(ell.blocks):
        return ell
    blk = _numpy(ell.blocks).astype(np.float32)
    amax = np.max(np.abs(blk), axis=(-3, -2, -1), keepdims=True)
    scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.rint(blk / scale), -127, 127).astype(np.int8)
    dev = ell.blocks.device
    return dataclasses.replace(
        ell, blocks=QuantizedTensor(torch.from_numpy(q).to(dev),
                                    torch.from_numpy(scale).to(dev)))


def pack_payload(container: BlockedELL, payload: str) -> BlockedELL:
    """Re-store the tiles as ``payload``: 'f32' as they are, 'bf16' cast,
    'int8' as codes and per-row-block scales. Structure and pad stay."""
    if payload not in SUPPORT_PAYLOADS:
        raise ValueError(f"unknown support payload {payload!r}: expected "
                         f"one of {SUPPORT_PAYLOADS}")
    if not isinstance(container, BlockedELL):
        raise TypeError(f"not a sparse container: "
                        f"{type(container).__name__}")
    if payload == "f32":
        return container
    if payload == "int8":
        return quantize_ell(container)
    return dataclasses.replace(container,
                               blocks=container.blocks.to(torch.bfloat16))


def container_nbytes(c: BlockedELL) -> int:
    """Resident bytes of a container: column ids, tiles (codes and scales
    for int8) and the transposed block index."""
    blk = c.blocks
    tiles = (blk.nbytes if is_quantized(blk)
             else blk.numel() * blk.element_size())
    return tiles + sum(t.numel() * t.element_size()
                       for t in (c.block_cols, c.t_ptr, c.t_slot))


def dense_equiv_bytes(c: BlockedELL, dtype_bytes: int = 4) -> int:
    """Bytes of the same operator stack stored dense."""
    return int(np.prod(c.shape)) * dtype_bytes


def container_pad(c: BlockedELL) -> int:
    """The shared-pad handle of a container (MB)."""
    if isinstance(c, BlockedELL):
        return c.pad_blocks
    raise TypeError(f"not a sparse container: {type(c).__name__}")
