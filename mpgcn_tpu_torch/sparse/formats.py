"""Sparse support-stack containers: padded-CSR and blocked-ELL
(counterpart of mpgcn_tpu/sparse/formats.py).

A ``PaddedCSR`` holds a stack of sparse (N, n_cols) operators as (..., N,
R) column ids and values, R the pad width every row shares (the most
populated row, rounded up to ``plan_pad_width``'s bucket); a row with
fewer non-zeros pads with id 0 and value 0, so an isolated node gives an
exact zero row. A ``BlockedELL`` holds a stack of sparse (n_rows,
n_cols) operators as fixed-shape tensors: the rows in blocks of BR, the
columns in blocks of BC, and per row block only its populated (BR, BC)
tiles with their column-block ids. Both take any leading dims -- (K, N,
N) static stacks, (7, K, N, N) day-of-week banks -- and ``bank[keys]``
gathers the stack like a dense bank.

Orientation: a container stores the operator A applied as
``out[m] = sum_n A[m, n] X[n]``. Both BDGCN contractions apply the
supports transposed, so ``sparsify_support_stack`` transposes the dense
stack first; callers hand it the (..., N, N) bank the dense path uses.

The containers are built in numpy and are byte for byte the JAX package's
for the same dense stack (CSR ids and values; block_cols, tiles, int8
codes and scales), the ELL ones with its (8, 128) tiles: the tile shape
is the TPU's and is kept so that the two packages store the same bytes.
One thing is added to a BlockedELL: a transposed block
index (``t_ptr``, ``t_slot``), the populated slots of each column block in
a fixed order, which the dX kernel walks instead of adding into dX with
atomics, and the forward kernel walks to find a row group's slots on each
column block (sparse/cuda_ell.py). Pad slots (all-zero tiles) are left out
of it: their contribution is exactly zero.

``analyze_support`` and ``recommend_format`` profile a dense stack as the
JAX package does: dense above the density threshold, else blocked-ELL on
the TPU and padded-CSR elsewhere (the port's own ``auto`` is
data/pipeline.py ``resolve_bdgcn_impl``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from mpgcn_tpu_torch.config import SUPPORT_PAYLOADS
from mpgcn_tpu_torch.quant.int8 import QuantizedTensor, is_quantized

#: support density above which ``recommend_format`` says dense (the JAX
#: package's guessed ``sparse_density_threshold``)
SPARSE_DENSITY_DEFAULT = 0.25

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
class PaddedCSR:
    """Padded-CSR operator stack.

    indices: (..., N, R) int32 input-node ids per output row (0 on pads).
    values:  (..., N, R) coefficients (0 on pads), f32 or bf16.
    n_cols:  the dense input dimension.
    """

    indices: torch.Tensor
    values: torch.Tensor
    n_cols: int

    def __getitem__(self, key):
        """Slice the stack's leading dims (``bank[keys]``)."""
        return PaddedCSR(self.indices[key], self.values[key], self.n_cols)

    def to(self, device) -> "PaddedCSR":
        return PaddedCSR(self.indices.to(device), self.values.to(device),
                         self.n_cols)

    @property
    def pad_width(self) -> int:
        return self.indices.shape[-1]

    @property
    def shape(self) -> tuple:
        """Dense-equivalent shape of the stacked operator."""
        return tuple(self.indices.shape[:-1]) + (self.n_cols,)

    @property
    def device(self) -> torch.device:
        return self.indices.device

    def to_dense(self) -> np.ndarray:
        idx = _numpy(self.indices)
        val = _numpy(self.values.float())
        flat_i = idx.reshape(-1, *idx.shape[-2:])
        flat_v = val.reshape(-1, *val.shape[-2:])
        out = np.zeros((flat_i.shape[0], idx.shape[-2], self.n_cols),
                       flat_v.dtype)
        rows = np.arange(idx.shape[-2])[:, None]
        for b in range(flat_i.shape[0]):
            # pads carry value 0 at id 0, so adding them is exact
            np.add.at(out[b], (rows, flat_i[b]), flat_v[b])
        return out.reshape(self.shape)


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


def csr_from_dense(A, bucket: int = _PAD_BUCKET,
                   pad_width: Optional[int] = None) -> PaddedCSR:
    """(..., N, M) dense operator stack -> PaddedCSR with one pad width R
    shared by the whole stack (CPU tensors): each row's non-zeros in
    column order, then pads."""
    A = _numpy(A)
    _check_finite(A, "dense operator")
    mask = A != 0
    max_nnz = int(mask.sum(-1).max()) if A.size else 0
    if pad_width is not None:
        R = pad_width
        if max_nnz > R:
            raise ValueError(
                f"pad_width {R} < max row nnz {max_nnz}: entries would "
                f"be silently dropped")
    else:
        # a small matrix never needs a pad wider than its column count
        R = min(plan_pad_width(max_nnz, bucket), max(A.shape[-1], 1))
    order = np.argsort(~mask, axis=-1, kind="stable")[..., :R]
    taken = np.take_along_axis(mask, order, -1)
    vals = np.where(taken, np.take_along_axis(A, order, -1), 0)
    idx = np.where(taken, order, 0)
    return PaddedCSR(torch.from_numpy(idx.astype(np.int32)),
                     torch.from_numpy(vals.astype(A.dtype)),
                     int(A.shape[-1]))


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


def sparsify_support_stack(stack, fmt: str, pad: Optional[int] = None):
    """Dense (..., N, N) support bank -> the container of the TRANSPOSED
    operators. ``pad`` is the pad width R ('csr') or pad-block count MB
    ('ell'), shared across banks when given; the ELL column-block width
    follows ``_support_bc``."""
    stack = np.swapaxes(_numpy(stack), -1, -2)
    if fmt == "csr":
        return csr_from_dense(stack, pad_width=pad)
    if fmt == "ell":
        return ell_from_dense(stack, br=_ELL_BR,
                              bc=_support_bc(stack.shape[-1]),
                              pad_blocks=pad)
    raise ValueError(f"unknown sparse format {fmt!r}: expected csr|ell")


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


def pack_payload(container, payload: str):
    """Re-store the values as ``payload``: 'f32' as they are, 'bf16' cast,
    'int8' as codes and per-row-block scales (blocked-ELL only: the
    padded-CSR gather has no tiled operand read to dequantise in).
    Structure and pad stay."""
    if payload not in SUPPORT_PAYLOADS:
        raise ValueError(f"unknown support payload {payload!r}: expected "
                         f"one of {SUPPORT_PAYLOADS}")
    if not isinstance(container, (PaddedCSR, BlockedELL)):
        raise TypeError(f"not a sparse container: "
                        f"{type(container).__name__}")
    if payload == "f32":
        return container
    if isinstance(container, PaddedCSR):
        if payload == "int8":
            raise ValueError(
                "support_payload='int8' needs blocked-ELL containers "
                "(bdgcn_impl='ell'): the padded-CSR arm has no tiled "
                "operand read")
        return dataclasses.replace(
            container, values=container.values.to(torch.bfloat16))
    if payload == "int8":
        return quantize_ell(container)
    return dataclasses.replace(container,
                               blocks=container.blocks.to(torch.bfloat16))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def container_nbytes(c) -> int:
    """Resident bytes of a container: CSR ids and values; ELL column ids,
    tiles (codes and scales for int8) and the transposed block index."""
    if isinstance(c, PaddedCSR):
        return _nbytes(c.indices) + _nbytes(c.values)
    blk = c.blocks
    tiles = blk.nbytes if is_quantized(blk) else _nbytes(blk)
    return tiles + sum(_nbytes(t) for t in (c.block_cols, c.t_ptr, c.t_slot))


def dense_equiv_bytes(c, dtype_bytes: int = 4) -> int:
    """Bytes of the same operator stack stored dense."""
    return int(np.prod(c.shape)) * dtype_bytes


def container_pad(c) -> int:
    """The shared-pad handle of a container: R for PaddedCSR, MB for
    BlockedELL (what ``sparsify_support_stack(pad=...)`` takes)."""
    if isinstance(c, PaddedCSR):
        return c.pad_width
    if isinstance(c, BlockedELL):
        return c.pad_blocks
    raise TypeError(f"not a sparse container: {type(c).__name__}")


def analyze_support(stack) -> dict:
    """Density and row-population profile of a dense support stack, and
    the format ``recommend_format`` gives it (host numpy)."""
    A = _numpy(stack)
    mask = A != 0
    nnz = int(mask.sum())
    density = nnz / A.size if A.size else 1.0
    per_row = mask.sum(-1)
    max_row = int(per_row.max()) if A.size else 0
    return {
        "nnz": nnz,
        "density": round(density, 6),
        "max_row_nnz": max_row,
        "pad_width": plan_pad_width(max_row),
        "zero_degree_rows": int((per_row == 0).sum()),
        "recommend": recommend_format(density),
    }


def recommend_format(density: float,
                     threshold: float = SPARSE_DENSITY_DEFAULT,
                     platform: str = "cpu") -> str:
    """The JAX package's recommendation by density: dense above the
    threshold, blocked-ELL on the TPU, padded-CSR elsewhere."""
    if density > threshold:
        return "dense"
    return "ell" if platform == "tpu" else "csr"
