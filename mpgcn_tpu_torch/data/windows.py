"""Sliding windows, split bookkeeping, day-of-week graph keys, and the
sparse host storage of the OD series (counterpart of
mpgcn_tpu/data/windows.py).

The reference's window and split semantics are kept exactly:
  * windows: x = data[i-obs : i], y = data[i : i+pred] for
    i in [obs_len, T - pred_len) -- the last valid window is dropped
    (reference off-by-one, Data_Container_OD.py:158-163);
  * split: validate/test get floor(ratio * len), train the remainder;
  * dynamic-graph key of sample t of a mode: (obs_len + offset + t) % 7.

Sparse OD storage (``cfg.od_storage``): at city scale the dense (T, N, N)
series is what fills the host. ``SparseODSeries`` keeps it as one flat of
non-zeros a day, and ``WindowView`` gives the (n, L, N, N, 1) window
tensor's surface (len, shape, dtype, nbytes, fancy indexing, np.asarray),
densifying only the rows a batch or chunk gathers, with the bytes the
dense strided views give.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

MODES = ("train", "validate", "test")


class SparseODSeries:
    """A (T, N, N, 1) OD series stored as per-timestep sparse flats."""

    def __init__(self, indptr, idx, vals, T: int, N: int, dtype):
        self._indptr = indptr        # (T + 1,) int64 offsets into idx/vals
        self._idx = idx              # (nnz,) int32 flat N*N positions
        self._vals = vals            # (nnz,) dtype
        self.T, self.N = T, N
        self.dtype = dtype

    @classmethod
    def from_dense(cls, od: np.ndarray) -> "SparseODSeries":
        od = np.asarray(od)
        T, N = od.shape[0], od.shape[1]
        flat = od.reshape(T, -1)
        mask = flat != 0
        indptr = np.zeros(T + 1, np.int64)
        np.cumsum(mask.sum(axis=1), out=indptr[1:])
        # np.nonzero is row-major: the positions come grouped by timestep
        nz_t, nz_p = np.nonzero(mask)
        return cls(indptr, nz_p.astype(np.int32), flat[nz_t, nz_p], T, N,
                   od.dtype)

    @property
    def density(self) -> float:
        return float(self._vals.size / max(self.T * self.N * self.N, 1))

    @property
    def nbytes(self) -> int:
        """The sparse host bytes (the dense series: T N^2 itemsize)."""
        return self._indptr.nbytes + self._idx.nbytes + self._vals.nbytes

    def densify(self, t0: int, t1: int,
                out: Optional[np.ndarray] = None) -> np.ndarray:
        """Rows [t0, t1) as a dense (t1 - t0, N, N, 1) block, written into
        ``out`` when given."""
        if out is None:
            out = np.zeros((t1 - t0, self.N, self.N, 1), self.dtype)
        else:
            out[...] = 0
        flat = out.reshape(t1 - t0, self.N * self.N)
        for i, t in enumerate(range(t0, t1)):
            lo, hi = self._indptr[t], self._indptr[t + 1]
            flat[i, self._idx[lo:hi]] = self._vals[lo:hi]
        return out


class WindowView:
    """A lazy (count, length, N, N, 1) window tensor over a SparseODSeries:
    window j covers series rows [base + j, base + j + length). Indexing
    returns dense rows, the bytes of the dense strided views; ``nbytes``
    is the dense equivalent, so the epoch executor's budget counts the
    bytes the device will hold."""

    def __init__(self, series: SparseODSeries, base: int, count: int,
                 length: int):
        self._series = series
        self._base, self._count, self._length = base, count, length
        self.shape = (count, length, series.N, series.N, 1)
        self.dtype = np.dtype(np.float32)

    def __len__(self):
        return self._count

    @property
    def nbytes(self) -> int:
        return int(np.prod(self.shape)) * self.dtype.itemsize

    def take(self, sel, out: Optional[np.ndarray] = None) -> np.ndarray:
        """The windows ``sel`` (an int, a slice, or an index or mask array
        under numpy's rules: negatives wrap once, out of range raises),
        densified into ``out`` when given."""
        if isinstance(sel, slice):
            sel = np.arange(self._count)[sel]
        sel = np.asarray(sel)
        if sel.dtype == bool:
            sel = np.flatnonzero(sel)
        # without the range check a negative j would densify rows from
        # before this mode's split boundary
        flat = np.where(sel < 0, sel + self._count, sel).reshape(-1)
        if flat.size and (int(flat.min()) < 0
                          or int(flat.max()) >= self._count):
            raise IndexError(
                f"window index out of range for a {self._count}-window "
                f"view")
        shape = (flat.size,) + self.shape[1:]
        if out is None:
            out = np.empty(shape, self.dtype)
        rows = out.reshape(shape)
        for i, j in enumerate(flat):
            t0 = self._base + int(j)
            self._series.densify(t0, t0 + self._length, out=rows[i])
        return out.reshape(sel.shape + self.shape[1:])

    def __getitem__(self, key):
        """numpy indexing: the first index picks windows (densified), the
        rest index the dense result."""
        if not isinstance(key, tuple):
            return self.take(key)
        if not key or key[0] is Ellipsis:
            return np.asarray(self)[key]
        first, rest = key[0], key[1:]
        kept = isinstance(first, slice) or np.ndim(first) > 0
        return self.take(first)[((slice(None),) if kept else ()) + rest]

    def __array__(self, dtype=None, copy=None):
        dense = self.take(np.arange(self._count))
        return dense if dtype is None else dense.astype(dtype)


def sliding_windows(
    data: np.ndarray, obs_len: int, pred_len: int, drop_last_window: bool = True
) -> tuple[np.ndarray, np.ndarray]:
    """(T, ...) -> x (n, obs_len, ...), y (n, pred_len, ...). Zero-copy views."""
    T = data.shape[0]
    end = T - pred_len if drop_last_window else T - pred_len + 1
    n = end - obs_len
    if n <= 0:
        raise ValueError(
            f"series too short: T={T}, obs_len={obs_len}, pred_len={pred_len}")
    win = np.lib.stride_tricks.sliding_window_view(
        data, obs_len + pred_len, axis=0)
    win = np.moveaxis(win, -1, 1)[:n]
    return win[:, :obs_len], win[:, obs_len:]


def split_lengths(n: int, split_ratio) -> dict[str, int]:
    total = sum(split_ratio)
    lens = {
        "validate": int(split_ratio[1] / total * n),
        "test": int(split_ratio[2] / total * n),
    }
    lens["train"] = n - lens["validate"] - lens["test"]
    return lens


def mode_offset(mode: str, mode_len: dict[str, int]) -> int:
    if mode == "train":
        return 0
    if mode == "validate":
        return mode_len["train"]
    return mode_len["train"] + mode_len["validate"]


def dow_keys(mode: str, mode_len: dict[str, int], obs_len: int,
             period: int = 7) -> np.ndarray:
    """Per-sample dynamic-graph slot keys for a mode (reference: :97-108)."""
    off = obs_len + mode_offset(mode, mode_len)
    return (off + np.arange(mode_len[mode])) % period
