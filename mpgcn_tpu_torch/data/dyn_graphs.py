"""Dynamic OD-correlation graphs (counterpart of
mpgcn_tpu/data/dyn_graphs.py).

Average the unnormalized OD tensor per day-of-week slot over the train
split, then for each slot build

  O-graph: O_G[i, j] = cosine_distance(row_i, row_j)        (paper eq. 6)
  D-graph: D_G[i, j] = cosine_distance(col_i, row_j)        (reference :56)

The reference's D-graph mixes column i with ROW j; eq. (7) of the paper
says columns i and j. ``reproduce_d_bug=True`` (the default) keeps the
reference behaviour. Zero vectors give NaN exactly as scipy does.

With ``use_native`` (the loader passes ``cfg.native_host != "off"``) the
day-of-week mean is native/host.py ``dow_mean``: the C++/OpenMP loop in
float64 where it builds, else numpy's float64 mean, as the JAX package
takes it; without, numpy's mean of the series as it is.
"""

from __future__ import annotations

import numpy as np

from mpgcn_tpu_torch.native import host


def _cosine_distance_matrix(U: np.ndarray, V: np.ndarray) -> np.ndarray:
    """dist[i, j] = 1 - (U_i . V_j) / (|U_i| |V_j|), rows of U vs rows of V."""
    dots = U @ V.T
    nu = np.linalg.norm(U, axis=1)
    nv = np.linalg.norm(V, axis=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        return 1.0 - dots / np.outer(nu, nv)


def construct_dyn_g(
    od_data: np.ndarray,
    train_ratio: float,
    perceived_period: int = 7,
    reproduce_d_bug: bool = True,
    use_native: bool = True,
) -> tuple[np.ndarray, np.ndarray]:
    """Build (O_dyn_G, D_dyn_G), each (N, N, period), from a (T, N, N) or
    (T, N, N, 1) unnormalized flow tensor."""
    if od_data.ndim == 4:
        od_data = od_data[..., 0]
    T = od_data.shape[0]
    train_len = int(T * train_ratio)
    num_periods = train_len // perceived_period  # drop the remainder (:41)
    history = od_data[: num_periods * perceived_period]
    if use_native:
        avgs = host.dow_mean(history, perceived_period)
    else:
        avgs = np.stack([history[t::perceived_period].mean(axis=0)
                         for t in range(perceived_period)])

    O_list, D_list = [], []
    for t in range(perceived_period):
        avg = avgs[t]
        O_list.append(_cosine_distance_matrix(avg, avg))
        if reproduce_d_bug:
            D_list.append(_cosine_distance_matrix(avg.T, avg))
        else:
            D_list.append(_cosine_distance_matrix(avg.T, avg.T))
    return np.stack(O_list, axis=-1), np.stack(D_list, axis=-1)
