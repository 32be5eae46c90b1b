"""Sliding windows, split bookkeeping and day-of-week graph keys
(counterpart of mpgcn_tpu/data/windows.py, dense storage only).

The reference's window and split semantics are kept exactly:
  * windows: x = data[i-obs : i], y = data[i : i+pred] for
    i in [obs_len, T - pred_len) -- the last valid window is dropped
    (reference off-by-one, Data_Container_OD.py:158-163);
  * split: validate/test get floor(ratio * len), train the remainder;
  * dynamic-graph key of sample t of a mode: (obs_len + offset + t) % 7.
"""

from __future__ import annotations

import numpy as np

MODES = ("train", "validate", "test")


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
