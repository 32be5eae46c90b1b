"""The continual-learning daemon's window split (counterpart of
``window_split_ratio``, mpgcn_tpu/service/daemon.py:96-128), which the
serve command's data build reads (service/serve.py ``_build_data``). The
daemon loop itself is not ported yet."""

from __future__ import annotations

from mpgcn_tpu_torch.data.windows import split_lengths


def window_split_ratio(T: int, obs_len: int, pred_len: int,
                       val_days: int, holdout_days: int) -> tuple:
    """split_ratio for a T-day window that realizes exactly the requested
    counts: the trailing ``holdout_days`` windows are the held-out
    ('test') split, ``val_days`` windows before them validate, the rest
    train. ``split_lengths`` truncates ``r / total * n``, which can land
    one ulp below the integer, so the ratio biases validate and test up
    by a quarter window and the realized split is checked before it is
    returned."""
    nwin = T - obs_len - pred_len  # drop_last_window semantics
    train_n = nwin - val_days - holdout_days
    if train_n < 1:
        raise ValueError(
            f"window of {T} days yields {nwin} windows -- not enough for "
            f"val={val_days} + holdout={holdout_days} + >=1 train window")
    ratio = (train_n - 0.5, val_days + 0.25, holdout_days + 0.25)
    lens = split_lengths(nwin, ratio)
    if (lens["train"], lens["validate"], lens["test"]) != (
            train_n, val_days, holdout_days):
        raise AssertionError(
            f"window_split_ratio({T}, {obs_len}, {pred_len}, {val_days}, "
            f"{holdout_days}) realized {lens} instead of the requested "
            f"({train_n}, {val_days}, {holdout_days}) windows")
    return ratio
