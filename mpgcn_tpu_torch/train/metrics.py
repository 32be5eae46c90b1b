"""Evaluation metrics (counterpart of mpgcn_tpu/train/metrics.py; reference
Metrics.py:5-26). Host-side numpy: every residual and reduction runs in
float64, whatever dtype the arrays arrive in."""

from __future__ import annotations

import numpy as np


def _f64(a: np.ndarray) -> np.ndarray:
    return np.asarray(a, np.float64)


def MSE(y_pred: np.ndarray, y_true: np.ndarray) -> float:
    return float(np.mean(np.square(_f64(y_pred) - _f64(y_true))))


def RMSE(y_pred: np.ndarray, y_true: np.ndarray) -> float:
    return float(np.sqrt(MSE(y_pred, y_true)))


def MAE(y_pred: np.ndarray, y_true: np.ndarray) -> float:
    return float(np.mean(np.abs(_f64(y_pred) - _f64(y_true))))


def MAPE(y_pred: np.ndarray, y_true: np.ndarray, epsilon: float = 1.0) -> float:
    # epsilon=1.0 denominator guard, as in the reference (Metrics.py:22-23)
    return float(np.mean(np.abs(_f64(y_pred) - _f64(y_true))
                         / (_f64(y_true) + epsilon)))


def PCC(y_pred: np.ndarray, y_true: np.ndarray) -> float:
    return float(np.corrcoef(_f64(y_pred).flatten(),
                             _f64(y_true).flatten())[0, 1])


def per_horizon_rmse(y_pred: np.ndarray, y_true: np.ndarray,
                     axis: int = 1) -> list[float]:
    """RMSE per forecast step along ``axis`` (the pred_len axis of a
    (B, pred_len, N, N, 1) rollout)."""
    p, t = _f64(y_pred), _f64(y_true)
    if p.shape != t.shape:
        raise ValueError(f"shape mismatch: pred {p.shape} vs true "
                         f"{t.shape}")
    sq = np.square(p - t)
    red = tuple(a for a in range(sq.ndim) if a != axis)
    return [float(v) for v in np.sqrt(sq.mean(axis=red))]


def evaluate(y_pred: np.ndarray, y_true: np.ndarray, precision: int = 4):
    """Print all five metrics, return (MSE, RMSE, MAE, MAPE)
    (reference: Metrics.py:5-11)."""
    mse = MSE(y_pred, y_true)
    rmse = float(np.sqrt(mse))
    mae = MAE(y_pred, y_true)
    mape = MAPE(y_pred, y_true)
    pcc = PCC(y_pred, y_true)
    print("MSE:", round(mse, precision))
    print("RMSE:", round(rmse, precision))
    print("MAE:", round(mae, precision))
    print("MAPE:", round(mape * 100, precision), "%")
    print("PCC:", round(pcc, precision))
    return mse, rmse, mae, mape
