"""Drift detection for the continual-learning daemon (counterpart of
mpgcn_tpu/service/drift.py).

Two signal families, composed:

  * the windowed eval-loss trend: the daemon scores the incumbent on the
    held-out recent-days split every ingest cycle; drift fires when the
    mean of the newest ``window`` scores exceeds the mean of the
    ``window`` before them by more than ``threshold`` (relative);
  * the sentinel and spike counters of the last retrain's epoch log: more
    sentinel-skipped steps or loss spikes than the budgets tolerate mark
    the data regime as suspect, and the next cycle retrains without
    waiting for the cadence.

Plain Python: no device, nothing per observation but a list append.
"""

from __future__ import annotations

import math


class DriftDetector:
    def __init__(self, window: int, threshold: float,
                 skip_budget: int = 0, spike_budget: int = 0):
        if window < 1:
            raise ValueError(f"drift window={window} must be >= 1")
        if threshold <= 0:
            raise ValueError(f"drift threshold={threshold} must be > 0")
        self.window = int(window)
        self.threshold = float(threshold)
        self.skip_budget = int(skip_budget)
        self.spike_budget = int(spike_budget)
        self._evals: list[float] = []
        self._counter_reason = None

    # --- observations -------------------------------------------------------

    def observe_eval(self, loss: float) -> None:
        """One incumbent eval-loss sample (held-out recent days). Only
        the newest 2*window samples are kept -- check() never reads
        further back, and the history rides every daemon state save."""
        self._evals.append(float(loss))
        del self._evals[: -2 * self.window]

    def observe_counters(self, skipped: int = 0, spikes: int = 0) -> None:
        """Sentinel/spike counters from the most recent retrain's epoch
        log (the trainer's `skipped_steps` / `loss_spikes` fields). Each
        observation REPLACES the previous verdict: a clean retrain
        clears a stale flag (the flagged counters described an older
        window's data), and both signals are reported when both fire."""
        reasons = []
        if skipped > self.skip_budget:
            reasons.append(
                f"{skipped} sentinel-skipped step(s) exceeded the drift "
                f"skip budget {self.skip_budget}")
        if spikes > self.spike_budget:
            reasons.append(
                f"{spikes} loss spike(s) exceeded the drift spike "
                f"budget {self.spike_budget}")
        self._counter_reason = "; ".join(reasons) if reasons else None

    # --- verdict ------------------------------------------------------------

    def check(self):
        """Drift reason string, or None. Non-finite incumbent evals are
        drift by definition (the incumbent cannot score the new data)."""
        if self._counter_reason:
            return self._counter_reason
        if self._evals and not math.isfinite(self._evals[-1]):
            return "non-finite incumbent eval loss"
        w = self.window
        if len(self._evals) < 2 * w:
            return None
        recent = sum(self._evals[-w:]) / w
        base = sum(self._evals[-2 * w:-w]) / w
        if not math.isfinite(base) or base <= 0:
            return None
        if recent > base * (1.0 + self.threshold):
            return (f"eval-loss trend: recent mean {recent:.5g} > "
                    f"{1.0 + self.threshold:.2f} x baseline mean "
                    f"{base:.5g} over {w}-cycle windows")
        return None

    def reset(self) -> None:
        """Called after a retrain lands: the baseline regime changed, so
        both the trend history and any counter flag start over."""
        self._evals.clear()
        self._counter_reason = None

    # --- persistence (daemon state file) ------------------------------------

    def state(self) -> dict:
        return {"evals": list(self._evals),
                "counter_reason": self._counter_reason}

    def load_state(self, s) -> None:
        if not s:
            return
        self._evals = [float(x) for x in s.get("evals", [])]
        self._counter_reason = s.get("counter_reason")
