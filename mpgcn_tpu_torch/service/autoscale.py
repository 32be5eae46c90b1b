"""SLO-burn-driven replica autoscaling (counterpart of
mpgcn_tpu/service/autoscale.py).

The router feeds its own per-request latencies into an SLOEngine
(obs/perf/slo.py), and this module turns the engine's tick reports into
spawn/retire decisions with hysteresis -- sustained BURNING spawns a
replica, sustained OK retires one, and every action freezes the
controller for a cooldown so a noisy signal cannot flap the fleet
(spawn/retire churn is itself an availability risk: a joining replica
builds its rollout graphs, a retiring one drains).

Device-free and side-effect-free: the controller never talks to
processes itself -- it calls the spawn/retire callables the router
wires in, and every decision is derived from the report it was handed,
so a fake-clock SLOEngine drives the whole loop deterministically
(tests/test_torch_router.py).
"""

from __future__ import annotations

from typing import Callable, Optional

from mpgcn_tpu_torch.obs.perf.slo import BURNING, OK, WARN

__all__ = ["Autoscaler", "worst_state"]


def worst_state(report: Optional[dict]) -> int:
    """The worst state_code across a tick report's SLO entries; a
    missing/empty/errored report reads as OK (no signal is not a reason
    to scale -- the engine itself never raises, so absence means no
    specs are armed)."""
    if not report or not isinstance(report.get("slos"), list):
        return OK
    worst = OK
    for entry in report["slos"]:
        code = entry.get("state_code")
        if isinstance(code, int) and code > worst:
            worst = code
    return worst


class Autoscaler:
    """Hysteresis controller: burn-rate state -> spawn/retire.

    State machine per tick (one tick = one SLOEngine report):

      BURNING  burn_streak += 1, ok_streak = 0
      WARN     ok_streak = 0 (not healthy enough to retire; the burn
               streak HOLDS -- WARN between BURNING ticks must not
               reset the evidence that capacity is short)
      OK       ok_streak += 1, burn_streak = 0

    `scale_up()` fires after `up_after` consecutive-or-held BURNING
    ticks, `scale_down()` after `down_after` consecutive OK ticks; both
    respect the [min_replicas, max_replicas] bounds and every action
    zeroes the streaks and arms `cooldown_ticks` of enforced inaction.
    """

    def __init__(self, *, min_replicas: int, max_replicas: int,
                 scale_up: Callable[[], None],
                 scale_down: Callable[[], None],
                 count: Callable[[], int],
                 up_after: int = 2, down_after: int = 6,
                 cooldown_ticks: int = 3):
        if min_replicas < 1 or max_replicas < min_replicas:
            raise ValueError(
                f"need 1 <= min_replicas <= max_replicas, got "
                f"{min_replicas}..{max_replicas}")
        if up_after < 1 or down_after < 1:
            raise ValueError("up_after and down_after must be >= 1")
        if cooldown_ticks < 0:
            raise ValueError("cooldown_ticks must be >= 0")
        self.min_replicas = min_replicas
        self.max_replicas = max_replicas
        self._scale_up = scale_up
        self._scale_down = scale_down
        self._count = count
        self.up_after = up_after
        self.down_after = down_after
        self.cooldown_ticks = cooldown_ticks
        self.burn_streak = 0
        self.ok_streak = 0
        self.cooldown = 0
        self.actions: list = []      #: decision history (the last 200)

    def tick(self, report: Optional[dict]) -> dict:
        """Consume one SLOEngine tick report; returns the decision row
        ({action, state, streaks, replicas}) the router ledgers."""
        state = worst_state(report)
        if state == BURNING:
            self.burn_streak += 1
            self.ok_streak = 0
        elif state == WARN:
            self.ok_streak = 0
        else:
            self.ok_streak += 1
            self.burn_streak = 0

        action = "hold"
        n = self._count()
        if self.cooldown > 0:
            self.cooldown -= 1
            action = "cooldown"
        elif self.burn_streak >= self.up_after and state == BURNING:
            if n < self.max_replicas:
                self._scale_up()
                action = "scale-up"
                self.burn_streak = self.ok_streak = 0
                self.cooldown = self.cooldown_ticks
            else:
                action = "at-max"
        elif self.ok_streak >= self.down_after:
            if n > self.min_replicas:
                self._scale_down()
                action = "scale-down"
                self.burn_streak = self.ok_streak = 0
                self.cooldown = self.cooldown_ticks
            else:
                action = "at-min"
        row = {"action": action, "state": state, "replicas": n,
               "burn_streak": self.burn_streak,
               "ok_streak": self.ok_streak, "cooldown": self.cooldown}
        self.actions.append(row)
        del self.actions[:-200]
        return row
