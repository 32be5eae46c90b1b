"""Per-tenant fault-domain walls of the serving fleet (counterpart of
mpgcn_tpu/service/tenants.py): one tenant's flood, bad candidate or
failing model degrades to a typed error for that tenant only.

  * ``TenantQuota`` -- the admission bulkhead: a bounded count of
    admitted-but-unresolved requests a tenant may hold; past it the
    tenant sheds with ``SHED_TENANT_QUOTA`` while every other tenant's
    admission is untouched (each tenant also has its own micro-batcher
    queues, service/fleet.py).
  * ``CircuitBreaker`` -- after ``threshold`` consecutive model failures
    (``BREAKER_FAILURE_OUTCOMES``) the breaker OPENS and the tenant's
    requests are rejected at once with ``REJECT_BREAKER_OPEN`` (HTTP 429)
    without touching the device; after ``cooldown_s`` it goes HALF-OPEN
    and admits exactly one probe, whose success closes it and whose
    failure opens it again.

Both are state of the fleet engine that owns them, never of the module:
two fleets in one process share no breaker. The JAX classes take their
locks from its analysis package's ``make_lock``; these take a plain
``threading.Lock``.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

# the typed per-tenant outcomes (the batcher's wire-visible set, extended)
SHED_TENANT_QUOTA = "shed-tenant-quota"
REJECT_BREAKER_OPEN = "rejected-breaker-open"
REJECT_UNKNOWN_TENANT = "rejected-unknown-tenant"
REJECT_TENANT_UNAVAILABLE = "rejected-tenant-unavailable"

#: the outcomes that count as model failures toward a tenant's breaker:
#: sheds and client errors are the tenant's traffic, not its model's
#: health, and never trip it
BREAKER_FAILURE_OUTCOMES = ("error-internal", "error-nonfinite")

# breaker states (the ``serve_breaker_state{tenant=}`` gauge's values)
CLOSED, HALF_OPEN, OPEN = 0, 1, 2
_STATE_NAMES = {CLOSED: "closed", HALF_OPEN: "half-open", OPEN: "open"}


class TenantQuota:
    """Bounded in-flight admission count: ``acquire`` at admission,
    ``release`` at resolution. ``limit <= 0`` admits everything."""

    def __init__(self, limit: int):
        self.limit = int(limit)
        self._lock = threading.Lock()
        self._inflight = 0
        self.shed = 0  # quota sheds so far

    @property
    def inflight(self) -> int:
        with self._lock:
            return self._inflight

    def acquire(self) -> bool:
        with self._lock:
            if self.limit > 0 and self._inflight >= self.limit:
                self.shed += 1
                return False
            self._inflight += 1
            return True

    def release(self) -> None:
        with self._lock:
            # a release without an acquire is clamped: the quota fails
            # open rather than keep a lowered limit for good
            self._inflight = max(0, self._inflight - 1)


class CircuitBreaker:
    """Consecutive-failure breaker with a half-open probe. ``allow()``
    gates admission and says whether the admitted request is the probe;
    the caller reports the probe's fate through ``probe_result`` /
    ``probe_abort`` and every other resolution through ``record``.
    ``threshold <= 0`` turns it off.

    The probe is the ticket ``allow`` named, not the next to resolve:
    requests admitted before the trip may still resolve while the
    breaker is open or half-open, and ``record`` counts only in CLOSED.
    A probe that ends without a model verdict (invalid, shed, drained)
    aborts back to HALF_OPEN so the next request can probe.

    ``clock``: the time source (tests drive the cooldown with a fake one);
    ``on_transition(state)`` runs after each change, outside the lock."""

    def __init__(self, threshold: int, cooldown_s: float,
                 clock: Callable[[], float] = time.monotonic,
                 on_transition: Optional[Callable[[int], None]] = None):
        self.threshold = int(threshold)
        self.cooldown_s = float(cooldown_s)
        self._clock = clock
        self._on_transition = on_transition
        self._lock = threading.Lock()
        self._state = CLOSED
        self._consecutive = 0
        self._opened_at = 0.0
        self._probe_inflight = False
        self.trips = 0  # transitions to OPEN so far

    @property
    def state(self) -> int:
        with self._lock:
            return self._state

    @property
    def state_name(self) -> str:
        return _STATE_NAMES[self.state]

    def _notify(self, state: Optional[int]) -> None:
        if state is not None and self._on_transition is not None:
            self._on_transition(state)

    def allow(self) -> tuple:
        """(admitted, is_probe) for a request arriving now."""
        if self.threshold <= 0:
            return True, False
        notify = None
        with self._lock:
            if self._state == CLOSED:
                return True, False
            if self._state == OPEN:
                if self._clock() - self._opened_at < self.cooldown_s:
                    return False, False
                # the cooldown has passed: half-open, one probe
                self._state = HALF_OPEN
                self._probe_inflight = True
                notify = HALF_OPEN
                out = True
            else:  # HALF_OPEN: one probe at a time
                out = not self._probe_inflight
                if out:
                    self._probe_inflight = True
        self._notify(notify)
        return out, out

    def probe_result(self, ok: bool) -> None:
        """The probe's model verdict: close on success, open on failure."""
        if self.threshold <= 0:
            return
        with self._lock:
            if self._state != HALF_OPEN:
                return  # a stale probe
            self._probe_inflight = False
            if ok:
                self._state = CLOSED
                self._consecutive = 0
                notify = CLOSED
            else:
                self._state = OPEN
                self._opened_at = self._clock()
                self.trips += 1
                notify = OPEN
        self._notify(notify)

    def probe_abort(self) -> None:
        """The probe ended without a model verdict: free the token, state
        unchanged."""
        with self._lock:
            if self._state == HALF_OPEN:
                self._probe_inflight = False

    def record(self, ok: bool) -> None:
        """One non-probe model verdict (the caller filters outcomes with
        ``BREAKER_FAILURE_OUTCOMES``); counted only in CLOSED."""
        if self.threshold <= 0:
            return
        notify = None
        with self._lock:
            if self._state != CLOSED:
                return
            if ok:
                self._consecutive = 0
            else:
                self._consecutive += 1
                if self._consecutive >= self.threshold:
                    self._state = OPEN
                    self._opened_at = self._clock()
                    self.trips += 1
                    notify = OPEN
        self._notify(notify)
