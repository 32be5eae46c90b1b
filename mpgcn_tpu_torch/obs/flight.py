"""Flight recorder (counterpart of mpgcn_tpu/obs/flight.py): a bounded
in-memory ring of recent telemetry, dumped atomically on the failure
paths.

The ring keeps the last ``capacity`` events (every JsonlLogger row,
through utils/logging.py's tee, and explicit ``record()`` calls) and
dumps them, with a snapshot of every registered metrics provider, as one
atomic JSON file when something ends badly: the serve command's
SIGTERM/SIGINT drain and a sustained SLO burn (obs/perf/slo.py). Stdlib
only and silent on every error: it rides fire paths and must never be
the reason an exit does not happen.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Callable, Optional

from mpgcn_tpu_torch.utils.atomic import atomic_write_bytes

#: default ring capacity: ~enough for the last few epochs of trainer
#: events or a few seconds of serving-plane request rows
DEFAULT_CAPACITY = 512


def flight_path(dir_: str) -> str:
    """Where a plane's postmortem dump lands (beside its emergency
    checkpoint / ledgers)."""
    return os.path.join(dir_, "flight_recorder.json")


class FlightRecorder:
    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self._ring: deque = deque(maxlen=int(capacity))
        self._lock = threading.Lock()
        self._providers: list[tuple[str, Callable[[], dict]]] = []
        self._t_start = time.time()
        self.dumps = 0

    def record(self, kind: str, fields: Optional[dict] = None) -> None:
        """Append one event to the ring (drops the oldest past
        capacity). Cheap enough for hot-ish paths: one lock + one deque
        append; values must already be json-representable scalars."""
        try:
            with self._lock:
                self._ring.append(
                    {"t": round(time.time(), 3), "kind": kind,
                     **(fields or {})})
        except Exception:
            pass

    def add_metrics_provider(self, name: str,
                             fn: Callable[[], dict]) -> None:
        """Register a snapshot callable (e.g. a MetricsRegistry's
        ``snapshot``) whose output is embedded in every dump."""
        with self._lock:
            self._providers = [(n, f) for n, f in self._providers
                               if n != name] + [(name, fn)]

    def payload(self, reason: str) -> dict:
        with self._lock:
            events = list(self._ring)
            providers = list(self._providers)
        metrics: dict[str, dict] = {}
        for name, fn in providers:
            try:
                metrics[name] = fn()
            except Exception as e:
                metrics[name] = {"error": f"{type(e).__name__}: {e}"[:200]}
        # the process default registry is always worth having (program
        # builds, device gauges) even when nobody registered it
        if "default" not in metrics:
            try:
                from mpgcn_tpu_torch.obs.metrics import default_registry

                metrics["default"] = default_registry().snapshot()
            except Exception:
                pass
        return {"reason": reason, "pid": os.getpid(),
                "t_dump": round(time.time(), 3),
                "uptime_s": round(time.time() - self._t_start, 3),
                "n_events": len(events), "metrics": metrics,
                "events": events}

    def dump(self, path: str, reason: str) -> Optional[str]:
        """Write the postmortem atomically (tmp+fsync+replace,
        utils/atomic.py -- it is read after the very crash that
        triggered it). Returns the path, or None on any failure; never
        raises (fire-path discipline)."""
        try:
            body = json.dumps(self.payload(reason), default=str,
                              indent=1).encode()
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            atomic_write_bytes(path, body)
            self.dumps += 1
            return path
        except BaseException:
            return None


# --- process-wide recorder ---------------------------------------------------

RECORDER = FlightRecorder()


def record(kind: str, **fields) -> None:
    RECORDER.record(kind, fields)


def record_event(rec: dict) -> None:
    """The ``utils/logging.JsonlLogger`` tee: every structured log row
    any plane writes also lands in the ring (kind = ``log.<event>``)."""
    RECORDER.record("log." + str(rec.get("event", "?")),
                    {k: v for k, v in rec.items() if k != "event"})


def add_metrics_provider(name: str, fn: Callable[[], dict]) -> None:
    RECORDER.add_metrics_provider(name, fn)


def dump(path: str, reason: str) -> Optional[str]:
    return RECORDER.dump(path, reason)


def dump_to_dir(dir_: Optional[str], reason: str) -> Optional[str]:
    """Convenience for fire paths that only know their output/emergency
    directory; None dir is a silent no-op."""
    if not dir_:
        return None
    return RECORDER.dump(flight_path(dir_), reason)
