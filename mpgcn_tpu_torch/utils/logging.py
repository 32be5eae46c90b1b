"""Structured logging (counterpart of mpgcn_tpu/utils/logging.py).

One JSON record per event. ``JsonlLogger`` is the core: an append-only
JSONL log, optionally size-capped for long-lived writers (the serving
plane's request and reload ledgers, the span log): once a write would
pass ``rotate_max_bytes`` the file is renamed to ``<path>.1`` and
appending restarts, so one rotated generation bounds the disk at about
twice the cap. Every row is also teed into the in-memory flight recorder
(obs/flight.py). ``RunLogger`` is the trainer's run log,
``<output_dir>/<model>_train_log.jsonl``, with the JAX trainer's event
names and fields (``train_start``, ``epoch``, ``dead_init``,
``nan_abort``, ``rollback``, ``early_stop``, ``preempted``,
``train_end``, ``ckpt_corrupt``, ``watchdog_timeout``), so one reader
parses either package's log. The port runs one process, so
``RunLogger`` writes unconditionally (the JAX one writes from process 0
only).
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Optional

from mpgcn_tpu_torch.obs.flight import record_event as _flight_record


def rotated_path(path: str) -> str:
    """Where a size-capped JsonlLogger parks the previous generation."""
    return path + ".1"


class JsonlLogger:
    """Append-only JSONL event log; a no-op when ``path`` is None. A
    write that fails disables the logger with one warning: logging never
    stops a run. ``rotate_max_bytes`` > 0 arms the rotation (module
    docstring); the rename is ``os.replace``, so a reader of either name
    sees a complete file."""

    def __init__(self, path: Optional[str], rotate_max_bytes: int = 0):
        self.path = path
        self.rotate_max_bytes = int(rotate_max_bytes)
        self._t_start = time.time()
        # one logger is written from several threads (batcher workers,
        # HTTP handlers): an unlocked rotation could fire twice and
        # clobber the rotated generation with a near-empty file
        self._lock = threading.Lock()

    def _maybe_rotate(self, incoming: int) -> None:
        if not self.rotate_max_bytes:
            return
        try:
            size = os.path.getsize(self.path)
        except OSError:
            return
        if size + incoming <= self.rotate_max_bytes:
            return
        try:
            os.replace(self.path, rotated_path(self.path))
        except OSError:
            pass  # best effort; the append below still lands

    def _record(self, event: str, fields: dict) -> str:
        rec = {"event": event,
               "t": round(time.time() - self._t_start, 3), **fields}
        try:
            # the flight recorder first: the rows a postmortem needs
            # most are the ones a failing disk is about to drop
            _flight_record(rec)
        except Exception:
            pass
        return json.dumps(rec) + "\n"

    def log(self, event: str, **fields: Any) -> None:
        if self.path:
            self._append(self._record(event, fields))

    def log_many(self, events: list) -> None:
        """Append several ``(event, fields)`` records in one open and
        write (the serving plane's per-request span chain)."""
        if self.path and events:
            self._append("".join(self._record(e, f) for e, f in events))

    def _append(self, data: str) -> None:
        try:
            with self._lock:
                self._maybe_rotate(len(data))
                with open(self.path, "a") as f:
                    f.write(data)
        except OSError as e:
            self.path = None
            print(f"WARNING: run log write failed ({e}); structured "
                  f"logging disabled for the rest of this run.")


#: the trainer's run log (unrotated)
RunLogger = JsonlLogger


def run_log_path(output_dir: str, model: str, enabled: bool) -> Optional[str]:
    if not enabled:
        return None
    os.makedirs(output_dir, exist_ok=True)
    return os.path.join(output_dir, f"{model}_train_log.jsonl")


def read_events(path: str, event: Optional[str] = None,
                rotated: bool = False) -> list[dict]:
    """Every record of a JSONL log (or of one event kind), in order. A torn
    line (the writer does not fsync) is skipped. ``rotated`` also reads
    the previous generation (``<path>.1``) first, oldest first."""
    out = []
    paths = ([rotated_path(path)] if rotated else []) + [path]
    for p in paths:
        if not os.path.exists(p):
            continue
        with open(p) as f:
            for line in f:
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if event is None or rec.get("event") == event:
                    out.append(rec)
    return out
