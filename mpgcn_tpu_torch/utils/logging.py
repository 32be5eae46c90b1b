"""Structured run logging (counterpart of mpgcn_tpu/utils/logging.py).

One JSON record per event in ``<output_dir>/<model>_train_log.jsonl``,
with the JAX trainer's event names and fields (``train_start``,
``epoch``, ``dead_init``, ``nan_abort``, ``rollback``, ``early_stop``,
``preempted``, ``train_end``, ``ckpt_corrupt``, ``watchdog_timeout``), so
one reader parses either package's log. The port runs one process, so
``RunLogger`` writes unconditionally (the JAX one writes from process 0
only); there is no flight recorder and no size-capped rotation.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Optional


class RunLogger:
    """Append-only JSONL event log; a no-op when ``path`` is None. A
    write that fails disables the logger with one warning: logging never
    stops a run."""

    def __init__(self, path: Optional[str]):
        self.path = path
        self._t_start = time.time()
        self._lock = threading.Lock()

    def log(self, event: str, **fields: Any) -> None:
        if not self.path:
            return
        rec = {"event": event,
               "t": round(time.time() - self._t_start, 3), **fields}
        line = json.dumps(rec) + "\n"
        try:
            with self._lock, open(self.path, "a") as f:
                f.write(line)
        except OSError as e:
            self.path = None
            print(f"WARNING: run log write failed ({e}); structured "
                  f"logging disabled for the rest of this run.")


def run_log_path(output_dir: str, model: str, enabled: bool) -> Optional[str]:
    if not enabled:
        return None
    os.makedirs(output_dir, exist_ok=True)
    return os.path.join(output_dir, f"{model}_train_log.jsonl")


def read_events(path: str, event: Optional[str] = None) -> list[dict]:
    """Every record of a JSONL log (or of one event kind), in order. A torn
    final line (the writer does not fsync) is skipped."""
    out = []
    if not os.path.exists(path):
        return out
    with open(path) as f:
        for line in f:
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if event is None or rec.get("event") == event:
                out.append(rec)
    return out
