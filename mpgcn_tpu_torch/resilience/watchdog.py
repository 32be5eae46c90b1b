"""Host-side hang watchdog (counterpart of mpgcn_tpu/resilience/watchdog.py,
single process: no collective sections).

A wedged kernel or driver call never returns to the epoch loop, so the
loop cannot notice it. The watchdog is a daemon thread watching a
heartbeat the loop strokes; when no beat lands within the deadline it

  1. dumps every thread's stack to stderr (``faulthandler``, which works
     while the main thread is stuck inside a C call),
  2. writes an emergency checkpoint from the last host copy of the
     training state, never touching the card (it may be what hung),
  3. exits with ``WATCHDOG_EXIT_CODE`` (113), so launch tooling can tell
     "hung, state resumable" from a crash (1) or a clean preemption (0).

``on_timeout`` replaces the exit, so tests can fire it in process.
"""

from __future__ import annotations

import faulthandler
import os
import sys
import threading
import time
from typing import Callable, Optional

from mpgcn_tpu_torch.utils.atomic import atomic_pickle_dump

#: exit status of a run whose watchdog deadline expired
WATCHDOG_EXIT_CODE = 113


def _assert_host_tree(payload) -> None:
    """Leaves must be host data: a torch tensor (on the card, or one that
    still shares memory with a card-side copy) is rejected at update
    time, while the card is healthy, not found at fire time."""
    stack = [payload]
    while stack:
        x = stack.pop()
        if isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
        elif type(x).__module__.startswith("torch"):
            raise TypeError(
                f"emergency state leaf {type(x).__name__} is a torch "
                f"object; copy it to numpy before update_state (the "
                f"watchdog's fire path must not touch the card)")


class HangWatchdog:
    """Heartbeat watchdog with a host-state emergency checkpoint.

    deadline_s:     seconds without a ``beat()`` before firing; must exceed
                    the longest healthy gap between beats (an epoch on the
                    scan executor, a step per step).
    emergency_path: where the fire path pickles the last host state.
    on_timeout:     replaces the exit (tests)."""

    def __init__(self, deadline_s: float,
                 emergency_path: Optional[str] = None, logger=None,
                 on_timeout: Optional[Callable[[], None]] = None,
                 poll_s: Optional[float] = None):
        if deadline_s <= 0:
            raise ValueError(f"watchdog deadline_s={deadline_s} must be > 0")
        self.deadline_s = float(deadline_s)
        self.logger = logger
        self.on_timeout = on_timeout
        self.poll_s = poll_s if poll_s is not None else min(
            1.0, self.deadline_s / 5.0)
        self._last = time.monotonic()
        self.emergency_path = emergency_path
        self._lock = threading.Lock()
        self._state: Optional[dict] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.fired = False
        self.fire_code: Optional[int] = None

    def beat(self) -> None:
        self._last = time.monotonic()

    def update_state(self, payload: dict) -> None:
        """Record the last known-good state, a checkpoint payload of host
        data (train/checkpoint.py ``checkpoint_payload``); also a beat."""
        _assert_host_tree(payload)
        with self._lock:
            self._state = payload
        self.beat()

    def start(self) -> "HangWatchdog":
        self._thread = threading.Thread(
            target=self._run, name="mpgcn-hang-watchdog", daemon=True)
        self.beat()
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def _run(self) -> None:
        while not self._stop.wait(self.poll_s):
            if time.monotonic() - self._last > self.deadline_s:
                self._fire()
                return

    def _write_state(self) -> Optional[str]:
        with self._lock:
            state = self._state
        if state is None or self.emergency_path is None:
            return None
        try:
            return atomic_pickle_dump(self.emergency_path, state)
        except Exception as e:  # the fire path itself must never wedge
            os.write(2, f"watchdog: emergency checkpoint write failed: "
                        f"{e}\n".encode())
            return None

    def _fire(self) -> None:
        # every step before the exit is best-effort: the exit must happen
        # whatever a diagnostic raises
        self.fired = True
        code = self.fire_code = WATCHDOG_EXIT_CODE
        if self.on_timeout is None:
            # bound the whole fire path: a write to a dead mount can block
            # without raising
            backstop = threading.Timer(10.0, lambda: os._exit(code))
            backstop.daemon = True
            backstop.start()
        try:
            os.write(2, (f"\n=== HANG WATCHDOG: no heartbeat for "
                         f"{self.deadline_s:.1f}s -- dumping all thread "
                         f"stacks, writing emergency checkpoint, exiting "
                         f"{code} ===\n").encode())
            faulthandler.dump_traceback(file=sys.stderr, all_threads=True)
        except BaseException:
            pass
        path = None
        try:
            path = self._write_state()
            if path:
                os.write(2, f"watchdog: emergency checkpoint (last good "
                            f"host state) written to {path}\n".encode())
        except BaseException:
            pass
        try:
            if self.logger is not None:
                self.logger.log("watchdog_timeout",
                                deadline_s=self.deadline_s, collective="",
                                emergency=path or "")
        except BaseException:
            pass
        if self.on_timeout is not None:
            self.on_timeout()
            return
        os._exit(code)
