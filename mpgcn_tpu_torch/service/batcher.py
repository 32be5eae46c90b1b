"""Dynamic micro-batcher for the serving path (counterpart of the
single-thread feed of mpgcn_tpu/service/batcher.py).

Concurrent single-window requests coalesce into padded, bucketed batches:

  * a bounded FIFO queue with backpressure: a submit against a full queue
    resolves at once as ``SHED_QUEUE_FULL``;
  * one worker gathers what is queued (waiting at most ``max_wait_ms`` for
    co-travelers once it holds a request), sheds requests whose deadline
    expired (``SHED_DEADLINE``), repeat-pads the survivors -- the last
    row, keys included, never zeros -- to the smallest bucket that fits,
    and hands the batch to ``run_batch``;
  * drain: new submits are rejected (``REJECT_DRAINING``) while every
    queued request is still answered.

Every ticket resolves exactly once, including when ``run_batch`` raises
(``ERROR_INTERNAL``: the batch's tickets get the error, the worker lives
on). ``run_batch(x, keys, bucket, n_live) -> preds`` is the only
seam to the model, so tests drive the queueing surface with a stub.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Optional, Sequence

import numpy as np

OK = "ok"
SHED_QUEUE_FULL = "shed-queue-full"
SHED_DEADLINE = "shed-deadline"
REJECT_INVALID = "rejected-invalid"
REJECT_DRAINING = "rejected-draining"
ERROR_INTERNAL = "error-internal"
ERROR_NONFINITE = "error-nonfinite"


def pick_bucket(n: int, buckets: Sequence[int]) -> int:
    """Smallest configured bucket that fits ``n`` requests (the caller
    caps ``n`` at buckets[-1]); buckets sorted ascending."""
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


class Ticket:
    """One in-flight request: inputs plus a one-shot result slot. ``wait``
    blocks the submitting thread until the worker resolves it."""

    __slots__ = ("x", "key", "deadline", "t_submit", "pred", "outcome",
                 "error", "bucket", "latency_ms", "_done", "_on_resolve")

    def __init__(self, x, key: int, deadline_s: Optional[float] = None,
                 on_resolve: Optional[Callable] = None):
        self.x = x
        self.key = int(key)
        self.t_submit = time.perf_counter()
        self.deadline = (self.t_submit + deadline_s
                         if deadline_s and deadline_s > 0 else None)
        self.pred = None
        self.outcome: Optional[str] = None
        self.error: Optional[str] = None
        self.bucket = 0
        self.latency_ms = 0.0
        self._done = threading.Event()
        self._on_resolve = on_resolve

    @property
    def expired(self) -> bool:
        return (self.deadline is not None
                and time.perf_counter() > self.deadline)

    def resolve(self, outcome: str, pred=None, error: Optional[str] = None,
                bucket: int = 0) -> None:
        if self._done.is_set():  # exactly once
            return
        self.pred = pred
        self.outcome = outcome
        self.error = error
        self.bucket = bucket
        self.latency_ms = (time.perf_counter() - self.t_submit) * 1e3
        self._done.set()
        if self._on_resolve is not None:
            self._on_resolve(self)

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._done.wait(timeout)

    @property
    def ok(self) -> bool:
        return self.outcome == OK


class MicroBatcher:
    """Queue + worker coalescing tickets into bucketed padded batches."""

    def __init__(self, run_batch: Callable, buckets: Sequence[int],
                 max_queue: int, max_wait_ms: float = 2.0):
        if not buckets or list(buckets) != sorted(set(int(b)
                                                      for b in buckets)):
            raise ValueError(
                f"buckets {buckets!r} must be sorted unique positive ints")
        if buckets[0] < 1:
            raise ValueError(f"buckets {buckets!r} must be >= 1")
        if max_queue < 1:
            raise ValueError(f"max_queue={max_queue} must be >= 1")
        self.run_batch = run_batch
        self.buckets = tuple(int(b) for b in buckets)
        self.max_queue = int(max_queue)
        self.max_wait_s = max(0.0, float(max_wait_ms)) / 1e3
        self._q: deque[Ticket] = deque()
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._draining = threading.Event()
        self._stopped = threading.Event()
        self._worker: Optional[threading.Thread] = None
        self.batches_dispatched = 0

    def depth(self) -> int:
        with self._lock:
            return len(self._q)

    def submit(self, ticket: Ticket) -> Ticket:
        """Enqueue or shed; a shed ticket is already resolved on return."""
        with self._cond:
            if self._draining.is_set() or self._stopped.is_set():
                outcome = REJECT_DRAINING
            elif len(self._q) >= self.max_queue:
                outcome = SHED_QUEUE_FULL
            else:
                self._q.append(ticket)
                self._cond.notify()
                return ticket
        ticket.resolve(outcome, error="queue full (load shed)"
                       if outcome == SHED_QUEUE_FULL else "server draining")
        return ticket

    def start(self) -> None:
        if self._worker is None:
            self._worker = threading.Thread(target=self._run, daemon=True,
                                            name="mpgcn-torch-batcher")
            self._worker.start()

    def _collect(self) -> list[Ticket]:
        """Block for the first ticket, then give co-travelers up to
        max_wait_s (early-out once the largest bucket is full)."""
        cap = self.buckets[-1]
        with self._cond:
            while not self._q and not self._stopped.is_set():
                if self._draining.is_set():
                    return []
                self._cond.wait(timeout=0.05)
            if self._stopped.is_set() and not self._q:
                return []
            t_first = time.perf_counter()
            while (len(self._q) < cap and not self._draining.is_set()
                   and not self._stopped.is_set()):
                left = self.max_wait_s - (time.perf_counter() - t_first)
                if left <= 0:
                    break
                self._cond.wait(timeout=left)
            return [self._q.popleft()
                    for _ in range(min(cap, len(self._q)))]

    def _dispatch(self, batch: list[Ticket]) -> None:
        live = []
        for t in batch:
            if t.expired:
                t.resolve(SHED_DEADLINE,
                          error=f"deadline budget exhausted after "
                                f"{(time.perf_counter() - t.t_submit) * 1e3:.0f}ms in queue")
            else:
                live.append(t)
        if not live:
            return
        bucket = pick_bucket(len(live), self.buckets)
        x = np.stack([np.asarray(t.x, np.float32) for t in live])
        keys = np.asarray([t.key for t in live], np.int32)
        if len(live) < bucket:  # repeat-pad to the bucket's fixed shape
            pad = bucket - len(live)
            x = np.concatenate([x, np.repeat(x[-1:], pad, axis=0)])
            keys = np.concatenate([keys, np.repeat(keys[-1:], pad)])
        self.batches_dispatched += 1
        try:
            preds = self.run_batch(x, keys, bucket, len(live))
        except Exception as e:  # the worker must outlive a bad batch
            for t in live:
                t.resolve(ERROR_INTERNAL, bucket=bucket,
                          error=f"{type(e).__name__}: {e}"[:300])
            return
        preds = np.asarray(preds)
        for i, t in enumerate(live):
            row = preds[i]
            if not np.all(np.isfinite(row)):
                t.resolve(ERROR_NONFINITE, bucket=bucket,
                          error="non-finite prediction")
            else:
                t.resolve(OK, pred=row, bucket=bucket)

    def _run(self) -> None:
        while True:
            batch = self._collect()
            if batch:
                self._dispatch(batch)
                continue
            with self._lock:
                if self._stopped.is_set() or (self._draining.is_set()
                                              and not self._q):
                    return

    def drain(self, timeout: Optional[float] = 30.0) -> bool:
        """Reject new submits, answer everything queued, retire the
        worker. True when the queue fully drained within ``timeout``."""
        with self._cond:
            self._draining.set()
            self._cond.notify_all()
        if self._worker is None:
            self._reject_remaining()
            return True
        self._worker.join(timeout=timeout)
        done = not self._worker.is_alive()
        if done:
            self._worker = None
        return done and self.depth() == 0

    def stop(self) -> None:
        """Hard stop: reject anything still queued, end the worker."""
        with self._cond:
            self._stopped.set()
            self._cond.notify_all()
        if self._worker is not None:
            self._worker.join(timeout=10.0)
            self._worker = None
        self._reject_remaining()

    def _reject_remaining(self) -> None:
        while True:
            with self._lock:
                if not self._q:
                    return
                t = self._q.popleft()
            t.resolve(REJECT_DRAINING, error="server stopped")
