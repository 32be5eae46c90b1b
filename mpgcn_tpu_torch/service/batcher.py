"""Dynamic micro-batcher for the serving path (counterpart of
mpgcn_tpu/service/batcher.py).

Concurrent single-window requests coalesce into padded, bucketed batches:

  * a bounded FIFO queue with backpressure: a submit against a full queue
    resolves at once as ``SHED_QUEUE_FULL``;
  * a worker gathers what is queued (waiting at most ``max_wait_ms`` for
    co-travelers once it holds a request), sheds requests whose deadline
    expired (``SHED_DEADLINE``), repeat-pads the survivors -- the last
    row, keys included, never zeros -- to the smallest bucket that fits,
    and hands the batch to ``run_batch``;
  * drain: new submits are rejected (``REJECT_DRAINING``) while every
    queued request is still answered.

The double-buffered feed (``double_buffer``): a stager thread coalesces,
pads and stages batch k+1 while a dispatcher thread runs batch k. One
stager, a handoff of at most one staged batch, and one dispatcher keep
the submission order of the one-thread feed; the dispatcher checks the
deadlines again at execute time, so a batch that waited behind a slow
one sheds its expired tickets instead of answering them late.
``stage_fn(x, keys) -> (x, keys)`` is the optional upload the stager
runs (the serve engine passes one on the card, service/serve.py
``_Stager``). The stager calls it only once the handoff is free, that
is once the batch two before this one has finished, so a ring of two
staging buffers per bucket is never written while a batch still reads
it.

Every ticket resolves exactly once, including when ``run_batch`` raises
(``ERROR_INTERNAL``: the batch's tickets get the error, the worker lives
on). ``run_batch(x, keys, bucket, n_live)`` returns ``(preds, canary)``
(or the preds alone, as a stub may): the only seam to the model, so
tests drive the queueing surface with a stub.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Optional, Sequence

import numpy as np

# typed request outcomes (the wire-visible ``outcome`` field of every
# request ledger row and HTTP answer)
OK = "ok"
SHED_QUEUE_FULL = "shed-queue-full"
SHED_DEADLINE = "shed-deadline"
REJECT_INVALID = "rejected-invalid"
REJECT_DRAINING = "rejected-draining"
ERROR_INTERNAL = "error-internal"
ERROR_NONFINITE = "error-nonfinite"

#: outcomes that mean "deliberately shed under pressure"
SHED_OUTCOMES = (SHED_QUEUE_FULL, SHED_DEADLINE, REJECT_DRAINING)


def pick_bucket(n: int, buckets: Sequence[int]) -> int:
    """Smallest configured bucket that fits ``n`` requests (the caller
    caps ``n`` at buckets[-1]); buckets sorted ascending."""
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


class Ticket:
    """One in-flight request: inputs plus a one-shot result slot. ``wait``
    blocks the submitting thread until the worker resolves it. The trace
    fields (``trace``, ``span``, ``t_wall``) and stage timings
    (``queue_ms``, ``model_ms``, ``batch_seq``) feed the span chain the
    engine emits at resolution."""

    __slots__ = ("x", "key", "deadline", "t_submit", "pred", "outcome",
                 "error", "bucket", "canary", "latency_ms", "_done",
                 "_on_resolve", "t_wall", "trace", "span", "queue_ms",
                 "model_ms", "batch_seq", "tenant", "horizon", "day_slot",
                 "_quota_held", "_breaker_probe")

    def __init__(self, x, key: int, deadline_s: Optional[float] = None,
                 on_resolve: Optional[Callable] = None):
        self.x = x
        self.key = int(key)
        self.t_submit = time.perf_counter()
        self.t_wall = time.time()  # span t0 (epoch seconds)
        self.deadline = (self.t_submit + deadline_s
                         if deadline_s and deadline_s > 0 else None)
        self.pred = None
        self.outcome: Optional[str] = None
        self.error: Optional[str] = None
        self.bucket = 0
        self.canary = False
        self.latency_ms = 0.0
        self.trace: Optional[str] = None
        self.span: Optional[str] = None
        self.queue_ms: Optional[float] = None
        self.model_ms: Optional[float] = None
        self.batch_seq = 0
        self.tenant: Optional[str] = None
        self.horizon: Optional[int] = None
        self.day_slot: Optional[int] = None
        # the fleet's walls (service/fleet.py): a quota slot to release
        # and whether this is the breaker's half-open probe
        self._quota_held = False
        self._breaker_probe = False
        self._done = threading.Event()
        self._on_resolve = on_resolve

    @property
    def expired(self) -> bool:
        return (self.deadline is not None
                and time.perf_counter() > self.deadline)

    def resolve(self, outcome: str, pred=None, error: Optional[str] = None,
                bucket: int = 0, canary: bool = False) -> None:
        if self._done.is_set():  # exactly once
            return
        self.pred = pred
        self.outcome = outcome
        self.error = error
        self.bucket = bucket
        self.canary = canary
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
    """Queue + worker(s) coalescing tickets into bucketed padded batches.

    run_batch(x, keys, bucket, n_live) -> (preds, canary) or preds:
        x (bucket, obs_len, N, N, 1) float32 and keys (bucket,) int32, as
        ``stage_fn`` left them; n_live the real request count; preds the
        host rows (rows past n_live are padding) and whether the canary
        parameters served the batch.
    """

    def __init__(self, run_batch: Callable, buckets: Sequence[int],
                 max_queue: int, max_wait_ms: float = 2.0,
                 double_buffer: bool = False,
                 stage_fn: Optional[Callable] = None):
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
        # one-way latches as Events: the stager and dispatcher read them
        # under another mutex (_staged_cond) than the one that sets them
        self._draining = threading.Event()
        self._stopped = threading.Event()
        self._worker: Optional[threading.Thread] = None
        self.batches_dispatched = 0
        self.double_buffer = bool(double_buffer)
        self.stage_fn = stage_fn
        self._staged: deque = deque()
        self._staged_cond = threading.Condition()
        self._stage_done = False
        self._dispatcher: Optional[threading.Thread] = None

    # --- submit side ----------------------------------------------------

    @property
    def draining(self) -> bool:
        return self._draining.is_set()

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
        # resolve outside the lock: the resolution hook writes ledgers
        ticket.resolve(outcome, error="queue full (load shed)"
                       if outcome == SHED_QUEUE_FULL else "server draining")
        return ticket

    # --- worker side ----------------------------------------------------

    def start(self) -> None:
        if self._worker is not None:
            return
        if self.double_buffer:
            self._worker = threading.Thread(
                target=self._run_stager, daemon=True,
                name="mpgcn-torch-stager")
            self._dispatcher = threading.Thread(
                target=self._run_dispatcher, daemon=True,
                name="mpgcn-torch-dispatch")
            self._worker.start()
            self._dispatcher.start()
            return
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

    def _stage(self, batch: list[Ticket]):
        """Deadline-shed, stack and repeat-pad one batch (the host half of
        a dispatch): (live, x, keys, bucket), or None when every ticket
        shed."""
        live = []
        for t in batch:
            if t.expired:
                t.resolve(SHED_DEADLINE,
                          error=f"deadline budget exhausted after "
                                f"{(time.perf_counter() - t.t_submit) * 1e3:.0f}ms in queue")
            else:
                live.append(t)
        if not live:
            return None
        bucket = pick_bucket(len(live), self.buckets)
        x = np.stack([np.asarray(t.x, np.float32) for t in live])
        keys = np.asarray([t.key for t in live], np.int32)
        if len(live) < bucket:  # repeat-pad to the bucket's fixed shape
            pad = bucket - len(live)
            x = np.concatenate([x, np.repeat(x[-1:], pad, axis=0)])
            keys = np.concatenate([keys, np.repeat(keys[-1:], pad)])
        return live, x, keys, bucket

    def _upload(self, staged):
        """``stage_fn`` on a staged batch; a failed upload resolves the
        batch's tickets as ``ERROR_INTERNAL`` (None) and the worker lives
        on, as for a failed ``run_batch``: nothing runs on the host in
        its place."""
        live, x, keys, bucket = staged
        if self.stage_fn is not None:
            try:
                x, keys = self.stage_fn(x, keys)
            except Exception as e:
                for t in live:
                    t.resolve(ERROR_INTERNAL, bucket=bucket,
                              error=f"staging failed: {type(e).__name__}: "
                                    f"{e}"[:300])
                return None
        return live, x, keys, bucket

    def _execute(self, staged) -> None:
        """Run one staged batch and resolve its tickets (the device half
        of a dispatch)."""
        live, x, keys, bucket = staged
        # deadlines again at execute time: a staged batch can wait behind
        # a slow one (in the serial feed this finds nothing). Shed rows
        # stay in x as dead weight; the delivery loop's second resolve of
        # their tickets is a no-op
        fresh = []
        for t in live:
            if t.expired:
                t.resolve(SHED_DEADLINE,
                          error=f"deadline budget exhausted after "
                                f"{(time.perf_counter() - t.t_submit) * 1e3:.0f}ms staged")
            else:
                fresh.append(t)
        if not fresh:
            return
        self.batches_dispatched += 1
        t_exec = time.perf_counter()
        for t in fresh:
            t.queue_ms = (t_exec - t.t_submit) * 1e3
            t.batch_seq = self.batches_dispatched
        try:
            out = self.run_batch(x, keys, bucket, len(fresh))
        except Exception as e:  # the worker must outlive a bad batch
            for t in live:
                t.resolve(ERROR_INTERNAL, bucket=bucket,
                          error=f"{type(e).__name__}: {e}"[:300])
            return
        preds, canary = out if isinstance(out, tuple) else (out, False)
        model_ms = (time.perf_counter() - t_exec) * 1e3
        for t in fresh:
            t.model_ms = model_ms
        preds = np.asarray(preds)
        for i, t in enumerate(live):
            row = preds[i]
            if not np.all(np.isfinite(row)):
                # the request passed the gate finite: the model failed
                t.resolve(ERROR_NONFINITE, bucket=bucket, canary=canary,
                          error="non-finite prediction")
            else:
                t.resolve(OK, pred=row, bucket=bucket, canary=canary)

    def _dispatch(self, batch: list[Ticket]) -> None:
        staged = self._stage(batch)
        if staged is not None:
            staged = self._upload(staged)
        if staged is not None:
            self._execute(staged)

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

    # --- the double-buffered feed ---------------------------------------

    def _run_stager(self) -> None:
        """Collect and stage batch k+1 while the dispatcher runs batch k;
        the handoff holds at most one staged batch."""
        while True:
            batch = self._collect()
            if batch:
                staged = self._stage(batch)
                if staged is None:
                    continue
                with self._staged_cond:
                    while (len(self._staged) >= 1
                           and not self._stopped.is_set()):
                        self._staged_cond.wait(timeout=0.05)
                if self._stopped.is_set():
                    for t in staged[0]:
                        t.resolve(REJECT_DRAINING, error="server stopped")
                    continue
                # the handoff is free: the batch before the one in
                # flight has finished, so its staging buffer is too
                staged = self._upload(staged)
                if staged is None:
                    continue
                with self._staged_cond:
                    self._staged.append(staged)
                    self._staged_cond.notify_all()
                continue
            with self._lock:
                if self._stopped.is_set() or (self._draining.is_set()
                                              and not self._q):
                    break
        with self._staged_cond:
            self._stage_done = True
            self._staged_cond.notify_all()

    def _run_dispatcher(self) -> None:
        while True:
            with self._staged_cond:
                while (not self._staged and not self._stage_done
                       and not self._stopped.is_set()):
                    self._staged_cond.wait(timeout=0.05)
                if self._staged:
                    staged = self._staged.popleft()
                    self._staged_cond.notify_all()
                elif self._stopped.is_set() or self._stage_done:
                    return
                else:
                    continue
            # stop() resolves what is left once the threads are joined;
            # executing after it would race that
            if self._stopped.is_set():
                for t in staged[0]:
                    t.resolve(REJECT_DRAINING, error="server stopped")
                continue
            self._execute(staged)

    # --- shutdown -------------------------------------------------------

    def drain(self, timeout: Optional[float] = 30.0) -> bool:
        """Reject new submits, answer everything queued (and staged),
        retire the worker(s). True when the queue fully drained within
        ``timeout``."""
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
        if self._dispatcher is not None:
            # the stager's exit sets _stage_done; the dispatcher then
            # finishes what is staged and returns
            self._dispatcher.join(timeout=timeout)
            done = done and not self._dispatcher.is_alive()
            if not self._dispatcher.is_alive():
                self._dispatcher = None
        with self._staged_cond:
            done = done and not self._staged
        return done and self.depth() == 0

    def stop(self) -> None:
        """Hard stop: reject anything still queued or staged, end the
        worker(s)."""
        with self._cond:
            self._stopped.set()
            self._cond.notify_all()
        with self._staged_cond:
            self._staged_cond.notify_all()
        if self._worker is not None:
            self._worker.join(timeout=10.0)
            self._worker = None
        if self._dispatcher is not None:
            self._dispatcher.join(timeout=10.0)
            self._dispatcher = None
        self._reject_remaining()

    def _reject_remaining(self) -> None:
        while True:
            with self._staged_cond:
                staged = self._staged.popleft() if self._staged else None
            if staged is None:
                break
            for t in staged[0]:
                t.resolve(REJECT_DRAINING, error="server stopped")
        while True:
            with self._lock:
                if not self._q:
                    return
                t = self._q.popleft()
            t.resolve(REJECT_DRAINING, error="server stopped")
