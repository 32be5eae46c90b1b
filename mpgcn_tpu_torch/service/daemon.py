"""``python -m mpgcn_tpu_torch.cli daemon``: the continual-learning loop
(counterpart of mpgcn_tpu/service/daemon.py).

OD flow arrives a day at a time (one (N, N) snapshot per day slot); this
long-lived process keeps a served model fresh without letting a bad day
or a failed retrain degrade it:

  1. ingest: day files landing in the spool pass the day gate
     (service/ingest.py); a failing day is moved to ``quarantine/`` with
     a jsonl verdict and never trained on;
  2. drift: the incumbent is scored on the held-out recent-days split
     every ingest cycle, and the windowed trend plus the last retrain's
     sentinel and spike counters (service/drift.py) can start a retrain
     ahead of the day-count cadence;
  3. retrain: a warm-started ``ModelTrainer`` (its executors and CUDA
     graphs as they are) over the newest ``window_days`` accepted days,
     fed by a pipeline whose gathers retry and name their day files;
  4. eval before promote: the candidate must beat or tie the incumbent
     within ``promote_tolerance`` on the held-out split before an atomic
     install into the ``promoted/`` slot (service/promote.py); rejected
     candidates are kept, every verdict is a row of the promotion ledger.

A retrain crash, poisoned data or an eval regression each leave the
promoted checkpoint untouched and the daemon alive. A SIGKILL mid-retrain
is the supervisor's (resilience/supervisor.py): run the daemon under
``python -m mpgcn_tpu_torch.cli supervise --procs 1 -- daemon ...`` and
every piece of loop state (ingest lists, retrain attempt counter, drift
history, capture watermark) is on disk as atomic json, so the relaunched
daemon resumes where the dead one stopped.

Every trainer the loop makes (a retrain, each drift evaluation) is
closed after use (``ModelTrainer.close``): its CUDA graphs and their pool
go with it, so device memory does not grow from retrain to retrain.
``retrain_done`` carries the metrics snapshot of the default registry,
with ``cuda_program_builds`` (graph captures and kernel library builds)
and, for the attempt, the kernels' launches
(``daemon_retrain_launches``), its steps by kind
(``daemon_retrain_steps``: train, eval, rollout forwards) and the bytes
the caching allocator holds once its trainer and window are released
(``daemon_device_bytes_reserved``: on the card the cuBLAS workspaces of
the streams the retrains ran on, the same after every retrain).

The daemon runs on the card (``--device cuda``, the default) and refuses
to start without one unless ``--device cpu`` asks for the plain PyTorch
versions of the kernels. The command's operator flags: ``--profile NAME``
takes ``-obs``, ``-pred``, ``-seed`` and ``--nodes`` from a scenario
profile (scenarios/profiles.py); ``--compile-cache DIR`` is the
kernel-library directory (obs/perf/compile_cache.py); ``-trace DIR``
records the session in a ``torch.profiler`` window, the retrain steps
annotated (utils/profiling.py); ``--metrics-port P`` serves the default
registry's ``/metrics`` (obs/metrics.py ``MetricsServer``).
"""

from __future__ import annotations

import argparse
import bisect
import io
import json
import math
import os
import shutil
import time
import traceback

import numpy as np

from mpgcn_tpu_torch.config import DaemonConfig
from mpgcn_tpu_torch.obs import flight
from mpgcn_tpu_torch.obs.metrics import default_registry
from mpgcn_tpu_torch.obs.trace import SpanLog, new_trace_id, spans_path
from mpgcn_tpu_torch.resilience.faults import FaultPlan
from mpgcn_tpu_torch.service.capture import (
    TrafficCapture,
    default_capture_state,
)
from mpgcn_tpu_torch.service.drift import DriftDetector
from mpgcn_tpu_torch.service.ingest import (
    KIND_HELD,
    KIND_SHOCK,
    DayProfile,
    RobustProfile,
    classify_day,
    day_filename,
    parse_day_index,
)
from mpgcn_tpu_torch.service.promote import (
    PromotionGate,
    candidate_hash,
    evaluate_params,
    ledger_path,
    poison_checkpoint,
    promote_checkpoint,
    promoted_path,
    rejected_path,
)
from mpgcn_tpu_torch.utils.atomic import atomic_write_bytes
from mpgcn_tpu_torch.utils.logging import JsonlLogger, read_events, run_log_path
from mpgcn_tpu_torch.utils.retry import read_with_retry


def daemon_log_path(output_dir: str) -> str:
    return os.path.join(output_dir, "daemon_log.jsonl")


def state_path(output_dir: str) -> str:
    return os.path.join(output_dir, "daemon_state.json")


def verdicts_path(output_dir: str) -> str:
    return os.path.join(output_dir, "quarantine", "verdicts.jsonl")


def pattern_path(output_dir: str) -> str:
    """The robust profile's (N, N) reference pattern: an atomic npy beside
    daemon_state.json (a dense array does not belong in the json)."""
    return os.path.join(output_dir, "profile_pattern.npy")


def window_split_ratio(T: int, obs_len: int, pred_len: int,
                       val_days: int, holdout_days: int) -> tuple:
    """split_ratio for a T-day window that realizes exactly the requested
    counts: the trailing ``holdout_days`` windows are the held-out
    ('test') split, ``val_days`` windows before them validate, the rest
    train. ``split_lengths`` truncates ``r / total * n``, which can land
    one ulp below the integer, so the ratio biases validate and test up
    by a quarter window and the realized split is checked before it is
    returned."""
    from mpgcn_tpu_torch.data.windows import split_lengths

    nwin = T - obs_len - pred_len  # drop_last_window semantics
    train_n = nwin - val_days - holdout_days
    if train_n < 1:
        raise ValueError(
            f"window of {T} days yields {nwin} windows -- not enough for "
            f"val={val_days} + holdout={holdout_days} + >=1 train window")
    ratio = (train_n - 0.5, val_days + 0.25, holdout_days + 0.25)
    lens = split_lengths(nwin, ratio)
    if (lens["train"], lens["validate"], lens["test"]) != (
            train_n, val_days, holdout_days):
        raise AssertionError(
            f"window_split_ratio({T}, {obs_len}, {pred_len}, {val_days}, "
            f"{holdout_days}) realized {lens} instead of the requested "
            f"({train_n}, {val_days}, {holdout_days}) windows")
    return ratio


def kernel_launches() -> dict:
    """Every launch-counted kernel entry's count, by symbol (0 on the CPU,
    where the wrappers run their plain versions)."""
    from mpgcn_tpu_torch.nn import cuda_bdgcn, cuda_lstm
    from mpgcn_tpu_torch.native.build import CudaKernel
    from mpgcn_tpu_torch.sparse import cuda_ell

    out = {}
    for mod in (cuda_lstm, cuda_bdgcn, cuda_ell):
        for v in vars(mod).values():
            if isinstance(v, CudaKernel):
                out[v.symbol] = v.launches
    return out


class ContinualDaemon:
    def __init__(self, dcfg: DaemonConfig, tcfg, device="cuda"):
        from mpgcn_tpu_torch.device import resolve_device

        self.dcfg = dcfg
        self.tcfg = tcfg  # the MPGCNConfig template of the retrains
        self.device = resolve_device(device)
        out = dcfg.output_dir
        self.accepted_dir = os.path.join(out, "accepted")
        self.quarantine_dir = os.path.join(out, "quarantine")
        self.retrain_base = os.path.join(out, "retrain")
        for d in (out, dcfg.spool_dir, self.accepted_dir,
                  self.quarantine_dir, os.path.join(out, "rejected")):
            os.makedirs(d, exist_ok=True)
        self.log = JsonlLogger(daemon_log_path(out))
        self.ledger = JsonlLogger(ledger_path(out))
        self.verdicts = JsonlLogger(verdicts_path(out))
        os.makedirs(os.path.dirname(ledger_path(out)), exist_ok=True)
        # the day chain: an accepted day's ingest span is the parent of
        # the retrain and promote spans; the gate row carries the ids to
        # serve's reload span through the span log both processes share
        self.spans = SpanLog(spans_path(out))
        reg = default_registry()
        self._m_days = reg.counter(
            "daemon_days", "ingested days by gate verdict")
        self._m_retrains = reg.counter(
            "daemon_retrains", "retrain attempts by outcome")
        self._m_capture = reg.counter(
            "daemon_capture", "traffic-capture events by kind")
        self._m_capture_lag = reg.gauge(
            "daemon_capture_lag_days",
            "captured days seen but not yet spooled")
        self._m_launches = reg.gauge(
            "daemon_retrain_launches",
            "kernel launches of the last retrain attempt, by kernel")
        self._m_steps = reg.gauge(
            "daemon_retrain_steps",
            "steps of the last retrain attempt, by kind")
        self._m_reserved = reg.gauge(
            "daemon_device_bytes_reserved",
            "bytes the caching allocator holds after the last retrain's "
            "trainer and window were released (torch.cuda.memory_reserved "
            "after empty_cache; 0 on the CPU)")
        # traffic capture: the serving plane's request ledger stitched
        # into spool day files before each ingest pass; the watermark
        # rides daemon_state.json
        self.capture = None
        if dcfg.capture_ledger:
            self.capture = TrafficCapture(
                dcfg.capture_ledger, dcfg.spool_dir,
                os.path.join(out, "capture_staging"),
                tenant=dcfg.capture_tenant, num_nodes=dcfg.num_nodes)
        self._faults = FaultPlan.from_config(tcfg)
        self._day_cache: dict[int, np.ndarray] = {}
        self._adj = None
        self._stop = False
        self._load_state()
        self._reconcile_day_dirs()

    # --- persisted loop state (atomic json) -------------------------------

    def _load_state(self):
        s = {}
        path = state_path(self.dcfg.output_dir)
        if os.path.exists(path):
            with open(path) as f:
                s = json.load(f)
        self.ingested = int(s.get("ingested", 0))
        self.accepted = [int(i) for i in s.get("accepted", [])]
        self.quarantined = [int(i) for i in s.get("quarantined", [])]
        self.retrain_attempts = int(s.get("retrain_attempts", 0))
        self.retrains_done = int(s.get("retrains_done", 0))
        self.accepted_at_last_retrain = int(
            s.get("accepted_at_last_retrain", 0))
        self.accepted_at_last_failure = int(
            s.get("accepted_at_last_failure", -1))
        self.num_nodes = int(s.get("num_nodes", self.dcfg.num_nodes))
        # day -> (trace id, ingest span id), so a relaunched daemon's
        # retrain still joins the chain the dead one started
        self.day_spans = {int(k): tuple(v) for k, v in
                          s.get("day_spans", {}).items()}
        self.profile = DayProfile.from_state(s.get("profile"))
        self.rprofile = RobustProfile.from_state(
            s.get("robust_profile"), maxlen=self.dcfg.robust_window)
        ppath = pattern_path(self.dcfg.output_dir)
        if os.path.exists(ppath):
            try:
                self.rprofile.pattern = np.load(ppath, allow_pickle=False)
            except Exception:
                # a torn pattern re-warms from the stream; it must never
                # crash a supervised relaunch
                self.rprofile.pattern = None
                self.rprofile.pattern_count = 0
        # quarantined days eligible for re-classification once the robust
        # pattern arms (kind "held": an outlier before history)
        self.held = [int(i) for i in s.get("held", [])]
        self.capture_state = s.get("capture") or default_capture_state()
        self.detector = DriftDetector(
            self.dcfg.drift_window, self.dcfg.drift_threshold,
            skip_budget=self.dcfg.drift_skip_budget,
            spike_budget=self.dcfg.drift_spike_budget)
        self.detector.load_state(s.get("drift"))

    def _save_state(self):
        s = {"ingested": self.ingested, "accepted": self.accepted,
             "quarantined": self.quarantined,
             "retrain_attempts": self.retrain_attempts,
             "retrains_done": self.retrains_done,
             "accepted_at_last_retrain": self.accepted_at_last_retrain,
             "accepted_at_last_failure": self.accepted_at_last_failure,
             "num_nodes": self.num_nodes,
             "day_spans": {str(k): list(v) for k, v in
                           sorted(self.day_spans.items())
                           [-self.dcfg.window_days:]},
             "profile": self.profile.state(),
             "robust_profile": self.rprofile.state(),
             "held": self.held,
             "capture": self.capture_state,
             "drift": self.detector.state()}
        atomic_write_bytes(state_path(self.dcfg.output_dir),
                           json.dumps(s, indent=1).encode())

    def _save_pattern(self):
        """The robust profile's reference pattern, as an atomic npy beside
        the state file (``_load_state`` reads it back)."""
        if self.rprofile.pattern is None:
            return
        buf = io.BytesIO()
        np.save(buf, self.rprofile.pattern)
        atomic_write_bytes(pattern_path(self.dcfg.output_dir),
                           buf.getvalue())

    def _reconcile_day_dirs(self):
        """accepted/ and quarantine/ are the source of truth for a day's
        membership: a day file moves there only after its verdict, so a
        kill between the move and the state save leaves a judged day on
        disk but missing from the lists. Fold such days back in at
        startup, or they would never be trained on, profiled or retried
        (they are no longer in the spool)."""
        changed = False
        for d, lst in ((self.accepted_dir, self.accepted),
                       (self.quarantine_dir, self.quarantined)):
            have = set(lst)
            for name in sorted(os.listdir(d)):
                idx = parse_day_index(name)
                if idx is None or idx in have:
                    continue
                changed = True
                self.ingested += 1
                if d == self.accepted_dir:
                    try:
                        arr = self._read_day(os.path.join(d, name))
                    except Exception as e:
                        # an unreadable file degrades to quarantine: a
                        # supervised daemon must not crash-loop on it
                        _move(os.path.join(d, name),
                              os.path.join(self.quarantine_dir, name))
                        self.quarantined.append(idx)
                        self.verdicts.log(
                            "quarantine", day=idx, ok=False,
                            reason=f"unreadable at reconcile: "
                                   f"{type(e).__name__}: {e}"[:300])
                        self.log.log("day_quarantined", day=idx,
                                     reason="unreadable at reconcile")
                        continue
                    if self.num_nodes == 0:
                        self.num_nodes = int(arr.shape[0])
                    self.profile.observe(math.log1p(float(arr.sum())))
                    self.rprofile.observe(math.log1p(float(arr.sum())),
                                          arr)
                lst.append(idx)
                self.log.log("day_reconciled", day=idx,
                             kind=os.path.basename(d))
        if changed:
            self.accepted.sort()
            self.quarantined.sort()
            self._save_pattern()
            self._save_state()

    # --- ingestion --------------------------------------------------------

    def _capture_poll(self) -> int:
        """One traffic-capture pass (a no-op with capture off): new request
        rows into spool day files, the watermark advanced and persisted,
        the capture counters and lag gauge fed. Returns the day files
        emitted into the spool."""
        if self.capture is None:
            return 0
        before = dict(self.capture_state)
        emitted = self.capture.poll(self.capture_state)
        for key in ("rows", "malformed", "late", "gaps"):
            delta = self.capture_state[key] - before[key]
            if delta:
                self._m_capture.labels(kind=key).inc(delta)
        if emitted:
            self._m_capture.labels(kind="days").inc(len(emitted))
            self.log.log("capture", days=emitted,
                         rows=self.capture_state["rows"],
                         last_emitted=self.capture_state["last_emitted"])
        self._m_capture_lag.set(self.capture.lag_days(self.capture_state))
        if self.capture_state != before:
            self._save_state()  # the watermark moved: a relaunch must
            #                     neither re-ingest nor skip these rows
        return len(emitted)

    def _classify(self, arr, idx: int) -> dict:
        """The shock-vs-poison gate over one day: the robust median/MAD
        profile and the structure test against the accepted pattern and
        the adjacency's support."""
        adj = None
        a = np.asarray(arr)
        if (a.ndim == 2 and a.shape[0] == a.shape[1]
                and a.dtype.kind in "fiu"
                and self.num_nodes in (0, a.shape[0])):
            try:
                adj = self._adjacency(int(a.shape[0]))
            except Exception:
                adj = None  # the structure test falls back to the pattern
        return classify_day(
            arr, self.num_nodes, self.rprofile,
            zmax=self.dcfg.profile_zmax,
            min_history=self.dcfg.profile_min_history,
            coherence_min=self.dcfg.shock_coherence,
            off_support_max=self.dcfg.shock_support_max,
            adjacency=adj)

    def _accept_day(self, idx: int, src: str, verdict: dict, arr,
                    reclassified: bool = False):
        """The accept path of ``_ingest`` and ``_revisit_held``: the day
        file into accepted/, into both profiles, and into the rolling
        window in temporal order (a delayed day cannot scramble the
        holdout split)."""
        if self.num_nodes == 0:
            self.num_nodes = int(verdict["shape"][0])
        _move(src, os.path.join(self.accepted_dir, day_filename(idx)))
        self.profile.observe(math.log1p(verdict["total_flow"]))
        self.rprofile.observe(math.log1p(verdict["total_flow"]), arr)
        self._save_pattern()
        bisect.insort(self.accepted, idx)
        label = "reclassified" if reclassified else "accepted"
        self._m_days.labels(verdict=label).inc()
        kind = verdict.get("kind")
        if kind == KIND_SHOCK:
            self._m_days.labels(verdict=KIND_SHOCK).inc()
            print(f"[daemon] EVENT SHOCK day {idx} accepted: coherent "
                  f"structure at z={verdict.get('z_total')} -- trains",
                  flush=True)
        trace = new_trace_id()
        span = self.spans.emit(
            "daemon.ingest", trace, day=idx, verdict=label, kind=kind,
            total_flow=round(verdict["total_flow"], 3))
        self.day_spans[idx] = (trace, span)
        self.log.log("day_reclassified" if reclassified else
                     "day_accepted", day=idx, kind=kind,
                     total_flow=verdict["total_flow"],
                     accepted=len(self.accepted), trace=trace)

    def _revisit_held(self) -> int:
        """Re-classify days held (a total-flow outlier before the pattern
        armed) once the robust profile has armed: an event shock re-enters
        the window in temporal order, a day the armed structure test
        calls poison stays quarantined. Returns the days cleared."""
        if not self.held or not self.rprofile.pattern_armed(
                self.dcfg.profile_min_history):
            return 0
        cleared = 0
        for idx in list(self.held):
            path = os.path.join(self.quarantine_dir, day_filename(idx))
            try:
                arr = self._read_day(path)
            except Exception as e:
                self.held.remove(idx)  # unreadable evidence: final
                self.log.log("day_held_final", day=idx,
                             reason=f"unreadable at revisit: "
                                    f"{type(e).__name__}: {e}"[:300])
                self._save_state()
                continue
            verdict = self._classify(arr, idx)
            if verdict["ok"]:
                self.quarantined.remove(idx)
                self.held.remove(idx)
                self._accept_day(idx, path, verdict, arr,
                                 reclassified=True)
                print(f"[daemon] RECLASSIFIED day {idx}: "
                      f"{verdict.get('kind')} cleared by the armed "
                      f"robust profile", flush=True)
                cleared += 1
            elif verdict.get("kind") != KIND_HELD:
                # the armed structure test judged it: quarantine is final
                self.held.remove(idx)
                self._m_days.labels(verdict="held-final").inc()
                self.log.log("day_held_final", day=idx,
                             kind=verdict.get("kind"),
                             reason=verdict.get("reason"))
            self._save_state()
        return cleared

    def _pending_days(self) -> list[tuple[int, str]]:
        seen = set(self.accepted) | set(self.quarantined)
        out = []
        for name in os.listdir(self.dcfg.spool_dir):
            idx = parse_day_index(name)
            if idx is None:
                continue
            path = os.path.join(self.dcfg.spool_dir, name)
            if idx in seen:
                # a judged day still in the spool: left by a kill between
                # the quarantine evidence write and the unlink; the judged
                # copy wins, this one goes
                if (os.path.exists(os.path.join(self.accepted_dir, name))
                        or os.path.exists(
                            os.path.join(self.quarantine_dir, name))):
                    try:
                        os.unlink(path)
                    except OSError:
                        pass
                continue
            out.append((idx, path))
        out.sort()
        if self.dcfg.ingest_batch:
            out = out[: self.dcfg.ingest_batch]
        return out

    def _read_day(self, path: str) -> np.ndarray:
        """One spool read under the io-retry cover (transient failures
        retry with backoff; the final error names the day file)."""
        return read_with_retry(
            lambda: np.load(path, allow_pickle=False), path,
            attempts=self.tcfg.io_retries,
            base_delay_s=self.tcfg.io_retry_delay_s, faults=self._faults)

    def _quarantine(self, idx: int, path: str, verdict: dict, arr=None):
        dst = os.path.join(self.quarantine_dir, day_filename(idx))
        if arr is not None:
            # poisoned in memory by a fault: the evidence is the bytes the
            # gate judged, written atomically (a kill mid-save must not
            # leave torn evidence that reconcile counts as judged); a kill
            # between write and unlink leaves a spool orphan, which
            # _pending_days removes on the next pass
            buf = io.BytesIO()
            np.save(buf, np.asarray(arr))
            atomic_write_bytes(dst, buf.getvalue())
            os.unlink(path)
        else:
            _move(path, dst)
        row = {"day": idx, "file": dst, **verdict}
        self.verdicts.log("quarantine", **row)
        bisect.insort(self.quarantined, idx)
        self._m_days.labels(verdict="quarantined").inc()
        if verdict.get("kind"):
            # the typed verdict (held / poisoned-structure / invalid) gets
            # its own series beside the total
            self._m_days.labels(verdict=str(verdict["kind"])).inc()
        # a quarantined day's chain ends at its ingest span, which says why
        self.spans.emit("daemon.ingest", new_trace_id(), day=idx,
                        verdict="quarantined",
                        reason=str(verdict.get("reason"))[:200])
        self.log.log("day_quarantined", day=idx,
                     reason=verdict.get("reason"))
        print(f"[daemon] QUARANTINED day {idx}: {verdict.get('reason')}",
              flush=True)

    def _ingest(self) -> int:
        """Pull pending spool days through the gate; returns how many were
        processed (accepted or quarantined). The state is saved after
        every day, so a kill mid-ingest never judges a day twice."""
        self._capture_poll()
        processed = 0
        for idx, path in self._pending_days():
            self.ingested += 1
            poisoned = None
            arr = None
            try:
                arr = self._read_day(path)
                if self._faults.take_bad_day(self.ingested):
                    arr = np.array(arr, dtype=np.float64)
                    arr[:: max(1, arr.shape[0] // 3)] = np.nan
                    poisoned = arr
                verdict = self._classify(arr, idx)
                if poisoned is not None:
                    verdict["injected_fault"] = "bad_day"
            except Exception as e:  # unreadable bytes: a verdict, not a
                verdict = {"ok": False,  # crash
                           "reason": f"unreadable: "
                                     f"{type(e).__name__}: {e}"[:300]}
            if verdict["ok"]:
                self._accept_day(idx, path, verdict, arr)
            else:
                if verdict.get("kind") == KIND_HELD:
                    # an outlier before the pattern armed: quarantined,
                    # but re-classified later (_revisit_held)
                    bisect.insort(self.held, idx)
                self._quarantine(idx, path, verdict, arr=poisoned)
            processed += 1
            self._save_state()
        return processed

    # --- window data ------------------------------------------------------

    @property
    def _min_train_days(self) -> int:
        if self.dcfg.min_train_days:
            return self.dcfg.min_train_days
        return (self.tcfg.obs_len + self.tcfg.pred_len
                + self.dcfg.val_days + self.dcfg.holdout_days
                + self.tcfg.batch_size)

    def _window_ids(self) -> list[int]:
        return self.accepted[-self.dcfg.window_days:]

    def _day(self, idx: int) -> np.ndarray:
        if idx not in self._day_cache:
            path = os.path.join(self.accepted_dir, day_filename(idx))
            self._day_cache[idx] = np.asarray(
                self._read_day(path), dtype=np.float64)
            # the cache holds the rolling window only
            keep = set(self.accepted[-self.dcfg.window_days:])
            for old in [k for k in self._day_cache if k not in keep]:
                self._day_cache.pop(old, None)
        return self._day_cache[idx]

    def _adjacency(self, N: int) -> np.ndarray:
        if self._adj is None:
            path = os.path.join(self.dcfg.spool_dir, "adjacency.npy")
            if os.path.exists(path):
                self._adj = np.asarray(self._read_day(path))
            else:
                from mpgcn_tpu_torch.data.loader import synthetic_adjacency

                self._adj = synthetic_adjacency(N, self.tcfg.seed)
        return self._adj

    def _build_window(self, ids: list[int], out_dir: str):
        """(cfg, data, pipeline) over the window's days: the offline
        preprocessing (``loader.preprocess_od``), and a pipeline whose
        gathers retry and name the day files behind them (on the
        chunked-stream staging thread too)."""
        from mpgcn_tpu_torch.data.loader import preprocess_od
        from mpgcn_tpu_torch.data.pipeline import DataPipeline
        from mpgcn_tpu_torch.data.windows import mode_offset, split_lengths

        raw = np.stack([self._day(i) for i in ids])
        N = raw.shape[1]
        ratio = window_split_ratio(
            len(ids), self.tcfg.obs_len, self.tcfg.pred_len,
            self.dcfg.val_days, self.dcfg.holdout_days)
        cfg = self.tcfg.replace(output_dir=out_dir,
                                split_ratio=ratio, num_nodes=N)
        data = preprocess_od(raw, self._adjacency(N), cfg)
        nwin = int(round(sum(ratio)))
        lens = split_lengths(nwin, ratio)
        acc_dir = self.accepted_dir

        def provenance(mode: str, sel) -> str:
            # window w of `mode` starts at day ids[mode_offset + w]: name
            # the first requested window's first day file
            w = mode_offset(mode, lens) + int(np.asarray(sel).reshape(-1)[0])
            path = os.path.join(acc_dir, day_filename(ids[min(w,
                                                              len(ids) - 1)]))
            extra = int(np.asarray(sel).size) - 1
            return path + (f" (+{extra} more windows)" if extra > 0 else "")

        pipeline = DataPipeline(cfg, data, self.device,
                                gather_provenance=provenance,
                                gather_faults=self._faults)
        return cfg, data, pipeline

    def _trainer(self, cfg, data, pipeline):
        from mpgcn_tpu_torch.train.trainer import ModelTrainer

        return ModelTrainer(cfg, data, device=self.device,
                            pipeline=pipeline)

    # --- retrain + gate ---------------------------------------------------

    def _have_incumbent(self) -> bool:
        return os.path.exists(self._promoted())

    def _promoted(self) -> str:
        return promoted_path(self.dcfg.output_dir, self.tcfg.model)

    def _retrain_due(self):
        """The reason a retrain starts this cycle (cadence or bootstrap),
        or None. Drift carries its own reason."""
        n = len(self.accepted)
        if n < self._min_train_days:
            return None
        if n <= self.accepted_at_last_failure:
            # the last attempt failed on this window: wait for new data
            # instead of repeating a deterministic failure
            return None
        if not self._have_incumbent():
            return "bootstrap: no incumbent promoted checkpoint"
        new = n - self.accepted_at_last_retrain
        if new >= self.dcfg.retrain_cadence:
            return f"cadence: {new} new accepted day(s)"
        return None

    def _observe_incumbent(self):
        """Score the incumbent on the current held-out split and feed the
        drift detector. Returns the drift reason, if any."""
        trainer = None
        try:
            cfg, data, pipeline = self._build_window(
                self._window_ids(), os.path.join(self.retrain_base,
                                                 "drift_eval"))
            trainer = self._trainer(cfg, data, pipeline)
            trainer.load_trained(self._promoted())
            loss = trainer._validation_loss("test")
        except Exception as e:
            self.log.log("drift_eval_failed",
                         error=f"{type(e).__name__}: {e}"[:300])
            return None
        finally:
            if trainer is not None:
                trainer.close()
        self.detector.observe_eval(loss)
        self._save_state()
        self.log.log("drift_eval", loss=round(float(loss), 6),
                     evals=len(self.detector._evals))
        return self.detector.check()

    def _retrain_counters(self, out_dir: str) -> tuple[int, int]:
        """Sentinel and spike totals from the retrain's epoch log (the
        drift detector's second family of signals)."""
        events = read_events(run_log_path(out_dir, self.tcfg.model, True),
                             "epoch")
        return (sum(int(e.get("skipped_steps", 0)) for e in events),
                sum(int(e.get("loss_spikes", 0)) for e in events))

    def _note_attempt(self, launches0: dict, steps: dict) -> None:
        """The attempt's kernel launches and steps, and the device bytes
        held once its trainer and window are released (the cached blocks
        returned to the card first), into the gauges that retrain_done's
        metrics snapshot carries."""
        for name, n in kernel_launches().items():
            self._m_launches.labels(kernel=name).set(n - launches0[name])
        for kind, n in steps.items():
            self._m_steps.labels(kind=kind).set(n)
        if self.device.type == "cuda":
            import gc

            import torch

            gc.collect()
            torch.cuda.empty_cache()
            self._m_reserved.set(torch.cuda.memory_reserved(self.device))

    def _retrain_cycle(self, reason: str):
        """One retrain attempt and its gate. Every failure inside (crash,
        kill, poisoned candidate, eval regression) leaves the promoted
        checkpoint untouched."""
        attempt = self.retrain_attempts + 1
        self.retrain_attempts = attempt
        self._save_state()  # before training: a SIGKILL mid-retrain must
        #                     not let the relaunch reuse this attempt
        #                     number (kill_retrain is keyed on it)
        # one output dir an attempt: an armed kill_retrain watcher polls
        # its own attempt's log, so a watcher whose attempt crashed before
        # its first epoch can never fire into a later attempt's log
        retrain_dir = os.path.join(self.retrain_base, f"a{attempt}")
        shutil.rmtree(self.retrain_base, ignore_errors=True)
        os.makedirs(retrain_dir, exist_ok=True)
        ids = self._window_ids()
        self.log.log("retrain_start", attempt=attempt, reason=reason,
                     window_days=len(ids), first_day=ids[0],
                     last_day=ids[-1], init=self.dcfg.retrain_init)
        self._faults.maybe_kill_retrain(
            attempt, run_log_path(retrain_dir, self.tcfg.model, True))
        # the retrain span joins the trace of the newest accepted day of
        # the window (the arrival that made this window)
        dtrace, dspan = self.day_spans.get(ids[-1], (None, None))
        launches0 = kernel_launches()
        trainer = None
        try:
            with self.spans.span("daemon.retrain", trace=dtrace,
                                 parent=dspan, attempt=attempt,
                                 reason=reason) as srec:
                cfg, data, pipeline = self._build_window(ids, retrain_dir)
                trainer = self._trainer(cfg, data, pipeline)
                warm = (self.dcfg.retrain_init == "warm"
                        and self._have_incumbent())
                if warm:
                    try:
                        trainer.warm_start(self._promoted())
                    except Exception as e:
                        warm = False
                        self.log.log(
                            "warm_start_failed",
                            error=f"{type(e).__name__}: {e}"[:300])
                trainer.train()
                candidate = os.path.join(retrain_dir,
                                         f"{cfg.model}_od.pkl")
                if not os.path.exists(candidate):
                    raise FileNotFoundError(
                        f"retrain produced no candidate at {candidate}")
                if self._faults.take_poison_eval(attempt):
                    poison_checkpoint(candidate)
                skipped, spikes = self._retrain_counters(retrain_dir)
                self.detector.observe_counters(skipped=skipped,
                                               spikes=spikes)
                promoted = self._gate(trainer, candidate, attempt,
                                      warm_start=warm)
                srec["attrs"]["promoted"] = promoted
                self._m_retrains.labels(
                    result="promoted" if promoted else "rejected").inc()
                self.accepted_at_last_retrain = len(self.accepted)
                self.retrains_done += 1
                if promoted:
                    self.detector.reset()
                else:
                    # keep the drift history (the incumbent may be
                    # drifting), but wait for new data before the next
                    # attempt instead of repeating a rejected window
                    self.accepted_at_last_failure = len(self.accepted)
                self._save_state()
                steps = dict(trainer.step_counts)
                trainer.close()
                # the window's banks go too, before the bytes are read
                trainer = cfg = data = pipeline = None
                self._note_attempt(launches0, steps)
                self.log.log("retrain_done", attempt=attempt,
                             promoted=promoted, skipped_steps=skipped,
                             loss_spikes=spikes,
                             metrics=default_registry().snapshot())
        except Exception as e:
            # degrade: the incumbent stays promoted, the daemon alive, and
            # this window is not retried until new data arrives
            traceback.print_exc()
            self._m_retrains.labels(result="failed").inc()
            self.accepted_at_last_failure = len(self.accepted)
            self._save_state()
            self.log.log("retrain_failed", attempt=attempt,
                         error=f"{type(e).__name__}: {e}"[:300])
            print(f"[daemon] retrain attempt {attempt} failed; incumbent "
                  f"checkpoint untouched.", flush=True)
        finally:
            if trainer is not None:
                trainer.close()

    def _gate(self, trainer, candidate: str, attempt: int,
              warm_start: bool = False) -> bool:
        """Eval before promote: score candidate and incumbent on the
        held-out split with the same trainer and data, decide, then
        promote atomically or keep the candidate for postmortem. The
        decision runs in a ``daemon.promote`` span whose ids ride the gate
        ledger row to the serving plane's reload span."""
        with self.spans.span("daemon.promote", attempt=attempt) as prec:
            ok = self._gate_inner(trainer, candidate, attempt,
                                  warm_start, prec)
            prec["attrs"]["promoted"] = ok
            return ok

    def _gate_inner(self, trainer, candidate: str, attempt: int,
                    warm_start: bool, prec: dict) -> bool:
        trainer.load_trained(candidate)
        cand_eval = evaluate_params(trainer, "test")
        inc_eval = None
        inc_failed = False
        if self._have_incumbent():
            try:
                trainer.load_trained(self._promoted())
                inc_eval = evaluate_params(trainer, "test")
            except Exception as e:
                inc_failed = True
                self.log.log("incumbent_eval_failed",
                             error=f"{type(e).__name__}: {e}"[:300])
        gate = PromotionGate(self.dcfg.promote_tolerance,
                             enabled=self.dcfg.gate)
        if inc_failed and gate.enabled:
            # an incumbent that exists but could not be scored is not "no
            # incumbent": defer rather than replace a healthy model on a
            # transient eval error
            ok, verdict = False, ("incumbent-eval-failed: promotion "
                                  "deferred, incumbent keeps serving")
        else:
            ok, verdict = gate.decide(cand_eval, inc_eval)
        row = {"attempt": attempt, "promoted": ok, "verdict": verdict,
               "trace": prec["trace"], "span": prec["span"],
               "candidate_hash": candidate_hash(candidate),
               "cand_loss": cand_eval["loss"],
               "cand_rmse": cand_eval["rmse"],
               "inc_loss": inc_eval["loss"] if inc_eval else None,
               "inc_rmse": inc_eval["rmse"] if inc_eval else None,
               "tolerance": self.dcfg.promote_tolerance,
               "warm_start": warm_start,
               "window_days": len(self._window_ids())}
        if ok:
            slot = promote_checkpoint(candidate, self._promoted())
            self.log.log("promoted", attempt=attempt, slot=slot,
                         cand_loss=cand_eval["loss"],
                         cand_rmse=cand_eval["rmse"])
            print(f"[daemon] PROMOTED attempt {attempt}: loss "
                  f"{cand_eval['loss']:.6g}, rmse "
                  f"{cand_eval['rmse']:.6g} ({verdict})", flush=True)
        else:
            keep = rejected_path(self.dcfg.output_dir, attempt,
                                 self.tcfg.model)
            shutil.copyfile(candidate, keep)
            self.log.log("rejected", attempt=attempt, kept=keep,
                         verdict=verdict)
            print(f"[daemon] REJECTED attempt {attempt}: {verdict} "
                  f"(candidate kept at {keep})", flush=True)
        self.ledger.log("gate", **row)
        return ok

    # --- the loop ---------------------------------------------------------

    def run(self) -> int:
        import signal

        def _on_sig(signum, frame):
            self._stop = True

        prev = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                prev[sig] = signal.signal(sig, _on_sig)
            except ValueError:
                pass
        d = self.dcfg
        self.log.log("daemon_start", window_days=d.window_days,
                     retrain_cadence=d.retrain_cadence,
                     drift_window=d.drift_window,
                     drift_threshold=d.drift_threshold,
                     promote_tolerance=d.promote_tolerance,
                     gate=d.gate, retrain_init=d.retrain_init,
                     resumed_accepted=len(self.accepted),
                     retrain_attempts=self.retrain_attempts)
        idle = 0
        cycle = 0
        try:
            while not self._stop:
                cycle += 1
                n_new = self._ingest()
                n_new += self._revisit_held()
                worked = n_new > 0
                reason = self._retrain_due()
                if reason is None and n_new and self._have_incumbent():
                    # no cadence retrain this cycle: watch the refreshed
                    # window for drift instead
                    reason = self._observe_incumbent()
                    if reason:
                        self.log.log("drift", reason=reason)
                        print(f"[daemon] drift detected: {reason}",
                              flush=True)
                if reason and not self._stop:
                    self._retrain_cycle(reason)
                    worked = True
                if worked:
                    idle = 0
                else:
                    idle += 1
                    if d.idle_exits and idle >= d.idle_exits:
                        self.log.log("idle_exit", cycles=cycle)
                        return 0
                    if d.poll_secs and not self._stop:
                        time.sleep(d.poll_secs)
                if d.max_cycles and cycle >= d.max_cycles:
                    self.log.log("max_cycles", cycles=cycle)
                    return 0
            self.log.log("daemon_stop", cycles=cycle,
                         metrics=default_registry().snapshot())
            # a SIGTERM drain leaves a postmortem beside the ledgers
            flight.dump_to_dir(self.dcfg.output_dir,
                               reason="daemon-sigterm-drain")
            return 0
        finally:
            for sig, h in prev.items():
                signal.signal(sig, h if h is not None else signal.SIG_DFL)


def _move(src: str, dst: str) -> None:
    try:
        os.replace(src, dst)
    except OSError:
        shutil.move(src, dst)


# --- CLI ----------------------------------------------------------------------


def build_parser() -> argparse.ArgumentParser:
    """The JAX daemon command's flags, plus ``--device``."""
    p = argparse.ArgumentParser(
        prog="python -m mpgcn_tpu_torch.cli daemon",
        description="Continual-learning service loop: ingest daily OD "
                    "snapshots through a data-integrity gate, retrain "
                    "warm-start on drift/cadence, and promote candidates "
                    "only past an eval-before-promote gate.")
    p.add_argument("--device", default="cuda",
                   help="where the retrains run: 'cuda' (the default; the "
                        "command refuses to start without it) or 'cpu' "
                        "(the plain PyTorch versions of the kernels)")
    p.add_argument("-spool", "--spool_dir", required=True,
                   help="where day_<idx>.npy snapshots arrive (an "
                        "adjacency.npy beside them overrides the "
                        "synthetic adjacency)")
    p.add_argument("-out", "--output_dir", default="./service")
    p.add_argument("--profile", default=None,
                   help="scenario profile name (scenarios/profiles.py): "
                        "sets -obs/-pred/-seed/--nodes from the named "
                        "profile's contract, so the retrained model "
                        "matches the tenant's scenario (`scenario list`)")
    p.add_argument("--compile-cache", dest="compile_cache_dir",
                   type=str, default="",
                   help="directory of the built kernel libraries (obs/"
                        "perf/compile_cache.py): a relaunched daemon loads "
                        "them instead of building them "
                        "($MPGCN_COMPILE_CACHE is the env equivalent)")
    p.add_argument("--window-days", type=int, default=56)
    p.add_argument("--holdout-days", type=int, default=8)
    p.add_argument("--val-days", type=int, default=6)
    p.add_argument("--min-train-days", type=int, default=0)
    p.add_argument("--drift-window", type=int, default=3)
    p.add_argument("--drift-threshold", type=float, default=0.2)
    p.add_argument("--drift-skip-budget", type=int, default=0)
    p.add_argument("--drift-spike-budget", type=int, default=3)
    p.add_argument("--retrain-cadence", type=int, default=7)
    p.add_argument("--promote-tolerance", type=float, default=0.05)
    p.add_argument("--no-gate", dest="gate", action="store_false",
                   help="promote every candidate unconditionally (for "
                        "the test that shows the gate is load-bearing)")
    p.add_argument("--retrain-init", choices=["warm", "scratch"],
                   default="warm")
    p.add_argument("--ingest-batch", type=int, default=0)
    p.add_argument("--poll-secs", type=float, default=1.0)
    p.add_argument("--idle-exits", type=int, default=0)
    p.add_argument("--max-cycles", type=int, default=0)
    p.add_argument("--profile-zmax", type=float, default=6.0)
    p.add_argument("--profile-min-history", type=int, default=5)
    p.add_argument("--robust-window", type=int, default=64,
                   help="accepted-day log-totals the robust median/MAD "
                        "profile remembers (shock-vs-poison classifier)")
    p.add_argument("--shock-coherence", type=float, default=0.90,
                   help="min cosine vs the accepted pattern for a "
                        "total-flow outlier to train as an event shock")
    p.add_argument("--shock-support-max", type=float, default=0.05,
                   help="max fraction of an outlier day's mass allowed "
                        "off the accepted support before it is typed "
                        "poisoned-structure")
    p.add_argument("--capture-ledger", type=str, default="",
                   help="serving-plane requests.jsonl to stitch "
                        "captured day files from (service/capture.py; "
                        "'' = capture off). Pair with the server's "
                        "--capture-flows")
    p.add_argument("--capture-tenant", type=str, default="",
                   help="tenant filter when the capture ledger is a "
                        "multi-tenant fleet ledger ('' = any)")
    p.add_argument("--nodes", type=int, default=0,
                   help="expected zone count (0 = lock in from the "
                        "first accepted day)")
    # the retrains' training knobs (the train command's names)
    p.add_argument("-obs", "--obs_len", type=int, default=7)
    p.add_argument("-pred", "--pred_len", type=int, default=1)
    p.add_argument("-batch", "--batch_size", type=int, default=4)
    p.add_argument("-hidden", "--hidden_dim", type=int, default=32)
    p.add_argument("-kernel", "--kernel_type", type=str,
                   default="random_walk_diffusion")
    p.add_argument("-K", "--cheby_order", type=int, default=2)
    p.add_argument("-M", "--num_branches", type=int, default=2)
    p.add_argument("-lr", "--learn_rate", type=float, default=1e-3,
                   help="retrain learning rate (warm starts refine an "
                        "already-good model, so the default is hotter "
                        "than the offline 1e-4 but still early-stopped)")
    p.add_argument("-epoch", "--num_epochs", type=int, default=20,
                   help="epoch budget PER retrain (early stopping "
                        "applies)")
    p.add_argument("-seed", "--seed", type=int, default=0)
    p.add_argument("-shuffle", "--shuffle", action="store_true")
    p.add_argument("-faults", "--faults", type=str, default="",
                   help="chaos spec incl. daemon faults bad_day=K / "
                        "kill_retrain=K / poison_eval=K "
                        "(resilience/faults.py)")
    p.add_argument("-io-retries", "--io_retries", type=int, default=3)
    p.add_argument("-trace", "--trace_dir", type=str, default=None,
                   help="torch.profiler trace output dir: the daemon "
                        "session in one window (retrain steps annotated), "
                        "written there when it exits")
    p.add_argument("--metrics-port", type=int, default=None,
                   help="serve GET /metrics (Prometheus text) from a "
                        "stdlib HTTP sidecar on this port (0 = "
                        "ephemeral, printed at startup; unset = off)")
    p.add_argument("-resume", "--resume", action="store_true",
                   help="accepted for supervisor compatibility (the "
                        "supervisor appends it on relaunch); the daemon "
                        "always resumes from its on-disk state")
    return p


def main(argv=None) -> int:
    from mpgcn_tpu_torch.config import MPGCNConfig
    from mpgcn_tpu_torch.device import resolve_device
    from mpgcn_tpu_torch.obs.device import DeviceSampler
    from mpgcn_tpu_torch.obs.metrics import MetricsServer
    from mpgcn_tpu_torch.obs.perf import compile_cache
    from mpgcn_tpu_torch.utils.profiling import trace_if

    ns = build_parser().parse_args(argv)
    try:
        device = resolve_device(ns.device)
    except (RuntimeError, ValueError) as e:
        raise SystemExit(f"daemon: {e}") from None
    if ns.profile:
        # the profile's contract wins for the model-shape knobs it
        # declares, so a federated tenant's daemon keeps its scenario
        from mpgcn_tpu_torch.scenarios.profiles import get_profile

        prof = get_profile(ns.profile)
        ns.obs_len = prof.obs_len
        ns.pred_len = prof.horizon
        ns.seed = prof.folded_seed
        ns.nodes = prof.num_nodes
        print(f"[daemon] scenario profile {prof.name!r}: obs_len="
              f"{prof.obs_len}, pred_len={prof.horizon}, N="
              f"{prof.num_nodes}, seed={prof.folded_seed}", flush=True)
    # the kernel-library directory before any retrain builds a kernel
    compile_cache.enable(ns.compile_cache_dir or None)
    dcfg = DaemonConfig(
        spool_dir=ns.spool_dir, output_dir=ns.output_dir,
        window_days=ns.window_days, holdout_days=ns.holdout_days,
        val_days=ns.val_days, min_train_days=ns.min_train_days,
        drift_window=ns.drift_window, drift_threshold=ns.drift_threshold,
        drift_skip_budget=ns.drift_skip_budget,
        drift_spike_budget=ns.drift_spike_budget,
        retrain_cadence=ns.retrain_cadence,
        promote_tolerance=ns.promote_tolerance, gate=ns.gate,
        retrain_init=ns.retrain_init, ingest_batch=ns.ingest_batch,
        poll_secs=ns.poll_secs, idle_exits=ns.idle_exits,
        max_cycles=ns.max_cycles, profile_zmax=ns.profile_zmax,
        profile_min_history=ns.profile_min_history, num_nodes=ns.nodes,
        robust_window=ns.robust_window,
        shock_coherence=ns.shock_coherence,
        shock_support_max=ns.shock_support_max,
        capture_ledger=ns.capture_ledger,
        capture_tenant=ns.capture_tenant)
    tcfg = MPGCNConfig(
        mode="train", data="synthetic", input_dir=ns.spool_dir,
        output_dir=os.path.join(ns.output_dir, "retrain"),
        obs_len=ns.obs_len, pred_len=ns.pred_len,
        batch_size=ns.batch_size, hidden_dim=ns.hidden_dim,
        kernel_type=ns.kernel_type, cheby_order=ns.cheby_order,
        num_branches=ns.num_branches, learn_rate=ns.learn_rate,
        num_epochs=ns.num_epochs, seed=ns.seed, shuffle=ns.shuffle,
        faults=ns.faults, io_retries=ns.io_retries)
    # the card's memory gauges ride the default registry that the cycle
    # events snapshot; --metrics-port exposes it to a scrape
    sidecar = None
    if ns.metrics_port is not None:
        sidecar = MetricsServer([default_registry()],
                                port=ns.metrics_port).start()
        print(f"[obs] /metrics on "
              f"http://{sidecar.host}:{sidecar.port}/metrics", flush=True)
    sampler = DeviceSampler().start()
    try:
        with trace_if(ns.trace_dir, device):
            return ContinualDaemon(dcfg, tcfg, device=device).run()
    finally:
        sampler.stop()
        if sidecar is not None:
            sidecar.stop()


if __name__ == "__main__":
    raise SystemExit(main())
