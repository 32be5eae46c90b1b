"""SLO engine (counterpart of mpgcn_tpu/obs/perf/slo.py): declarative
objectives evaluated in-process with multi-window burn rates over the
metrics registry (obs/metrics.py).

The engine takes declarative specs (``config.py`` ``DEFAULT_SLOS``),
snapshots the raw cumulative series on every ``tick()``, and evaluates
each objective over a short and a long window (the multi-window,
multi-burn-rate alerting shape: the short window catches a fast burn,
the long one keeps a blip from paging):

  burn >= threshold in BOTH windows  ->  ``burning``
  burn >= 1.0 in either window       ->  ``warn``
  otherwise                          ->  ``ok``

State is exported back into the registry (``slo_state{slo=}``,
``slo_burn_rate{slo=,window=}``) and rides ``/v1/stats`` through
``report()``; a spec that stays ``burning`` for ``postmortem_after``
consecutive ticks dumps a flight-recorder postmortem beside the plane's
ledgers. Per-label specs (``per_label="tenant"``) evaluate each labeled
child of the metric separately.

Stdlib only, and guarded at the tick boundary: the SLO engine must
never be the reason a serving plane goes down.
"""

from __future__ import annotations

import math
import threading
import time
from collections import deque
from typing import Callable, Optional, Sequence

from mpgcn_tpu_torch.obs import flight
from mpgcn_tpu_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    bucket_quantile,
)

#: evaluation states (the `slo_state{slo=}` gauge's encoding)
OK, WARN, BURNING = 0, 1, 2
_STATE_NAMES = {OK: "ok", WARN: "warn", BURNING: "burning"}

_KINDS = ("latency_p99", "bad_ratio", "rate", "gauge_min")


class SLOSpec:
    """One declarative objective (built from the config.py dict form).

      name          -- stable id (label value in the exported gauges)
      kind          -- latency_p99 | bad_ratio | rate | gauge_min
      metric        -- registry series name WITHOUT the mpgcn_ prefix
      objective     -- latency_p99: p99 ceiling (ms); bad_ratio: error
                       budget (bad fraction); rate: events allowed per
                       LONG window (0 = any event burns); gauge_min:
                       floor (0 = informational only, never burns)
      windows_s     -- (short, long) evaluation windows, seconds
      burn_threshold-- burn multiple that (in both windows) = burning
      bad_prefixes  -- bad_ratio only: outcome-label prefixes counted
                       against the budget
      per_label     -- evaluate each labeled child of this label name
                       separately (e.g. "tenant")
    """

    def __init__(self, name: str, kind: str, metric: str,
                 objective: float, windows_s: Sequence[float] = (60.0,
                                                                 600.0),
                 burn_threshold: float = 2.0,
                 bad_prefixes: Sequence[str] = ("shed-", "rejected-",
                                                "error-"),
                 per_label: Optional[str] = None,
                 description: str = "", plane: Optional[str] = None):
        if kind not in _KINDS:
            raise ValueError(f"SLO {name}: kind {kind!r} not in {_KINDS}")
        if len(windows_s) != 2 or windows_s[0] >= windows_s[1]:
            raise ValueError(f"SLO {name}: windows_s must be "
                             f"(short, long) with short < long")
        self.name = name
        self.kind = kind
        self.metric = metric
        self.objective = float(objective)
        self.windows_s = (float(windows_s[0]), float(windows_s[1]))
        self.burn_threshold = float(burn_threshold)
        self.bad_prefixes = tuple(bad_prefixes)
        self.per_label = per_label
        self.description = description
        self.plane = plane


class SLOEngine:
    """Evaluates a spec list against one or more registries.

    ``tick()`` is the only entry point: cheap (a few dict copies per
    spec), called from scrape paths (``/v1/stats``, ``/metrics``), the
    serve main loop -- never from inside a captured CUDA graph."""

    def __init__(self, specs: Sequence, registries: Sequence,
                 export_registry: Optional[MetricsRegistry] = None,
                 output_dir: Optional[str] = None,
                 postmortem_after: int = 3,
                 min_tick_interval_s: float = 1.0,
                 clock: Callable[[], float] = time.monotonic):
        self.specs = [s if isinstance(s, SLOSpec) else SLOSpec(**s)
                      for s in specs]
        self.registries = list(registries)
        self.output_dir = output_dir
        self.postmortem_after = int(postmortem_after)
        self.min_tick_interval_s = float(min_tick_interval_s)
        self._clock = clock
        self._lock = threading.Lock()
        # (t, {spec.name: raw}) ring sized so that at the FASTEST
        # allowed tick cadence it still spans every spec's long window
        # (plus slack) -- a fixed size would silently evict the long
        # window's base snapshot under a 1 Hz serve loop and evaluate
        # "600 s" burn over whatever survived
        longest = max((s.windows_s[1] for s in self.specs), default=600.0)
        cadence = max(self.min_tick_interval_s, 1.0)
        self._snaps: deque = deque(
            maxlen=max(64, int(longest / cadence) + 16))
        self._last_report: dict = {"slos": []}
        self._burn_streak: dict[str, int] = {}
        self._postmortems = 0
        reg = export_registry if export_registry is not None else (
            self.registries[0] if self.registries else MetricsRegistry())
        self._g_state = reg.gauge(
            "slo_state", "per-SLO evaluation state (0=ok, 1=warn, "
            "2=burning; worst labelset for per-tenant objectives)")
        self._g_burn = reg.gauge(
            "slo_burn_rate", "per-SLO burn-rate multiple per window "
            "(1.0 = consuming exactly the error budget)")

    # --- metric lookup -------------------------------------------------------

    def _find(self, name: str):
        for reg in self.registries:
            m = reg._metrics.get(reg.prefix + name)  # noqa: SLF001
            if m is not None:
                return m
        return None

    # --- raw snapshots -------------------------------------------------------

    def _raw(self, spec: SLOSpec):
        """Cumulative raw data for one spec at this instant; shape
        depends on kind (counts are cumulative -- windows are DELTAS of
        two snapshots, so process lifetime never pollutes a window)."""
        m = self._find(spec.metric)
        if m is None:
            return None
        if spec.kind == "latency_p99":
            if not isinstance(m, Histogram):
                return None
            keys = [()] + m.label_keys()
            return {k: m._read(k) for k in keys}  # noqa: SLF001
        if spec.kind == "bad_ratio":
            if not isinstance(m, Counter):
                return None
            return m.series()
        if spec.kind == "rate":
            if not isinstance(m, Counter):
                return None
            return sum(m.series().values())
        if spec.kind == "gauge_min":
            return float(m.value) if isinstance(m, Gauge) else None
        return None

    # --- evaluation ----------------------------------------------------------

    def tick(self) -> dict:
        """Snapshot + evaluate + export. Never raises (the scrape paths
        and the serve main loop ride it); returns the report dict."""
        try:
            return self._tick()
        except Exception as e:  # observability must not take the plane down
            return {"slos": [], "error": f"{type(e).__name__}: {e}"[:200]}

    def _tick(self) -> dict:
        now = self._clock()
        with self._lock:
            if (self._snaps
                    and now - self._snaps[-1][0] < self.min_tick_interval_s):
                # scrape storms must not flood the ring with
                # zero-delta snapshots; re-serve the last evaluation
                return self._last_report
            raw = {s.name: self._raw(s) for s in self.specs}
            self._snaps.append((now, raw))
            snaps = list(self._snaps)
        report = {"t": round(now, 3), "windows_covered_s":
                  round(now - snaps[0][0], 1), "slos": []}
        for spec in self.specs:
            entry = self._evaluate(spec, now, snaps)
            report["slos"].append(entry)
            self._export(spec, entry)
            self._maybe_postmortem(spec, entry)
        with self._lock:
            self._last_report = report
        return report

    def _window_base(self, snaps, now: float, window_s: float,
                     name: str):
        """The snapshot a window's delta subtracts: the newest one at
        least `window_s` old, else the oldest available (short history
        degrades to since-start deltas instead of reporting nothing)."""
        base = snaps[0]
        for t, raw in snaps:
            if now - t >= window_s:
                base = (t, raw)
            else:
                break
        return base[1].get(name), max(now - base[0], 1e-9)

    def _evaluate(self, spec: SLOSpec, now: float, snaps) -> dict:
        cur = snaps[-1][1].get(spec.name)
        entry = {"name": spec.name, "kind": spec.kind,
                 "metric": spec.metric, "objective": spec.objective,
                 "windows_s": list(spec.windows_s),
                 "burn_threshold": spec.burn_threshold}
        if spec.description:
            entry["description"] = spec.description
        if cur is None:
            entry.update(state="ok", state_code=OK, value=None,
                         absent=True)
            return entry
        burns: dict[str, dict] = {}          # labelset repr -> burn info
        for wname, wsecs in zip(("short", "long"), spec.windows_s):
            base, span = self._window_base(snaps, now, wsecs, spec.name)
            for key, burn, value in self._burn(spec, cur, base, span,
                                               wsecs):
                burns.setdefault(key, {"burn": {}, "value": None})
                burns[key]["burn"][wname] = _round_burn(burn)
                if wname == "short":
                    burns[key]["value"] = value
        # state per labelset, overall = worst
        worst = OK
        for key, info in burns.items():
            b = info["burn"]
            short, long_ = b.get("short", 0.0), b.get("long", 0.0)
            if (short >= spec.burn_threshold
                    and long_ >= spec.burn_threshold):
                code = BURNING
            elif short >= 1.0 or long_ >= 1.0:
                code = WARN
            else:
                code = OK
            info["state"] = _STATE_NAMES[code]
            info["state_code"] = code
            worst = max(worst, code)
        overall = burns.get("", {"burn": {}, "value": None,
                                 "state": "ok", "state_code": OK})
        entry.update(state=_STATE_NAMES[worst], state_code=worst,
                     value=overall.get("value"),
                     burn=overall.get("burn", {}))
        if spec.per_label:
            per = {key: info for key, info in sorted(burns.items())
                   if key}
            if per:
                entry[spec.per_label + "s"] = per
        return entry

    def _burn(self, spec: SLOSpec, cur, base, span_s: float,
              window_s: float):
        """Yield (labelset_repr, burn_multiple, measured_value) for one
        window. labelset_repr '' is the overall series; per-label specs
        additionally yield one entry per child label value."""
        if spec.kind == "gauge_min":
            v = float(cur)
            if spec.objective <= 0:
                yield "", 0.0, round(v, 3)
            elif v <= 0:
                yield "", math.inf, round(v, 3)
            else:
                yield "", spec.objective / v, round(v, 3)
            return
        if spec.kind == "rate":
            delta = max(0.0, float(cur) - float(base or 0.0))
            # scale the long-window allowance to this window's span
            allowed = spec.objective * (window_s / spec.windows_s[1])
            if allowed > 0:
                yield "", delta / allowed, delta
            else:
                yield "", (math.inf if delta > 0 else 0.0), delta
            return
        if spec.kind == "latency_p99":
            base = base or {}
            m = self._find(spec.metric)  # once, not per labelset
            for key, (counts, _s, n) in sorted(cur.items()):
                bcounts, _bs, bn = base.get(
                    key, ([0] * len(counts), 0.0, 0))
                dcounts = [max(0, c - b)
                           for c, b in zip(counts, bcounts)]
                dn = max(0, n - bn)
                p99 = bucket_quantile(m.buckets, dcounts, dn, 0.99) \
                    if m is not None else None
                if spec.objective > 0 and p99 is not None:
                    burn = p99 / spec.objective
                else:
                    burn = 0.0
                val = None if p99 is None else round(p99, 3)
                if key == ():
                    yield "", burn, val
                elif spec.per_label:
                    lbl = dict(key).get(spec.per_label)
                    if lbl is not None:
                        yield str(lbl), burn, val
            return
        if spec.kind == "bad_ratio":
            base = base or {}
            groups: dict[str, list] = {"": [0.0, 0.0]}  # [bad, total]
            for key, v in cur.items():
                if not key:
                    continue
                d = max(0.0, v - float(base.get(key, 0.0)))
                lbl = dict(key)
                outcome = str(lbl.get("outcome", ""))
                bad = outcome.startswith(spec.bad_prefixes)
                targets = [""]
                if spec.per_label and lbl.get(spec.per_label) is not None:
                    targets.append(str(lbl[spec.per_label]))
                for t in targets:
                    g = groups.setdefault(t, [0.0, 0.0])
                    g[1] += d
                    if bad:
                        g[0] += d
            for key, (bad, total) in sorted(groups.items()):
                if total <= 0:
                    yield key, 0.0, None
                    continue
                ratio = bad / total
                burn = (ratio / spec.objective if spec.objective > 0
                        else (math.inf if bad > 0 else 0.0))
                yield key, burn, round(ratio, 4)

    # --- export / postmortem -------------------------------------------------

    def _export(self, spec: SLOSpec, entry: dict) -> None:
        self._g_state.labels(slo=spec.name).set(entry["state_code"])
        for wname, burn in (entry.get("burn") or {}).items():
            self._g_burn.labels(slo=spec.name, window=wname).set(
                min(burn, 1e9))  # keep +inf out of the exposition

    def _maybe_postmortem(self, spec: SLOSpec, entry: dict) -> None:
        if entry["state_code"] == BURNING:
            streak = self._burn_streak.get(spec.name, 0) + 1
            self._burn_streak[spec.name] = streak
            if streak == self.postmortem_after and self.output_dir:
                # once per burn episode: the dump embeds every
                # registered metrics provider, so the postmortem shows
                # WHAT was burning, not just that something was
                flight.record("slo_burn", slo=spec.name,
                              value=entry.get("value"),
                              burn=entry.get("burn"))
                flight.dump_to_dir(self.output_dir,
                                   reason=f"slo-burn-{spec.name}")
                self._postmortems += 1
        else:
            self._burn_streak[spec.name] = 0

    # --- read surface --------------------------------------------------------

    def report(self, refresh: bool = True) -> dict:
        """The ``/v1/stats`` "slo" section."""
        if refresh:
            return self.tick()
        with self._lock:
            return self._last_report


def state_name(code: int) -> str:
    return _STATE_NAMES.get(code, "?")


def _round_burn(b: float) -> float:
    if b == math.inf:
        return math.inf
    return round(b, 3)
