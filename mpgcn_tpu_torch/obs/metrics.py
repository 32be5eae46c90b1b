"""Metrics registry: counters, gauges and histograms (counterpart of
mpgcn_tpu/obs/metrics.py).

The serving engine owns a registry: ``/v1/stats`` is a view over it and
``/metrics`` renders it, merged with the process default registry, as
Prometheus text (``render_prometheus``). Design, in order:

  * stdlib only, so any thread and any fire path can snapshot it;
  * a cheap hot path: ``Counter.inc`` and ``Histogram.observe`` are a
    lock and a float add (and one bisect); label children are made once
    by ``labels()`` and cached by the caller;
  * fixed buckets: histograms never grow, p50/p99 are derived from the
    bucket counts by linear interpolation inside the bucket, as
    Prometheus' ``histogram_quantile`` computes them.

``default_registry()`` is the process-wide registry that cross-cutting
series land in: the device gauges (obs/device.py) and
``cuda_program_builds`` (``count_program_build``), the port's
counterpart of the JAX package's ``jax_compiles``: every CUDA graph
capture (train/graphs.py ``GraphSet.capture``) and every kernel library
build (native/build.py). The serving plane's ``retrace_rate`` objective
reads it: after startup it must not move. ``MetricsServer`` is the
stdlib HTTP sidecar that serves ``/metrics`` for planes without an HTTP
front of their own.
"""

from __future__ import annotations

import bisect
import threading
from typing import Callable, Optional, Sequence

#: default latency buckets (milliseconds): tuned for the serving plane's
#: 1ms..30s request range; the train-step histogram reuses them
LATENCY_BUCKETS_MS = (1.0, 2.0, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
                      500.0, 1000.0, 2500.0, 5000.0, 10000.0, 30000.0)


def _labelkey(labels: dict) -> tuple:
    return tuple(sorted(labels.items()))


def _escape_label_value(v) -> str:
    # text exposition format: backslash, double-quote and newline must be
    # escaped inside label values (the exact three the spec names)
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt_labels(key: tuple, extra: str = "") -> str:
    """Render one labelset; ``extra`` appends a pre-formatted pair (the
    histogram ``le`` label, which must not be value-escaped as a float)."""
    pairs = [f'{k}="{_escape_label_value(v)}"' for k, v in key]
    if extra:
        pairs.append(extra)
    if not pairs:
        return ""
    return "{" + ",".join(pairs) + "}"


def _fmt_value(v: float) -> str:
    # prometheus wants plain decimals; ints render without the .0, and
    # non-finite values use the format's spellings (NaN / +Inf / -Inf)
    v = float(v)
    if v != v:
        return "NaN"
    if v == float("inf"):
        return "+Inf"
    if v == float("-inf"):
        return "-Inf"
    return str(int(v)) if v.is_integer() else repr(v)


class Counter:
    """Monotone counter, optionally with one cached label family."""

    kind = "counter"

    def __init__(self, name: str, help_: str = ""):
        self.name = name
        self.help = help_
        self._lock = threading.Lock()
        self._series: dict[tuple, float] = {(): 0.0}

    @property
    def family(self) -> str:
        """The sample-family name the HELP/TYPE lines must carry: the
        text exposition format requires a counter's samples to belong to
        the declared metric family, and this class renders samples with
        the ``_total`` suffix -- so the family IS ``<name>_total``
        (declaring ``<name>`` and emitting ``<name>_total`` makes a
        strict parser file the samples under an untyped second family)."""
        return self.name + "_total"

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._series[()] += n

    def labels(self, **labels) -> "_Child":
        key = _labelkey(labels)
        with self._lock:
            if key not in self._series:
                self._series[key] = 0.0
        return _Child(self, key)

    def _inc_key(self, key: tuple, n: float) -> None:
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + n

    @property
    def value(self) -> float:
        with self._lock:
            return self._series[()]

    def series(self) -> dict[tuple, float]:
        with self._lock:
            return dict(self._series)

    def samples(self) -> list[tuple[str, str, float]]:
        out = []
        for key, v in sorted(self.series().items()):
            if not key and len(self._series) > 1 and v == 0.0:
                continue  # unlabeled zero next to labeled children is noise
            out.append((self.name + "_total", _fmt_labels(key), v))
        return out


class _Child:
    """One cached (metric, labelset) handle -- the hot-path object."""

    __slots__ = ("_metric", "_key")

    def __init__(self, metric, key: tuple):
        self._metric = metric
        self._key = key

    def inc(self, n: float = 1.0) -> None:
        self._metric._inc_key(self._key, n)

    def set(self, v: float) -> None:
        self._metric._inc_key(self._key, v - self.value)

    @property
    def value(self) -> float:
        with self._metric._lock:
            return self._metric._series.get(self._key, 0.0)


class Gauge(Counter):
    """Settable value; ``set_fn`` registers a pull-time callable (e.g.
    queue depth) evaluated at render/snapshot instead of pushed."""

    kind = "gauge"

    def __init__(self, name: str, help_: str = ""):
        super().__init__(name, help_)
        self._fn: Optional[Callable[[], float]] = None

    @property
    def family(self) -> str:
        return self.name  # gauges carry no suffix

    def set(self, v: float) -> None:
        with self._lock:
            self._series[()] = float(v)

    def set_fn(self, fn: Callable[[], float]) -> None:
        self._fn = fn

    @property
    def value(self) -> float:
        if self._fn is not None:
            try:
                return float(self._fn())
            except Exception:
                return float("nan")
        return super().value

    def samples(self) -> list[tuple[str, str, float]]:
        if self._fn is not None:
            return [(self.name, "", self.value)]
        return [(self.name, _fmt_labels(k), v)
                for k, v in sorted(self.series().items())
                if k or len(self._series) == 1 or v != 0.0]


class _HistState:
    """One labelset's bucket counts (unlabeled = key ())."""

    __slots__ = ("counts", "sum", "n")

    def __init__(self, n_buckets: int):
        self.counts = [0] * (n_buckets + 1)  # +1 = +Inf
        self.sum = 0.0
        self.n = 0


class _HistChild:
    """Cached (histogram, labelset) handle -- the hot-path object for
    labeled observations (e.g. per-tenant request latency)."""

    __slots__ = ("_metric", "_key")

    def __init__(self, metric: "Histogram", key: tuple):
        self._metric = metric
        self._key = key

    def observe(self, v: float) -> None:
        self._metric._observe_key(self._key, v)

    @property
    def count(self) -> int:
        return self._metric._read(self._key)[2]

    @property
    def sum(self) -> float:
        return self._metric._read(self._key)[1]

    def quantile(self, q: float) -> Optional[float]:
        return self._metric.quantile(q, key=self._key)


class Histogram:
    """Fixed-bucket histogram (cumulative, Prometheus-style), optionally
    with one cached label family (each labelset renders its own
    ``_bucket``/``_sum``/``_count`` series)."""

    kind = "histogram"

    def __init__(self, name: str, help_: str = "",
                 buckets: Sequence[float] = LATENCY_BUCKETS_MS):
        self.name = name
        self.help = help_
        self.buckets = tuple(sorted(float(b) for b in buckets))
        if not self.buckets:
            raise ValueError(f"histogram {name}: buckets must be non-empty")
        self._lock = threading.Lock()
        self._states: dict[tuple, _HistState] = {
            (): _HistState(len(self.buckets))}

    @property
    def family(self) -> str:
        return self.name  # suffixed samples belong to the bare family

    def _observe_key(self, key: tuple, v: float) -> None:
        i = bisect.bisect_left(self.buckets, v)
        with self._lock:
            st = self._states[key]
            st.counts[i] += 1
            st.sum += v
            st.n += 1

    def observe(self, v: float) -> None:
        self._observe_key((), v)

    def labels(self, **labels) -> _HistChild:
        key = _labelkey(labels)
        with self._lock:
            if key not in self._states:
                self._states[key] = _HistState(len(self.buckets))
        return _HistChild(self, key)

    def _read(self, key: tuple) -> tuple[list, float, int]:
        with self._lock:
            st = self._states.get(key)
            if st is None:
                return [0] * (len(self.buckets) + 1), 0.0, 0
            return list(st.counts), st.sum, st.n

    def label_keys(self) -> list[tuple]:
        """The labeled children present (sorted; excludes the unlabeled
        series) -- the SLO engine iterates these for per-tenant state."""
        with self._lock:
            return sorted(k for k in self._states if k)

    @property
    def count(self) -> int:
        return self._read(())[2]

    @property
    def sum(self) -> float:
        return self._read(())[1]

    def quantile(self, q: float, key: tuple = ()) -> Optional[float]:
        """Derived quantile (what Prometheus' histogram_quantile computes:
        linear interpolation inside the owning bucket). None when empty;
        the top bucket clamps to its lower edge (unbounded above)."""
        counts, _s, n = self._read(key)
        return bucket_quantile(self.buckets, counts, n, q)

    def samples(self) -> list[tuple[str, str, float]]:
        with self._lock:
            states = {k: (list(st.counts), st.sum, st.n)
                      for k, st in self._states.items()}
        out = []
        for key in sorted(states):
            counts, s, n = states[key]
            if key == () and len(states) > 1 and n == 0:
                continue  # unlabeled zero next to labeled children is noise
            cum = 0
            for i, edge in enumerate(self.buckets):
                cum += counts[i]
                out.append((self.name + "_bucket",
                            _fmt_labels(key, f'le="{edge:g}"'), float(cum)))
            out.append((self.name + "_bucket",
                        _fmt_labels(key, 'le="+Inf"'), float(n)))
            out.append((self.name + "_sum", _fmt_labels(key), s))
            out.append((self.name + "_count", _fmt_labels(key), float(n)))
        return out


def bucket_quantile(buckets: Sequence[float], counts: Sequence[float],
                    n: float, q: float) -> Optional[float]:
    """Quantile from cumulative-style bucket COUNT deltas (shared by the
    live histograms above and the SLO engine's windowed deltas)."""
    if n <= 0:
        return None
    rank = q * n
    cum = 0.0
    for i, c in enumerate(counts):
        prev_cum = cum
        cum += c
        if cum >= rank and c > 0:
            lo = buckets[i - 1] if i > 0 else 0.0
            if i >= len(buckets):  # +Inf bucket: no upper edge
                return lo
            hi = buckets[i]
            return lo + (hi - lo) * (rank - prev_cum) / c
    return buckets[-1]


class MetricsRegistry:
    """A named set of metrics. ``prefix`` namespaces every series."""

    def __init__(self, prefix: str = "mpgcn_"):
        self.prefix = prefix
        self._lock = threading.Lock()
        self._metrics: dict[str, object] = {}

    def _get(self, cls, name: str, help_: str, **kw):
        full = self.prefix + name
        with self._lock:
            m = self._metrics.get(full)
            if m is None:
                m = cls(full, help_, **kw)
                self._metrics[full] = m
            elif not isinstance(m, cls):
                raise TypeError(f"metric {full} already registered as "
                                f"{type(m).__name__}, not {cls.__name__}")
            return m

    def counter(self, name: str, help_: str = "") -> Counter:
        return self._get(Counter, name, help_)

    def gauge(self, name: str, help_: str = "") -> Gauge:
        return self._get(Gauge, name, help_)

    def histogram(self, name: str, help_: str = "",
                  buckets: Sequence[float] = LATENCY_BUCKETS_MS
                  ) -> Histogram:
        return self._get(Histogram, name, help_, buckets=buckets)

    def metrics(self) -> list:
        with self._lock:
            return list(self._metrics.values())

    def snapshot(self) -> dict:
        """Flat {series_name: value} of every metric -- the form the
        jsonl epoch/cycle events and the flight recorder embed. Counters
        and gauges contribute their samples; histograms contribute
        count/sum + derived p50/p99."""
        out: dict[str, float] = {}
        for m in self.metrics():
            if isinstance(m, Histogram):
                for key in [()] + m.label_keys():
                    lbl = _fmt_labels(key)
                    _counts, s, n = m._read(key)
                    if key and n == 0:
                        continue
                    out[m.name + "_count" + lbl] = n
                    out[m.name + "_sum" + lbl] = round(s, 3)
                    for q, tag in ((0.5, "_p50"), (0.99, "_p99")):
                        v = m.quantile(q, key=key)
                        if v is not None:
                            out[m.name + tag + lbl] = round(v, 3)
            else:
                for name, lbl, v in m.samples():
                    out[name + lbl] = v
        return out


def render_prometheus(*registries: MetricsRegistry) -> str:
    """Prometheus text exposition (version 0.0.4) of one or more
    registries -- serve merges its own with the process default."""
    lines = []
    seen = set()
    for reg in registries:
        for m in reg.metrics():
            if m.name in seen:
                continue
            seen.add(m.name)
            # HELP/TYPE must name the sample FAMILY (a counter's samples
            # carry the _total suffix, so its family does too; declaring
            # the bare name would orphan every sample under a strict
            # parser) -- pinned by the round-trip test in tests/
            if m.help:
                # HELP text: escape backslash and newline (format spec)
                help_ = m.help.replace("\\", "\\\\").replace("\n", "\\n")
                lines.append(f"# HELP {m.family} {help_}")
            lines.append(f"# TYPE {m.family} {m.kind}")
            for name, lbl, v in m.samples():
                lines.append(f"{name}{lbl} {_fmt_value(v)}")
    return "\n".join(lines) + "\n"


# --- process-wide default registry -------------------------------------------

_DEFAULT: Optional[MetricsRegistry] = None
_DEFAULT_LOCK = threading.Lock()


def default_registry() -> MetricsRegistry:
    """The process-wide registry cross-cutting series land in (program
    builds, device telemetry)."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        if _DEFAULT is None:
            _DEFAULT = MetricsRegistry()
        return _DEFAULT


# --- program builds: the runtime counterpart of a retrace counter ---------

#: kinds of ``cuda_program_builds``
PROGRAM_BUILD_KINDS = ("cuda_graph", "kernel_library")


def program_builds() -> Counter:
    """The default registry's ``cuda_program_builds`` counter, by
    ``kind`` (``PROGRAM_BUILD_KINDS``); process-cumulative, so readers
    take deltas."""
    return default_registry().counter(
        "cuda_program_builds", "CUDA graph captures and kernel library "
        "builds in this process (the port's counterpart of XLA compiles)")


def count_program_build(kind: str) -> None:
    """Count one CUDA graph capture or kernel library build."""
    if kind not in PROGRAM_BUILD_KINDS:
        raise ValueError(f"program build kind {kind!r} is not one of "
                         f"{PROGRAM_BUILD_KINDS}")
    program_builds().labels(kind=kind).inc()


# --- stdlib HTTP sidecar -----------------------------------------------------


class MetricsServer:
    """A stdlib HTTP sidecar serving GET /metrics (Prometheus text of
    ``registries``) and /healthz, for the planes without an HTTP front of
    their own (the trainer, the daemon; ``-metrics-port``). Port 0 picks
    an ephemeral port: read ``.port`` after ``start()``; ``stop()``
    releases the listening socket."""

    def __init__(self, registries: Sequence[MetricsRegistry],
                 port: int = 0, host: str = "127.0.0.1"):
        self.registries = tuple(registries)
        self.host = host
        self.port = int(port)
        self._httpd = None
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "MetricsServer":
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        registries = self.registries

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                if self.path == "/metrics":
                    body = render_prometheus(*registries).encode()
                    ctype = "text/plain; version=0.0.4"
                elif self.path == "/healthz":
                    body, ctype = b'{"status": "ok"}', "application/json"
                else:
                    self.send_response(404)
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        class _Server(ThreadingHTTPServer):
            daemon_threads = True

        self._httpd = _Server((self.host, self.port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True, name="mpgcn-metrics")
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            # release the socket: a restart on a fixed port must bind
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
