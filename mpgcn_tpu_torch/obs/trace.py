"""Trace spans (counterpart of mpgcn_tpu/obs/trace.py).

One forecast travels serve -> batcher -> model. A trace id is minted at
request admission (or taken from the ``X-MPGCN-Trace`` HTTP header and
echoed back), and every stage emits one span row into
``<out>/obs/spans.jsonl``::

    {"event": "span", "name": ..., "trace": ..., "span": ...,
     "parent": ...|null, "t0": epoch-secs, "dur_ms": ..., <attrs>}

``stitch`` arranges one trace's rows into a tree and ``format_tree``
renders it. The span log writes through the size-capped rotating
JsonlLogger (utils/logging.py), so a long-lived server cannot fill its
disk with its own telemetry. The serving path emits at ticket
resolution, off the submit path.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
import uuid
from typing import Optional

from mpgcn_tpu_torch.utils.logging import JsonlLogger, read_events, rotated_path

#: HTTP header carrying a caller-supplied trace id into `mpgcn-tpu
#: serve` (and echoed back on the response)
TRACE_HEADER = "X-MPGCN-Trace"

_local = threading.local()


def new_trace_id() -> str:
    return uuid.uuid4().hex[:16]


def new_span_id() -> str:
    return uuid.uuid4().hex[:8]


def spans_path(output_dir: str) -> str:
    return os.path.join(output_dir, "obs", "spans.jsonl")


def current_span() -> Optional[dict]:
    stack = getattr(_local, "stack", None)
    return stack[-1] if stack else None


def current_trace() -> Optional[str]:
    cur = current_span()
    return cur["trace"] if cur else None


class SpanLog:
    """Span emitter over one rotating jsonl file. ``path=None`` is a
    no-op log (spans cost one dict build, no I/O)."""

    def __init__(self, path: Optional[str],
                 rotate_max_bytes: int = 8_000_000):
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.path = path
        self._log = JsonlLogger(path, rotate_max_bytes=rotate_max_bytes)

    def emit(self, name: str, trace: str, span: Optional[str] = None,
             parent: Optional[str] = None, t0: Optional[float] = None,
             dur_ms: Optional[float] = None, **attrs) -> str:
        """Emit one completed span row (the manual form -- serve builds
        request spans from ticket timestamps after the fact)."""
        span = span or new_span_id()
        if self.path:
            self._log.log("span", name=name, trace=trace, span=span,
                          parent=parent,
                          t0=round(t0 if t0 is not None else time.time(), 3),
                          dur_ms=(None if dur_ms is None
                                  else round(dur_ms, 3)),
                          **attrs)
        return span

    def emit_many(self, rows: list) -> None:
        """Emit several completed span rows in ONE ledger append -- the
        serving plane's request chain (request -> batcher -> model)
        resolves on the batcher worker thread, and per-row `emit()`
        would pay one file open per span there. Each row is an
        `emit()`-kwargs dict (name/trace required; span minted, t0/
        dur_ms normalized like emit)."""
        if not self.path or not rows:
            return
        events = []
        for r in rows:
            r = dict(r)
            r.setdefault("span", new_span_id())
            r.setdefault("parent", None)
            t0 = r.get("t0")
            r["t0"] = round(t0 if t0 is not None else time.time(), 3)
            d = r.get("dur_ms")
            r["dur_ms"] = None if d is None else round(d, 3)
            events.append(("span", r))
        self._log.log_many(events)

    @contextlib.contextmanager
    def span(self, name: str, trace: Optional[str] = None,
             parent: Optional[str] = None, **attrs):
        """Context-manager span: times the block, parents implicitly
        under the thread's current span, and re-raises with
        status=error recorded. Yields a dict whose ``attrs`` may be
        filled in mid-flight (e.g. the gate verdict)."""
        cur = current_span()
        if trace is None:
            trace = cur["trace"] if cur else new_trace_id()
        if parent is None and cur is not None and cur["trace"] == trace:
            parent = cur["span"]
        rec = {"trace": trace, "span": new_span_id(), "parent": parent,
               "name": name, "attrs": dict(attrs)}
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        stack.append(rec)
        t0 = time.time()
        try:
            yield rec
            status = "ok"
        except BaseException as e:
            rec["attrs"].setdefault("error",
                                    f"{type(e).__name__}: {e}"[:200])
            status = "error"
            raise
        finally:
            stack.pop()
            self.emit(name, trace, span=rec["span"], parent=parent,
                      t0=t0, dur_ms=(time.time() - t0) * 1e3,
                      status=status, **rec["attrs"])


def read_spans(path: str, trace: Optional[str] = None) -> list[dict]:
    """All span rows (both rotation generations), optionally filtered
    to one trace id."""
    rows = read_events(path, "span", rotated=True)
    if trace is not None:
        rows = [r for r in rows if r.get("trace") == trace]
    return rows


def stitch(rows: list[dict]) -> list[dict]:
    """Arrange one trace's span rows into a tree: returns the roots,
    each row gaining a ``children`` list (chronological). A span whose
    parent never landed (crash, rotation) becomes a root rather than
    disappearing -- postmortems must not hide the orphaned tail."""
    rows = sorted(rows, key=lambda r: (r.get("t0") or 0.0))
    by_id = {}
    for r in rows:
        r = dict(r, children=[])
        by_id[r.get("span")] = r
    roots = []
    for r in by_id.values():
        parent = by_id.get(r.get("parent"))
        if parent is not None and parent is not r:
            parent["children"].append(r)
        else:
            roots.append(r)
    return roots


def format_tree(roots: list[dict]) -> str:
    """Render a stitched trace tree, one indented line per span."""
    lines = []

    def walk(node: dict, depth: int) -> None:
        dur = node.get("dur_ms")
        extra = {k: v for k, v in node.items()
                 if k not in ("event", "t", "t0", "dur_ms", "name",
                              "trace", "span", "parent", "children")
                 and v is not None}
        lines.append("  " * depth
                     + f"{node.get('name', '?')}"
                     + (f"  [{dur:.1f} ms]" if dur is not None else "")
                     + (f"  {extra}" if extra else ""))
        for c in node["children"]:
            walk(c, depth + 1)

    for root in roots:
        walk(root, 0)
    return "\n".join(lines)


__all__ = ["TRACE_HEADER", "SpanLog", "new_trace_id", "new_span_id",
           "spans_path", "current_span", "current_trace", "read_spans",
           "stitch", "format_tree", "rotated_path"]
