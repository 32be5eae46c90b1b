"""Request admission gate and the day files' names (counterpart of
``validate_request``, ``day_filename`` and ``parse_day_index`` in
mpgcn_tpu/service/ingest.py:43-50, 324-377)."""

from __future__ import annotations

import re

import numpy as np

DAY_RE = re.compile(r"^day_(\d+)\.npy$")


def day_filename(idx: int) -> str:
    return f"day_{idx:05d}.npy"


def parse_day_index(name: str):
    """Day index from a spool filename, or None for other files."""
    m = DAY_RE.match(name)
    return int(m.group(1)) if m else None


def validate_request(x, key, obs_len: int, num_nodes: int) -> dict:
    """Integrity verdict for one serving request: an observation window
    ``x`` of shape (obs_len, N, N) or (obs_len, N, N, 1) plus a day-of-week
    ``key`` in [0, 7). A poisoned request is rejected here, with a typed
    per-request verdict, before it can join a shared device batch.

    Returns a verdict dict (``ok``, ``reason``); numpy only."""
    verdict: dict = {"ok": False, "reason": None}
    try:
        a = np.asarray(x)
    except Exception as e:
        verdict["reason"] = f"unparseable input: {type(e).__name__}"
        return verdict
    verdict["shape"] = list(a.shape)
    verdict["dtype"] = str(a.dtype)
    if a.dtype.kind not in "fiu":
        verdict["reason"] = f"non-numeric dtype {a.dtype}"
        return verdict
    if a.ndim == 4 and a.shape[3] == 1:
        a = a[..., 0]
    if (a.ndim != 3 or a.shape[0] != obs_len
            or a.shape[1] != a.shape[2]):
        verdict["reason"] = (f"expected ({obs_len}, N, N[, 1]) observation "
                             f"window, got {verdict['shape']}")
        return verdict
    if num_nodes and a.shape[1] != num_nodes:
        verdict["reason"] = (f"zone count {a.shape[1]} != expected "
                             f"{num_nodes}")
        return verdict
    try:
        k = int(key)
    except (TypeError, ValueError):
        verdict["reason"] = f"non-integer day-of-week key {key!r}"
        return verdict
    if not 0 <= k < 7:
        verdict["reason"] = f"day-of-week key {k} outside [0, 7)"
        return verdict
    a = a.astype(np.float64, copy=False)
    nonfinite = int(np.size(a) - np.isfinite(a).sum())
    if nonfinite:
        verdict["reason"] = f"{nonfinite} non-finite entries"
        return verdict
    negative = int((a < 0).sum())
    if negative:
        verdict["reason"] = f"{negative} negative flow entries"
        return verdict
    verdict["ok"] = True
    return verdict
