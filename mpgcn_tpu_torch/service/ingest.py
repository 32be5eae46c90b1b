"""The data-integrity gate of the continual-learning daemon and the
serving plane's request gate (counterpart of mpgcn_tpu/service/ingest.py).

Every day snapshot the daemon ingests passes the gate before it can
enter the training window: schema, shape and dtype checks, non-finite
and negative counts, and a total-flow test against a running profile of
the accepted stream. A failing day is quarantined with a jsonl verdict
and never trained on.

Two profiles live here:

  * ``DayProfile`` + ``validate_day``: a Welford mean/std z-test of each
    day's log1p total flow. One event day drags its mean, and a
    coherent wrong-units day looks like a real spike to it.
  * ``RobustProfile`` + ``classify_day``: a median/MAD z over the
    accepted log totals plus a structure test. An event shock scales
    real demand coherently (its normalized pattern matches the
    profile's and stays on the known support), poison does not. Shock
    days train, poisoned days quarantine, each with a typed verdict
    ``kind``; a day that spikes before the reference pattern has armed
    is ``held`` (quarantined, revisited once the profile arms).

numpy only: the gate runs in the daemon loop before any device work.
"""

from __future__ import annotations

import math
import re

import numpy as np

DAY_RE = re.compile(r"^day_(\d+)\.npy$")


def day_filename(idx: int) -> str:
    return f"day_{idx:05d}.npy"


def parse_day_index(name: str):
    """Day index from a spool filename, or None for other files."""
    m = DAY_RE.match(name)
    return int(m.group(1)) if m else None


class DayProfile:
    """Running profile of the ACCEPTED stream: Welford mean/variance of
    each day's log1p total flow. The z-test against it catches
    wrong-units / duplicated / near-empty days that are individually
    well-formed; it arms only after `min_history` accepted days so a cold
    start cannot reject everything."""

    def __init__(self, count: int = 0, mean: float = 0.0, m2: float = 0.0):
        self.count = int(count)
        self.mean = float(mean)
        self.m2 = float(m2)

    def observe(self, log_total: float) -> None:
        self.count += 1
        delta = log_total - self.mean
        self.mean += delta / self.count
        self.m2 += delta * (log_total - self.mean)

    @property
    def std(self) -> float:
        if self.count < 2:
            return 0.0
        return math.sqrt(self.m2 / (self.count - 1))

    def zscore(self, log_total: float, min_history: int):
        """z of a day's log-total vs the profile, or None while the
        profile is still warming up. The std is floored (5% of |mean|,
        abs 0.05) so a freakishly self-similar warmup window cannot turn
        the test into a hair-trigger."""
        if self.count < max(2, min_history):
            return None
        floor = max(0.05, 0.05 * abs(self.mean))
        return (log_total - self.mean) / max(self.std, floor)

    def state(self) -> dict:
        return {"count": self.count, "mean": self.mean, "m2": self.m2}

    @classmethod
    def from_state(cls, s) -> "DayProfile":
        return cls(**s) if s else cls()


class RobustProfile:
    """Robust profile of the ACCEPTED stream: a bounded
    window of per-day log1p totals scored by median/MAD instead of
    Welford mean/std (one event day cannot drag the center), plus a
    running mean NORMALIZED flow pattern (each accepted day's
    ``arr / arr.sum()``) that anchors the structure test -- coherence
    (cosine vs the reference pattern) and support (mass on OD pairs the
    accepted stream has actually used).

    The totals window rides the daemon's json state (`state()` /
    `from_state`); the (N, N) pattern is persisted SEPARATELY by the
    owner (daemon: atomic ``profile_pattern.npy``) since it does not
    belong in a json document at city scale.
    """

    #: relative floor defining the pattern's support: a cell belongs to
    #: the support once its mean normalized flow exceeds this fraction
    #: of the pattern's peak cell
    SUPPORT_REL = 1e-4

    def __init__(self, totals=None, pattern_count: int = 0,
                 count: int = 0, maxlen: int = 64):
        self.maxlen = max(2, int(maxlen))
        self.totals = [float(t) for t in (totals or [])][-self.maxlen:]
        self.pattern: np.ndarray | None = None  # set by owner / observe
        self.pattern_count = int(pattern_count)
        #: lifetime accepted-day count (the bounded window forgets, the
        #: ledger-facing count must not)
        self.count = int(count)

    def observe(self, log_total: float, arr=None) -> None:
        self.count += 1
        self.totals.append(float(log_total))
        del self.totals[:-self.maxlen]
        if arr is not None:
            a = np.asarray(arr, dtype=np.float64)
            total = float(a.sum())
            if total > 0 and np.isfinite(total):
                norm = a / total
                if (self.pattern is None
                        or self.pattern.shape != norm.shape):
                    self.pattern = norm
                    self.pattern_count = 1
                else:
                    self.pattern_count += 1
                    self.pattern += ((norm - self.pattern)
                                     / self.pattern_count)

    @property
    def median(self) -> float:
        return float(np.median(self.totals)) if self.totals else 0.0

    @property
    def mad(self) -> float:
        if not self.totals:
            return 0.0
        t = np.asarray(self.totals)
        return float(np.median(np.abs(t - np.median(t))))

    def robust_z(self, log_total: float, min_history: int):
        """Median/MAD z of a day's log-total, or None while warming up.
        1.4826*MAD estimates sigma under normality; the same floor as
        DayProfile.zscore keeps a freakishly self-similar warmup window
        from turning the test into a hair-trigger."""
        if len(self.totals) < max(2, min_history):
            return None
        med = self.median
        scale = 1.4826 * self.mad
        floor = max(0.05, 0.05 * abs(med))
        return (log_total - med) / max(scale, floor)

    def pattern_armed(self, min_history: int) -> bool:
        return (self.pattern is not None
                and self.pattern_count >= max(2, min_history))

    def coherence(self, arr) -> float:
        """Cosine similarity between a day's normalized flows and the
        reference pattern (1.0 = a pure coherent rescale of typical
        demand). 0.0 when the pattern has not formed."""
        if self.pattern is None:
            return 0.0
        a = np.asarray(arr, dtype=np.float64).reshape(-1)
        p = self.pattern.reshape(-1)
        na, np_ = float(np.linalg.norm(a)), float(np.linalg.norm(p))
        if na <= 0 or np_ <= 0:
            return 0.0
        return float(a @ p / (na * np_))

    def support_mask(self, adjacency=None) -> np.ndarray | None:
        """Boolean (N, N) mask of OD pairs the accepted stream uses
        (pattern cells above SUPPORT_REL of the peak), optionally
        unioned with the known adjacency support."""
        if self.pattern is None:
            return None
        mask = self.pattern > (float(self.pattern.max())
                               * self.SUPPORT_REL)
        if adjacency is not None:
            adj = np.asarray(adjacency)
            if adj.shape == mask.shape:
                mask = mask | (adj > 0)
        return mask

    def off_support_fraction(self, arr, adjacency=None) -> float:
        """Fraction of a day's total flow landing OUTSIDE the support --
        the structure signal poison cannot fake: scaling real demand
        keeps mass on real OD pairs."""
        mask = self.support_mask(adjacency)
        a = np.asarray(arr, dtype=np.float64)
        total = float(a.sum())
        if mask is None or total <= 0:
            return 0.0
        return float(a[~mask].sum() / total)

    def state(self) -> dict:
        return {"totals": [round(t, 9) for t in self.totals],
                "pattern_count": self.pattern_count,
                "count": self.count, "maxlen": self.maxlen}

    @classmethod
    def from_state(cls, s, maxlen: int = 64) -> "RobustProfile":
        if not s or "totals" not in s:
            # absent, or an older Welford-only dict: start fresh (the
            # robust window re-warms from the accepted stream)
            return cls(maxlen=maxlen)
        return cls(totals=s.get("totals"),
                   pattern_count=s.get("pattern_count", 0),
                   count=s.get("count", len(s.get("totals") or [])),
                   maxlen=s.get("maxlen", maxlen))


#: typed classify_day verdicts: ok=True kinds train, ok=False kinds
#: quarantine; "held" quarantines but is re-classifiable once the
#: pattern arms (the daemon revisits held days each cycle)
KIND_NORMAL = "normal"
KIND_SHOCK = "event-shock"
KIND_HELD = "held"
KIND_POISON = "poisoned-structure"
KIND_INVALID = "invalid"


def classify_day(arr, num_nodes: int, profile: RobustProfile,
                 zmax: float = 6.0, min_history: int = 5,
                 coherence_min: float = 0.90,
                 off_support_max: float = 0.05,
                 adjacency=None) -> dict:
    """Shock-vs-poison gate verdict for one ingested day.

    Pipeline: schema/finite/negative/empty checks (identical walls to
    `validate_day`, kind="invalid") -> robust median/MAD z of the
    log-total -> for |z| > zmax, the STRUCTURE test decides:

      * coherent (cosine vs the reference pattern >= `coherence_min`)
        AND on-support (off-support mass <= `off_support_max`, support
        optionally unioned with the known `adjacency`) -> an event
        shock: real demand scaled by a real-world event. ok=True,
        kind="event-shock" -- it TRAINS.
      * structure violated -> kind="poisoned-structure", quarantined.
      * |z| > zmax before the pattern has armed -> kind="held":
        quarantined for now, but the caller may re-classify once the
        profile arms (the daemon's revisit pass).

    Returns a jsonl-able dict: ok, kind, reason, and the measured
    stats. The caller folds accepted days into the profile via
    ``profile.observe(log_total, arr)`` -- classification never
    mutates the profile."""
    verdict: dict = {"ok": False, "kind": KIND_INVALID, "reason": None}
    a = np.asarray(arr)
    verdict["shape"] = list(a.shape)
    verdict["dtype"] = str(a.dtype)
    if a.dtype.kind not in "fiu":
        verdict["reason"] = f"non-numeric dtype {a.dtype}"
        return verdict
    if a.ndim != 2 or a.shape[0] != a.shape[1]:
        verdict["reason"] = f"not a square (N, N) matrix: {a.shape}"
        return verdict
    if num_nodes and a.shape[0] != num_nodes:
        verdict["reason"] = (f"zone count {a.shape[0]} != expected "
                             f"{num_nodes}")
        return verdict
    a = a.astype(np.float64, copy=False)
    nonfinite = int(np.size(a) - np.isfinite(a).sum())
    verdict["nonfinite"] = nonfinite
    if nonfinite:
        verdict["reason"] = f"{nonfinite} non-finite entries"
        return verdict
    negative = int((a < 0).sum())
    verdict["negative"] = negative
    if negative:
        verdict["reason"] = f"{negative} negative flow entries"
        return verdict
    total = float(a.sum())
    verdict["total_flow"] = round(total, 3)
    if total <= 0:
        verdict["reason"] = "empty day (zero total flow)"
        return verdict
    log_total = math.log1p(total)
    z = profile.robust_z(log_total, min_history)
    if z is not None:
        verdict["z_total"] = round(z, 3)
    if z is None or abs(z) <= zmax:
        verdict["ok"] = True
        verdict["kind"] = KIND_NORMAL
        return verdict
    # outlier magnitude: structure decides shock vs poison
    if not profile.pattern_armed(min_history):
        verdict["kind"] = KIND_HELD
        verdict["reason"] = (
            f"total-flow outlier ({z:+.1f} sigma robust, zmax {zmax}) "
            f"before the reference pattern armed -- held for "
            f"re-classification")
        return verdict
    coh = profile.coherence(a)
    off = profile.off_support_fraction(a, adjacency)
    verdict["coherence"] = round(coh, 4)
    verdict["off_support"] = round(off, 6)
    if coh >= coherence_min and off <= off_support_max:
        verdict["ok"] = True
        verdict["kind"] = KIND_SHOCK
        verdict["reason"] = None
        return verdict
    verdict["kind"] = KIND_POISON
    verdict["reason"] = (
        f"structure violation at {z:+.1f} sigma robust: coherence "
        f"{coh:.3f} (min {coherence_min}) off-support mass {off:.4f} "
        f"(max {off_support_max}) -- an event shock scales real demand "
        f"coherently; this day does not")
    return verdict


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


def validate_day(arr, num_nodes: int, profile: DayProfile,
                 zmax: float = 6.0, min_history: int = 5) -> dict:
    """Integrity verdict for one ingested day snapshot.

    Returns a jsonl-able dict: `ok`, `reason` (None when accepted), and
    the measured stats. `num_nodes`==0 skips the zone-count pin (the
    daemon locks N in from the first accepted day)."""
    verdict: dict = {"ok": False, "reason": None}
    a = np.asarray(arr)
    verdict["shape"] = list(a.shape)
    verdict["dtype"] = str(a.dtype)
    if a.dtype.kind not in "fiu":
        verdict["reason"] = f"non-numeric dtype {a.dtype}"
        return verdict
    if a.ndim != 2 or a.shape[0] != a.shape[1]:
        verdict["reason"] = f"not a square (N, N) matrix: {a.shape}"
        return verdict
    if num_nodes and a.shape[0] != num_nodes:
        verdict["reason"] = (f"zone count {a.shape[0]} != expected "
                             f"{num_nodes}")
        return verdict
    a = a.astype(np.float64, copy=False)
    nonfinite = int(np.size(a) - np.isfinite(a).sum())
    verdict["nonfinite"] = nonfinite
    if nonfinite:
        verdict["reason"] = f"{nonfinite} non-finite entries"
        return verdict
    negative = int((a < 0).sum())
    verdict["negative"] = negative
    if negative:
        verdict["reason"] = f"{negative} negative flow entries"
        return verdict
    total = float(a.sum())
    verdict["total_flow"] = round(total, 3)
    if total <= 0:
        verdict["reason"] = "empty day (zero total flow)"
        return verdict
    log_total = math.log1p(total)
    z = profile.zscore(log_total, min_history)
    if z is not None:
        verdict["z_total"] = round(z, 3)
        if abs(z) > zmax:
            verdict["reason"] = (
                f"total-flow outlier: log1p(total)={log_total:.3f} is "
                f"{z:+.1f} sigma from the running profile "
                f"(mean {profile.mean:.3f}, std {profile.std:.3f}, "
                f"zmax {zmax})")
            return verdict
    verdict["ok"] = True
    return verdict
