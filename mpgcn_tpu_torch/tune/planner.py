"""Traffic-driven serving-shape planner (counterpart of
mpgcn_tpu/tune/planner.py).

The serve engine captures one rollout graph per (slot, bucket,
horizon), and the micro-batcher pads every dispatched group up to the
smallest bucket that fits (service/batcher.py ``pick_bucket``) -- so
the bucket set decides the pad waste paid at observed load, ``(padded
- live) / padded`` elements. This module derives the set with the
least expected pad waste over a request ledger's observed group sizes,
under a budget on the captures (``|buckets| x |horizons|``).

  1. `load_requests` -- arrivals from the serve engine's
     ``<out>/serve/requests.jsonl`` rows (``event == "request"``) or a
     bare ``{"t": seconds, "horizon": h}`` trace;
  2. `coalesce` -- replay of the batcher's staging rule (wait at most
     ``max_wait_s`` for co-travelers, cap at the largest bucket) ->
     dispatched group sizes;
  3. `plan_buckets` -- exact DP over the observed group sizes: at most
     K bucket values, the largest observed size always one, with the
     least padded elements;
  4. `replay_compare` -- the planned set against a hand-picked one over
     the same trace, at equal or fewer captures.

Surfaced as ``tune buckets``; ``--write`` stores the planned set as
``serve_buckets`` / ``serve_horizons`` in ``tuned/<platform>.json``,
which ``serve`` resolves through explicit > tuned > default.

Imports neither torch nor JAX: planning runs wherever the ledger is.
"""

from __future__ import annotations

import json
from collections import Counter
from typing import Optional, Sequence

from mpgcn_tpu_torch.service.batcher import pick_bucket

#: default staging window replayed by `coalesce` (ServeConfig
#: max_wait_ms's order of magnitude; pass the real config's)
DEFAULT_MAX_WAIT_S = 0.005


def load_requests(path: str) -> list:
    """[(t_seconds, horizon)] arrivals, sorted by t.

    Takes the serve request ledger (rows with ``event == "request"``;
    every arrival counts, shed requests were load too) and bare traces
    (rows with ``t`` / ``horizon`` only). Malformed lines are skipped: a
    half-written ledger never crashes the planner."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                row = json.loads(line)
            except json.JSONDecodeError:
                continue
            if not isinstance(row, dict):
                continue
            if "event" in row and row["event"] != "request":
                continue
            t = row.get("t")
            if not isinstance(t, (int, float)):
                continue
            h = row.get("horizon")
            out.append((float(t), int(h) if isinstance(h, int) else 0))
    out.sort()
    return out


def coalesce(arrivals: Sequence[tuple], max_wait_s: float,
             max_batch: int) -> list:
    """Dispatched (size, horizon) groups of an arrival stream: per
    horizon, the first queued request opens a ``max_wait_s`` window,
    everything arriving inside it rides along, at most ``max_batch``
    (a fuller window opens a fresh group, as the worker's next collect
    does)."""
    groups = []
    by_h: dict = {}
    for t, h in arrivals:
        by_h.setdefault(h, []).append(t)
    for h, ts in sorted(by_h.items()):
        i = 0
        while i < len(ts):
            j = i
            deadline = ts[i] + max_wait_s
            while j < len(ts) and ts[j] <= deadline \
                    and (j - i) < max_batch:
                j += 1
            groups.append((j - i, h))
            i = j
    return groups


def pad_waste(group_sizes: Sequence[int], buckets: Sequence[int]) -> dict:
    """Padded / live element totals of dispatching ``group_sizes``
    through ``buckets`` (sorted ascending). A group above buckets[-1]
    splits into full buckets and a remainder, as the batcher's collect
    cap does."""
    bmax = buckets[-1]
    live = padded = dispatches = 0
    for n in group_sizes:
        while n > 0:
            take = min(n, bmax)
            b = pick_bucket(take, buckets)
            live += take
            padded += b
            dispatches += 1
            n -= take
    ratio = (padded - live) / padded if padded else 0.0
    return {"live": live, "padded": padded, "dispatches": dispatches,
            "waste_ratio": ratio}


def plan_buckets(group_sizes: Sequence[int], max_buckets: int) -> tuple:
    """The bucket set of at most ``max_buckets`` values with the fewest
    padded elements over the observed group sizes (exact DP, O(m^2 K)
    in the m distinct sizes). The largest observed size is always a
    bucket: without it every such group pays a split dispatch."""
    if not group_sizes:
        return ()
    if max_buckets < 1:
        raise ValueError("max_buckets must be >= 1")
    counts = Counter(int(n) for n in group_sizes if n > 0)
    sizes = sorted(counts)
    m = len(sizes)
    k_max = min(max_buckets, m)
    # cost(i, j): groups of sizes[i..j] all padded up to sizes[j]
    prefix_cnt = [0] * (m + 1)
    prefix_sum = [0] * (m + 1)
    for idx, s in enumerate(sizes):
        prefix_cnt[idx + 1] = prefix_cnt[idx] + counts[s]
        prefix_sum[idx + 1] = prefix_sum[idx] + counts[s] * s

    def cost(i: int, j: int) -> int:
        cnt = prefix_cnt[j + 1] - prefix_cnt[i]
        tot = prefix_sum[j + 1] - prefix_sum[i]
        return cnt * sizes[j] - tot

    INF = float("inf")
    # dp[k][j]: least waste covering sizes[0..j] with k buckets, the
    # k-th at sizes[j]
    dp = [[INF] * m for _ in range(k_max + 1)]
    back = [[-1] * m for _ in range(k_max + 1)]
    for j in range(m):
        dp[1][j] = cost(0, j)
    for k in range(2, k_max + 1):
        for j in range(k - 1, m):
            for i in range(k - 2, j):
                c = dp[k - 1][i] + cost(i + 1, j)
                if c < dp[k][j]:
                    dp[k][j] = c
                    back[k][j] = i
    best_k = min(range(1, k_max + 1), key=lambda k: dp[k][m - 1])
    picks = []
    j, k = m - 1, best_k
    while j >= 0 and k >= 1:
        picks.append(sizes[j])
        j, k = back[k][j], k - 1
    return tuple(sorted(picks))


def replay_compare(arrivals: Sequence[tuple],
                   default_buckets: Sequence[int],
                   max_compiles: Optional[int] = None,
                   max_wait_s: float = DEFAULT_MAX_WAIT_S) -> dict:
    """The planned set against ``default_buckets`` over one trace, the
    same staging replay, at equal or fewer captures (``|buckets| x
    |observed horizons| <= max_compiles``, by default the hand-picked
    set's own count). The key names are the JAX planner's."""
    horizons = sorted({h for _, h in arrivals})
    n_h = max(len(horizons), 1)
    default_buckets = tuple(sorted(default_buckets))
    if max_compiles is None:
        max_compiles = len(default_buckets) * n_h
    groups_default = [n for n, _ in coalesce(
        arrivals, max_wait_s, default_buckets[-1])]
    # plan over the natural group sizes (uncapped windows): the DP's
    # largest pick becomes the planned set's own collect cap
    natural = [n for n, _ in coalesce(arrivals, max_wait_s, 1 << 30)]
    planned = plan_buckets(natural,
                           max_buckets=max(1, max_compiles // n_h))
    groups_planned = [n for n, _ in coalesce(
        arrivals, max_wait_s, planned[-1])] if planned else []
    d = pad_waste(groups_default, default_buckets)
    p = pad_waste(groups_planned, planned) if planned else d
    return {
        "requests": len(arrivals),
        "horizons": horizons,
        "default_buckets": list(default_buckets),
        "planned_buckets": list(planned),
        "default_compiles": len(default_buckets) * n_h,
        "planned_compiles": len(planned) * n_h,
        "max_compiles": max_compiles,
        "default": d,
        "planned": p,
        "pad_waste_default": round(d["waste_ratio"], 6),
        "pad_waste_planned": round(p["waste_ratio"], 6),
        "waste_reduction": round(
            d["waste_ratio"] - p["waste_ratio"], 6),
    }
