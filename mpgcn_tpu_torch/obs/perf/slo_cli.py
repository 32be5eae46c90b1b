"""``python -m mpgcn_tpu_torch.cli slo``: the operator's SLO read surface
(counterpart of mpgcn_tpu/obs/perf/slo_cli.py). No torch.

    ... slo -out ./service          # live server, or the ledger
    ... slo -out ./service --json   # machine-readable

A live evaluation first: when ``<out>/serve/http.json`` names a running
server, its ``/v1/stats`` carries the in-process SLO engine's "slo"
section (and, in fleet mode, each tenant's breaker). Without one, an
offline evaluation over ``serve/requests.jsonl``: exact windowed p99 and
shed ratios from the ledger rows against the same objectives
(config.py ``default_slos("serve")``), labelled ``source: ledger``. Exits
1 when an objective is burning.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional

from mpgcn_tpu_torch.config import default_slos
from mpgcn_tpu_torch.utils.logging import read_events


def _scrape_live(output_dir: str, timeout: float = 2.0) -> Optional[dict]:
    info_path = os.path.join(output_dir, "serve", "http.json")
    try:
        with open(info_path) as f:
            info = json.load(f)
        import urllib.request

        url = f"http://{info['host']}:{info['port']}/v1/stats"
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return json.load(r)
    except Exception:
        return None


def _pct(sorted_vals: list, q: float) -> Optional[float]:
    if not sorted_vals:
        return None
    return sorted_vals[min(len(sorted_vals) - 1,
                           int(len(sorted_vals) * q))]


def evaluate_ledger(output_dir: str, specs=None) -> dict:
    """Offline SLO evaluation over serve/requests.jsonl: the same
    objectives, exact (not bucketed) windowed percentiles, windows
    anchored at the newest row's relative timestamp."""
    specs = [dict(s) for s in (specs or default_slos("serve"))]
    path = os.path.join(output_dir, "serve", "requests.jsonl")
    rows = [r for r in read_events(path, "request", rotated=True)
            if "t" in r] if os.path.exists(path) else []
    report: dict = {"source": "ledger", "rows": len(rows), "slos": []}
    if not rows:
        report["note"] = (f"no request rows under {path} and no live "
                          f"server; nothing to evaluate")
        return report
    now = max(float(r["t"]) for r in rows)
    for spec in specs:
        if spec["kind"] not in ("latency_p99", "bad_ratio"):
            continue  # ledger rows only carry the request-plane signals
        entry = {"name": spec["name"], "kind": spec["kind"],
                 "objective": spec["objective"],
                 "windows_s": list(spec["windows_s"])}
        burns: dict[str, dict] = {}
        for wname, wsecs in zip(("short", "long"), spec["windows_s"]):
            win = [r for r in rows if float(r["t"]) >= now - wsecs]
            groups: dict[str, list] = {"": win}
            for r in win:
                tid = r.get("tenant")
                if tid:
                    groups.setdefault(str(tid), []).append(r)
            for key, g in groups.items():
                info = burns.setdefault(key, {"burn": {}, "value": None})
                if spec["kind"] == "latency_p99":
                    lats = sorted(float(r["latency_ms"]) for r in g
                                  if r.get("outcome") == "ok"
                                  and r.get("latency_ms") is not None)
                    p99 = _pct(lats, 0.99)
                    burn = (p99 / spec["objective"]
                            if p99 is not None and spec["objective"] > 0
                            else 0.0)
                    value = p99
                else:
                    bad = sum(str(r.get("outcome", "")).startswith(
                        tuple(spec.get("bad_prefixes",
                                       ("shed-", "error-"))))
                        for r in g)
                    ratio = bad / len(g) if g else None
                    burn = (ratio / spec["objective"]
                            if ratio is not None and spec["objective"] > 0
                            else 0.0)
                    value = None if ratio is None else round(ratio, 4)
                info["burn"][wname] = round(burn, 3)
                if wname == "short":
                    info["value"] = value
        thr = spec.get("burn_threshold", 2.0)
        for info in burns.values():
            s, lo = info["burn"].get("short", 0), info["burn"].get("long",
                                                                   0)
            info["state"] = ("burning" if s >= thr and lo >= thr
                             else "warn" if s >= 1.0 or lo >= 1.0
                             else "ok")
        overall = burns.pop("", {"burn": {}, "value": None, "state": "ok"})
        entry.update(state=overall["state"], value=overall["value"],
                     burn=overall["burn"])
        if burns:
            entry["tenants"] = dict(sorted(burns.items()))
            for info in burns.values():
                if info["state"] == "burning":
                    entry["state"] = "burning"
                elif info["state"] == "warn" and entry["state"] == "ok":
                    entry["state"] = "warn"
        report["slos"].append(entry)
    return report


def _fmt_value(entry: dict) -> str:
    v = entry.get("value")
    if v is None:
        return "-"
    unit = " ms" if entry.get("kind") == "latency_p99" else ""
    return f"{v}{unit}"


def _print_report(report: dict, tenants_meta: Optional[dict]) -> None:
    src = report.get("source", "live")
    print(f"source: {src}" + (f" ({report.get('rows')} ledger rows)"
                              if src == "ledger" else ""))
    slos = report.get("slos", [])
    if not slos:
        print(report.get("note", "no SLOs evaluated"))
        return
    for e in slos:
        burn = e.get("burn") or {}
        print(f"{e.get('state', '?').upper():>8}  {e['name']}: "
              f"value {_fmt_value(e)}  objective {e.get('objective')}  "
              f"burn {burn.get('short', 0)}/{burn.get('long', 0)} "
              f"(short/long)")
        per = e.get("tenants") or {}
        for tid, info in sorted(per.items()):
            b = info.get("burn") or {}
            breaker = ""
            meta = (tenants_meta or {}).get(tid) or {}
            if meta.get("breaker"):
                breaker = f"  breaker={meta['breaker']}"
            print(f"          tenant {tid}: {info.get('state', '?')} "
                  f"value {info.get('value')}  "
                  f"burn {b.get('short', 0)}/{b.get('long', 0)}"
                  f"{breaker}")
    if tenants_meta:
        unavailable = [t for t, m in sorted(tenants_meta.items())
                       if not m.get("available", True)]
        if unavailable:
            print(f"unavailable tenants: {', '.join(unavailable)}")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m mpgcn_tpu_torch.cli slo",
        description="SLO state of a serving root: live in-process "
                    "evaluation when the server is up, offline ledger "
                    "evaluation otherwise.")
    p.add_argument("-out", "--output_dir", default="./service")
    p.add_argument("--json", action="store_true")
    return p


def main(argv=None) -> int:
    ns = build_parser().parse_args(argv)
    live = _scrape_live(ns.output_dir)
    tenants_meta = None
    if live is not None and "slo" in live:
        report = dict(live["slo"])
        report["source"] = "live"
        tenants_meta = live.get("tenants")
    else:
        report = evaluate_ledger(ns.output_dir)
    if ns.json:
        if tenants_meta:
            report = dict(report, tenant_meta={
                t: {"breaker": m.get("breaker"),
                    "available": m.get("available")}
                for t, m in tenants_meta.items()})
        print(json.dumps(report, indent=1))
    else:
        _print_report(report, tenants_meta)
    # nonzero when anything is burning: scriptable
    burning = any(e.get("state") == "burning"
                  for e in report.get("slos", []))
    return 1 if burning else 0


if __name__ == "__main__":
    raise SystemExit(main())
