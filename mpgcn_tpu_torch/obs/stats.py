"""``python -m mpgcn_tpu_torch.cli stats``: the operator's read surface
over the telemetry plane (counterpart of mpgcn_tpu/obs/stats.py). It reads
the jsonl ledgers and span logs under one root and, when a live server's
``serve/http.json`` is there, scrapes its ``/v1/stats``. No torch.

    ... stats -out ./service               # summary of one root
    ... stats -out ./service --trace <id>  # stitch one trace's span tree
    ... stats -out ./service --json        # machine-readable
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional

from mpgcn_tpu_torch.obs.trace import (
    format_tree,
    read_spans,
    spans_path,
    stitch,
)
from mpgcn_tpu_torch.utils.logging import read_events


def _percentile(sorted_vals: list, q: float) -> Optional[float]:
    if not sorted_vals:
        return None
    return sorted_vals[min(len(sorted_vals) - 1,
                           int(len(sorted_vals) * q))]


def summarize(output_dir: str) -> dict:
    """Offline summary of every ledger family under one service/output
    root (each section present only when its ledger exists)."""
    out: dict = {"output_dir": output_dir}
    req_path = os.path.join(output_dir, "serve", "requests.jsonl")
    if os.path.exists(req_path):
        rows = read_events(req_path, "request", rotated=True)
        outcomes: dict[str, int] = {}
        lats = []
        per_tenant: dict[str, dict] = {}
        for r in rows:
            outcomes[r.get("outcome", "?")] = \
                outcomes.get(r.get("outcome", "?"), 0) + 1
            is_ok = r.get("outcome") == "ok"
            if is_ok and r.get("latency_ms") is not None:
                lats.append(float(r["latency_ms"]))
            tid = r.get("tenant")
            if tid:
                sec = per_tenant.setdefault(
                    tid, {"n": 0, "outcomes": {}, "_lats": []})
                sec["n"] += 1
                sec["outcomes"][r.get("outcome", "?")] = \
                    sec["outcomes"].get(r.get("outcome", "?"), 0) + 1
                if is_ok and r.get("latency_ms") is not None:
                    sec["_lats"].append(float(r["latency_ms"]))
        lats.sort()
        out["requests"] = {"n": len(rows), "outcomes": outcomes,
                           "ok_p50_ms": _percentile(lats, 0.5),
                           "ok_p99_ms": _percentile(lats, 0.99)}
        if per_tenant:
            # the fleet's view (service/fleet.py): one section per tenant
            # fault domain, the shape of the fleet's /v1/stats
            for sec in per_tenant.values():
                tl = sorted(sec.pop("_lats"))
                sec["ok_p50_ms"] = _percentile(tl, 0.5)
                sec["ok_p99_ms"] = _percentile(tl, 0.99)
            out["requests"]["tenants"] = dict(sorted(per_tenant.items()))
    rel_path = os.path.join(output_dir, "serve", "reloads.jsonl")
    if os.path.exists(rel_path):
        rows = read_events(rel_path, rotated=True)
        kinds: dict[str, int] = {}
        for r in rows:
            kinds[r.get("event", "?")] = kinds.get(r.get("event", "?"),
                                                   0) + 1
        out["reloads"] = kinds
    # training-run roots: the trainer's jsonl (any <model>_train_log.jsonl
    # under the root) -- surface the dispatch decision + the sparse graph
    # engine gauges from the latest epoch's registry snapshot
    import glob as _glob

    for tl in sorted(_glob.glob(os.path.join(output_dir,
                                             "*_train_log.jsonl"))):
        starts = read_events(tl, "train_start")
        epochs = read_events(tl, "epoch")
        if not (starts or epochs):
            continue
        sec: dict = {"log": os.path.basename(tl), "epochs": len(epochs)}
        if starts:
            s = starts[-1]
            sec.update({k: s[k] for k in
                        ("bdgcn_impl", "od_storage", "support_density",
                         "loss_scaling", "infer_precision")
                        if k in s})
        if epochs:
            m = epochs[-1].get("metrics", {})
            sparse = {k: v for k, v in m.items()
                      if "graph_support" in k or "sparse" in k}
            if sparse:
                sec["sparse_gauges"] = sparse
            # the precision gauges (quant/): loss scale, scaler skips,
            # int8 round-trip error
            prec = {k: v for k, v in m.items()
                    if "loss_scale" in k or "quant" in k}
            if prec:
                sec["precision_gauges"] = prec
        out.setdefault("train", []).append(sec)
    gate_path = os.path.join(output_dir, "promoted", "promotions.jsonl")
    if os.path.exists(gate_path):
        rows = read_events(gate_path, "gate", rotated=True)
        out["promotions"] = {
            "n": len(rows),
            "promoted": sum(bool(r.get("promoted")) for r in rows),
            "rejected": sum(not r.get("promoted") for r in rows)}
    sp = spans_path(output_dir)
    if os.path.exists(sp):
        rows = read_spans(sp)
        traces = {r.get("trace") for r in rows}
        out["spans"] = {"n": len(rows), "traces": len(traces)}
    # a federated fleet root (scenarios/federation.py): per-tenant
    # promotion, quarantine and drift summaries and the best / worst
    # held-out RMSE (registry and ledger reads only)
    from mpgcn_tpu_torch.scenarios.federation import federation_report

    fed = federation_report(output_dir)
    if fed is not None:
        out["federation"] = fed
    live = _scrape_live(output_dir)
    if live is not None:
        out["live"] = live
    return out


def _scrape_live(output_dir: str, timeout: float = 1.0) -> Optional[dict]:
    """Best-effort /v1/stats scrape of a server whose bound address was
    dropped in serve/http.json; None when unreachable/absent."""
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


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m mpgcn_tpu_torch.cli stats",
        description="Read surface over the telemetry plane: ledger "
                    "summaries, live /v1/stats scrape, and trace-tree "
                    "stitching.")
    p.add_argument("-out", "--output_dir", default="./service",
                   help="service/output root holding the ledgers + "
                        "obs/spans.jsonl")
    p.add_argument("--trace", default=None, metavar="ID",
                   help="stitch and print this trace id's span tree")
    p.add_argument("--spans", action="append", default=[],
                   help="extra span-log path(s) beyond "
                        "<out>/obs/spans.jsonl (repeatable; a trace "
                        "crossing output roots stitches from all)")
    p.add_argument("--json", action="store_true",
                   help="machine-readable output")
    return p


def main(argv=None) -> int:
    ns = build_parser().parse_args(argv)
    if ns.trace:
        rows = []
        for path in [spans_path(ns.output_dir)] + ns.spans:
            rows.extend(read_spans(path, trace=ns.trace))
        if not rows:
            print(f"trace {ns.trace}: no spans found under "
                  f"{ns.output_dir} (looked in "
                  f"{spans_path(ns.output_dir)})")
            return 1
        roots = stitch(rows)
        if ns.json:
            print(json.dumps(roots, indent=1))
        else:
            print(f"trace {ns.trace} ({len(rows)} spans):")
            print(format_tree(roots))
        return 0
    summary = summarize(ns.output_dir)
    if ns.json:
        print(json.dumps(summary, indent=1))
    else:
        for key, val in summary.items():
            print(f"{key}: {json.dumps(val)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
