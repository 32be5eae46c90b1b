"""``python -m mpgcn_tpu_torch.cli tune``: measure the dispatch
crossovers, plan the serving shapes, print the registry (counterpart of
mpgcn_tpu/tune/cli.py).

  tune run      measure each constant's crossover on the card
                (``--device cpu`` for the CPU; tune/measure.py) and
                store tuned/torch-<platform>.json with provenance
                (torch and CUDA versions, the card's name and power
                limit, the curves)
  tune buckets  derive the bucket set with the least expected pad waste
                over a request trace or ledger under a capture budget
                (tune/planner.py); --write stores it as serve_buckets /
                serve_horizons
  tune show     the registry table: guessed default against tuned
                value, per platform

Only ``tune run`` imports torch; ``buckets`` and ``show`` run wherever
the ledger is. ``--platform`` takes ``cuda`` or ``cpu`` (the profile
keys are ``torch-cuda`` / ``torch-cpu``).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import Optional

PLATFORM_CHOICES = ("cuda", "cpu")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m mpgcn_tpu_torch.cli tune",
        description="Self-tuning dispatch: replace the guessed "
                    "constants with measured per-platform crossovers "
                    "(tune/registry.py).")
    sub = p.add_subparsers(dest="cmd", required=True)

    run = sub.add_parser("run", help="measure crossovers on the device "
                                     "and write the profile")
    run.add_argument("--harnesses", default="",
                     help="comma-separated harness names (tune/measure"
                          ".py HARNESSES); empty = every harness "
                          "meaningful on this platform")
    run.add_argument("--steps", type=int, default=2)
    run.add_argument("--reps", type=int, default=2,
                     help="best-of repetitions per arm, the arms "
                          "interleaved")
    run.add_argument("--tuned-dir", default=None,
                     help="profile directory (default: "
                          "$MPGCN_TUNED_DIR, else tuned/ at the repo's "
                          "root)")
    run.add_argument("--dry-run", action="store_true",
                     help="measure and print, write nothing")
    run.add_argument("--device", default="cuda",
                     help="torch device to measure on ('cuda', "
                          "'cuda:1', or 'cpu'); without a card only "
                          "'cpu' runs")

    bk = sub.add_parser("buckets", help="plan the bucket set from "
                                        "observed traffic (no torch)")
    bk.add_argument("--trace", required=True,
                    help="request trace or ledger jsonl (the serve "
                         "engine's <out>/serve/requests.jsonl, or a bare "
                         "{t, horizon} trace)")
    bk.add_argument("--max-compiles", type=int, default=None,
                    help="capture budget |buckets| x |horizons| "
                         "(default: the hand-picked set's own count)")
    bk.add_argument("--max-wait-ms", type=float, default=5.0,
                    help="staging window replayed by the coalescer "
                         "(match serve's --max-wait-ms)")
    bk.add_argument("--default-buckets", default="1,2,4,8",
                    help="the hand-picked set to beat")
    bk.add_argument("--platform", default=None, choices=PLATFORM_CHOICES,
                    help="profile platform for --write (default: cuda "
                         "where an imported torch sees a card, else cpu)")
    bk.add_argument("--tuned-dir", default=None)
    bk.add_argument("--write", action="store_true",
                    help="store the planned serve_buckets / "
                         "serve_horizons in tuned/torch-<platform>.json")

    show = sub.add_parser("show", help="registry table: guessed against "
                                       "tuned per platform (no torch)")
    show.add_argument("--platform", default=None, choices=PLATFORM_CHOICES)
    show.add_argument("--tuned-dir", default=None)
    return p


def card_name_and_limit() -> Optional[str]:
    """``nvidia-smi --query-gpu=name,power.limit`` of the first card, or
    None where it does not answer."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else None


def _provenance(extra: Optional[dict] = None, device=None) -> dict:
    """Timestamp, and where torch is already imported its and CUDA's
    versions; with a CUDA ``device`` the card as nvidia-smi names it.
    Never imports torch."""
    prov = {"timestamp": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                       time.gmtime())}
    torch = sys.modules.get("torch")
    if torch is not None:
        prov["torch"] = torch.__version__
        prov["cuda"] = torch.version.cuda
    if device is not None:
        prov["device"] = str(device)
        if device.type == "cuda":
            prov["card"] = torch.cuda.get_device_name(device)
            prov["nvidia_smi"] = card_name_and_limit()
    prov.update(extra or {})
    return prov


def _cmd_run(ns) -> int:
    if ns.tuned_dir:
        os.environ["MPGCN_TUNED_DIR"] = ns.tuned_dir
    from mpgcn_tpu_torch.tune import measure, registry

    names = [h for h in ns.harnesses.split(",") if h.strip()] or None
    if names:
        unknown = [h for h in names if h not in measure.HARNESSES]
        if unknown:
            print(f"unknown harness(es) {unknown}; available: "
                  f"{sorted(measure.HARNESSES)}")
            return 2
    try:
        device = measure.resolve_tune_device(ns.device)
    except (RuntimeError, ValueError) as e:
        raise SystemExit(f"tune run: {e}") from None
    values, curves, notes = measure.run_harnesses(
        names, steps=ns.steps, reps=ns.reps, device=device)
    for h, note in notes.items():
        if isinstance(note, str):
            print(f"[tune] {h}: SKIPPED -- {note}")
    print(json.dumps({"measured": values,
                      "notes": {h: n for h, n in notes.items()
                                if isinstance(n, str)}},
                     indent=2, sort_keys=True, default=str))
    if ns.dry_run:
        return 0
    if not values:
        print("[tune] nothing measured on this platform; no profile "
              "written")
        return 0
    path = registry.save_profile(
        values, platform=registry.device_platform(device), curves=curves,
        provenance=_provenance({"harnesses": sorted(notes)}, device))
    print(f"[tune] wrote {path}")
    return 0


def _cmd_buckets(ns) -> int:
    if ns.tuned_dir:
        os.environ["MPGCN_TUNED_DIR"] = ns.tuned_dir
    from mpgcn_tpu_torch.tune import planner, registry

    arrivals = planner.load_requests(ns.trace)
    if not arrivals:
        print(f"no request arrivals found in {ns.trace}")
        return 2
    default = tuple(int(b) for b in ns.default_buckets.split(",")
                    if b.strip())
    cmp = planner.replay_compare(arrivals, default,
                                 max_compiles=ns.max_compiles,
                                 max_wait_s=ns.max_wait_ms / 1000.0)
    print(json.dumps(cmp, indent=2, sort_keys=True))
    if ns.write:
        values = {"serve_buckets": tuple(cmp["planned_buckets"])}
        horizons = [h for h in cmp["horizons"] if h >= 1]
        if horizons:
            values["serve_horizons"] = tuple(horizons)
        path = registry.save_profile(
            values, platform=ns.platform,
            provenance=_provenance({
                "bucket_planner": {
                    "trace": os.path.abspath(ns.trace),
                    "requests": cmp["requests"],
                    "pad_waste_default": cmp["pad_waste_default"],
                    "pad_waste_planned": cmp["pad_waste_planned"]}}))
        print(f"[tune] wrote {path}")
    return 0


def _cmd_show(ns) -> int:
    if ns.tuned_dir:
        os.environ["MPGCN_TUNED_DIR"] = ns.tuned_dir
    from mpgcn_tpu_torch.tune import registry

    plat = registry.current_platform(ns.platform)
    prof = registry.load_profile(plat) or {}
    tuned = prof.get("constants", {})
    print(f"platform: {plat}  profile: "
          f"{registry.profile_path(plat)}"
          f"{'' if tuned else '  (none -- guessed defaults active)'}")
    hdr = f"{'constant':28} {'guessed':>14} {'tuned':>14}  harness"
    print(hdr)
    print("-" * len(hdr))
    for c in registry.CONSTANTS:
        t = tuned.get(c.name)
        print(f"{c.name:28} {str(c.default):>14} "
              f"{str(t) if t is not None else '-':>14}  {c.harness}")
    if prof.get("provenance"):
        print(f"provenance: "
              f"{json.dumps(prof['provenance'], sort_keys=True)}")
    return 0


def main(argv=None) -> int:
    ns = build_parser().parse_args(argv)
    if ns.cmd == "run":
        return _cmd_run(ns)
    if ns.cmd == "buckets":
        return _cmd_buckets(ns)
    return _cmd_show(ns)


if __name__ == "__main__":
    raise SystemExit(main())
