"""``python -m mpgcn_tpu_torch.cli scenario``: the scenario engine's
operator surface (counterpart of mpgcn_tpu/scenarios/cli.py).

    ... scenario list                         # registered profiles
    ... scenario gen -profile metro-loop -out ./spool --days 34
    ... scenario run -out ./fleet --profiles taxi-midtown,bike-harbor,metro-loop

``list`` and ``gen`` need no torch (the profile registry and the numpy
generators); ``run`` is the federation driver: it provisions one fleet
tenant per profile, writes each tenant's spool, runs each tenant's own
continual-learning daemon (service/daemon.py) to a promoted checkpoint,
on the card unless ``--device cpu``, and prints the cross-tenant report.
Serve the result with ``serve --fleet -out ./fleet --horizons 1,3,6``.
"""

from __future__ import annotations

import argparse
import json


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m mpgcn_tpu_torch.cli scenario",
        description="Scenario engine: declarative multi-city / "
                    "multi-modal / multi-horizon workload profiles "
                    "feeding the serving fleet.")
    sub = p.add_subparsers(dest="action", required=True)

    sub.add_parser("list", help="registered profiles + their declared "
                                "statistics")

    g = sub.add_parser("gen", help="materialize one profile as a "
                                   "daemon spool (day_<idx>.npy + "
                                   "adjacency.npy)")
    g.add_argument("-profile", "--profile", required=True)
    g.add_argument("-out", "--output_dir", required=True,
                   help="spool directory the day files land in")
    g.add_argument("--days", type=int, default=0,
                   help="days to write (0 = the profile's full series)")
    g.add_argument("--start-day", type=int, default=0,
                   help="first day index (successive gens extend the "
                        "same stream)")
    g.add_argument("--no-validate", dest="validate",
                   action="store_false",
                   help="skip the declared-statistics validation")

    r = sub.add_parser("run", help="federation driver: provision one "
                                   "fleet tenant per profile, run each "
                                   "tenant's daemon to a promoted "
                                   "checkpoint, print the cross-tenant "
                                   "report")
    r.add_argument("-out", "--output_dir", required=True,
                   help="fleet root (fleet/registry.json + "
                        "tenants/<profile>/)")
    r.add_argument("--profiles", required=True,
                   help="comma-separated profile names (one tenant "
                        "each; must be shape-compatible)")
    r.add_argument("--days", type=int, default=34,
                   help="spool days written per tenant")
    r.add_argument("--start-day", type=int, default=0,
                   help="first day index (successive runs extend each "
                        "tenant's stream)")
    r.add_argument("--window-days", type=int, default=34)
    r.add_argument("--val-days", type=int, default=3)
    r.add_argument("--holdout-days", type=int, default=4)
    r.add_argument("--retrain-cadence", type=int, default=4)
    r.add_argument("-epoch", "--num_epochs", type=int, default=3)
    r.add_argument("-hidden", "--hidden_dim", type=int, default=8)
    r.add_argument("-lr", "--learn_rate", type=float, default=3e-3)
    r.add_argument("-faults", "--faults", type=str, default="",
                   help="chaos spec applied to EVERY tenant daemon "
                        "(per-tenant targeting belongs to tests)")
    r.add_argument("--json", action="store_true")
    r.add_argument("--device", default="cuda",
                   help="where the tenant daemons retrain: 'cuda' (the "
                        "default; the command refuses to start without "
                        "it) or 'cpu' (the plain PyTorch versions of the "
                        "kernels)")
    return p


def _list() -> int:
    from mpgcn_tpu_torch.scenarios.profiles import get_profile, list_profiles

    out = {name: get_profile(name).describe() for name in list_profiles()}
    print(json.dumps(out, indent=1))
    return 0


def _gen(ns) -> int:
    from mpgcn_tpu_torch.scenarios.profiles import get_profile, write_spool

    profile = get_profile(ns.profile)
    paths = write_spool(profile, ns.output_dir,
                        days=ns.days or None, start_day=ns.start_day,
                        validate=ns.validate)
    print(f"wrote {len(paths)} day file(s) for {profile.name!r} "
          f"(days {ns.start_day}..{ns.start_day + len(paths) - 1}) + "
          f"adjacency.npy under {ns.output_dir}")
    return 0


def _run(ns) -> int:
    # the only branch that imports torch: daemons retrain through
    # ModelTrainer; no card, nothing provisioned
    from mpgcn_tpu_torch.device import resolve_device
    from mpgcn_tpu_torch.scenarios.federation import (
        federation_report,
        provision,
        run_tenant_daemon,
    )

    try:
        device = resolve_device(ns.device)
    except (RuntimeError, ValueError) as e:
        raise SystemExit(f"scenario run: {e}") from None

    names = [n.strip() for n in ns.profiles.split(",") if n.strip()]
    provision(ns.output_dir, names, days=ns.days,
              start_day=ns.start_day)
    for name in names:
        print(f"[scenario] running tenant daemon {name!r} ...",
              flush=True)
        summary = run_tenant_daemon(
            ns.output_dir, name, faults=ns.faults, device=device,
            window_days=ns.window_days, val_days=ns.val_days,
            holdout_days=ns.holdout_days,
            retrain_cadence=ns.retrain_cadence,
            num_epochs=ns.num_epochs, hidden_dim=ns.hidden_dim,
            learn_rate=ns.learn_rate)
        print(f"[scenario] {name}: promoted={summary['promoted']} "
              f"rejected={summary['rejected']} quarantined="
              f"{summary['quarantined_days']} steps_last_retrain="
              f"{summary['steps_last_retrain']}", flush=True)
    report = federation_report(ns.output_dir)
    if ns.json:
        print(json.dumps(report, indent=1))
    else:
        print("federation report:")
        for tid, sec in sorted(report["tenants"].items()):
            print(f"  {tid}: modality={sec.get('modality')} "
                  f"horizon={sec.get('horizon')} "
                  f"promoted={sec['promoted']} "
                  f"rejected={sec['rejected']} "
                  f"quarantined={sec['quarantined_days']} "
                  f"rmse={sec['last_cand_rmse']}")
        print(f"  cross-tenant: {json.dumps(report['cross_tenant'])}")
    return 0


def main(argv=None) -> int:
    ns = build_parser().parse_args(argv)
    if ns.action == "list":
        return _list()
    if ns.action == "gen":
        return _gen(ns)
    return _run(ns)


if __name__ == "__main__":
    raise SystemExit(main())
