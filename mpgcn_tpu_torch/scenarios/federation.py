"""Federation: one continual-learning daemon per tenant, one fleet
(counterpart of mpgcn_tpu/scenarios/federation.py).

``provision`` registers one fleet-registry tenant per scenario profile
(the tenant id is the profile's name; the entry carries the scenario
metadata the fleet exports as labels) and writes each profile as that
tenant's spool stream; ``run_tenant_daemon`` runs the tenant's own
``ContinualDaemon`` (service/daemon.py) in process over its spool into its
own ``promoted/`` slot: the day gate, drift, warm retrains and
eval-before-promote, one fault domain per tenant. ``serve --fleet`` then
serves every promoted slot.

``federation_report`` is the cross-tenant read surface (numpy and json
only, no torch): per-tenant promotion, quality, drift and quarantine
summaries and the best / worst held-out RMSE, read by ``stats`` (its
"federation" section) and ``scenario run``.

Layout under one fleet root (the fleet's conventions):

    <root>/fleet/registry.json            tenant manifest (+ scenario)
    <root>/tenants/<profile>/             tenant service root
        spool/                            the profile's day stream
        accepted/ quarantine/ promoted/   the daemon's layout

The daemons retrain on the card unless ``device="cpu"`` asks for the
plain PyTorch versions of the kernels; one after another in one process,
each retrain's trainer closed after it (service/daemon.py), so the
device memory a tenant leaves does not grow with the tenants.
"""

from __future__ import annotations

import os
from typing import Optional

from mpgcn_tpu_torch.scenarios.profiles import ScenarioProfile, get_profile
from mpgcn_tpu_torch.utils.logging import read_events


def _resolve(profiles) -> list[ScenarioProfile]:
    return [p if isinstance(p, ScenarioProfile) else get_profile(p)
            for p in profiles]


def tenant_spool_dir(tenant_root: str) -> str:
    return os.path.join(tenant_root, "spool")


def provision(root: str, profiles, days: int = 34,
              start_day: int = 0) -> dict:
    """Register one tenant per profile in the fleet manifest (scenario
    metadata included) and write `days` spool days for each (indices
    from `start_day`, so successive calls extend every tenant's stream
    for multi-round scenarios). Shape compatibility across the fleet
    (same N + obs_len: the tenants share one set of captured rollouts) is
    enforced here, at provision time, not at fleet startup. Returns
    {tenant_id: tenant_root}. numpy only."""
    from mpgcn_tpu_torch.scenarios.profiles import write_spool
    from mpgcn_tpu_torch.service.registry import TenantRegistry

    ps = _resolve(profiles)
    reg = TenantRegistry.load(root)
    # shape compatibility must hold across the WHOLE fleet, not just
    # this call: fold in already-registered tenants whose scenario
    # metadata resolves to a known profile (entries without it carry no
    # shape information -- the fleet's own slot load is their gate)
    shapes = {(p.num_nodes, p.obs_len): p.name for p in ps}
    for tid, entry in reg.tenants.items():
        try:
            known = get_profile(entry.get("scenario", ""))
        except KeyError:
            continue
        shapes.setdefault((known.num_nodes, known.obs_len), tid)
    if len(shapes) > 1:
        raise ValueError(
            f"fleet tenants must be shape-compatible (same N + "
            f"obs_len); got {sorted(shapes)} across this provision + "
            f"the existing registry under {root}")
    out = {}
    for p in ps:
        entry = reg.tenants.get(p.name)
        meta = {"scenario": p.name, "city": p.city,
                "modality": p.modality, "horizon": p.horizon}
        if entry is None:
            entry = reg.add(p.name, **meta)
        elif any(entry.get(k) != v for k, v in meta.items()):
            # pre-registered (e.g. `fleet add` without --profile) or
            # stale: stamp/refresh the scenario metadata in place --
            # the obs labels and the federation report read it -- while
            # keeping the entry's root and extra fields
            entry.update(meta)
            reg.save()
        write_spool(p, tenant_spool_dir(entry["root"]), days=days,
                    start_day=start_day)
        out[p.name] = entry["root"]
    return out


def tenant_configs(tenant_root: str, profile: ScenarioProfile,
                   window_days: int = 34, val_days: int = 3,
                   holdout_days: int = 4, retrain_cadence: int = 4,
                   num_epochs: int = 3, hidden_dim: int = 8,
                   learn_rate: float = 3e-3, batch_size: int = 4,
                   faults: str = "", **daemon_kw):
    """(DaemonConfig, MPGCNConfig) for one tenant's daemon, derived from
    its profile (N / obs_len / horizon / folded seed)."""
    from mpgcn_tpu_torch.config import DaemonConfig, MPGCNConfig

    dcfg = DaemonConfig(
        spool_dir=tenant_spool_dir(tenant_root), output_dir=tenant_root,
        window_days=window_days, val_days=val_days,
        holdout_days=holdout_days, retrain_cadence=retrain_cadence,
        num_nodes=profile.num_nodes,
        **{"idle_exits": 1, "poll_secs": 0.0, **daemon_kw})
    tcfg = MPGCNConfig(
        mode="train", data="synthetic",
        input_dir=tenant_spool_dir(tenant_root),
        output_dir=os.path.join(tenant_root, "retrain"),
        obs_len=profile.obs_len, pred_len=profile.horizon,
        batch_size=batch_size, hidden_dim=hidden_dim,
        learn_rate=learn_rate, num_epochs=num_epochs,
        seed=profile.folded_seed, num_nodes=profile.num_nodes,
        faults=faults)
    return dcfg, tcfg


def run_tenant_daemon(root: str, profile: ScenarioProfile | str,
                      faults: str = "", device="cuda", **cfg_kw) -> dict:
    """One bounded daemon pass for one tenant: ingest whatever its spool
    holds, retrain and gate as due, exit on idle (idle_exits=1 by
    default). Returns the tenant's summary (promotions, quarantines,
    steps of the last retrain). This is the ``daemon`` command run in
    process: the same ContinualDaemon, the same ledgers."""
    from mpgcn_tpu_torch.service.daemon import ContinualDaemon
    from mpgcn_tpu_torch.service.registry import TenantRegistry

    if isinstance(profile, str):
        profile = get_profile(profile)
    reg = TenantRegistry.load(root, missing_ok=False)
    tenant_root = reg.tenant_root(profile.name)
    dcfg, tcfg = tenant_configs(tenant_root, profile, faults=faults,
                                **cfg_kw)
    rc = ContinualDaemon(dcfg, tcfg, device=device).run()
    summary = tenant_summary(tenant_root)
    summary["rc"] = rc
    return summary


def _last_retrain_steps(tenant_root: str, model: str = "MPGCN"
                        ) -> Optional[int]:
    """Steps the newest retrain attempt trained for (epoch-event count
    of its per-attempt train log x the run's steps_per_epoch): the
    tenant's steps to promote."""
    import glob

    from mpgcn_tpu_torch.utils.logging import run_log_path

    def attempt_no(path: str) -> int:
        try:
            return int(os.path.basename(path)[1:])
        except ValueError:
            return -1

    # numeric sort: lexicographic would pick a9 over a10 once a tenant
    # has seen ten retrain attempts (the counter persists across rounds)
    attempts = sorted(glob.glob(os.path.join(tenant_root, "retrain",
                                             "a*")), key=attempt_no)
    if not attempts or attempt_no(attempts[-1]) < 0:
        return None
    log = run_log_path(attempts[-1], model, True)
    starts = read_events(log, "train_start")
    epochs = read_events(log, "epoch")
    if not (starts and epochs):
        return None
    return len(epochs) * int(starts[-1].get("steps_per_epoch", 0)) or None


def tenant_summary(tenant_root: str) -> dict:
    """Summary of one tenant's daemon ledgers (no torch: the promotion
    ledger's path is service/promote.py ``ledger_path``'s)."""
    gates = os.path.join(tenant_root, "promoted", "promotions.jsonl")
    gate_rows = (read_events(gates, "gate", rotated=True)
                 if os.path.exists(gates) else [])
    quarantine = os.path.join(tenant_root, "quarantine",
                              "verdicts.jsonl")
    q_rows = (read_events(quarantine, "quarantine", rotated=True)
              if os.path.exists(quarantine) else [])
    dlog = os.path.join(tenant_root, "daemon_log.jsonl")
    drift = (read_events(dlog, "drift") if os.path.exists(dlog) else [])
    promoted = [r for r in gate_rows if r.get("promoted")]
    last = gate_rows[-1] if gate_rows else {}
    return {
        "gates": len(gate_rows),
        "promoted": len(promoted),
        "rejected": len(gate_rows) - len(promoted),
        "quarantined_days": len(q_rows),
        "drift_events": len(drift),
        "last_cand_rmse": last.get("cand_rmse"),
        "last_cand_loss": last.get("cand_loss"),
        "last_verdict": last.get("verdict"),
        "steps_last_retrain": _last_retrain_steps(tenant_root),
    }


def federation_report(root: str) -> Optional[dict]:
    """Cross-tenant drift/quality comparison over one fleet root: one
    summary per tenant (scenario metadata from the registry entry +
    its daemon-ledger summary) plus the cross-tenant ranking. None when
    ``root`` holds no fleet registry. No torch: this is the ``stats``
    command's "federation" section."""
    from mpgcn_tpu_torch.service.registry import (
        RegistryCorruptError,
        TenantRegistry,
        registry_path,
    )

    if not os.path.exists(registry_path(root)):
        return None
    try:
        reg = TenantRegistry.load(root, missing_ok=False)
    except (RegistryCorruptError, FileNotFoundError):
        return None
    tenants = {}
    for tid in reg.ids():
        entry = reg.tenants[tid]
        sec = {k: entry[k] for k in ("scenario", "city", "modality",
                                     "horizon") if k in entry}
        sec.update(tenant_summary(entry["root"]))
        tenants[tid] = sec
    import math

    # a tenant whose LAST gate verdict was a rejected poisoned
    # candidate reports a non-finite rmse -- it must drop out of the
    # ranking, not turn the whole spread into NaN
    scored = [(tid, s["last_cand_rmse"]) for tid, s in tenants.items()
              if isinstance(s.get("last_cand_rmse"), (int, float))
              and math.isfinite(s["last_cand_rmse"])]
    cross: dict = {"tenants_total": len(tenants),
                   "tenants_scored": len(scored)}
    if scored:
        scored.sort(key=lambda kv: kv[1])
        cross["best_rmse"] = {"tenant": scored[0][0],
                              "rmse": scored[0][1]}
        cross["worst_rmse"] = {"tenant": scored[-1][0],
                               "rmse": scored[-1][1]}
        if scored[0][1]:
            cross["rmse_spread"] = round(scored[-1][1] / scored[0][1], 3)
    drifting = sorted(t for t, s in tenants.items()
                      if s.get("drift_events"))
    if drifting:
        cross["drifting"] = drifting
    return {"tenants": tenants, "cross_tenant": cross}
