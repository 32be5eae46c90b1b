"""The serving fleet's tenant registry (counterpart of
mpgcn_tpu/service/registry.py), in the same file format, so either
package reads the other's registry.

One fleet root holds many tenants, each a fault domain with the daemon
layout of its own:

    <root>/fleet/registry.json          the manifest this module owns
    <root>/tenants/<tenant_id>/         the default tenant service root
        promoted/<model>_od.pkl         the tenant's hot-reload slot
        promoted/promotions.jsonl       the tenant's sequence ledger

The manifest is one JSON document, written only through
``utils/atomic.py`` (tmp + fsync + replace): a kill at any instant leaves
the previous complete manifest or the new one, never a torn file. A file
that is damaged anyway (hand edits, disk rot) raises
``RegistryCorruptError``: the fleet refuses to start on it.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import time
from typing import Optional

from mpgcn_tpu_torch.utils.atomic import atomic_write_bytes

_VERSION = 1
#: tenant ids are path components and metric label values
_TENANT_ID_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9_.-]{0,63}$")


class RegistryCorruptError(RuntimeError):
    """The registry file exists but does not parse or validate (a missing
    file is FileNotFoundError: no fleet configured here)."""


def fleet_dir(root: str) -> str:
    return os.path.join(root, "fleet")


def registry_path(root: str) -> str:
    return os.path.join(fleet_dir(root), "registry.json")


def default_tenant_root(root: str, tenant_id: str) -> str:
    return os.path.join(root, "tenants", tenant_id)


class TenantRegistry:
    """The tenant table of one fleet root and its atomic persistence:
    ``add`` and ``remove`` rewrite the manifest before they return."""

    def __init__(self, root: str, tenants: Optional[dict] = None):
        self.root = root
        self.tenants: dict[str, dict] = dict(tenants or {})

    @classmethod
    def load(cls, root: str, missing_ok: bool = True) -> "TenantRegistry":
        """The manifest under ``root``: a missing file is an empty fleet
        (``missing_ok``) or FileNotFoundError; damage raises
        RegistryCorruptError."""
        path = registry_path(root)
        if not os.path.exists(path):
            if missing_ok:
                return cls(root)
            raise FileNotFoundError(
                f"no fleet registry at {path} (add a tenant first)")
        try:
            with open(path) as f:
                doc = json.load(f)
        except (json.JSONDecodeError, OSError) as e:
            raise RegistryCorruptError(
                f"fleet registry {path} is corrupt "
                f"({type(e).__name__}: {e}); the atomic writer cannot "
                f"produce this -- restore from the tenant dirs or "
                f"re-add tenants") from e
        if (not isinstance(doc, dict) or "tenants" not in doc
                or not isinstance(doc["tenants"], dict)):
            raise RegistryCorruptError(
                f"fleet registry {path} parsed but has no tenant table")
        reg = cls(root, doc["tenants"])
        for tid, entry in reg.tenants.items():
            if not _TENANT_ID_RE.match(tid):
                raise RegistryCorruptError(
                    f"fleet registry {path} holds invalid tenant id "
                    f"{tid!r}")
            if not isinstance(entry, dict) \
                    or not isinstance(entry.get("root"), str) \
                    or not entry["root"]:
                raise RegistryCorruptError(
                    f"fleet registry {path}: tenant {tid!r} entry has "
                    f"no usable 'root' ({entry!r})")
        return reg

    def save(self) -> str:
        """Persist the manifest atomically (old or new bytes, never a
        prefix)."""
        doc = {"version": _VERSION, "updated_at": time.time(),
               "tenants": self.tenants}
        path = registry_path(self.root)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        return atomic_write_bytes(
            path, (json.dumps(doc, indent=1, sort_keys=True) + "\n")
            .encode())

    def add(self, tenant_id: str, tenant_root: Optional[str] = None,
            quota: Optional[int] = None,
            support_payload: Optional[str] = None, **extra) -> dict:
        """Register (or re-register) a tenant and persist. Its service
        root defaults to ``<root>/tenants/<id>``; ``quota`` overrides the
        fleet-wide in-flight quota; ``support_payload`` ('f32', 'bf16',
        'int8') records how this tenant's support banks are stored."""
        if not _TENANT_ID_RE.match(tenant_id or ""):
            raise ValueError(
                f"tenant id {tenant_id!r} must match "
                f"{_TENANT_ID_RE.pattern} (path component + metric "
                f"label)")
        if support_payload is not None \
                and support_payload not in ("f32", "bf16", "int8"):
            raise ValueError(
                f"support_payload={support_payload!r} must be one of "
                f"('f32', 'bf16', 'int8')")
        entry = {
            "root": tenant_root or default_tenant_root(self.root,
                                                       tenant_id),
            "added_at": time.time(),
            **({"quota": int(quota)} if quota is not None else {}),
            **({"support_payload": support_payload}
               if support_payload is not None else {}),
            **extra,
        }
        os.makedirs(entry["root"], exist_ok=True)
        self.tenants[tenant_id] = entry
        self.save()
        return entry

    def remove(self, tenant_id: str) -> None:
        if tenant_id not in self.tenants:
            raise KeyError(f"tenant {tenant_id!r} is not registered")
        del self.tenants[tenant_id]
        self.save()

    def ids(self) -> list[str]:
        return sorted(self.tenants)

    def tenant_root(self, tenant_id: str) -> str:
        return self.tenants[tenant_id]["root"]

    def __len__(self) -> int:
        return len(self.tenants)

    def __contains__(self, tenant_id: str) -> bool:
        return tenant_id in self.tenants


# --- the `fleet` subcommand ---------------------------------------------------


def build_parser() -> argparse.ArgumentParser:
    """The JAX ``fleet`` command's flags."""
    p = argparse.ArgumentParser(
        prog="python -m mpgcn_tpu_torch.cli fleet",
        description="Tenant-registry surgery for the multi-tenant serving "
                    "fleet (service/fleet.py): each tenant gets its own "
                    "service root (promoted/ slot and ledger); `serve "
                    "--fleet` routes requests across them.")
    p.add_argument("action", choices=("add", "remove", "list"))
    p.add_argument("tenant", nargs="?", default=None,
                   help="tenant id (add/remove)")
    p.add_argument("-out", "--output_dir", default="./service",
                   help="fleet root (holds fleet/registry.json and the "
                        "default tenants/<id>/ service roots)")
    p.add_argument("--root", default=None,
                   help="explicit service root for this tenant (default "
                        "<out>/tenants/<id>)")
    p.add_argument("--quota", type=int, default=None,
                   help="per-tenant in-flight quota override (unset = "
                        "the fleet-wide --tenant-quota)")
    p.add_argument("--profile", default=None,
                   help="scenario profile name (scenarios/profiles.py): "
                        "stamps the tenant entry with the scenario "
                        "metadata (name/city/modality/horizon) the fleet "
                        "exports as labels and `stats` reads for the "
                        "federation report")
    p.add_argument("--support-payload", dest="support_payload",
                   choices=("f32", "bf16", "int8"), default=None,
                   help="how this tenant's resident support banks are "
                        "stored (serve --support-payload twin); unset "
                        "inherits the fleet-wide default")
    return p


def main(argv=None) -> int:
    ns = build_parser().parse_args(argv)
    if ns.action == "list":
        reg = TenantRegistry.load(ns.output_dir)
        print(json.dumps({"root": ns.output_dir, "tenants": reg.tenants},
                         indent=1, sort_keys=True))
        return 0
    if not ns.tenant:
        print(f"fleet {ns.action}: tenant id required")
        return 2
    reg = TenantRegistry.load(ns.output_dir)
    if ns.action == "add":
        extra = {}
        if ns.profile:
            # the scenario's metadata rides the entry (numpy-only import)
            from mpgcn_tpu_torch.scenarios.profiles import get_profile

            prof = get_profile(ns.profile)
            extra = {"scenario": prof.name, "city": prof.city,
                     "modality": prof.modality, "horizon": prof.horizon}
        entry = reg.add(ns.tenant, tenant_root=ns.root, quota=ns.quota,
                        support_payload=ns.support_payload, **extra)
        hint = f" --profile {ns.profile}" if ns.profile else ""
        print(f"added tenant {ns.tenant!r} (root {entry['root']}); "
              f"feed it with: python -m mpgcn_tpu_torch.cli daemon "
              f"-spool <spool> -out {entry['root']}{hint}")
    else:
        try:
            reg.remove(ns.tenant)
        except KeyError as e:
            print(str(e))
            return 1
        print(f"removed tenant {ns.tenant!r} (its service root is kept "
              f"on disk)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
