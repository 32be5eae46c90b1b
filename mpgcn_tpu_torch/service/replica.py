"""Fleet replica lifecycle (counterpart of mpgcn_tpu/service/replica.py):
N ``python -m mpgcn_tpu_torch.cli serve --fleet`` processes under one
front tier (service/router.py).

Each replica is a full single-process serving fleet (FleetEngine over
the same tenant set) launched as a child process with its OWN service
root under ``<root>/router/replicas/r<k>/`` -- its ledgers, http.json
and metrics never collide with a sibling's -- while the tenant roots
(promoted slots + promotion ledgers) are SHARED read-only: every
replica serves the same incumbents, which is what makes request-level
failover answer-preserving (predictions are pure functions of the
promoted params, and the kernels sum in a fixed order, so two replicas
give the same bits).

A restart builds no kernel: the libraries under ``native/_build/`` are
named by a hash of their source and reused by every process. Each
incarnation does capture its rollout graphs again (its own CUDA
context), so a restart costs a process start, a CUDA context and the
captures.

Port discovery rides serve's own ``--port 0`` + http.json contract
instead of a racy free-port pick. Device-free: the front tier imports no
torch (tests pin the import); only the children do.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request
from typing import Optional

from mpgcn_tpu_torch.service.registry import TenantRegistry

__all__ = [
    "ReplicaProcess", "prepare_replica_root", "replica_root",
    "replicas_dir",
]


def replicas_dir(root: str) -> str:
    return os.path.join(root, "router", "replicas")


def replica_root(root: str, idx: int) -> str:
    return os.path.join(replicas_dir(root), f"r{idx}")


def prepare_replica_root(source_root: str, rroot: str) -> TenantRegistry:
    """Materialize a replica's service root: its own fleet registry (the
    JAX file format) whose tenant entries point at the SHARED tenant
    roots of `source_root`, made absolute.

    The replica reads tenant slots/ledgers from the shared roots (the
    rolling-deploy contract: a restarted replica picks up whatever has
    been promoted since) and writes its own serve ledgers under `rroot`
    -- no cross-replica file contention.
    """
    src = TenantRegistry.load(source_root, missing_ok=False)
    if not src.ids():
        raise ValueError(
            f"fleet registry under {source_root} has no tenants; "
            f"register tenants before launching replicas")
    tenants = {}
    for tid, entry in src.tenants.items():
        e = dict(entry)
        e["root"] = os.path.abspath(entry["root"])
        tenants[tid] = e
    reg = TenantRegistry(rroot, tenants)
    reg.save()
    return reg


def _http_info(rroot: str) -> Optional[dict]:
    """The replica's serve/http.json ({host, port, pid}), or None until
    the child has bound its ephemeral port and written it."""
    path = os.path.join(rroot, "serve", "http.json")
    try:
        with open(path) as f:
            return json.load(f)
    except (FileNotFoundError, json.JSONDecodeError, OSError):
        return None          # mid-write/absent: poll again


class ReplicaProcess:
    """One fleet replica child process and its address.

    The lifecycle verbs are mechanical (start / terminate / kill /
    restart); admission policy -- when a replica may receive traffic --
    lives in the router's handle, gated on health + smoke probes.
    """

    def __init__(self, idx: int, router_root: str, serve_args: list,
                 env: Optional[dict] = None):
        self.idx = idx
        self.root = replica_root(router_root, idx)
        self._router_root = router_root
        self._serve_args = list(serve_args)
        self._env = dict(env) if env is not None else None
        self.proc: Optional[subprocess.Popen] = None
        self._log_handle = None
        self.generation = 0          #: launches since construction
        self.host: Optional[str] = None
        self.port: Optional[int] = None

    # --- launch / discovery ---

    def start(self) -> None:
        """Launch the serve child. Idempotence guard: refuses while a
        previous incarnation is still running."""
        if self.alive:
            raise RuntimeError(f"replica r{self.idx} is already running "
                               f"(pid {self.proc.pid})")
        prepare_replica_root(self._router_root, self.root)
        # a stale http.json from the previous incarnation would hand out
        # a dead port as "ready" -- remove before the child can rebind
        info_path = os.path.join(self.root, "serve", "http.json")
        if os.path.exists(info_path):
            os.remove(info_path)
        self.host = self.port = None
        log_path = os.path.join(self.root,
                                f"replica_gen{self.generation}.log")
        os.makedirs(self.root, exist_ok=True)
        self._close_log()
        self._log_handle = open(log_path, "w")
        argv = ([sys.executable, "-m", "mpgcn_tpu_torch.cli", "serve",
                 "--fleet", "-out", self.root, "--port", "0"]
                + self._serve_args)
        self.proc = subprocess.Popen(
            argv, stdout=self._log_handle, stderr=subprocess.STDOUT,
            env=self._env)
        self.generation += 1

    def discover(self, timeout_s: float = 600.0,
                 poll_s: float = 0.2) -> tuple:
        """Block until the child writes http.json (its bound ephemeral
        port); raises if the child dies or the budget runs out. This is
        address discovery only -- the router still health-probes before
        admitting."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if self.proc is not None and self.proc.poll() is not None:
                raise RuntimeError(
                    f"replica r{self.idx} exited rc={self.proc.returncode}"
                    f" before binding its port (log: {self.root})")
            info = _http_info(self.root)
            if info and "port" in info:
                self.host = info.get("host", "127.0.0.1")
                self.port = int(info["port"])
                return self.host, self.port
            time.sleep(poll_s)
        raise TimeoutError(
            f"replica r{self.idx} did not write http.json within "
            f"{timeout_s:.0f}s (log: {self.root})")

    @property
    def base_url(self) -> Optional[str]:
        if self.port is None:
            return None
        return f"http://{self.host}:{self.port}"

    # --- liveness / teardown ---

    @property
    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None

    @property
    def pid(self) -> Optional[int]:
        return self.proc.pid if self.proc is not None else None

    def healthz(self, timeout_s: float = 2.0) -> Optional[dict]:
        """GET /healthz; None on any transport failure (the caller's
        breaker interprets it)."""
        if self.base_url is None:
            return None
        try:
            with urllib.request.urlopen(self.base_url + "/healthz",
                                        timeout=timeout_s) as resp:
                return json.loads(resp.read())
        except (urllib.error.URLError, OSError, ValueError):
            return None

    def terminate(self, timeout_s: float = 30.0) -> int:
        """SIGTERM (serve drains in-flight work and exits 0), escalate
        to SIGKILL past the budget. Returns the exit code."""
        if self.proc is None:
            return 0
        if self.proc.poll() is None:
            try:
                self.proc.send_signal(signal.SIGTERM)
            except ProcessLookupError:
                pass
            try:
                self.proc.wait(timeout=timeout_s)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
        self._close_log()
        return self.proc.returncode

    def kill(self) -> None:
        """SIGKILL, no drain -- the chaos verb (kill_replica fault)."""
        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self._close_log()

    def _close_log(self) -> None:
        if self._log_handle is not None:
            self._log_handle.close()
            self._log_handle = None
