"""Deterministic fault-injection harness (counterpart of
mpgcn_tpu/resilience/faults.py): the same spec grammar, validation and
one-shot hooks, so one spec string means the same plan in either
package. The port wires the serving arms (``flood_qps``,
``poison_reload``, ``slow_request`` / ``slow_secs``,
``poison_requests``: service/serve.py and service/reload.py); the
trainer's, the daemon's, the fleet's and the router's arms parse and
validate here but nothing of the port calls their hooks yet.

Recovery code that is never executed is recovery code that does not work.
This module turns every failure class the runtime claims to survive into a
config/env-driven, deterministic injection, so tier-1 tests and the CI
`chaos` job drive each detection+recovery path end-to-end:

  * NaN inputs at an exact train step  -> in-jit sentinel skip / rollback
  * SIGTERM mid-epoch                  -> preemption checkpoint + resume
  * simulated hang                     -> hang watchdog fires, exit 113
  * checkpoint truncation (torn write) -> corrupt-checkpoint resume fallback
  * data-file IOError (NFS/GCS flake)  -> loader retry-with-backoff

Spec grammar -- comma-separated ``key=value`` pairs, e.g.
``"nan_step=3,sigterm_epoch=2"``:

  nan_step=K       poison the inputs of train step K (1-based, counted
                   across the whole process lifetime) with NaN, so loss AND
                   grads are non-finite at exactly that step
  sigterm_epoch=K  deliver SIGTERM to this process mid-epoch K
  hang_epoch=K     sleep ``hang_secs`` at the start of epoch K (a wedged
                   ICI collective / dead host, as seen from the epoch loop)
  hang_secs=S      hang duration in seconds (default 3600; tests shrink it)
  ckpt_trunc=K     truncate the K-th checkpoint written (torn/partial write)
  io_errors=K      the first K data-file reads raise OSError

Multi-host faults (keyed off the process index; they fire only on
the process whose index equals ``fault_host``, so one shared spec drives
an asymmetric multi-process chaos scenario):

  fault_host=P        which process the multi-host faults target (default 1)
  kill_host_epoch=K   SIGKILL the targeted process at the start of epoch K
                      -- hardware death: no cleanup, no preemption vote,
                      peers discover it via liveness/collective timeout
  straggle_host=K     the targeted process sleeps ``straggle_secs`` at the
                      END of epoch K, after the epoch's device sync and
                      before the vote collective -- host-side lag that is
                      exclusively attributable to this process (drives
                      the straggler detector, NOT a failure)
  straggle_secs=S     straggle duration (default 3.0)
  wedge_collective=K  the targeted process DELAYS its entry to epoch K's
                      vote collective by ``hang_secs`` -- the healthy
                      peers block inside the allreduce for that long, so
                      with hang_secs above their watchdog deadline (the
                      3600 default dwarfs any sane deadline) their
                      collective-entry watchdog fires first (exit 114)

Daemon faults (the continual-learning service loop, service/daemon.py):

  bad_day=K        NaN-poison the K-th day snapshot the daemon ingests
                   (1-based, counted across the daemon's lifetime) AFTER
                   the read, BEFORE validation -- the data-integrity gate
                   must quarantine it, never train on it
  kill_retrain=K   SIGKILL the daemon mid-retrain attempt K: a watcher
                   thread arms when attempt K starts and fires as soon as
                   the retrain's jsonl shows its first completed epoch
                   (genuinely mid-training, deterministically). The
                   attempt counter is PERSISTED daemon state, so the
                   relaunched daemon's next attempt gets a new number and
                   the fault cannot re-fire into a kill loop.
  poison_eval=K    NaN-poison retrain attempt K's candidate checkpoint
                   before the eval gate sees it (the daemon rewrites the
                   params; this plan only votes) -- eval-before-promote
                   must reject it and keep the incumbent

Serving faults (the online serving plane, service/serve.py):

  flood_qps=K      inject a burst of K synthetic requests into the
                   engine as fast as possible right after warmup -- a
                   deterministic overload that must drive the bounded
                   queue into load shedding (typed rejections, never a
                   hang); timing-free, unlike a client-side flood
  poison_reload=K  NaN-poison the K-th hot-reload CANDIDATE's params in
                   memory after the integrity load and before the smoke
                   eval (the on-disk slot stays intact) -- the canary
                   protocol must reject it and keep serving the
                   incumbent, bit-identical
  slow_request=K   the K-th dispatched serving batch sleeps
                   ``slow_secs`` before compute (a stalled device /
                   co-tenant hiccup): queued requests behind it must
                   shed on their deadlines instead of hanging
  slow_secs=S      slow-batch duration (default 0.5; tests shrink it)
  poison_requests=K  adversarial traffic: NaN-poison the
                   inputs of the next K submitted requests (counted
                   from the first submit after the plan arms) -- each
                   must be SHED at the request gate with a typed
                   rejection, and none may reach a compiled batch or,
                   through the traffic-capture loop, a tenant's spool.
                   The submit path does the poisoning (this plan only
                   votes), so the plan stays stdlib-only; anything
                   crafted to pass the request gate is the ingest
                   gate's problem (service/ingest.py classify_day)

Fleet faults (the multi-tenant serving fleet, service/fleet.py; the
tenant-targeted ones key off ``fault_tenant`` -- the INDEX into the
fleet's sorted tenant-id list, reusing the multi-host targeting knob --
so one shared spec names exactly one fault domain and the chaos tests
can pin that the blast radius stays inside it):

  fault_tenant=I           which tenant index the targeted fleet faults
                           hit (default 1, like the multi-host faults);
                           also retargets flood_qps / poison_reload when
                           a fleet engine consumes the plan
  corrupt_tenant_slot=1    truncate the targeted tenant's promoted slot
                           to half its bytes at fleet startup (a torn
                           write that beat the atomic rename) -- that
                           tenant must come up UNAVAILABLE with typed
                           rejections while every other tenant serves
  drop_mesh_peer=K         after the K-th dispatched fleet batch,
                           simulate chip loss: the fleet must degrade
                           one mesh rung (re-shard all tenants, keep
                           serving, zero new traces) under live traffic

Front-tier faults (the replica router, service/router.py; the targeted
ones key off ``fault_replica`` -- the replica INDEX the router launched,
reusing the targeting-knob idiom -- and the ROUTER does the damage, so
the plan stays stdlib-only and the replica child runs a stock serve):

  fault_replica=I       which replica index the targeted front-tier
                        faults hit (default 1)
  kill_replica=K        SIGKILL the targeted replica after the router
                        has proxied K requests -- hardware death under
                        live traffic: in-flight requests to it must
                        fail over to a sibling, its breaker must open,
                        the supervisor loop must restart it warm
  slow_replica=K        stall the K-th request ROUTED TO the targeted
                        replica by ``slow_secs`` in the proxy path (a
                        stalled upstream): the deadline budget must
                        shed or fail over, never hang
  partition_replica=K   from the router's K-th proxied request, the
                        targeted replica is unreachable from the router
                        for ``partition_secs`` (a one-way network
                        partition: the child is healthy, the router
                        cannot see it) -- requests fail over, probes
                        fail, and the replica re-admits itself when the
                        partition heals
  partition_secs=S      partition duration (default 2.0; tests shrink)

Sources: ``cfg.faults`` first, else the ``MPGCN_FAULTS`` environment
variable (the subprocess/CLI hook). An empty spec is an inactive plan whose
hooks are all no-ops, so production runs pay nothing.

Every fault is one-shot and stateful on the plan instance: a rollback that
re-runs epoch K must not re-fire the fault that poisoned it the first time
(the retry would never converge), so hooks mark themselves fired.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import threading
import time

_INT_KEYS = ("nan_step", "sigterm_epoch", "hang_epoch", "ckpt_trunc",
             "io_errors", "fault_host", "kill_host_epoch", "straggle_host",
             "wedge_collective", "bad_day", "kill_retrain", "poison_eval",
             "flood_qps", "poison_reload", "slow_request",
             "poison_requests", "fault_tenant",
             "corrupt_tenant_slot", "drop_mesh_peer", "fault_replica",
             "kill_replica", "slow_replica", "partition_replica")
_FLOAT_KEYS = ("hang_secs", "straggle_secs", "slow_secs",
               "partition_secs")
ENV_VAR = "MPGCN_FAULTS"


@dataclasses.dataclass
class FaultPlan:
    nan_step: int | None = None
    sigterm_epoch: int | None = None
    hang_epoch: int | None = None
    hang_secs: float = 3600.0
    ckpt_trunc: int | None = None
    io_errors: int = 0
    fault_host: int = 1
    kill_host_epoch: int | None = None
    straggle_host: int | None = None
    straggle_secs: float = 3.0
    wedge_collective: int | None = None
    bad_day: int | None = None
    kill_retrain: int | None = None
    poison_eval: int | None = None
    flood_qps: int | None = None
    poison_reload: int | None = None
    slow_request: int | None = None
    poison_requests: int | None = None
    slow_secs: float = 0.5
    fault_tenant: int = 1
    corrupt_tenant_slot: int | None = None
    drop_mesh_peer: int | None = None
    fault_replica: int = 1
    kill_replica: int | None = None
    slow_replica: int | None = None
    partition_replica: int | None = None
    partition_secs: float = 2.0

    def __post_init__(self):
        for key in _INT_KEYS:
            val = getattr(self, key)
            floor = 0 if key in ("io_errors", "fault_host",
                                 "fault_tenant", "fault_replica") else 1
            if val is not None and val < floor:
                raise ValueError(f"fault {key}={val} must be >= {floor}")
        if self.hang_secs <= 0:
            raise ValueError(f"hang_secs={self.hang_secs} must be > 0")
        if self.straggle_secs <= 0:
            raise ValueError(
                f"straggle_secs={self.straggle_secs} must be > 0")
        if self.slow_secs <= 0:
            raise ValueError(f"slow_secs={self.slow_secs} must be > 0")
        if self.partition_secs <= 0:
            raise ValueError(
                f"partition_secs={self.partition_secs} must be > 0")
        self._fired: set[str] = set()
        self._io_left = int(self.io_errors)
        self._saves_seen = 0

    # --- construction -------------------------------------------------------

    @classmethod
    def parse(cls, spec: str | None) -> "FaultPlan":
        """Parse a spec string; '' / None yield an inactive plan."""
        kw: dict = {}
        for item in (spec or "").split(","):
            item = item.strip()
            if not item:
                continue
            key, sep, val = item.partition("=")
            key = key.strip()
            if not sep or key not in _INT_KEYS + _FLOAT_KEYS:
                raise ValueError(
                    f"bad fault spec item {item!r}: expected key=value with "
                    f"key one of {_INT_KEYS + _FLOAT_KEYS}")
            try:
                kw[key] = (float(val) if key in _FLOAT_KEYS
                           else int(val))
            except ValueError as e:
                raise ValueError(
                    f"bad fault spec value in {item!r}: {e}") from None
        return cls(**kw)

    @classmethod
    def from_config(cls, cfg) -> "FaultPlan":
        """Plan from cfg.faults, falling back to $MPGCN_FAULTS (the hook
        subprocess tests and chaos CI use to reach a stock CLI run).

        The env path bypasses MPGCNConfig's parse-time validation, so
        errors name their source here -- and an ACTIVE env-sourced plan
        announces itself loudly: a leaked export from a chaos session must
        never silently poison a real run."""
        spec = getattr(cfg, "faults", "")
        source = "cfg.faults"
        if not spec:
            spec = os.environ.get(ENV_VAR, "")
            source = f"${ENV_VAR}"
        try:
            plan = cls.parse(spec)
        except ValueError as e:
            raise ValueError(f"invalid fault spec in {source}: {e}") \
                from None
        if plan.active and source != "cfg.faults":
            print(f"NOTE: fault injection ACTIVE from {source}: {spec!r} "
                  f"(unset the variable if this is not a chaos run)")
        return plan

    @property
    def active(self) -> bool:
        return (self.nan_step is not None
                or self.sigterm_epoch is not None
                or self.hang_epoch is not None
                or self.ckpt_trunc is not None
                or self.io_errors > 0
                or self.kill_host_epoch is not None
                or self.straggle_host is not None
                or self.wedge_collective is not None
                or self.bad_day is not None
                or self.kill_retrain is not None
                or self.poison_eval is not None
                or self.flood_qps is not None
                or self.poison_reload is not None
                or self.slow_request is not None
                or self.poison_requests is not None
                or self.corrupt_tenant_slot is not None
                or self.drop_mesh_peer is not None
                or self.kill_replica is not None
                or self.slow_replica is not None
                or self.partition_replica is not None)

    # --- injection hooks ----------------------------------------------------

    def take_nan_steps(self, step0: int, n_steps: int) -> tuple[int, ...]:
        """Local indices (0-based within the upcoming window of `n_steps`
        train steps starting at process-global step `step0`) whose inputs
        should be poisoned. One-shot: returned steps are marked fired so a
        rollback replay of the same epoch runs clean."""
        if self.nan_step is None or "nan_step" in self._fired:
            return ()
        local = self.nan_step - 1 - step0
        if 0 <= local < n_steps:
            self._fired.add("nan_step")
            return (local,)
        return ()

    def maybe_sigterm(self, epoch: int) -> bool:
        """Deliver SIGTERM to this process once, mid-epoch `sigterm_epoch`
        (the trainer calls this from inside the epoch, so the preemption
        handler sees a genuinely in-flight epoch)."""
        if self.sigterm_epoch == epoch and "sigterm" not in self._fired:
            self._fired.add("sigterm")
            os.kill(os.getpid(), signal.SIGTERM)
            return True
        return False

    def maybe_hang(self, epoch: int) -> bool:
        """Simulate a wedged host: block the training thread for
        `hang_secs`. The hang watchdog (resilience/watchdog.py) is expected
        to fire first and _exit the process."""
        if self.hang_epoch == epoch and "hang" not in self._fired:
            self._fired.add("hang")
            time.sleep(self.hang_secs)
            return True
        return False

    # --- multi-host faults (keyed off process_index) ------------------------

    def maybe_kill_host(self, epoch: int, process_index: int) -> None:
        """Simulated hardware death: SIGKILL this process at the start of
        epoch `kill_host_epoch` if it is the targeted host. No cleanup
        runs -- exactly what peers of a dead machine observe. (One-shot
        marking is moot -- the process is gone -- but kept so a test seam
        replacing os.kill sees the standard semantics.)"""
        if (self.kill_host_epoch == epoch
                and process_index == self.fault_host
                and "kill_host" not in self._fired):
            self._fired.add("kill_host")
            print(f"FAULT INJECTED: SIGKILL of process {process_index} "
                  f"at epoch {epoch}", flush=True)
            os.kill(os.getpid(), signal.SIGKILL)

    def maybe_straggle(self, epoch: int, process_index: int) -> bool:
        """Chronically slow host: the targeted process sleeps
        `straggle_secs` between epoch `straggle_host`'s device sync and
        its vote collective (host-side lag only this process's epoch
        clock sees -- a sleep before the dispatch would stall the shared
        allreduce and stretch every peer's clock identically). Drives
        the straggler detector; not a failure."""
        if (self.straggle_host == epoch
                and process_index == self.fault_host
                and "straggle" not in self._fired):
            self._fired.add("straggle")
            time.sleep(self.straggle_secs)
            return True
        return False

    def maybe_wedge(self, epoch: int, process_index: int) -> bool:
        """Wedged allreduce: the targeted process delays its entry to
        this epoch's vote collective by `hang_secs`, so every healthy
        peer blocks inside it for that long. Configure hang_secs ABOVE
        the peers' watchdog deadline (the 3600 default dwarfs any sane
        deadline) so their collective-entry watchdog fires first and
        exits 114 -- a shorter sleep degrades the scenario into a
        straggle."""
        if (self.wedge_collective == epoch
                and process_index == self.fault_host
                and "wedge" not in self._fired):
            self._fired.add("wedge")
            time.sleep(self.hang_secs)
            return True
        return False

    def maybe_truncate(self, path: str) -> bool:
        """Tear the K-th checkpoint written: truncate the pickle file (or
        the orbax meta file inside a directory checkpoint) to half its
        bytes, simulating a crash mid-write that beat the atomic rename."""
        if self.ckpt_trunc is None or "ckpt_trunc" in self._fired:
            return False
        self._saves_seen += 1
        if self._saves_seen != self.ckpt_trunc:
            return False
        self._fired.add("ckpt_trunc")
        target = path
        if os.path.isdir(path):
            target = os.path.join(path, "meta.pt")
        if not os.path.exists(target):
            return False
        size = os.path.getsize(target)
        with open(target, "r+b") as f:
            f.truncate(size // 2)
        print(f"FAULT INJECTED: truncated checkpoint {target} "
              f"({size} -> {size // 2} bytes)")
        return True

    def maybe_io_error(self, path: str) -> None:
        """Raise an injected transient OSError for the first `io_errors`
        data-file reads (consumed across all files of one loader)."""
        if self._io_left > 0:
            self._io_left -= 1
            raise OSError(f"injected transient IOError reading {path} "
                          f"({self._io_left} more to come)")

    # --- daemon faults (continual-learning service loop) --------------------

    def take_bad_day(self, seq: int) -> bool:
        """Should the `seq`-th ingested day (1-based, daemon lifetime) be
        poisoned? One-shot; the caller (service/daemon.py ingestion) does
        the actual NaN scatter so this plan stays stdlib-only."""
        if self.bad_day == seq and "bad_day" not in self._fired:
            self._fired.add("bad_day")
            print(f"FAULT INJECTED: poisoning ingested day #{seq}",
                  flush=True)
            return True
        return False

    def take_poison_eval(self, attempt: int) -> bool:
        """Should retrain attempt `attempt`'s candidate checkpoint be
        NaN-poisoned before the eval gate? One-shot vote; the daemon
        rewrites the checkpoint (service/promote.py owns the numpy/
        integrity-refresh mechanics)."""
        if self.poison_eval == attempt and "poison_eval" not in self._fired:
            self._fired.add("poison_eval")
            print(f"FAULT INJECTED: NaN-poisoning retrain attempt "
                  f"{attempt}'s candidate before the eval gate",
                  flush=True)
            return True
        return False

    # --- serving faults (online serving plane, service/serve.py) -----------

    def take_flood(self) -> int:
        """Synthetic-request burst size to inject right after serve
        warmup (0 = no flood). One-shot: a drain/relaunch must not
        re-flood."""
        if self.flood_qps is None or "flood_qps" in self._fired:
            return 0
        self._fired.add("flood_qps")
        print(f"FAULT INJECTED: flooding the serve queue with "
              f"{self.flood_qps} synthetic requests", flush=True)
        return self.flood_qps

    def take_poison_reload(self, seq: int) -> bool:
        """Should the `seq`-th hot-reload candidate (1-based, server
        lifetime) be NaN-poisoned in memory before the smoke eval? The
        reload path does the poisoning (this plan stays stdlib-only);
        the on-disk promoted slot is never touched."""
        if self.poison_reload == seq and "poison_reload" not in self._fired:
            self._fired.add("poison_reload")
            print(f"FAULT INJECTED: NaN-poisoning reload candidate #{seq} "
                  f"before the smoke eval", flush=True)
            return True
        return False

    def maybe_slow_request(self, batch_seq: int) -> bool:
        """Stall the `batch_seq`-th dispatched serving batch (1-based) by
        `slow_secs` before its compute -- queued requests behind it must
        shed on their deadlines, not hang."""
        if (self.slow_request == batch_seq
                and "slow_request" not in self._fired):
            self._fired.add("slow_request")
            print(f"FAULT INJECTED: slowing serving batch #{batch_seq} by "
                  f"{self.slow_secs}s", flush=True)
            time.sleep(self.slow_secs)
            return True
        return False

    def take_poison_request(self, seq: int) -> bool:
        """Should the `seq`-th submitted serving request (1-based,
        engine lifetime) be NaN-poisoned before the request gate? Fires
        for the first `poison_requests` submissions -- a poisoned
        STREAM, not one bad row -- and the caller (serve/fleet submit)
        does the poisoning so this plan stays stdlib-only. Stateful:
        the budget is consumed per request, so a drain/relaunch cannot
        re-poison an already-judged stream."""
        if self.poison_requests is None:
            return False
        if seq <= self.poison_requests:
            if "poison_requests" not in self._fired:
                self._fired.add("poison_requests")
                print(f"FAULT INJECTED: NaN-poisoning the first "
                      f"{self.poison_requests} submitted request(s)",
                      flush=True)
            return True
        return False

    def take_corrupt_tenant_slot(self, tenant_index: int) -> bool:
        """Should the `tenant_index`-th tenant's (sorted-id order)
        promoted slot be torn at fleet startup? One-shot vote keyed off
        ``fault_tenant``; the fleet does the truncation so this plan
        stays stdlib-only."""
        if (self.corrupt_tenant_slot is not None
                and tenant_index == self.fault_tenant
                and "corrupt_tenant_slot" not in self._fired):
            self._fired.add("corrupt_tenant_slot")
            print(f"FAULT INJECTED: tearing tenant #{tenant_index}'s "
                  f"promoted slot at fleet startup", flush=True)
            return True
        return False

    def take_drop_mesh_peer(self, batch_seq: int) -> bool:
        """Simulated chip loss under live traffic: after the
        `drop_mesh_peer`-th dispatched fleet batch, the fleet must
        degrade one mesh rung and keep serving. One-shot."""
        if (self.drop_mesh_peer == batch_seq
                and "drop_mesh_peer" not in self._fired):
            self._fired.add("drop_mesh_peer")
            print(f"FAULT INJECTED: dropping a mesh peer after fleet "
                  f"batch #{batch_seq}", flush=True)
            return True
        return False

    def take_kill_replica(self, n_routed: int) -> bool:
        """Should the router SIGKILL the targeted replica now? Fires
        once, after the router has proxied `n_routed` == `kill_replica`
        requests -- mid-stream by construction, so live traffic is in
        flight when the process dies. The router does the killing (it
        owns the child handle); this plan only votes."""
        if (self.kill_replica == n_routed
                and "kill_replica" not in self._fired):
            self._fired.add("kill_replica")
            print(f"FAULT INJECTED: SIGKILL replica "
                  f"r{self.fault_replica} after request #{n_routed}",
                  flush=True)
            return True
        return False

    def maybe_slow_replica(self, replica_idx: int,
                           n_to_replica: int) -> bool:
        """Stall the `slow_replica`-th request routed TO the targeted
        replica (1-based, per-replica count) by `slow_secs` in the
        router's proxy path -- a stalled upstream as seen from the front
        tier. The deadline budget must shed or fail over, never hang."""
        if (self.slow_replica == n_to_replica
                and replica_idx == self.fault_replica
                and "slow_replica" not in self._fired):
            self._fired.add("slow_replica")
            print(f"FAULT INJECTED: slowing request #{n_to_replica} to "
                  f"replica r{replica_idx} by {self.slow_secs}s",
                  flush=True)
            time.sleep(self.slow_secs)
            return True
        return False

    def take_partition_replica(self, n_routed: int) -> bool:
        """Should the router partition itself from the targeted replica
        now (for `partition_secs`)? Fires once at proxied request
        `partition_replica`; the router marks the replica unreachable
        and refuses to open connections to it until the partition heals
        -- the child itself stays healthy throughout."""
        if (self.partition_replica == n_routed
                and "partition_replica" not in self._fired):
            self._fired.add("partition_replica")
            print(f"FAULT INJECTED: partitioning replica "
                  f"r{self.fault_replica} from the router for "
                  f"{self.partition_secs}s", flush=True)
            return True
        return False

    def maybe_kill_retrain(self, attempt: int, log_path: str,
                           poll_s: float = 0.05) -> bool:
        """SIGKILL this process mid-retrain attempt `attempt`: arm a
        watcher thread that polls the retrain run's jsonl for its first
        completed-`epoch` event and then kills -- deterministically
        "after training made real progress, before it finished" (the
        retrain must run >= 2 epochs for the kill to land mid-run).
        One-shot on ARMING; the daemon persists its attempt counter, so
        the relaunched process's next attempt has a different number and
        can never re-arm this fault."""
        if self.kill_retrain != attempt or "kill_retrain" in self._fired:
            return False
        self._fired.add("kill_retrain")
        print(f"FAULT ARMED: SIGKILL once retrain attempt {attempt} "
              f"logs its first epoch ({log_path})", flush=True)

        def _watch():
            while True:
                try:
                    with open(log_path) as f:
                        if any('"event": "epoch"' in line for line in f):
                            break
                except OSError:
                    pass
                time.sleep(poll_s)
            print(f"FAULT INJECTED: SIGKILL mid-retrain attempt {attempt}",
                  flush=True)
            os.kill(os.getpid(), signal.SIGKILL)

        t = threading.Thread(target=_watch, daemon=True,
                             name="mpgcn-kill-retrain-fault")
        t.start()
        return True
