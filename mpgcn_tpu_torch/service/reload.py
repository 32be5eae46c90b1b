"""Canaried hot reload (counterpart of mpgcn_tpu/service/reload.py): the
serving half of the promotion handshake.

A daemon installs gated candidates into ``promoted/<model>_od.pkl``
atomically and appends every verdict to ``promoted/promotions.jsonl``.
``CanaryReloader`` is the consumer: a poll loop that notices a new slot
and walks it through a refuse-by-default pipeline before it serves full
traffic:

  1. sequence check: the slot's hash must appear in the promotions
     ledger at a row newer than the served one. A reload never moves
     backwards, and a slot whose hash has no ledger row yet is deferred
     (the daemon writes the slot before its row);
  2. integrity load: the manifest and per-leaf blake2b checks and the
     branch-spec guard (train/checkpoint.py ``load_serving_params``): torn
     bytes or a checkpoint of another architecture are rejected without
     touching the served weights;
  3. smoke eval: the candidate's weights, copied into the engine's idle
     parameter slot, run the pinned probe batch through that slot's
     rollout prepared at startup (on the card its captured graph): a
     non-finite probe output, or a probe-loss regression past
     ``reload_tolerance`` against the incumbent, rejects it;
  4. canary: the survivor serves ``canary_fraction`` of the batches until
     ``canary_requests`` requests came back finite, then becomes the
     incumbent; a non-finite canary output rolls it back mid-flight and
     the engine serves that batch again on the incumbent.

Every decision is a row of the reload ledger (``serve/reloads.jsonl``),
and ``poll`` returns the JAX package's action strings letter for letter.
A hash rejected on its content (integrity, smoke, rollback) is
blacklisted so a bad slot cannot grind the poll loop; a stale refusal is
parked only until the promotions ledger grows. Idle polls cost two
stats.
"""

from __future__ import annotations

import math
import os
import threading
from typing import Optional

from mpgcn_tpu_torch.service.promote import _nan_tree, candidate_hash
from mpgcn_tpu_torch.train.checkpoint import (
    CheckpointCorruptError,
    load_serving_params,
)
from mpgcn_tpu_torch.utils.logging import read_events


def validate_candidate(path: str, num_branches=None,
                       branch_sources=None) -> dict:
    """The pre-placement gate every reload candidate must clear: the
    manifest and per-leaf checksum verification (CheckpointCorruptError
    on damage) and the branch-spec guard, all on host numpy arrays. A
    truncated, bit-rotted or wrong-architecture candidate is rejected
    here, before quantization and before a byte reaches the device.

    Returns the host checkpoint dict; raises CheckpointCorruptError /
    ValueError exactly like load_serving_params (it IS that load, named
    for the ordering contract it anchors)."""
    return load_serving_params(path, num_branches=num_branches,
                               branch_sources=branch_sources)


def promoted_gate_row(ledger_path: str,
                      slot_hash: str) -> tuple[Optional[int],
                                               Optional[dict]]:
    """(row index, row) of the NEWEST promoted gate verdict whose
    candidate hash matches the slot, or (None, None) when the ledger has
    no such row. The row index is the sequence the never-move-backwards
    check orders reloads by; the row itself carries the day chain's
    trace/span ids (daemon's _gate), which the reload span re-joins so
    obs/trace.py ``stitch`` can join ingest -> retrain -> promote ->
    reload across the process boundary."""
    rows = read_events(ledger_path, "gate")
    out: tuple[Optional[int], Optional[dict]] = (None, None)
    for i, row in enumerate(rows):
        if row.get("promoted") and row.get("candidate_hash") == slot_hash:
            out = (i, row)
    return out


def promoted_seq(ledger_path: str, slot_hash: str) -> Optional[int]:
    """Ledger row index of the PROMOTED gate verdict whose candidate
    hash matches the slot (see promoted_gate_row)."""
    return promoted_gate_row(ledger_path, slot_hash)[0]


class CanaryReloader:
    """Poll `slot_path` and walk new candidates through the
    sequence/integrity/smoke/canary pipeline against `engine`
    (service/serve.py ``ServeEngine``). Torch-free except through
    engine methods; tests drive `poll()` directly and assert on its returned
    action string."""

    def __init__(self, engine, scfg, faults=None):
        self.engine = engine
        self.scfg = scfg
        self.slot_path = engine.slot_path
        self.ledger_path = engine.promotions_ledger_path
        self._faults = faults
        self._log = engine.reload_log
        self._candidates_seen = 0  # poison_reload fault counter
        # change detection: (slot mtime_ns, slot size) + ledger size at
        # the last completed poll -- idle polls short-circuit on these
        self._slot_sig: Optional[tuple] = None
        self._ledger_size = -1
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # --- one poll step ------------------------------------------------------

    def _reload_span(self, gate_row: Optional[dict], action: str,
                     **attrs) -> None:
        """Emit the serve.reload span joined to the day chain's trace
        (carried by the daemon's gate ledger row, parented under its
        promote span); a ledgerless reload (hand-placed checkpoint) has
        no trace to join and emits nothing."""
        if not gate_row or not gate_row.get("trace"):
            return
        try:
            self.engine.span_log.emit(
                "serve.reload", gate_row["trace"],
                parent=gate_row.get("span"), action=action, **attrs)
        except Exception:
            pass  # telemetry must never break the reload protocol

    def poll(self) -> str:
        """One reload-protocol step; returns the action taken (a stable
        string the tests and the reload ledger share)."""
        eng = self.engine
        if eng.canary_hash is not None:
            return "canary-in-flight"
        # cheap change detection: a long-lived server polls every few
        # seconds for its whole lifetime; re-hashing the (possibly
        # multi-hundred-MB) slot and re-reading the whole promotions
        # ledger on every idle tick is pure waste. The ledger size
        # participates because a deferred (unledgered) or refused
        # (stale) slot must be re-evaluated when its ledger row lands
        # or a newer re-promotion row appends.
        try:
            st = os.stat(self.slot_path)
        except OSError:
            self._slot_sig = None
            return "no-slot"
        sig = (st.st_mtime_ns, st.st_size)
        try:
            lsize = os.path.getsize(self.ledger_path)
        except OSError:
            lsize = -1
        if sig == self._slot_sig and lsize == self._ledger_size:
            return "unchanged"
        self._slot_sig, self._ledger_size = sig, lsize
        try:
            h = candidate_hash(self.slot_path)
        except OSError:
            self._slot_sig = None
            return "no-slot"  # racing a replace; next poll sees it
        if h == eng.incumbent_hash or h in eng.bad_hashes:
            return "unchanged"
        # 1. promotions-ledger sequence check: never move backwards
        gate_row = None
        if os.path.exists(self.ledger_path):
            seq, gate_row = promoted_gate_row(self.ledger_path, h)
            if seq is None:
                # slot bytes land strictly before their ledger row
                # (daemon's _gate): this is the mid-promote window, or a
                # hand-tampered slot -- either way, wait, don't serve it
                self._log.log("reload_deferred", hash=h,
                              reason="slot hash has no promoted ledger "
                                     "row yet")
                return "deferred-unledgered"
            if seq <= eng.incumbent_seq:
                # NOT a permanent blacklist: staleness is a property of
                # the ledger's current tail, not of the bytes -- when a
                # newer row re-promotes this candidate, the ledger-size
                # gate above re-runs this check and it passes
                self._log.log("reload_refused", hash=h, seq=seq,
                              incumbent_seq=eng.incumbent_seq,
                              reason="stale candidate: ledger row is not "
                                     "newer than the served incumbent")
                return "refused-stale"
        else:
            # no ledger (hand-placed checkpoint, tests): synthesize the
            # next sequence so repeated reloads stay monotone
            seq = eng.incumbent_seq + 1
        # 2. integrity + branch-spec load (shared with the trainer) --
        #    the pre-placement gate: validation MUST complete on host
        #    bytes before eng._place quantizes/uploads anything
        try:
            ckpt = validate_candidate(
                self.slot_path, num_branches=eng.cfg.num_branches,
                branch_sources=eng.cfg.resolved_branch_sources)
        except (CheckpointCorruptError, ValueError) as e:
            eng.bad_hashes.add(h)
            self._log.log("reload_rejected", hash=h,
                          reason=f"{type(e).__name__}: {e}"[:300])
            print(f"[serve] reload REJECTED (integrity/spec): {e}",
                  flush=True)
            return "rejected-integrity"
        # the daemon's os.replace can land between the hash above and
        # the load: the loaded params would then belong to a DIFFERENT
        # hash, and blacklisting/canarying them under `h` would mislabel
        # both. Re-hash; on any mismatch wait for the next poll, which
        # sees the settled slot.
        try:
            if candidate_hash(self.slot_path) != h:
                self._slot_sig = None  # mid-replace; redo next poll
                return "slot-changed"
        except OSError:
            self._slot_sig = None
            return "no-slot"
        params = ckpt["params"]
        self._candidates_seen += 1
        if self._faults is not None and self._faults.take_poison_reload(
                self._candidates_seen):
            params = _nan_tree(params)
        # 3. smoke eval on the pinned probe batch (the idle slot's
        #    rollout prepared at startup, nothing new captured);
        #    non-finite or regressed -> reject, incumbent untouched
        try:
            # place ONCE: _place copies (int8: quantizes) the candidate
            # into the idle slot in place and returns the slot, which
            # install_canary then takes as it is; a placement failure
            # routes to the same rejection a failing probe does
            params_dev = eng._place(params)
            loss = eng.probe_loss(params_dev)
        except Exception as e:
            # a structurally incompatible tree (branch spec matches but
            # e.g. hidden_dim differs) raises inside the placement copy;
            # blacklist so the slot cannot grind the poll loop
            eng.bad_hashes.add(h)
            self._log.log("reload_rejected", hash=h,
                          reason=f"smoke eval raised "
                                 f"{type(e).__name__}: {e}"[:300])
            print(f"[serve] reload REJECTED (smoke eval raised): {e}",
                  flush=True)
            return "rejected-smoke-error"
        inc_loss = eng.incumbent_probe_loss
        if not math.isfinite(loss):
            eng.bad_hashes.add(h)
            eng.note_reload_rollback()
            self._reload_span(gate_row, "rejected-smoke", hash=h)
            self._log.log("reload_rollback", hash=h, probe_loss=None,
                          reason="non-finite smoke-eval output")
            print("[serve] reload ROLLED BACK: candidate produced "
                  "non-finite probe output; incumbent keeps serving.",
                  flush=True)
            return "rejected-smoke"
        if (inc_loss is not None and math.isfinite(inc_loss)
                and loss > inc_loss * (1.0 + self.scfg.reload_tolerance)):
            eng.bad_hashes.add(h)
            eng.note_reload_rollback()
            self._reload_span(gate_row, "rejected-regression", hash=h,
                              probe_loss=round(loss, 6))
            self._log.log("reload_rollback", hash=h,
                          probe_loss=round(loss, 6),
                          incumbent_probe_loss=round(inc_loss, 6),
                          tolerance=self.scfg.reload_tolerance,
                          reason="probe-loss regression vs incumbent")
            print(f"[serve] reload ROLLED BACK: candidate probe loss "
                  f"{loss:.6g} > incumbent {inc_loss:.6g} x "
                  f"(1 + {self.scfg.reload_tolerance}); incumbent keeps "
                  f"serving.", flush=True)
            return "rejected-regression"
        # 4. canary: serve a traffic fraction until enough finite
        #    responses, then promote (engine owns the counting). Ledger
        #    row FIRST: canary_requests=0 promotes inside install_canary
        #    and the ledger must read chronologically
        self._reload_span(gate_row, "canary-started", hash=h, seq=seq,
                          probe_loss=round(loss, 6))
        self._log.log("reload_canary", hash=h, seq=seq,
                      probe_loss=round(loss, 6),
                      canary_requests=self.scfg.canary_requests,
                      canary_fraction=self.scfg.canary_fraction,
                      **({"trace": gate_row["trace"]}
                         if gate_row and gate_row.get("trace") else {}))
        eng.install_canary(params_dev, h, seq, probe_loss=loss)
        print(f"[serve] reload CANARY started: {h[:12]} seq {seq} "
              f"(probe loss {loss:.6g})", flush=True)
        return "canary-started"

    # --- poll loop ----------------------------------------------------------

    def start(self) -> None:
        if self.scfg.reload_poll_secs <= 0 or self._thread is not None:
            return
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="mpgcn-serve-reloader")
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.poll()
            except Exception as e:  # the poll loop must outlive surprises
                self._log.log("reload_error",
                              error=f"{type(e).__name__}: {e}"[:300])
            self._stop.wait(self.scfg.reload_poll_secs)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
