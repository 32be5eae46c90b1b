"""Traffic capture: the serving plane's request ledger back into the
daemon's spool (counterpart of mpgcn_tpu/service/capture.py).

This closes the serve -> train -> promote -> serve loop. The serving
plane's request ledger (service/serve.py, fleet.py, written through the
size-capped ``utils/logging.JsonlLogger``) records every accepted
request; with flow capture on, an accepted row also carries the
request's declared ``day_slot`` and the (N, N) flows of its newest
observation slot (``capture_row_fields``). ``TrafficCapture`` stitches
those rows, across the logger's rotated generation and past torn tails,
into ``day_<idx>.npy`` files dropped atomically into a daemon's spool,
where the ingest gate (service/ingest.py) judges them like any day.

The watermark (generation signature, byte offset) rides the daemon's
atomic state file (``daemon_state.json``, key "capture"), so a
relaunched daemon neither re-ingests nor skips rows:

  * the signature names a ledger generation by the sha1 of its first
    complete line (generations are append-only; rotation by
    ``os.replace`` freezes the old one at ``<path>.1``);
  * the offset is the byte after the last complete line consumed in that
    generation: a torn tail is left for the next poll;
  * ``done_sig`` remembers the newest fully consumed older generation,
    so an empty new generation cannot make the reader consume the
    rotated file again.

A day's file is the last row of that day (every accepted request of a
day observes the same snapshot), and a day is emitted only once a later
day shows up in the stream, or on ``flush()``. Publication is a staging
write plus ``os.replace`` into the spool: the ingest gate never sees a
torn day file.

Needs no torch: capture runs in the daemon loop before any device work.
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np

from mpgcn_tpu_torch.service.ingest import day_filename, parse_day_index
from mpgcn_tpu_torch.utils.logging import rotated_path


def default_capture_state() -> dict:
    """Fresh watermark + counters (the daemon persists this dict)."""
    return {"sig": "", "offset": 0, "done_sig": "", "last_emitted": -1,
            "max_day": -1, "rows": 0, "malformed": 0, "late": 0,
            "gaps": 0, "days_emitted": 0}


def _first_line_sig(data: bytes) -> str:
    """Generation signature: sha1 of the first COMPLETE line. A file
    whose first line is still being appended has no signature yet --
    the caller skips it this poll and re-reads next time."""
    nl = data.find(b"\n")
    if nl < 0:
        return ""
    return hashlib.sha1(data[:nl]).hexdigest()[:16]


def _complete_lines(data: bytes, start: int) -> tuple[list[bytes], int]:
    """Newline-terminated lines from `start`, plus the offset AFTER the
    last complete one (a torn tail stays unconsumed)."""
    end = data.rfind(b"\n")
    if end < start:
        return [], start
    return data[start:end].split(b"\n"), end + 1


class TrafficCapture:
    """Stitch one request ledger's accepted rows into spool day files.

    `ledger_path` is the serving plane's ``requests.jsonl``; rotation
    (``<path>.1``) is handled via the watermark protocol above.
    `tenant` filters a multi-tenant fleet ledger down to one tenant's
    stream ("" accepts rows with any -- or no -- tenant field).
    `staging_dir` holds the open (not yet closed) day accumulators as
    ``pending_day_<idx>.npy``, written atomically so a kill mid-poll
    can only lose the poll, never corrupt a day.
    """

    def __init__(self, ledger_path: str, spool_dir: str, staging_dir: str,
                 tenant: str = "", num_nodes: int = 0):
        self.ledger_path = ledger_path
        self.spool_dir = spool_dir
        self.staging_dir = staging_dir
        self.tenant = tenant
        self.num_nodes = int(num_nodes)
        os.makedirs(spool_dir, exist_ok=True)
        os.makedirs(staging_dir, exist_ok=True)

    # --- generation-aware ledger reading ------------------------------------

    def _read_new_rows(self, state: dict) -> list[dict]:
        """All complete rows past the watermark, oldest first, advancing
        the watermark in `state`. Tolerant of: missing files, torn
        tails, a rotation between polls, and (counted, not fatal) a
        LOST generation when two rotations beat one poll."""
        try:
            with open(self.ledger_path, "rb") as f:
                cur = f.read()
        except OSError:
            cur = b""
        try:
            with open(rotated_path(self.ledger_path), "rb") as f:
                rot = f.read()
        except OSError:
            rot = b""
        c_sig, r_sig = _first_line_sig(cur), _first_line_sig(rot)
        raw: list[bytes] = []
        tracked = state["sig"]
        # 1) the rotated (frozen) generation, unless already drained
        if r_sig and r_sig != state["done_sig"] and r_sig != c_sig:
            start = state["offset"] if r_sig == tracked else 0
            if start > len(rot):
                start = 0  # signature collision across generations
            lines, _ = _complete_lines(rot, start)
            raw.extend(lines)
            state["done_sig"] = r_sig
        # 2) the live generation
        if c_sig:
            start = state["offset"] if c_sig == tracked else 0
            if start > len(cur):
                start = 0
            if c_sig == state["done_sig"]:
                start = len(cur)  # defensively never re-read a drained gen
            lines, end = _complete_lines(cur, start)
            raw.extend(lines)
            state["sig"], state["offset"] = c_sig, end
        # generation loss: the one we were mid-way through vanished
        # without becoming the rotated file -- >= 2 rotations since the
        # last poll. Rows are gone; say so instead of silently skipping.
        if tracked and tracked not in (c_sig, r_sig, state["done_sig"]):
            state["gaps"] += 1
        rows = []
        for line in raw:
            if not line.strip():
                continue
            try:
                rows.append(json.loads(line))
            except (json.JSONDecodeError, UnicodeDecodeError):
                state["malformed"] += 1
        return rows

    # --- day aggregation ----------------------------------------------------

    def _pending_path(self, idx: int) -> str:
        return os.path.join(self.staging_dir, f"pending_{day_filename(idx)}")

    def _pending_days(self) -> list[int]:
        out = []
        for name in os.listdir(self.staging_dir):
            if name.startswith("pending_"):
                idx = parse_day_index(name[len("pending_"):])
                if idx is not None:
                    out.append(idx)
        return sorted(out)

    def _write_atomic(self, arr: np.ndarray, dst: str) -> None:
        tmp = os.path.join(self.staging_dir,
                           f".tmp_{os.path.basename(dst)}")
        with open(tmp, "wb") as f:
            np.save(f, arr)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, dst)

    def _accept_row(self, rec: dict, state: dict) -> None:
        if rec.get("event") != "request" or rec.get("outcome") != "ok":
            return
        if self.tenant and rec.get("tenant") != self.tenant:
            return
        day, flows = rec.get("day_slot"), rec.get("flows")
        if day is None or flows is None:
            return
        try:
            idx = int(day)
            arr = np.asarray(flows, dtype=np.float32)
        except (TypeError, ValueError):
            state["malformed"] += 1
            return
        if (idx < 0 or arr.ndim != 2 or arr.shape[0] != arr.shape[1]
                or (self.num_nodes and arr.shape[0] != self.num_nodes)):
            state["malformed"] += 1
            return
        if idx <= state["last_emitted"]:
            # the day already shipped to the spool: never double-emit
            # (and never tear an already-judged day out from under the
            # ingest gate) -- count the straggler instead
            state["late"] += 1
            return
        state["rows"] += 1
        state["max_day"] = max(state["max_day"], idx)
        # last-write-wins within a day: every accepted request of day k
        # observes the same snapshot, so the newest row is the day
        self._write_atomic(arr, self._pending_path(idx))

    def _emit(self, idx: int, state: dict) -> str:
        src = self._pending_path(idx)
        dst = os.path.join(self.spool_dir, day_filename(idx))
        # publish atomically INTO the spool: os.replace of the staged
        # bytes -- the ingest gate can only ever see a complete file
        os.replace(src, dst)
        state["last_emitted"] = max(state["last_emitted"], idx)
        state["days_emitted"] += 1
        return dst

    # --- public API ---------------------------------------------------------

    def poll(self, state: dict) -> list[int]:
        """One capture pass: consume new ledger rows past the watermark,
        update the open-day accumulators, and emit every CLOSED day
        (strictly older than the newest day seen) into the spool in
        temporal order. Mutates `state` (the caller persists it
        atomically -- the daemon folds it into daemon_state.json) and
        returns the emitted day indices."""
        for rec in self._read_new_rows(state):
            self._accept_row(rec, state)
        emitted = []
        for idx in self._pending_days():
            if idx < state["max_day"]:
                self._emit(idx, state)
                emitted.append(idx)
        return emitted

    def flush(self, state: dict) -> list[int]:
        """Emit every open day regardless of closure -- end-of-stream
        drain (tests, batch replays, daemon shutdown hooks). The final
        day of a stream never sees a successor, so without a flush it
        would wait forever."""
        emitted = []
        for idx in self._pending_days():
            self._emit(idx, state)
            emitted.append(idx)
        return emitted

    def lag_days(self, state: dict) -> int:
        """Open (seen but not yet spooled) day count -- the capture lag
        gauge: 0 when every seen day has shipped."""
        if state["max_day"] < 0:
            return 0
        return max(0, state["max_day"] - state["last_emitted"])


def capture_row_fields(x, day_slot) -> dict:
    """Ledger-row extras for one accepted request when flow capture is
    on: the declared day index and the newest observation slot of the
    window as a nested float32 list (JSON round-trips float32 exactly,
    so a captured day parses back bit-identical)."""
    if day_slot is None:
        return {}
    a = np.asarray(x)
    if a.ndim == 4:  # (obs_len, N, N, 1), the engine's layout
        a = a[..., 0]
    return {"day_slot": int(day_slot),
            "flows": np.asarray(a[-1], dtype=np.float32).tolist()}
