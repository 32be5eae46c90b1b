"""Flow capture on the request ledger (counterpart of
``capture_row_fields``, mpgcn_tpu/service/capture.py:256-268). The
daemon-side ``TrafficCapture`` that stitches captured rows back into
spool day files belongs to the daemon and is not ported yet."""

from __future__ import annotations

import numpy as np


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
