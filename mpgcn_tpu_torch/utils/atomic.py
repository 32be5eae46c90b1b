"""Atomic, durable writes (counterpart of mpgcn_tpu/utils/atomic.py).

``atomic_pickle_dump`` (and ``atomic_write_bytes`` for raw bytes) writes to a temporary file beside ``path``, flushes
and fsyncs it, then renames it over ``path``: a reader never sees a
partial file, and a crash between the write and the rename never
publishes unflushed pages. Checkpoints and the watchdog's emergency file
go through it. ``AsyncWriter`` runs those writes on one background
thread, in order, so a training loop does not wait for the disk.
"""

from __future__ import annotations

import os
import pickle
from concurrent.futures import ThreadPoolExecutor


def _atomic_write(path: str, write) -> str:
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        with open(tmp, "wb") as f:
            write(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return path


def atomic_pickle_dump(path: str, payload) -> str:
    """Pickle ``payload`` to ``path`` atomically and durably; returns
    ``path``."""
    return _atomic_write(path, lambda f: pickle.dump(payload, f))


def atomic_write_bytes(path: str, data: bytes) -> str:
    """Write ``data`` to ``path`` atomically and durably; returns
    ``path``."""
    return _atomic_write(path, lambda f: f.write(data))


class AsyncWriter:
    """``atomic_pickle_dump`` on one background thread, in the order of
    ``write``; ``flush`` waits for every write so far and raises the first
    that failed. The caller hands over host data it no longer changes, and
    flushes before it reads a file back."""

    def __init__(self):
        self._pool = None
        self._pending = []

    def write(self, path: str, payload) -> None:
        if self._pool is None:
            self._pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="mpgcn-ckpt-writer")
        self._pending.append(self._pool.submit(atomic_pickle_dump, path,
                                               payload))

    def flush(self) -> None:
        pending, self._pending = self._pending, []
        for f in pending:
            f.result()
