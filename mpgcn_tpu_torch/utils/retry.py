"""Retry with backoff for host file reads (counterpart of
mpgcn_tpu/resilience/retry.py).

Data directories on network mounts fail reads transiently under load.
``read_with_retry`` wraps one read, retries ``OSError`` with exponential
backoff, and on the final failure raises an ``IOError`` that names the
file.

Fault injection: given a ``FaultPlan`` (resilience/faults.py) with
``io_errors=K``, the first K tries raise an injected ``OSError`` before
the file is touched, so the chaos tests drive this retry loop end to
end.
"""

from __future__ import annotations

import time
from typing import Callable, Optional, TypeVar

T = TypeVar("T")


def read_with_retry(fn: Callable[[], T], path: str, *,
                    attempts: int = 3,
                    base_delay_s: float = 0.05,
                    faults=None,
                    _sleep: Callable[[float], None] = time.sleep) -> T:
    """Call ``fn()`` (a read of ``path``), retrying ``OSError`` up to
    ``attempts`` times with ``base_delay_s * 2**i`` between tries;
    ``faults.maybe_io_error(path)`` runs before each try when a plan is
    given.

    Raises an ``IOError`` naming ``path`` when every attempt fails. Errors
    that a retry cannot fix propagate at once and keep their type: bad
    file content (format errors) and permanent OS errors (missing file,
    bad permissions, a directory in the file's place).
    """
    if attempts < 1:
        raise ValueError(f"attempts={attempts} must be >= 1")
    last: Optional[BaseException] = None
    for i in range(attempts):
        try:
            if faults is not None:
                faults.maybe_io_error(path)
            return fn()
        except (FileNotFoundError, PermissionError, IsADirectoryError,
                NotADirectoryError):
            raise
        except OSError as e:
            last = e
            if i + 1 < attempts:
                delay = base_delay_s * (2 ** i)
                print(f"WARNING: read of {path} failed "
                      f"({e}); retry {i + 1}/{attempts - 1} in "
                      f"{delay:.2f}s")
                _sleep(delay)
    raise IOError(f"failed to read {path} after {attempts} attempts; "
                  f"last error: {last}") from last
