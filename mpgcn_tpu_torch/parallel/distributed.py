"""The process group of a data-parallel run (counterpart of
mpgcn_tpu/parallel/distributed.py ``initialize``), and the launcher that
``-devices N`` uses to start N ranks of the command.

The JAX package runs one process over every local device and joins
processes through ``jax.distributed.initialize``. The port runs one
process per device, PyTorch's own idiom: ``initialize`` joins this process
to a ``torch.distributed`` group (NCCL between cards, gloo on the CPU).
Where the values come from: the explicit arguments first, then the
environment torchrun sets (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT``), not the JAX package's ``JAX_*``
names. With no world configured it is a no-op that returns False; a
configured world that fails to start raises; an explicit world of 1
starts a one-rank group and returns False. It is idempotent, and the
group has a finite timeout, so a lost peer fails a collective rather than
hanging it. ``hybrid_mesh`` (multi-slice TPU layouts) is not ported: no
slice is a concern of torch.distributed.

``launch_ranks`` starts ``python -m mpgcn_tpu_torch.cli <argv>`` once per
rank with the world's environment and a rendezvous on a free loopback
port, waits, stops every rank as soon as one fails, and returns the exit
code of the first rank to fail (128 + the signal for a rank a signal
ended), else 0.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import signal
import socket
import subprocess
import sys
import time
from typing import Optional

import torch
import torch.distributed as dist

#: seconds a collective (and the rendezvous) may wait for a peer
DEFAULT_TIMEOUT_S = 600.0
#: seconds the ranks left running get after SIGTERM before SIGKILL
_GRACE_S = 10.0


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return int(value) if value else None


def world_from_env() -> Optional[int]:
    """The world size torchrun's environment names, or None."""
    return _env_int("WORLD_SIZE")


def local_rank() -> int:
    """This process's index among the ranks of its host (``LOCAL_RANK``,
    else ``RANK``, else 0): the card it takes."""
    value = _env_int("LOCAL_RANK")
    return value if value is not None else (_env_int("RANK") or 0)


def initialize(init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None,
               backend: Optional[str] = None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Join the process group; returns True when the world has more than
    one rank. ``backend`` defaults to 'nccl' where a card is visible, else
    'gloo'; the caller picks 'gloo' for CPU ranks on a machine with
    cards."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    world_size = world_size if world_size is not None else world_from_env()
    rank = rank if rank is not None else _env_int("RANK")
    if init_method is None and os.environ.get("MASTER_ADDR") \
            and os.environ.get("MASTER_PORT"):
        init_method = "env://"
    if init_method is None and world_size is None:
        return False  # a single-process run: nothing to join
    if world_size is None:
        raise ValueError(f"init_method {init_method!r} without a world size: "
                         f"pass world_size or set WORLD_SIZE")
    if rank is None:
        if world_size != 1:
            raise ValueError(f"a world of {world_size} needs this process's "
                             f"rank: pass rank or set RANK")
        rank = 0
    if init_method is None:
        raise ValueError("a configured world needs a rendezvous: pass "
                         "init_method or set MASTER_ADDR and MASTER_PORT")
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    try:
        dist.init_process_group(
            backend, init_method=init_method, world_size=world_size,
            rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    except (RuntimeError, ValueError) as e:
        # continuing alone would leave the peers waiting in their first
        # collective, or training apart
        raise RuntimeError(
            f"torch.distributed.init_process_group failed for a configured "
            f"run (backend={backend}, init_method={init_method}, "
            f"world_size={world_size}, rank={rank})") from e
    return world_size > 1


def free_port() -> int:
    """A TCP port on the loopback interface that nothing listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _exit_code(status: int) -> int:
    """A wait status as a shell reports it: 128 + the signal that ended
    the process, else its exit code."""
    code = os.waitstatus_to_exitcode(status)
    return 128 - code if code < 0 else code


def _reap(pid: int, deadline: float) -> bool:
    """Wait for ``pid`` until ``deadline``; True when it was reaped."""
    while True:
        if os.waitpid(pid, os.WNOHANG)[0] == pid:
            return True
        if time.monotonic() >= deadline:
            return False
        time.sleep(0.05)


def launch_ranks(argv: list, n: int) -> int:
    """Run ``python -m mpgcn_tpu_torch.cli <argv>`` as ranks 0..n-1 of one
    world on this host and wait for them. SIGTERM and SIGINT sent here go
    on to every rank (each finishes its epoch, the ranks agree, rank 0
    saves). Returns the exit code of the first rank to fail, else 0; no
    rank is left running when it returns."""
    port = free_port()
    procs = {}
    for r in range(n):
        env = dict(os.environ, WORLD_SIZE=str(n), RANK=str(r),
                   LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(n),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        p = subprocess.Popen([sys.executable, "-m", "mpgcn_tpu_torch.cli",
                              *argv], env=env)
        procs[p.pid] = r
        print(f"[parallel] rank {r} of {n}: pid {p.pid}", flush=True)

    def forward(signum, frame):
        for pid in procs:
            with contextlib.suppress(ProcessLookupError):
                os.kill(pid, signum)

    previous = {}
    try:
        for sig in (signal.SIGTERM, signal.SIGINT):
            previous[sig] = signal.signal(sig, forward)
    except ValueError:  # not the main thread: nothing to forward
        pass
    first = 0
    try:
        while procs and not first:
            # the ranks in the order they end (os.wait reaps them)
            pid, status = os.wait()
            rank = procs.pop(pid, None)
            if rank is not None and _exit_code(status):
                first = _exit_code(status)
                print(f"[parallel] rank {rank} exited "
                      f"{os.waitstatus_to_exitcode(status)}: stopping the "
                      f"others", file=sys.stderr, flush=True)
    finally:
        for pid in procs:
            with contextlib.suppress(ProcessLookupError):
                os.kill(pid, signal.SIGTERM)
        deadline = time.monotonic() + _GRACE_S
        for pid in procs:
            if not _reap(pid, deadline):
                with contextlib.suppress(ProcessLookupError):
                    os.kill(pid, signal.SIGKILL)
                os.waitpid(pid, 0)
        for sig, prev in previous.items():
            signal.signal(sig, prev if prev is not None else signal.SIG_DFL)
    return first
