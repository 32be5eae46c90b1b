"""Profiling helpers (counterpart of mpgcn_tpu/utils/profiling.py):
``StepTimer`` (steps/sec with the first steps left out), ``trace_if`` (a
``torch.profiler`` window over a block, its trace written into a
directory: ``-trace`` on the train command, ``serve`` and ``daemon``) and
``step_annotation`` (a ``torch.profiler.record_function`` around one step
while a window is open, a free ``nullcontext`` otherwise).

While a window is open the hand kernels' wrappers also name each eager
launch by its entry (native/build.py ``CudaKernel.launch``,
``kernel_annotation``); a launch replayed from a CUDA graph shows as the
device kernel alone. Nothing here imports torch until a window opens.
"""

from __future__ import annotations

import contextlib
import os
import time

#: set while a ``trace_if`` window is recording: ``step_annotation`` and
#: ``kernel_annotation`` annotate only then
_TRACE_ACTIVE = False


class StepTimer:
    """Wall-clock steps/sec with warmup exclusion (the first ticks build
    the kernels and capture the graphs).

    The measurement contract, as the JAX package's:

      * the clock can only start at a tick boundary: ``t0`` is set at the
        end of the tick whose cumulative steps first reach
        ``warmup_steps``, and every step of that tick (all ``n`` of a
        multi-step tick) is excluded, so a multi-step first tick never
        starts the clock with work already done inside the window;
      * ``warmup_steps=0`` starts the clock at construction or reset and
        counts everything.

    Call ``tick`` after the step's host sync, so the timed window covers
    the device's work.
    """

    def __init__(self, warmup_steps: int = 1):
        if warmup_steps < 0:
            raise ValueError(f"warmup_steps={warmup_steps} must be >= 0")
        self.warmup_steps = warmup_steps
        self.reset()

    def reset(self):
        self._steps = 0
        self._steps_at_t0 = 0
        # warmup 0: nothing to exclude, measure from now
        self._t0 = time.perf_counter() if self.warmup_steps == 0 else None

    def tick(self, n: int = 1):
        """Record n completed steps (n > 1: a chunk whose steps all
        finished by now)."""
        self._steps += n
        if self._t0 is None and self._steps >= self.warmup_steps:
            # the clock starts here, at the end of the crossing tick, and
            # every step of it is left out
            self._t0 = time.perf_counter()
            self._steps_at_t0 = self._steps

    @property
    def measured_steps(self) -> int:
        """Steps inside the measured window (post-warmup ticks only)."""
        if self._t0 is None:
            return 0
        return self._steps - self._steps_at_t0

    @property
    def steps_per_sec(self) -> float:
        if self._t0 is None or self._steps <= self._steps_at_t0:
            return 0.0
        return (self._steps - self._steps_at_t0) / (
            time.perf_counter() - self._t0)


@contextlib.contextmanager
def trace_if(trace_dir: str | None, device=None):
    """A ``torch.profiler.profile`` window over the block when
    ``trace_dir`` is set (else nothing): CPU activity, plus CUDA activity
    when ``device`` is the card. On leaving the block the trace is
    written into ``trace_dir`` (``<host>_<pid>.<ms>.pt.trace.json``,
    ``torch.profiler.tensorboard_trace_handler``), every thread's CPU
    activity in it. Yields the profiler, or None without a window."""
    global _TRACE_ACTIVE
    if not trace_dir:
        yield None
        return
    import torch
    from torch.profiler import (
        ProfilerActivity,
        profile,
        tensorboard_trace_handler,
    )

    os.makedirs(trace_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    # every thread's ops and annotations: the serving plane runs its
    # batches on the batcher threads, the daemon its retrains' backward
    # on autograd's (the default records the entering thread's only)
    config = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    with profile(activities=activities, experimental_config=config,
                 on_trace_ready=tensorboard_trace_handler(trace_dir)) as prof:
        _TRACE_ACTIVE = True
        try:
            yield prof
        finally:
            _TRACE_ACTIVE = False


def step_annotation(step: int, name: str = "train_step"):
    """A ``torch.profiler.record_function`` named ``<name>#<step>`` while a
    ``trace_if`` window records, else a free nullcontext: the per-step
    paths wrap each step in it, so a traced run shows its step boundaries
    and an untraced one pays nothing."""
    if not _TRACE_ACTIVE:
        return contextlib.nullcontext()
    import torch

    return torch.profiler.record_function(f"{name}#{step}")


def kernel_annotation(entry: str):
    """A ``record_function`` named by a hand kernel's C entry while a
    window records (the wrapper's eager launch), else a nullcontext."""
    if not _TRACE_ACTIVE:
        return contextlib.nullcontext()
    import torch

    return torch.profiler.record_function(entry)
