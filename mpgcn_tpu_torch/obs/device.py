"""Device telemetry: the card's memory as measured gauges (counterpart
of mpgcn_tpu/obs/device.py).

A daemon thread reads ``torch.cuda``'s allocator counters into gauges of
the default registry, with the JAX sampler's names where the meaning is
the same:

    mpgcn_device_bytes_in_use{device="0"}       torch.cuda.memory_allocated
    mpgcn_device_bytes_limit{device="0"}        the card's total memory
    mpgcn_device_bytes_reserved{device="0"}     torch.cuda.memory_reserved
    mpgcn_device_peak_bytes_in_use{device="0"}  torch.cuda.max_memory_allocated
    mpgcn_device_sample_errors_total            reads that failed
    mpgcn_device_samples_total                  sampler passes

Without CUDA it reads nothing, as the JAX sampler reads no memory stats
on XLA:CPU: only the pass counter moves. Every read is guarded; the
sampler never raises.
"""

from __future__ import annotations

import threading
from typing import Optional

import torch

from mpgcn_tpu_torch.obs.metrics import MetricsRegistry, default_registry


class DeviceSampler:
    """Poll the card's memory counters into gauges every ``interval_s``.
    ``sample_once()`` is the testable core; ``start()`` runs it on a
    daemon thread until ``stop()``."""

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 interval_s: float = 10.0):
        if interval_s <= 0:
            raise ValueError(f"interval_s={interval_s} must be > 0")
        self.registry = registry or default_registry()
        self.interval_s = float(interval_s)
        g = self.registry.gauge
        self._gauges = {
            "bytes_in_use": g("device_bytes_in_use", "per-device bytes "
                              "held by tensors (torch.cuda.memory_"
                              "allocated)"),
            "bytes_limit": g("device_bytes_limit", "per-device memory "
                             "capacity bytes"),
            "bytes_reserved": g("device_bytes_reserved", "per-device bytes "
                                "the caching allocator holds (torch.cuda."
                                "memory_reserved)"),
            "peak_bytes_in_use": g("device_peak_bytes_in_use", "per-device "
                                   "peak of bytes_in_use (torch.cuda."
                                   "max_memory_allocated)"),
        }
        self._errors = self.registry.counter(
            "device_sample_errors", "device telemetry reads that failed")
        self._samples = self.registry.counter(
            "device_samples", "device telemetry sampler passes")
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @staticmethod
    def _read(i: int) -> dict:
        return {"bytes_in_use": torch.cuda.memory_allocated(i),
                "bytes_limit": torch.cuda.get_device_properties(i)
                .total_memory,
                "bytes_reserved": torch.cuda.memory_reserved(i),
                "peak_bytes_in_use": torch.cuda.max_memory_allocated(i)}

    def sample_once(self) -> dict:
        """One pass; returns what it read, by device. Never raises:
        failures count into the errors series."""
        out: dict = {"devices": {}}
        try:
            if torch.cuda.is_available():
                for i in range(torch.cuda.device_count()):
                    try:
                        stats = self._read(i)
                    except Exception:
                        self._errors.inc()
                        continue
                    for name, v in stats.items():
                        self._gauges[name].labels(device=str(i)).set(
                            float(v))
                    out["devices"][str(i)] = {k: int(v)
                                              for k, v in stats.items()}
            self._samples.inc()
        except Exception:
            self._errors.inc()
        return out

    def start(self) -> "DeviceSampler":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="mpgcn-device-sampler")
            self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.sample_once()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
