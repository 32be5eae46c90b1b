"""Crossover measurement harnesses behind ``tune run`` (counterpart of
mpgcn_tpu/tune/measure.py).

Each registered constant's ``harness`` names one function here; ``tune
run`` sweeps the constant's search space on the device it runs on (the
card unless ``device="cpu"`` is asked for), finds the crossover, and
stores it with its curve in ``tuned/<platform>.json``
(`registry.save_profile`).

Method, the JAX package's: best of ``reps`` with the arms interleaved
inside each rep, so that a burst of load on a shared host does not
deflate one arm alone. A step is timed between two
``torch.cuda.synchronize()``; an epoch by its own host read of the
losses.

Departures, on purpose:
  * the dense arm of `measure_sparse_crossover` is ``kernel`` (the arm
    the port's ``auto`` takes for dense banks), not ``einsum``; the
    sparse arm is ``ell`` on both devices (the JAX code takes ``csr``
    off the TPU);
  * `measure_bdgcn_bwd_crossover`, `measure_lstm_bwd_crossover` and
    `measure_pallas_tile_grid` measure switches of the JAX package's
    TPU path that the port does not have: each returns ``{"skipped":
    why}``.

torch is imported inside the harnesses only: the registry and planner
side of the package stays importable without it.
"""

from __future__ import annotations

import contextlib
import inspect
import os
import sys
import tempfile
import time
from typing import Optional, Sequence

import numpy as np

#: the reference synthetic shape, rebased for the sweeps (the JAX
#: harnesses' _BASE_FIELDS)
_BASE_FIELDS = dict(data="synthetic", obs_len=7, pred_len=1,
                    batch_size=4, hidden_dim=32, num_epochs=1)

#: the knobs a harness sets on purpose: a tuned profile must not move
#: the arm it measures
_PINNED = ("epoch_scan_max_mb", "stream_chunk_mb")


def resolve_tune_device(device=None):
    """The harnesses' device: the card unless ``device`` says otherwise;
    raises where CUDA is asked for and there is none."""
    from mpgcn_tpu_torch.device import resolve_device

    return resolve_device(device if device is not None else "cuda")


def _out_dir(tag: str) -> str:
    return os.path.join(tempfile.gettempdir(), f"mpgcn_tune_{tag}")


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def banded_density(data: dict, density: float) -> None:
    """Project the synthetic graphs and the OD flows onto a circulant
    band of ~``density`` nonzero share, in place (the large-N city's
    shape; data/loader.py ``apply_density``)."""
    from mpgcn_tpu_torch.data.loader import apply_density

    apply_density(data, density)


def step_rate(trainer, steps: int = 2) -> float:
    """Steps/sec of the per-step path (``ModelTrainer.train_step``) on
    one fixed batch: 2 warm-up steps, then ``steps`` timed between two
    device synchronisations. The loss must stay finite."""
    t = trainer
    batch = next(t.pipeline.batches("train", pad_to_full=True))
    for _ in range(2):  # build, load and warm
        loss = t.train_step(batch)
    _sync(t.device)
    t0 = time.perf_counter()
    for _ in range(steps):
        loss = t.train_step(batch)
    _sync(t.device)
    dt = time.perf_counter() - t0
    if not np.isfinite(loss):
        raise RuntimeError(f"tune sweep produced a non-finite loss {loss}")
    return steps / dt


def best_of(arms: dict, measure, reps: int = 2) -> dict:
    """Best of ``reps`` per arm, the arms interleaved inside each rep."""
    rates = {k: 0.0 for k in arms}
    for _ in range(reps):
        for k, obj in arms.items():
            rates[k] = max(rates[k], measure(obj))
    return rates


def _epoch_rate(t, path: str, epochs: int) -> float:
    """Steps/sec of ``epochs`` train epochs on executor ``path`` ('scan'
    or 'stream') after one warm-up epoch (which captures the graphs on
    the card), each epoch ending in its own host read of the losses."""
    rng = np.random.default_rng(0)
    S = len(t._run_epoch("train", path, rng)[1])
    t0 = time.perf_counter()
    for _ in range(epochs):
        t._run_epoch("train", path, rng)
    return epochs * S / (time.perf_counter() - t0)


def _dense_sparse_pair(n: int, density: float, device, seed: int = 0):
    """(dense trainer, sparse trainer) on the same banded synthetic
    city: ``kernel`` on dense storage against ``ell`` on sparse storage
    (what the port's ``auto`` chooses between)."""
    from mpgcn_tpu_torch.config import MPGCNConfig
    from mpgcn_tpu_torch.data.loader import load_dataset
    from mpgcn_tpu_torch.train.trainer import ModelTrainer

    base = MPGCNConfig(
        data="synthetic", synthetic_T=60, synthetic_N=n, obs_len=7,
        pred_len=1, batch_size=1, hidden_dim=16, num_epochs=1, seed=seed,
        output_dir=_out_dir("sparse"), dtype="bfloat16", remat=True,
        epoch_scan=False)
    with contextlib.redirect_stdout(sys.stderr):
        data, di = load_dataset(base)
        banded_density(data, density)
        base = base.replace(num_nodes=data["OD"].shape[1])
        dense = ModelTrainer(base.replace(od_storage="dense"), data,
                             device=device, bdgcn_impl="kernel",
                             data_container=di)
        sparse = ModelTrainer(base.replace(od_storage="sparse"), data,
                              device=device, bdgcn_impl="ell",
                              data_container=di)
    return dense, sparse


def measure_sparse_crossover(n: int = 300,
                             densities: Sequence[float] = (
                                 0.02, 0.05, 0.1, 0.2, 0.3),
                             steps: int = 2, reps: int = 2,
                             device=None) -> dict:
    """Dense against sparse steps/s across the density grid at fixed N:
    the tuned ``sparse_density_threshold`` is the largest grid density
    where the sparse arm still wins (0.0 when it never does)."""
    dev = resolve_tune_device(device)
    curve = []
    threshold = 0.0
    for d in densities:
        dense, sparse = _dense_sparse_pair(n, d, dev)
        try:
            rates = best_of({"dense": dense, "sparse": sparse},
                            lambda t: step_rate(t, steps), reps)
        finally:
            dense.close()
            sparse.close()
        del dense, sparse
        win = rates["sparse"] >= rates["dense"]
        curve.append({"density": d,
                      "dense_sps": round(rates["dense"], 4),
                      "sparse_sps": round(rates["sparse"], 4),
                      "sparse_wins": win})
        if win:
            threshold = max(threshold, d)
    return {"value": threshold, "n": n, "curve": curve}


def _epoch_trainers(cfgs: dict, device) -> dict:
    """{key: ModelTrainer} over one synthetic series, one per config
    (the configs differ in executor knobs only)."""
    from mpgcn_tpu_torch.data.loader import load_dataset
    from mpgcn_tpu_torch.train.trainer import ModelTrainer

    out = {}
    with contextlib.redirect_stdout(sys.stderr):
        data, di = load_dataset(next(iter(cfgs.values())))
        for key, cfg in cfgs.items():
            cfg = cfg.replace(num_nodes=data["OD"].shape[1])
            out[key] = ModelTrainer(cfg, data, device=device,
                                    data_container=di)
    return out


def _require_exec(trainers: dict, path: str) -> None:
    """Each trainer's train mode resolves to executor ``path`` (the arm
    the harness means to time)."""
    with contextlib.redirect_stdout(sys.stderr):
        got = {k: t._epoch_exec("train") for k, t in trainers.items()}
    if any(v != path for v in got.values()):
        raise RuntimeError(f"expected the {path} executor, got {got}")


def measure_stream_chunk(chunks_mb: Sequence[float] = (
                             0.05, 0.1, 0.25, 0.5, 1.0),
                         epochs: int = 2, reps: int = 2,
                         device=None) -> dict:
    """Stream-executor steps/s across the chunk grid on a shape over the
    scan budget: the tuned ``stream_chunk_mb`` is the argmax."""
    from mpgcn_tpu_torch.config import MPGCNConfig

    dev = resolve_tune_device(device)
    fields = dict(_BASE_FIELDS, synthetic_T=320, synthetic_N=6,
                  hidden_dim=8, num_branches=2, epoch_scan_max_mb=0.001,
                  output_dir=_out_dir("stream"), explicit_knobs=_PINNED)
    trainers = _epoch_trainers(
        {mb: MPGCNConfig(**fields, stream_chunk_mb=mb) for mb in chunks_mb},
        dev)
    try:
        _require_exec(trainers, "stream")
        rates = best_of(trainers, lambda t: _epoch_rate(t, "stream",
                                                        epochs), reps)
    finally:
        for t in trainers.values():
            t.close()
    curve = [{"chunk_mb": mb, "steps_per_sec": round(rates[mb], 3)}
             for mb in chunks_mb]
    best = max(chunks_mb, key=lambda mb: rates[mb])
    return {"value": float(best), "curve": curve}


def measure_scan_stream_crossover(epochs: int = 2, reps: int = 2,
                                  device=None) -> dict:
    """Scan against stream steps/s at the reference shape: confirms or
    moves ``epoch_scan_max_mb``. Where the scan executor wins the
    guessed budget stands; where the stream wins, the budget drops
    below the shape's footprint so that 'auto' streams it."""
    from mpgcn_tpu_torch.config import MPGCNConfig
    from mpgcn_tpu_torch.tune.registry import guessed_default

    dev = resolve_tune_device(device)
    fields = dict(_BASE_FIELDS, synthetic_T=320, synthetic_N=6,
                  hidden_dim=8, num_branches=2,
                  output_dir=_out_dir("scan"), explicit_knobs=_PINNED)
    default_mb = float(guessed_default("epoch_scan_max_mb"))
    cfg = MPGCNConfig(**fields)
    trainers = _epoch_trainers(
        {"scan": cfg, "stream": cfg.replace(epoch_scan_max_mb=0.001,
                                            stream_chunk_mb=0.25)}, dev)
    try:
        _require_exec({"scan": trainers["scan"]}, "scan")
        _require_exec({"stream": trainers["stream"]}, "stream")
        footprint_mb = trainers["scan"]._mode_bytes("train")
        rates = best_of(trainers, lambda t: _epoch_rate(
            t, "scan" if t is trainers["scan"] else "stream", epochs), reps)
    finally:
        for t in trainers.values():
            t.close()
    scan_sps, stream_sps = rates["scan"], rates["stream"]
    value = default_mb if scan_sps >= stream_sps \
        else max(footprint_mb / 2.0, 0.001)
    return {"value": value,
            "curve": [{"path": "scan", "steps_per_sec": round(scan_sps, 3)},
                      {"path": "stream",
                       "steps_per_sec": round(stream_sps, 3)}],
            "footprint_mb": round(footprint_mb, 4)}


def _no_switch(name: str, what: str) -> dict:
    return {"skipped": f"{name}: {what} is a switch of the JAX package's "
                       f"TPU path; the port has none (a CUDA tensor "
                       f"always launches its kernel)"}


def measure_bdgcn_bwd_crossover(grid: Sequence[int] = (
        4096, 16384, 65536, 262144), steps: int = 2,
        reps: int = 2, device=None) -> dict:
    return _no_switch("bdgcn_bwd_crossover",
                      "the folded-vs-einsum BDGCN backward")


def measure_lstm_bwd_crossover(grid: Sequence[int] = (
        4096, 16384, 65536, 262144), steps: int = 2,
        reps: int = 2, device=None) -> dict:
    return _no_switch("lstm_bwd_crossover",
                      "the Pallas-vs-XLA-scan LSTM backward")


def measure_pallas_tile_grid(budgets_mib: Sequence[int] = (2, 4, 8, 16, 32),
                             steps: int = 2, reps: int = 2,
                             device=None) -> dict:
    return _no_switch("pallas_tile_grid", "the VMEM tile budget")


#: harness name (registry .harness field) -> measurement function and
#: the constants one run of it tunes
HARNESSES = {
    "sparse_crossover": (measure_sparse_crossover,
                         ("sparse_density_threshold",)),
    "stream_chunk": (measure_stream_chunk, ("stream_chunk_mb",)),
    "scan_stream_crossover": (measure_scan_stream_crossover,
                              ("epoch_scan_max_mb",)),
    "bdgcn_bwd_crossover": (measure_bdgcn_bwd_crossover,
                            ("bdgcn_bwd_min_pairs",)),
    "lstm_bwd_crossover": (measure_lstm_bwd_crossover,
                           ("lstm_bwd_min_rows",)),
    "pallas_tile_grid": (measure_pallas_tile_grid,
                         ("pallas_vmem_tile_budget",)),
}


def run_harnesses(names: Optional[Sequence[str]] = None,
                  steps: int = 2, reps: int = 2, device=None) -> tuple:
    """Run the named harnesses on ``device`` (default: the card; by
    default every harness meaningful on its platform, the bucket planner
    excluded -- it needs a trace) -> (values, curves, notes) for
    `registry.save_profile`."""
    from mpgcn_tpu_torch.tune.registry import (
        REGISTRY,
        device_platform,
        short_platform,
    )

    dev = resolve_tune_device(device)
    plat = short_platform(device_platform(dev))
    if names is None:
        names = [h for h, (_, consts) in HARNESSES.items()
                 if any(plat in REGISTRY[c].platforms for c in consts)]
    values, curves, notes = {}, {}, {}
    for h in names:
        fn, consts = HARNESSES[h]
        params = inspect.signature(fn).parameters
        kw = {k: v for k, v in (("steps", steps), ("reps", reps))
              if k in params}
        out = fn(device=dev, **kw)
        if "skipped" in out:
            notes[h] = out["skipped"]
            continue
        for c in consts:
            values[c] = out["value"]
            curves[c] = out.get("curve", [])
        notes[h] = out
    return values, curves, notes
