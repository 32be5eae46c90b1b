"""Per-mode datasets, the host feed, and graph support banks (counterpart
of mpgcn_tpu/data/pipeline.py).

Windows stay on the host: zero-copy strided views of the dense series, or
under sparse OD storage (``cfg.od_storage``; 'auto' takes it for N >=
``sparse_min_nodes`` at OD density <= ``sparse_density_threshold``)
``WindowView``s over a ``SparseODSeries`` that densify only the rows a
gather asks for. Gathers of dense storage go through the C++/OpenMP host
kernel (native/host.py) unless ``cfg.native_host`` is 'off' or it does
not build; the ``[dispatch]`` line says which ran and, for numpy, why.
``epoch_chunks`` and ``stream_chunks`` feed the chunked-stream epoch
executor: an epoch's (S, B) index in chunks of steps, each gathered
(into pinned host memory for the card) on a background thread behind a
queue of depth 1, so chunk k+1 is gathered while chunk k computes.

The support banks are computed once, on the serving device: the static
stack (K, N, N), the POI stack (K, N, N) when a branch uses it, and the
seven weekly O/D correlation stacks (7, K, N, N) that a batch gathers by
day-of-week key.
``batches`` streams a mode's windows in order (or shuffled), repeat-padding
the last partial batch to full size when asked, as the JAX pipeline does.

The bank build also settles the BDGCN arm, in the one place that
``ModelTrainer`` and ``ServeEngine`` share (mpgcn_tpu/train/trainer.py:
160-197, 470-495): it measures the banks' density, resolves
``bdgcn_impl='auto'`` by it, and for the sparse arms ('csr', 'ell')
stores every bank as a container with one pad shared across the banks
and the values packed as ``cfg.support_payload``.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator, Optional

import numpy as np
import torch

from mpgcn_tpu_torch.config import BDGCN_IMPLS, MPGCNConfig
from mpgcn_tpu_torch.data.windows import (
    MODES,
    SparseODSeries,
    WindowView,
    dow_keys,
    mode_offset,
    sliding_windows,
    split_lengths,
)
from mpgcn_tpu_torch.device import resolve_device
from mpgcn_tpu_torch.graph.kernels import (
    batch_supports,
    compute_supports,
    pack_supports,
    validate_graph,
)
from mpgcn_tpu_torch.native import host
from mpgcn_tpu_torch.sparse.formats import (
    BlockedELL,
    PaddedCSR,
    container_nbytes,
    container_pad,
    dense_equiv_bytes,
    ell_pad_width,
    sparsify_support_stack,
)
from mpgcn_tpu_torch.tune.registry import device_platform, resolve_knob
from mpgcn_tpu_torch.utils.retry import read_with_retry


def resolve_bdgcn_impl(requested: str, cfg: MPGCNConfig, num_nodes: int,
                       density: float, platform: Optional[str] = None) -> str:
    """The BDGCN arm: 'auto' gives 'ell' when the measured support density
    is at or below ``sparse_density_threshold`` and N is at least
    ``sparse_min_nodes``, else 'kernel' (on the CPU too, where the
    wrappers run their plain versions); any other arm stands as asked.
    Both thresholds resolve explicit knob > tuned profile of
    ``platform`` ('torch-cuda' / 'torch-cpu') > guessed default
    (tune/registry.py ``resolve_knob``).

    The JAX ``auto`` takes 'csr' off the TPU (its padded-CSR gathers
    beat its blocked-ELL scan there), 'ell' on it. The port takes 'ell'
    on both devices: its ELL SpMMs are the ported TPU kernels, on the
    card's tensor cores, where 'csr' is plain PyTorch gathers."""
    if requested == "auto":
        if (num_nodes >= resolve_knob(cfg, "sparse_min_nodes", platform)
                and density <= resolve_knob(cfg, "sparse_density_threshold",
                                            platform)):
            return "ell"
        return "kernel"
    if requested not in BDGCN_IMPLS:
        raise ValueError(f"bdgcn_impl={requested!r} is not one of "
                         f"{('auto',) + BDGCN_IMPLS}")
    return requested


@dataclasses.dataclass
class ModeData:
    """Per-mode arrays; x/y float32 views, keys int32 day-of-week slots."""

    x: np.ndarray      # (n, obs_len, N, N, 1)
    y: np.ndarray      # (n, pred_len, N, N, 1)
    keys: np.ndarray   # (n,)

    def __len__(self):
        return self.x.shape[0]


@dataclasses.dataclass
class Batch:
    """One batch of host arrays; ``size`` counts the real rows (the rest
    repeat the last one and are masked out of the loss)."""

    x: np.ndarray      # (B, obs_len, N, N, 1)
    y: np.ndarray      # (B, pred_len, N, N, 1)
    keys: np.ndarray   # (B,)
    size: int


@dataclasses.dataclass
class EpochChunk:
    """A contiguous slice of an epoch's (S, B) batch stream, gathered on
    the host for the chunked-stream executor: (steps, B, ...) rows of the
    epoch index. ``pinned`` holds the page-locked tensors that ``x`` and
    ``y`` view when the chunk was gathered for the card (empty on the
    CPU)."""

    x: np.ndarray         # (steps, B, obs_len, N, N, 1)
    y: np.ndarray         # (steps, B, pred_len, N, N, 1)
    keys: np.ndarray      # (steps, B) int32
    sizes: np.ndarray     # (steps,) int32 true batch sizes
    start_step: int       # the epoch step of the chunk's first step
    pinned: tuple = ()


class DataPipeline:
    """Per-mode windows plus the support banks, on ``device``, stored for
    the BDGCN arm ``bdgcn_impl`` resolves to (``self.bdgcn_impl``).

    ``gather_provenance`` / ``gather_faults``: optional io-retry cover
    for the host window gathers (``gather_xy``), the ones on the
    chunked-stream staging thread included. ``gather_provenance(mode,
    sel)`` names the source of the requested windows (the
    continual-learning daemon maps window rows back to the day files
    behind them, service/daemon.py), so a retry or failure names the day
    file; ``gather_faults`` is a ``FaultPlan`` whose ``io_errors`` drive
    the retry loop."""

    def __init__(self, cfg: MPGCNConfig, data: dict, device="cuda",
                 bdgcn_impl: str = "auto", gather_provenance=None,
                 gather_faults=None):
        self.cfg = cfg
        self._gather_provenance = gather_provenance
        self._gather_faults = gather_faults
        self.device = resolve_device(device)
        od = np.ascontiguousarray(np.asarray(data["OD"], dtype=np.float32))
        #: 'dense' or 'sparse': how the host holds the series
        self.od_storage = self._resolve_od_storage(od)
        self.od_series = self._od = None
        if self.od_storage == "sparse":
            # the (n, T, N, N) host windows never densify; gathers
            # densify only the rows they ask for
            self.od_series = SparseODSeries.from_dense(od)
            T = od.shape[0]
            end = (T - cfg.pred_len if cfg.drop_last_window
                   else T - cfg.pred_len + 1)
            n_windows = end - cfg.obs_len
            if n_windows <= 0:
                raise ValueError(
                    f"series too short: T={T}, obs_len={cfg.obs_len}, "
                    f"pred_len={cfg.pred_len}")
        else:
            x, y = sliding_windows(od, cfg.obs_len, cfg.pred_len,
                                   cfg.drop_last_window)
            n_windows = y.shape[0]
            self._od = od
        del od
        #: how dense windows are gathered ('native' or 'numpy'), and why
        #: not natively (None when natively)
        self.host_gather, self.host_gather_why = self._resolve_gather()
        self.mode_len = split_lengths(n_windows, cfg.split_ratio)
        empty = [m for m in MODES if self.mode_len[m] <= 0]
        if empty:
            raise ValueError(
                f"split {tuple(cfg.split_ratio)} of {n_windows} windows "
                f"leaves mode(s) {empty} empty; use a longer series or a "
                f"different split_ratio")
        self.modes: dict[str, ModeData] = {}
        self._series_views: dict = {}
        for mode in MODES:
            off = mode_offset(mode, self.mode_len)
            n = self.mode_len[mode]
            if self.od_series is not None:
                mx = WindowView(self.od_series, off, n, cfg.obs_len)
                my = WindowView(self.od_series, off + cfg.obs_len, n,
                                cfg.pred_len)
            else:
                mx, my = x[off: off + n], y[off: off + n]
            self._series_views[mode] = (mx, my)
            self.modes[mode] = ModeData(
                x=mx, y=my,
                keys=dow_keys(mode, self.mode_len, cfg.obs_len,
                              cfg.perceived_period).astype(np.int32))

        sources = cfg.resolved_branch_sources
        clamp = cfg.symnorm_degree_clamp

        def supports(graph, name, batched=False):
            g = validate_graph(graph, cfg.kernel_type, name,
                               cfg.isolated_nodes, degree_clamp=clamp)
            fn = batch_supports if batched else compute_supports
            return fn(np.asarray(g, np.float32), cfg.kernel_type,
                      cfg.cheby_order, cfg.lambda_max, cfg.lambda_max_iters,
                      degree_clamp=clamp, device=self.device)

        # dense (..., N, N) stacks; BlockedELL containers for the 'ell' arm
        self.banks: dict = {}
        if "static" in sources:
            self.banks["static"] = supports(data["adj"], "adjacency")
        if "poi" in sources:
            if data.get("poi_sim") is None:
                raise ValueError(
                    "branch source 'poi' needs a POI-similarity graph, but "
                    "the data dict has none; rebuild it with the same "
                    "branch spec")
            self.banks["poi"] = supports(data["poi_sim"], "POI similarity")
        if "dynamic" in sources:
            if data.get("O_dyn_G") is None:
                raise ValueError(
                    "a 'dynamic' branch needs dynamic O/D graphs, but the "
                    "data dict has none; rebuild it with the same branch "
                    "spec")
            self.banks["o"] = supports(np.moveaxis(data["O_dyn_G"], -1, 0),
                                       "O-correlation graphs", batched=True)
            self.banks["d"] = supports(np.moveaxis(data["D_dyn_G"], -1, 0),
                                       "D-correlation graphs", batched=True)
        self._build_sparse(bdgcn_impl)

    def _resolve_od_storage(self, od: np.ndarray) -> str:
        """``cfg.od_storage``; 'auto' takes sparse host storage under the
        sparse arms' rule: N >= sparse_min_nodes and an OD density at or
        below sparse_density_threshold, each resolved through the
        registry for this device's platform (JAX:
        ``_resolve_od_storage``)."""
        cfg = self.cfg
        if cfg.od_storage != "auto":
            return cfg.od_storage
        plat = device_platform(self.device)
        if od.shape[1] < resolve_knob(cfg, "sparse_min_nodes", plat):
            return "dense"
        density = np.count_nonzero(od) / max(od.size, 1)
        return ("sparse"
                if density <= resolve_knob(cfg, "sparse_density_threshold",
                                           plat)
                else "dense")

    def _resolve_gather(self) -> tuple:
        """('native', None) when dense windows are gathered by the host
        library, else ('numpy', why)."""
        if self.od_storage == "sparse":
            return "numpy", ("od_storage=sparse: the series densifies the "
                             "rows a gather asks for")
        if self.cfg.native_host == "off":
            return "numpy", "-native off"
        if not host.available():
            return "numpy", (f"the host library did not build: "
                             f"{host.unavailable_reason()}")
        return "native", None

    def _build_sparse(self, requested: str) -> None:
        """Measure the banks' density, resolve the BDGCN arm, and for the
        sparse arms re-store every bank as a container with one shared
        pad."""
        cfg = self.cfg
        nnz = sum(int(torch.count_nonzero(v)) for v in self.banks.values())
        total = sum(v.numel() for v in self.banks.values())
        self.support_nnz = nnz
        self.support_density = nnz / total if total else 1.0
        self.requested_impl = requested
        self.bdgcn_impl = impl = resolve_bdgcn_impl(
            requested, cfg, self.num_nodes, self.support_density,
            device_platform(self.device))
        if impl != "ell" and cfg.support_payload == "int8":
            raise ValueError(
                f"support_payload='int8' packs blocked-ELL tiles as "
                f"codes + per-row-block scales, so it needs the 'ell' "
                f"arm, but bdgcn_impl={requested!r} resolved to {impl!r}")
        if impl not in ("csr", "ell"):
            return  # dense banks ignore the payload, as in the JAX package
        dense = {k: v.cpu().numpy() for k, v in self.banks.items()}
        # one pad across banks, as the JAX trainer plans it
        pad = max(ell_pad_width(v) if impl == "ell"
                  else container_pad(sparsify_support_stack(v, "csr"))
                  for v in dense.values())
        self.banks = {
            k: pack_supports(v, impl, cfg.support_payload,
                             pad=pad).to(self.device)
            for k, v in dense.items()}

    def dispatch_line(self, lstm_impl: str) -> str:
        """The kernel-dispatch decision, as the JAX trainer prints it."""
        cfg = self.cfg
        return (f"[dispatch] bdgcn_impl={self.bdgcn_impl} (requested "
                f"{self.requested_impl!r}), lstm_impl={lstm_impl}, device "
                f"{self.device}, support density {self.support_density:.4f}"
                + (f", od_storage={self.od_storage}"
                   if self.od_storage != "dense" else "")
                + (", fused_epilogue=on" if cfg.fused_epilogue else "")
                + (f", support_payload={cfg.support_payload}"
                   if cfg.support_payload != "f32"
                   and self.bdgcn_impl in ("csr", "ell") else "")
                + f", host gather {self.host_gather}"
                + (f" ({self.host_gather_why})" if self.host_gather_why
                   else ""))

    def support_stats(self) -> dict:
        """Resident bytes of the banks as stored (containers with their
        index, or dense f32) against the dense f32 equivalent."""
        resident = dense = 0
        for b in self.banks.values():
            if isinstance(b, (BlockedELL, PaddedCSR)):
                resident += container_nbytes(b)
                dense += dense_equiv_bytes(b)
            else:
                resident += b.numel() * b.element_size()
                dense += b.numel() * 4
        return {"payload": self.cfg.support_payload,
                "impl": self.bdgcn_impl,
                "resident_bytes": int(resident),
                "dense_f32_bytes": int(dense),
                "reduction": round(dense / resident, 2) if resident else 1.0}

    @property
    def num_nodes(self) -> int:
        return self.modes["train"].x.shape[2]

    def num_batches(self, mode: str, batch_size: Optional[int] = None) -> int:
        bs = batch_size or self.cfg.batch_size
        return -(-len(self.modes[mode]) // bs)

    def batches(self, mode: str, batch_size: Optional[int] = None,
                shuffle: Optional[bool] = None,
                rng: Optional[np.random.Generator] = None,
                pad_to_full: bool = False) -> Iterator[Batch]:
        """Stream a mode's batches. ``shuffle`` (None: cfg.shuffle) permutes
        the window order with ``rng`` (None: a generator seeded by
        cfg.seed); ``pad_to_full`` repeat-pads the final partial batch to
        the full batch size, masked through ``Batch.size``."""
        md = self.modes[mode]
        bs = batch_size or self.cfg.batch_size
        n = len(md)
        idx = np.arange(n)
        if shuffle if shuffle is not None else self.cfg.shuffle:
            (rng or np.random.default_rng(self.cfg.seed)).shuffle(idx)
        for start in range(0, n, bs):
            sel = idx[start: start + bs]
            size = sel.shape[0]
            if pad_to_full and size < bs:
                sel = np.concatenate([sel, np.full(bs - size, sel[-1])])
            x, y = self.gather_xy(mode, sel)
            yield Batch(x=x, y=y, keys=md.keys[sel], size=size)

    def gather_xy(self, mode: str, sel: np.ndarray, out=None):
        """x, y rows of ``mode`` for the flat window indices ``sel``: the
        host library's gather (dense storage, ``host_gather`` 'native'),
        the sparse series' densify, or numpy's; written into ``out`` (a
        pair of float32 arrays of the gathered shapes) when given. The
        same bytes every way. With ``gather_provenance`` or
        ``gather_faults`` the gather runs under ``read_with_retry``,
        which names the source ``gather_provenance`` gives."""
        if self._gather_provenance is None and self._gather_faults is None:
            return self._gather_xy_raw(mode, sel, out)
        src = (self._gather_provenance(mode, np.asarray(sel).reshape(-1))
               if self._gather_provenance is not None
               else f"<{mode} window gather>")
        return read_with_retry(
            lambda: self._gather_xy_raw(mode, sel, out), src,
            attempts=self.cfg.io_retries,
            base_delay_s=self.cfg.io_retry_delay_s,
            faults=self._gather_faults)

    def _gather_xy_raw(self, mode: str, sel: np.ndarray, out=None):
        md = self.modes[mode]
        sel = np.asarray(sel)
        # the library reads the series the mode's own views cover; windows
        # put in their place (a poisoned copy) are gathered from themselves
        own = self._series_views[mode]
        if self.host_gather == "native" and md.x is own[0] \
                and md.y is own[1]:
            starts = mode_offset(mode, self.mode_len) + sel.astype(np.int64)
            out = out or (None, None)
            return (host.gather_windows(self._od, starts, self.cfg.obs_len,
                                        out=out[0]),
                    host.gather_windows(self._od, starts + self.cfg.obs_len,
                                        self.cfg.pred_len, out=out[1]))
        if out is None:
            return md.x[sel], md.y[sel]
        for a, o in zip((md.x, md.y), out):
            if isinstance(a, WindowView):
                a.take(sel, out=o)
            else:
                # fancy indexing, then a copy: np.take(..., out=) walks a
                # strided window view element by element
                o[...] = a[sel]
        return out

    # --- chunk-granular staging (the chunked-stream epoch executor) ------

    def epoch_chunks(self, mode: str, idx: np.ndarray, sizes: np.ndarray,
                     steps_per_chunk: int,
                     poison_steps=()) -> Iterator[EpochChunk]:
        """Slice an epoch's (S, B) gather index into chunks of
        ``steps_per_chunk`` steps and gather each chunk's windows on the
        host: into page-locked memory when the pipeline's device is the
        card, so its upload can run on a side stream. ``poison_steps``
        (epoch step indices) NaN a step's x rows at gather time: the
        trainer's ``nan_step`` fault arm on the stream executor."""
        md = self.modes[mode]
        S = idx.shape[0]
        pin = self.device.type == "cuda"
        for s0 in range(0, S, steps_per_chunk):
            s1 = min(S, s0 + steps_per_chunk)
            sel = idx[s0:s1]
            shapes = [sel.shape + a.shape[1:] for a in (md.x, md.y)]
            pinned = (tuple(torch.empty(sh, dtype=torch.float32,
                                        pin_memory=True) for sh in shapes)
                      if pin else ())
            x, y = (t.numpy() for t in pinned) if pin else (
                np.empty(sh, np.float32) for sh in shapes)
            flat = (sel.size,)
            self.gather_xy(mode, sel.reshape(-1),
                           out=(x.reshape(flat + x.shape[2:]),
                                y.reshape(flat + y.shape[2:])))
            for s in poison_steps:
                if s0 <= s < s1:  # the whole step's batch goes NaN
                    x[s - s0] = np.nan
            yield EpochChunk(x=x, y=y, keys=md.keys[sel],
                             sizes=np.asarray(sizes[s0:s1], np.int32),
                             start_step=s0, pinned=pinned)

    def stream_chunks(self, *args, depth: int = 1, **kw):
        """``epoch_chunks`` on a background staging thread: chunk k+1 is
        gathered while the consumer computes chunk k. ``depth`` 1 bounds
        the queue's look-ahead to one chunk, which caps the executor's
        device residency at two chunk buffers (computing and staged)."""
        return self._threaded(self.epoch_chunks(*args, **kw), depth)

    @staticmethod
    def _threaded(gen: Iterator, depth: int) -> Iterator:
        """Run ``gen`` on a background thread behind a bounded queue of
        ``depth``; an error in it is raised on the consumer's side, and a
        consumer that stops early retires the thread."""
        q: queue.Queue = queue.Queue(maxsize=depth)
        stop = threading.Event()
        end = object()

        def put(item) -> bool:
            """A bounded put that gives up when the consumer is gone."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for item in gen:
                    if not put((None, item)):
                        return
                put((None, end))
            except BaseException as e:  # raised again on the consumer side
                put((e, None))

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                err, item = q.get()
                if err is not None:
                    raise err
                if item is end:
                    break
                yield item
        finally:
            # done or abandoned mid-epoch: unblock and retire the producer
            stop.set()
            while not q.empty():
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            t.join(timeout=5)
