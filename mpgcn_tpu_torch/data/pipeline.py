"""Per-mode datasets and graph support banks (counterpart of the dense
path of mpgcn_tpu/data/pipeline.py).

Windows stay host numpy (zero-copy strided views). The support banks are
computed once, on the serving device: the static stack (K, N, N), the POI
stack (K, N, N) when a branch uses it, and the seven weekly O/D
correlation stacks (7, K, N, N) that a batch gathers by day-of-week key.
``batches`` streams a mode's windows in order (or shuffled), repeat-padding
the last partial batch to full size when asked, as the JAX pipeline does.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np
import torch

from mpgcn_tpu_torch.config import MPGCNConfig
from mpgcn_tpu_torch.data.windows import (
    MODES,
    dow_keys,
    mode_offset,
    sliding_windows,
    split_lengths,
)
from mpgcn_tpu_torch.device import resolve_device
from mpgcn_tpu_torch.graph.kernels import (
    batch_supports,
    compute_supports,
    validate_graph,
)


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


class DataPipeline:
    """Per-mode windows plus the support banks, on ``device``."""

    def __init__(self, cfg: MPGCNConfig, data: dict, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        od = np.ascontiguousarray(np.asarray(data["OD"], dtype=np.float32))
        x, y = sliding_windows(od, cfg.obs_len, cfg.pred_len,
                               cfg.drop_last_window)
        self.mode_len = split_lengths(y.shape[0], cfg.split_ratio)
        empty = [m for m in MODES if self.mode_len[m] <= 0]
        if empty:
            raise ValueError(
                f"split {tuple(cfg.split_ratio)} of {y.shape[0]} windows "
                f"leaves mode(s) {empty} empty; use a longer series or a "
                f"different split_ratio")
        self.modes: dict[str, ModeData] = {}
        for mode in MODES:
            off = mode_offset(mode, self.mode_len)
            n = self.mode_len[mode]
            self.modes[mode] = ModeData(
                x=x[off: off + n], y=y[off: off + n],
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

        self.banks: dict[str, torch.Tensor] = {}
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
            yield Batch(x=md.x[sel], y=md.y[sel], keys=md.keys[sel],
                        size=size)
