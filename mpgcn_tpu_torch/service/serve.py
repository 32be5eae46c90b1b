"""The serving engine (counterpart of the request path of
mpgcn_tpu/service/serve.py:130-705).

``ServeEngine.submit`` is the seam a front end calls: every request passes
the admission gate (service/ingest.py), joins a micro-batcher queue per
forecast horizon (service/batcher.py), and is answered by a
``horizon``-step autoregressive rollout of MPGCN over its padded bucket,
through the hand-written kernels when the engine runs on the card.
The support banks are put on the device once at startup, dense or, for
large sparse graphs (``bdgcn_impl`` 'auto' or 'ell'), as blocked-ELL
containers; ``stats()["support"]`` reports their resident bytes.

The JAX engine's AOT compile per bucket has no counterpart: PyTorch runs
eagerly. Each (bucket, horizon) pair is run once at startup instead, which
builds the kernels and warms the allocator before the first request.
Canary hot reload, the HTTP front, the SLO engine and span logs are not
part of this engine yet.
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import torch

from mpgcn_tpu_torch.config import MPGCNConfig, ServeConfig
from mpgcn_tpu_torch.data.pipeline import DataPipeline
from mpgcn_tpu_torch.device import resolve_device
from mpgcn_tpu_torch.nn.cuda_bdgcn import BDGCN_PAIR_FWD
from mpgcn_tpu_torch.nn.cuda_lstm import LSTM_INFER_COLLECT, LSTM_INFER_LAST
from mpgcn_tpu_torch.nn.mpgcn import MPGCN
from mpgcn_tpu_torch.service.batcher import (
    OK,
    REJECT_DRAINING,
    REJECT_INVALID,
    MicroBatcher,
    Ticket,
)
from mpgcn_tpu_torch.service.ingest import validate_request
from mpgcn_tpu_torch.sparse.cuda_ell import ELL_FWD, ELL_FWD_Q
from mpgcn_tpu_torch.train.predict import rollout
from mpgcn_tpu_torch.utils.convert import load_jax_checkpoint, params_from_jax

#: the kernels on the serve path, by the name the stats report
KERNELS = {"lstm_infer_last": LSTM_INFER_LAST,
           "lstm_infer_collect": LSTM_INFER_COLLECT,
           "bdgcn_pair_fwd": BDGCN_PAIR_FWD,
           "ell_fwd": ELL_FWD,
           "ell_fwd_q": ELL_FWD_Q}


class ServeEngine:
    """Micro-batchers + the model on ``device`` + its support banks.

    Params come from ``init_ckpt`` (a JAX pickle checkpoint, converted by
    utils/convert.py), else -- only with ``allow_fresh`` -- from a fresh
    init seeded by ``cfg.seed``. ``bdgcn_impl`` picks the BDGCN arm as for
    ``ModelTrainer`` ('auto' resolves by the banks' density)."""

    def __init__(self, cfg: MPGCNConfig, data: dict, scfg: ServeConfig,
                 device="cuda", init_ckpt: Optional[str] = None,
                 allow_fresh: bool = False, bdgcn_impl: str = "auto"):
        self.device = resolve_device(device)
        self.scfg = scfg
        pipeline = DataPipeline(cfg, data, self.device, bdgcn_impl)
        self.cfg = cfg = cfg.replace(num_nodes=pipeline.num_nodes)
        self.pipeline = pipeline
        self.banks = pipeline.banks
        self.horizons = tuple(scfg.horizons) or (cfg.pred_len,)
        self._default_horizon = (cfg.pred_len if cfg.pred_len in
                                 self.horizons else self.horizons[-1])

        self.model = MPGCN.from_config(
            cfg, device=self.device,
            bdgcn_impl=pipeline.bdgcn_impl).eval()
        print(pipeline.dispatch_line(self.model.lstm_impl))
        if init_ckpt is not None:
            params = load_jax_checkpoint(
                init_ckpt, num_branches=cfg.num_branches,
                branch_sources=cfg.resolved_branch_sources)
            self.model.load_state_dict(params_from_jax(params))
            self.params_source = init_ckpt
        elif allow_fresh:
            self.params_source = f"fresh init (seed {cfg.seed})"
        else:
            raise FileNotFoundError(
                "no checkpoint to serve: pass init_ckpt, or "
                "allow_fresh=True for a fresh seeded init")

        # per-bucket pad-waste accounting: {bucket: [live, padded, batches]}
        self._pad_stats: dict[int, list] = {}
        self._outcomes: dict[str, int] = {}
        self._lat_ms: list[float] = []
        self._stats_lock = threading.Lock()
        self._draining = False
        self._warmup()
        self.batchers = {
            h: MicroBatcher(self._make_run_batch(h), scfg.buckets,
                            scfg.max_queue, scfg.max_wait_ms)
            for h in self.horizons}
        for b in self.batchers.values():
            b.start()

    def _warmup(self) -> None:
        """Run every (bucket, horizon) once: builds the kernels and warms
        the caching allocator before the first request."""
        N, T = self.cfg.num_nodes, self.cfg.obs_len
        for b in self.scfg.buckets:
            x = torch.zeros((b, T, N, N, 1), device=self.device)
            k = torch.zeros((b,), dtype=torch.long, device=self.device)
            for h in self.horizons:
                rollout(self.model, self.banks, x, k, h)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _make_run_batch(self, horizon: int):
        def run_batch(x, keys, bucket: int, n_live: int):
            with self._stats_lock:
                st = self._pad_stats.setdefault(bucket, [0, 0, 0])
                st[0] += n_live
                st[1] += bucket
                st[2] += 1
            xt = torch.from_numpy(x).to(self.device)
            kt = torch.from_numpy(keys.astype(np.int64)).to(self.device)
            return rollout(self.model, self.banks, xt, kt,
                           horizon).cpu().numpy()

        return run_batch

    def _note(self, t: Ticket) -> None:
        with self._stats_lock:
            self._outcomes[t.outcome] = self._outcomes.get(t.outcome, 0) + 1
            if t.outcome == OK:
                self._lat_ms.append(t.latency_ms)
                del self._lat_ms[:-2048]

    def submit(self, x, key, deadline_ms: Optional[float] = None,
               horizon: Optional[int] = None) -> Ticket:
        """Admit one forecast request; always returns a ticket that will
        resolve (answered, shed or rejected). ``x`` is an (obs_len, N,
        N[, 1]) observation window, ``key`` its day-of-week slot, and
        ``horizon`` one of the served horizons (None = the default)."""
        dl = self.scfg.deadline_ms if deadline_ms is None else deadline_ms
        t = Ticket(x, key if isinstance(key, int) else 0,
                   deadline_s=dl / 1e3 if dl else None, on_resolve=self._note)
        h = self._default_horizon if horizon is None else horizon
        if h not in self.batchers:
            t.resolve(REJECT_INVALID,
                      error=f"horizon {horizon!r} is not served (served "
                            f"horizons: {list(self.horizons)})")
            return t
        if self._draining:
            t.resolve(REJECT_DRAINING, error="server draining")
            return t
        verdict = validate_request(x, key, self.cfg.obs_len,
                                   self.cfg.num_nodes)
        if not verdict["ok"]:
            t.resolve(REJECT_INVALID, error=verdict["reason"])
            return t
        with np.errstate(over="ignore"):  # overflow is rejected just below
            arr = np.asarray(x, np.float32)
        if not np.all(np.isfinite(arr)):
            t.resolve(REJECT_INVALID, error="values overflow float32 "
                                            "(non-finite after cast)")
            return t
        t.x = arr[..., None] if arr.ndim == 3 else arr
        t.key = int(key)
        return self.batchers[h].submit(t)

    def drain(self, timeout: Optional[float] = 30.0) -> bool:
        """Reject new work, answer everything queued, retire the workers."""
        self._draining = True
        ok = True
        for b in self.batchers.values():
            ok = b.drain(timeout=timeout) and ok
        return ok

    def close(self) -> None:
        for b in self.batchers.values():
            b.stop()

    def stats(self) -> dict:
        """Outcomes, latency, per-bucket dispatches and pad waste, the
        support banks' resident bytes, and the kernels' launch counts
        (counted since they were last set to 0)."""
        with self._stats_lock:
            per = {b: list(st) for b, st in self._pad_stats.items()}
            outcomes = dict(self._outcomes)
            lats = sorted(self._lat_ms)
        live = sum(st[0] for st in per.values())
        padded = sum(st[1] for st in per.values())
        out = {
            "device": str(self.device),
            "params": self.params_source,
            "outcomes": outcomes,
            "resolved": sum(outcomes.values()),
            "horizons": list(self.horizons),
            "pad_waste": {
                "ratio": (padded - live) / padded if padded else 0.0,
                "live": live, "padded": padded,
                "by_bucket": {str(b): {"live": st[0], "padded": st[1],
                                       "dispatches": st[2]}
                              for b, st in sorted(per.items())},
            },
            "support": self.pipeline.support_stats(),
            "kernel_launches": {name: k.launches
                                for name, k in KERNELS.items()},
        }
        if lats:
            out["latency_ms"] = {
                "p50": lats[len(lats) // 2],
                "p99": lats[min(len(lats) - 1, int(len(lats) * 0.99))],
                "n": len(lats)}
        return out
