"""Training and evaluation of MPGCN (counterpart of the single-device
paths of mpgcn_tpu/train/trainer.py: the epoch-scan executor and the
per-step loop).

``ModelTrainer.train`` runs the reference epoch loop (Model_Trainer.py:
87-142): a per-step update on the masked batch loss (Adam, after the
global-norm clip ``cfg.clip_norm``, at the rate of ``cfg.lr_schedule``
over the run's steps), a validation pass per epoch on the inference
kernels under ``torch.no_grad()``, a checkpoint at epoch 0 and on every
non-worsening validation loss, and early stopping after
``early_stop_patience`` epochs without one; given the ``DataInput`` that
loaded the data (``data_container``), the checkpoint records its
normalizer's kind and state.

Each epoch of a mode runs on one of two executors (``_epoch_exec``, as
the JAX trainer dispatches them, printed on the ``[dispatch]
epoch_exec:`` line). ``scan`` (the default, ``cfg.epoch_scan``, for a
mode whose windows fit ``cfg.epoch_scan_max_mb``) keeps the mode's
windows on the device, gathers each step's rows there from the epoch
index, writes each step's loss into a device buffer and reads the
buffer once at the end of the epoch: one host sync per epoch. On the
card its train step (forward, backward, clip, Adam) and eval step are
each captured once as a CUDA graph (train/graphs.py) after two eager
warm-up steps, which are the epoch's first real steps, and replayed for
every step after; on the CPU and on the ELL arm they run eagerly
(graphs.py ``refusal``). ``per_step`` (``epoch_scan=False``, or a mode
over the budget: the stream executor is not ported) copies each batch
from the host and reads each loss back. Both run the same arithmetic,
so they give the same bits. ``test`` reloads the checkpoint, rolls out
``pred_len`` steps and appends its scores to
``<output_dir>/MPGCN_prediction_scores.txt``, in the model's space or,
with ``denormalize``, in the normalizer's input space. On the card every
step goes through the hand-written kernels (``lstm_impl`` "kernel",
``bdgcn_impl`` "kernel" or "ell"); the plain arms ("plain"/"einsum")
compute the same function with stock PyTorch operations.
``bdgcn_impl="auto"`` (the default) is resolved once by the data pipeline
from the measured support density: "ell" for large sparse graphs, else
"kernel".

Not here yet: step sentinels, the dead-init probe and reseed, resume and
the rolling ``_last`` checkpoint, rollback and the watchdog, gradient
accumulation and multi-step training, bf16 and loss scaling, the stream
executor, remat, and the jsonl logs.
"""

from __future__ import annotations

import os
import time
from datetime import datetime
from typing import Optional

import numpy as np
import torch

from mpgcn_tpu_torch.config import MPGCNConfig
from mpgcn_tpu_torch.data.pipeline import Batch, DataPipeline
from mpgcn_tpu_torch.device import resolve_device
from mpgcn_tpu_torch.nn.mpgcn import MPGCN
from mpgcn_tpu_torch.train import metrics
from mpgcn_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from mpgcn_tpu_torch.train.objectives import elementwise_loss, make_optimizer
from mpgcn_tpu_torch.train.graphs import GraphSet, RolloutGraphs, refusal
from mpgcn_tpu_torch.train.predict import graphs_for, rollout
from mpgcn_tpu_torch.utils.convert import params_from_jax

#: train steps left out of steps/sec (the first ones build the kernels);
#: on the card the scan executor runs as many eager steps of each mode
#: before it captures that mode's step
WARMUP_STEPS = 2


class _Epoch:
    """One mode's state on the scan executor: its device-resident windows
    (xs, ys, keys), the static (S, B) index and (S,) sizes an epoch reads,
    the (S,) step losses it writes, the device step counter ``t`` (the
    buffers a captured step reads and writes), and how many eager
    warm-up steps of the mode have run."""

    def __init__(self, data: tuple, S: int, B: int, device):
        self.xs, self.ys, self.keys = data
        self.idx = torch.zeros((S, B), dtype=torch.long, device=device)
        self.sizes = torch.zeros((S,), dtype=torch.float32, device=device)
        self.losses = torch.zeros((S,), dtype=torch.float32, device=device)
        self.t = torch.zeros((1,), dtype=torch.long, device=device)
        self.warm = 0
        self._host = ()

    def load(self, idx: np.ndarray, sizes: np.ndarray) -> None:
        """Upload an epoch's index and sizes and set t to 0, without a
        host sync: from pinned memory on the card (kept alive here until
        the next epoch, whose start follows this one's read)."""
        host = (torch.from_numpy(idx.astype(np.int64)),
                torch.from_numpy(sizes.astype(np.float32)))
        if self.idx.is_cuda:
            host = tuple(h.pin_memory() for h in host)
        self._host = host
        self.idx.copy_(host[0], non_blocking=True)
        self.sizes.copy_(host[1], non_blocking=True)
        self.t.zero_()

    def gather(self):
        """Step t's batch and size, gathered on the device."""
        rows = self.idx.index_select(0, self.t).view(-1)
        return (self.xs.index_select(0, rows), self.ys.index_select(0, rows),
                self.keys.index_select(0, rows),
                self.sizes.index_select(0, self.t).view(()))

    def record(self, loss: torch.Tensor) -> None:
        """Write step t's loss into its slot and advance t."""
        self.losses.index_copy_(0, self.t, loss.detach().view(1))
        self.t += 1


def epoch_mean(losses: np.ndarray, sizes: np.ndarray) -> float:
    """The size-weighted mean of an epoch's step losses (the JAX trainer's
    ``losses @ sizes`` over ``sizes.sum()``)."""
    return float(losses @ sizes) / max(int(sizes.sum()), 1)


def _banner(msg: str):
    print("\n", datetime.now().strftime("%Y/%m/%d %H:%M:%S"))
    print(msg)


class ModelTrainer:
    """The model, its optimizer and the support banks on ``device``
    (default the card; the CPU only when asked)."""

    def __init__(self, cfg: MPGCNConfig, data: dict, device="cuda",
                 lstm_impl: str = "kernel", bdgcn_impl: str = "auto",
                 data_container=None):
        if cfg.model != "MPGCN":
            raise NotImplementedError("Invalid model name.")
        self.device = resolve_device(device)
        self.pipeline = DataPipeline(cfg, data, self.device, bdgcn_impl)
        if cfg.num_nodes == 0:
            cfg = cfg.replace(num_nodes=self.pipeline.num_nodes)
        self.cfg = cfg
        self.data_container = data_container
        self.banks = self.pipeline.banks
        self.bdgcn_impl = self.pipeline.bdgcn_impl
        self.model = MPGCN.from_config(cfg, device=self.device,
                                       lstm_impl=lstm_impl,
                                       bdgcn_impl=self.bdgcn_impl)
        print(self.pipeline.dispatch_line(lstm_impl))
        self.optimizer = make_optimizer(
            cfg.optimizer, self.model.parameters(), cfg.learn_rate,
            cfg.decay_rate, clip_norm=cfg.clip_norm,
            lr_schedule=cfg.lr_schedule,
            total_steps=self.pipeline.num_batches("train") * cfg.num_epochs)
        self.global_step = 0
        self._clock = None  # (time, step) once the warm-up steps are done
        # the scan executor's per-mode state, and the graphs of this
        # trainer (None where graphs.refusal names a reason)
        self._epochs: dict[str, _Epoch] = {}
        self.graph_refusal = refusal(self.device, self.bdgcn_impl)
        self._graphs = (None if self.graph_refusal else
                        GraphSet(self.device, self.bdgcn_impl))
        self._rollouts = (None if self._graphs is None else
                          RolloutGraphs(self._graphs, self.model, self.banks))
        self._graph_ptrs = self._state_ptrs()

    # --- one step --------------------------------------------------------

    def _tensors(self, batch: Batch):
        return (torch.from_numpy(np.ascontiguousarray(batch.x)).to(
                    self.device),
                torch.from_numpy(np.ascontiguousarray(batch.y)).to(
                    self.device),
                torch.from_numpy(batch.keys.astype(np.int64)).to(
                    self.device))

    def _batch_loss(self, x, y, keys, size,
                    inference: bool = False) -> torch.Tensor:
        """The per-sample f32 mean loss, masked to the first ``size`` rows
        (the rest repeat-pad the batch), summed and divided by ``size``
        (an int, or an f32 device scalar where a replayed step reads it):
        the reference's batch mean when there is no padding."""
        graphs = graphs_for(self.banks, keys, self.model.sources)
        pred = self.model(x, graphs, inference=inference)
        if pred.shape != y.shape:
            raise ValueError(f"prediction shape {tuple(pred.shape)} != "
                             f"target shape {tuple(y.shape)}")
        per_sample = elementwise_loss(self.cfg.loss, pred, y).reshape(
            pred.shape[0], -1).mean(dim=1)
        mask = (torch.arange(pred.shape[0], device=pred.device)
                < size).float()
        return (per_sample * mask).sum() / size

    def _size(self, batch: Batch) -> torch.Tensor:
        """The batch's size as the f32 device scalar the scan executor
        gathers, so both executors divide alike."""
        return torch.tensor(float(batch.size), device=self.device)

    def _start_clock(self) -> None:
        """Start steps/sec when a train step begins after WARMUP_STEPS
        of them, at a synchronised point (the host may run ahead of the
        device)."""
        if self._clock is None and self.global_step >= WARMUP_STEPS:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self._clock = (time.perf_counter(), self.global_step)

    def train_step(self, batch: Batch) -> float:
        """One optimizer update on ``batch`` (the clip, if any, inside
        ``optimizer.step``); returns its loss. The per-step executor."""
        self._start_clock()
        x, y, keys = self._tensors(batch)
        self.optimizer.zero_grad(set_to_none=True)
        loss = self._batch_loss(x, y, keys, self._size(batch))
        loss.backward()
        self.optimizer.step()
        self.global_step += 1
        return float(loss.detach())

    def eval_step(self, batch: Batch) -> float:
        x, y, keys = self._tensors(batch)
        return float(self._batch_loss(x, y, keys, self._size(batch),
                                      inference=True))

    # --- the scan executor -----------------------------------------------

    def _mode_bytes(self, mode: str) -> float:
        """MB of the mode's epoch tensors, x + y + keys, at the padded
        (S*B-row) epoch width (JAX: ``_mode_bytes``)."""
        md = self.pipeline.modes[mode]
        n = max(len(md), 1)
        bs = self.cfg.batch_size
        rows = -(-n // bs) * bs  # repeat-padded final batch included
        per_row = (md.x.nbytes + md.y.nbytes + md.keys.nbytes) / n
        return rows * per_row / 1e6

    def _epoch_exec(self, mode: str) -> str:
        """'scan' when ``cfg.epoch_scan`` is on and the mode fits
        ``cfg.epoch_scan_max_mb``, else 'per_step' (JAX: ``_epoch_exec``
        with ``epoch_stream=False``: the stream executor is not
        ported)."""
        if not self.cfg.epoch_scan:
            return "per_step"
        if self._mode_bytes(mode) <= self.cfg.epoch_scan_max_mb:
            return "scan"
        return "per_step"

    def _exec_line(self, plan: dict) -> str:
        """The ``[dispatch] epoch_exec:`` line, in the JAX format, with
        how the scan executor runs its steps here."""
        desc = ", ".join(f"{m}={e}" for m, e in plan.items())
        line = (f"[dispatch] epoch_exec: {desc} (epoch_scan_max_mb="
                f"{self.cfg.epoch_scan_max_mb})")
        if "scan" in plan.values():
            line += ("; scan steps: CUDA graphs" if self._graphs else
                     f"; scan steps: eager ({self.graph_refusal})")
        if self.cfg.epoch_scan and "per_step" in plan.values():
            line += ("; a mode over the budget runs per step (the stream "
                     "executor is not ported)")
        return line

    def _epoch_index(self, mode: str, shuffle: bool, rng):
        """(S, B) int32 gather indices + (S,) int32 sizes; the final
        batch repeats the epoch's last sample (masked out by size in the
        loss). The permutation ``pipeline.batches`` draws from ``rng``."""
        n = len(self.pipeline.modes[mode])
        bs = self.cfg.batch_size
        order = np.arange(n)
        if shuffle:
            rng.shuffle(order)
        S = -(-n // bs)
        pad = S * bs - n
        idx = np.concatenate(
            [order, np.full(pad, order[-1])]).reshape(S, bs).astype(np.int32)
        sizes = np.full((S,), bs, dtype=np.int32)
        sizes[-1] = n - (S - 1) * bs
        return idx, sizes

    def _mode_device_data(self, mode: str) -> tuple:
        """Device-resident (xs, ys, keys int64) of a mode."""
        md = self.pipeline.modes[mode]
        return tuple(torch.from_numpy(np.array(a)).to(self.device)
                     for a in (md.x, md.y, md.keys.astype(np.int64)))

    def _epoch_state(self, mode: str) -> _Epoch:
        """The mode's executor state, made on first use and cached."""
        if mode not in self._epochs:
            self._epochs[mode] = _Epoch(
                self._mode_device_data(mode), self.pipeline.num_batches(mode),
                self.cfg.batch_size, self.device)
        return self._epochs[mode]

    def _train_body(self, ep: _Epoch) -> None:
        """One train step of the scan executor, all on the device: what
        the train graph captures."""
        x, y, keys, size = ep.gather()
        self.optimizer.zero_grad(set_to_none=True)
        loss = self._batch_loss(x, y, keys, size)
        loss.backward()
        self.optimizer.update()
        ep.record(loss)

    def _eval_body(self, ep: _Epoch) -> None:
        x, y, keys, size = ep.gather()
        ep.record(self._batch_loss(x, y, keys, size, inference=True))

    def _state_ptrs(self) -> tuple:
        """Where the weights, Adam's state and the rate table lie: what
        the captured graphs read and write."""
        opt = self.optimizer
        state = [v for st in opt.state.values() for v in st.values()
                 if torch.is_tensor(v)]
        return tuple(t.data_ptr() for t in (
            *self.model.parameters(), opt.lr_table, opt.lr_t, opt.step_t,
            *state))

    def _check_storage(self) -> None:
        """Drop every captured graph when the weights, Adam's state or the
        rate table moved since the last capture or check: a graph reads
        them where they lay when it was captured. ``load_trained`` copies
        in place and keeps the graphs; a grown rate table or a module
        made anew moves them. Each graph is captured again at its next
        use."""
        ptrs = self._state_ptrs()
        if (self._graphs is not None and self._graphs.graphs
                and ptrs != self._graph_ptrs):
            print("[graphs] the weights, Adam's state or the rate table "
                  "moved: dropping the captured graphs")
            self._graphs.drop()
        self._graph_ptrs = ptrs

    def _exec_step(self, mode: str, ep: _Epoch, is_train: bool) -> None:
        """Run one step of the scan executor: eagerly without graphs; on
        the card the mode's first WARMUP_STEPS steps eagerly on the graph
        set's side stream, then its capture and a replay per step."""
        body = self._train_body if is_train else self._eval_body
        graphs, g = self._graphs, None
        if graphs is not None and graphs.get(mode) is None \
                and ep.warm < WARMUP_STEPS:
            graphs.warmup(lambda: body(ep))
            ep.warm += 1
        else:
            if graphs is not None:
                g = graphs.get(mode)
                if g is None:
                    g = graphs.capture(mode, lambda: body(ep))
                    self._graph_ptrs = self._state_ptrs()
            if is_train:
                self._start_clock()
            if g is None:
                body(ep)
            else:
                g.replay()
        if is_train:
            self.global_step += 1

    def _dispatch_epoch(self, mode: str, shuffle: bool, rng,
                        is_train: bool):
        """Run one epoch of ``mode`` on the scan executor and return its
        (S,) device losses, not read yet, and its host sizes. No host
        sync once the mode's graph is captured."""
        idx, sizes = self._epoch_index(mode, shuffle, rng)
        if is_train:
            self.optimizer.reserve(self.optimizer.count + len(sizes))
        self._check_storage()
        ep = self._epoch_state(mode)
        ep.load(idx, sizes)
        for _ in range(len(sizes)):
            self._exec_step(mode, ep, is_train)
        if is_train:
            self.optimizer.advance(len(sizes))
        return ep.losses, sizes

    # --- the epoch loop --------------------------------------------------

    def _ckpt_path(self) -> str:
        return os.path.join(self.cfg.output_dir, f"{self.cfg.model}_od.pkl")

    def _ckpt_extra(self, **kw) -> dict:
        extra = {"seed": self.cfg.seed,
                 "num_branches": self.cfg.num_branches,
                 "branch_sources": list(self.cfg.resolved_branch_sources),
                 "global_step": self.global_step, **kw}
        if self.data_container is not None:
            norm = self.data_container.normalizer
            extra["normalizer"] = {"kind": norm.kind, "state": norm.state()}
        return extra

    def _run_mode(self, mode: str, rng) -> float:
        """One pass over ``mode`` on the per-step executor: the
        size-weighted mean batch loss."""
        is_train = mode == "train"
        step = self.train_step if is_train else self.eval_step
        losses, sizes = [], []
        for batch in self.pipeline.batches(
                mode, shuffle=self.cfg.shuffle and is_train, rng=rng,
                pad_to_full=True):
            losses.append(step(batch))
            sizes.append(batch.size)
        return epoch_mean(np.array(losses, np.float32),
                          np.array(sizes, np.int32))

    def _run_epoch(self, mode: str, exec_path: str, rng) -> float:
        """One epoch of ``mode`` on ``exec_path``: its mean loss. On the
        scan executor the step losses are read once, here (JAX:
        ``_run_epoch_scan``)."""
        if exec_path == "per_step":
            return self._run_mode(mode, rng)
        is_train = mode == "train"
        losses, sizes = self._dispatch_epoch(
            mode, self.cfg.shuffle and is_train, rng, is_train)
        return epoch_mean(losses.cpu().numpy(), sizes)

    def steps_per_sec(self) -> float:
        """Training steps per second since the warm-up steps (0.0 before
        them)."""
        if self._clock is None:
            return 0.0
        dt = time.perf_counter() - self._clock[0]
        return (self.global_step - self._clock[1]) / dt if dt > 0 else 0.0

    def train(self) -> dict:
        """Epoch loop with validation early stopping after
        ``cfg.early_stop_patience`` epochs without a better validation loss
        (reference: Model_Trainer.py:87-142). Returns the train and
        validate epoch losses."""
        cfg = self.cfg
        modes = ("train", "validate")
        os.makedirs(cfg.output_dir, exist_ok=True)
        best_val, patience_count = np.inf, cfg.early_stop_patience
        history = {m: [] for m in modes}
        rng = np.random.default_rng(cfg.seed)
        self.best_epoch = 0
        plan = {m: self._epoch_exec(m) for m in modes}
        print(self._exec_line(plan))
        save_checkpoint(self._ckpt_path(), self.model, 0,
                        extra=self._ckpt_extra())
        _banner(f"     {cfg.model} model training begins:")
        for epoch in range(1, 1 + cfg.num_epochs):
            for mode in modes:
                history[mode].append(self._run_epoch(mode, plan[mode], rng))
                if mode != "validate":
                    continue
                epoch_val = history[mode][-1]
                if epoch_val <= best_val:
                    print(f"Epoch {epoch}, validation loss drops from "
                          f"{best_val:.5} to {epoch_val:.5}. "
                          f"Update model checkpoint..")
                    best_val, self.best_epoch = epoch_val, epoch
                    save_checkpoint(self._ckpt_path(), self.model, epoch,
                                    extra=self._ckpt_extra(
                                        best_val=best_val))
                    patience_count = cfg.early_stop_patience
                else:
                    print(f"Epoch {epoch}, validation loss does not "
                          f"improve from {best_val:.5}.")
                    patience_count -= 1
                if patience_count <= 0:
                    _banner(f"    Early stopping at epoch {epoch}. "
                            f"{cfg.model} model training ends.")
                    print(f"steps/sec: {self.steps_per_sec():.2f}")
                    return history
        _banner(f"     {cfg.model} model training ends.")
        print(f"steps/sec: {self.steps_per_sec():.2f}")
        return history

    # --- inference -------------------------------------------------------

    def load_trained(self, path: Optional[str] = None) -> dict:
        """Load a JAX-format checkpoint (this trainer's by default) into
        the model; returns its payload."""
        path = path or self._ckpt_path()
        ckpt = load_checkpoint(path, self.cfg.num_branches,
                               self.cfg.resolved_branch_sources)
        self.model.load_state_dict(params_from_jax(ckpt["params"]))
        return ckpt

    def predict(self, x, keys, pred_len: Optional[int] = None) -> np.ndarray:
        """Forecast ``pred_len`` OD frames: x (B, obs_len, N, N, 1) in the
        model's space, keys (B,) day-of-week slots -> (B, pred_len, N, N,
        1). On the card one captured rollout per (B, pred_len) replays
        (the JAX trainer's jitted ``_rollout``); elsewhere ``rollout``
        runs eagerly."""
        pred_len = pred_len or self.cfg.pred_len
        xt = torch.from_numpy(np.array(x, np.float32))
        kt = torch.from_numpy(np.asarray(keys, np.int64))
        if self._rollouts is not None:
            self._check_storage()
            out = self._rollouts.run(xt, kt, pred_len).numpy()
            self._graph_ptrs = self._state_ptrs()
            return out
        return rollout(self.model, self.banks, xt.to(self.device),
                       kt.to(self.device), pred_len).cpu().numpy()

    def test(self, denormalize: bool = False) -> dict:
        """Multi-step autoregressive evaluation of the train and test
        splits + score-file append (reference: Model_Trainer.py:145-185).
        ``denormalize`` scores forecast and truth after the data
        container's ``normalizer.denormalize`` (none without a
        container)."""
        cfg = self.cfg
        self.load_trained()
        results = {}
        for mode in ("train", "test"):
            _banner(f"     {cfg.model} model testing on {mode} data "
                    f"begins:")
            forecasts, truths = [], []
            for batch in self.pipeline.batches(mode, pad_to_full=True):
                pred = self.predict(batch.x, batch.keys, cfg.pred_len)
                forecasts.append(pred[: batch.size])
                truths.append(batch.y[: batch.size])
            forecast = np.concatenate(forecasts, axis=0)
            truth = np.concatenate(truths, axis=0)
            if denormalize and self.data_container is not None:
                norm = self.data_container.normalizer
                forecast = norm.denormalize(forecast)
                truth = norm.denormalize(truth)
            mse, rmse, mae, mape = metrics.evaluate(forecast, truth)
            results[mode] = {"MSE": mse, "RMSE": rmse, "MAE": mae,
                             "MAPE": mape}
            if cfg.pred_len > 1:
                results[mode]["RMSE_by_horizon"] = metrics.per_horizon_rmse(
                    forecast, truth)
            score_path = os.path.join(cfg.output_dir,
                                      f"{cfg.model}_prediction_scores.txt")
            with open(score_path, "a") as f:
                f.write("%s, MSE, RMSE, MAE, MAPE, "
                        "%.10f, %.10f, %.10f, %.10f\n"
                        % (mode, mse, rmse, mae, mape))
        _banner(f"     {cfg.model} model testing ends.")
        return results
