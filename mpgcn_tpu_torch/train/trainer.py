"""Training and evaluation of MPGCN (counterpart of the single-device,
per-step path of mpgcn_tpu/train/trainer.py).

``ModelTrainer.train`` runs the reference epoch loop (Model_Trainer.py:
87-142): a per-step Adam update on the masked batch loss, a validation
pass per epoch on the inference kernels under ``torch.no_grad()``, a
checkpoint at epoch 0 and on every non-worsening validation loss, and early
stopping after ``early_stop_patience`` epochs without one. ``test`` reloads
the checkpoint, rolls out ``pred_len`` steps and appends its scores to
``<output_dir>/MPGCN_prediction_scores.txt``. On the card every step goes
through the hand-written kernels (``lstm_impl`` "kernel", ``bdgcn_impl``
"kernel" or "ell"); the plain arms ("plain"/"einsum") compute the same
function with stock PyTorch operations. ``bdgcn_impl="auto"`` (the
default) is resolved once by the data pipeline from the measured support
density: "ell" for large sparse graphs, else "kernel".

Not here yet: step sentinels, the dead-init probe and reseed, resume and
the rolling ``_last`` checkpoint, rollback and the watchdog, gradient
accumulation and multi-step training, clipping and LR schedules, bf16 and
loss scaling, the epoch-scan and stream executors, remat, and the jsonl
logs.
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
from mpgcn_tpu_torch.train.predict import graphs_for, rollout
from mpgcn_tpu_torch.utils.convert import params_from_jax

#: train steps left out of steps/sec (the first ones build the kernels)
WARMUP_STEPS = 2


def _banner(msg: str):
    print("\n", datetime.now().strftime("%Y/%m/%d %H:%M:%S"))
    print(msg)


class ModelTrainer:
    """The model, its optimizer and the support banks on ``device``
    (default the card; the CPU only when asked)."""

    def __init__(self, cfg: MPGCNConfig, data: dict, device="cuda",
                 lstm_impl: str = "kernel", bdgcn_impl: str = "auto"):
        if cfg.model != "MPGCN":
            raise NotImplementedError("Invalid model name.")
        self.device = resolve_device(device)
        self.pipeline = DataPipeline(cfg, data, self.device, bdgcn_impl)
        if cfg.num_nodes == 0:
            cfg = cfg.replace(num_nodes=self.pipeline.num_nodes)
        self.cfg = cfg
        self.banks = self.pipeline.banks
        self.bdgcn_impl = self.pipeline.bdgcn_impl
        self.model = MPGCN.from_config(cfg, device=self.device,
                                       lstm_impl=lstm_impl,
                                       bdgcn_impl=self.bdgcn_impl)
        print(self.pipeline.dispatch_line(lstm_impl))
        self.optimizer = make_optimizer(cfg.optimizer,
                                        self.model.parameters(),
                                        cfg.learn_rate, cfg.decay_rate)
        self.global_step = 0
        self._clock = None  # (time, step) once the warm-up steps are done

    # --- one step --------------------------------------------------------

    def _tensors(self, batch: Batch):
        return (torch.from_numpy(np.ascontiguousarray(batch.x)).to(
                    self.device),
                torch.from_numpy(np.ascontiguousarray(batch.y)).to(
                    self.device),
                torch.from_numpy(batch.keys.astype(np.int64)).to(
                    self.device))

    def _batch_loss(self, x, y, keys, size: int,
                    inference: bool = False) -> torch.Tensor:
        """The per-sample f32 mean loss, masked to the first ``size`` rows
        (the rest repeat-pad the batch), summed and divided by ``size``:
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

    def train_step(self, batch: Batch) -> float:
        """One Adam update on ``batch``; returns its loss."""
        x, y, keys = self._tensors(batch)
        self.optimizer.zero_grad(set_to_none=True)
        loss = self._batch_loss(x, y, keys, batch.size)
        loss.backward()
        self.optimizer.step()
        self.global_step += 1
        if self.global_step == WARMUP_STEPS:
            self._clock = (time.perf_counter(), self.global_step)
        return float(loss.detach())

    def eval_step(self, batch: Batch) -> float:
        x, y, keys = self._tensors(batch)
        return float(self._batch_loss(x, y, keys, batch.size,
                                      inference=True))

    # --- the epoch loop --------------------------------------------------

    def _ckpt_path(self) -> str:
        return os.path.join(self.cfg.output_dir, f"{self.cfg.model}_od.pkl")

    def _ckpt_extra(self, **kw) -> dict:
        return {"seed": self.cfg.seed,
                "num_branches": self.cfg.num_branches,
                "branch_sources": list(self.cfg.resolved_branch_sources),
                "global_step": self.global_step, **kw}

    def _run_mode(self, mode: str, rng) -> float:
        """One pass over ``mode``: the size-weighted mean batch loss."""
        is_train = mode == "train"
        step = self.train_step if is_train else self.eval_step
        running, count = 0.0, 0
        for batch in self.pipeline.batches(
                mode, shuffle=self.cfg.shuffle and is_train, rng=rng,
                pad_to_full=True):
            running += step(batch) * batch.size
            count += batch.size
        return running / max(count, 1)

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
        save_checkpoint(self._ckpt_path(), self.model, 0,
                        extra=self._ckpt_extra())
        _banner(f"     {cfg.model} model training begins:")
        for epoch in range(1, 1 + cfg.num_epochs):
            for mode in modes:
                history[mode].append(self._run_mode(mode, rng))
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
        1)."""
        pred_len = pred_len or self.cfg.pred_len
        xt = torch.from_numpy(np.array(x, np.float32)).to(self.device)
        kt = torch.from_numpy(np.asarray(keys, np.int64)).to(self.device)
        return rollout(self.model, self.banks, xt, kt,
                       pred_len).cpu().numpy()

    def test(self) -> dict:
        """Multi-step autoregressive evaluation of the train and test
        splits + score-file append (reference: Model_Trainer.py:145-185)."""
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
