"""Data-parallel training (counterpart of mpgcn_tpu/parallel/trainer.py
``ParallelModelTrainer``, the data axis of BASELINE.json config 4).

The JAX trainer drives every device of a mesh from one process and lets
GSPMD insert the gradient all-reduce. The port runs PyTorch's own design
instead, one process per device: every rank of a ``torch.distributed``
group holds a replica of the model and its optimizer and trains on its
shard of each global batch (parallel/sharding.py ``batch_shard``: the
contiguous block of rows a 1-D sharding over "data" gives it), with one
all-reduce of the gradients a step. The arithmetic is the JAX trainer's:

- one starting point: every rank builds the same seeded init, and rank
  0's weights are broadcast once, as DDP does, before the first step;
- the step: each rank sums its rows' masked losses at their GLOBAL batch
  positions against the global ``size`` and divides by it
  (``ModelTrainer._masked_sum_loss``), so a repeat-padded final batch
  masks as it does on one device; under ``grad_accum`` k, chunk j is the
  rank's rows whose global position is j mod k;
- ``_reduce_step`` all-reduces (SUM) one flat buffer that holds every
  gradient and the loss, and copies it back, between the backward and
  ``optimizer.update``: the clip, the step sentinels and the loss scaler
  then judge the same numbers on every rank; eval losses are all-reduced
  the same way, so early stopping and rollback decide alike everywhere.

Executors: ModelTrainer's, on the rank's batch columns (``_local_cols``).
The scan executor keeps the whole mode on the device once a run, as on
one device, and each step gathers the rank's rows of the step there; the
stream executor stages only the rank's columns, its chunk budget x dp. On the
card an NCCL group's all-reduce is captured inside the train graph; where
it cannot be (gloo, whose collectives run on the host, or a failed trial
capture) ``train/graphs.py`` ``refusal`` names the reason and the steps
run eagerly. ``test`` rolls out each rank's shard of every batch and
gathers the forecasts; rank 0 writes the score file, the checkpoints, the
run log and the watchdog's emergency state, and alone prints (the other
ranks' stdout goes to /dev/null while they train and test). The
"checkpoint exists" answer is rank 0's; every rank votes on preemption
each epoch (an all-reduce MAX: the JAX vote without its straggler half).

Departures from the JAX trainer: one process per device, not one process
over a mesh; a rank's scan executor holds the whole mode, not 1/dp of
the stacked epoch, so the scan-or-stream choice weighs the whole mode's
bytes against ``epoch_scan_max_mb`` (the JAX ``_mode_device_mb`` divides
them by dp); each rank runs the whole model on its shard, so none of the
JAX mesh rewrites applies (``ell`` -> ``csr``, the LSTM rows' divisibility
by the mesh, ``pallas`` -> ``folded``): every rank keeps the port's own
``bdgcn_impl`` / ``lstm_impl`` resolution. The model axis
(``model_parallel`` > 1, ``-shard-branches``, ``-bexec``) waits for
ROADMAP.md Queue 1 item 1(b).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from mpgcn_tpu_torch.config import MPGCNConfig
from mpgcn_tpu_torch.data.pipeline import Batch, DataPipeline
from mpgcn_tpu_torch.parallel.distributed import initialize
from mpgcn_tpu_torch.parallel.mesh import AXIS_DATA, Mesh, make_mesh
from mpgcn_tpu_torch.parallel.sharding import batch_shard
from mpgcn_tpu_torch.train.checkpoint import topology_manifest
from mpgcn_tpu_torch.train.trainer import ModelTrainer


class ParallelModelTrainer(ModelTrainer):
    """``ModelTrainer`` on one rank of a data-parallel world. ``mesh``
    (default ``make_mesh(num_devices, device=device)`` over the process
    group, which ``initialize(backend=backend)`` joins first where the
    environment names a world) gives the rank, the world and the device."""

    def __init__(self, cfg: MPGCNConfig, data: dict, device="cuda",
                 lstm_impl: str = "kernel", bdgcn_impl: str = "auto",
                 data_container=None,
                 pipeline: Optional[DataPipeline] = None,
                 num_devices: Optional[int] = None,
                 mesh: Optional[Mesh] = None,
                 backend: Optional[str] = None):
        if mesh is None:
            initialize(backend=backend)
            dev = torch.device(device)
            if dev.type == "cuda" and dev.index is None:
                dev = None  # the card of this process's local rank
            mesh = make_mesh(num_devices, device=dev)
        self.mesh = mesh
        dp = mesh.shape[AXIS_DATA]
        if cfg.batch_size % dp:
            raise ValueError(
                f"batch_size {cfg.batch_size} must be divisible by the "
                f"data-parallel axis ({dp} devices); pad_to_full batches keep "
                f"a fixed global shape")
        if cfg.grad_accum > 1 and (cfg.batch_size // cfg.grad_accum) % dp:
            raise ValueError(
                f"grad_accum {cfg.grad_accum} makes microbatches of "
                f"{cfg.batch_size // cfg.grad_accum} which are not divisible "
                f"by the data-parallel axis ({dp} devices); pick grad_accum "
                f"so batch_size/grad_accum stays a multiple of {dp}")
        self.rank = mesh.rank
        self._rows = batch_shard(mesh, cfg.batch_size)
        self._row0 = self._rows.start
        self.process_group = (dist.group.WORLD if dist.is_initialized()
                              else None)
        self._comm_device = (mesh.device if self.process_group is not None
                             and dist.get_backend() == "nccl"
                             else torch.device("cpu"))
        with self._quiet():
            super().__init__(cfg, data, device=mesh.device,
                             lstm_impl=lstm_impl, bdgcn_impl=bdgcn_impl,
                             data_container=data_container,
                             pipeline=pipeline)
        self._broadcast_params()

    # --- the process group ------------------------------------------------

    @contextlib.contextmanager
    def _quiet(self):
        """Rank 0 alone prints: the others' stdout goes to /dev/null."""
        if self._is_writer:
            yield
            return
        with open(os.devnull, "w") as null, contextlib.redirect_stdout(null):
            yield

    def _all_reduce(self, t: torch.Tensor, op=dist.ReduceOp.SUM):
        """``t`` reduced over the ranks, on the trainer's device (through
        the host for gloo)."""
        buf = t.to(self._comm_device)
        dist.all_reduce(buf, op=op, group=self.process_group)
        return buf.to(self.device)

    def _reduce_int(self, value: int, op) -> int:
        if self.process_group is None:
            return value
        return int(self._all_reduce(
            torch.tensor([value], device=self._comm_device), op))

    @torch.no_grad()
    def _broadcast_params(self) -> None:
        """Rank 0's weights to every rank, in place (one flat buffer)."""
        if self.process_group is None:
            return
        params = [p.detach() for p in self.model.parameters()]
        flat = torch.cat([p.reshape(-1) for p in params]).to(
            self._comm_device)
        dist.broadcast(flat, src=0, group=self.process_group)
        flat = flat.to(self.device)
        torch._foreach_copy_(params, [v.view_as(p) for v, p in zip(
            flat.split([p.numel() for p in params]), params)])

    def _reduce_step(self, loss: torch.Tensor,
                     grads: bool = True) -> torch.Tensor:
        """One all-reduce (SUM) of a flat buffer of every gradient and the
        loss, copied back: the global batch's gradient and loss."""
        if self.process_group is None:
            return loss
        bufs = ([p.grad for p in self.optimizer.all_params()
                 if p.grad is not None] if grads else [])
        flat = self._all_reduce(torch.cat(
            [g.reshape(-1) for g in bufs] + [loss.detach().reshape(1)]))
        if bufs:
            parts = flat[:-1].split([g.numel() for g in bufs])
            torch._foreach_copy_(bufs, [v.view_as(g)
                                        for v, g in zip(parts, bufs)])
        return flat[-1].view_as(loss)

    def _agree(self, flag: bool) -> bool:
        return bool(self._reduce_int(int(flag), dist.ReduceOp.MIN))

    def _vote_preempted(self) -> bool:
        return bool(self._reduce_int(int(self._preempted),
                                     dist.ReduceOp.MAX))

    def _ckpt_exists(self, path: str) -> bool:
        mine = super()._ckpt_exists(path) if self._is_writer else False
        return bool(self._reduce_int(int(mine), dist.ReduceOp.MAX))

    def _files_settled(self) -> None:
        super()._files_settled()
        self._reduce_int(0, dist.ReduceOp.SUM)  # a barrier

    def _manifest(self) -> dict:
        return topology_manifest(self._platform, self.mesh.world,
                                 dict(self.mesh.shape))

    # --- the batch shard --------------------------------------------------

    def _tensors(self, batch: Batch):
        r = self._rows
        return super()._tensors(dataclasses.replace(
            batch, x=batch.x[r], y=batch.y[r], keys=batch.keys[r]))

    def _local_cols(self, idx: np.ndarray) -> np.ndarray:
        return idx[:, self._rows]

    def _chunk_budget_mb(self) -> float:
        # a per-device budget: the global chunk scales by dp
        return super()._chunk_budget_mb() * self.mesh.shape[AXIS_DATA]

    # --- rank 0 alone prints ----------------------------------------------

    def train(self, resume: bool = False) -> dict:
        with self._quiet():
            return super().train(resume)

    def test(self, denormalize: bool = False) -> dict:
        with self._quiet():
            return super().test(denormalize)

    def _rollout_batch(self, batch: Batch) -> np.ndarray:
        """The rank's rows of the batch rolled out, the forecasts of every
        rank gathered in rank order."""
        r = self._rows
        local = self.predict(batch.x[r], batch.keys[r], self.cfg.pred_len)
        if self.process_group is None:
            return local
        t = torch.from_numpy(np.ascontiguousarray(local)).to(
            self._comm_device)
        out = [torch.empty_like(t) for _ in range(self.mesh.world)]
        dist.all_gather(out, t, group=self.process_group)
        return torch.cat(out).cpu().numpy()
