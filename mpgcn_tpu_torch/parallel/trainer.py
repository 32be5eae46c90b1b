"""Data- and model-parallel training (counterpart of
mpgcn_tpu/parallel/trainer.py ``ParallelModelTrainer``, BASELINE.json
configs 4 and 5).

The JAX trainer drives every device of a (dp, mp) mesh from one process
and lets GSPMD insert the collectives. The port runs PyTorch's own design
instead, one process per device: every rank of a ``torch.distributed``
group holds a replica of the weights and its optimizer. Rank r sits at
(r // mp, r % mp) (parallel/mesh.py) and trains on its shard of each
global batch: the contiguous block of rows of its data index
(parallel/sharding.py ``batch_shard``) and, on a model axis of mp > 1,
the block of ORIGIN nodes of its model index (``node_shard``: n_loc =
ceil(N / mp) rows, the last block padded with zero rows past N; the
JAX trainer's ``shard_nodes``, on whenever mp > 1). The arithmetic is the
JAX trainer's:

- one starting point: every rank builds the same seeded init, and rank
  0's weights are broadcast once, as DDP does, before the first step;
- the step: each rank sums its rows' masked losses at their GLOBAL batch
  positions against the global ``size`` and divides by it
  (``ModelTrainer._masked_sum_loss``), so a repeat-padded final batch
  masks as it does on one device; under ``grad_accum`` k, chunk j is the
  rank's rows whose global position is j mod k. On a model axis each
  sample's loss is the sum over the rank's REAL origin rows divided by
  the whole window's element count (``_per_sample``): the model group's
  partial losses add up to the sample's mean;
- the model axis inside the forward: the LSTM rows, the head and the
  branch mean are local; each BDGCN layer all-gathers its input over the
  model group and runs the origin contraction for its own rows
  (nn/bdgcn.py), whose backward reduce-scatters the cotangent
  (mpgcn_tpu_torch/node_shard.py). A rank's weight gradients are then partial
  sums over its rows, so
- ``_reduce_step`` all-reduces (SUM) one flat buffer that holds every
  gradient and the loss over the whole world, and copies it back, between
  the backward and ``optimizer.update``: the clip, the step sentinels and
  the loss scaler then judge the same numbers on every rank; eval losses
  are all-reduced the same way, so early stopping and rollback decide
  alike everywhere.

Executors: ModelTrainer's, on the rank's batch columns (``_local_cols``)
and origin block (``_local_windows``). The scan executor keeps the mode's
windows on the device once a run (the rank's origin block of them), and
each step gathers the rank's rows of the step there; the stream executor
stages only the rank's columns, its chunk budget x dp, and cuts each
chunk to the origin block before its upload. On the card an NCCL group's
collectives (the all-reduce, and on a model axis the origin all-gathers
and reduce-scatters) are captured inside the train and eval graphs; where
they cannot be (gloo, whose collectives run on the host, or a failed
trial capture) ``train/graphs.py`` ``refusal`` names the reason and the
steps run eagerly. ``test`` rolls out each rank's shard of every batch
(its autoregression stays on the rank's origin rows) and gathers the
forecasts over the model group, then over the data group; rank 0 writes
the score file, the checkpoints (their manifest records the (dp, mp)
mesh; the weights are whole, so a checkpoint resumes on any (dp, mp)),
the run log and the watchdog's emergency state, and alone prints (the
other ranks' stdout goes to /dev/null while they train and test). The
"checkpoint exists" answer is rank 0's; every rank votes on preemption
each epoch (an all-reduce MAX: the JAX vote without its straggler half).

BDGCN arms on a model axis follow the JAX routing
(mpgcn_tpu/parallel/trainer.py:327-337): 'auto' that resolves to 'ell'
runs 'csr', and a forced 'ell' is refused with the JAX message.

Departures from the JAX trainer: one process per device, not one process
over a mesh; the weights stay whole on every rank (the JAX
``param_shardings`` shards their hidden dimension over "model"); a rank's
scan executor holds the whole mode's rows (its origin block), not 1/dp of
the stacked epoch, so the scan-or-stream choice weighs the whole mode's
bytes against ``epoch_scan_max_mb`` (the JAX ``_mode_device_mb`` divides
them by dp); the port's kernels take any row count, so none of the JAX
mesh rewrites for the Pallas wrappers' divisibility applies (the LSTM
rows, ``pallas`` -> ``folded``): every rank keeps the port's own
``lstm_impl`` / ``bdgcn_impl`` resolution but for 'ell' at mp > 1.
``-shard-branches`` and ``-bexec stacked`` wait for ROADMAP.md Queue 1
item 1(b), part two.
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
from mpgcn_tpu_torch.data.pipeline import Batch, DataPipeline, EpochChunk
from mpgcn_tpu_torch.node_shard import all_gather_blocks
from mpgcn_tpu_torch.parallel.distributed import initialize
from mpgcn_tpu_torch.parallel.mesh import AXIS_DATA, Mesh, make_mesh
from mpgcn_tpu_torch.parallel.sharding import (
    batch_shard,
    node_shard,
    shard_nodes,
)
from mpgcn_tpu_torch.train.checkpoint import topology_manifest
from mpgcn_tpu_torch.train.trainer import ModelTrainer


class ParallelModelTrainer(ModelTrainer):
    """``ModelTrainer`` on one rank of a (dp, mp) world. ``mesh`` (default
    ``make_mesh(num_devices, model_parallel, device=device)`` over the
    process group, which ``initialize(backend=backend)`` joins first where
    the environment names a world) gives the rank, the world, the grid,
    the subgroups and the device."""

    def __init__(self, cfg: MPGCNConfig, data: dict, device="cuda",
                 lstm_impl: str = "kernel", bdgcn_impl: str = "auto",
                 data_container=None,
                 pipeline: Optional[DataPipeline] = None,
                 num_devices: Optional[int] = None,
                 model_parallel: int = 1,
                 mesh: Optional[Mesh] = None,
                 backend: Optional[str] = None):
        if mesh is None:
            initialize(backend=backend)
            dev = torch.device(device)
            if dev.type == "cuda" and dev.index is None:
                dev = None  # the card of this process's local rank
            mesh = make_mesh(num_devices, model_parallel, device=dev)
        self.mesh = mesh
        dp = mesh.shape[AXIS_DATA]
        #: are the windows' origin nodes sharded over "model"?
        self.shard_nodes = shard_nodes(mesh)
        if self.shard_nodes and "ell" in (
                bdgcn_impl, getattr(pipeline, "bdgcn_impl", None)):
            # JAX ``_bdgcn_impl``: a forced 'ell' is refused, and 'auto'
            # runs 'csr' where it would resolve to 'ell' (the pipeline's
            # ``node_sharded``)
            raise ValueError(
                f"bdgcn_impl='ell' on a {mesh.world}-device mesh: the "
                f"Pallas blocked-ELL kernel has no GSPMD partitioning rule; "
                f"use bdgcn_impl='csr' (same sparse algebra) or a single "
                f"device")
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
        self.model_group = mesh.model_group if self.shard_nodes else None
        self._comm_device = (mesh.device if self.process_group is not None
                             and dist.get_backend() == "nccl"
                             else torch.device("cpu"))
        if self.shard_nodes and pipeline is None:
            pipeline = DataPipeline(cfg, data, mesh.device, bdgcn_impl,
                                    node_sharded=True)
        with self._quiet():
            super().__init__(cfg, data, device=mesh.device,
                             lstm_impl=lstm_impl, bdgcn_impl=bdgcn_impl,
                             data_container=data_container,
                             pipeline=pipeline)
        #: this rank's origin block (None without a model axis)
        self._nodes = (node_shard(mesh, self.cfg.num_nodes)
                       if self.shard_nodes else None)
        self.model.shard = self._nodes
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

    # --- the batch shard and the origin block -----------------------------

    def _local_windows(self, a: np.ndarray, axis: int = 2) -> np.ndarray:
        """``a``'s windows cut to this rank's origin block."""
        if self._nodes is None:
            return a
        return np.ascontiguousarray(self._nodes.take(a, axis))

    def _tensors(self, batch: Batch):
        r = self._rows
        return super()._tensors(dataclasses.replace(
            batch, x=self._local_windows(batch.x[r]),
            y=self._local_windows(batch.y[r]), keys=batch.keys[r]))

    def _place_chunk(self, chunk) -> tuple:
        if self._nodes is not None:
            # the chunk's (steps, B, T, N, N, F) windows cut to the origin
            # block before the upload (pinned again for the card)
            x, y = (self._local_windows(a, 3) for a in (chunk.x, chunk.y))
            pinned = (tuple(torch.from_numpy(a).pin_memory() for a in (x, y))
                      if chunk.pinned else ())
            if pinned:
                x, y = (t.numpy() for t in pinned)
            chunk = EpochChunk(x=x, y=y, keys=chunk.keys, sizes=chunk.sizes,
                               start_step=chunk.start_step, pinned=pinned)
        return super()._place_chunk(chunk)

    def _per_sample(self, elems: torch.Tensor) -> torch.Tensor:
        """On a model axis: each sample's loss over this rank's real origin
        rows (axis 2) over the whole window's element count, so the model
        group's partial losses sum to the sample's mean."""
        if self._nodes is None:
            return super()._per_sample(elems)
        B, T, M, N = elems.shape[:4]
        mask = self._nodes.mask(elems.device).view(1, 1, M, 1, 1)
        count = T * self.cfg.num_nodes * N * elems[0, 0, 0, 0].numel()
        return (elems * mask).reshape(B, -1).sum(dim=1) / count

    def _real_origins(self, pred: torch.Tensor) -> torch.Tensor:
        """This rank's real origin rows: a padded row's forecast comes from
        the biases alone, so it is not the model's output."""
        if self._nodes is None:
            return pred
        return pred[:, :, :self._nodes.real]

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
        """The rank's shard of the batch rolled out (its rows, and on a
        model axis its origin block, which the autoregression keeps), the
        forecasts gathered over the model group (origin blocks, trimmed to
        N), then over the data group (rows), in rank order."""
        r = self._rows
        local = self.predict(self._local_windows(batch.x[r]), batch.keys[r],
                             self.cfg.pred_len)
        if self.process_group is None:
            return local
        t = torch.from_numpy(np.ascontiguousarray(local)).to(self.device)
        if self._nodes is not None and self.mesh.model_group is not None:
            t = all_gather_blocks(t.movedim(2, 0).contiguous(),
                                  self.mesh.model_group, self._nodes.mp)
            t = t[:self.cfg.num_nodes].movedim(0, 2)
        dp = self.mesh.shape[AXIS_DATA]
        if dp > 1:
            t = all_gather_blocks(t, self.mesh.data_group, dp)
        return t.cpu().numpy()
