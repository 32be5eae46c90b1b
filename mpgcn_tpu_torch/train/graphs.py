"""CUDA graphs of the port's steps: the counterpart of the JAX package's
``jax.jit`` and ``.lower().compile()`` call sites (the trainer's
``_build_steps``, mpgcn_tpu/train/trainer.py:1104-1150, and the serve
engine's executable per (bucket, horizon), mpgcn_tpu/service/serve.py:
402-418). Where JAX compiles a step once and dispatches the executable,
the port records the step's launches once and replays them: one host
call a step instead of a few hundred.

A ``GraphSet`` holds the graphs of one trainer or one serve engine: one
memory pool they share, one lock that every replay takes (graphs that
share a pool must never run at once: one may reuse memory another
freed), and the side stream their warm-up runs on (one a device for
every set, ``side_stream``). A callable is
captured after it has run eagerly (``warmup``), which builds the
kernels and makes every state that is made lazily: Adam's moments, the
autograd buffers, cuBLAS's workspace, the kernels' occupancy queries.
Its inputs are static buffers that the caller fills before each replay;
its outputs are static tensors of the pool, which the caller copies out
before another graph of the set runs. Per-call scratch (the LSTM and
K-BDGCN wrappers' ``torch.empty``) comes from the pool, and the engine
BPTT's ``cudaMemsetAsync`` becomes a memset node. The graphs read the
weights where they lie: loading a checkpoint in place (``load_state_dict``)
keeps them valid; where a parameter's storage moves they are dropped
(``ModelTrainer._check_storage``).

Every capture counts into the default metrics registry's
``cuda_program_builds`` (obs/metrics.py), the port's counterpart of the
JAX package's compile counter.

``refusal`` names what cannot be captured: the CPU (nothing to capture),
the blocked-ELL arm, whose forward and dX mark Inf and NaN with a
generation the host counts per call (sparse/cuda_ell.py ``_marks``), so
a replay would reuse the captured one, and a data-parallel step whose
gradient all-reduce (or, on a model axis, its layers' origin all-gather
and reduce-scatter) cannot go into the graph: gloo's collectives run on
the host, and NCCL collectives that fail a trial capture are named with
their error. Callers print that decision; ``GraphSet`` raises on either. A
capture or a replay that fails raises: nothing falls back to eager
execution.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

import torch

from mpgcn_tpu_torch.native.build import add_replayed, capture_launches
from mpgcn_tpu_torch.node_shard import all_gather_blocks, reduce_scatter_blocks
from mpgcn_tpu_torch.obs.metrics import count_program_build
from mpgcn_tpu_torch.train.predict import rollout


#: the warm-up stream of every graph set, by device index (``side_stream``)
_side_streams: dict = {}
_side_lock = threading.Lock()


def side_stream(device: torch.device) -> "torch.cuda.Stream":
    """The one side stream that graph sets on ``device`` warm up on.
    cuBLAS keeps a workspace for each stream it has run on and does not
    free it, so a stream per graph set grows a process that makes a
    trainer per retrain (the continual-learning daemon) by a workspace a
    trainer."""
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    with _side_lock:
        stream = _side_streams.get(index)
        if stream is None:
            stream = _side_streams[index] = torch.cuda.Stream(index)
        return stream


def refusal(device: torch.device, bdgcn_impl: str,
            group=None, model_group=None) -> Optional[str]:
    """Why steps on ``device`` and ``bdgcn_impl`` (all-reducing their
    gradients over the process ``group``, and gathering their layers'
    inputs over ``model_group`` on a model axis, where one is given) run
    uncaptured, or None when they are captured."""
    if device.type != "cuda":
        return "cpu: CUDA graphs need the card"
    if bdgcn_impl == "ell":
        return ("bdgcn_impl=ell: the ELL forward and dX count their "
                "Inf/NaN marks' generation on the host")
    if group is not None:
        return _collective_refusal(device, group, model_group)
    return None


def _collective_refusal(device: torch.device, group,
                        model_group=None) -> Optional[str]:
    """Capture one all-reduce over ``group`` (and, on a model axis, one
    all-gather and one reduce-scatter over ``model_group``: the layers'
    origin gather and its backward) into a throwaway graph: None when it
    records, else why the step's collectives stay outside a graph. (In a
    world of one rank NCCL enqueues no work for an in-place all-reduce, so
    there the trial graph is empty: it shows only that the call may run
    under capture.)"""
    import torch.distributed as dist

    for g in (group, model_group):
        if g is not None and dist.get_backend(g) != "nccl":
            return (f"{dist.get_backend(g)}: its collectives run on the "
                    f"host, where a CUDA graph cannot capture them")
    buf = torch.ones(8, device=device)
    mp = dist.get_world_size(model_group) if model_group is not None else 1

    def collectives():
        dist.all_reduce(buf, group=group)
        if model_group is not None:
            reduce_scatter_blocks(all_gather_blocks(buf, model_group, mp),
                                  model_group, mp)

    stream = side_stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))
    try:
        with torch.cuda.stream(stream):
            collectives()  # eager: the communicators
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=stream):
                collectives()
            graph.replay()
        torch.cuda.synchronize(device)
    except RuntimeError as e:
        what = ("an all_reduce" if model_group is None else
                "an all_reduce, all_gather and reduce_scatter")
        return f"nccl: capturing {what} failed ({e})"
    return None


class Captured:
    """One captured graph: its static ``inputs`` (filled by ``replay``),
    its static ``output``, and the kernel launches its capture tallied
    (added to the kernels' counts at every replay)."""

    def __init__(self, graph, inputs: tuple, output, tally: dict, lock):
        self.graph, self.inputs, self.output = graph, inputs, output
        self.tally, self._lock = tally, lock

    def replay(self, *values):
        """Copy ``values`` into the static inputs, run the graph, and
        return its static output (valid until the set's next replay)."""
        with self._lock:
            for buf, v in zip(self.inputs, values):
                buf.copy_(v)
            self.graph.replay()
            add_replayed(self.tally)
        return self.output


class GraphSet:
    """The graphs of one trainer or engine on ``device``, by key; raises
    where ``refusal`` names a reason."""

    def __init__(self, device: torch.device, bdgcn_impl: str):
        why = refusal(device, bdgcn_impl)
        if why is not None:
            raise RuntimeError(f"cannot capture CUDA graphs here ({why})")
        self.device = device
        self.pool = torch.cuda.graph_pool_handle()
        self.lock = threading.RLock()
        self.stream = side_stream(device)
        self.graphs: dict = {}

    def get(self, key) -> Optional[Captured]:
        return self.graphs.get(key)

    def warmup(self, fn: Callable):
        """Run ``fn`` eagerly on the side stream (the capture recipe's
        warm-up; its work is real: a train step updates the weights) and
        return what it returns."""
        with self.lock:
            cur = torch.cuda.current_stream(self.device)
            self.stream.wait_stream(cur)
            with torch.cuda.stream(self.stream):
                out = fn()
            cur.wait_stream(self.stream)
        return out

    def capture(self, key, fn: Callable, inputs: tuple = ()) -> Captured:
        """Record ``fn`` (which reads ``inputs`` and returns its output)
        into a graph of the set's pool under ``key``. The capture checks
        only its own thread's calls ("thread_local"): the stream
        executor's staging thread pins each chunk's host buffers
        (``cudaHostAlloc``) while the compute thread captures, and under
        the default "global" mode that call, in another thread, ends the
        capture with ``cudaErrorStreamCaptureInvalidated``."""
        graph = torch.cuda.CUDAGraph()
        with self.lock, capture_launches() as tally:
            with torch.cuda.graph(graph, pool=self.pool,
                                  capture_error_mode="thread_local"):
                out = fn()
        self.graphs[key] = cap = Captured(graph, inputs, out, tally,
                                          self.lock)
        count_program_build("cuda_graph")
        return cap

    def drop(self) -> None:
        """Drop every graph of the set. Their pool goes with the last of
        them, so later captures take a new one."""
        with self.lock:
            self.graphs.clear()
            self.pool = torch.cuda.graph_pool_handle()


class Precision:
    """A rollout's precision: its ``name`` (f32, bf16 or int8, the key of
    its graphs), compute ``dtype`` (None: f32) and weight tree ``params``
    (the int8 tree, or None for the model's own weights)."""

    def __init__(self, name: str = "f32", dtype=None, params=None):
        self.name, self.dtype, self.params = name, dtype, params


class RolloutGraphs:
    """One captured ``rollout`` of ``model`` over ``banks`` per (batch,
    horizon, precision), the counterpart of the JAX trainer's jitted
    ``_rollout`` and of the serve engine's AOT executable per (bucket,
    horizon) and precision mode. ``run`` captures a triple on its first
    call (whose answer is the eager warm-up run's) and replays it after; a
    graph of one precision never answers a request at another. A graph
    reads the int8 tree where it lay at its capture: whoever replaces the
    tree (not refills it in place) drops the graphs (``GraphSet.drop``).
    ``slot`` (None: none) joins the key, so several models of one config
    (the serve engine's two parameter slots) capture their rollouts on
    one graph set, one pool and one lock."""

    def __init__(self, graphs: GraphSet, model, banks: dict, slot=None):
        self.graphs, self.model, self.banks = graphs, model, banks
        self.slot = slot

    def _key(self, batch: int, horizon: int, prec: Precision) -> tuple:
        key = (batch, horizon, prec.name)
        return key if self.slot is None else (self.slot,) + key

    def replay(self, x: torch.Tensor, keys: torch.Tensor, horizon: int,
               precision: Precision) -> torch.Tensor:
        """The captured rollout of (x's batch, horizon, precision) on x
        and keys, its forecast on the host; raises where none was
        captured (nothing is captured on the request path)."""
        g = self.graphs.get(self._key(x.shape[0], horizon, precision))
        if g is None:
            raise KeyError(f"no rollout graph captured for batch "
                           f"{x.shape[0]}, horizon {horizon}, precision "
                           f"{precision.name}, slot {self.slot}")
        with self.graphs.lock:
            return g.replay(x, keys).cpu()

    def run(self, x: torch.Tensor, keys: torch.Tensor, horizon: int,
            precision: Precision | None = None) -> torch.Tensor:
        """x (B, T, N, N, 1), keys (B,) int64, on any device -> the
        (B, horizon, N, N, 1) forecast on the host, at ``precision``
        (default f32 on the model's weights)."""
        prec = precision or Precision()
        key = self._key(x.shape[0], horizon, prec)
        with self.graphs.lock:
            g = self.graphs.get(key)
            if g is not None:
                return g.replay(x, keys).cpu()
            xs = x.to(self.graphs.device, copy=True)
            ks = keys.to(self.graphs.device, copy=True)

            def fn():
                return rollout(self.model, self.banks, xs, ks, horizon,
                               prec.dtype, prec.params)

            out = self.graphs.warmup(fn).cpu()
            self.graphs.capture(key, fn, (xs, ks))
            return out

    def capture_all(self, shapes, horizons, obs_len: int, num_nodes: int,
                    precision: Precision | None = None) -> float:
        """Capture every (batch in ``shapes``, horizon) pair at
        ``precision`` on zero inputs; returns the seconds it took."""
        prec = precision or Precision()
        t0 = time.perf_counter()
        for b in shapes:
            x = torch.zeros((b, obs_len, num_nodes, num_nodes, 1))
            k = torch.zeros((b,), dtype=torch.long)
            for h in horizons:
                if self.graphs.get(self._key(b, h, prec)) is None:
                    self.run(x, k, h, prec)
        return time.perf_counter() - t0
