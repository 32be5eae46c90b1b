"""One rank of the model-axis CPU tests (tests/test_torch_model_axis.py):
joins a gloo group of ``world`` ranks through a ``file://`` rendezvous,
lays them out as a (world / mp, mp) mesh, runs the named scenarios of
``mpgcn_tpu_torch.parallel`` in order, and saves what each found to
``<out>/<scenario>/rank<r>.pt``. Imports no JAX.

    python tests/torch_model_axis_worker.py SPEC.json RANK

SPEC holds ``init`` (the rendezvous URL), ``world``, ``mp``, ``out``,
``scenarios``, ``configs`` (name -> the config fields of a scenario's
data and trainer), ``inits`` (config name -> a state_dict file its
weights are loaded from) and ``halo`` (the halo cases' operator file).
"""

import json
import os
import sys
import traceback

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from mpgcn_tpu_torch.config import MPGCNConfig  # noqa: E402
from mpgcn_tpu_torch.data.loader import synthetic_dataset  # noqa: E402
from mpgcn_tpu_torch.parallel import (  # noqa: E402
    ParallelModelTrainer,
    build_halo_plan,
    halo_spmm,
    initialize,
    make_mesh,
)
from mpgcn_tpu_torch.sparse.formats import csr_from_dense  # noqa: E402

#: the halo cases: (local_impl, overlap, quantized)
HALO_CASES = [(impl, ov, q) for impl in ("csr", "ell")
              for ov in (False, True) for q in (False, True)]


def _state(tr) -> dict:
    out = {f"p:{k}": v.detach().clone()
           for k, v in tr.model.state_dict().items()}
    for k, p in tr.model.named_parameters():
        for name, t in tr.optimizer.state[p].items():
            out[f"o:{k}:{name}"] = t.detach().clone()
    return out


class Run:
    def __init__(self, spec: dict, rank: int):
        self.spec, self.rank = spec, rank
        self.mp = spec["mp"]
        self._data = {}

    def out(self, name: str) -> str:
        d = os.path.join(self.spec["out"], name)
        os.makedirs(d, exist_ok=True)
        return d

    def data(self, cfg: MPGCNConfig):
        key = (cfg.synthetic_N, cfg.synthetic_T, cfg.num_branches)
        if key not in self._data:
            self._data[key] = synthetic_dataset(cfg)
        return self._data[key]

    def trainer(self, name: str, config: str, init: bool = True, **kw):
        bdgcn = kw.pop("bdgcn_impl", "auto")
        cfg = MPGCNConfig(output_dir=self.out(name),
                          **{**self.spec["configs"][config], **kw})
        tr = ParallelModelTrainer(
            cfg, self.data(cfg), device="cpu", bdgcn_impl=bdgcn,
            mesh=make_mesh(model_parallel=self.mp, device="cpu"))
        if init:
            tr.model.load_state_dict(torch.load(
                self.spec["inits"][config]))
        return tr

    def first_step(self, name: str, config: str, **kw) -> dict:
        tr = self.trainer(name, config, **kw)
        batch = next(tr.pipeline.batches("train", pad_to_full=True))
        loss = tr.train_step(batch)
        return {"loss": loss, "impl": tr.bdgcn_impl, **_state(tr)}

    # --- the scenarios ------------------------------------------------------

    def mesh(self) -> dict:
        m = make_mesh(model_parallel=self.mp, device="cpu")
        found = {"shape": m.shape, "index": (m.data_index, m.model_index),
                 "groups": [None if g is None
                            else torch.distributed.get_world_size(g)
                            for g in (m.model_group, m.data_group)]}
        for args in ((8, 1), (self.spec["world"], 3)):
            try:
                make_mesh(*args, device="cpu")
                found[str(args)] = "ok"
            except ValueError as e:
                found[str(args)] = f"{type(e).__name__}: {e}"
        return found

    def step8(self) -> dict:
        return self.first_step("step8", "n8")

    def step47(self) -> dict:
        return self.first_step("step47", "n47")

    def accum(self) -> dict:
        return self.first_step("accum", "n8", batch_size=16, grad_accum=2)

    def multistep(self) -> dict:
        return self.first_step("multistep", "n8", pred_len=2)

    def three(self) -> dict:
        return self.first_step("three", "three")

    def bf16(self) -> dict:
        return self.first_step("bf16", "bf16")

    def csr(self) -> dict:
        return self.first_step("csr", "n8", bdgcn_impl="csr")

    def rollout(self) -> dict:
        """A 3-step rollout of the first test batch, gathered."""
        tr = self.trainer("rollout", "n8")
        batch = next(tr.pipeline.batches("test", pad_to_full=True))
        tr.cfg = tr.cfg.replace(pred_len=3)
        return {"pred": tr._rollout_batch(batch)}

    def _epochs(self, name: str, **kw) -> dict:
        tr = self.trainer(name, "n47", num_epochs=2, **kw)
        hist = tr.train()
        return {"hist": hist, "exec": tr._epoch_exec("train"),
                "refusal": tr.graph_refusal, **_state(tr)}

    def scan(self) -> dict:
        return self._epochs("scan", consistency_check_every=1)

    def stream(self) -> dict:
        return self._epochs("stream", epoch_scan_max_mb=0.0,
                            stream_chunk_mb=1.0)

    def test(self) -> dict:
        """Train one epoch, then roll out 3 steps in test mode."""
        self.trainer("test", "n47", num_epochs=1).train()
        return {"results": self.trainer("test", "n47", init=False,
                                        pred_len=3).test()}

    def dead47(self) -> dict:
        """A dead head at N = 47 (every FC weight and bias negative) whose
        padded origin rows come out nonzero, as the biases alone may leave
        them: one epoch with the dead-init probe on."""
        tr = self.trainer("dead47", "n47", num_epochs=1, on_dead_init="warn")
        with torch.no_grad():
            for br in tr.model.branches:
                for p in br.fc.parameters():
                    p.copy_(-p.abs() - 0.1)
        forward, shard = tr.model.forward, tr._nodes

        def padding_alive(*args, **kw):
            out = forward(*args, **kw)
            alive = torch.zeros_like(out)
            alive[:, :, shard.real:] = 1.0
            return out + alive

        tr.model.forward = padding_alive
        tr.train()
        return {"dead": tr._dead_init_detected, "real": shard.real,
                "n_loc": shard.n_loc}

    def resume(self) -> dict:
        """Resume the 1-rank run the test wrote into <out>/resume."""
        tr = self.trainer("resume", "n47", init=False, num_epochs=2)
        hist = tr.train(resume=True)
        return {"hist": hist, **_state(tr)}

    def halo(self) -> dict:
        """halo_spmm on this rank's block, every arm, forward and the
        gradient of the summed squares; then the zero-traffic operator."""
        ops = np.load(self.spec["halo"])
        world = self.spec["world"]
        found = {}
        for name in ("banded", "blockdiag"):
            G, X = ops[f"{name}_G"], ops[f"{name}_X"]
            n_loc = G.shape[1] // world
            rows = slice(self.rank * n_loc, (self.rank + 1) * n_loc)
            for impl, ov, q in HALO_CASES:
                plan = build_halo_plan(csr_from_dense(G), world, bucket=1,
                                       local_impl=impl)
                x = torch.from_numpy(X[rows].copy()).requires_grad_(True)
                out = halo_spmm(plan, x, overlap=ov, local_impl=impl,
                                quantized=q)
                (out ** 2).sum().backward()
                found[(name, impl, ov, q)] = (out.detach().numpy(),
                                              x.grad.numpy())
            found[(name, "halo_cols")] = plan.halo_cols
        return found


def main() -> int:
    with open(sys.argv[1]) as f:
        spec = json.load(f)
    rank = int(sys.argv[2])
    torch.set_num_threads(1)
    initialize(spec["init"], world_size=spec["world"], rank=rank,
               backend="gloo", timeout_s=spec.get("timeout_s", 60))
    run = Run(spec, rank)
    for name in spec["scenarios"]:
        try:
            found = getattr(run, name)()
        except Exception:
            found = {"exception": traceback.format_exc()}
        torch.save(found, os.path.join(run.out(name), f"rank{rank}.pt"))
        if "exception" in found:
            print(found["exception"], file=sys.stderr, flush=True)
            return 1
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
