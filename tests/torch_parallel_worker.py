"""One rank of the data-parallel CPU tests (tests/test_torch_parallel.py):
joins a gloo group through a ``file://`` rendezvous, runs the named
scenarios of ``mpgcn_tpu_torch.parallel`` in order, and saves what each
found to ``<out>/<scenario>/rank<r>.pt``. Imports no JAX.

    python tests/torch_parallel_worker.py SPEC.json RANK

SPEC holds ``init`` (the rendezvous URL), ``world``, ``out``,
``scenarios``, ``data_kw`` (the config fields of the synthetic series),
``kw`` (those every scenario's config starts from) and ``init_params``
(a state_dict file the weights are loaded from).
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
    ReplicaDivergenceError,
    check_replica_consistency,
    initialize,
    make_mesh,
)


def _state(tr) -> dict:
    """The weights and Adam's moments and steps, as host tensors."""
    out = {f"p:{k}": v.detach().clone()
           for k, v in tr.model.state_dict().items()}
    for k, p in tr.model.named_parameters():
        for name, t in tr.optimizer.state[p].items():
            out[f"o:{k}:{name}"] = t.detach().clone()
    return out


class Run:
    def __init__(self, spec: dict, rank: int):
        self.spec, self.rank = spec, rank
        self.data = synthetic_dataset(MPGCNConfig(**spec["data_kw"]))
        self.init = torch.load(spec["init_params"]) \
            if spec.get("init_params") else None

    def out(self, name: str) -> str:
        d = os.path.join(self.spec["out"], name)
        os.makedirs(d, exist_ok=True)
        return d

    def trainer(self, name: str, **kw):
        cfg = MPGCNConfig(output_dir=self.out(name),
                          **{**self.spec["kw"], **kw})
        tr = ParallelModelTrainer(cfg, self.data, device="cpu")
        if self.init is not None:
            tr.model.load_state_dict(self.init)
        return tr

    def first_step(self, name: str, **kw) -> dict:
        tr = self.trainer(name, **kw)
        batch = next(tr.pipeline.batches("train", pad_to_full=True))
        loss = tr.train_step(batch)
        return {"loss": loss, **_state(tr)}

    # --- the scenarios ------------------------------------------------------

    def mesh(self) -> dict:
        found = {"shape": make_mesh(device="cpu").shape}
        for args in ((4, 1), (2, 3), (2, 2)):
            try:
                make_mesh(*args, device="cpu")
                found[str(args)] = "ok"
            except (ValueError, NotImplementedError) as e:
                found[str(args)] = f"{type(e).__name__}: {e}"
        return found

    def step(self) -> dict:
        return self.first_step("step")

    def accum(self) -> dict:
        return self.first_step("accum", batch_size=8, grad_accum=2)

    def _epochs(self, name: str, **kw) -> dict:
        tr = self.trainer(name, num_epochs=2, **kw)
        hist = tr.train()
        return {"hist": hist, "exec": tr._epoch_exec("train"),
                **_state(tr)}

    def scan(self) -> dict:
        return self._epochs("scan")

    def stream(self) -> dict:
        return self._epochs("stream", epoch_scan_max_mb=0.0,
                            stream_chunk_mb=0.02)

    def scan_accum(self) -> dict:
        return self._epochs("scan_accum", batch_size=8, grad_accum=2)

    def stream_accum(self) -> dict:
        return self._epochs("stream_accum", batch_size=8, grad_accum=2,
                            epoch_scan_max_mb=0.0, stream_chunk_mb=0.02)

    def per_step(self) -> dict:
        return self._epochs("per_step", epoch_scan=False)

    def test(self) -> dict:
        """Train one epoch, then roll out 3 steps in test mode."""
        self.trainer("test", num_epochs=1).train()
        return {"results": self.trainer("test", pred_len=3).test()}

    def resume(self) -> dict:
        """Resume the 1-rank run the test wrote into <out>/resume."""
        tr = self.trainer("resume", num_epochs=3)
        hist = tr.train(resume=True)
        return {"hist": hist, **_state(tr)}

    def orbax(self) -> dict:
        tr = self.trainer("orbax", num_epochs=1, checkpoint_backend="orbax")
        tr.train()
        return {"results": tr.test(), **_state(tr)}

    def nan(self) -> dict:
        tr = self.trainer("nan", num_epochs=1, faults="nan_step=2",
                          skip_budget=1)
        return {"hist": tr.train(), **_state(tr)}

    def consistency(self) -> dict:
        """A clean check, then a byte flipped on rank 1 before epoch 2's
        check: both ranks raise, roll back, and train on clean."""
        tree = {"w": torch.arange(6.0), "b": [np.ones(3, np.float32)]}
        found = {"clean": check_replica_consistency(tree)}
        if self.rank == 1:
            tree["w"][2] += 1.0
        try:
            check_replica_consistency(tree, name="toy")
            found["flipped"] = None
        except ReplicaDivergenceError as e:
            found["flipped"] = str(e)
        tr = self.trainer("consistency", num_epochs=3,
                          consistency_check_every=1, rollback_retries=1)
        check, raised = tr._check_consistency, []

        def flipping(epoch, logger):
            if epoch == 2 and not raised and self.rank == 1:
                p = next(tr.model.parameters())
                with torch.no_grad():
                    p.view(-1)[0] = torch.nextafter(p.view(-1)[0],
                                                    torch.tensor(np.inf))
            try:
                return check(epoch, logger)
            except ReplicaDivergenceError:
                raised.append(epoch)
                raise

        tr._check_consistency = flipping
        found["hist"] = tr.train()
        found["raised"] = raised
        found.update(_state(tr))
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
