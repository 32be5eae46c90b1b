"""The port's ServeEngine: a 7-step rollout against the JAX
``ModelTrainer._rollout_fn`` (Pallas kernels in interpret mode) from a
checkpoint the JAX ``save_checkpoint`` wrote; bucketing, repeat padding
and typed rejections; and the entry points' refusal to run on the CPU
unless asked.

Rollout tolerance rtol 1e-4 / atol 1e-4: seven autoregressive steps of f32
arithmetic whose summation order differs from XLA's."""

import fractions
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpgcn_tpu.config import MPGCNConfig as JaxConfig
from mpgcn_tpu.train import ModelTrainer
from mpgcn_tpu.train.checkpoint import save_checkpoint
from mpgcn_tpu_torch.config import MPGCNConfig, ServeConfig
from mpgcn_tpu_torch.data.loader import synthetic_dataset
from mpgcn_tpu_torch.data.pipeline import DataPipeline
from mpgcn_tpu_torch.device import resolve_device
from mpgcn_tpu_torch.graph.kernels import compute_supports
from mpgcn_tpu_torch.nn.mpgcn import MPGCN
from mpgcn_tpu_torch.service.batcher import (
    OK,
    REJECT_DRAINING,
    REJECT_INVALID,
    SHED_DEADLINE,
    SHED_QUEUE_FULL,
    MicroBatcher,
    Ticket,
    pick_bucket,
)
from mpgcn_tpu_torch.service.serve import ServeEngine
from mpgcn_tpu_torch.utils.convert import load_jax_checkpoint

# each pytest-xdist worker takes its share of the cores: torch's default
# of one intra-op thread per core, in every worker at once, oversubscribes
# the machine
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

N, H, OBS, PRED = 8, 8, 7, 7
TOL = dict(rtol=1e-4, atol=1e-4)
KW = dict(synthetic_T=60, synthetic_N=N, hidden_dim=H, obs_len=OBS,
          pred_len=PRED, seed=0)


@pytest.fixture(scope="module")
def jax_stack(tmp_path_factory):
    """A JAX trainer on the Pallas paths and its params in a pickle
    checkpoint written by the JAX package."""
    out = tmp_path_factory.mktemp("torch_serve")
    cfg = MPGCNConfig(**KW)
    data = synthetic_dataset(cfg)
    jcfg = JaxConfig(native_host="off", lstm_impl="pallas",
                     bdgcn_impl="pallas", output_dir=str(out),
                     **KW).replace(num_nodes=N)
    trainer = ModelTrainer(jcfg, data)
    ckpt = os.path.join(str(out), "MPGCN_od.pkl")
    save_checkpoint(ckpt, trainer.params, 0, opt_state=trainer.opt_state,
                    extra={"num_branches": 2,
                           "branch_sources": ["static", "dynamic"]})
    return {"cfg": cfg, "data": data, "trainer": trainer, "ckpt": ckpt,
            "out": out}


def _engine(stack, **scfg_kw):
    scfg = ServeConfig(**{"buckets": (1, 2, 4), "max_queue": 16,
                          "max_wait_ms": 20.0, **scfg_kw})
    return ServeEngine(stack["cfg"], stack["data"], scfg, device="cpu",
                       init_ckpt=stack["ckpt"])


def test_rollout_matches_jax_trainer(jax_stack):
    trainer = jax_stack["trainer"]
    md = trainer.pipeline.modes["test"]
    x = np.ascontiguousarray(md.x)
    keys = md.keys
    ref = np.asarray(jax.jit(
        lambda p, b, xx, kk: trainer._rollout_fn(p, b, xx, kk, PRED,
                                                 inference=True))(
        trainer.params, trainer.banks, jnp.asarray(x), jnp.asarray(keys)))
    assert ref.shape == (len(x), PRED, N, N, 1)
    assert (ref != 0).mean() > 0.1, "dead ReLU head: parity would be vacuous"
    eng = _engine(jax_stack)
    try:
        # no deadline (deadline_ms=0): the test checks the rollout's
        # numbers, not how fast a loaded CPU serves them
        tickets = [eng.submit(x[i, ..., 0], int(keys[i]), deadline_ms=0)
                   for i in range(len(x))]
        for t in tickets:
            assert t.wait(60)
        assert [t.outcome for t in tickets] == [OK] * len(x), [
            (i, t.outcome, t.error) for i, t in enumerate(tickets)
            if t.outcome != OK]
        preds = np.stack([t.pred for t in tickets])
        np.testing.assert_allclose(preds, ref, **TOL)
        st = eng.stats()
        assert st["resolved"] == len(x) and st["outcomes"] == {OK: len(x)}
        assert set(st["pad_waste"]["by_bucket"]) <= {"1", "2", "4"}
        assert st["pad_waste"]["live"] == len(x)
        assert st["params"] == jax_stack["ckpt"]
        # CPU tensors never launch a kernel
        assert set(st["kernel_launches"].values()) == {0}
    finally:
        eng.close()


def test_checkpoint_loads_without_jax_classes(jax_stack):
    params = load_jax_checkpoint(jax_stack["ckpt"], num_branches=2,
                                 branch_sources=("static", "dynamic"))
    assert len(params["branches"]) == 2
    assert isinstance(params["branches"][0]["spatial"][0]["W"], np.ndarray)
    with pytest.raises(ValueError, match="num_branches=2"):
        load_jax_checkpoint(jax_stack["ckpt"], num_branches=3)
    with pytest.raises(ValueError, match="branch_sources"):
        load_jax_checkpoint(jax_stack["ckpt"],
                            branch_sources=("dynamic", "static"))
    # a params tree holding a class the port will not import (a quantized
    # tree, say) is refused, not half-loaded
    odd = os.path.join(str(jax_stack["out"]), "odd.pkl")
    with open(odd, "wb") as f:
        pickle.dump({"params": {"branches": [fractions.Fraction(1, 2)]}}, f)
    with pytest.raises(ValueError, match="fractions.Fraction"):
        load_jax_checkpoint(odd)


def test_engine_rejects_invalid_requests(jax_stack):
    eng = _engine(jax_stack)
    try:
        good = np.ones((OBS, N, N), np.float32)
        cases = {
            "wrong shape": (np.ones((OBS - 1, N, N)), 0, None),
            "zone count": (np.ones((OBS, N + 1, N + 1)), 0, None),
            "non-finite": (np.where(good > 0, np.nan, 0), 0, None),
            "negative": (-good, 0, None),
            "day-of-week": (good, 7, None),
            "overflow": (np.full((OBS, N, N), 1e39), 0, None),
            "horizon": (good, 0, 3),
        }
        for name, (x, key, h) in cases.items():
            t = eng.submit(x, key, horizon=h)
            assert t.outcome == REJECT_INVALID, name
            assert t.error, name
        assert eng.submit(good, 0).wait(60)
        assert eng.drain(timeout=30)
        assert eng.submit(good, 0).outcome == REJECT_DRAINING
        assert eng.stats()["outcomes"][REJECT_INVALID] == len(cases)
    finally:
        eng.close()


def test_engine_needs_a_checkpoint_or_fresh_init(jax_stack, tmp_path):
    scfg = ServeConfig(buckets=(1,))
    cfg, data = jax_stack["cfg"], jax_stack["data"]
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        ServeEngine(cfg, data, scfg, device="cpu")
    # a named checkpoint that is missing is an error, never a fresh init
    with pytest.raises(FileNotFoundError):
        ServeEngine(cfg, data, scfg, device="cpu",
                    init_ckpt=str(tmp_path / "missing.pkl"),
                    allow_fresh=True)
    eng = ServeEngine(cfg, data, scfg, device="cpu", allow_fresh=True)
    eng.close()
    assert eng.stats()["params"].startswith("fresh init")
    eng = ServeEngine(cfg, data, scfg, device="cpu",
                      init_ckpt=jax_stack["ckpt"], allow_fresh=True)
    eng.close()
    assert eng.stats()["params"] == jax_stack["ckpt"]


def test_batcher_buckets_and_repeat_pads():
    seen = []

    def run_batch(x, keys, bucket, n_live):
        seen.append((x.copy(), keys.copy(), bucket, n_live))
        return x[:, :1] * 2

    mb = MicroBatcher(run_batch, (1, 2, 4, 8), max_queue=16,
                      max_wait_ms=200.0)
    assert [pick_bucket(n, (1, 2, 4, 8)) for n in (1, 2, 3, 5, 8, 9)] == \
        [1, 2, 4, 8, 8, 8]
    tickets = [Ticket(np.full((3, 2, 2, 1), i, np.float32), key=i)
               for i in range(3)]
    for t in tickets:
        mb.submit(t)
    mb.start()
    try:
        for t in tickets:
            assert t.wait(10) and t.outcome == OK
        x, keys, bucket, n_live = seen[0]
        assert (bucket, n_live) == (4, 3)
        # the last row -- keys included -- repeats; never zeros
        np.testing.assert_array_equal(x[3], x[2])
        assert keys.tolist() == [0, 1, 2, 2]
        for i, t in enumerate(tickets):
            assert t.bucket == 4 and float(t.pred.max()) == 2 * i
    finally:
        mb.stop()


def test_batcher_sheds_and_survives_errors():
    mb = MicroBatcher(lambda *a: (_ for _ in ()).throw(RuntimeError("x")),
                      (1, 2), max_queue=2)
    ts = [Ticket(np.zeros((1,)), 0) for _ in range(3)]
    expired = Ticket(np.zeros((1,)), 0, deadline_s=1e-9)
    for t in ts:
        mb.submit(t)
    assert ts[2].outcome == SHED_QUEUE_FULL
    mb.start()
    try:
        for t in ts[:2]:
            assert t.wait(10) and t.outcome == "error-internal"
        mb.submit(expired)
        assert expired.wait(10) and expired.outcome == SHED_DEADLINE
    finally:
        mb.stop()


def test_entry_points_refuse_cpu_unless_asked(jax_stack, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg, data = jax_stack["cfg"], jax_stack["data"]
    adj = np.ones((N, N), np.float32)
    calls = [
        lambda: resolve_device(),
        lambda: compute_supports(adj, "random_walk_diffusion", 2),
        lambda: DataPipeline(cfg, data),
        lambda: MPGCN.from_config(cfg),
        lambda: ServeEngine(cfg, data, ServeConfig(), allow_fresh=True),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            call()
    assert resolve_device("cpu").type == "cpu"
    assert compute_supports(adj, "random_walk_diffusion", 2,
                            device="cpu").shape == (3, N, N)
