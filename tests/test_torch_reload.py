"""The port's serving engine and canaried hot reload against the JAX
package's: the two repairs (horizons past pred_len refused; the first
parameters from init_ckpt, then the promoted slot, then a fresh init),
the same requests through both engines from one promoted slot, and the
JAX package's reload scenarios (tests/test_serve.py) run on both engines
with their action sequences and reload-ledger events compared.

Size: N=8, hidden 8, T=60, buckets (1, 2, 4), horizon 1; the JAX engine
runs its CPU defaults (einsum BDGCN, scan LSTM), the port its plain
versions on the CPU. Answers to rtol 1e-4 / atol 1e-4; the port's own
incumbent before and after a rejected reload bit for bit."""

import hashlib
import os
import pickle
import types

import numpy as np
import pytest
import torch

from mpgcn_tpu.config import MPGCNConfig as JaxConfig
from mpgcn_tpu.resilience.faults import FaultPlan as JaxFaultPlan
from mpgcn_tpu.service import batcher as jax_batcher
from mpgcn_tpu.service import promote as jax_promote
from mpgcn_tpu.service import reload as jax_reload
from mpgcn_tpu.service import serve as jax_serve
from mpgcn_tpu.service.config import ServeConfig as JaxServeConfig
from mpgcn_tpu.train import ModelTrainer
from mpgcn_tpu.train.checkpoint import save_checkpoint
from mpgcn_tpu.utils import logging as jax_logging
from mpgcn_tpu_torch.config import MPGCNConfig, ServeConfig
from mpgcn_tpu_torch.data.loader import synthetic_dataset
from mpgcn_tpu_torch.resilience.faults import FaultPlan
from mpgcn_tpu_torch.service import batcher
from mpgcn_tpu_torch.service import promote
from mpgcn_tpu_torch.service import reload
from mpgcn_tpu_torch.service import serve
from mpgcn_tpu_torch.utils import logging as port_logging

torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

N, H, OBS = 8, 8, 7
TOL = dict(rtol=1e-4, atol=1e-4)
KW = dict(synthetic_T=60, synthetic_N=N, hidden_dim=H, obs_len=OBS,
          pred_len=1, batch_size=4, seed=0)
EXTRA = {"num_branches": 2, "branch_sources": ["static", "dynamic"]}


@pytest.fixture(scope="module")
def stack(tmp_path_factory):
    """Two JAX-written checkpoints (manifest and integrity record): the
    seeded init and a nudged copy of it (the reload candidate)."""
    out = tmp_path_factory.mktemp("torch_reload")
    cfg = MPGCNConfig(**KW)
    data = synthetic_dataset(cfg)
    jcfg = JaxConfig(mode="test", data="synthetic", **KW).replace(
        num_nodes=N)
    params = ModelTrainer(jcfg, data).params
    ckpt, ckpt2 = str(out / "MPGCN_od.pkl"), str(out / "cand.pkl")
    save_checkpoint(ckpt, params, 0, extra=EXTRA)
    import jax

    save_checkpoint(ckpt2, jax.tree_util.tree_map(
        lambda a: np.asarray(a) * np.float32(1.01), params), 1,
        extra=EXTRA)
    md_x, md_keys = _test_windows(cfg, data)
    return {"cfg": cfg, "jcfg": jcfg, "data": data, "ckpt": ckpt,
            "ckpt2": ckpt2, "x": md_x, "keys": md_keys}


def _test_windows(cfg, data):
    from mpgcn_tpu_torch.data.pipeline import DataPipeline

    md = DataPipeline(cfg, data, "cpu").modes["test"]
    return np.array(md.x), np.asarray(md.keys)


def _pkg(name):
    """One package's serving surface under common names."""
    if name == "jax":
        return types.SimpleNamespace(
            name=name, serve=jax_serve, reload=jax_reload,
            promote=jax_promote, logging=jax_logging, batcher=jax_batcher,
            FaultPlan=JaxFaultPlan, ServeConfig=JaxServeConfig,
            engine_kw={})
    return types.SimpleNamespace(
        name=name, serve=serve, reload=reload, promote=promote,
        logging=port_logging, batcher=batcher, FaultPlan=FaultPlan,
        ServeConfig=ServeConfig, engine_kw={"device": "cpu"})


PKGS = ("port", "jax")


def _ledger(pkg, svc):
    path = pkg.promote.ledger_path(str(svc))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    return pkg.logging.JsonlLogger(path)


def _engine(pkg, stack, svc, promote_first=True, faults=None, **scfg_kw):
    """An engine over a fresh service dir, its incumbent promoted from the
    stack's checkpoint through the real slot and ledger path."""
    scfg = pkg.ServeConfig(output_dir=str(svc),
                           **{"buckets": (1, 2, 4), "max_queue": 8,
                              "max_wait_ms": 2.0, **scfg_kw})
    init = None
    if promote_first:
        slot = pkg.promote.promoted_path(str(svc))
        pkg.promote.promote_checkpoint(stack["ckpt"], slot)
        _ledger(pkg, svc).log("gate", attempt=1, promoted=True,
                              candidate_hash=pkg.promote.candidate_hash(
                                  slot))
    else:
        init = stack["ckpt"]
    cfg = stack["jcfg"] if pkg.name == "jax" else stack["cfg"]
    return pkg.serve.ServeEngine(cfg, stack["data"], scfg, faults=faults,
                                 init_ckpt=init, **pkg.engine_kw)


def _req(stack, i=0):
    n = len(stack["x"])
    return stack["x"][i % n], int(stack["keys"][i % n])


def _events(svc, kind=None):
    return [r for r in port_logging.read_events(
        serve.reloads_ledger_path(str(svc)), kind)]


def _both(tmp_path, scenario, stack):
    out = {}
    for name in PKGS:
        pkg = _pkg(name)
        out[name] = scenario(pkg, stack, tmp_path / name)
    return out["port"], out["jax"]


# --- the repairs -------------------------------------------------------------


@pytest.mark.parametrize("pkg_name", PKGS)
def test_horizons_past_pred_len_are_refused(stack, tmp_path, pkg_name):
    pkg = _pkg(pkg_name)
    with pytest.raises(ValueError, match="exceed the model config's "
                                         "pred_len=1"):
        _engine(pkg, stack, tmp_path, horizons=(1, 3))


def test_port_refuses_past_pred_len_before_building_anything(
        stack, tmp_path, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("a bank was built before the horizon check")

    monkeypatch.setattr(serve, "DataPipeline", boom)
    with pytest.raises(ValueError, match="pred_len"):
        serve.ServeEngine(stack["cfg"], stack["data"],
                          ServeConfig(output_dir=str(tmp_path),
                                      horizons=(2,)), device="cpu",
                          allow_fresh=True)
    assert not os.path.exists(os.path.join(str(tmp_path), "serve"))


def _first_params(pkg, stack, svc, case):
    """(incumbent hash, seq, an answer) for one way of starting."""
    scfg = pkg.ServeConfig(output_dir=str(svc), buckets=(1,))
    slot = pkg.promote.promoted_path(str(svc))
    init, fresh = None, False
    if case in ("slot", "slot_and_init"):
        pkg.promote.promote_checkpoint(stack["ckpt2"], slot)
        _ledger(pkg, svc).log("gate", attempt=1, promoted=False,
                              candidate_hash="x")
        _ledger(pkg, svc).log("gate", attempt=2, promoted=True,
                              candidate_hash=pkg.promote.candidate_hash(
                                  slot))
    if case in ("init", "slot_and_init"):
        init = stack["ckpt"]
    if case == "fresh":
        fresh = True
    cfg = stack["jcfg"] if pkg.name == "jax" else stack["cfg"]
    try:
        eng = pkg.serve.ServeEngine(cfg, stack["data"], scfg,
                                    init_ckpt=init, allow_fresh=fresh,
                                    **pkg.engine_kw)
    except FileNotFoundError:
        return "FileNotFoundError"
    try:
        t = eng.submit(*_req(stack), deadline_ms=0)
        assert t.wait(60) and t.ok, t.error
        return eng.incumbent_hash, eng.incumbent_seq, np.asarray(t.pred)
    finally:
        eng.close()


@pytest.mark.parametrize("case", ["slot", "init", "slot_and_init", "fresh",
                                  "none"])
def test_first_parameters_come_from_where_jax_takes_them(stack, tmp_path,
                                                         case):
    ours, ref = _both(tmp_path, lambda p, s, d: _first_params(p, s, d, case),
                      stack)
    if ref == "FileNotFoundError":
        assert ours == ref
        return
    assert ours[:2] == ref[:2]
    if case == "fresh":
        # each package draws its own seeded init: no answer to compare
        assert ours[:2] == ("", -1) and np.isfinite(ours[2]).all()
        return
    np.testing.assert_allclose(ours[2], ref[2], **TOL)
    if case == "slot":
        assert ours[1] == 1  # the ledger's promoted row


def test_a_named_missing_checkpoint_never_serves_fresh(stack, tmp_path):
    # the JAX engine would fall through to a fresh init here; the port
    # refuses to serve anything but the file it was named
    with pytest.raises(FileNotFoundError):
        serve.ServeEngine(stack["cfg"], stack["data"],
                          ServeConfig(output_dir=str(tmp_path)),
                          device="cpu", allow_fresh=True,
                          init_ckpt=str(tmp_path / "missing.pkl"))


# --- the request path against the JAX engine ------------------------------------


def _requests(pkg, stack, svc):
    eng = _engine(pkg, stack, svc, max_wait_ms=400.0, max_queue=16,
                  deadline_ms=0, capture_flows=True)
    try:
        traces0 = eng.trace_count
        groups, i, tickets = (4, 3, 2, 1), 0, []
        for size in groups:
            # every other request declares its day: its ledger row
            # carries the newest observed day's flows
            batch = [eng.submit(*_req(stack, j), trace=f"tr{j}",
                                day_slot=j if j % 2 else None)
                     for j in range(i, i + size)]
            for t in batch:
                assert t.wait(60), "request not answered"
            tickets += batch
            i += size
        bad = np.array(_req(stack)[0])
        bad[0, 0, 0] = np.nan
        rejects = [eng.submit(bad, 0, trace="bad"),
                   eng.submit(_req(stack)[0], 0, tenant="acme",
                              trace="tenant"),
                   eng.submit(_req(stack)[0], 0, horizon=3,
                              trace="horizon")]
        st = eng.stats()
        assert eng.trace_count == traces0 == 3
    finally:
        eng.close()
    rows = port_logging.read_events(serve.requests_ledger_path(str(svc)))
    spans = port_logging.read_events(
        os.path.join(str(svc), "obs", "spans.jsonl"), "span")
    chain = {}
    for r in spans:
        chain.setdefault(r["trace"], []).append(
            (r["name"], r["parent"] is None))
    return {"preds": [t.pred for t in tickets],
            "outcomes": [t.outcome for t in tickets + rejects],
            "buckets": [t.bucket for t in tickets],
            "errors": [t.error is not None for t in rejects],
            "by_bucket": {b: v["dispatches"] for b, v in
                          st["pad_waste"]["by_bucket"].items()},
            "stats_keys": {"resolved", "outcomes", "traces", "batches",
                           "incumbent", "canary", "reloads", "pad_waste",
                           "latency_ms", "slo", "double_buffer"}
            <= set(st),
            "ledger": [(r["event"], sorted(r)) for r in rows],
            "flows": [(r["day_slot"], np.asarray(r["flows"]).shape)
                      for r in rows if "flows" in r],
            "captured": st["capture"],
            "chains": {k: sorted(v) for k, v in chain.items()}}


def test_requests_answer_as_the_jax_engine(stack, tmp_path):
    ours, ref = _both(tmp_path, _requests, stack)
    np.testing.assert_allclose(np.stack(ours.pop("preds")),
                               np.stack(ref.pop("preds")), **TOL)
    assert ours == ref
    assert ours["buckets"] == [4] * 4 + [4] * 3 + [2] * 2 + [1]
    assert ours["chains"]["tr0"] == [("serve.batcher", False),
                                     ("serve.model", False),
                                     ("serve.request", True)]
    assert ours["chains"]["bad"] == [("serve.request", True)]
    assert ours["captured"] == {"enabled": True, "rows": 5}
    assert [d for d, _ in ours["flows"]] == [1, 3, 5, 7, 9]


# --- the reload scenarios --------------------------------------------------------


def _canary_then_promote(pkg, stack, svc, fraction):
    eng = _engine(pkg, stack, svc, canary_requests=3,
                  canary_fraction=fraction)
    rel = pkg.reload.CanaryReloader(eng, eng.scfg)
    try:
        actions = [rel.poll()]
        h1 = eng.incumbent_hash
        slot = pkg.promote.promoted_path(str(svc))
        pkg.promote.promote_checkpoint(stack["ckpt2"], slot)
        h2 = pkg.promote.candidate_hash(slot)
        _ledger(pkg, svc).log("gate", attempt=2, promoted=True,
                              candidate_hash=h2)
        actions.append(rel.poll())
        states = [(eng.canary_hash == h2, eng.incumbent_hash == h1)]
        actions.append(rel.poll())
        flags = []
        for i in range(8):
            t = eng.submit(*_req(stack, i), deadline_ms=0)
            assert t.wait(60) and t.ok, t.error
            flags.append(t.canary)
        states.append((eng.incumbent_hash == h2, eng.canary_hash is None))
        actions.append(rel.poll())
        return {"actions": actions, "states": states, "flags": flags,
                "events": [e["event"] for e in _events(svc)],
                "reloads": eng.stats()["reloads"],
                "traces": eng.trace_count}
    finally:
        eng.close()


@pytest.mark.parametrize("fraction", [1.0, 0.5])
def test_reload_canary_serves_fraction_then_promotes(stack, tmp_path,
                                                     fraction):
    ours, ref = _both(
        tmp_path, lambda p, s, d: _canary_then_promote(p, s, d, fraction),
        stack)
    assert ours == ref
    assert ours["actions"] == ["unchanged", "canary-started",
                               "canary-in-flight", "unchanged"]
    assert ours["events"] == ["reload_canary", "reload_promoted"]
    assert ours["traces"] == 3  # the reload prepared nothing new
    assert sum(ours["flags"]) == 3


def _never_backwards(pkg, stack, svc):
    eng = _engine(pkg, stack, svc, canary_requests=0, reload_tolerance=1e9)
    rel = pkg.reload.CanaryReloader(eng, eng.scfg)
    try:
        slot = pkg.promote.promoted_path(str(svc))
        h1 = eng.incumbent_hash
        pkg.promote.promote_checkpoint(stack["ckpt2"], slot)
        actions = [rel.poll()]
        h2 = pkg.promote.candidate_hash(slot)
        _ledger(pkg, svc).log("gate", attempt=2, promoted=True,
                              candidate_hash=h2)
        actions.append(rel.poll())
        inc = [eng.incumbent_hash == h2]
        pkg.promote.promote_checkpoint(stack["ckpt"], slot)
        actions += [rel.poll(), rel.poll()]
        inc.append(h1 not in eng.bad_hashes)
        _ledger(pkg, svc).log("gate", attempt=3, promoted=True,
                              candidate_hash=h1)
        actions.append(rel.poll())
        inc.append(eng.incumbent_hash == h1)
        return {"actions": actions, "inc": inc,
                "events": [e["event"] for e in _events(svc)],
                "seqs": [e.get("seq") for e in _events(svc)],
                "traces": eng.trace_count}
    finally:
        eng.close()


def test_reload_never_moves_backwards_and_defers_unledgered(stack,
                                                            tmp_path):
    ours, ref = _both(tmp_path, _never_backwards, stack)
    assert ours == ref
    assert ours["actions"] == ["deferred-unledgered", "canary-started",
                               "refused-stale", "unchanged",
                               "canary-started"]
    assert all(ours["inc"])


def _incompatible(pkg, stack, svc):
    eng = _engine(pkg, stack, svc)
    rel = pkg.reload.CanaryReloader(eng, eng.scfg)
    try:
        h1 = eng.incumbent_hash
        wrong = str(svc / "wrong_shape.pkl")
        with open(stack["ckpt"], "rb") as f:
            ckpt = pickle.loads(f.read())
        with open(wrong, "wb") as f:
            pickle.dump({"params": {k: np.zeros((3, 3), np.float32)
                                    for k in ("w1", "w2")},
                         "extra": dict(ckpt.get("extra", {}),
                                       branch_sources=None)}, f)
        slot = pkg.promote.promoted_path(str(svc))
        pkg.promote.promote_checkpoint(wrong, slot)
        _ledger(pkg, svc).log("gate", attempt=2, promoted=True,
                              candidate_hash=pkg.promote.candidate_hash(
                                  slot))
        actions = [rel.poll()]
        ok = [eng.incumbent_hash == h1,
              pkg.promote.candidate_hash(wrong) in eng.bad_hashes]
        actions.append(rel.poll())
        t = eng.submit(*_req(stack), deadline_ms=0)
        ok.append(t.wait(60) and t.ok)
        rows = _events(svc, "reload_rejected")
        return {"actions": actions, "ok": ok, "n": len(rows),
                "why": "smoke eval raised" in rows[0]["reason"]}
    finally:
        eng.close()


def test_reload_rejects_incompatible_tree_and_blacklists(stack, tmp_path):
    ours, ref = _both(tmp_path, _incompatible, stack)
    assert ours == ref
    assert ours["actions"] == ["rejected-smoke-error", "unchanged"]
    assert all(ours["ok"]) and ours["n"] == 1 and ours["why"]


def _corrupt(pkg, stack, svc):
    eng = _engine(pkg, stack, svc)
    rel = pkg.reload.CanaryReloader(eng, eng.scfg)
    try:
        h1 = eng.incumbent_hash
        slot = pkg.promote.promoted_path(str(svc))
        with open(stack["ckpt2"], "rb") as f:
            torn = f.read()[:300]
        with open(slot, "wb") as f:
            f.write(torn)
        _ledger(pkg, svc).log("gate", attempt=2, promoted=True,
                              candidate_hash=pkg.promote.candidate_hash(
                                  slot))
        actions = [rel.poll(), rel.poll()]
        t = eng.submit(*_req(stack), deadline_ms=0)
        return {"actions": actions, "inc": eng.incumbent_hash == h1,
                "ok": t.wait(60) and t.ok,
                "events": [e["event"] for e in _events(svc)]}
    finally:
        eng.close()


def test_reload_rejects_corrupt_slot_and_keeps_serving(stack, tmp_path):
    ours, ref = _both(tmp_path, _corrupt, stack)
    assert ours == ref
    assert ours["actions"] == ["rejected-integrity", "unchanged"]
    assert ours["events"] == ["reload_rejected"]


def _digest(eng):
    if hasattr(eng, "_models"):
        state = eng.model.state_dict()
        return hashlib.blake2b(pickle.dumps(
            {k: v.numpy() for k, v in state.items()})).hexdigest()
    host = eng._jax.tree_util.tree_map(np.asarray, eng._incumbent.params)
    return hashlib.blake2b(pickle.dumps(host)).hexdigest()


def _poison(pkg, stack, svc):
    faults = pkg.FaultPlan.parse("poison_reload=1")
    eng = _engine(pkg, stack, svc, faults=faults)
    rel = pkg.reload.CanaryReloader(eng, eng.scfg, faults=faults)
    try:
        before = _digest(eng)
        t0 = eng.submit(*_req(stack), deadline_ms=0)
        assert t0.wait(60) and t0.ok
        slot = pkg.promote.promoted_path(str(svc))
        pkg.promote.promote_checkpoint(stack["ckpt2"], slot)
        _ledger(pkg, svc).log("gate", attempt=2, promoted=True,
                              candidate_hash=pkg.promote.candidate_hash(
                                  slot))
        action = rel.poll()
        t1 = eng.submit(*_req(stack), deadline_ms=0)
        assert t1.wait(60) and t1.ok
        rows = _events(svc, "reload_rollback")
        return {"action": action, "same_params": _digest(eng) == before,
                "same_answer": np.array_equal(t0.pred, t1.pred),
                "rows": len(rows), "why": "non-finite" in rows[0]["reason"],
                "slot_intact": pkg.promote.candidate_hash(slot)
                == pkg.promote.candidate_hash(stack["ckpt2"]),
                "reloads": eng.stats()["reloads"],
                "traces": eng.trace_count}
    finally:
        eng.close()


def test_poison_reload_rolls_back_incumbent_bit_identical(stack, tmp_path):
    ours, ref = _both(tmp_path, _poison, stack)
    assert ours == ref
    assert ours["action"] == "rejected-smoke"
    assert ours["same_params"] and ours["same_answer"]
    assert ours["reloads"] == {"promoted": 0, "rolled_back": 1}


def _flood(pkg, stack, svc):
    eng = _engine(pkg, stack, svc, max_queue=8, deadline_ms=0)
    try:
        tickets = [eng.submit(*_req(stack, i)) for i in range(80)]
        for t in tickets:
            assert t.wait(60), "request hung under flood"
        outcomes = {t.outcome for t in tickets}
        shed = sum(t.outcome == pkg.batcher.SHED_QUEUE_FULL
                   for t in tickets)
        typed = outcomes <= ({pkg.batcher.OK}
                             | set(pkg.batcher.SHED_OUTCOMES))
        return {"typed": typed, "shed": shed > 0,
                "served": any(t.ok for t in tickets),
                "counted": eng.stats()["outcomes"].get(
                    pkg.batcher.SHED_QUEUE_FULL) == shed,
                "traces": eng.trace_count}
    finally:
        eng.close()


def test_flood_10x_all_typed(stack, tmp_path):
    ours, ref = _both(tmp_path, _flood, stack)
    assert ours == ref == {"typed": True, "shed": True, "served": True,
                           "counted": True, "traces": 3}


def _slow(pkg, stack, svc):
    eng = _engine(pkg, stack, svc, max_queue=16, deadline_ms=120.0,
                  faults=pkg.FaultPlan.parse("slow_request=2,"
                                             "slow_secs=0.5"))
    try:
        tickets = [eng.submit(*_req(stack, i)) for i in range(12)]
        for t in tickets:
            assert t.wait(60), "request hung behind the slow batch"
        outcomes = {t.outcome for t in tickets}
        return {"typed": outcomes <= {pkg.batcher.OK,
                                      pkg.batcher.SHED_DEADLINE},
                "shed": pkg.batcher.SHED_DEADLINE in outcomes,
                "served": any(t.ok for t in tickets)}
    finally:
        eng.close()


def test_slow_request_sheds_by_deadline(stack, tmp_path):
    ours, ref = _both(tmp_path, _slow, stack)
    assert ours == ref == {"typed": True, "shed": True, "served": True}


def _canary_nonfinite(pkg, stack, svc):
    """A canary that passes the smoke eval but answers non-finite on a
    live window: rolled back, the batch served again on the
    incumbent."""
    eng = _engine(pkg, stack, svc, canary_requests=4, canary_fraction=1.0)
    try:
        good = eng.submit(*_req(stack), deadline_ms=0)
        assert good.wait(60) and good.ok
        from mpgcn_tpu_torch.utils.convert import read_checkpoint

        cand = read_checkpoint(stack["ckpt2"])["params"]
        eng.install_canary(cand, "cand", 5, probe_loss=0.0)
        # a window that overflows only inside the canary's rollout is
        # hard to build; poison its weights after the placement instead
        if pkg.name == "port":
            with torch.no_grad():
                for p in eng._models[eng._canary.slot].parameters():
                    p.fill_(float("nan"))
        else:
            nan = eng._jax.tree_util.tree_map(
                lambda a: a * np.float32(np.nan), eng._canary.params)
            eng._canary.params = nan
        t = eng.submit(*_req(stack), deadline_ms=0)
        assert t.wait(60)
        return {"outcome": t.outcome, "canary": t.canary,
                "same": np.array_equal(t.pred, good.pred),
                "canary_left": eng.canary_hash,
                "bad": "cand" in eng.bad_hashes,
                "events": [e["event"] for e in _events(svc)],
                "reloads": eng.stats()["reloads"]}
    finally:
        eng.close()


def test_nonfinite_canary_rolls_back_and_reserves_on_incumbent(stack,
                                                               tmp_path):
    ours, ref = _both(tmp_path, _canary_nonfinite, stack)
    assert ours == ref
    assert ours["outcome"] == "ok" and ours["canary"] is False
    assert ours["same"] and ours["canary_left"] is None and ours["bad"]
    assert ours["events"] == ["reload_rollback"]


@pytest.mark.parametrize("pkg_name", PKGS)
def test_reloader_poll_loop_starts_and_stops(stack, tmp_path, pkg_name):
    pkg = _pkg(pkg_name)
    eng = _engine(pkg, stack, tmp_path, reload_poll_secs=0.01)
    rel = pkg.reload.CanaryReloader(eng, eng.scfg)
    try:
        rel.start()
        slot = pkg.promote.promoted_path(str(tmp_path))
        pkg.promote.promote_checkpoint(stack["ckpt2"], slot)
        h2 = pkg.promote.candidate_hash(slot)
        _ledger(pkg, tmp_path).log("gate", attempt=2, promoted=True,
                                   candidate_hash=h2)
        import time

        t0 = time.time()
        while eng.canary_hash != h2 and time.time() - t0 < 30:
            time.sleep(0.01)
        assert eng.canary_hash == h2
    finally:
        rel.stop()
        eng.close()


# --- the promotion gate ----------------------------------------------------------


def test_evaluate_params_scores_as_the_jax_gate(stack):
    """``evaluate_params`` over the port's ModelTrainer against the JAX
    one over the JAX trainer, the same weights (the stack's checkpoint)
    on the test split: the eval loss and the rollout RMSE to 1e-4."""
    from mpgcn_tpu_torch.train.trainer import ModelTrainer as PortTrainer

    jtr = ModelTrainer(stack["jcfg"].replace(pred_len=1), stack["data"])
    jtr.load_trained(stack["ckpt"])
    ref = jax_promote.evaluate_params(jtr)
    ptr = PortTrainer(stack["cfg"], stack["data"], device="cpu")
    ptr.load_trained(stack["ckpt"])
    ours = promote.evaluate_params(ptr)
    assert set(ours) == set(ref) == {"loss", "rmse"}
    for k in ours:
        np.testing.assert_allclose(ours[k], ref[k], **TOL)


@pytest.mark.parametrize("cand,inc,tol,enabled", [
    ({"loss": 1.0}, None, 0.0, True),
    ({"loss": float("nan")}, {"loss": 1.0}, 0.0, True),
    (None, {"loss": 1.0}, 0.0, True),
    ({"loss": 1.05}, {"loss": 1.0}, 0.1, True),
    ({"loss": 1.2}, {"loss": 1.0}, 0.1, True),
    ({"loss": 1.0}, {"loss": float("inf")}, 0.0, True),
    ({"loss": float("nan")}, {"loss": 1.0}, 0.0, False)])
def test_promotion_gate_decides_as_jax(cand, inc, tol, enabled):
    assert promote.PromotionGate(tol, enabled).decide(cand, inc) == \
        jax_promote.PromotionGate(tol, enabled).decide(cand, inc)
    with pytest.raises(ValueError):
        promote.PromotionGate(-1.0)
    assert promote.rejected_path("o", 3) == jax_promote.rejected_path("o", 3)
    assert promote.promoted_dir("o") == jax_promote.promoted_dir("o")
