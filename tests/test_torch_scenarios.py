"""The port's scenario engine (scenarios/profiles.py, dynamics.py,
transfer.py, federation.py, cli.py, and ``--profile`` on ``daemon`` and
``fleet add``) against the JAX package's, on the CPU:

  (a) every built-in profile generates byte-identical od, adj and POI
      arrays with equal measured statistics; the profile checks and the
      statistics contract refuse what the JAX ones refuse, with the same
      message; spools, the drifts and the signatures byte-identical;
  (b) donor similarity, ranking and selection equal;
  (c) ``provision`` writes the same registry fields and the same spools;
      ``tenant_summary`` and ``federation_report`` equal on a root the JAX
      federation wrote and on one the port's wrote; ``scenario list`` and
      ``gen`` print and write the same; a tiny ``scenario run`` reports
      the JAX keys;
  (d) ``transfer_ab`` from the same JAX init and donor: equal steps to
      promote, the warm arm's validation losses to rtol 1e-4;
  (e) ``scenario run`` and ``transfer_ab`` refuse without a card unless
      asked for the CPU.

Size: the profiles' own N=20 and obs 5; hidden 8; 1-2 epochs.
"""

import contextlib
import io
import json
import math
import os

import jax
import numpy as np
import pytest
import torch

from mpgcn_tpu.nn.mpgcn import init_mpgcn
from mpgcn_tpu.scenarios import cli as jax_scn_cli
from mpgcn_tpu.scenarios import dynamics as jax_dyn
from mpgcn_tpu.scenarios import federation as jax_fed
from mpgcn_tpu.scenarios import profiles as jax_prof
from mpgcn_tpu.scenarios import transfer as jax_transfer
from mpgcn_tpu.service import registry as jax_registry
from mpgcn_tpu_torch.scenarios import cli as scn_cli
from mpgcn_tpu_torch.scenarios import dynamics as dyn
from mpgcn_tpu_torch.scenarios import federation as fed
from mpgcn_tpu_torch.scenarios import profiles as prof
from mpgcn_tpu_torch.scenarios import transfer
from mpgcn_tpu_torch.service import registry
from mpgcn_tpu_torch.utils.convert import params_from_jax
from mpgcn_tpu_torch.utils.logging import read_events

torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

NAMES = ("bike-harbor", "metro-loop", "taxi-midtown", "taxi-riverside")
LOSS_RTOL = 1e-4


def _same_bytes(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape \
        and a.tobytes() == b.tobytes()


# --- (a) profiles and their data ---------------------------------------------


def test_registry_and_profile_fields_match_jax():
    assert prof.list_profiles() == jax_prof.list_profiles() == sorted(NAMES)
    assert prof.MODALITIES == jax_prof.MODALITIES
    for name in NAMES:
        p, j = prof.get_profile(name), jax_prof.get_profile(name)
        assert p.describe() == j.describe()
        assert p.model_kwargs() == j.model_kwargs()
        assert p.folded_seed == j.folded_seed
    with pytest.raises(KeyError, match="unknown scenario profile"):
        prof.get_profile("atlantis")
    with pytest.raises(ValueError, match="already registered"):
        prof.register_profile(prof.get_profile("metro-loop"))


@pytest.mark.parametrize("name", NAMES)
def test_generate_is_byte_identical(name):
    ours = prof.generate(prof.get_profile(name))
    ref = jax_prof.generate(jax_prof.get_profile(name))
    for key in ("od", "adj", "poi"):
        assert _same_bytes(ours[key], ref[key]), key
    assert ours["stats"] == ref["stats"]
    assert prof.measured_stats(ours["od"], ours["adj"]) == \
        jax_prof.measured_stats(ref["od"], ref["adj"])
    # prefix-stable: a shorter draw is the longer one's head
    assert _same_bytes(prof.scenario_od(prof.get_profile(name), days=20),
                       ours["od"][:20])


BAD_PROFILES = [dict(modality="ferry"), dict(num_nodes=4),
                dict(density=0.05), dict(density=1.5),
                dict(degree_skew=0.5), dict(peak_sharpness=0.9),
                dict(flow_scale=0.0), dict(days=6), dict(horizon=0)]


@pytest.mark.parametrize("bad", BAD_PROFILES,
                         ids=lambda d: "-".join(f"{k}={v}"
                                                for k, v in d.items()))
def test_profile_checks_refuse_as_jax(bad):
    kw = {"name": "x", "city": "y", "modality": "taxi", **bad}
    msgs = []
    for mod in (prof, jax_prof):
        with pytest.raises(ValueError) as e:
            mod.ScenarioProfile(**kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("override", [dict(density=0.6),
                                      dict(degree_skew=4.0),
                                      dict(peak_sharpness=6.0)])
def test_validate_stats_refuses_as_jax(override):
    """A contract the generator cannot meet: both raise ProfileStatsError
    with the same message, on the same data."""
    base = jax_prof.get_profile("taxi-midtown")
    data = jax_prof.generate(base, validate=False)
    msgs = []
    for mod in (prof, jax_prof):
        p = mod.get_profile("taxi-midtown").replace(**override)
        with pytest.raises(mod.ProfileStatsError) as e:
            mod.validate_stats(p, data["od"], data["adj"])
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_write_spool_rounds_are_byte_identical(tmp_path):
    for pkg, mod in (("port", prof), ("jax", jax_prof)):
        p = mod.get_profile("bike-harbor")
        d = str(tmp_path / pkg)
        mod.write_spool(p, d, days=6)
        mod.write_spool(p, d, days=4, start_day=6)
        with pytest.raises(ValueError, match="different adjacency"):
            mod.write_spool(mod.get_profile("metro-loop"), d, days=1)
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax"))
    assert len(names) == 11  # 10 days + adjacency
    for f in names:
        assert (tmp_path / "port" / f).read_bytes() == \
            (tmp_path / "jax" / f).read_bytes(), f


@pytest.mark.parametrize("case", ["signature", "weights", "shift",
                                  "ramp", "mix"])
def test_drifts_are_byte_identical(case):
    p, j = (m.get_profile("taxi-midtown") for m in (prof, jax_prof))
    ours, ref = {
        "signature": lambda: (dyn.signature_multipliers("bike", 40, 1.7),
                              jax_dyn.signature_multipliers("bike", 40,
                                                            1.7)),
        "weights": lambda: (dyn.shift_weights(30, 9, 5),
                            jax_dyn.shift_weights(30, 9, 5)),
        "shift": lambda: (dyn.regime_shift_od(p, days=40),
                          jax_dyn.regime_shift_od(j, days=40)),
        "ramp": lambda: (dyn.regime_shift_od(p, days=40, shift_day=10,
                                             to_modality="bike",
                                             ramp_days=7),
                         jax_dyn.regime_shift_od(j, days=40, shift_day=10,
                                                 to_modality="bike",
                                                 ramp_days=7)),
        "mix": lambda: (dyn.modality_mix_od(p, days=30),
                        jax_dyn.modality_mix_od(j, days=30)),
    }[case]()
    assert _same_bytes(ours, ref)
    if case == "shift":  # the profile's own draw before the shift
        assert _same_bytes(ours[:20], prof.scenario_od(p, days=40)[:20])
    with pytest.raises(ValueError, match="is not one of"):
        dyn.signature_multipliers("ferry", 7)


# --- (b) donors ---------------------------------------------------------------


def test_donor_selection_matches_jax():
    for t in NAMES:
        pt, jt = prof.get_profile(t), jax_prof.get_profile(t)
        for c in NAMES:
            assert transfer.profile_similarity(pt, prof.get_profile(c)) == \
                jax_transfer.profile_similarity(jt, jax_prof.get_profile(c))
        ours = [(s, p.name) for s, p in transfer.rank_donors(pt, NAMES)]
        ref = [(s, p.name) for s, p in jax_transfer.rank_donors(jt, NAMES)]
        assert ours == ref
        assert transfer.select_donor(pt, list(NAMES)).name == \
            jax_transfer.select_donor(jt, list(NAMES)).name
    assert transfer.select_donor(prof.get_profile("metro-loop"), []) is None
    tgt = prof.get_profile("taxi-riverside")
    big = prof.get_profile("taxi-midtown").replace(name="taxi-big",
                                                   num_nodes=40)
    assert transfer.profile_similarity(tgt, prof.get_profile(
        "taxi-midtown")) > transfer.profile_similarity(tgt, big)


# --- (c) the federation ---------------------------------------------------------


def _entries(root, mod):
    reg = mod.TenantRegistry.load(root)
    return {t: {k: v for k, v in e.items() if k not in ("root", "added_at")}
            for t, e in reg.tenants.items()}


def test_provision_matches_jax(tmp_path):
    roots = {}
    for pkg, fmod, rmod in (("port", fed, registry),
                            ("jax", jax_fed, jax_registry)):
        root = str(tmp_path / pkg)
        rmod.TenantRegistry.load(root).add("taxi-midtown")  # no metadata
        out = fmod.provision(root, ["taxi-midtown", "metro-loop"], days=5)
        assert sorted(out) == ["metro-loop", "taxi-midtown"]
        fmod.provision(root, ["metro-loop"], days=2, start_day=5)
        roots[pkg] = root
    assert _entries(roots["port"], registry) == \
        _entries(roots["jax"], jax_registry)
    for tid in ("taxi-midtown", "metro-loop"):
        a = os.path.join(roots["port"], "tenants", tid, "spool")
        b = os.path.join(roots["jax"], "tenants", tid, "spool")
        assert sorted(os.listdir(a)) == sorted(os.listdir(b))
        for f in os.listdir(a):
            with open(os.path.join(a, f), "rb") as x, \
                    open(os.path.join(b, f), "rb") as y:
                assert x.read() == y.read(), (tid, f)
    small = dict(name="tmp-n12-city", city="x", modality="taxi",
                 num_nodes=12, days=30)
    msgs = []
    for pkg, fmod, pmod in (("port", fed, prof), ("jax", jax_fed, jax_prof)):
        with pytest.raises(ValueError, match="shape-compatible") as e:
            fmod.provision(roots[pkg], [pmod.ScenarioProfile(**small)],
                           days=3)
        msgs.append(str(e.value).replace(roots[pkg], "ROOT"))
    assert msgs[0] == msgs[1]


def test_last_retrain_steps_reads_the_newest_attempt(tmp_path):
    from mpgcn_tpu_torch.utils.logging import JsonlLogger, run_log_path

    for attempt, (spe, n_epochs) in (("a9", (7, 1)), ("a10", (5, 3))):
        d = tmp_path / "retrain" / attempt
        d.mkdir(parents=True)
        log = JsonlLogger(run_log_path(str(d), "MPGCN", True))
        log.log("train_start", steps_per_epoch=spe)
        for e in range(n_epochs):
            log.log("epoch", epoch=e)
    assert fed._last_retrain_steps(str(tmp_path)) == \
        jax_fed._last_retrain_steps(str(tmp_path)) == 15


#: a federation of two tenants at the size of tests/test_scenarios.py's
RUN_ARGS = ["--profiles", "taxi-midtown,metro-loop", "--days", "30",
            "--window-days", "30", "-epoch", "1", "-hidden", "8", "--json"]


def _run_cli(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def _report(out: str) -> dict:
    lines = out.splitlines()
    start = max(i for i, x in enumerate(lines) if x.startswith("{"))
    return json.loads("\n".join(lines[start:]))


def _keys(d):
    return {k: _keys(v) for k, v in d.items()} if isinstance(d, dict) \
        else type(d).__name__ if d is not None else None


@pytest.fixture(scope="module")
def fed_roots(tmp_path_factory):
    """A JAX federation root and a port one (CPU), each from `scenario
    run` over the same two profiles; with their printed reports."""
    base = tmp_path_factory.mktemp("torch_fed")
    out = {}
    for pkg, main, extra in (("jax", jax_scn_cli.main, []),
                             ("port", scn_cli.main, ["--device", "cpu"])):
        root = str(base / pkg)
        rc, text = _run_cli(main, ["run", "-out", root] + RUN_ARGS + extra)
        assert rc == 0
        out[pkg] = (root, _report(text))
    return out


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_federation_report_equal_on_each_root(fed_roots, writer):
    root, printed = fed_roots[writer]
    ours, ref = fed.federation_report(root), jax_fed.federation_report(root)
    assert ours == ref == printed
    assert set(ours["tenants"]) == {"taxi-midtown", "metro-loop"}
    for tid in ours["tenants"]:
        troot = registry.TenantRegistry.load(root).tenant_root(tid)
        assert fed.tenant_summary(troot) == jax_fed.tenant_summary(troot)
        assert ours["tenants"][tid]["promoted"] >= 1
    assert fed.federation_report(str(os.path.dirname(root))) is None


def test_scenario_run_reports_the_jax_keys(fed_roots):
    assert _keys(fed_roots["port"][1]) == _keys(fed_roots["jax"][1])
    sec = fed_roots["port"][1]["tenants"]["metro-loop"]
    assert sec["modality"] == "metro" and sec["horizon"] == 6
    assert sec["steps_last_retrain"] > 0


def test_scenario_list_and_gen_match_jax(tmp_path):
    assert _run_cli(scn_cli.main, ["list"]) == \
        _run_cli(jax_scn_cli.main, ["list"])
    for pkg, main in (("port", scn_cli.main), ("jax", jax_scn_cli.main)):
        rc, text = _run_cli(main, ["gen", "-profile", "metro-loop", "-out",
                                   str(tmp_path / pkg), "--days", "5",
                                   "--start-day", "2"])
        assert rc == 0 and "wrote 5 day file(s)" in text
    files = sorted(os.listdir(tmp_path / "port"))
    assert files == sorted(os.listdir(tmp_path / "jax"))
    for f in files:
        assert (tmp_path / "port" / f).read_bytes() == \
            (tmp_path / "jax" / f).read_bytes()


def test_fleet_add_profile_stamps_the_jax_entry(tmp_path, capsys):
    from mpgcn_tpu_torch import cli

    with pytest.raises(SystemExit) as e:
        cli.main(["fleet", "add", "riv", "-out", str(tmp_path / "port"),
                  "--profile", "taxi-riverside"])
    assert e.value.code == 0
    assert jax_registry.main(["add", "riv", "-out", str(tmp_path / "jax"),
                              "--profile", "taxi-riverside"]) == 0
    assert _entries(str(tmp_path / "port"), registry) == \
        _entries(str(tmp_path / "jax"), jax_registry)
    assert "--profile taxi-riverside" in capsys.readouterr().out


def test_daemon_profile_sets_the_retrain_shape(tmp_path):
    """``daemon --profile metro-loop``: the retrains run at the profile's
    obs_len, horizon, N and folded seed."""
    from mpgcn_tpu_torch.service import daemon

    spool, out = str(tmp_path / "spool"), str(tmp_path / "svc")
    prof.write_spool(prof.get_profile("metro-loop"), spool, days=26)
    assert daemon.main(["--device", "cpu", "--profile", "metro-loop",
                        "-spool", spool, "-out", out, "-hidden", "8",
                        "-epoch", "1", "--window-days", "26",
                        "--val-days", "3", "--holdout-days", "4",
                        "--retrain-cadence", "4", "--idle-exits", "1",
                        "--poll-secs", "0"]) == 0
    p = prof.get_profile("metro-loop")
    starts = read_events(os.path.join(out, "retrain", "a1",
                                      "MPGCN_train_log.jsonl"),
                         "train_start")
    assert starts and starts[0]["num_nodes"] == p.num_nodes
    gates = read_events(os.path.join(out, "promoted", "promotions.jsonl"),
                        "gate")
    assert gates and gates[0]["promoted"]
    import pickle

    with open(os.path.join(out, "promoted", "MPGCN_od.pkl"), "rb") as f:
        cfg = pickle.load(f).get("extra", {})
    # the folded seed, or a dead-init retry's from it
    assert cfg.get("seed") in [p.folded_seed + k * 100003 for k in range(4)]


# --- (d) the transfer A/B -------------------------------------------------------


def _jax_init_into(tr):
    cfg = tr.cfg
    tree = init_mpgcn(
        jax.random.PRNGKey(cfg.seed), M=cfg.num_branches, K=cfg.support_K,
        input_dim=cfg.input_dim, lstm_hidden_dim=cfg.hidden_dim,
        lstm_num_layers=cfg.lstm_num_layers, gcn_hidden_dim=cfg.hidden_dim,
        gcn_num_layers=cfg.gcn_num_layers, use_bias=cfg.use_bias)
    tr.model.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, tree)))
    return tr


def test_transfer_ab_matches_jax(fed_roots, tmp_path, monkeypatch):
    """The same A/B on both packages from the same donor (the JAX
    federation's promoted taxi-midtown checkpoint), the port's arms from
    the JAX init: the scratch arms' best losses set the same bar, both
    arms cross it at the same step, and the warm arm's validation losses
    agree to rtol 1e-4."""
    donor = os.path.join(fed_roots["jax"][0], "tenants", "taxi-midtown",
                         "promoted", "MPGCN_od.pkl")
    made = transfer.build_target_trainer
    monkeypatch.setattr(transfer, "build_target_trainer",
                        lambda *a, **k: _jax_init_into(made(*a, **k)))
    kw = dict(days=30, epochs=3, hidden_dim=8)
    ours = transfer.transfer_ab("taxi-riverside", donor,
                                str(tmp_path / "port"), device="cpu", **kw)
    ref = jax_transfer.transfer_ab("taxi-riverside", donor,
                                   str(tmp_path / "jax"), **kw)
    for key in ("warm_steps_to_promote", "scratch_steps_to_promote",
                "steps_per_epoch", "warm_vs_scratch", "target"):
        assert ours[key] == ref[key], key
    assert math.isclose(ours["bar_val_loss"], ref["bar_val_loss"],
                        rel_tol=LOSS_RTOL)
    for arm in ("warm", "scratch"):
        a, b = (read_events(str(tmp_path / pkg / arm /
                                "MPGCN_train_log.jsonl"), "epoch")
                for pkg in ("port", "jax"))
        assert len(a) == len(b) == 3
        for x, y in zip(a, b):
            assert math.isclose(x["validate_loss"], y["validate_loss"],
                                rel_tol=LOSS_RTOL), (arm, x, y)


# --- (e) the card ---------------------------------------------------------------


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a box "
                    "without a card")
def test_run_and_transfer_refuse_without_the_card(tmp_path):
    with pytest.raises(SystemExit, match="scenario run: device 'cuda'"):
        scn_cli.main(["run", "-out", str(tmp_path), "--profiles",
                      "metro-loop"])
    assert not os.path.exists(tmp_path / "fleet")  # nothing provisioned
    with pytest.raises(RuntimeError, match="device='cpu'"):
        transfer.transfer_ab("taxi-riverside", str(tmp_path / "x.pkl"),
                             str(tmp_path / "ab"))
    assert not os.path.exists(tmp_path / "ab")
