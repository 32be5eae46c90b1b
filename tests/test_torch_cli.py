"""The port's reference command against the JAX package's, on the CPU: the
npz loader and the normalizers' state, the data-file read retries, the
CLI's flags, the config and data each CLI hands its trainer, checkpoints
trained by one CLI and tested by the other, and the optimizer's clip and
learning-rate schedules against the optax chain.

Every data file is written by the tests from the seeded generators, in
the reference's file layout (``od_day20180101_20210228.npz`` holding one
row of 47 x 47 counts a day, ``adjacency_matrix.npy``, and a POI file).
N = 47 wherever the npz forces it; hidden 8.

Where the data dicts are compared byte for byte both sides build their
dynamic graphs with ``native_host='off'`` (the numpy day-of-week mean):
the C++ mean sums in float64 in another order and differs in the last
bit (checked below to 1e-12, port against JAX, both native).

Tolerances: the data dicts byte for byte; the test-mode scores of one
checkpoint in the two CLIs rtol 1e-4 (7 autoregressive f32 steps, other
summation orders); the optimizer's parameters rtol 1e-5 / atol 1e-6 after
20 steps, as the Adam test of tests/test_torch_train.py holds them.
"""

import dataclasses
import os
import shutil

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import scipy.sparse as ss
import torch

import mpgcn_tpu.train
from mpgcn_tpu import cli as jax_cli
from mpgcn_tpu.config import MPGCNConfig as JaxConfig
from mpgcn_tpu.data import loader as jax_loader
from mpgcn_tpu.train import metrics as jax_metrics
from mpgcn_tpu.train.objectives import make_optimizer as jax_optimizer
from mpgcn_tpu_torch import cli
from mpgcn_tpu_torch.config import MPGCNConfig
from mpgcn_tpu_torch.data import loader
from mpgcn_tpu_torch.data.loader import (
    ADJ_NAME,
    NPZ_NAME,
    POI_FEAT_NAME,
    POI_SIM_NAME,
    REFERENCE_DAYS,
    load_dataset,
    poi_cosine_similarity,
    synthetic_adjacency,
    synthetic_od,
    synthetic_poi_features,
)
from mpgcn_tpu_torch.train import trainer as port_trainer
from mpgcn_tpu_torch.train.objectives import (
    clip_by_global_norm_,
    make_optimizer,
)
from mpgcn_tpu_torch.train.predict import graphs_for
from mpgcn_tpu_torch.utils.convert import read_checkpoint
from mpgcn_tpu_torch.utils.retry import read_with_retry

# each pytest-xdist worker takes its share of the cores: torch's default
# of one intra-op thread per core, in every worker at once, oversubscribes
# the machine
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

N = 47
#: the init seed of both checkpoint runs: at hidden 8, M = 3 on the
#: 60-day tree it leaves every branch's head live in both packages' inits
INIT_SEED = 10
SCORE_TOL = dict(rtol=1e-4, atol=0)
PARAM_TOL = dict(rtol=1e-5, atol=1e-6)
JAX_FLAGS = ["-no-obs", "-native", "off"]


def write_tree(path, T, poi=None, npz=True):
    """The reference's data directory at ``path``: the OD npz of T days
    (``synthetic_od(T, 47, seed 0)``), the adjacency, and a POI file
    (``poi`` = 'sim' or 'feat'; drawn from seeds the synthetic fallback
    does not use, so a file that was read shows)."""
    os.makedirs(path, exist_ok=True)
    if npz:
        od = synthetic_od(T, N, 0)
        ss.save_npz(os.path.join(path, NPZ_NAME),
                    ss.csr_matrix(od.reshape(T, N * N)))
    np.save(os.path.join(path, ADJ_NAME), synthetic_adjacency(N, 0))
    if poi == "sim":
        np.save(os.path.join(path, POI_SIM_NAME),
                poi_cosine_similarity(synthetic_poi_features(N, seed=5)))
    elif poi == "feat":
        np.save(os.path.join(path, POI_FEAT_NAME),
                synthetic_poi_features(N, seed=7))
    return str(path)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("trees")
    return {
        "plain": write_tree(root / "plain", 440),
        "sim": write_tree(root / "sim", 440, poi="sim"),
        "feat": write_tree(root / "feat", 440, poi="feat"),
        "no_npz": write_tree(root / "no_npz", 440, poi="feat", npz=False),
        "short": write_tree(root / "short", 60, poi="feat"),
    }


def assert_same_data(ours: dict, ref: dict):
    assert set(ours) == set(ref) == {"OD", "adj", "O_dyn_G", "D_dyn_G",
                                     "poi_sim"}
    for k, r in ref.items():
        if r is None:
            assert ours[k] is None, k
            continue
        o = np.asarray(ours[k])
        r = np.asarray(r)
        assert (o.dtype, o.shape) == (r.dtype, r.shape), k
        assert o.tobytes() == r.tobytes(), k


# --- the loader -----------------------------------------------------------

LOADER_CASES = {
    # id: (tree, config fields)
    "norm-none": ("plain", dict(data="npz")),
    "norm-minmax": ("plain", dict(data="npz", norm="minmax")),
    "norm-std": ("plain", dict(data="npz", norm="std")),
    "poi-similarity-file": ("sim", dict(data="npz", num_branches=3)),
    "poi-features-file": ("feat", dict(data="npz", num_branches=3)),
    "poi-absent": ("plain", dict(data="npz", num_branches=3)),
    "auto-with-npz": ("feat", dict(data="auto", num_branches=3)),
    # the POI file beside no npz is not read: the zones are synthetic
    "auto-without-npz": ("no_npz", dict(data="auto", num_branches=3,
                                        synthetic_N=8, synthetic_T=60)),
    "synthetic": ("feat", dict(data="synthetic", num_branches=3,
                               synthetic_N=8, synthetic_T=60)),
}


@pytest.mark.parametrize("case", list(LOADER_CASES))
def test_load_dataset_matches_jax(trees, case, capsys):
    tree, kw = LOADER_CASES[case]
    ours, di = load_dataset(MPGCNConfig(input_dir=trees[tree],
                                        native_host="off", **kw))
    ref, jdi = jax_loader.load_dataset(
        JaxConfig(input_dir=trees[tree], native_host="off", **kw))
    assert_same_data(ours, ref)
    assert di.normalizer.kind == jdi.normalizer.kind == kw.get("norm",
                                                               "none")
    assert di.normalizer.state() == jdi.normalizer.state()
    assert di._used_npz == (tree != "no_npz" and kw["data"] != "synthetic")
    out = capsys.readouterr().out
    # the reference's banner, as the JAX loader prints it
    T = REFERENCE_DAYS if di._used_npz else 60
    n = N if di._used_npz else 8
    assert f"({T}, {n}, {n}, 1)" in out
    assert ("using synthetic POI features" in out) == (case == "poi-absent")
    if di._used_npz:
        # the trailing 425 of the file's 440 days, log1p, normalized
        od = synthetic_od(440, N, 0)[-REFERENCE_DAYS:, ..., None]
        want = di.normalizer.normalize(np.log(od + 1.0))
        assert ours["OD"].tobytes() == want.tobytes()
    if case == "poi-similarity-file":
        np.testing.assert_array_equal(
            ours["poi_sim"], np.load(os.path.join(trees["sim"],
                                                  POI_SIM_NAME)))
    if case in ("poi-features-file", "auto-with-npz"):
        np.testing.assert_array_equal(
            ours["poi_sim"],
            poi_cosine_similarity(synthetic_poi_features(N, seed=7)))


def test_load_dataset_matches_jax_native_dow_mean(trees):
    """The JAX package's default C++ day-of-week mean: the same graphs to
    the last few bits."""
    cfg = dict(input_dir=trees["plain"], data="npz")
    ours, _ = load_dataset(MPGCNConfig(**cfg))
    ref, _ = jax_loader.load_dataset(JaxConfig(**cfg))
    for k in ("O_dyn_G", "D_dyn_G"):
        np.testing.assert_allclose(ours[k], ref[k], rtol=1e-12, atol=1e-12)
    assert ours["OD"].tobytes() == ref["OD"].tobytes()


def test_missing_npz_raises_naming_the_file(tmp_path):
    cfg = dict(input_dir=str(tmp_path), data="npz")
    errors = []
    for load, config in ((load_dataset, MPGCNConfig),
                         (jax_loader.load_dataset, JaxConfig)):
        with pytest.raises(IOError) as e:
            load(config(**cfg))
        errors.append(e.value)
    assert all(NPZ_NAME in str(e) for e in errors)
    assert type(errors[0]) is type(errors[1])


@pytest.mark.parametrize("kind", ["none", "minmax", "std"])
def test_normalizer_state_matches_jax(kind):
    x = np.log1p(np.random.default_rng(1).poisson(20.0, (30, 5, 5, 1))
                 .astype(np.float64))
    ours, ref = loader.make_normalizer(kind), jax_loader.make_normalizer(kind)
    z = ours.fit(x)
    assert z.tobytes() == ref.fit(x).tobytes()
    assert ours.kind == ref.kind == kind
    assert ours.state() == ref.state()
    assert ours.denormalize(z).tobytes() == ref.denormalize(z).tobytes()
    np.testing.assert_allclose(ours.denormalize(z), x, rtol=1e-12,
                               atol=1e-12)
    # a fresh normalizer loaded from the state inverts the same way
    fresh, jfresh = (loader.make_normalizer(kind),
                     jax_loader.make_normalizer(kind))
    fresh.load_state(ours.state())
    jfresh.load_state(ref.state())
    assert fresh.state() == jfresh.state() == ours.state()
    assert fresh.denormalize(z).tobytes() == jfresh.denormalize(z).tobytes()


# --- retries ---------------------------------------------------------------


def _flaky_load(monkeypatch, fails: int):
    """np.load that raises OSError on the adjacency's first ``fails``
    reads; returns the list of its adjacency calls."""
    real, calls = np.load, []

    def load(path, *a, **kw):
        if str(path).endswith(ADJ_NAME):
            calls.append(path)
            if len(calls) <= fails:
                raise OSError(5, "Input/output error")
        return real(path, *a, **kw)

    monkeypatch.setattr(np, "load", load)
    return calls


def test_read_retries_then_succeeds(trees, monkeypatch, capsys):
    calls = _flaky_load(monkeypatch, fails=2)
    data, _ = load_dataset(MPGCNConfig(input_dir=trees["plain"], data="npz",
                                       io_retry_delay_s=0.0))
    assert len(calls) == 3
    np.testing.assert_array_equal(data["adj"], synthetic_adjacency(N, 0))
    assert capsys.readouterr().out.count("WARNING: read of") == 2


def test_read_fails_naming_the_file(trees, monkeypatch):
    calls = _flaky_load(monkeypatch, fails=10**6)
    with pytest.raises(IOError, match=f"failed to read .*{ADJ_NAME} after "
                                      f"4 attempts"):
        load_dataset(MPGCNConfig(input_dir=trees["plain"], data="npz",
                                 io_retries=4, io_retry_delay_s=0.0))
    assert len(calls) == 4


def test_read_with_retry_backoff_and_permanent_errors(tmp_path):
    sleeps = []
    with pytest.raises(IOError, match="x.npy after 3 attempts"):
        read_with_retry(lambda: (_ for _ in ()).throw(OSError("flake")),
                        "x.npy", attempts=3, base_delay_s=0.5,
                        _sleep=sleeps.append)
    assert sleeps == [0.5, 1.0]
    missing = str(tmp_path / "missing.npy")
    with pytest.raises(FileNotFoundError):  # permanent: not retried
        read_with_retry(lambda: np.load(missing), missing,
                        _sleep=sleeps.append)
    assert sleeps == [0.5, 1.0]
    with pytest.raises(ValueError, match="attempts"):
        read_with_retry(lambda: 1, "x", attempts=0)


# --- the config and the parser ---------------------------------------------


def test_config_fields_match_jax_defaults_and_checks():
    ours, ref = MPGCNConfig(), JaxConfig()
    for f in dataclasses.fields(MPGCNConfig):
        assert getattr(ours, f.name) == getattr(ref, f.name), f.name
    for bad in (dict(time_slice=12), dict(io_retries=0),
                dict(io_retry_delay_s=-1.0), dict(data="csv"),
                dict(lr_schedule="linear")):
        with pytest.raises(ValueError):
            JaxConfig(**bad)
        with pytest.raises(ValueError):
            MPGCNConfig(**bad)
    d = {"hidden_dim": 8, "input_dir": "x", "no_such_field": 1}
    assert MPGCNConfig.from_dict(d) == MPGCNConfig(hidden_dim=8,
                                                   input_dir="x")


PORTED_FLAGS = ["-in", "-model", "-t", "-norm", "-split", "-nn", "-M",
                "-lstm-layers", "-sources", "-data", "-sprofile", "-lmax",
                "-clip", "-lrs", "-no-symnorm-clamp", "-iso", "-fix-dgraph",
                "-io-retries"]


@pytest.mark.parametrize("flag", PORTED_FLAGS)
def test_cli_flags_match_jax(flag):
    ours, ref = (next(a for a in p._actions if flag in a.option_strings)
                 for p in (cli.build_parser(), jax_cli.build_parser()))
    for attr in ("option_strings", "dest", "choices", "default", "nargs",
                 "const", "required"):
        assert getattr(ours, attr) == getattr(ref, attr), attr
    assert type(ours) is type(ref)
    if flag == "-lmax":  # a lambda on both sides: compare what it does
        for s in ("auto", "1.5"):
            assert ours.type(s) == ref.type(s)
    else:
        assert ours.type == ref.type


#: the city-scale feed's flags, each with a value to parse
FEED_FLAG_VALUES = {"-fused-epilogue": [], "-od-storage": ["sparse"],
                    "-no-stream": [], "-stream-chunk-mb": ["64"],
                    "-native": ["off"]}


@pytest.mark.parametrize("flag", list(FEED_FLAG_VALUES))
def test_feed_flags_parse_to_the_jax_config(flag):
    """Each flag: the same parser action as the JAX CLI's, and the same
    config field and value out of the two CLIs' config building (the
    port's ``config_from_args``; the JAX CLI's default-popping of
    ``stream_chunk_mb``)."""
    ours, ref = (next(a for a in p._actions if flag in a.option_strings)
                 for p in (cli.build_parser(), jax_cli.build_parser()))
    for attr in ("option_strings", "dest", "choices", "default", "nargs",
                 "const", "required", "type"):
        assert getattr(ours, attr) == getattr(ref, attr), attr
    assert type(ours) is type(ref)
    argv = [flag] + FEED_FLAG_VALUES[flag]
    args = cli.build_parser().parse_args(argv).__dict__
    cfg = cli.config_from_args(dict(args))
    jargs = jax_cli.build_parser().parse_args(argv).__dict__
    field = ours.dest
    assert getattr(cfg, field) == jargs[field] == getattr(
        JaxConfig(**{field: jargs[field]}), field)
    assert getattr(cfg, field) != getattr(MPGCNConfig(), field)
    # unset, the config default stands, as the JAX CLI leaves it
    unset = cli.config_from_args(dict(cli.build_parser().parse_args(
        []).__dict__))
    assert getattr(unset, field) == getattr(JaxConfig(), field)


def test_cli_runs_the_city_scale_feed_on_the_cpu(tmp_path, monkeypatch,
                                                 capsys):
    """-od-storage sparse -fused-epilogue -bdgcn csr with every mode on
    the stream executor (epoch_scan_max_mb forced to 0, which no flag
    sets in either CLI): one epoch, then the checkpoint's test-mode
    scores from the port CLI and from the JAX CLI agree."""
    real = cli.config_from_args
    monkeypatch.setattr(cli, "config_from_args", lambda args: real(
        args).replace(epoch_scan_max_mb=0.0))
    argv = ["-data", "synthetic", "-sN", "12", "-sT", "60", "-hidden", "8",
            "-od-storage", "sparse", "-fused-epilogue", "-bdgcn", "csr",
            "-stream-chunk-mb", "0.1", "-seed", str(INIT_SEED)]
    out = str(tmp_path / "port")
    hist = cli.main(argv + ["-GPU", "cpu", "-epoch", "1", "-out", out])
    printed = capsys.readouterr().out
    assert np.isfinite(hist["train"]).all()
    assert ("bdgcn_impl=csr (requested 'csr')" in printed
            and "od_storage=sparse" in printed
            and "fused_epilogue=on" in printed)
    assert "[dispatch] epoch_exec: train=stream(" in printed
    jax_out = str(tmp_path / "jax")
    os.makedirs(jax_out)
    shutil.copy(os.path.join(out, "MPGCN_od.pkl"), jax_out)
    cli.main(argv + ["-GPU", "cpu", "-mode", "test", "-out", out])
    jax_cli.main(argv + ["-mode", "test", "-out", jax_out] + JAX_FLAGS)
    _assert_scores_close(_score_lines(out), _score_lines(jax_out))


def test_cli_lstm_flag_keeps_the_ports_names():
    act = next(a for a in cli.build_parser()._actions
               if "-lstm" in a.option_strings)
    assert (act.dest, act.choices, act.default) == (
        "lstm_impl", ["auto", "kernel", "plain"], "auto")


class _Handed(Exception):
    """Raised by the recording trainers once they hold what the CLI handed
    them, so neither CLI goes on to train."""


def _recorders(monkeypatch):
    got = {}

    def port(cfg, data, device=None, lstm_impl=None, bdgcn_impl=None,
             data_container=None):
        got["port"] = dict(cfg=cfg, data=data, container=data_container,
                           lstm_impl=lstm_impl, device=device)
        raise _Handed

    def jax_(cfg, data, data_container=None, **kw):
        got["jax"] = dict(cfg=cfg, data=data, container=data_container)
        raise _Handed

    monkeypatch.setattr(port_trainer, "ModelTrainer", port)
    monkeypatch.setattr(mpgcn_tpu.train, "ModelTrainer", jax_)
    return got


def _run_both(argv, out):
    """Each CLI on ``argv``; returns what each raised (None if nothing)."""
    raised = []
    for main, extra in ((cli.main, ["-GPU", "cpu"] + JAX_FLAGS),
                        (jax_cli.main, JAX_FLAGS)):
        try:
            main(argv + ["-out", str(out)] + extra)
            raised.append(None)
        except _Handed:
            raised.append(None)
        except Exception as e:  # noqa: BLE001 - compared across the CLIs
            raised.append(e)
    return raised


SYN = ["-data", "synthetic", "-sN", "16", "-sT", "60"]
HANDED_CASES = {
    "M1": ["-M", "1"],
    "M3": ["-M", "3"],
    "sources": ["-sources", "static", "poi", "dynamic"],
    "nn2": ["-nn", "2"],
    "lstm-layers2": ["-lstm-layers", "2"],
    "split": ["-split", "7", "1", "2"],
    "lmax-auto-chebyshev": ["-lmax", "auto", "-kernel", "chebyshev"],
    "fix-dgraph": ["-fix-dgraph"],
    "no-symnorm-clamp": ["-no-symnorm-clamp"],
    "norm-std-test-mode": ["-norm", "std", "-mode", "test", "-pred", "3"],
    "realistic-selfloop": SYN + ["-sprofile", "realistic", "-iso",
                                 "selfloop"],
}


@pytest.mark.parametrize("case", list(HANDED_CASES))
def test_cli_hands_its_trainer_what_jax_does(trees, tmp_path, monkeypatch,
                                             case):
    got = _recorders(monkeypatch)
    argv = ["-in", trees["feat"], "-hidden", "8"] + HANDED_CASES[case]
    assert _run_both(argv, tmp_path) == [None, None]
    ours, ref = got["port"], got["jax"]
    for f in dataclasses.fields(MPGCNConfig):
        assert getattr(ours["cfg"], f.name) == getattr(ref["cfg"],
                                                       f.name), f.name
    assert ours["cfg"].num_nodes == (16 if case.startswith("realistic")
                                     else N)
    assert_same_data(ours["data"], ref["data"])
    assert (ours["container"].normalizer.state()
            == ref["container"].normalizer.state())
    assert ours["lstm_impl"] == "kernel" and ours["device"].type == "cpu"


@pytest.mark.parametrize("argv,match", [
    (SYN + ["-sprofile", "realistic", "-iso", "error"],
     "O-correlation graphs has zero-degree or non-finite node row"),
    (["-t", "12"], "time_slice has no effect"),
    (["-M", "2", "-sources", "static"], "branch_sources has 1 entries"),
])
def test_cli_fails_where_jax_fails(trees, tmp_path, argv, match):
    """The real trainers (no recorder): both CLIs raise the same error
    before any training step."""
    raised = _run_both(["-in", trees["feat"], "-hidden", "8", "-epoch", "1"]
                       + argv, tmp_path)
    assert all(isinstance(e, ValueError) for e in raised), raised
    assert all(match in str(e) for e in raised), raised


def test_cli_lstm_plain_and_default_arm(trees, tmp_path, monkeypatch):
    got = _recorders(monkeypatch)
    for flag, want in (([], "kernel"), (["-lstm", "kernel"], "kernel"),
                       (["-lstm", "plain"], "plain")):
        with pytest.raises(_Handed):
            cli.main(["-GPU", "cpu", "-in", trees["feat"], "-out",
                      str(tmp_path)] + flag)
        assert got["port"]["lstm_impl"] == want


def test_config_from_args_refuses_a_dest_that_names_no_field():
    """Every parser dest the CLI keeps is a config field: one that is not
    (a misspelled dest) raises instead of being dropped."""
    args = cli.build_parser().parse_args(["-M", "3"]).__dict__
    assert cli.config_from_args(dict(args)).num_branches == 3
    with pytest.raises(TypeError, match="clip_nrom"):
        cli.config_from_args(dict(args, clip_nrom=1.0))


# --- checkpoints across the two CLIs ---------------------------------------

CKPT_ARGV = ["-data", "npz", "-hidden", "8", "-M", "3", "-norm", "minmax",
             "-seed", str(INIT_SEED)]


def _score_lines(out):
    with open(os.path.join(out, "MPGCN_prediction_scores.txt")) as f:
        return [line.rstrip("\n").split(", ") for line in f]


def _assert_scores_close(ours, ref):
    assert [l[:5] for l in ours] == [l[:5] for l in ref] == [
        [m, "MSE", "RMSE", "MAE", "MAPE"] for m in ("train", "test")]
    for lo, lr in zip(ours, ref):
        np.testing.assert_allclose([float(v) for v in lo[5:]],
                                   [float(v) for v in lr[5:]], **SCORE_TOL)


def _assert_branches_live(tree, ckpt_path):
    """Every branch's pre-head output and FC+ReLU head of the trained
    weights are mostly non-zero on the first training batch."""
    cfg = MPGCNConfig(input_dir=tree, **dict(
        data="npz", hidden_dim=8, num_branches=3, norm="minmax",
        pred_len=1))
    data, _ = load_dataset(cfg)
    tr = port_trainer.ModelTrainer(cfg, data, device="cpu")
    tr.load_trained(ckpt_path)
    x, _, keys = tr._tensors(next(tr.pipeline.batches("train",
                                                      pad_to_full=True)))
    _, hidden = tr.model(x, graphs_for(tr.banks, keys, tr.model.sources),
                         return_hidden=True)
    with torch.no_grad():
        for m, (b, h) in enumerate(zip(tr.model.branches, hidden)):
            assert float((h != 0).float().mean()) > 0.1, f"branch {m}"
            head = torch.relu(b.fc(h))
            assert float((head != 0).float().mean()) > 0.1, f"branch {m}"
    return tr


@pytest.fixture(scope="module")
def crossed(trees, tmp_path_factory):
    """One epoch trained by each CLI on the 60-day tree (-norm minmax
    -M 3); each checkpoint then tested by both CLIs."""
    tree = trees["short"]
    runs = {}
    for trainer_side in ("jax", "port"):
        train_out = str(tmp_path_factory.mktemp(f"{trainer_side}_train"))
        other_out = str(tmp_path_factory.mktemp(f"{trainer_side}_other"))
        argv = ["-in", tree] + CKPT_ARGV
        if trainer_side == "jax":
            jax_cli.main(argv + ["-epoch", "1", "-dead-init", "warn",
                                 "-out", train_out] + JAX_FLAGS)
        else:
            cli.main(argv + ["-epoch", "1", "-GPU", "cpu", "-out",
                             train_out])
        shutil.copy(os.path.join(train_out, "MPGCN_od.pkl"), other_out)
        test_argv = argv + ["-mode", "test"]
        jax_out, port_out = ((train_out, other_out) if trainer_side == "jax"
                             else (other_out, train_out))
        jax_cli.main(test_argv + ["-out", jax_out] + JAX_FLAGS)
        res = cli.main(test_argv + ["-GPU", "cpu", "-out", port_out])
        runs[trainer_side] = dict(jax_out=jax_out, port_out=port_out,
                                  train_out=train_out, res=res)
    return dict(tree=tree, runs=runs)


@pytest.mark.parametrize("trainer_side", ["jax", "port"])
def test_checkpoint_scores_match_across_clis(crossed, trainer_side):
    r = crossed["runs"][trainer_side]
    lines_j, lines_p = _score_lines(r["jax_out"]), _score_lines(r["port_out"])
    _assert_scores_close(lines_p, lines_j)
    assert all(np.isfinite(float(v)) for l in lines_p for v in l[5:])
    assert len(r["res"]["test"]["RMSE_by_horizon"]) == 7


@pytest.mark.parametrize("trainer_side", ["jax", "port"])
def test_checkpoint_records_the_normalizer(crossed, trainer_side):
    r = crossed["runs"][trainer_side]
    ckpt = read_checkpoint(os.path.join(r["train_out"], "MPGCN_od.pkl"))
    od = synthetic_od(60, N, 0)
    log = np.log(od + 1.0)
    assert ckpt["extra"]["normalizer"] == {
        "kind": "minmax", "state": {"min": float(log.min()),
                                    "max": float(log.max())}}
    assert ckpt["extra"]["seed"] == INIT_SEED
    assert ckpt["epoch"] == 1
    _assert_branches_live(crossed["tree"],
                          os.path.join(r["train_out"], "MPGCN_od.pkl"))


def test_normalizer_records_equal_across_clis(crossed):
    recs = [read_checkpoint(os.path.join(crossed["runs"][s]["train_out"],
                                         "MPGCN_od.pkl"))["extra"]
            for s in ("jax", "port")]
    assert recs[0]["normalizer"] == recs[1]["normalizer"]
    assert recs[0]["branch_sources"] == recs[1]["branch_sources"] == [
        "static", "poi", "dynamic"]


def test_test_mode_denormalizes_through_the_container(crossed):
    """``test(denormalize=True)`` scores forecast and truth after the
    container's minmax ``denormalize``: the JAX metrics of the port's own
    forecasts, mapped back."""
    tree = crossed["tree"]
    ckpt = os.path.join(crossed["runs"]["port"]["train_out"], "MPGCN_od.pkl")
    cfg = MPGCNConfig(input_dir=tree, data="npz", hidden_dim=8,
                      num_branches=3, norm="minmax", mode="test",
                      output_dir=os.path.dirname(ckpt))
    data, di = load_dataset(cfg)
    tr = port_trainer.ModelTrainer(cfg, data, device="cpu",
                                   data_container=di)
    res = tr.test(denormalize=True)
    tr.load_trained()
    md = tr.pipeline.modes["test"]
    pred = np.concatenate([tr.predict(md.x[i: i + 4], md.keys[i: i + 4])
                           for i in range(0, len(md), 4)])
    jn = jax_loader.make_normalizer("minmax")
    jn.load_state(di.normalizer.state())
    ref = jax_metrics.evaluate(jn.denormalize(pred), jn.denormalize(md.y))
    np.testing.assert_allclose(
        [res["test"][k] for k in ("MSE", "RMSE", "MAE", "MAPE")], ref,
        rtol=1e-6)
    assert res["test"]["MSE"] > crossed["runs"]["port"]["res"]["test"]["MSE"]


# --- the optimizer ----------------------------------------------------------


@pytest.mark.parametrize("lr_schedule", ["none", "cosine", "exponential"])
def test_clip_and_schedule_match_optax_chain(lr_schedule):
    """20 steps of the port's make_optimizer (clip 1.0, L2 decay 0.01,
    the schedule over 20 steps) against the JAX package's optax chain on
    the same gradients, every other one above the clip norm."""
    rng = np.random.default_rng(3)
    shapes = [(6, 3), (4,)]
    p0 = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[rng.normal(size=s).astype(np.float32) * (3.0 if i % 2 else
                                                       0.05)
              for s in shapes] for i in range(20)]
    norms = [np.sqrt(sum(float((g * g).sum()) for g in gs)) for gs in grads]
    assert min(norms) < 1.0 < max(norms)
    ps = [torch.nn.Parameter(torch.from_numpy(x.copy())) for x in p0]
    opt = make_optimizer("Adam", ps, 1e-2, 0.01, clip_norm=1.0,
                         lr_schedule=lr_schedule, total_steps=20)
    tx = jax_optimizer("Adam", 1e-2, 0.01, clip_norm=1.0,
                       lr_schedule=lr_schedule, total_steps=20)
    jp = [jnp.asarray(x) for x in p0]
    state = tx.init(jp)
    for gs in grads:
        for p, g in zip(ps, gs):
            p.grad = torch.from_numpy(g.copy())
        opt.step()
        upd, state = tx.update([jnp.asarray(g) for g in gs], state, jp)
        jp = optax.apply_updates(jp, upd)
        for p, j in zip(ps, jp):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(j),
                                       **PARAM_TOL)
    assert opt.count == 20


@pytest.mark.parametrize("scale", [0.05, 3.0, "nan"])
def test_clip_by_global_norm_matches_optax(scale):
    """The port's clip on one gradient list against optax's
    clip_by_global_norm: below the norm every bit stays, above it each
    gradient is g / norm * max_norm, a non-finite norm spreads."""
    rng = np.random.default_rng(4)
    gs = [rng.normal(size=s).astype(np.float32) for s in [(6, 3), (4,), ()]]
    if scale == "nan":
        gs[1][2] = np.nan
    else:
        gs = [g * np.float32(scale) for g in gs]
    ours = [torch.from_numpy(np.array(g)) for g in gs]
    clip_by_global_norm_(ours, 1.0)
    ref, _ = optax.clip_by_global_norm(1.0).update(
        [jnp.asarray(g) for g in gs], None)
    for o, r, g in zip(ours, ref, gs):
        if scale == 0.05:
            assert np.array_equal(o.numpy(), g)
        elif scale == "nan":
            assert np.isnan(o.numpy()).all() and np.isnan(np.asarray(r)).all()
        else:  # the norm's sum order: within an ulp or two of optax's
            np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-6,
                                       atol=0)


@pytest.mark.parametrize("lr_schedule,at_end", [
    ("none", 1.0), ("cosine", 0.0), ("exponential", 0.1)])
def test_schedule_values_match_optax(lr_schedule, at_end):
    opt = make_optimizer("Adam", [torch.zeros(1, requires_grad=True)], 0.5,
                         lr_schedule=lr_schedule, total_steps=8)
    ref = {"none": lambda i: 0.5,
           "cosine": optax.cosine_decay_schedule(0.5, 8),
           "exponential": optax.exponential_decay(0.5, 8, 0.1)}[lr_schedule]
    for i in range(12):  # past total_steps: cosine holds 0, exp decays on
        # optax evaluates in f32: ~1e-7 of the initial rate
        np.testing.assert_allclose(opt.schedule(i), float(ref(i)),
                                   rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(opt.schedule(8), 0.5 * at_end, rtol=1e-6,
                               atol=1e-12)


def test_trainer_schedules_over_the_whole_run(trees):
    """The trainer's optimizer: the config's clip, and the schedule over
    num_batches('train') x num_epochs steps, as the JAX trainer's."""
    cfg = MPGCNConfig(input_dir=trees["short"], data="npz", hidden_dim=8,
                      pred_len=1, num_epochs=3, clip_norm=0.5,
                      lr_schedule="cosine")
    data, _ = load_dataset(cfg)
    tr = port_trainer.ModelTrainer(cfg, data, device="cpu")
    total = tr.pipeline.num_batches("train") * 3
    assert tr.optimizer.clip_norm == 0.5
    assert tr.optimizer.schedule(0) == cfg.learn_rate
    assert tr.optimizer.schedule(total) == 0.0
    assert tr.optimizer.schedule(total // 2) > 0.0
    batch = next(tr.pipeline.batches("train", pad_to_full=True))
    tr.train_step(batch)
    assert tr.optimizer.count == 1
    assert "normalizer" not in tr._ckpt_extra()  # no container given
