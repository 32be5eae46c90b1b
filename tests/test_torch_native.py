"""The port's host kernels (mpgcn_tpu_torch/native/host.py, built from its
own ``mpgcn_host.cpp``) against numpy and against the JAX package's
(``mpgcn_tpu.native``) on the CPU: the window gather byte for byte, the
day-of-week mean to 1e-12 (float64 sums in the same loop order: equal in
practice), the dynamic graphs built on it against the JAX loader's
native path, the pipeline's batches and chunks with ``-native auto``
and ``off`` byte for byte, the ``[dispatch]`` line naming the gather and
why numpy ran, the numpy versions taken when the library is not
available, and the build's compilers: ``CXX``, then ``g++`` when that
one cannot build it.

Sizes: series of 40 days over 5 to 8 zones."""

import os

import numpy as np
import pytest
import torch

from mpgcn_tpu import native as jax_native
from mpgcn_tpu.data.dyn_graphs import construct_dyn_g as jax_dyn_g
from mpgcn_tpu_torch.config import MPGCNConfig
from mpgcn_tpu_torch.data.dyn_graphs import construct_dyn_g
from mpgcn_tpu_torch.data.loader import synthetic_dataset, synthetic_od
from mpgcn_tpu_torch.data.pipeline import DataPipeline
from mpgcn_tpu_torch.native import host

# each pytest-xdist worker takes its share of the cores: torch's default
# of one intra-op thread per core, in every worker at once, oversubscribes
# the machine
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

MEAN_TOL = dict(rtol=1e-12, atol=1e-12)
KW = dict(synthetic_T=60, synthetic_N=8, hidden_dim=8, pred_len=2)


@pytest.fixture
def no_library(monkeypatch):
    """The library as if it had not built."""
    monkeypatch.setattr(host, "_state", "OSError: no compiler")


def test_library_builds_here():
    assert host.available(), host.unavailable_reason()
    assert host.unavailable_reason() is None
    assert os.path.basename(host.lib_path()).startswith("libmpgcn_host-")


@pytest.mark.parametrize("shape,starts,steps", [
    ((40, 5, 5, 1), [3, 0, 30, 3], 7), ((40, 8, 8, 1), [0], 1),
    ((40, 6, 6), [33, 1], 7), ((40, 5, 5, 1), [], 4)])
def test_gather_matches_numpy_and_jax(shape, starts, steps):
    base = np.random.default_rng(0).random(shape).astype(np.float32)
    st = np.asarray(starts, np.int64)
    want = np.stack([base[s: s + steps] for s in st]) if len(st) else \
        np.empty((0, steps) + shape[1:], np.float32)
    ours = host.gather_windows(base, st, steps)
    assert ours.tobytes() == want.tobytes() and ours.shape == want.shape
    assert ours.tobytes() == jax_native.gather_windows(base, st,
                                                       steps).tobytes()
    out = np.zeros_like(want)
    assert host.gather_windows(base, st, steps, out=out) is out
    assert out.tobytes() == want.tobytes()


def test_gather_refuses_bad_windows_and_buffers():
    base = np.zeros((10, 3, 3, 1), np.float32)
    with pytest.raises(IndexError):
        host.gather_windows(base, [4], 7)
    with pytest.raises(IndexError):
        host.gather_windows(base, [-1], 2)
    with pytest.raises(ValueError, match="C-contiguous float32"):
        host.gather_windows(base, [0], 2, out=np.zeros((1, 2, 3, 3, 1)))


@pytest.mark.parametrize("period,shape", [(7, (28, 5, 5)), (7, (35, 6, 6)),
                                          (3, (9, 4))])
def test_dow_mean_matches_numpy_and_jax(period, shape):
    h = np.random.default_rng(1).random(shape)
    ours = host.dow_mean(h, period)
    want = np.stack([h[p::period].mean(axis=0) for p in range(period)])
    np.testing.assert_allclose(ours, want, **MEAN_TOL)
    np.testing.assert_allclose(ours, jax_native.dow_mean(h, period),
                               **MEAN_TOL)
    with pytest.raises(ValueError, match="multiple"):
        host.dow_mean(h[:-1], period)


def test_numpy_versions_without_the_library(no_library):
    assert not host.available()
    assert host.unavailable_reason() == "OSError: no compiler"
    base = np.random.default_rng(2).random((20, 4, 4, 1)).astype(np.float32)
    assert host.gather_windows(base, [5, 0], 3).tobytes() == np.stack(
        [base[5:8], base[0:3]]).tobytes()
    h = np.random.default_rng(3).random((14, 4, 4)).astype(np.float32)
    np.testing.assert_allclose(
        host.dow_mean(h, 7),
        np.stack([h.astype(np.float64)[p::7].mean(0) for p in range(7)]),
        **MEAN_TOL)


@pytest.mark.parametrize("bug", [True, False])
def test_dyn_graphs_match_the_jax_native_path(bug):
    raw = synthetic_od(40, 8, 1)
    o, d = construct_dyn_g(raw, 0.64, 7, reproduce_d_bug=bug)
    jo, jd = jax_dyn_g(raw, 0.64, 7, reproduce_d_bug=bug, use_native=True)
    np.testing.assert_allclose(o, jo, **MEAN_TOL)
    np.testing.assert_allclose(d, jd, **MEAN_TOL)


@pytest.fixture(scope="module")
def data():
    return synthetic_dataset(MPGCNConfig(**KW))


@pytest.mark.parametrize("storage", ["dense", "sparse"])
def test_pipeline_batches_equal_with_native_auto_and_off(data, storage):
    pipes = {n: DataPipeline(MPGCNConfig(native_host=n, od_storage=storage,
                                         **KW), data, "cpu")
             for n in ("auto", "off")}
    want = "native" if storage == "dense" else "numpy"
    assert pipes["auto"].host_gather == want
    assert pipes["off"].host_gather == "numpy"
    for mode in ("train", "validate", "test"):
        for a, b in zip(pipes["auto"].batches(mode, shuffle=True,
                                              pad_to_full=True),
                        pipes["off"].batches(mode, shuffle=True,
                                             pad_to_full=True)):
            assert a.x.tobytes() == b.x.tobytes()
            assert a.y.tobytes() == b.y.tobytes()
            assert a.keys.tobytes() == b.keys.tobytes() and a.size == b.size
    idx = np.arange(32, dtype=np.int32)[::-1].reshape(8, 4) % 33
    sizes = np.full(8, 4, np.int32)
    for a, b in zip(pipes["auto"].epoch_chunks("train", idx, sizes, 3),
                    pipes["off"].epoch_chunks("train", idx, sizes, 3)):
        assert a.x.tobytes() == b.x.tobytes()
        assert a.y.tobytes() == b.y.tobytes()


def test_dispatch_line_says_which_gather_ran_and_why(data, no_library):
    lines = {}
    for name, kw in (("off", dict(native_host="off")),
                     ("sparse", dict(od_storage="sparse")),
                     ("unbuilt", {})):
        pipe = DataPipeline(MPGCNConfig(**KW, **kw), data, "cpu")
        lines[name] = pipe.dispatch_line("kernel")
    assert lines["off"].endswith(", host gather numpy (-native off)")
    assert "od_storage=sparse" in lines["sparse"]
    assert lines["sparse"].endswith(
        "host gather numpy (od_storage=sparse: the series densifies the "
        "rows a gather asks for)")
    assert lines["unbuilt"].endswith(
        "host gather numpy (the host library did not build: OSError: no "
        "compiler)")


def test_dispatch_line_names_the_native_gather(data):
    line = DataPipeline(MPGCNConfig(**KW), data, "cpu").dispatch_line(
        "kernel")
    assert line.endswith(", host gather native")


@pytest.fixture
def fresh_build(tmp_path, monkeypatch):
    """The library not built yet, into an empty build directory."""
    monkeypatch.setattr(host, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(host, "_state", None)
    return tmp_path / "_build"


def test_build_falls_back_to_gpp_when_cxx_cannot(fresh_build, monkeypatch):
    """A CXX that cannot build the library (a compiler without OpenMP's
    runtime, or none at all) leaves g++ to build it."""
    monkeypatch.setenv("CXX", str(fresh_build / "no-such-compiler"))
    assert host.compilers() == [str(fresh_build / "no-such-compiler"),
                                "g++"]
    assert host.available(), host.unavailable_reason()
    assert os.path.exists(host.lib_path())
    assert host.gather_windows(np.ones((4, 2), np.float32), [1], 2).sum() \
        == 4


def test_unbuilt_library_names_every_compiler_tried(fresh_build,
                                                    monkeypatch):
    monkeypatch.setenv("CXX", "no-such-cxx")
    monkeypatch.setenv("PATH", str(fresh_build))  # no g++ either
    assert not host.available()
    why = host.unavailable_reason()
    assert why.startswith("RuntimeError: no-such-cxx: FileNotFoundError")
    assert "; g++: FileNotFoundError" in why
    assert not os.listdir(fresh_build)  # no partial library left
