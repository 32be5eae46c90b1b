"""The port on the card: each CUDA kernel against its plain PyTorch
version, the kernels' refusals, a ServeEngine whose rollout goes through
the kernels, and a ModelTrainer step whose forward and backward go
through the training kernels. Every test needs a CUDA card and skips
without one.

This file imports neither JAX nor the JAX package, so it runs on a GPU
machine without JAX; tests/conftest.py imports JAX, so run it there as

    pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: f32 on both sides, other summation orders. K-LSTM and K-BDGCN
rtol 1e-5 / atol 1e-5; the 7-step rollout rtol 1e-4 / atol 1e-4. The
backward kernels' dW sums R T (or B M N) products, so it is held at
rtol 1e-5 with atol 1e-6 x its largest entry."""

import numpy as np
import pytest
import torch

from mpgcn_tpu_torch.config import MPGCNConfig, ServeConfig
from mpgcn_tpu_torch.data.loader import synthetic_dataset
from mpgcn_tpu_torch.nn import cuda_bdgcn, cuda_lstm
from mpgcn_tpu_torch.nn.mpgcn import MPGCN
from mpgcn_tpu_torch.service.serve import KERNELS, ServeEngine
from mpgcn_tpu_torch.train.predict import rollout
from mpgcn_tpu_torch.train.trainer import ModelTrainer

KERNEL_TOL = dict(rtol=1e-5, atol=1e-5)
ROLLOUT_TOL = dict(rtol=1e-4, atol=1e-4)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided here at run time, never at import or
    collection, so every xdist worker collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run `pytest --noconftest -m cuda "
                    "tests/test_torch_cuda.py` on the GPU machine")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("collect", [False, True])
@pytest.mark.parametrize("R,H", [(17672, 32), (1000, 8), (333, 64), (5, 40)])
def test_lstm_kernel_matches_plain(cuda_device, collect, R, H):
    rng = np.random.default_rng(R)
    xp = torch.from_numpy(rng.normal(size=(7, R, 4 * H)).astype(
        np.float32)).to(cuda_device)
    w = torch.from_numpy((rng.normal(size=(H, 4 * H)) / np.sqrt(H)).astype(
        np.float32)).to(cuda_device)
    kernel = (cuda_lstm.LSTM_INFER_COLLECT if collect
              else cuda_lstm.LSTM_INFER_LAST)
    before = kernel.launches
    out = cuda_lstm.lstm_layer_infer(xp, w, collect)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    ref = cuda_lstm.lstm_layer_infer_plain(xp, w, collect)
    torch.testing.assert_close(out, ref, **KERNEL_TOL)


def test_lstm_kernel_rejects_what_it_does_not_take(cuda_device):
    xp = torch.zeros((7, 10, 4 * 32), device=cuda_device)
    w = torch.zeros((32, 128), device=cuda_device)
    with pytest.raises(TypeError, match="float32"):
        cuda_lstm.lstm_layer_infer(xp.bfloat16(), w.bfloat16(), False)
    with pytest.raises(ValueError, match="hidden widths"):
        cuda_lstm.lstm_layer_infer(
            torch.zeros((7, 10, 4 * 128), device=cuda_device),
            torch.zeros((128, 512), device=cuda_device), False)
    with pytest.raises(RuntimeError, match="inference-only"):
        cuda_lstm.lstm_layer_infer(xp, w.requires_grad_(), False)


def _bdgcn_inputs(dev, K, B, N, C, H, dynamic, seed=0):
    rng = np.random.default_rng(seed)
    h1 = rng.normal(size=(K, B, N, N, C)).astype(np.float32)
    g = (rng.random((B if dynamic else 1, K, N, N)) / N * 2).astype(
        np.float32)
    w = (rng.normal(size=(K, K, C, H)) / np.sqrt(K * K * C)).astype(
        np.float32)
    return [torch.from_numpy(a).to(dev) for a in (h1, g, w)]


@pytest.mark.parametrize("dynamic", [False, True])
@pytest.mark.parametrize("K,B,N,C,H", [(3, 8, 47, 32, 32),
                                       (3, 2, 200, 32, 32),
                                       (5, 2, 33, 16, 64),
                                       (2, 3, 9, 8, 40), (1, 1, 1, 1, 1)])
def test_bdgcn_kernel_matches_plain(cuda_device, dynamic, K, B, N, C, H):
    args = _bdgcn_inputs(cuda_device, K, B, N, C, H, dynamic, seed=N)
    before = cuda_bdgcn.BDGCN_PAIR_FWD.launches
    out = cuda_bdgcn.folded_pair_project(*args)
    torch.cuda.synchronize()
    assert cuda_bdgcn.BDGCN_PAIR_FWD.launches == before + 1
    torch.testing.assert_close(out, cuda_bdgcn.folded_pair_project_plain(
        *args), **KERNEL_TOL)


def test_bdgcn_kernel_rejects_what_it_does_not_take(cuda_device):
    h1, g, w = _bdgcn_inputs(cuda_device, 3, 2, 5, 8, 8, False)
    with pytest.raises(TypeError, match="float32"):
        cuda_bdgcn.folded_pair_project(h1.double(), g, w)
    with pytest.raises(ValueError, match="supports"):
        cuda_bdgcn.folded_pair_project(*_bdgcn_inputs(
            cuda_device, 6, 1, 3, 2, 2, False))
    with pytest.raises(ValueError, match="widths"):
        cuda_bdgcn.folded_pair_project(*_bdgcn_inputs(
            cuda_device, 2, 1, 3, 65, 2, False))
    with pytest.raises(ValueError, match="Gk must be"):
        cuda_bdgcn.folded_pair_project(h1, g[:, :2], w)


def test_engine_serves_through_the_kernels(cuda_device):
    cfg = MPGCNConfig(synthetic_T=200, synthetic_N=10, hidden_dim=16,
                      lstm_num_layers=2, seed=0)
    data = synthetic_dataset(cfg)
    eng = ServeEngine(cfg, data, ServeConfig(buckets=(1, 4),
                                             max_wait_ms=50.0),
                      device=cuda_device, allow_fresh=True)
    try:
        md = eng.pipeline.modes["test"]
        x = np.ascontiguousarray(md.x[:4])
        for k in KERNELS.values():
            k.launches = 0
        tickets = [eng.submit(x[i, ..., 0], int(md.keys[i]))
                   for i in range(4)]
        for t in tickets:
            assert t.wait(60) and t.ok, t.error
        batches = sum(v["dispatches"] for v in
                      eng.stats()["pad_waste"]["by_bucket"].values())
        launches = eng.stats()["kernel_launches"]
        steps = cfg.pred_len * cfg.num_branches * batches
        assert launches == {"lstm_infer_last": steps,
                            "lstm_infer_collect": steps,
                            "bdgcn_pair_fwd": steps * cfg.gcn_num_layers}
        plain = MPGCN.from_config(eng.cfg, device=cuda_device,
                                  lstm_impl="plain", bdgcn_impl="einsum")
        plain.load_state_dict(eng.model.state_dict())
        ref = rollout(plain, eng.banks, torch.from_numpy(x).to(cuda_device),
                      torch.from_numpy(md.keys[:4].astype(np.int64)).to(
                          cuda_device), cfg.pred_len).cpu()
        preds = torch.from_numpy(np.stack([t.pred for t in tickets]))
        assert bool(torch.isfinite(preds).all())
        torch.testing.assert_close(preds, ref, **ROLLOUT_TOL)
    finally:
        eng.close()


def _close_scaled(out, ref):
    """dW-style sums: rtol 1e-5, atol 1e-6 x the largest entry."""
    torch.testing.assert_close(out, ref, rtol=1e-5,
                               atol=1e-6 * float(ref.abs().max()))


@pytest.mark.parametrize("with_dcs", [False, True])
@pytest.mark.parametrize("T,R,H", [(7, 8836, 32), (7, 1001, 8),
                                   (5, 333, 64), (3, 17, 40)])
def test_lstm_train_kernels_match_plain(cuda_device, T, R, H, with_dcs):
    rng = np.random.default_rng(R + H)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(cuda_device)
    xp = t(rng.normal(size=(T, R, 4 * H)))
    w = t(rng.normal(size=(H, 4 * H)) / np.sqrt(H))
    before = [k.launches for k in (cuda_lstm.LSTM_TRAIN_FWD,
                                   cuda_lstm.LSTM_TRAIN_BWD,
                                   cuda_lstm.DW_REDUCE)]
    hs, cs = cuda_lstm.lstm_layer_train(xp, w)
    hp, cp = cuda_lstm.lstm_layer_train_plain(xp, w)
    torch.testing.assert_close(hs, hp, **KERNEL_TOL)
    torch.testing.assert_close(cs, cp, **KERNEL_TOL)
    dhs = t(rng.normal(size=(T, R, H)))
    dcs = t(rng.normal(size=(T, R, H))) if with_dcs else None
    dxp, dw = cuda_lstm.lstm_layer_bwd(xp, w, hs, cs, dhs, dcs)
    torch.cuda.synchronize()
    assert [k.launches for k in (cuda_lstm.LSTM_TRAIN_FWD,
                                 cuda_lstm.LSTM_TRAIN_BWD,
                                 cuda_lstm.DW_REDUCE)] == [
        b + 1 for b in before]
    dxr, dwr = cuda_lstm.lstm_layer_bwd_plain(xp, w, hs, cs, dhs, dcs)
    torch.testing.assert_close(dxp, dxr, **KERNEL_TOL)
    _close_scaled(dw, dwr)
    _, dw2 = cuda_lstm.lstm_layer_bwd(xp, w, hs, cs, dhs, dcs)
    assert torch.equal(dw, dw2), "dW differs between two runs"


@pytest.mark.parametrize("dynamic", [False, True])
@pytest.mark.parametrize("K,B,N,C,H", [(3, 4, 47, 32, 32),
                                       (3, 2, 200, 32, 32),
                                       (5, 2, 33, 16, 64),
                                       (2, 3, 9, 8, 40), (1, 1, 1, 1, 1)])
def test_bdgcn_bwd_kernel_matches_plain(cuda_device, dynamic, K, B, N, C, H):
    h1, g, w = _bdgcn_inputs(cuda_device, K, B, N, C, H, dynamic, seed=N)
    dout = torch.from_numpy(np.random.default_rng(C).normal(
        size=(B, N, N, H)).astype(np.float32)).to(cuda_device)
    before = (cuda_bdgcn.BDGCN_PAIR_BWD.launches,
              cuda_lstm.DW_REDUCE.launches)
    dh1, dW = cuda_bdgcn.folded_pair_project_bwd(h1, g, w, dout)
    torch.cuda.synchronize()
    assert (cuda_bdgcn.BDGCN_PAIR_BWD.launches,
            cuda_lstm.DW_REDUCE.launches) == (before[0] + 1, before[1] + 1)
    r1, rW = cuda_bdgcn.folded_pair_project_bwd_plain(h1, g, w, dout)
    torch.testing.assert_close(dh1, r1, **KERNEL_TOL)
    _close_scaled(dW, rW)
    _, dW2 = cuda_bdgcn.folded_pair_project_bwd(h1, g, w, dout)
    assert torch.equal(dW, dW2), "dW differs between two runs"


@pytest.mark.parametrize("P,shape", [(264, (32, 128)), (30, (3, 3, 32, 32)),
                                     (1, (5,)), (7, (1001,))])
def test_dw_reduce_kernel_matches_plain(cuda_device, P, shape):
    """The shared dW reduction adds the partials in the plain version's
    order, p = 0, 1, ..., so the two agree to the last bit."""
    part = torch.from_numpy(np.random.default_rng(P).normal(
        size=(P, *shape)).astype(np.float32)).to(cuda_device)
    before = cuda_lstm.DW_REDUCE.launches
    out = cuda_lstm.dw_reduce(part)
    torch.cuda.synchronize()
    assert cuda_lstm.DW_REDUCE.launches == before + 1
    assert tuple(out.shape) == shape
    assert torch.equal(out, cuda_lstm.dw_reduce_plain(part))
    with pytest.raises(ValueError, match="float32"):
        cuda_lstm.dw_reduce(part.double())


def test_training_kernels_reject_what_they_do_not_take(cuda_device):
    xp = torch.zeros((7, 10, 4 * 32), device=cuda_device)
    w = torch.zeros((32, 128), device=cuda_device)
    with pytest.raises(TypeError, match="float32"):
        cuda_lstm.lstm_layer_train(xp.double(), w.double())
    with pytest.raises(ValueError, match="hidden widths"):
        cuda_lstm.lstm_layer_train(
            torch.zeros((7, 10, 4 * 128), device=cuda_device),
            torch.zeros((128, 512), device=cuda_device))
    hs, cs = cuda_lstm.lstm_layer_train(xp, w)
    with pytest.raises(ValueError, match="dhs must be"):
        cuda_lstm.lstm_layer_bwd(xp, w, hs, cs, hs[:3], None)
    with pytest.raises(TypeError, match="float32"):
        cuda_lstm.lstm_layer_bwd(xp, w, hs, cs.double(), hs, None)
    h1, g, wr = _bdgcn_inputs(cuda_device, 3, 2, 5, 8, 8, False)
    dout = torch.zeros((2, 5, 5, 8), device=cuda_device)
    with pytest.raises(ValueError, match="dout must be"):
        cuda_bdgcn.folded_pair_project_bwd(h1, g, wr, dout[:1])
    with pytest.raises(TypeError, match="float32"):
        cuda_bdgcn.folded_pair_project_bwd(h1.double(), g, wr, dout)
    with pytest.raises(ValueError, match="supports"):
        h6, g6, w6 = _bdgcn_inputs(cuda_device, 6, 1, 3, 2, 2, False)
        cuda_bdgcn.folded_pair_project_bwd(
            h6, g6, w6, torch.zeros((1, 3, 3, 2), device=cuda_device))


def test_trainer_step_runs_the_training_kernels(cuda_device, tmp_path):
    """One ModelTrainer step at M=2, 1 LSTM layer, 3 BDGCN layers: exactly
    M = 2 launches of each LSTM training entry, M * 3 = 6 of each BDGCN
    entry and 2 + 6 = 8 of the shared dW reduction, no inference launch;
    then a validation step launches only the inference kernels. The kernel
    arm's gradients match the plain arms'."""
    cfg = MPGCNConfig(synthetic_T=200, synthetic_N=10, hidden_dim=16,
                      pred_len=1, seed=0, output_dir=str(tmp_path))
    data = synthetic_dataset(cfg)
    tr = ModelTrainer(cfg, data, device=cuda_device)
    plain = ModelTrainer(cfg, data, device=cuda_device, lstm_impl="plain",
                         bdgcn_impl="einsum")
    plain.model.load_state_dict(tr.model.state_dict())
    batch = next(tr.pipeline.batches("train", pad_to_full=True))
    kernels = {**KERNELS, "lstm_train_fwd": cuda_lstm.LSTM_TRAIN_FWD,
               "lstm_train_bwd": cuda_lstm.LSTM_TRAIN_BWD,
               "dw_reduce": cuda_lstm.DW_REDUCE,
               "bdgcn_pair_bwd": cuda_bdgcn.BDGCN_PAIR_BWD}
    for k in kernels.values():
        k.launches = 0
    for t in (tr, plain):
        x, y, keys = t._tensors(batch)
        t._batch_loss(x, y, keys, batch.size).backward()
    torch.cuda.synchronize()
    assert {n: k.launches for n, k in kernels.items()} == {
        "lstm_infer_last": 0, "lstm_infer_collect": 0,
        "bdgcn_pair_fwd": 6, "lstm_train_fwd": 2, "lstm_train_bwd": 2,
        "dw_reduce": 8, "bdgcn_pair_bwd": 6}
    ref = dict(plain.model.named_parameters())
    for name, p in tr.model.named_parameters():
        torch.testing.assert_close(
            p.grad, ref[name].grad, rtol=1e-4,
            atol=1e-5 * float(ref[name].grad.abs().max()))
    for k in kernels.values():
        k.launches = 0
    assert np.isfinite(tr.eval_step(batch))
    assert {n: k.launches for n, k in kernels.items() if k.launches} == {
        "lstm_infer_last": 2, "bdgcn_pair_fwd": 6}
