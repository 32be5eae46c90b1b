"""The port on the card: each CUDA kernel against its plain PyTorch
version, the kernels' refusals, a ServeEngine whose rollout goes through
the kernels, and ModelTrainer steps whose forward and backward go through
the training kernels, dense and blocked-ELL. Every test needs a CUDA card
and skips without one.

This file imports neither JAX nor the JAX package, so it runs on a GPU
machine without JAX; tests/conftest.py imports JAX, so run it there as

    pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: f32 on both sides, other summation orders. K-LSTM and K-BDGCN
rtol 1e-5 / atol 1e-5; the 7-step rollout rtol 1e-4 / atol 1e-4. The
backward kernels' dW sums R T (or B M N) products, so it is held at
rtol 1e-5 with atol 1e-6 x its largest entry. The ELL SpMM forward and dX
rtol 1e-5 / atol 1e-5 (sums of up to MB * 128 products; the forward's
TF32 tensor-core products split each f32 operand into two TF32 parts,
about 2^-21 relative per product); dBlocks sums F products and is held
like dW."""

import functools
import os

import numpy as np
import pytest
import torch

from mpgcn_tpu_torch.config import MPGCNConfig, ServeConfig
from mpgcn_tpu_torch.data.loader import apply_density, synthetic_dataset
from mpgcn_tpu_torch.nn import cuda_bdgcn, cuda_lstm
from mpgcn_tpu_torch.nn.mpgcn import MPGCN
from mpgcn_tpu_torch.quant.int8 import QuantizedTensor
from mpgcn_tpu_torch.service.serve import KERNELS, ServeEngine
from mpgcn_tpu_torch.sparse import cuda_ell, formats
from mpgcn_tpu_torch.sparse.formats import (
    BlockedELL,
    ell_from_dense,
    pack_payload,
)
from mpgcn_tpu_torch.sparse.kernels import ell_spmm, flat_stack
from mpgcn_tpu_torch.train.predict import rollout
from mpgcn_tpu_torch.train.trainer import ModelTrainer

# each pytest-xdist worker takes its share of the cores: torch's default
# of one intra-op thread per core, in every worker at once, oversubscribes
# the machine
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

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


#: hidden widths past the resident kernels' shared memory (w_hh stays in
#: shared memory to H = 116 for the forward, H = 81 for the BPTT), and one
#: past a block's 1,024 threads, at T = 2 (``_T_OF``)
WIDE_LSTM = [(1001, 65), (333, 96), (1000, 128), (257, 256), (9, 1030)]
_T_OF = {1030: 2}
#: the forwards' fused form (x, w_ih and b instead of x_proj): (T, R, H, F)
#: at H = 3 (a w_hh row shorter than one 16-byte load), 32, 81, the widest
#: resident H (116), 118 and 128 (the wide kernel), F = 1 (the model's
#: input width) and 3, ragged R; one step; the N=500 step's R = 500,000
FUSED_LSTM = ([(7, 1001, H, F) for H in (3, 32, 81, 116, 118, 128)
               for F in (1, 3)]
              + [(1, 999, 32, 1), (7, 500000, 32, 1)])


def _fused_inputs(dev, T, R, H, F, seed):
    """x (R, T, F), w_ih (4H, F), b (4H,), w_hh_T (H, 4H) on ``dev``,
    weights as the model's init draws them (uniform in +-1/sqrt(H))."""
    rng = np.random.default_rng(seed)
    s = 1 / np.sqrt(H)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)
    return (t(rng.normal(size=(R, T, F))), t(rng.uniform(-s, s, (4 * H, F))),
            t(rng.uniform(-s, s, 4 * H)), t(rng.uniform(-s, s, (H, 4 * H))))


@pytest.mark.parametrize("collect", [False, True])
@pytest.mark.parametrize("T,R,H,F", [
    pytest.param(_T_OF.get(H, 7), R, H, 0, id=f"{R}-{H}")
    for R, H in [(17672, 32), (1000, 8), (333, 64), (5, 40)] + WIDE_LSTM]
    + [pytest.param(*c, id="fused-{}-{}-{}-{}".format(*c))
       for c in FUSED_LSTM])
def test_lstm_kernel_matches_plain(cuda_device, collect, T, R, H, F):
    """Each inference entry against its plain version, on x_proj (F = 0)
    or in the fused form from x (F >= 1; then also against the plain
    version in float64), one launch a call."""
    kernel = (cuda_lstm.LSTM_INFER_COLLECT if collect
              else cuda_lstm.LSTM_INFER_LAST)
    before = kernel.launches
    if F == 0:
        rng = np.random.default_rng(R)
        xp = torch.from_numpy(rng.normal(size=(T, R, 4 * H)).astype(
            np.float32)).to(cuda_device)
        w = torch.from_numpy((rng.normal(size=(H, 4 * H)) / np.sqrt(H))
                             .astype(np.float32)).to(cuda_device)
        out = cuda_lstm.lstm_layer_infer(xp, w, collect)
        torch.cuda.synchronize()
        ref = cuda_lstm.lstm_layer_infer_plain(xp, w, collect)
    else:
        args = _fused_inputs(cuda_device, T, R, H, F, seed=R + H + F)
        out = cuda_lstm.lstm_layer_infer_fused(*args, collect)
        torch.cuda.synchronize()
        ref = cuda_lstm.lstm_layer_infer_fused_plain(*args, collect)
        ref64 = cuda_lstm.lstm_layer_infer_fused_plain(
            *(a.double() for a in args), collect)
        torch.testing.assert_close(out.double(), ref64, **KERNEL_TOL)
    assert kernel.launches == before + 1
    torch.testing.assert_close(out, ref, **KERNEL_TOL)


@pytest.mark.parametrize("collect", [False, True])
@pytest.mark.parametrize("H", [32, 128])
def test_lstm_fused_form_equals_projection_then_kernel(cuda_device, collect,
                                                       H):
    """At F = 1 the fused form rounds the gate inputs as the torch K = 1
    product and bias add do, so its outputs equal the x_proj form's fed
    by that projection, bit for bit: the resident kernel (H = 32) and the
    wide one (H = 128), at the N=47 serve shape."""
    x, w_ih, b, w = _fused_inputs(cuda_device, 7, 17672, H, 1, seed=H)
    fused = cuda_lstm.lstm_layer_infer_fused(x, w_ih, b, w, collect)
    x_proj = torch.matmul(x.transpose(0, 1), w_ih.t()) + b
    unfused = cuda_lstm.lstm_layer_infer(x_proj, w, collect)
    torch.cuda.synchronize()
    assert torch.equal(fused, unfused)


#: the wide forward's widths: every WIDE_LSTM shape (H = 65 and 96 take the
#: resident kernel, the rest the wide one), the two just past the resident
#: forward's limit, and R = 4,433 > 32 x 132 SMs, where the wide kernel
#: takes 48-row tiles (32 below)
WIDE_FWD = WIDE_LSTM + [(1003, 117), (997, 118), (4433, 128)]


@pytest.mark.parametrize("R,H", WIDE_FWD, ids=[f"{R}-{H}" for R, H in
                                                 WIDE_FWD])
def test_wide_lstm_forwards_match_float64(cuda_device, record_property, R,
                                          H):
    """lstm_infer_last, lstm_infer_collect and lstm_train_fwd against their
    plain versions in float64 on the same inputs, at KERNEL_TOL (the wide
    kernel's split-TF32 products carry each f32 operand to 2^-22); the
    largest error is recorded (``max_abs_err``); a second run of each
    entry gives the same bits."""
    T = _T_OF.get(H, 7)
    rng = np.random.default_rng(R * H)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(cuda_device)
    xp = t(rng.normal(size=(T, R, 4 * H)))
    w = t(rng.normal(size=(H, 4 * H)) / np.sqrt(H))
    runs = []
    for _ in range(2):
        runs.append([cuda_lstm.lstm_layer_infer(xp, w, False),
                     cuda_lstm.lstm_layer_infer(xp, w, True),
                     *cuda_lstm.lstm_layer_train(xp, w)])
    torch.cuda.synchronize()
    x64, w64 = xp.double(), w.double()
    refs = [cuda_lstm.lstm_layer_infer_plain(x64, w64, False),
            cuda_lstm.lstm_layer_infer_plain(x64, w64, True),
            *cuda_lstm.lstm_layer_train_plain(x64, w64)]
    err = 0.0
    for out, again, ref in zip(*runs, refs):
        torch.testing.assert_close(out.double(), ref, **KERNEL_TOL)
        err = max(err, float((out.double() - ref).abs().max()))
        assert torch.equal(out, again), "two runs differ"
    record_property("max_abs_err", err)


def test_lstm_kernel_rejects_what_it_does_not_take(cuda_device):
    xp = torch.zeros((7, 10, 4 * 32), device=cuda_device)
    w = torch.zeros((32, 128), device=cuda_device)
    # float32 or bfloat16 (the bf16 entries), never float16 nor a mix
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        cuda_lstm.lstm_layer_infer(xp.half(), w.half(), False)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        cuda_lstm.lstm_layer_infer(xp.bfloat16(), w, False)
    x, w_ih, b, _ = _fused_inputs(cuda_device, 7, 10, 32, 1, seed=0)
    with pytest.raises(ValueError, match="1 <= F <= 4"):
        x5 = torch.zeros((10, 7, 5), device=cuda_device)
        cuda_lstm.lstm_layer_infer_fused(x5, torch.zeros((128, 5),
                                                         device=cuda_device),
                                         b, w, False)
    with pytest.raises(ValueError, match="w_ih must be"):
        cuda_lstm.lstm_layer_infer_fused(x, w_ih[:64], b, w, False)
    with pytest.raises(ValueError, match="w_ih must be"):
        cuda_lstm.lstm_layer_infer_fused(x, torch.zeros(
            (128, 2), device=cuda_device), b, w, False)
    with pytest.raises(ValueError, match="b must be"):
        cuda_lstm.lstm_layer_infer_fused(x, w_ih, b[:100], w, False)
    with pytest.raises(TypeError, match="float32"):
        cuda_lstm.lstm_layer_infer_fused(x, w_ih, b.double(), w, False)
    # H = 128, refused before the wide kernel, is taken
    rng = np.random.default_rng(128)
    xw = torch.from_numpy(rng.normal(size=(7, 10, 512)).astype(
        np.float32)).to(cuda_device)
    ww = torch.from_numpy((rng.normal(size=(128, 512)) / 8).astype(
        np.float32)).to(cuda_device)
    torch.testing.assert_close(
        cuda_lstm.lstm_layer_infer(xw, ww, False),
        cuda_lstm.lstm_layer_infer_plain(xw, ww, False), **KERNEL_TOL)
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


#: (K, B, N, C, H) past K <= 5 and C, H <= 64 (the widths the card took
#: only after PR 7's wide kernels), with ragged ends of every axis
WIDE_BDGCN = [(7, 2, 20, 128, 128), (6, 2, 33, 65, 33), (9, 2, 21, 16, 16),
              (3, 2, 47, 32, 128)]
#: the split-TF32 products' edges: R = B N^2 = 147 rows (not a multiple of
#: the 64- and 128-row tiles), K C = 15 and K H = 21 (not multiples of the
#: 8-deep mma step), and N = 500 at B = 2, the dense kernel arm's shape
EDGE_BDGCN = [(3, 3, 7, 32, 32), (3, 2, 11, 5, 7), (3, 2, 500, 32, 32)]
#: operands scaled apart: h1 x 1e3 and Wr x 1e-3 in the forward, h1 and Wr
#: x 1e3 and dout x 1e-3 in the backward, so every TF32 split runs on
#: values far from 1 while the outputs stay O(1) (scaling one operand
#: alone moves f32's own rounding of the plain version past atol 1e-5)
SCALED_BDGCN = [(3, 8, 47, 32, 32), (7, 2, 20, 128, 128)]


def _bdgcn_cases():
    return ([pytest.param(*shape, 1.0, id="-".join(map(str, shape)))
             for shape in [(3, 8, 47, 32, 32), (3, 2, 200, 32, 32),
                           (5, 2, 33, 16, 64), (2, 3, 9, 8, 40),
                           (1, 1, 1, 1, 1)] + WIDE_BDGCN + EDGE_BDGCN]
            + [pytest.param(*shape, 1e3, id="-".join(map(str, shape))
                            + "-x1e3") for shape in SCALED_BDGCN])


@pytest.mark.parametrize("dynamic", [False, True])
@pytest.mark.parametrize("K,B,N,C,H,scale", _bdgcn_cases())
def test_bdgcn_kernel_matches_plain(cuda_device, dynamic, K, B, N, C, H,
                                    scale):
    args = _bdgcn_inputs(cuda_device, K, B, N, C, H, dynamic, seed=N)
    args[0], args[2] = args[0] * scale, args[2] / scale
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
    # K = 6 and C = 65, refused before the wide kernel, are taken
    for K, C in ((6, 2), (2, 65)):
        args = _bdgcn_inputs(cuda_device, K, 1, 3, C, 2, False)
        torch.testing.assert_close(
            cuda_bdgcn.folded_pair_project(*args),
            cuda_bdgcn.folded_pair_project_plain(*args), **KERNEL_TOL)
    with pytest.raises(ValueError, match="Gk must be"):
        cuda_bdgcn.folded_pair_project(h1, g[:, :2], w)


def test_engine_serves_through_the_kernels(cuda_device, tmp_path):
    cfg = MPGCNConfig(synthetic_T=200, synthetic_N=10, hidden_dim=16,
                      lstm_num_layers=2, seed=0)
    data = synthetic_dataset(cfg)
    eng = ServeEngine(cfg, data, ServeConfig(buckets=(1, 4),
                                             max_wait_ms=50.0,
                                             output_dir=str(tmp_path)),
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
                            "bdgcn_pair_fwd": steps * cfg.gcn_num_layers,
                            "lstm_infer_last_bf16": 0,
                            "lstm_infer_collect_bf16": 0,
                            "bdgcn_pair_fwd_bf16": 0,
                            "ell_fwd": 0, "ell_fwd_q": 0}
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


#: the BPTT's engine path (H > 81) at its edges: one step (no recurrent
#: product, no dW depth), 17 rows (under one tile of either engine), H = 97
#: (hs rows not 16-byte aligned), and many tiles (R = 70,000 at H = 128:
#: the dh product's 64 x 64 mma.sync tiles fill the 132 SMs 16 times over)
ENGINE_BPTT = [(1, 1000, 128), (7, 17, 128), (3, 333, 97), (2, 70000, 128)]


#: the resident BPTT (H <= 81) at its edges: the widest resident H (odd,
#: its w_hh^T rows not a multiple of 4), H = 3 (a 4 x 4 dW block wider
#: than H), one step (no recurrent product), and the N=500 step's shape
#: (R = 500,000), held to float64
RESIDENT_BPTT = [(7, 1001, 81), (7, 999, 3), (1, 1000, 32), (7, 500000, 32)]
#: the resident forward at its edges (its BPTT on the engine path): the
#: widest resident H (116), the two just past it (117, 118: the wide
#: kernel), and one step at the widest, all at ragged R
RESIDENT_FWD = [(7, 1001, 116), (7, 1003, 117), (7, 997, 118),
                (1, 1001, 116)]


@pytest.mark.parametrize("with_dcs", [False, True])
@pytest.mark.parametrize("T,R,H", [(7, 8836, 32), (7, 1001, 8),
                                   (5, 333, 64), (3, 17, 40)]
                         + RESIDENT_BPTT + RESIDENT_FWD
                         + [(_T_OF.get(H, 7), R, H) for R, H in WIDE_LSTM]
                         + ENGINE_BPTT)
def test_lstm_train_kernels_match_plain(cuda_device, T, R, H, with_dcs):
    """Forward and BPTT against their plain versions, one host launch
    each; dW bit-equal to dw_reduce_plain of its partials and, with
    dx_proj, to a second run. H <= 81 takes the resident BPTT (no
    scratch), H > 81 the split-TF32 engine path. At R = 500,000 the plain
    versions run in float64 on the same inputs."""
    rng = np.random.default_rng(R + H)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(cuda_device)
    ref = (lambda a: a.double()) if R >= 500000 else (lambda a: a)
    opt = lambda a: None if a is None else ref(a)
    xp = t(rng.normal(size=(T, R, 4 * H)))
    w = t(rng.normal(size=(H, 4 * H)) / np.sqrt(H))
    before = [k.launches for k in (cuda_lstm.LSTM_TRAIN_FWD,
                                   cuda_lstm.LSTM_TRAIN_BWD)]
    hs, cs = cuda_lstm.lstm_layer_train(xp, w)
    hp, cp = cuda_lstm.lstm_layer_train_plain(ref(xp), ref(w))
    torch.testing.assert_close(ref(hs), hp, **KERNEL_TOL)
    torch.testing.assert_close(ref(cs), cp, **KERNEL_TOL)
    dhs = t(rng.normal(size=(T, R, H)))
    dcs = t(rng.normal(size=(T, R, H))) if with_dcs else None
    dxp, dw, part = cuda_lstm.lstm_layer_bwd_partials(xp, w, hs, cs, dhs,
                                                      dcs)
    torch.cuda.synchronize()
    assert [k.launches for k in (cuda_lstm.LSTM_TRAIN_FWD,
                                 cuda_lstm.LSTM_TRAIN_BWD)] == [
        b + 1 for b in before]
    engine = cuda_lstm.bwd_on_engine(cuda_lstm.device_index(cuda_device), H)
    assert engine == (H > 81)
    assert (cuda_lstm.bwd_scratch(R, H, cuda_device) is None) != engine
    dxr, dwr = cuda_lstm.lstm_layer_bwd_plain(ref(xp), ref(w), ref(hs),
                                              ref(cs), ref(dhs), opt(dcs))
    torch.testing.assert_close(ref(dxp), dxr, **KERNEL_TOL)
    _close_scaled(ref(dw), dwr)
    assert torch.equal(dw, cuda_lstm.dw_reduce_plain(part))
    dxp2, dw2 = cuda_lstm.lstm_layer_bwd(xp, w, hs, cs, dhs, dcs)
    assert torch.equal(dw, dw2), "dW differs between two runs"
    assert torch.equal(dxp, dxp2), "dx_proj differs between two runs"


@pytest.mark.parametrize("dynamic", [False, True])
@pytest.mark.parametrize("K,B,N,C,H,scale", [
    pytest.param(3, 4, 47, 32, 32, 1.0, id="3-4-47-32-32")]
    + _bdgcn_cases()[1:])
def test_bdgcn_bwd_kernel_matches_plain(cuda_device, dynamic, K, B, N, C, H,
                                        scale):
    h1, g, w = _bdgcn_inputs(cuda_device, K, B, N, C, H, dynamic, seed=N)
    h1, w = h1 * scale, w * scale
    dout = torch.from_numpy(np.random.default_rng(C).normal(
        size=(B, N, N, H)).astype(np.float32)).to(cuda_device) / scale
    before = cuda_bdgcn.BDGCN_PAIR_BWD.launches
    dh1, dW, part = cuda_bdgcn.folded_pair_project_bwd_partials(h1, g, w,
                                                                dout)
    torch.cuda.synchronize()
    assert cuda_bdgcn.BDGCN_PAIR_BWD.launches == before + 1
    r1, rW = cuda_bdgcn.folded_pair_project_bwd_plain(h1, g, w, dout)
    torch.testing.assert_close(dh1, r1, **KERNEL_TOL)
    _close_scaled(dW, rW)
    assert torch.equal(dW, cuda_lstm.dw_reduce_plain(part))
    _, dW2 = cuda_bdgcn.folded_pair_project_bwd(h1, g, w, dout)
    assert torch.equal(dW, dW2), "dW differs between two runs"


@pytest.mark.parametrize("entry,shape", [("lstm", (7, 8836, 32)),
                                         ("lstm", (5, 333, 64)),
                                         ("bdgcn", (3, 4, 47, 32, 32)),
                                         ("bdgcn", (5, 2, 33, 16, 64)),
                                         ("lstm", (7, 1000, 128)),
                                         ("bdgcn", (7, 2, 20, 128, 128)),
                                         ("lstm", (5, 1000, 256))])
def test_dw_reduce_kernel_matches_plain(cuda_device, entry, shape):
    """Each backward entry sums its per-block dW partials inside its own
    launch, in the plain version's order p = 0, 1, ...: its dW equals
    dw_reduce_plain of the partials it wrote to the last bit, and two runs
    give the same bits. One launch each, and none other."""
    rng = np.random.default_rng(sum(shape))
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(cuda_device)
    if entry == "lstm":
        T, R, H = shape
        xp = t(rng.normal(size=(T, R, 4 * H)))
        w = t(rng.normal(size=(H, 4 * H)) / np.sqrt(H))
        hs, cs = cuda_lstm.lstm_layer_train(xp, w)
        dhs = t(rng.normal(size=(T, R, H)))
        kernel = cuda_lstm.LSTM_TRAIN_BWD
        run = lambda: cuda_lstm.lstm_layer_bwd_partials(xp, w, hs, cs, dhs,
                                                        None)
        P = cuda_lstm.bwd_blocks(R, H, cuda_device)
    else:
        K, B, N, C, H = shape
        h1, g, wr = _bdgcn_inputs(cuda_device, K, B, N, C, H, True, seed=N)
        dout = t(rng.normal(size=(B, N, N, H)))
        kernel = cuda_bdgcn.BDGCN_PAIR_BWD
        run = lambda: cuda_bdgcn.folded_pair_project_bwd_partials(h1, g, wr,
                                                                  dout)
        P = cuda_bdgcn.bwd_blocks(B * N * N, K, C, H, cuda_device)
    before = kernel.launches
    _, dw, part = run()
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert part.shape[0] == P > 1
    assert torch.equal(dw, cuda_lstm.dw_reduce_plain(part))
    _, dw2, _ = run()
    assert torch.equal(dw, dw2), "dW differs between two runs"


def test_training_kernels_reject_what_they_do_not_take(cuda_device):
    xp = torch.zeros((7, 10, 4 * 32), device=cuda_device)
    w = torch.zeros((32, 128), device=cuda_device)
    with pytest.raises(TypeError, match="float32"):
        cuda_lstm.lstm_layer_train(xp.double(), w.double())
    # H = 128, refused before the wide kernels, is taken
    rng = np.random.default_rng(128)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(cuda_device)
    xw, ww = t(rng.normal(size=(7, 10, 512))), t(rng.normal(
        size=(128, 512)) / 8)
    hw, cw = cuda_lstm.lstm_layer_train(xw, ww)
    for a, b in zip((hw, cw), cuda_lstm.lstm_layer_train_plain(xw, ww)):
        torch.testing.assert_close(a, b, **KERNEL_TOL)
    dhw = t(rng.normal(size=(7, 10, 128)))
    dxw, dww = cuda_lstm.lstm_layer_bwd(xw, ww, hw, cw, dhw, None)
    dxr, dwr = cuda_lstm.lstm_layer_bwd_plain(xw, ww, hw, cw, dhw, None)
    torch.testing.assert_close(dxw, dxr, **KERNEL_TOL)
    _close_scaled(dww, dwr)
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
    # K = 6, refused before the wide kernels, is taken
    h6, g6, w6 = _bdgcn_inputs(cuda_device, 6, 1, 3, 2, 2, False)
    d6 = t(rng.normal(size=(1, 3, 3, 2)))
    r1, rW = cuda_bdgcn.folded_pair_project_bwd_plain(h6, g6, w6, d6)
    dh6, dW6 = cuda_bdgcn.folded_pair_project_bwd(h6, g6, w6, d6)
    torch.testing.assert_close(dh6, r1, **KERNEL_TOL)
    _close_scaled(dW6, rW)


def test_trainer_step_runs_the_training_kernels(cuda_device, tmp_path):
    """One ModelTrainer step at M=2, 1 LSTM layer, 3 BDGCN layers: exactly
    M = 2 launches of each LSTM training entry and M * 3 = 6 of each BDGCN
    entry (each backward entry sums its dW inside its one launch), no
    inference launch;
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
               "bdgcn_pair_bwd": cuda_bdgcn.BDGCN_PAIR_BWD}
    for k in kernels.values():
        k.launches = 0
    for t in (tr, plain):
        x, y, keys = t._tensors(batch)
        t._batch_loss(x, y, keys, batch.size).backward()
    torch.cuda.synchronize()
    assert {n: k.launches for n, k in kernels.items()} == {
        "lstm_infer_last": 0, "lstm_infer_collect": 0,
        "bdgcn_pair_fwd": 6, "ell_fwd": 0, "ell_fwd_q": 0,
        "lstm_infer_last_bf16": 0, "lstm_infer_collect_bf16": 0,
        "bdgcn_pair_fwd_bf16": 0,
        "lstm_train_fwd": 2, "lstm_train_bwd": 2, "bdgcn_pair_bwd": 6}
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


def test_wide_model_trains_and_serves_through_the_kernels(cuda_device,
                                                          tmp_path):
    """hidden 128 and dual_random_walk_diffusion of order 3 (K = 2 * 3 + 1
    = 7 supports), which the card refused before the wide kernels: one
    ModelTrainer step launches each training entry (M = 2 LSTM, M * 3 = 6
    BDGCN) and its gradients match the plain arms'; a ServeEngine answers
    through the inference kernels and matches the plain rollout."""
    cfg = MPGCNConfig(synthetic_T=120, synthetic_N=8, hidden_dim=128,
                      kernel_type="dual_random_walk_diffusion",
                      cheby_order=3, pred_len=1, seed=0,
                      output_dir=str(tmp_path))
    assert cfg.support_K == 7
    data = synthetic_dataset(cfg)
    tr = ModelTrainer(cfg, data, device=cuda_device)
    plain = ModelTrainer(cfg, data, device=cuda_device, lstm_impl="plain",
                         bdgcn_impl="einsum")
    plain.model.load_state_dict(tr.model.state_dict())
    batch = next(tr.pipeline.batches("train", pad_to_full=True))
    kernels = {**KERNELS, "lstm_train_fwd": cuda_lstm.LSTM_TRAIN_FWD,
               "lstm_train_bwd": cuda_lstm.LSTM_TRAIN_BWD,
               "bdgcn_pair_bwd": cuda_bdgcn.BDGCN_PAIR_BWD}
    for k in kernels.values():
        k.launches = 0
    for t in (tr, plain):
        x, y, keys = t._tensors(batch)
        t._batch_loss(x, y, keys, batch.size).backward()
    torch.cuda.synchronize()
    assert {n: k.launches for n, k in kernels.items() if k.launches} == {
        "bdgcn_pair_fwd": 6, "lstm_train_fwd": 2, "lstm_train_bwd": 2,
        "bdgcn_pair_bwd": 6}
    ref = dict(plain.model.named_parameters())
    for name, p in tr.model.named_parameters():
        torch.testing.assert_close(
            p.grad, ref[name].grad, rtol=1e-4,
            atol=1e-5 * float(ref[name].grad.abs().max()))

    scfg = cfg.replace(pred_len=3)
    eng = ServeEngine(scfg, data, ServeConfig(buckets=(1, 2),
                                              max_wait_ms=50.0,
                                              output_dir=str(tmp_path)),
                      device=cuda_device, allow_fresh=True)
    try:
        md = eng.pipeline.modes["test"]
        x = np.ascontiguousarray(md.x[:2])
        for k in KERNELS.values():
            k.launches = 0
        tickets = [eng.submit(x[i, ..., 0], int(md.keys[i]))
                   for i in range(2)]
        for t in tickets:
            assert t.wait(60) and t.ok, t.error
        launches = eng.stats()["kernel_launches"]
        assert launches["lstm_infer_last"] > 0
        assert launches["bdgcn_pair_fwd"] == 3 * launches["lstm_infer_last"]
        wide = MPGCN.from_config(eng.cfg, device=cuda_device,
                                 lstm_impl="plain", bdgcn_impl="einsum")
        wide.load_state_dict(eng.model.state_dict())
        ref = rollout(wide, eng.banks, torch.from_numpy(x).to(cuda_device),
                      torch.from_numpy(md.keys[:2].astype(np.int64)).to(
                          cuda_device), scfg.pred_len).cpu()
        preds = torch.from_numpy(np.stack([t.pred for t in tickets]))
        assert bool(torch.isfinite(preds).all())
        torch.testing.assert_close(preds, ref, **ROLLOUT_TOL)
    finally:
        eng.close()


# --- the ELL SpMM kernels -----------------------------------------------------

#: (stack shape, tile width, pattern, F, per-sample X): ragged N over several
#: column blocks, MB = 1 (block diagonal), MB = the column-block count
#: (dense), a banded N = 500 stack at the (8, 128) tile, F not a multiple of
#: any tile. The forward's edges: row groups of 8 row blocks over NB not a
#: multiple of 8 (13, 20, 25, 63), a group with no populated slot (a zero
#: band of 64 rows), a group whose row blocks meet disjoint column blocks,
#: tile widths that are no multiple of the mma depth 8 (3, 12), F below,
#: at and above the 32- and 64-column F tiles, and row groups that meet
#: more (128-wide) column blocks than the forward stages at once (random
#: N=300: three), so their sums take two batches. dX's edges: a tile width
#: that is a whole number of 16-byte chunks in f32 but not in bf16 or int8
#: and straddles a 16-column fragment (20), column blocks that no slot
#: names (zero columns: their dX is 0), F below, at and above its
#: 128-column F tile (100, 128, 130), x_div = 1, K and S, and column
#: blocks with more slots than its staging ring holds (band: up to 20 a
#: slice)
ELL_CASES = [((3, 21, 21), 8, "random", 5, False),
             ((2, 3, 21, 21), 8, "random", 700, True),
             ((3, 64, 64), 8, "diagonal", 513, False),
             ((2, 40, 40), 16, "dense", 37, True),
             ((3, 500, 500), 128, "band", 1000, False),
             ((2, 200, 200), 16, "zero band", 64, False),
             ((2, 160, 160), 8, "scatter", 65, True),
             ((3, 101, 101), 12, "random", 130, False),
             ((2, 45, 45), 3, "random", 3, True),
             ((2, 300, 300), 128, "random", 100, False),
             ((2, 90, 90), 20, "random", 70, False),
             ((2, 2, 100, 100), 16, "zero columns", 128, True)]


def _ell_case(dev, shape, bc, pattern, F, per_sample, payload, seed=0):
    """A container on the card, X and dout for it, and the stack's x_div."""
    rng = np.random.default_rng(seed + shape[-1] + F)
    N = shape[-1]
    A = rng.normal(size=shape).astype(np.float32)
    if pattern == "random":
        A *= rng.random(shape) < 0.3
        A[..., 1, :] = 0.0
    elif pattern == "diagonal":
        # row block i (8 rows) meets column block i only (bc = 8)
        A *= np.arange(N)[:, None] // bc == np.arange(N)[None, :] // bc
    elif pattern in ("band", "zero band"):
        d = np.abs(np.arange(N)[:, None] - np.arange(N)[None, :])
        A *= np.minimum(d, N - d) <= 12
        if pattern == "zero band":  # row group 1 (rows 64-127) holds no slot
            A[..., 64:128, :] = 0.0
    elif pattern == "scatter":
        # row block i meets column block 7 i mod NBc only: the 8 row blocks
        # of a group meet 8 different column blocks
        nbc = -(-N // bc)
        A *= (np.arange(N)[None, :] // bc
              == (7 * (np.arange(N)[:, None] // 8)) % nbc)
    elif pattern == "zero columns":
        # column blocks 1 and 2 hold no non-zero, so no slot names them
        A[..., bc:3 * bc] = 0.0
    ell = pack_payload(ell_from_dense(A, br=8, bc=bc), payload).to(dev)
    S = int(np.prod(shape[:-2]))
    G = shape[0] if per_sample else 1
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)
    X = t(rng.normal(size=(G, N, F)))
    dout = t(rng.normal(size=(S, N, F)))
    return ell, X, dout, S // G


@pytest.mark.parametrize("payload", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("shape,bc,pattern,F,per_sample", ELL_CASES)
def test_ell_fwd_and_dx_kernels_match_plain(cuda_device, payload, shape, bc,
                                            pattern, F, per_sample):
    ell, X, dout, x_div = _ell_case(cuda_device, shape, bc, pattern, F,
                                    per_sample, payload)
    cols, tiles, scale, t_ptr, t_slot = flat_stack(ell)
    if pattern == "diagonal":
        assert ell.pad_blocks == 1
    if pattern == "dense":
        assert ell.pad_blocks == -(-shape[-1] // bc)
    q = scale is not None
    fwd = cuda_ell.ELL_FWD_Q if q else cuda_ell.ELL_FWD
    dxk = cuda_ell.ELL_BWD_DX_Q if q else cuda_ell.ELL_BWD_DX
    before = (fwd.launches, dxk.launches)
    n = shape[-1]
    out = cuda_ell.ell_fwd(cols, tiles, t_ptr, t_slot, X, n, x_div, scale)
    dx = cuda_ell.ell_bwd_dx(cols, tiles, t_ptr, t_slot, dout, n, x_div,
                             scale)
    torch.cuda.synchronize()
    assert (fwd.launches, dxk.launches) == (before[0] + 1, before[1] + 1)
    torch.testing.assert_close(
        out, cuda_ell.ell_fwd_plain(cols, tiles, X, n, x_div, scale),
        **KERNEL_TOL)
    out2 = cuda_ell.ell_fwd(cols, tiles, t_ptr, t_slot, X, n, x_div, scale)
    assert torch.equal(out, out2), "the forward differs between two runs"
    torch.testing.assert_close(
        dx, cuda_ell.ell_bwd_dx_plain(cols, tiles, dout, n, x_div, scale),
        **KERNEL_TOL)
    dx2 = cuda_ell.ell_bwd_dx(cols, tiles, t_ptr, t_slot, dout, n, x_div,
                              scale)
    assert torch.equal(dx, dx2), "dX differs between two runs"
    if pattern == "zero columns":
        assert not bool((cols.reshape(-1) == 1).any())
        assert bool((dx[:, bc:3 * bc] == 0).all())
    if pattern == "band":
        assert int((t_ptr[:, 1:] - t_ptr[:, :-1]).max()) > 8
    if q:  # one scale per (slice, row block), not one for the stack
        assert len(torch.unique(scale)) > 1


@pytest.mark.parametrize("payload", ["f32", "bf16", "int8"])
def test_ell_dx_reads_unaligned_dout(cuda_device, payload):
    """dout whose F is a multiple of 4 but whose data does not start on a
    16-byte boundary: dX stages it with 4-byte copies, and matches the
    aligned call bit for bit."""
    ell, _, dout, x_div = _ell_case(cuda_device, (3, 60, 60), 8, "random",
                                    64, False, payload)
    cols, tiles, scale, t_ptr, t_slot = flat_stack(ell)
    buf = torch.empty(dout.numel() + 1, device=cuda_device)
    moved = buf[1:].view(dout.shape)
    moved.copy_(dout)
    assert moved.data_ptr() % 16 != 0 and moved.is_contiguous()
    dx = cuda_ell.ell_bwd_dx(cols, tiles, t_ptr, t_slot, moved, 60, x_div,
                             scale)
    torch.testing.assert_close(
        dx, cuda_ell.ell_bwd_dx_plain(cols, tiles, dout, 60, x_div, scale),
        **KERNEL_TOL)
    assert torch.equal(dx, cuda_ell.ell_bwd_dx(cols, tiles, t_ptr, t_slot,
                                               dout, 60, x_div, scale))


def _same_non_finite(out, ref, close=None):
    """out holds Inf and NaN where ref does, each Inf of ref's sign (the
    card's non-finite values: a NaN from Inf - Inf has bits 0x7fffffff);
    the finite entries match at KERNEL_TOL, or by ``close``."""
    bad = ~torch.isfinite(ref)
    assert 0 < int(bad.sum()) < bad.numel()
    assert torch.equal(~torch.isfinite(out), bad)
    assert torch.equal(torch.isnan(out), torch.isnan(ref))
    inf = torch.isinf(ref)
    assert torch.equal(out[inf], ref[inf])
    (close or (lambda a, b: torch.testing.assert_close(a, b, **KERNEL_TOL)))(
        out[~bad], ref[~bad])


@pytest.mark.parametrize("payload", ["f32", "bf16", "int8"])
def test_ell_dx_non_finite_dout(cuda_device, payload):
    """An Inf, a -Inf and a NaN in dout, on a band (BC = 128) whose slots
    leave most 16-column fragments of their tiles zero: each makes its
    column of dX non-finite in every row (inside n_cols) of each column
    block that a slot of its row block names, whatever the fragments, pad
    slots (zero tiles naming column block 0) included, as the plain sum
    does (0 x Inf is NaN); each Inf of the plain sum's sign. The NaN is
    made on the card (Inf - Inf: bits 0x7fffffff, which a TF32 split's
    rounding add would carry into the sign). Every finite entry matches
    the plain version."""
    ell, _, dout, x_div = _ell_case(cuda_device, (3, 200, 200), 128, "band",
                                    160, False, payload)
    cols, tiles, scale, t_ptr, t_slot = flat_stack(ell)
    MB, n = cols.shape[-1], 200
    inf = torch.full((), float("inf"), device=cuda_device)
    bad = [(0, 70, 5, inf), (1, 150, 33, -inf), (2, 199, 150, inf - inf)]
    populated = torch.zeros((1, n, dout.shape[-1]), dtype=torch.bool)
    for s, r, f, v in bad:
        dout[s, r, f] = v
        ptr, slots = t_ptr[s].cpu(), t_slot[s].cpu()
        for c in range(len(ptr) - 1):
            if bool((slots[ptr[c]:ptr[c + 1]] // MB == r // 8).any()):
                populated[s // x_div, c * 128:(c + 1) * 128, f] = True
    dx = cuda_ell.ell_bwd_dx(cols, tiles, t_ptr, t_slot, dout, n, x_div,
                             scale)
    ref = cuda_ell.ell_bwd_dx_plain(cols, tiles, dout, n, x_div, scale)
    _same_non_finite(dx, ref)
    # the pad slot of row 150's row block adds column block 0 to the
    # blocks its populated slots name
    mask = ~torch.isfinite(ref).cpu()
    assert bool((mask & ~populated).any()) and bool((mask | ~populated).all())


def _put_non_finite(dev, a, at):
    """a with +Inf, -Inf and a card-made NaN (Inf - Inf) at the flat
    indices ``at``."""
    a = a.clone()
    inf = torch.full((), float("inf"), device=dev)
    flat = a.view(-1)
    for i, v in zip(at, (inf, -inf, inf - inf)):
        flat[i] = v
    return a


@pytest.mark.parametrize("entry,operand", [
    *[("ell_fwd", p) for p in ("f32", "bf16", "int8")],
    *[(e, o) for e in ("ell_fwd", "ell_bwd_dx")
      for o in ("tile-f32", "tile-bf16", "scale-int8")], ("ell_bwd_dblk", "x"),
    ("ell_bwd_dblk", "dout"), *[("bdgcn_pair_fwd", o) for o in ("h1", "g",
                                                               "w")],
    *[("bdgcn_pair_bwd", o) for o in ("h1", "g", "w", "dout")],
    ("lstm_train_bwd_engine", "dhs"), ("lstm_train_bwd_resident", "dhs"),
    *[("lstm_fwd_wide", o) for o in ("x_proj", "w_hh", "x")],
    *[("bdgcn_pair_fwd_bf16", o) for o in ("h1", "g", "w")],
    *[("bdgcn_pair_bwd_bf16", o) for o in ("h1", "g", "w", "dout")],
    ("lstm_train_bwd_engine_bf16", "dhs"),
    ("lstm_train_bwd_resident_bf16", "dhs"),
    *[("lstm_fwd_wide_bf16", o) for o in ("x_proj", "w_hh", "x")]],
    ids="-".join)
def test_split_tf32_entries_keep_inf_and_nan(cuda_device, entry, operand):
    """Every split-TF32 entry (and the resident BPTT, on the CUDA cores,
    as a guard) with an Inf, a -Inf and a card-made NaN (bits 0x7fffffff)
    in one operand: Inf and NaN where the plain version has them, each Inf
    of its sign; every finite entry matches. The ELL forward's X holds them
    in k steps that a row group skips (a band: its rows meet only part of
    a column block), in column block 0, which pad slots name for row
    blocks that meet only column block 1, in a fragment's zero rows, and
    in a column that every tile leaves zero inside the k steps the
    products take; f32, bf16 and int8 tiles. The ELL forward and dX also take them in
    populated f32 and bf16 tiles (one in columns past n_cols, which meet
    X rows that read 0) and in int8 scales, of row blocks with and
    without pad slots; X one per slice there, so that other slices stay
    finite. dX's dout has its own test above. The wide LSTM forward
    (H = 128) takes them in x_proj (the NaN at step 1: its row is NaN from
    there on), w_hh^T (0 x Inf is NaN in the plain sum at t = 0, so every
    later step is NaN: the outputs of every step) and x (the fused form).
    The cases ending in _bf16 run the same on the bf16 forms (operands
    cast to bf16 first; finite entries held at ``BF16_TOL``)."""
    dev = cuda_device
    put = functools.partial(_put_non_finite, dev)
    bf16 = entry.endswith("_bf16")
    entry = entry.removesuffix("_bf16")
    cast = (lambda a: a.to(torch.bfloat16)) if bf16 else (lambda a: a)
    same = functools.partial(
        _same_non_finite, close=lambda a, b: _bf16_close(
            a, b, max(1.0, float(b.float().abs().max())))) if bf16 \
        else _same_non_finite
    if operand.startswith(("tile", "scale")):
        payload = operand.split("-")[1]
        ell, X, dout, x_div = _ell_case(dev, (3, 200, 200), 128, "band", 160,
                                        operand == "scale-int8", payload)
        cols, tiles, scale, t_ptr, t_slot = flat_stack(ell)

        def call(tiles, scale):
            if entry == "ell_fwd":
                return cuda_ell.ell_fwd(cols, tiles, t_ptr, t_slot, X, 200,
                                        x_div, scale)
            return cuda_ell.ell_bwd_dx(cols, tiles, t_ptr, t_slot, dout, 200,
                                       x_div, scale)

        clean = call(tiles, scale)
        finite = (tiles, scale)
        if operand == "scale-int8":
            # row blocks 5 and 18 hold a pad slot, 24 none
            scale = put(scale, [5, 18, cols.shape[1] + 24])
        else:
            # populated slots of slices 0, 1, 2; the second on column
            # block 1, its column 100 past n_cols = 200
            per_slice = cols.shape[1] * cols.shape[2]  # NB * MB
            at = []
            for s, c, (r, k) in ((0, 0, (3, 100)), (1, 1, (0, 100)),
                                 (2, 0, (7, 64))):
                slot = int(t_slot[s, int(t_ptr[s, c])])
                at.append(((s * per_slice + slot) * 8 + r) * 128 + k)
            tiles = put(tiles, at)
        out = call(tiles, scale)
        if entry == "ell_fwd":
            ref = cuda_ell.ell_fwd_plain(cols, tiles, X, 200, x_div, scale)
        else:
            ref = cuda_ell.ell_bwd_dx_plain(cols, tiles, dout, 200, x_div,
                                            scale)
        _same_non_finite(out, ref)
        # this call's marks (its generation) do not reach the next call:
        # finite operands again give the first call's bits
        assert torch.equal(call(*finite), clean)
        return
    if entry == "ell_fwd":
        ell, X, _, x_div = _ell_case(dev, (3, 200, 200), 128, "band", 160,
                                     False, operand)
        cols, tiles, scale, t_ptr, t_slot = flat_stack(ell)
        F = X.shape[-1]
        X_clean = X
        X = put(X, [150 * F + 7, 60 * F + 40, 5 * F + 130])
        out = cuda_ell.ell_fwd(cols, tiles, t_ptr, t_slot, X, 200, x_div,
                               scale)
        ref = cuda_ell.ell_fwd_plain(cols, tiles, X, 200, x_div, scale)
        _same_non_finite(out, ref)
        # rows 144.. meet only column block 1: X row 60 reaches them
        # through their pad slots alone
        assert not bool(torch.isfinite(ref[:, 144:176, 40]).any())
        # column 60 of every tile zero, inside the k steps that row group
        # 0 multiplies on both column blocks: X rows 60 and 188 reach the
        # products only as 0 x Inf and 0 x NaN
        tiles = tiles.clone()
        tiles[..., 60] = 0
        X = put(X_clean, [60 * F + 3, 188 * F + 5, 60 * F + 9])
        out = cuda_ell.ell_fwd(cols, tiles, t_ptr, t_slot, X, 200, x_div,
                               scale)
        ref = cuda_ell.ell_fwd_plain(cols, tiles, X, 200, x_div, scale)
        _same_non_finite(out, ref)
        return
    if entry == "ell_bwd_dblk":
        ell, X, dout, x_div = _ell_case(dev, (3, 200, 200), 128, "band",
                                        160, False, "f32", seed=3)
        cols = flat_stack(ell)[0]
        F = X.shape[-1]
        if operand == "x":
            X = put(X, [150 * F + 7, 60 * F + 40, 5 * F + 130])
        else:
            dout = put(dout, [70 * F + 3, (200 + 150) * F + 33,
                              (400 + 199) * F + 100])
        out = cuda_ell.ell_bwd_dblk(cols, X, dout, 128, x_div)
        ref = cuda_ell.ell_bwd_dblk_plain(cols, X, dout, 128, x_div)
        _same_non_finite(out, ref, _close_scaled)
        return
    if entry.startswith("bdgcn"):
        K, B, N, C, H = 3, 2, 20, 32, 32
        h1, g, w = map(cast, _bdgcn_inputs(dev, K, B, N, C, H, True,
                                           seed=N))
        ops = {"h1": h1, "g": g, "w": w}
        if entry == "bdgcn_pair_bwd":
            ops["dout"] = cast(torch.from_numpy(np.random.default_rng(
                C).normal(size=(B, N, N, H)).astype(np.float32)).to(dev))
        n = ops[operand].numel()
        ops[operand] = put(ops[operand], [n // 7, n // 3, n - 5])
        if entry == "bdgcn_pair_fwd":
            out = cuda_bdgcn.folded_pair_project(ops["h1"], ops["g"],
                                                 ops["w"])
            ref = cuda_bdgcn.folded_pair_project_plain(ops["h1"], ops["g"],
                                                       ops["w"])
            same(out, ref)
            return
        args = (ops["h1"], ops["g"], ops["w"], ops["dout"])
        dh1, dW = cuda_bdgcn.folded_pair_project_bwd(*args)
        r1, rW = cuda_bdgcn.folded_pair_project_bwd_plain(*args)
        same(torch.cat([dh1.reshape(-1), dW.reshape(-1)]),
             torch.cat([r1.reshape(-1), rW.to(r1.dtype).reshape(-1)]))
        return
    if entry == "lstm_fwd_wide":
        T, R, H = 7, 333, 128
        assert cuda_lstm.fwd_on_wide(cuda_lstm.device_index(dev), H)
        if operand == "x":
            x, w_ih, b, w = map(cast, _fused_inputs(dev, T, R, H, 1, seed=H))
            # x (R, T, 1): rows 10, 200 at steps 1, 3; row 300's NaN at 0
            x = put(x, [10 * T + 1, 200 * T + 3, 300 * T])
            outs = [cuda_lstm.lstm_layer_infer_fused(x, w_ih, b, w, c)
                    for c in (False, True)]
            refs = [cuda_lstm.lstm_layer_infer_fused_plain(x, w_ih, b, w, c)
                    for c in (False, True)]
        else:
            rng = np.random.default_rng(R + H)
            t = lambda a: cast(torch.from_numpy(a.astype(np.float32)).to(
                dev))
            xp = t(rng.normal(size=(T, R, 4 * H)))
            w = t(rng.normal(size=(H, 4 * H)) / np.sqrt(H))
            if operand == "x_proj":
                xp = put(xp, [(3 * R + 20) * 4 * H + 7,
                              (5 * R + 100) * 4 * H + 300,
                              (R + 200) * 4 * H + 5])
            else:
                w = put(w, [5 * 4 * H + 3, 70 * 4 * H + 260,
                            127 * 4 * H + 511])
            outs = [cuda_lstm.lstm_layer_infer(xp, w, True),
                    *cuda_lstm.lstm_layer_train(xp, w)]
            refs = [cuda_lstm.lstm_layer_infer_plain(xp, w, True),
                    *cuda_lstm.lstm_layer_train_plain(xp, w)]
            if operand == "x_proj":
                outs.append(cuda_lstm.lstm_layer_infer(xp, w, False))
                refs.append(cuda_lstm.lstm_layer_infer_plain(xp, w, False))
        for out, ref in zip(outs, refs):
            same(out, ref)
        return
    T, R, H = (3, 333, 97) if entry.endswith("engine") else (7, 1001, 32)
    assert cuda_lstm.bwd_on_engine(cuda_lstm.device_index(dev), H) == (
        entry.endswith("engine"))
    rng = np.random.default_rng(R + H)
    t = lambda a: cast(torch.from_numpy(a.astype(np.float32)).to(dev))
    xp = t(rng.normal(size=(T, R, 4 * H)))
    w = t(rng.normal(size=(H, 4 * H)) / np.sqrt(H))
    hs, cs = cuda_lstm.lstm_layer_train(xp, w)
    dhs = put(t(rng.normal(size=(T, R, H))),
              [((T - 1) * R + 10) * H + 3, ((T - 1) * R + 200) * H + 1,
               (R + 300) * H + 7])
    dxp, dw = cuda_lstm.lstm_layer_bwd(xp, w, hs, cs, dhs, None)
    dxr, dwr = cuda_lstm.lstm_layer_bwd_plain(xp, w, hs, cs, dhs, None)
    same(torch.cat([dxp.reshape(-1), dw.reshape(-1)]),
         torch.cat([dxr.reshape(-1), dwr.to(dxr.dtype).reshape(-1)]))


@pytest.mark.parametrize("payload", ["f32", "int8"])
def test_ell_dx_n500_against_float64(cuda_device, payload):
    """dX at the static N=500 shape (S = 3 shared by one X, NB = 63,
    MB = 2, BC = 128, a band of density 0.05, F = 32,000) against the plain
    version in float64: the split-TF32 products stay within rtol 1e-5 /
    atol 1e-5 of the exact sum. Bit-equal over two runs."""
    ell, _, dout, x_div = _ell_case(cuda_device, (3, 500, 500), 128,
                                    "band", 32000, False, payload)
    cols, tiles, scale, t_ptr, t_slot = flat_stack(ell)
    assert (cols.shape, x_div) == ((3, 63, 2), 3)
    dx = cuda_ell.ell_bwd_dx(cols, tiles, t_ptr, t_slot, dout, 500, x_div,
                             scale)
    ref = cuda_ell.ell_bwd_dx_plain(
        cols, tiles if scale is not None else tiles.double(), dout.double(),
        500, x_div, None if scale is None else scale.double())
    torch.testing.assert_close(dx.double(), ref, **KERNEL_TOL)
    assert torch.equal(dx, cuda_ell.ell_bwd_dx(cols, tiles, t_ptr, t_slot,
                                               dout, 500, x_div, scale))


@pytest.mark.parametrize("payload", ["f32", "bf16", "int8"])
def test_ell_fwd_sums_repeated_column_ids(cuda_device, payload):
    """ell_from_dense never gives a row block two slots on one column
    block, but the kernel takes such a stack: the two tiles are summed into
    the staged operand, and the sum is split into TF32 parts as f32 tiles
    are."""
    rng = np.random.default_rng(11)
    S, NB, MB, bc, N, F = 2, 11, 3, 16, 84, 70
    nbc = -(-N // bc)
    cols = rng.integers(0, nbc, size=(S, NB, MB))
    cols[:, ::2, 1] = cols[:, ::2, 0]            # every other row block
    tiles = rng.normal(size=(S, NB, MB, 8, bc)).astype(np.float32)
    taken = np.ones((S, NB, MB), bool)
    t_ptr, t_slot = formats._transposed_index(cols, taken, nbc)
    ell = pack_payload(BlockedELL(
        torch.from_numpy(cols.astype(np.int32)), torch.from_numpy(tiles),
        torch.from_numpy(t_ptr), torch.from_numpy(t_slot), N, N),
        payload).to(cuda_device)
    c, t, scale, tp, ts = flat_stack(ell)
    X = torch.from_numpy(rng.normal(size=(1, N, F)).astype(
        np.float32)).to(cuda_device)
    out = cuda_ell.ell_fwd(c, t, tp, ts, X, N, S, scale)
    torch.testing.assert_close(
        out, cuda_ell.ell_fwd_plain(c, t, X, N, S, scale), **KERNEL_TOL)


@pytest.mark.parametrize("shape,bc,pattern,F,per_sample", ELL_CASES)
def test_ell_dblk_kernel_matches_plain(cuda_device, shape, bc, pattern, F,
                                       per_sample):
    ell, X, dout, x_div = _ell_case(cuda_device, shape, bc, pattern, F,
                                    per_sample, "f32", seed=1)
    cols = flat_stack(ell)[0]
    before = cuda_ell.ELL_BWD_DBLK.launches
    dblk = cuda_ell.ell_bwd_dblk(cols, X, dout, bc, x_div)
    torch.cuda.synchronize()
    assert cuda_ell.ELL_BWD_DBLK.launches == before + 1
    _close_scaled(dblk, cuda_ell.ell_bwd_dblk_plain(cols, X, dout, bc, x_div))
    assert torch.equal(dblk, cuda_ell.ell_bwd_dblk(cols, X, dout, bc, x_div))


@pytest.mark.parametrize("shape,bc,pattern,F,per_sample", [
    ((1, 256, 256), 16, "dense", 96, False),
    ((3, 300, 300), 128, "band", 37, False),
    ((2, 3, 150, 150), 12, "band", 130, True)])
def test_ell_dblk_slot_tiles_and_pad_slots(cuda_device, shape, bc, pattern,
                                           F, per_sample):
    """dBlocks gathers up to 16 slots on one column block per tile: a
    column block named by more than 16 slots of an X group takes several
    tiles, pad slots (column 0, zero tiles) take their cotangent like any
    slot, and F % 4 != 0 stages with 4-byte copies. Bit-equal over two
    runs."""
    ell, X, dout, x_div = _ell_case(cuda_device, shape, bc, pattern, F,
                                    per_sample, "f32", seed=2)
    cols = flat_stack(ell)[0]
    S, NB, MB = cols.shape
    per_group = cols.reshape(S // x_div, -1)
    most = max(int((per_group == c).sum(1).max())
               for c in range(-(-shape[-1] // bc)))
    assert most > 16
    if pattern == "band":
        assert bool((ell.blocks.reshape(S, NB, MB, -1) == 0).all(-1).any())
    dblk = cuda_ell.ell_bwd_dblk(cols, X, dout, bc, x_div)
    _close_scaled(dblk, cuda_ell.ell_bwd_dblk_plain(cols, X, dout, bc, x_div))
    assert torch.equal(dblk, cuda_ell.ell_bwd_dblk(cols, X, dout, bc, x_div))


def test_ell_dblk_pad_free_n500_against_float64(cuda_device):
    """dBlocks at the pad-free N=500 shape (S = 3, NB = 63, MB = 4,
    F = 32,000, its F split into chunks) against the plain version in
    float64: the TF32 split products and the chunked f32 sums over F stay
    within rtol 1e-5 and 1e-6 x the largest entry."""
    rng = np.random.default_rng(500)
    N, F = 500, 32000
    ell = ell_from_dense(rng.normal(size=(3, N, N)).astype(np.float32)).to(
        cuda_device)
    assert ell.pad_blocks == 4
    X = torch.from_numpy(rng.normal(size=(1, N, F)).astype(
        np.float32)).to(cuda_device)
    dout = torch.from_numpy(rng.normal(size=(3, N, F)).astype(
        np.float32)).to(cuda_device)
    cols = ell.block_cols
    dblk = cuda_ell.ell_bwd_dblk(cols, X, dout, 128, 3)
    ref = cuda_ell.ell_bwd_dblk_plain(cols, X.double(), dout.double(), 128, 3)
    _close_scaled(dblk.double(), ref)
    assert torch.equal(dblk, cuda_ell.ell_bwd_dblk(cols, X, dout, 128, 3))


def test_ell_autograd_launches_dblk_only_for_tiles_that_need_it(cuda_device):
    ell, X, dout, _ = _ell_case(cuda_device, (3, 21, 21), 8, "random", 9,
                                False, "f32")
    Xg = X[0].clone().requires_grad_()
    counts = lambda: (cuda_ell.ELL_BWD_DX.launches,
                      cuda_ell.ELL_BWD_DBLK.launches)
    before = counts()
    ell_spmm(ell, Xg).backward(dout)
    assert counts() == (before[0] + 1, before[1])
    blocks = ell.blocks.clone().requires_grad_()
    el = BlockedELL(ell.block_cols, blocks, ell.t_ptr, ell.t_slot, 21, 21)
    (dblk,) = torch.autograd.grad((ell_spmm(el, X[0]) * dout).sum(), blocks)
    torch.cuda.synchronize()
    assert counts() == (before[0] + 1, before[1] + 1)
    assert dblk.shape == blocks.shape
    # the int8 payload's codes and scales are data: dX only
    q = pack_payload(ell.to("cpu"), "int8").to(cuda_device)
    scale = q.blocks.scale.clone().requires_grad_()
    qel = BlockedELL(q.block_cols, QuantizedTensor(q.blocks.q, scale),
                     q.t_ptr, q.t_slot, 21, 21)
    Xq = X[0].clone().requires_grad_()
    before_q = cuda_ell.ELL_BWD_DX_Q.launches
    ell_spmm(qel, Xq).backward(dout)
    torch.cuda.synchronize()
    assert cuda_ell.ELL_BWD_DX_Q.launches == before_q + 1
    assert Xq.grad is not None and scale.grad is None


def test_ell_kernels_reject_what_they_do_not_take(cuda_device):
    ell, X, dout, x_div = _ell_case(cuda_device, (3, 21, 21), 8, "random", 5,
                                    False, "f32")
    cols, tiles, _, t_ptr, t_slot = flat_stack(ell)
    with pytest.raises(ValueError, match="float32"):
        cuda_ell.ell_fwd(cols, tiles, t_ptr, t_slot, X.double(), 21, x_div)
    with pytest.raises(TypeError, match="int32"):
        cuda_ell.ell_fwd(cols.long(), tiles, t_ptr, t_slot, X, 21, x_div)
    with pytest.raises(TypeError, match="tiles"):
        cuda_ell.ell_fwd(cols, tiles.half(), t_ptr, t_slot, X, 21, x_div)
    with pytest.raises(ValueError, match="x_div"):
        cuda_ell.ell_fwd(cols, tiles, t_ptr, t_slot, X, 21, 2)
    with pytest.raises(ValueError, match="transposed index"):
        cuda_ell.ell_fwd(cols, tiles, t_ptr[:, :-1], t_slot, X, 21, x_div)
    with pytest.raises(ValueError, match="transposed index"):
        cuda_ell.ell_fwd(cols, tiles, t_ptr, t_slot[:, 1:], X, 21, x_div)
    with pytest.raises(ValueError, match="transposed index"):
        cuda_ell.ell_fwd(cols, tiles, t_ptr.long(), t_slot, X, 21, x_div)
    with pytest.raises(ValueError, match="transposed index"):
        cuda_ell.ell_fwd(cols, tiles, t_ptr, t_slot.long(), X, 21, x_div)
    with pytest.raises(ValueError, match="transposed index"):
        cuda_ell.ell_bwd_dx(cols, tiles, t_ptr[:, :2], t_slot, dout, 21,
                            x_div)
    with pytest.raises(ValueError, match="dout"):
        cuda_ell.ell_bwd_dblk(cols, X, dout[:1], 8, x_div)


def test_trainer_step_runs_the_ell_kernels(cuda_device, tmp_path):
    """A ModelTrainer step on banded N=136 supports, where 'auto' resolves
    to the ELL arm: M * 3 layers * (1 + K) = 24 launches of ell_fwd and of
    ell_bwd_dx, none of dBlocks or of the dense BDGCN kernels; gradients
    match the dense plain arms'."""
    cfg = MPGCNConfig(synthetic_T=60, synthetic_N=136, hidden_dim=8,
                      batch_size=2, pred_len=1, seed=0, sparse_min_nodes=64,
                      output_dir=str(tmp_path))
    data = synthetic_dataset(cfg)
    apply_density(data, 0.05)
    tr = ModelTrainer(cfg, data, device=cuda_device)
    assert tr.bdgcn_impl == "ell"
    plain = ModelTrainer(cfg, data, device=cuda_device, lstm_impl="plain",
                         bdgcn_impl="einsum")
    plain.model.load_state_dict(tr.model.state_dict())
    batch = next(tr.pipeline.batches("train", pad_to_full=True))
    kernels = {"ell_fwd": cuda_ell.ELL_FWD, "ell_bwd_dx": cuda_ell.ELL_BWD_DX,
               "ell_bwd_dblk": cuda_ell.ELL_BWD_DBLK,
               "bdgcn_pair_fwd": cuda_bdgcn.BDGCN_PAIR_FWD,
               "bdgcn_pair_bwd": cuda_bdgcn.BDGCN_PAIR_BWD}
    for k in kernels.values():
        k.launches = 0
    for t in (tr, plain):
        x, y, keys = t._tensors(batch)
        t._batch_loss(x, y, keys, batch.size).backward()
    torch.cuda.synchronize()
    assert {n: k.launches for n, k in kernels.items()} == {
        "ell_fwd": 24, "ell_bwd_dx": 24, "ell_bwd_dblk": 0,
        "bdgcn_pair_fwd": 0, "bdgcn_pair_bwd": 0}
    ref = dict(plain.model.named_parameters())
    for name, p in tr.model.named_parameters():
        torch.testing.assert_close(
            p.grad, ref[name].grad, rtol=1e-4,
            atol=1e-5 * float(ref[name].grad.abs().max()))


# --- the scan executor's CUDA graphs ------------------------------------------

#: the hand-written kernels' device names (csrc/: every __global__)
_OWN_KERNELS = ("lstm_", "tf32_", "ell_")


def _graph_pair(dev, tmp_path, **kw):
    """A trainer on the scan executor (graphs) and one on the per-step
    executor, from the same seeded init."""
    cfg = MPGCNConfig(synthetic_T=120, synthetic_N=10, pred_len=1, seed=0,
                      output_dir=str(tmp_path), **kw)
    data = synthetic_dataset(cfg)
    a = ModelTrainer(cfg, data, device=dev)
    b = ModelTrainer(cfg.replace(epoch_scan=False), data, device=dev)
    assert a.graph_refusal is None
    return a, b


def _steps(a, b, mode, n):
    """n steps of ``mode`` on the executor (two eager warm-ups, the
    capture, replays) and by the per-step calls; their losses."""
    ep = a._epoch_state(mode)
    ep.load(*a._epoch_index(mode, False, None))
    for _ in range(n):
        a._exec_step(mode, ep, mode == "train")
    if mode == "train":
        a.optimizer.advance(n)
    step = b.train_step if mode == "train" else b.eval_step
    ref = [step(x) for x in list(b.pipeline.batches(
        mode, pad_to_full=True))[:n]]
    return ep.losses[:n].cpu().numpy(), np.array(ref, np.float32)


def _assert_same_state(a, b):
    for (n, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(p, q), n
    for sa, sb in zip(a.optimizer.state.values(), b.optimizer.state.values()):
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(sa[k], sb[k]), k
    if a.optimizer.scaler is not None:
        assert a.optimizer.scaler.stats() == b.optimizer.scaler.stats()


@pytest.mark.parametrize("kw", [
    dict(hidden_dim=32),
    dict(hidden_dim=128, kernel_type="dual_random_walk_diffusion",
         cheby_order=3),
    dict(hidden_dim=32, dtype="bfloat16"),
    dict(hidden_dim=128, kernel_type="dual_random_walk_diffusion",
         cheby_order=3, dtype="bfloat16", remat=True)],
    ids=["hidden32", "hidden128-K7", "hidden32-bf16", "hidden128-K7-bf16"])
def test_captured_steps_equal_eager(cuda_device, tmp_path, kw):
    """Five train steps and four eval steps by graph equal the per-step
    executor's bit for bit: losses, weights, Adam's state (and the loss
    scaler's). At hidden 128 the graph holds the engine BPTT and both
    cooperative dW launches; in bf16 their bf16 forms and the scaler, and
    at hidden 128 in bf16 remat (the forwards again inside the
    backward)."""
    a, b = _graph_pair(cuda_device, tmp_path, **kw)
    for mode, n in (("train", 5), ("validate", 4)):
        got, ref = _steps(a, b, mode, n)
        assert np.array_equal(got, ref), (mode, got, ref)
        assert a._graphs.get(mode) is not None
    _assert_same_state(a, b)


def test_bf16_scaler_skips_inside_a_graph(cuda_device, tmp_path):
    """bf16 training with an Inf forced into the scaled gradients of two
    steps inside the captured step (a hook multiplies one weight's
    gradient by a device scalar the graph reads): the scaler skips them
    (weights and Adam's state kept, the scale halved, the losses finite
    and unmarked). Eight steps by graph equal the per-step executor's bit
    for bit, the scaler's state included."""
    a, b = _graph_pair(cuda_device, tmp_path, hidden_dim=32,
                       dtype="bfloat16")
    poison = {}
    for tr in (a, b):
        poison[id(tr)] = t = torch.ones((), device=cuda_device)
        next(tr.model.parameters()).register_hook(lambda g, t=t: g * t)
    n, bad = 8, (3, 6)
    ep = a._epoch_state("train")
    ep.load(*a._epoch_index("train", False, None))
    for i in range(n):
        poison[id(a)].fill_(float("inf") if i in bad else 1.0)
        a._exec_step("train", ep, True)
    a.optimizer.advance(n)
    got = ep.losses[:n].cpu().numpy()
    ref = []
    for i, x in enumerate(list(b.pipeline.batches(
            "train", pad_to_full=True))[:n]):
        poison[id(b)].fill_(float("inf") if i in bad else 1.0)
        ref.append(b.train_step(x))
    assert np.array_equal(got, np.array(ref, np.float32))
    assert np.isfinite(got).all() and a._graphs.get("train") is not None
    _assert_same_state(a, b)
    assert a.optimizer.scaler.stats() == {
        "scale": 65536.0 / 4, "good_steps": 1, "skipped_steps": 2}
    assert int(a.optimizer.step_t) == n - 2


def test_bf16_rollout_graphs_per_precision(cuda_device, tmp_path):
    """A serve engine at -infer-precision bf16 and one at int8: each
    bucket's rollout graph is keyed by its precision, equals the eager
    rollout at that precision bit for bit, runs the bf16 kernels (bf16)
    or the f32 ones on the int8 codes dequantized inside the graph
    (int8), and stays within 0.05 of the f32 rollout."""
    cfg = MPGCNConfig(synthetic_T=200, synthetic_N=10, hidden_dim=16,
                      pred_len=3, seed=0)
    data = synthetic_dataset(cfg)
    f32 = ServeEngine(cfg, data, ServeConfig(buckets=(1, 4),
                                             output_dir=str(tmp_path)),
                      device=cuda_device, allow_fresh=True)
    md = f32.pipeline.modes["test"]
    x = torch.from_numpy(np.array(md.x[:4]))
    k = torch.from_numpy(md.keys[:4].astype(np.int64))
    ref32 = f32._rollouts.run(x, k, 3)
    f32.close()
    for ip, kernel in (("bf16", KERNELS["bdgcn_pair_fwd_bf16"]),
                       ("int8", KERNELS["bdgcn_pair_fwd"])):
        eng = ServeEngine(cfg.replace(infer_precision=ip), data,
                          ServeConfig(buckets=(1, 4),
                                      output_dir=str(tmp_path / ip)),
                          device=cuda_device, allow_fresh=True)
        try:
            # one graph per (parameter slot, bucket, horizon, precision)
            assert set(eng._rollouts.graphs.graphs) == {
                (s, b, 3, ip) for s in (0, 1) for b in (1, 4)}
            prec = eng._precision
            before = kernel.launches
            got = eng._rollouts.run(x, k, 3, prec)
            assert kernel.launches == before + 3 * 2 * cfg.gcn_num_layers
            want = rollout(eng.model, eng.banks, x.to(cuda_device),
                           k.to(cuda_device), 3, prec.dtype,
                           prec.params).cpu()
            assert torch.equal(got, want), ip
            assert float((got - ref32).abs().max()) < 0.05, ip
        finally:
            eng.close()


def _device_kernels(fn):
    """{name: count} of the hand-written kernels the device ran in one
    call of fn (torch.profiler; the call sits inside idle time, as the
    smoke's device_activities has it)."""
    import time

    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        time.sleep(0.05)
        fn()
        torch.cuda.synchronize()
        time.sleep(0.05)
        prof.step()
    names = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = e.name.replace("void ", "").replace(
                "(anonymous namespace)::", "").split("<")[0].split("(")[0]
            if name.startswith(_OWN_KERNELS):
                names[name] = names.get(name, 0) + 1
    return names


def test_replay_counts_the_captured_launches(cuda_device, tmp_path):
    """One replay of the train graph adds its capture's tally to the
    launch counts; the tally is what an eager step counts, and the
    replay runs on the device the hand-written kernels an eager step
    runs, as many times."""
    a, b = _graph_pair(cuda_device, tmp_path, hidden_dim=32)
    _steps(a, b, "train", 3)
    g = a._graphs.get("train")
    ep = a._epochs["train"]
    kernels = {**KERNELS, "lstm_train_fwd": cuda_lstm.LSTM_TRAIN_FWD,
               "lstm_train_bwd": cuda_lstm.LSTM_TRAIN_BWD,
               "bdgcn_pair_bwd": cuda_bdgcn.BDGCN_PAIR_BWD}
    tally = {k.symbol: n for k, n in g.tally.items()}
    assert tally == {"lstm_train_fwd_f32": 2, "lstm_train_bwd_f32": 2,
                     "bdgcn_pair_fwd_f32": 6, "bdgcn_pair_bwd_f32": 6}
    for k in kernels.values():
        k.launches = 0
    ep.t.zero_()
    g.replay()
    torch.cuda.synchronize()
    assert {k.symbol: k.launches for k in kernels.values()
            if k.launches} == tally
    ep.t.zero_()
    replayed = _device_kernels(g.replay)
    eager = _device_kernels(lambda: a._train_body(ep))
    assert replayed == eager and replayed, (replayed, eager)


def test_no_host_sync_inside_an_epoch(cuda_device, tmp_path):
    """Once the steps are captured, a whole train and validation epoch
    runs under torch.cuda.set_sync_debug_mode('error') up to its read."""
    a, _ = _graph_pair(cuda_device, tmp_path, hidden_dim=32)
    rng = np.random.default_rng(0)
    for mode in ("train", "validate"):
        a._run_epoch(mode, "scan", rng)
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = [a._dispatch_epoch(m, m == "train", rng, m == "train")
               for m in ("train", "validate")]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for losses, sizes in out:
        assert np.isfinite(losses.cpu().numpy()).all()


def test_rollout_graph_per_bucket_equals_eager(cuda_device, tmp_path):
    cfg = MPGCNConfig(synthetic_T=200, synthetic_N=10, hidden_dim=16,
                      lstm_num_layers=2, pred_len=3, seed=0)
    data = synthetic_dataset(cfg)
    eng = ServeEngine(cfg, data, ServeConfig(buckets=(1, 2, 4),
                                             horizons=(1, 3),
                                             output_dir=str(tmp_path)),
                      device=cuda_device, allow_fresh=True)
    try:
        graphs = eng._rollouts.graphs
        assert set(graphs.graphs) == {(s, b, h, "f32") for s in (0, 1)
                                      for b in (1, 2, 4) for h in (1, 3)}
        md = eng.pipeline.modes["test"]
        for b in (1, 2, 4):
            x = torch.from_numpy(np.array(md.x[:b]))
            k = torch.from_numpy(md.keys[:b].astype(np.int64))
            for h in (1, 3):
                ref = rollout(eng.model, eng.banks, x.to(cuda_device),
                              k.to(cuda_device), h).cpu()
                assert torch.equal(eng._rollouts.run(x, k, h), ref), (b, h)
    finally:
        eng.close()


def test_replay_after_load_trained_equals_eager(cuda_device, tmp_path):
    """load_trained copies a checkpoint into the weights in place, so the
    captured rollout and train step read the new weights: after it both
    replays equal eager runs from the same state."""
    from mpgcn_tpu_torch.train.checkpoint import save_checkpoint

    a, b = _graph_pair(cuda_device, tmp_path, hidden_dim=32)
    _steps(a, b, "train", 3)
    md = a.pipeline.modes["test"]
    x, k = np.array(md.x[:4]), md.keys[:4]
    a.predict(x, k, 3)  # the eager warm-up, then the capture
    before = a.predict(x, k, 3)
    path = str(tmp_path / "other.pkl")
    save_checkpoint(path, MPGCN.from_config(a.cfg.replace(seed=1),
                                            device=cuda_device), 0)
    ptrs = a._state_ptrs()
    a.load_trained(path)
    b.load_trained(path)
    assert a._state_ptrs() == ptrs and a._graphs.get((4, 3, "f32")) is not None
    ref = rollout(a.model, a.banks, torch.from_numpy(x).to(cuda_device),
                  torch.from_numpy(k.astype(np.int64)).to(cuda_device),
                  3).cpu()
    after = a.predict(x, k, 3)
    assert torch.equal(torch.from_numpy(after), ref)
    assert not np.array_equal(after, before)
    got, want = _steps(a, b, "train", 2)
    assert np.array_equal(got, want)
    _assert_same_state(a, b)


def test_capture_survives_a_thread_pinning_host_memory(cuda_device):
    """A graph captured while another thread pins fresh host memory (the
    stream executor's staging thread does, a chunk at a time) records
    and replays: the capture checks only its own thread's calls. The
    pinning is held inside the captured function, so it lands in the
    capture window on every run."""
    import threading

    from mpgcn_tpu_torch.train.graphs import GraphSet

    gs = GraphSet(cuda_device, "kernel")
    x = torch.arange(1024, dtype=torch.float32, device=cuda_device)
    go, done, held = threading.Event(), threading.Event(), []

    def pin():
        go.wait(30)
        # 37 MiB: a size class no earlier block of the process fills,
        # so the host allocator calls cudaHostAlloc
        try:
            held.append(torch.empty(37 << 20, dtype=torch.uint8,
                                    pin_memory=True))
        finally:
            done.set()

    def body():
        out = x * 2 + 1
        go.set()
        assert done.wait(30)
        return out

    t = threading.Thread(target=pin)
    t.start()
    gs.warmup(lambda: x * 2 + 1)
    cap = gs.capture("pinned", body)
    t.join(30)
    assert held and held[0].is_pinned()
    x.add_(1)
    out = cap.replay()
    torch.cuda.synchronize(cuda_device)
    torch.testing.assert_close(out, x * 2 + 1, rtol=0, atol=0)


def test_graphs_captured_again_after_the_storage_moves(cuda_device,
                                                      tmp_path):
    """A rate table grown past the run moves what the train graph reads:
    the trainer drops its graphs, takes a new pool, captures the step
    again, and it still equals eager."""
    a, b = _graph_pair(cuda_device, tmp_path, hidden_dim=32)
    _steps(a, b, "train", 3)
    a.optimizer.reserve(a.optimizer.lr_table.shape[0] + 1)
    a._check_storage()
    assert not a._graphs.graphs
    got, want = _steps(a, b, "train", 2)
    assert np.array_equal(got, want) and a._graphs.get("train") is not None
    _assert_same_state(a, b)


# --- the self-healing step: sentinels, accumulation, multi-step ------------


def _poison(tr, step: int) -> None:
    """NaN input windows for the rows of unshuffled train step ``step``."""
    md = tr.pipeline.modes["train"]
    bs = tr.cfg.batch_size
    x = np.array(md.x)
    x[step * bs: (step + 1) * bs] = np.nan
    md.x = x


def _guarded(tr) -> list:
    """Copies of what an update writes: weights, Adam's state, the rate
    and the step counter."""
    return [t.detach().clone() for t in tr.optimizer.guarded()]


def test_sentinel_revert_is_bit_exact_inside_a_graph(cuda_device, tmp_path):
    """A replayed train step whose batch holds NaN windows leaves the
    weights, Adam's moments and steps, the rate and step_t as they were,
    bit for bit, and writes NaN as its loss; the clean replays around it
    train; the whole run equals the per-step executor's bit for bit."""
    a, b = _graph_pair(cuda_device, tmp_path, hidden_dim=32)
    for tr in (a, b):
        _poison(tr, 3)
    ep = a._epoch_state("train")
    idx, sizes = a._epoch_index("train", False, None)
    a.optimizer.reserve(len(sizes))
    ep.load(idx, sizes)
    for _ in range(3):  # two eager warm-ups, then the capture and a replay
        a._exec_step("train", ep, True)
    assert a._graphs.get("train") is not None
    before = _guarded(a)
    a._exec_step("train", ep, True)  # the replay of step 3: poisoned
    after = _guarded(a)
    assert all(torch.equal(x, y) for x, y in zip(before, after))
    assert int(a.optimizer.step_t) == 3
    a._exec_step("train", ep, True)
    assert int(a.optimizer.step_t) == 4
    n = len(list(a.model.parameters()))
    assert not all(torch.equal(x, y) for x, y in zip(_guarded(a)[:n],
                                                     after[:n]))
    a.optimizer.advance(5)
    losses = ep.losses[:5].cpu().numpy()
    assert np.isnan(losses[3]) and np.isfinite(losses[[0, 1, 2, 4]]).all()
    ref = [b.train_step(x) for x in list(b.pipeline.batches(
        "train", pad_to_full=True))[:5]]
    np.testing.assert_array_equal(losses, np.array(ref, np.float32))
    _assert_same_state(a, b)
    assert torch.equal(a.optimizer.step_t, b.optimizer.step_t)


def test_grad_accum_matches_the_full_batch_on_the_card(cuda_device,
                                                       tmp_path):
    """grad_accum=2: one step's loss and gradients match the full batch's
    (rtol 1e-5, atol 1e-6 x each tensor's largest entry); its steps by
    graph equal the per-step executor's bit for bit, with twice the
    kernel launches of a full-batch step."""
    a, b = _graph_pair(cuda_device, tmp_path, hidden_dim=32, grad_accum=2)
    full = ModelTrainer(a.cfg.replace(grad_accum=1), synthetic_dataset(
        a.cfg), device=cuda_device)
    full.model.load_state_dict(a.model.state_dict())
    batch = next(a.pipeline.batches("train", pad_to_full=True))
    grads = {}
    for name, tr in (("k2", a), ("full", full)):
        x, y, keys = tr._tensors(batch)
        loss = tr._loss_and_grads(x, y, keys, tr._size(batch))
        grads[name] = (float(loss), {n: p.grad.clone() for n, p in
                                     tr.model.named_parameters()})
        tr.optimizer.zero_grad(set_to_none=True)
    assert grads["k2"][0] == pytest.approx(grads["full"][0], rel=1e-5)
    for n, g in grads["full"][1].items():
        torch.testing.assert_close(grads["k2"][1][n], g, rtol=1e-5,
                                   atol=1e-6 * float(g.abs().max()))
    for k in (cuda_lstm.LSTM_TRAIN_FWD, cuda_bdgcn.BDGCN_PAIR_BWD):
        k.launches = 0
    got, ref = _steps(a, b, "train", 5)
    assert np.array_equal(got, ref)
    _assert_same_state(a, b)
    assert cuda_lstm.LSTM_TRAIN_FWD.launches == 2 * 2 * 2 * 5
    assert cuda_bdgcn.BDGCN_PAIR_BWD.launches == 2 * 2 * 6 * 5


def test_multistep_step_by_graph_equals_eager(cuda_device, tmp_path):
    """A 3-frame target trains through the rollout: five train steps and
    four eval steps by graph equal the per-step executor's bit for bit,
    each train step launching 3 x a one-step step's training kernels."""
    cfg = MPGCNConfig(synthetic_T=120, synthetic_N=10, pred_len=3, seed=0,
                      hidden_dim=32, output_dir=str(tmp_path))
    data = synthetic_dataset(cfg)
    a = ModelTrainer(cfg, data, device=cuda_device)
    b = ModelTrainer(cfg.replace(epoch_scan=False), data, device=cuda_device)
    cuda_lstm.LSTM_TRAIN_BWD.launches = 0
    for mode, n in (("train", 5), ("validate", 4)):
        got, ref = _steps(a, b, mode, n)
        assert np.array_equal(got, ref), (mode, got, ref)
        assert a._graphs.get(mode) is not None
    _assert_same_state(a, b)
    assert cuda_lstm.LSTM_TRAIN_BWD.launches == 2 * (3 * 2 * 5)


# --- the bf16 forms (-dtype bfloat16) -------------------------------------

#: bf16 storage against the plain twin on the same bf16 operands: both sum
#: in f32, in other orders, so a sum within f32 rounding of a bf16 rounding
#: boundary rounds to the neighbouring bf16 value (2^-8 relative), and the
#: LSTM carries such a flip into later steps through h: 4 bf16 ulps at 1.0
#: absolute, 2 relative. dW (f32 partials of bf16 products) is held like
#: the f32 dW where its operands are the same bf16 tensors (the BPTT),
#: and at 2^-10 x its largest entry where they pass through a bf16
#: rounding of the kernel's own (K-BDGCN's Z)
BF16_TOL = dict(rtol=2 ** -7, atol=2 ** -6)


def _bf16_close(out, ref, scale=1.0):
    """``BF16_TOL``, atol x ``scale`` (the largest entry where outputs are
    not O(1))."""
    assert out.dtype == ref.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), ref.float(),
                               rtol=BF16_TOL["rtol"],
                               atol=BF16_TOL["atol"] * scale)


def _bf(dev, a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dev).to(
        torch.bfloat16)


#: (T, R, H) of the bf16 LSTM entries: the reference serve and train
#: shapes, the widths past the resident kernels (H = 65..1,030), the
#: resident forward's and BPTT's edges (H = 3, 81, 116, 117, 118, one step)
#: and the engine BPTT's (H = 97, 17 rows)
BF16_LSTM = ([(7, 17672, 32), (7, 8836, 32), (7, 1000, 8), (7, 333, 64),
              (7, 5, 40)] + [(_T_OF.get(H, 7), R, H) for R, H in WIDE_LSTM]
             + [(7, 1001, 81), (7, 999, 3), (1, 1000, 32), (7, 1001, 116),
                (7, 1003, 117), (7, 997, 118), (7, 17, 128), (3, 333, 97),
                (1, 1000, 128)])


@pytest.mark.parametrize("T,R,H", BF16_LSTM,
                         ids=["-".join(map(str, c)) for c in BF16_LSTM])
def test_bf16_lstm_entries_match_plain(cuda_device, T, R, H):
    """Every bf16 LSTM entry against its plain twin on the same bf16
    operands: lstm_infer_last / collect on x_proj and fused from x (F = 1
    and 3), the training forward, and the BPTT with dhs and dcs (dW before
    its cast); one launch a call."""
    dev = cuda_device
    rng = np.random.default_rng(R + H + 16)
    xp = _bf(dev, rng.normal(size=(T, R, 4 * H)))
    w = _bf(dev, rng.normal(size=(H, 4 * H)) / np.sqrt(H))
    K = cuda_lstm.KERNELS[torch.bfloat16]
    for collect in (False, True):
        kernel = K["collect" if collect else "last"]
        before = kernel.launches
        out = cuda_lstm.lstm_layer_infer(xp, w, collect)
        torch.cuda.synchronize()
        assert kernel.launches == before + 1 and out.dtype == torch.bfloat16
        _bf16_close(out, cuda_lstm.lstm_layer_infer_plain(xp, w, collect))
        for F in (1, 3):
            s = 1 / np.sqrt(H)
            args = (_bf(dev, rng.normal(size=(R, T, F))),
                    _bf(dev, rng.uniform(-s, s, (4 * H, F))),
                    _bf(dev, rng.uniform(-s, s, 4 * H)), w)
            out = cuda_lstm.lstm_layer_infer_fused(*args, collect)
            _bf16_close(out, cuda_lstm.lstm_layer_infer_fused_plain(
                *args, collect))
    before = K["fwd"].launches
    hs, cs = cuda_lstm.lstm_layer_train(xp, w)
    torch.cuda.synchronize()
    assert K["fwd"].launches == before + 1
    rh, rc = cuda_lstm.lstm_layer_train_plain(xp, w)
    _bf16_close(hs, rh)
    _bf16_close(cs, rc, float(rc.float().abs().max()))
    dhs = _bf(dev, rng.normal(size=(T, R, H)))
    dcs = _bf(dev, rng.normal(size=(T, R, H)))
    before = K["bwd"].launches
    dxp, dw, _ = cuda_lstm.lstm_layer_bwd_partials(xp, w, hs, cs, dhs, dcs)
    torch.cuda.synchronize()
    assert K["bwd"].launches == before + 1
    assert dxp.dtype == torch.bfloat16 and dw.dtype == torch.float32
    rx, rw = cuda_lstm.lstm_layer_bwd_plain(xp, w, hs, cs, dhs, dcs)
    _bf16_close(dxp, rx, float(rx.float().abs().max()))
    _close_scaled(dw, rw)
    assert cuda_lstm.lstm_layer_bwd(xp, w, hs, cs, dhs, dcs)[1].dtype == \
        torch.bfloat16


@pytest.mark.parametrize("dynamic", [False, True])
@pytest.mark.parametrize("K,B,N,C,H,scale", _bdgcn_cases())
def test_bf16_bdgcn_entries_match_plain(cuda_device, dynamic, K, B, N, C, H,
                                        scale):
    """The bf16 K-BDGCN forward and backward against their plain twins on
    the same bf16 operands, at every shape of the f32 test (K, C, H up to
    7, 128, 128); dW in f32 before its cast."""
    args = _bdgcn_inputs(cuda_device, K, B, N, C, H, dynamic, seed=N + 1)
    args[0], args[2] = args[0] * scale, args[2] / scale
    args = [a.to(torch.bfloat16) for a in args]
    before = cuda_bdgcn.BDGCN_PAIR_FWD_BF16.launches
    out = cuda_bdgcn.folded_pair_project(*args)
    torch.cuda.synchronize()
    assert cuda_bdgcn.BDGCN_PAIR_FWD_BF16.launches == before + 1
    ref = cuda_bdgcn.folded_pair_project_plain(*args)
    _bf16_close(out, ref, float(ref.float().abs().max()))
    dout = _bf(cuda_device, np.random.default_rng(C).normal(
        size=(B, N, N, H)))
    before = cuda_bdgcn.BDGCN_PAIR_BWD_BF16.launches
    dh1, dW, _ = cuda_bdgcn.folded_pair_project_bwd_partials(*args, dout)
    torch.cuda.synchronize()
    assert cuda_bdgcn.BDGCN_PAIR_BWD_BF16.launches == before + 1
    r1, rW = cuda_bdgcn.folded_pair_project_bwd_plain(*args, dout)
    _bf16_close(dh1, r1, float(r1.float().abs().max()))
    torch.testing.assert_close(dW, rW, rtol=2 ** -7,
                               atol=2 ** -10 * float(rW.abs().max()))


# --- the city-scale feed ------------------------------------------------------


def _banded_stack(lead, n, band, gen):
    """A (lead..., n, n) circulant band of random weights (the N=500
    configuration's support shape)."""
    i = torch.arange(n)
    d = (i[:, None] - i[None, :]).abs()
    d = torch.minimum(d, n - d)
    mask = (d <= band).float()
    return torch.randn(lead + (n, n), generator=gen) * mask


@pytest.mark.parametrize("payload", ["f32", "int8"])
@pytest.mark.parametrize("dynamic", [False, True])
def test_fused_ell_widths_equal_per_origin_columns(cuda_device, payload,
                                                   dynamic):
    """The fused epilogue's destination SpMM: one launch over the K stacked
    origins, at the N=500 widths (static: X (500, 3 * 32,000) shared by
    the stack; dynamic: one X (500, 3 * 16,000) per sample), equals the K
    per-origin SpMMs column for column, bit for bit, forward and dX."""
    gen = torch.Generator().manual_seed(5)
    K, B, N, C = 3, 2, 500, 32
    lead = (B, K) if dynamic else (K,)
    A = _banded_stack(lead, N, 12, gen)
    G = pack_payload(formats.sparsify_support_stack(A, "ell"),
                     payload).to(cuda_device)
    f_o = N * C if dynamic else B * N * C
    X = torch.randn(lead[:1] + (N, K * f_o) if dynamic else (N, K * f_o),
                    generator=gen).to(cuda_device).requires_grad_()
    out = ell_spmm(G, X)
    dout = torch.randn(out.shape, generator=gen).to(cuda_device)
    out.backward(dout)
    for o in range(K):
        cols = slice(o * f_o, (o + 1) * f_o)
        xo = X.detach()[..., cols].contiguous().requires_grad_()
        oo = ell_spmm(G, xo)
        oo.backward(dout[..., cols].contiguous())
        assert torch.equal(out.detach()[..., cols], oo.detach()), o
        assert torch.equal(X.grad[..., cols], xo.grad), o


def test_stream_executor_equals_scan_on_the_card(cuda_device, tmp_path):
    """Two epochs on the stream executor (chunks of 3 steps, every step
    replayed from its graph after the warm-ups) equal the scan executor's
    bit for bit; at most two chunks resident; one pacing wait a chunk
    after the first."""
    cfg = MPGCNConfig(synthetic_T=120, synthetic_N=10, pred_len=1, seed=0,
                      num_epochs=2, hidden_dim=32)
    data = synthetic_dataset(cfg)
    runs = {}
    for name, kw in (("scan", {}), ("stream", dict(
            epoch_scan_max_mb=0.0, stream_chunk_mb=0.03,
            od_storage="sparse"))):
        tr = ModelTrainer(cfg.replace(output_dir=str(tmp_path / name), **kw),
                          data, device=cuda_device)
        waits = []
        wait = tr._host_wait
        tr._host_wait = lambda ev: (waits.append(1), wait(ev))
        runs[name] = (tr, tr.train(), waits)
    (ts, hs, _), (tm, hm, waits) = runs["scan"], runs["stream"]
    assert tm._epoch_exec("train") == "stream"
    assert tm._graphs.get("train-stream") is not None
    chunks = {m: tm._stream_plan(m)[0] for m in ("train", "validate")}
    assert chunks["train"] >= 3
    assert hm == hs
    _assert_same_state(tm, ts)
    assert len(waits) == 2 * (chunks["train"] - 1 + chunks["validate"] - 1)
    assert all(s["max_resident_chunks"] <= 2
               for s in tm._stream_stats.values())


# --- the serving plane's two parameter slots ---------------------------------


def _slot_stack(tmp_path, device):
    """A small config, its data, and two checkpoints in the JAX format
    (seeded weights and a nudged copy), the first promoted into the
    service dir's slot with its ledger row."""
    from mpgcn_tpu_torch.service.promote import (
        candidate_hash,
        ledger_path,
        promote_checkpoint,
        promoted_path,
    )
    from mpgcn_tpu_torch.train.checkpoint import save_checkpoint
    from mpgcn_tpu_torch.utils.logging import JsonlLogger

    cfg = MPGCNConfig(synthetic_T=200, synthetic_N=10, hidden_dim=16,
                      pred_len=3, seed=0)
    data = synthetic_dataset(cfg)
    model = MPGCN.from_config(cfg.replace(num_nodes=10), device="cpu")
    extra = {"num_branches": 2, "branch_sources": ["static", "dynamic"]}
    a, b = str(tmp_path / "a.pkl"), str(tmp_path / "b.pkl")
    save_checkpoint(a, model, 0, extra=extra)
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(1.01)
    save_checkpoint(b, model, 1, extra=extra)
    svc = str(tmp_path / "svc")

    def promote(path, attempt):
        slot = promoted_path(svc)
        promote_checkpoint(path, slot)
        ledger = ledger_path(svc)
        os.makedirs(os.path.dirname(ledger), exist_ok=True)
        JsonlLogger(ledger).log("gate", attempt=attempt, promoted=True,
                                candidate_hash=candidate_hash(slot))

    promote(a, 1)
    return cfg, data, svc, a, b, promote


def _serve_one_by_one(eng, md, n):
    out = []
    for i in range(n):
        t = eng.submit(md.x[i, ..., 0], int(md.keys[i]), deadline_ms=0)
        assert t.wait(60) and t.ok, t.error
        out.append((t.pred, t.canary))
    return out


def test_two_slot_engine_keeps_its_graphs_across_reload_and_promotion(
        cuda_device, tmp_path):
    """Both slots' rollouts are captured at startup; traffic, a canary, a
    promotion, a poisoned reload and a canary rollback add no graph; the
    promoted weights answer bit for bit as an engine started on them."""
    from mpgcn_tpu_torch.resilience.faults import FaultPlan
    from mpgcn_tpu_torch.service.reload import CanaryReloader

    cfg, data, svc, a, b, promote = _slot_stack(tmp_path, cuda_device)
    scfg = ServeConfig(output_dir=svc, buckets=(1, 2), canary_requests=2,
                       canary_fraction=1.0, reload_poll_secs=0)
    eng = ServeEngine(cfg, data, scfg, device=cuda_device,
                      faults=FaultPlan.parse("poison_reload=2"))
    ref = ServeEngine(cfg, data, scfg.replace(output_dir=str(tmp_path /
                                                             "ref")),
                      device=cuda_device, init_ckpt=b)
    try:
        md = eng.pipeline.modes["test"]
        n0 = eng.stats()["traces"]
        assert n0 == 2 * 2 * 1 == len(eng._graphs.graphs)
        before = _serve_one_by_one(eng, md, 3)
        rel = CanaryReloader(eng, scfg, faults=eng._faults)
        promote(b, 2)
        assert rel.poll() == "canary-started"
        canary = _serve_one_by_one(eng, md, 2)
        assert [c for _, c in canary] == [True, True]
        assert eng.stats()["reloads"]["promoted"] == 1
        assert eng.stats()["traces"] == n0
        after = _serve_one_by_one(eng, md, 3)
        want = _serve_one_by_one(ref, md, 3)
        for (got, _), (exp, _) in zip(after, want):
            assert np.array_equal(got, exp)
        assert not np.array_equal(after[0][0], before[0][0])
        # a poisoned candidate: rejected by the smoke eval, incumbent
        # bit-identical
        promote(a, 3)
        assert rel.poll() == "rejected-smoke"
        again = _serve_one_by_one(eng, md, 3)
        for (got, _), (exp, _) in zip(again, after):
            assert np.array_equal(got, exp)
        # a canary that goes non-finite on live traffic: rolled back,
        # the batch served again on the incumbent
        eng.install_canary(eng._place(_host_tree(b)), "nan", 9)
        with torch.no_grad():
            for p in eng._models[eng._canary.slot].parameters():
                p.fill_(float("nan"))
        (got, was_canary), = _serve_one_by_one(eng, md, 1)
        assert was_canary is False and np.array_equal(got, after[0][0])
        assert eng.stats()["reloads"]["rolled_back"] == 2
        assert eng.stats()["traces"] == n0 == len(eng._graphs.graphs)
    finally:
        eng.close()
        ref.close()


def _host_tree(path):
    from mpgcn_tpu_torch.utils.convert import read_checkpoint

    return read_checkpoint(path)["params"]


def test_staged_feed_answers_as_the_one_thread_feed(cuda_device, tmp_path):
    """The double-buffered feed (pinned host buffers, side-stream upload
    into staging buffers, an event the batch waits on) answers bit for bit
    as double_buffer=False, over every bucket. Each group is submitted
    under the batcher's lock, so no worker wakes between two submits and
    takes part of a group: both feeds see the same groups."""
    cfg, data, svc, a, _, _ = _slot_stack(tmp_path, cuda_device)
    preds = {}
    for db in (True, False):
        scfg = ServeConfig(output_dir=str(tmp_path / f"db{db}"),
                           buckets=(1, 2, 4), max_wait_ms=100.0,
                           double_buffer=db, deadline_ms=0)
        eng = ServeEngine(cfg, data, scfg, device=cuda_device, init_ckpt=a)
        try:
            stager = eng.batchers[3].stage_fn
            assert (stager is not None) == db
            md = eng.pipeline.modes["test"]
            out = []
            batcher = eng.batchers[3]
            for group in (4, 3, 2, 1, 4):
                with batcher._lock:
                    ts = [eng.submit(md.x[i, ..., 0], int(md.keys[i]))
                          for i in range(group)]
                for t in ts:
                    assert t.wait(60) and t.ok, t.error
                out += [(t.bucket, t.pred) for t in ts]
            preds[db] = out
            assert eng.stats()["traces"] == 2 * 3
        finally:
            eng.close()
    assert [b for b, _ in preds[True]] == [b for b, _ in preds[False]]
    for (_, x), (_, y) in zip(preds[True], preds[False]):
        assert np.array_equal(x, y)


def test_fleet_shares_its_graphs_and_answers_as_one_engine_each(
        cuda_device, tmp_path):
    """A 2-tenant fleet (service/fleet.py) captures one execution model's
    rollouts, |buckets| x |horizons| graphs, as one tenant would; each
    tenant's answers equal a ServeEngine started on its checkpoint bit for
    bit; a reload (canary, promotion) and a rolled-back canary add no
    graph, and the promoted tenant then answers as the candidate's
    engine."""
    from mpgcn_tpu_torch.config import FleetConfig
    from mpgcn_tpu_torch.service.fleet import FleetEngine, FleetReloader
    from mpgcn_tpu_torch.service.promote import (
        candidate_hash,
        ledger_path,
        promote_checkpoint,
        promoted_path,
    )
    from mpgcn_tpu_torch.service.registry import TenantRegistry
    from mpgcn_tpu_torch.utils.logging import JsonlLogger

    cfg, data, _, a, b, _ = _slot_stack(tmp_path, cuda_device)
    root = str(tmp_path / "fleet")
    reg = TenantRegistry.load(root)

    def promote(tid, path, attempt):
        slot = promoted_path(reg.tenant_root(tid))
        promote_checkpoint(path, slot)
        JsonlLogger(ledger_path(reg.tenant_root(tid))).log(
            "gate", attempt=attempt, promoted=True,
            candidate_hash=candidate_hash(slot))

    for tid, path in (("nyc", a), ("sf", b)):
        reg.add(tid)
        promote(tid, path, 1)
    fcfg = FleetConfig(output_dir=root, buckets=(1, 2), canary_requests=2,
                       canary_fraction=1.0, reload_poll_secs=0)
    eng = FleetEngine(cfg, data, fcfg, reg, device=cuda_device)
    refs = {name: ServeEngine(cfg, data, ServeConfig(
        output_dir=str(tmp_path / name), buckets=(1, 2)),
        device=cuda_device, init_ckpt=path)
        for name, path in (("a", a), ("b", b))}
    try:
        md = eng.pipeline.modes["test"]
        assert eng.trace_count == 2 == len(eng._graphs.graphs)

        def answers(tenant, n=3):
            out = []
            for i in range(n):
                t = eng.submit(tenant, md.x[i, ..., 0], int(md.keys[i]),
                               deadline_ms=0)
                assert t.wait(60) and t.ok, t.error
                out.append(t.pred)
            return out

        for tid, ref in (("nyc", refs["a"]), ("sf", refs["b"])):
            for got, want in zip(answers(tid),
                                 _serve_one_by_one(ref, md, 3)):
                assert np.array_equal(got, want[0]), tid
        rel = FleetReloader(eng)
        promote("nyc", b, 2)
        assert rel.poll_all()["nyc"] == "canary-started"
        answers("nyc", 2)
        assert eng._views["nyc"].incumbent_hash == candidate_hash(b)
        for got, want in zip(answers("nyc"),
                             _serve_one_by_one(refs["b"], md, 3)):
            assert np.array_equal(got, want[0])
        promote("sf", a, 2)
        assert rel.poll_all()["sf"] == "canary-started"
        ts = eng.tenants["sf"]
        ts.canary.params = {k: v * float("nan")
                            for k, v in ts.canary.params.items()}
        for got, want in zip(answers("sf", 1),
                             _serve_one_by_one(refs["b"], md, 1)):
            assert np.array_equal(got, want[0])  # served again on b
        assert ts.canary is None
        assert eng.trace_count == 2 == eng.stats()["traces"]
    finally:
        eng.close()
        for r in refs.values():
            r.close()


def test_router_kill_keeps_answers_bit_equal_across_replicas(cuda_device,
                                                              tmp_path):
    """The front tier (service/router.py) over 2 ``serve --fleet``
    replicas on the card, 2 tenants: kill -9 of r1 at the 6th request; no
    accepted request fails, every (tenant, window) has one answer whether
    r0, r1 or r1's restart served it, equal bit for bit to a ServeEngine
    on the tenant's checkpoint in this process; the restart captures as
    many graphs as the first incarnation and builds no kernel library."""
    import json
    import threading
    import time
    import urllib.request
    from http.server import ThreadingHTTPServer

    from mpgcn_tpu_torch.config import RouterConfig
    from mpgcn_tpu_torch.resilience.faults import FaultPlan
    from mpgcn_tpu_torch.service.promote import (
        candidate_hash,
        ledger_path,
        promote_checkpoint,
        promoted_path,
    )
    from mpgcn_tpu_torch.service.registry import TenantRegistry
    from mpgcn_tpu_torch.service.router import ADMITTED, Router, _make_handler
    from mpgcn_tpu_torch.utils.logging import JsonlLogger

    cfg, data, _, a, b, _ = _slot_stack(tmp_path, cuda_device)
    root = str(tmp_path / "fleet")
    reg = TenantRegistry.load(root)
    ckpts = {"nyc": a, "sf": b}
    for tid, path in ckpts.items():
        slot = promoted_path(reg.add(tid)["root"])
        promote_checkpoint(path, slot)
        JsonlLogger(ledger_path(reg.tenant_root(tid))).log(
            "gate", attempt=1, promoted=True,
            candidate_hash=candidate_hash(slot))
    serve_args = ["--device", "cuda", "-pred", str(cfg.pred_len), "-hidden",
                  str(cfg.hidden_dim), "-sN", str(cfg.synthetic_N), "-sT",
                  str(cfg.synthetic_T), "-seed", "0", "--buckets", "1,2",
                  "--deadline-ms", "0", "--reload-poll-secs", "0"]
    rcfg = RouterConfig(output_dir=root, replicas=2, probe_interval_s=0.2,
                        probe_timeout_s=5.0, breaker_threshold=2,
                        breaker_cooldown_s=0.5, deadline_ms=0.0,
                        connect_timeout_s=30.0, ready_timeout_s=300.0,
                        smoke_obs=cfg.obs_len, smoke_nodes=cfg.synthetic_N)
    root_dir = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root_dir)
    env.pop("MPGCN_FAULTS", None)
    rt = Router(rcfg, serve_args,
                faults=FaultPlan.parse("kill_replica=6,fault_replica=1"),
                env=env)
    refs = {tid: ServeEngine(cfg, data, ServeConfig(
        output_dir=str(tmp_path / f"ref_{tid}"), buckets=(1, 2),
        reload_poll_secs=0), device=cuda_device, init_ckpt=path)
        for tid, path in ckpts.items()}

    class _Srv(ThreadingHTTPServer):
        daemon_threads = True

    def stats(h):
        with urllib.request.urlopen(h.proc.base_url + "/v1/stats",
                                    timeout=30) as r:
            st = json.load(r)
        with urllib.request.urlopen(h.proc.base_url + "/metrics",
                                    timeout=30) as r:
            text = r.read().decode()
        assert "# TYPE mpgcn_cuda_program_builds_total counter" in text
        builds = {kind: sum(float(line.split()[-1])
                            for line in text.splitlines()
                            if line.startswith(
                                "mpgcn_cuda_program_builds_total{kind=\""
                                + kind + "\"}"))
                  for kind in ("cuda_graph", "kernel_library")}
        return st["traces"], builds

    httpd = None
    try:
        md = refs["nyc"].pipeline.modes["test"]
        want = {tid: _serve_one_by_one(ref, md, 3)
                for tid, ref in refs.items()}
        rt.start()
        assert rt.wait_ready(300.0), "replicas never admitted"
        first = stats(rt.handles[0])
        assert first[0] == 2 and first[1]["kernel_library"] == 0, first
        assert first[1]["cuda_graph"] > 0, first
        assert stats(rt.handles[1]) == first
        httpd = _Srv(("127.0.0.1", 0), _make_handler(rt))
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        port = httpd.server_address[1]
        got = {}

        def ask(n):
            for i in range(n):
                tid, w = ("nyc", "sf")[i % 2], (i // 2) % 3
                body = {"tenant": tid, "x": md.x[w, ..., 0].tolist(),
                        "key": int(md.keys[w])}
                req = urllib.request.Request(
                    f"http://127.0.0.1:{port}/v1/predict",
                    data=json.dumps(body).encode(),
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=120) as r:
                    assert r.status == 200
                    got.setdefault((tid, w), []).append(
                        np.asarray(json.load(r)["pred"], np.float32))

        ask(12)
        assert rt.handles[1].deaths <= 1 and len(rt.handles) == 2
        deadline = time.monotonic() + 300
        h1 = rt.handles[1]
        while not (h1.state == ADMITTED and h1.proc.generation == 2):
            assert time.monotonic() < deadline, "r1 never re-admitted"
            time.sleep(0.1)
        assert h1.deaths == 1
        assert stats(h1) == first
        ask(12)
        with open(os.path.join(root, "router", "router.jsonl")) as f:
            routes = [json.loads(line) for line in f]
        served = {r["replica"] for r in routes if r["event"] == "route"}
        assert served == {0, 1}
        for (tid, w), preds in got.items():
            for p in preds:
                assert np.array_equal(p, want[tid][w][0]), (tid, w)
    finally:
        if httpd is not None:
            httpd.shutdown()
        rt.close()
        for ref in refs.values():
            ref.close()
    assert not any(h.proc.alive for h in rt.handles.values())


def _snapshot_value(snap: dict, name: str, **labels) -> float:
    """A series of a metrics snapshot (``MetricsRegistry.snapshot``), 0
    where it was never written."""
    want = [f'{k}="{v}"' for k, v in labels.items()]
    for key, v in snap.items():
        if key.startswith("mpgcn_" + name) and all(w in key for w in want):
            return v
    return 0.0


def test_daemon_retrains_promotes_and_a_second_process_builds_nothing(
        cuda_device, tmp_path):
    """The continual-learning daemon (service/daemon.py) at the reference
    widths (N=47, hidden 32, batch 4, obs 7, M=2, K=3) on 30 spooled days:
    one retrain by graph, promoted; its launches are 2 of each LSTM
    training entry and 6 of each BDGCN entry a train step and 2
    lstm_infer_last and 6 bdgcn_pair_fwd an eval step or rollout forward
    (retrain_done's metrics); a ServeEngine on the promoted slot answers
    bit for bit as a trainer's rollout graph on the same weights; a
    second daemon process on 6 more days retrains with no kernel library
    built."""
    import json
    import subprocess
    import sys

    from mpgcn_tpu_torch.config import DaemonConfig
    from mpgcn_tpu_torch.data.loader import synthetic_od
    from mpgcn_tpu_torch.scenarios.dynamics import write_od_spool
    from mpgcn_tpu_torch.service.daemon import ContinualDaemon
    from mpgcn_tpu_torch.service.promote import promoted_path
    from mpgcn_tpu_torch.utils.logging import read_events

    spool, out = str(tmp_path / "spool"), str(tmp_path / "svc")
    od = synthetic_od(36, 47, seed=0)
    write_od_spool(od[:30], spool)
    flags = dict(window_days=30, holdout_days=2, val_days=2,
                 retrain_cadence=3, idle_exits=1, poll_secs=0.0)
    tcfg = MPGCNConfig(mode="train", data="synthetic",
                       output_dir=os.path.join(out, "retrain"),
                       num_epochs=2, learn_rate=1e-3, pred_len=1)
    d = ContinualDaemon(DaemonConfig(spool_dir=spool, output_dir=out,
                                     **flags), tcfg, device=cuda_device)
    assert d.run() == 0
    gates = read_events(os.path.join(out, "promoted", "promotions.jsonl"),
                        "gate")
    assert [(g["attempt"], g["promoted"]) for g in gates] == [(1, True)]
    done = read_events(os.path.join(out, "daemon_log.jsonl"),
                       "retrain_done")[-1]["metrics"]
    steps = {k: _snapshot_value(done, "daemon_retrain_steps", kind=k)
             for k in ("train", "eval", "rollout")}
    assert steps["train"] > 0 and steps["eval"] > 0 and steps["rollout"] > 0
    launches = {k: _snapshot_value(done, "daemon_retrain_launches",
                                   kernel=k)
                for k in ("lstm_train_fwd_f32", "lstm_train_bwd_f32",
                          "bdgcn_pair_bwd_f32", "bdgcn_pair_fwd_f32",
                          "lstm_infer_last_f32")}
    assert launches["lstm_train_fwd_f32"] == 2 * steps["train"]
    assert launches["lstm_train_bwd_f32"] == 2 * steps["train"]
    assert launches["bdgcn_pair_bwd_f32"] == 6 * steps["train"]
    infer = steps["eval"] + steps["rollout"]
    assert launches["lstm_infer_last_f32"] == 2 * infer
    assert launches["bdgcn_pair_fwd_f32"] == 6 * (steps["train"] + infer)

    cfg, data, pipeline = d._build_window(d._window_ids(),
                                          str(tmp_path / "check"))
    tr = d._trainer(cfg, data, pipeline)
    tr.load_trained(promoted_path(out))
    eng = ServeEngine(cfg, data, ServeConfig(
        output_dir=str(tmp_path / "serve"), buckets=(1,),
        reload_poll_secs=0), device=cuda_device,
        init_ckpt=promoted_path(out))
    try:
        md = eng.pipeline.modes["test"]
        for i in range(len(md)):
            t = eng.submit(md.x[i, ..., 0], int(md.keys[i]), deadline_ms=0)
            assert t.wait(60) and t.ok, t.error
            want = tr.predict(md.x[i:i + 1], md.keys[i:i + 1], 1)
            assert np.array_equal(np.asarray(t.pred), want[0]), i
    finally:
        eng.close()
        tr.close()

    write_od_spool(od[30:], spool, start_day=30)
    root_dir = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root_dir)
    env.pop("MPGCN_FAULTS", None)
    argv = [sys.executable, "-m", "mpgcn_tpu_torch.cli", "daemon",
            "-spool", spool, "-out", out, "-epoch", "2", "-lr", "1e-3"]
    for k, v in flags.items():
        argv += ["--" + k.replace("_", "-"), str(v)]
    proc = subprocess.run(argv, env=env, cwd=root_dir, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    done = read_events(os.path.join(out, "daemon_log.jsonl"),
                       "retrain_done")
    assert [e["attempt"] for e in done] == [1, 2]
    snap = done[-1]["metrics"]
    assert _snapshot_value(snap, "cuda_program_builds",
                           kind="kernel_library") == 0
    assert _snapshot_value(snap, "cuda_program_builds",
                           kind="cuda_graph") > 0
    assert json.load(open(os.path.join(out, "daemon_state.json")))[
        "retrains_done"] == 2


#: one process's kernel library: built into (or found in) the directory
#: given, one launch of its inference LSTM entry against the plain
#: version, and the cache's counts
_CACHE_PROC = """
import json, sys
import torch
from mpgcn_tpu_torch.native import build
from mpgcn_tpu_torch.nn import cuda_lstm
from mpgcn_tpu_torch.obs.perf import compile_cache
from mpgcn_tpu_torch.obs.metrics import program_builds
compile_cache.enable(sys.argv[1])
g = torch.Generator().manual_seed(0)
T, R, H = 5, 64, 32
xp = (torch.randn(T, R, 4 * H, generator=g) * 0.5).cuda()
whh_t = (torch.randn(H, 4 * H, generator=g) * 0.2).cuda()
got = cuda_lstm.lstm_layer_infer(xp, whh_t, False)
want = cuda_lstm.lstm_layer_infer(xp.cpu(), whh_t.cpu(), False)
print(json.dumps({**compile_cache.cache_stats(),
                  "built": program_builds().labels(
                      kind="kernel_library").value,
                  "lib": build._lib_path("lstm_infer"),
                  "err": float((got.cpu() - want).abs().max())}))
"""


def test_kernel_cache_second_process_loads_without_building(cuda_device,
                                                            tmp_path):
    """-compile-cache on the card: a first process builds the library into
    the directory (one miss, one build), a second loads it from there (one
    hit, nothing built); both launch the kernel, equal to its plain
    version."""
    import json
    import subprocess
    import sys

    root_dir = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root_dir)
    env.pop("MPGCN_COMPILE_CACHE", None)
    runs = []
    for _ in range(2):
        proc = subprocess.run(
            [sys.executable, "-c", _CACHE_PROC, str(tmp_path / "kc")],
            env=env, cwd=root_dir, capture_output=True, text=True,
            timeout=600)
        assert proc.returncode == 0, proc.stderr[-3000:]
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    first, second = runs
    assert (first["misses"], first["hits"], first["built"]) == (1, 0, 1)
    assert (second["misses"], second["hits"], second["built"]) == (0, 1, 0)
    for r in runs:
        assert r["dir"] == str(tmp_path / "kc")
        assert r["lib"].startswith(r["dir"] + os.sep)
        assert r["err"] <= 1e-5
    assert sorted(os.listdir(tmp_path / "kc")) == [
        os.path.basename(first["lib"])]


def test_tune_harnesses_give_finite_curves_on_the_card(cuda_device):
    """The crossover harnesses on a small grid, on the card: every arm's
    rate finite and positive, each tuned value inside its grid."""
    from mpgcn_tpu_torch.tune import measure

    sp = measure.measure_sparse_crossover(n=64, densities=(0.1, 0.3),
                                          steps=1, reps=1, device="cuda")
    assert sp["value"] in (0.0, 0.1, 0.3)
    for p in sp["curve"]:
        assert np.isfinite(p["dense_sps"]) and p["dense_sps"] > 0
        assert np.isfinite(p["sparse_sps"]) and p["sparse_sps"] > 0
    sc = measure.measure_stream_chunk(chunks_mb=(0.05, 0.25), epochs=1,
                                      reps=1, device="cuda")
    assert sc["value"] in (0.05, 0.25)
    ss = measure.measure_scan_stream_crossover(epochs=1, reps=1,
                                               device="cuda")
    assert ss["value"] == 512.0 or ss["value"] <= ss["footprint_mb"]
    for p in sc["curve"] + ss["curve"]:
        assert np.isfinite(p["steps_per_sec"]) and p["steps_per_sec"] > 0


def test_tune_run_profile_names_the_card(cuda_device, tmp_path, monkeypatch):
    """`tune run` on the card writes tuned/torch-cuda.json; its
    provenance names the card and its power limit as nvidia-smi does."""
    import json

    from mpgcn_tpu_torch.tune import cli as tune_cli
    from mpgcn_tpu_torch.tune import registry

    monkeypatch.setenv("MPGCN_TUNED_DIR", str(tmp_path))
    registry._reset_cache()
    assert tune_cli.main(["run", "--harnesses", "stream_chunk",
                          "--reps", "1"]) == 0
    with open(tmp_path / "torch-cuda.json") as f:
        prof = json.load(f)
    prov = prof["provenance"]
    assert prof["platform"] == "torch-cuda"
    assert prov["card"] == torch.cuda.get_device_name(0)
    smi = tune_cli.card_name_and_limit()
    assert prov["nvidia_smi"] == smi and smi.endswith(" W")
    assert prov["torch"] == torch.__version__
    assert prov["cuda"] == torch.version.cuda
    assert set(prof["constants"]) == {"stream_chunk_mb"}


def test_planned_buckets_roll_out_as_plain(cuda_device, tmp_path):
    """Planned buckets that are not powers of two (1, 3, 7): each
    bucket's captured rollout (its staging buffers, the K-BDGCN and LSTM
    kernels at B = 3 and 7) against the plain arms' rollout."""
    cfg = MPGCNConfig(synthetic_T=120, synthetic_N=12, hidden_dim=16,
                      pred_len=2, seed=0)
    data = synthetic_dataset(cfg)
    eng = ServeEngine(cfg, data, ServeConfig(buckets=(1, 3, 7),
                                             horizons=(2,),
                                             output_dir=str(tmp_path)),
                      device=cuda_device, allow_fresh=True)
    try:
        assert set(eng._rollouts.graphs.graphs) == {
            (s, b, 2, "f32") for s in (0, 1) for b in (1, 3, 7)}
        assert eng.stats()["buckets"] == [1, 3, 7]
        plain = MPGCN.from_config(eng.cfg, device=cuda_device,
                                  lstm_impl="plain", bdgcn_impl="einsum")
        plain.load_state_dict(eng.model.state_dict())
        md = eng.pipeline.modes["test"]
        for b in (3, 7):
            x = torch.from_numpy(np.array(md.x[:b]))
            k = torch.from_numpy(md.keys[:b].astype(np.int64))
            got = eng._rollouts.run(x, k, 2)
            ref = rollout(plain, eng.banks, x.to(cuda_device),
                          k.to(cuda_device), 2).cpu()
            assert bool(torch.isfinite(got).all())
            torch.testing.assert_close(got, ref, **ROLLOUT_TOL)
        # the request path: 3 tickets in one batch of bucket 3
        x = np.ascontiguousarray(md.x[:3])
        tickets = [eng.submit(x[i, ..., 0], int(md.keys[i]))
                   for i in range(3)]
        for t in tickets:
            assert t.wait(60) and t.ok, t.error
        ref = rollout(plain, eng.banks, torch.from_numpy(x).to(cuda_device),
                      torch.from_numpy(md.keys[:3].astype(np.int64)).to(
                          cuda_device), 2).cpu()
        preds = torch.from_numpy(np.stack([t.pred for t in tickets]))
        torch.testing.assert_close(preds, ref, **ROLLOUT_TOL)
    finally:
        eng.close()


# --- data-parallel training (parallel/) ---------------------------------------

#: the per-rank shapes of a 2-rank step at the reference widths: B = 4
#: over dp = 2 gives 2 windows a rank, R = 2 * 47^2 = 4,418 LSTM sequences
RANK_LSTM = (7, 4418, 32)
RANK_BDGCN = (3, 2, 47, 32, 32)


@pytest.mark.parametrize("dynamic", [False, True])
def test_kernels_at_the_per_rank_shapes(cuda_device, dynamic):
    """The training LSTM pair and the K-BDGCN pair at the shapes one rank
    of a 2-rank reference step gives them, against their plain
    versions."""
    T, R, H = RANK_LSTM
    rng = np.random.default_rng(R)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(cuda_device)
    xp = t(rng.normal(size=(T, R, 4 * H)))
    w = t(rng.normal(size=(H, 4 * H)) / np.sqrt(H))
    hs, cs = cuda_lstm.lstm_layer_train(xp, w)
    hp, cp = cuda_lstm.lstm_layer_train_plain(xp, w)
    torch.testing.assert_close(hs, hp, **KERNEL_TOL)
    torch.testing.assert_close(cs, cp, **KERNEL_TOL)
    dhs = t(rng.normal(size=(T, R, H)))
    dxp, dw = cuda_lstm.lstm_layer_bwd(xp, w, hs, cs, dhs, None)
    dxr, dwr = cuda_lstm.lstm_layer_bwd_plain(xp, w, hs, cs, dhs, None)
    torch.testing.assert_close(dxp, dxr, **KERNEL_TOL)
    _close_scaled(dw, dwr)
    K, B, N, C, H = RANK_BDGCN
    h1, g, wb = _bdgcn_inputs(cuda_device, K, B, N, C, H, dynamic, seed=N)
    torch.testing.assert_close(
        cuda_bdgcn.folded_pair_project(h1, g, wb),
        cuda_bdgcn.folded_pair_project_plain(h1, g, wb), **KERNEL_TOL)
    dout = torch.from_numpy(rng.normal(size=(B, N, N, H)).astype(
        np.float32)).to(cuda_device)
    dh1, dW = cuda_bdgcn.folded_pair_project_bwd(h1, g, wb, dout)
    r1, rW = cuda_bdgcn.folded_pair_project_bwd_plain(h1, g, wb, dout)
    torch.testing.assert_close(dh1, r1, **KERNEL_TOL)
    _close_scaled(dW, rW)


def test_one_nccl_rank_by_graph_equals_model_trainer(cuda_device, tmp_path):
    """A one-rank NCCL world: its steps captured with the gradient
    all-reduce inside the graph, 2 epochs equal to ModelTrainer's from
    the same seeded init bit for bit (a one-rank SUM is the identity):
    the epoch losses, the weights and Adam's state."""
    import torch.distributed as dist

    from mpgcn_tpu_torch.parallel import ParallelModelTrainer, initialize

    cfg = MPGCNConfig(synthetic_T=120, synthetic_N=10, pred_len=1, seed=0,
                      num_epochs=2)
    data = synthetic_dataset(cfg)
    ref = ModelTrainer(cfg.replace(output_dir=str(tmp_path / "one")), data,
                       device=cuda_device)
    h_ref = ref.train()
    initialize(f"file://{tmp_path}/rendezvous", world_size=1, rank=0,
               backend="nccl")
    try:
        par = ParallelModelTrainer(cfg.replace(output_dir=str(
            tmp_path / "dp")), data, device=cuda_device)
        assert par.graph_refusal is None, par.graph_refusal
        h_par = par.train()
        assert par._graphs.get("train") is not None
    finally:
        dist.destroy_process_group()
    assert h_par == h_ref
    _assert_same_state(par, ref)


def test_devices_past_the_visible_cards_exit_before_spawning(cuda_device,
                                                             tmp_path):
    """-devices N > the cards this process sees: the JAX make_mesh
    message, before any rank starts or any data loads."""
    from mpgcn_tpu_torch import cli

    n = torch.cuda.device_count() + 1
    with pytest.raises(SystemExit, match=f"requested {n} devices, only "
                                         f"{n - 1} visible"):
        cli.main(["-GPU", "0", "-devices", str(n), "-data", "npz", "-in",
                  str(tmp_path / "missing"), "-out", str(tmp_path)])


# --- the model axis (node_shard.py, parallel/halo.py) ------------------------


def test_gather_origins_and_a_one_rank_mesh_bdgcn_equal_unsharded(
        cuda_device, tmp_path):
    """On a one-rank NCCL group: the origin all-gather and its
    reduce-scatter backward are the identity on the card, and a BDGCN
    layer on the one-rank mesh's node shard (kernel arm) equals the
    unsharded layer, forward and gradient, through K-BDGCN."""
    import torch.distributed as dist

    from mpgcn_tpu_torch.nn.bdgcn import BDGCN, bdgcn_apply
    from mpgcn_tpu_torch.node_shard import _GatherOrigins
    from mpgcn_tpu_torch.parallel import initialize, make_mesh, node_shard

    K, B, N, C, H = 3, 2, 47, 32, 32
    rng = np.random.default_rng(N)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(cuda_device)
    X = t(rng.normal(size=(B, N, N, C)))
    G = t(rng.random(size=(K, N, N)) / N)
    layer = BDGCN(K, C, H, True, torch.Generator().manual_seed(0)).to(
        cuda_device)
    initialize(f"file://{tmp_path}/rendezvous", world_size=1, rank=0,
               backend="nccl")
    try:
        x = X.clone().requires_grad_(True)
        out = _GatherOrigins.apply(x, 1, dist.group.WORLD, 1)
        assert torch.equal(out, X)
        g = torch.randn_like(out)
        out.backward(g)
        assert torch.equal(x.grad, g)
        shard = node_shard(make_mesh(device=cuda_device), N)
        grads = []
        for s in (shard, None):
            layer.zero_grad()
            x = X.clone().requires_grad_(True)
            before = cuda_bdgcn.BDGCN_PAIR_FWD.launches
            y = bdgcn_apply(layer, x, G, torch.relu, impl="kernel", shard=s)
            assert cuda_bdgcn.BDGCN_PAIR_FWD.launches == before + 1
            y.square().sum().backward()
            grads.append((y.detach(), x.grad, layer.W.grad.clone()))
    finally:
        dist.destroy_process_group()
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("dynamic", [False, True])
def test_kernels_at_a_model_axis_ranks_shapes(cuda_device, dynamic):
    """The shapes one rank of a reference step at mp = 2 gives the
    kernels: the training LSTM pair on R = 4 * 24 * 47 = 4,512 sequences,
    and K-BDGCN forward and backward on h1 of M = 24 origin rows of
    N = 47, against their plain versions."""
    K, B, M, N, C = 3, 4, 24, 47, 32
    T, R = 7, B * M * N
    rng = np.random.default_rng(M)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(cuda_device)
    xp = t(rng.normal(size=(T, R, 4 * C)))
    wl = t(rng.normal(size=(C, 4 * C)) / np.sqrt(C))
    hs, cs = cuda_lstm.lstm_layer_train(xp, wl)
    hp, cp = cuda_lstm.lstm_layer_train_plain(xp, wl)
    torch.testing.assert_close(hs, hp, **KERNEL_TOL)
    torch.testing.assert_close(cs, cp, **KERNEL_TOL)
    dhs = t(rng.normal(size=(T, R, C)))
    dxp, dwl = cuda_lstm.lstm_layer_bwd(xp, wl, hs, cs, dhs, None)
    dxr, dwr = cuda_lstm.lstm_layer_bwd_plain(xp, wl, hs, cs, dhs, None)
    torch.testing.assert_close(dxp, dxr, **KERNEL_TOL)
    _close_scaled(dwl, dwr)
    h1 = t(rng.normal(size=(K, B, M, N, C)))
    g = t(rng.random((B if dynamic else 1, K, N, N)) / N * 2)
    w = t(rng.normal(size=(K, K, C, C)) / np.sqrt(K * K * C))
    dout = t(rng.normal(size=(B, M, N, C)))
    before = (cuda_bdgcn.BDGCN_PAIR_FWD.launches,
              cuda_bdgcn.BDGCN_PAIR_BWD.launches)
    out = cuda_bdgcn.folded_pair_project(h1, g, w)
    dh1, dW = cuda_bdgcn.folded_pair_project_bwd(h1, g, w, dout)
    torch.cuda.synchronize()
    assert (cuda_bdgcn.BDGCN_PAIR_FWD.launches,
            cuda_bdgcn.BDGCN_PAIR_BWD.launches) == (before[0] + 1,
                                                    before[1] + 1)
    torch.testing.assert_close(out, cuda_bdgcn.folded_pair_project_plain(
        h1, g, w), **KERNEL_TOL)
    r1, rW = cuda_bdgcn.folded_pair_project_bwd_plain(h1, g, w, dout)
    torch.testing.assert_close(dh1, r1, **KERNEL_TOL)
    _close_scaled(dW, rW)


def test_halo_spmm_with_one_shard_launches_the_ell_kernels(cuda_device):
    """A halo plan of one shard (no exchange) on the ell local arm: the
    forward launches ell_fwd, the backward ell_bwd_dx, and both equal the
    dense product."""
    from mpgcn_tpu_torch.parallel.halo import build_halo_plan, halo_spmm
    from mpgcn_tpu_torch.sparse.formats import csr_from_dense

    rng = np.random.default_rng(3)
    K, N, F = 3, 64, 6
    G = (rng.normal(size=(K, N, N))
         * (rng.random((N, N)) < 0.1)).astype(np.float32)
    plan = build_halo_plan(csr_from_dense(G), 1,
                           local_impl="ell").to(cuda_device)
    X = rng.normal(size=(N, F)).astype(np.float32)
    x = torch.from_numpy(X).to(cuda_device).requires_grad_(True)
    f0, b0 = cuda_ell.ELL_FWD.launches, cuda_ell.ELL_BWD_DX.launches
    out = halo_spmm(plan, x, local_impl="ell")
    out.square().sum().backward()
    assert cuda_ell.ELL_FWD.launches > f0
    assert cuda_ell.ELL_BWD_DX.launches > b0
    ref = np.einsum("knm,mf->knf", G, X)
    np.testing.assert_allclose(out.detach().cpu().numpy(), ref, **KERNEL_TOL)
    np.testing.assert_allclose(x.grad.cpu().numpy(),
                               2 * np.einsum("knm,knf->mf", G, ref),
                               rtol=1e-4, atol=1e-4)
