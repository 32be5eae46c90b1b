"""Multi-step training and gradient accumulation in the port against the
JAX trainer, on the CPU (mirrors tests/test_trainer.py:241, 578-615):
the seq2seq loss through the differentiable rollout and its gradients
against ``jax.grad`` of the JAX ``_batch_loss`` on a 6-frame target (the
kernel arms' plain versions, the plain arms and the ELL arm), two
multi-step epochs against the JAX trainer, ``grad_accum`` against the
full batch and against the JAX trainer's accumulation, and the CLI's
``-multistep -accum``.

Tolerances: the seq2seq loss and gradients rtol 1e-4 / atol 1e-5 (6
chained f32 forwards); epoch losses rtol 1e-5 and weights rtol 1e-4 /
atol 2e-6 against the JAX trainer (tests/test_torch_train.py's
two-epoch test); accumulated against full-batch epoch losses rtol 1e-4 /
atol 1e-6 (the JAX test's own).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpgcn_tpu_torch import cli
from mpgcn_tpu_torch.config import MPGCNConfig
from mpgcn_tpu_torch.train.trainer import ModelTrainer
from mpgcn_tpu_torch.utils.convert import params_from_jax
from tests.torch_heal_common import (
    INIT_SEED,
    KW,
    data_for,
    jax_params,
    jax_trainer,
    np_tree,
    pair,
    port_params,
    port_trainer,
)

# each pytest-xdist worker takes its share of the cores: torch's default
# of one intra-op thread per core, in every worker at once, oversubscribes
# the machine
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
LOSS_TOL = dict(rtol=1e-5, atol=0)
PARAM_TOL = dict(rtol=1e-4, atol=2e-6)
ACCUM_TOL = dict(rtol=1e-4, atol=1e-6)
PRED = 6


@pytest.fixture(scope="module")
def data():
    return data_for()


@pytest.mark.parametrize("arms", [("kernel", "auto"), ("plain", "einsum"),
                                  ("kernel", "ell")])
def test_seq2seq_loss_and_grads_match_jax(tmp_path, data, arms):
    """One padded batch (3 real rows of 4) with a 6-frame target: the
    port's loss through ``rollout_train`` and its gradients equal
    ``jax.value_and_grad`` of the JAX ``_batch_loss``, which rolls out
    through ``_rollout_fn(..., inference=False)``."""
    lstm_impl, bdgcn_impl = arms
    jt = jax_trainer(tmp_path / "jax", data, pred_len=PRED)
    pt = ModelTrainer(MPGCNConfig(**{**KW, "pred_len": PRED,
                                     "seed": INIT_SEED,
                                     "output_dir": str(tmp_path / "p")}),
                      data, device="cpu", lstm_impl=lstm_impl,
                      bdgcn_impl=bdgcn_impl)
    assert pt.bdgcn_impl == ("kernel" if bdgcn_impl == "auto"
                             else bdgcn_impl)
    pt.model.load_state_dict(params_from_jax(np_tree(jt.params)))
    batch = list(pt.pipeline.batches("train", batch_size=4,
                                     pad_to_full=True))[-1]
    assert batch.size < 4 and batch.y.shape[1] == PRED
    loss_j, g_j = jax.value_and_grad(jt._batch_loss)(
        jt.params, jt.banks, jnp.asarray(batch.x), jnp.asarray(batch.y),
        jnp.asarray(batch.keys), batch.size)
    x, y, keys = pt._tensors(batch)
    loss = pt._loss_and_grads(x, y, keys, pt._size(batch))
    np.testing.assert_allclose(float(loss), float(loss_j), **GRAD_TOL)
    ref = params_from_jax(np_tree(g_j))
    for n, p in pt.model.named_parameters():
        assert p.grad is not None and bool(p.grad.abs().sum() > 0), n
        np.testing.assert_allclose(p.grad.numpy(), ref[n].numpy(),
                                   err_msg=n, **GRAD_TOL)


@pytest.fixture(scope="module")
def multistep(data, tmp_path_factory):
    """Two multi-step (6-frame) epochs in each package from one init."""
    jt, pt = pair(tmp_path_factory.mktemp("ms"), data, pred_len=PRED,
                  num_epochs=2)
    init = port_params(pt)
    return dict(jt=jt, pt=pt, init=init, hj=jt.train(), hp=pt.train())


def test_two_multistep_epochs_match_jax(multistep):
    r = multistep
    pt, jt = r["pt"], r["jt"]
    for mode in ("train", "validate"):
        np.testing.assert_allclose(r["hp"][mode], r["hj"][mode],
                                   **LOSS_TOL)
    final = jax_params(jt)
    for k, v in port_params(pt).items():
        np.testing.assert_allclose(v.numpy(), final[k].numpy(), err_msg=k,
                                   **PARAM_TOL)
        assert not torch.equal(v, r["init"][k]), k
    # the train split yields 6-frame targets, as the JAX pipeline's
    for mode in ("train", "validate"):
        ours, ref = pt.pipeline.modes[mode], jt.pipeline.modes[mode]
        assert ours.y.shape == ref.y.shape and ours.y.shape[1] == PRED
        np.testing.assert_array_equal(ours.y, ref.y)


def test_multistep_test_mode_scores_per_horizon(multistep, tmp_path):
    """tests/test_trainer.py:241: the trained rollout tests, with an RMSE
    per horizon."""
    res = multistep["pt"].test()
    assert len(res["test"]["RMSE_by_horizon"]) == PRED
    assert np.isfinite(res["test"]["RMSE"])


@pytest.mark.parametrize("k", [2, 4])
def test_grad_accum_matches_full_batch_and_jax(tmp_path, k):
    """tests/test_trainer.py:578: k interleaved chunks and one update equal
    the full batch (an odd series, so the final train batch is padded and
    masked by global position); the port's accumulation against the JAX
    trainer's."""
    data = data_for(synthetic_T=61)
    jt, pt = pair(tmp_path / "k", data, synthetic_T=61, num_epochs=2,
                  grad_accum=k)
    full = port_trainer(tmp_path / "full", data, init=jt, synthetic_T=61,
                        num_epochs=2)
    assert len(pt.pipeline.modes["train"]) % 4
    hj, hp, hf = jt.train(), pt.train(), full.train()
    np.testing.assert_allclose(hp["train"], hf["train"], **ACCUM_TOL)
    for mode in ("train", "validate"):
        np.testing.assert_allclose(hp[mode], hj[mode], **LOSS_TOL)
    final = jax_params(jt)
    for name, v in port_params(pt).items():
        np.testing.assert_allclose(v.numpy(), final[name].numpy(),
                                   err_msg=name, **PARAM_TOL)


@pytest.mark.parametrize("epoch_scan", [True, False])
def test_grad_accum_seq2seq(tmp_path, data, epoch_scan):
    """tests/test_trainer.py:602: accumulation through the multi-step
    rollout matches the unchunked step, on either executor."""
    hist = {}
    for k in (1, 2):
        tr = port_trainer(tmp_path / f"a{k}", data, grad_accum=k,
                          num_epochs=2, pred_len=2, epoch_scan=epoch_scan)
        hist[k] = tr.train()["train"]
    np.testing.assert_allclose(hist[2], hist[1], **ACCUM_TOL)


def test_cli_multistep_accum(tmp_path, capsys):
    """The CLI keeps -pred in train mode under -multistep and takes -accum:
    one epoch on a 3-frame target, then test mode."""
    argv = ["-GPU", "cpu", "-data", "synthetic", "-sN", "8", "-sT", "60",
            "-hidden", "8", "-pred", "3", "-out", str(tmp_path)]
    hist = cli.main(argv + ["-epoch", "1", "-multistep", "-accum", "2"])
    assert np.isfinite(hist["train"]).all()
    res = cli.main(argv + ["-mode", "test"])
    assert len(res["test"]["RMSE_by_horizon"]) == 3
