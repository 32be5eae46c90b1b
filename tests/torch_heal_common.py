"""Shared set-up of the self-healing trainer's parity tests
(tests/test_torch_resilience.py, test_torch_resume.py,
test_torch_deadinit.py, test_torch_multistep.py): one small synthetic
series, a JAX trainer and a port trainer (on the CPU) from the same JAX
init, NaN windows written into a mode's data on either side, the dead
ReLU head forced on either side, and the run logs read back.

Sizes: N=8, hidden 8, synthetic_T=60 (34 training and 8 validation
windows), batch 4; the JAX init seed 10 leaves both branches live at
these widths (tests/test_torch_train.py INIT_SEED).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np

from mpgcn_tpu.config import MPGCNConfig as JaxConfig
from mpgcn_tpu.train import ModelTrainer as JaxTrainer
from mpgcn_tpu_torch.config import MPGCNConfig
from mpgcn_tpu_torch.data.loader import synthetic_dataset
from mpgcn_tpu_torch.train.trainer import ModelTrainer
from mpgcn_tpu_torch.utils.convert import params_from_jax
from mpgcn_tpu_torch.utils.logging import read_events

N, H = 8, 8
KW = dict(synthetic_T=60, synthetic_N=N, hidden_dim=H, pred_len=1)
INIT_SEED = 10


def data_for(**kw):
    return synthetic_dataset(MPGCNConfig(**{**KW, **kw}))


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def jax_trainer(out, data, **kw):
    return JaxTrainer(JaxConfig(native_host="off", output_dir=str(out),
                                **{**KW, "seed": INIT_SEED, **kw}), data)


def port_trainer(out, data, init=None, **kw):
    """A port trainer on the CPU; ``init`` (a JAX trainer or a JAX params
    tree) gives its weights."""
    tr = ModelTrainer(MPGCNConfig(output_dir=str(out),
                                  **{**KW, "seed": INIT_SEED, **kw}),
                      data, device="cpu")
    if init is not None:
        tree = init.params if isinstance(init, JaxTrainer) else init
        tr.model.load_state_dict(params_from_jax(np_tree(tree)))
    return tr


def pair(tmp_path, data, **kw):
    """A JAX trainer and a port trainer from its init, each with an output
    directory of its own."""
    jt = jax_trainer(tmp_path / "jax", data, **kw)
    return jt, port_trainer(tmp_path / "port", data, init=jt, **kw)


def poison(trainer, step: int, mode: str = "train") -> None:
    """NaN input windows for the rows of (unshuffled) step ``step`` of
    ``mode``, in a copy of the mode's windows, on either package's
    trainer, before its first epoch reads them."""
    md = trainer.pipeline.modes[mode]
    bs = trainer.cfg.batch_size
    x = np.array(md.x)
    x[step * bs: (step + 1) * bs] = np.nan
    md.x = x


def force_dead_head(trainer) -> None:
    """Every branch's FC head strictly negative, so (the BDGCN output
    being non-negative) the forward is identically zero and every loss
    gradient exactly zero (tests/test_trainer.py ``_force_dead_head``);
    on either package's trainer."""
    if isinstance(trainer, JaxTrainer):
        for br in trainer.params["branches"]:
            br["fc"] = jax.tree_util.tree_map(lambda x: -jnp.abs(x) - 0.1,
                                              br["fc"])
        return
    import torch

    with torch.no_grad():
        for br in trainer.model.branches:
            for p in br.fc.parameters():
                p.copy_(-p.abs() - 0.1)


def events(out, name=None) -> list:
    return read_events(os.path.join(str(out), "MPGCN_train_log.jsonl"), name)


def event_names(out) -> list:
    return [e["event"] for e in events(out)]


def finite_port(tr) -> bool:
    return all(bool(p.isfinite().all()) for p in tr.model.parameters())


def finite_jax(jt) -> bool:
    return all(np.isfinite(np.asarray(x)).all()
               for x in jax.tree_util.tree_leaves(jt.params))


def port_params(tr) -> dict:
    return {k: v.detach().clone() for k, v in tr.model.state_dict().items()}


def jax_params(jt) -> dict:
    return params_from_jax(np_tree(jt.params))


def opt_snapshot(tr) -> list:
    """Adam's moments and steps, the rate and the step counter."""
    return [t.detach().clone() for t in tr.optimizer.guarded()
            [len(list(tr.model.parameters())):]]
