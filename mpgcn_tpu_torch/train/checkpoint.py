"""Checkpoints in the JAX package's pickle format (counterpart of
mpgcn_tpu/train/checkpoint.py:79-195).

``save_checkpoint`` writes ``{"epoch", "params": <JAX numpy tree>,
"opt_state_torch": {...}, "extra": {...}}`` atomically and durably (tmp +
fsync + replace), so the JAX ``load_checkpoint`` reads a port checkpoint
and the port reads a JAX one. It writes no topology manifest and no
integrity record: the JAX loader reads such a file unchecked.

The optimizer state (for resume and rollback) goes under a key of its
own, ``opt_state_torch``: Adam's moments as numpy trees with the JAX
parameter names (``params_to_jax``), the update count, and the optax
chain it stands for. The port cannot write optax's state classes without
importing optax, and the JAX trainer, finding no ``opt_state`` in a port
checkpoint, reads its params and keeps a fresh optimizer, as it does for
a best-only file. The other way, ``adam_state_from_jax`` maps a JAX
checkpoint's ``ScaleByAdamState(count, mu, nu)`` by position when its
chain matches the port's configuration.

With the dynamic loss scaler (bf16 training), the JAX optimizer state is
``DynamicLossScaleState(inner, scale, good_steps, skipped)`` around the
chain's: ``adam_state_from_jax`` reads the chain from ``inner`` and the
scaler's three scalars beside it, and the port writes them under
``loss_scale`` in its own key (``{"scale", "good_steps", "skipped"}``).
A state with a scaler fits only a run with one, and one without only a
run without (the JAX trainer's structure check).

``load_checkpoint`` reads through the restricted unpickler of
utils/convert.py (a torn file raises ``CheckpointCorruptError``) and
applies ``check_branch_spec``.
"""

from __future__ import annotations

from typing import Optional

import torch

from mpgcn_tpu_torch.utils.atomic import atomic_pickle_dump
from mpgcn_tpu_torch.utils.convert import (
    CheckpointCorruptError,
    _Stub,
    check_branch_spec,
    host_arrays,
    params_from_jax,
    params_to_jax,
    read_checkpoint,
)

__all__ = ["CheckpointCorruptError", "OPT_STATE_KEY", "adam_state_from_jax",
           "checkpoint_payload", "load_checkpoint", "load_opt_state",
           "opt_state_to_host", "save_checkpoint"]

#: the payload key of the port's optimizer state
OPT_STATE_KEY = "opt_state_torch"


def _structure(tree):
    if isinstance(tree, tuple):
        return tuple(_structure(t) for t in tree)
    if isinstance(tree, _Stub):
        return tree.name
    return type(tree).__name__


def _find_adam(tree):
    if isinstance(tree, tuple):
        for t in tree:
            found = _find_adam(t)
            if found is not None:
                return found
    elif isinstance(tree, _Stub) and tree.name == "ScaleByAdamState":
        return tree
    return None


def adam_state_from_jax(opt_state, chain: tuple) -> Optional[dict]:
    """A JAX checkpoint's optax state as the port's ``{"count", "mu",
    "nu"}`` (and ``loss_scale`` from a ``DynamicLossScaleState``), or None
    where its chain's structure differs from ``chain`` (the JAX trainer
    then restores params only and reinitialises)."""
    if isinstance(opt_state, _Stub) \
            and opt_state.name == "DynamicLossScaleState" \
            and len(opt_state.args) == 4:
        inner, scale, good_steps, skipped = opt_state.args
        state = adam_state_from_jax(inner, chain)
        if state is not None:
            state["loss_scale"] = {"scale": float(scale),
                                   "good_steps": int(good_steps),
                                   "skipped": int(skipped)}
        return state
    if _structure(opt_state) != chain:
        return None
    adam = _find_adam(opt_state)
    if adam is None or len(adam.args) != 3:
        return None
    count, mu, nu = adam.args
    return {"count": int(count), "mu": mu, "nu": nu, "chain": chain}


def opt_state_to_host(model, optimizer) -> dict:
    """The optimizer state as host data: Adam's moments as JAX-named numpy
    trees (read from the device in one copy), the update count (the
    device step counter, read here: after a skipped step it is the truth,
    not the host's mirror) and the chain."""
    named = list(model.named_parameters())
    st = optimizer.state
    moments = host_arrays([st[p][k] for k in ("exp_avg", "exp_avg_sq")
                           for _, p in named])
    names = [n for n, _ in named]
    state = {"count": int(optimizer.step_t),
             "mu": params_to_jax(dict(zip(names, moments[:len(names)]))),
             "nu": params_to_jax(dict(zip(names, moments[len(names):]))),
             "chain": optimizer.chain}
    if optimizer.scaler is not None:
        st = optimizer.scaler.stats()
        state["loss_scale"] = {"scale": st["scale"],
                               "good_steps": st["good_steps"],
                               "skipped": st["skipped_steps"]}
    return state


def load_opt_state(model, optimizer, state: dict) -> None:
    """Copy ``state`` (``opt_state_to_host``'s layout) into the optimizer in
    place, so captured steps stay valid."""
    mu, nu = params_from_jax(state["mu"]), params_from_jax(state["nu"])
    with torch.no_grad():
        for n, p in model.named_parameters():
            st = optimizer.state[p]
            st["exp_avg"].copy_(mu[n])
            st["exp_avg_sq"].copy_(nu[n])
    optimizer.set_count(int(state["count"]))
    if optimizer.scaler is not None and "loss_scale" in state:
        optimizer.scaler.load(state["loss_scale"])


def checkpoint_payload(params: dict, epoch: int, extra: dict | None = None,
                       opt_state: dict | None = None) -> dict:
    """The pickled dict: ``params`` a JAX params tree (``params_to_jax``),
    ``opt_state`` ``opt_state_to_host``'s dict or None."""
    payload = {"epoch": epoch, "params": params}
    if opt_state is not None:
        payload[OPT_STATE_KEY] = opt_state
    if extra:
        payload["extra"] = extra
    return payload


def save_checkpoint(path: str, model, epoch: int,
                    extra: dict | None = None,
                    opt_state: dict | None = None) -> None:
    """``opt_state``: ``opt_state_to_host``'s dict, or None."""
    atomic_pickle_dump(path, checkpoint_payload(
        params_to_jax(model.state_dict()), epoch, extra, opt_state))


def load_checkpoint(path: str, num_branches=None,
                    branch_sources=None) -> dict:
    """The checkpoint's payload dict (numpy params tree), after the branch
    spec check."""
    payload = read_checkpoint(path)
    check_branch_spec(payload, path, num_branches, branch_sources)
    return payload
