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
applies ``check_branch_spec``. ``load_serving_params`` is the serving
plane's load (mpgcn_tpu/train/checkpoint.py:198-213): it also verifies
what a JAX checkpoint records about itself. A topology manifest must be
sound, and every ``params`` leaf must match its blake2b digest in the
integrity record (labels and digests computed as the JAX package's
resilience/elastic.py computes them); damage raises
``CheckpointCorruptError``. The ``opt_state`` leaves of the record are
not checked: they are optax classes the restricted unpickler leaves as
stubs, and serving never reads them. A file with no record (the port's
own checkpoints, older JAX ones) loads unchecked, as in the JAX loader.
"""

from __future__ import annotations

import hashlib
from typing import Optional

import numpy as np
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
           "checkpoint_payload", "integrity_mismatches", "load_checkpoint",
           "load_opt_state", "load_serving_params", "opt_state_to_host",
           "params_integrity", "save_checkpoint"]

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


# --- the serving load: manifest and integrity checks -------------------------

#: the manifest format the JAX package writes, and the keys it requires
MANIFEST_FORMAT = 1
_MANIFEST_REQUIRED = ("format", "process_count", "device_count", "mesh")


def _manifest_error(manifest) -> Optional[str]:
    """What is wrong with a topology manifest, or None (the JAX
    ``validate_manifest``)."""
    if not isinstance(manifest, dict):
        return (f"topology manifest is {type(manifest).__name__}, "
                f"expected dict")
    missing = [k for k in _MANIFEST_REQUIRED if k not in manifest]
    if missing:
        return f"topology manifest is missing keys {missing}"
    if not isinstance(manifest["format"], int):
        return "topology manifest 'format' is not an int"
    if manifest["format"] > MANIFEST_FORMAT:
        return (f"topology manifest format {manifest['format']} is newer "
                f"than this build understands ({MANIFEST_FORMAT})")
    mesh = manifest["mesh"]
    if mesh is not None and not isinstance(mesh, dict):
        return f"topology manifest 'mesh' is {type(mesh).__name__}"
    return None


def _leaf_digest(leaf) -> str:
    """blake2b-128 of one leaf, its dtype and shape folded in (the JAX
    ``_leaf_digest``)."""
    arr = np.ascontiguousarray(leaf)
    h = hashlib.blake2b(digest_size=16)
    h.update(f"{arr.dtype.str}|{arr.shape}|".encode())
    h.update(arr.tobytes())
    return h.hexdigest()


def _labelled(tree, label: str):
    """(label, leaf) pairs in the JAX tree order: dict keys sorted, list
    and tuple entries by index, labels as ``jax.tree_util.keystr``."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _labelled(tree[k], f"{label}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _labelled(v, f"{label}[{i}]")
    elif tree is not None:
        yield label, tree


def params_integrity(params) -> dict:
    """``{label: digest}`` of a host params tree, the labels the JAX
    integrity record gives them (``params['branches'][0]...``)."""
    return {label: _leaf_digest(np.asarray(leaf))
            for label, leaf in _labelled(params, "params")}


def integrity_mismatches(params, record) -> list[str]:
    """The params labels whose digest disagrees with ``record`` (or that
    are missing on either side); empty when they verify. A malformed
    record is one pseudo-label."""
    if (not isinstance(record, dict)
            or not isinstance(record.get("leaves"), dict)):
        return ["<integrity record malformed>"]
    current = params_integrity(params)
    saved = {k: v for k, v in record["leaves"].items()
             if k.startswith("params")}
    bad = [label for label, dig in current.items()
           if saved.get(label) != dig]
    bad += [label for label in saved if label not in current]
    return sorted(bad)


def load_serving_params(path: str, num_branches: Optional[int] = None,
                        branch_sources=None) -> dict:
    """The checkpoint dict (numpy params and ``extra``) for the serving
    path, verified (module docstring) and, when ``num_branches`` is
    given, held to the live model's branch spec. Raises
    ``CheckpointCorruptError`` on damaged bytes, ``ValueError`` on a
    checkpoint that does not fit."""
    payload = read_checkpoint(path)
    if "manifest" in payload:
        err = _manifest_error(payload["manifest"])
        if err:
            raise CheckpointCorruptError(
                f"checkpoint {path}: {err} -- treating as corrupt")
    if "integrity" in payload:
        bad = integrity_mismatches(payload["params"], payload["integrity"])
        if bad:
            shown = ", ".join(bad[:4]) + (" ..." if len(bad) > 4 else "")
            raise CheckpointCorruptError(
                f"checkpoint {path}: integrity checksum mismatch on "
                f"{len(bad)} leaf/leaves ({shown}) -- bit rot or a torn "
                f"write that still unpickled")
    if num_branches is not None:
        check_branch_spec(payload, path, num_branches, branch_sources)
    return payload
