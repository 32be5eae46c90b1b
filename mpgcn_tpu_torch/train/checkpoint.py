"""Checkpoints in the JAX package's pickle format (counterpart of
mpgcn_tpu/train/checkpoint.py:79-195).

``save_checkpoint`` writes ``{"epoch", "params": <JAX numpy tree>,
"extra": {...}}`` atomically and durably (tmp + fsync + replace), so the
JAX ``load_checkpoint`` reads a port checkpoint and the port reads a JAX
one. It writes no topology manifest and no integrity record: the JAX
loader reads such a file unchecked. Optimizer state is not saved yet (it
belongs with resume, which this port does not have).

``load_checkpoint`` reads through the restricted unpickler of
utils/convert.py and applies ``check_branch_spec``.
"""

from __future__ import annotations

import os
import pickle

from mpgcn_tpu_torch.utils.convert import (
    check_branch_spec,
    params_to_jax,
    read_checkpoint,
)


def save_checkpoint(path: str, model, epoch: int,
                    extra: dict | None = None) -> None:
    payload = {"epoch": epoch, "params": params_to_jax(model.state_dict())}
    if extra:
        payload["extra"] = extra
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        with open(tmp, "wb") as f:
            pickle.dump(payload, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def load_checkpoint(path: str, num_branches=None,
                    branch_sources=None) -> dict:
    """The checkpoint's payload dict (numpy params tree), after the branch
    spec check."""
    payload = read_checkpoint(path)
    check_branch_spec(payload, path, num_branches, branch_sources)
    return payload
