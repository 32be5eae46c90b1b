"""Silent-divergence detection for replicated training state (counterpart
of mpgcn_tpu/parallel/consistency.py).

Every rank of a parallel run holds a full replica of the weights, Adam's
state and the support banks (on a model axis too: the ranks split the
windows' rows and origin nodes, never the weights), and each step keeps
them equal: the same all-reduced gradients go through the same update. What can still
part them is outside the step: a bad restore, a rank fed other
"replicated" values, memory corruption over a long run. Each rank digests
the bytes of every leaf (blake2b, 64 bits) and the ranks compare the
digest tables.

Collective contract (the JAX one): every rank runs the same fixed
sequence of all-gathers whatever it found -- the fail vote, the table
size, the key ids, the digests -- so no rank waits in an unpaired
collective, and ``ReplicaDivergenceError`` is raised on every rank in the
same call, which lets the trainer roll back in lockstep
(``ModelTrainer._bad_epoch``). A 64-bit collision among one rank's key
ids raises ``ValueError`` on every rank instead: a naming problem, not a
divergence, and not a reason to roll back.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch
import torch.distributed as dist


class ReplicaDivergenceError(RuntimeError):
    """Two ranks hold different bytes for the same leaf."""


def _digest(data: bytes) -> int:
    h = hashlib.blake2b(digest_size=8)
    h.update(data)
    return int.from_bytes(h.digest(), "little", signed=True)


def _leaf_bytes(leaf) -> bytes:
    if torch.is_tensor(leaf):
        t = leaf.detach().contiguous().cpu().reshape(-1)
        return t.view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(leaf).tobytes()


def _leaves(tree, label: str = ""):
    """(label, leaf) over the tensors and arrays of ``tree``: dicts by
    sorted key, lists and tuples by index, dataclasses (the sparse support
    containers) by field; other values are not state and are skipped."""
    if torch.is_tensor(tree) or isinstance(tree, np.ndarray):
        yield label, tree
    elif isinstance(tree, dict):
        for k in sorted(tree, key=str):
            yield from _leaves(tree[k], f"{label}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{label}[{i}]")
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name), f"{label}.{f.name}")


def _comm_device() -> torch.device:
    """Where the group's collectives take their tensors."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _all_gather(values: np.ndarray) -> np.ndarray:
    """(world, len) int64: every rank's ``values`` (all one length)."""
    dev = _comm_device()
    t = torch.from_numpy(np.ascontiguousarray(values, np.int64)).to(dev)
    out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(out, t)
    return torch.stack(out).cpu().numpy()


def check_replica_consistency(tree, name: str = "state") -> int:
    """Raise ``ReplicaDivergenceError`` on every rank if two ranks disagree
    on any leaf of ``tree`` (nested dicts, lists, tuples and dataclasses of
    tensors or arrays); returns the number of leaves digested. Without a
    process group there is one replica and nothing to compare."""
    local = {label: _digest(_leaf_bytes(leaf))
             for label, leaf in _leaves(tree)}
    if not dist.is_initialized():
        return len(local)
    keys = sorted(local)
    ids = np.array([_digest(k.encode()) for k in keys], dtype=np.int64)
    id_to_key = {int(i): k for i, k in zip(ids, keys)}
    collision = len(id_to_key) != len(keys)
    # 1. the fail vote: 0 ok, 2 an id collision on that rank
    votes = _all_gather(np.array([2 if collision else 0])).ravel()
    if (votes == 2).any():
        bad = [int(r) for r in np.nonzero(votes == 2)[0]]
        raise ValueError(
            f"{name}: 64-bit key-id collision among the leaf labels on "
            f"rank(s) {bad} (two distinct leaves hash to one id) -- the "
            f"digest comparison would conflate them; rename a parameter")
    # 2.-4. the table sizes, then the ids and the digests padded to the
    # largest table
    digests = np.array([local[k] for k in keys], dtype=np.int64)
    n_all = _all_gather(np.array([len(keys)])).ravel()
    width = max(int(n_all.max()), 1)

    def pad(a):
        return np.pad(a, (0, width - len(a)))

    ids_all = _all_gather(pad(ids))
    dig_all = _all_gather(pad(digests))
    seen: dict[int, tuple[int, int]] = {}
    for r in range(ids_all.shape[0]):
        for j in range(int(n_all[r])):
            i, d = int(ids_all[r, j]), int(dig_all[r, j])
            if i in seen and seen[i][1] != d:
                label = id_to_key.get(i, f"<remote key id {i}>")
                raise ReplicaDivergenceError(
                    f"{name}: ranks {seen[i][0]} and {r} disagree on "
                    f"{name}{label} (replica divergence); restore from the "
                    f"last good checkpoint")
            seen.setdefault(i, (r, d))
    return len(local)
