"""JAX checkpoint <-> the port's ``state_dict`` (the role of
mpgcn_tpu/utils/convert.py for the reference torch layout).

The JAX params pytree (numpy leaves)::

    {"branches": [{"temporal": {"layers": [{w_ih, w_hh, b_ih, b_hh}]},
                   "spatial": [{"W", "b"}], "fc": {"w", "b"}}]}

maps one to one onto ``MPGCN``'s parameters, except the FC head: JAX
stores ``fc.w`` as (H, input_dim), ``nn.Linear`` as (input_dim, H).

A JAX checkpoint is a pickle of a dict (mpgcn_tpu/train/checkpoint.py)
whose optimizer state and manifest can name classes from optax or the JAX
package. ``load_jax_checkpoint`` unpickles with a restricted
``Unpickler``: numpy arrays and scalars load (dicts, lists and tuples need
no class), every other class becomes an inert stub, so no JAX code is
imported or run. Only ``params`` is returned, and a stub inside it (a
quantized tree, say) raises.
"""

from __future__ import annotations

import pickle

import numpy as np
import torch

from mpgcn_tpu_torch.config import DEFAULT_LINEUPS

_ALLOWED = {
    ("numpy", "ndarray"), ("numpy", "dtype"),
    ("numpy.core.multiarray", "_reconstruct"),
    ("numpy._core.multiarray", "_reconstruct"),
    ("numpy.core.multiarray", "scalar"),
    ("numpy._core.multiarray", "scalar"),
}


class _Stub:
    """Stand-in for a class the restricted unpickler will not import."""

    origin = "?"

    def __init__(self, *args, **kwargs):
        self.args = args

    def __setstate__(self, state):
        self.state = state


class _RestrictedUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) in _ALLOWED:
            return super().find_class(module, name)
        return type(f"Stub[{module}.{name}]", (_Stub,),
                    {"origin": f"{module}.{name}"})


def _stub_paths(tree, path="params"):
    if isinstance(tree, _Stub):
        yield f"{path} ({tree.origin})"
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _stub_paths(v, f"{path}.{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _stub_paths(v, f"{path}[{i}]")


def read_checkpoint(path: str) -> dict:
    """The payload dict of a JAX-format pickle checkpoint, unpickled with
    the restricted unpickler; a ``params`` tree holding anything but
    numpy leaves raises."""
    with open(path, "rb") as f:
        try:
            payload = _RestrictedUnpickler(f).load()
        except (pickle.UnpicklingError, EOFError) as e:
            raise ValueError(f"checkpoint {path} is corrupt: "
                             f"{type(e).__name__}: {e}") from e
    if not isinstance(payload, dict) or "params" not in payload:
        raise ValueError(f"{path} is not a model checkpoint (no 'params')")
    stubs = list(_stub_paths(payload["params"]))
    if stubs:
        raise ValueError(f"checkpoint {path} params hold objects this port "
                         f"cannot load (e.g. a quantized tree): "
                         f"{stubs[:4]}")
    return payload


def check_branch_spec(payload: dict, path: str, num_branches=None,
                      branch_sources=None) -> None:
    """Reject a checkpoint whose recorded branch spec differs from the
    live model's (mpgcn_tpu/train/checkpoint.py ``check_branch_spec``):
    a checkpoint that records M but no lineup was trained with M's
    default lineup. None skips a comparison."""
    extra = payload.get("extra")
    extra = extra if isinstance(extra, dict) else {}
    saved_m = extra.get("num_branches")
    if num_branches is not None and saved_m not in (None, num_branches):
        raise ValueError(f"checkpoint {path} was trained with "
                         f"num_branches={saved_m}, this model has "
                         f"{num_branches}")
    saved_srcs = extra.get("branch_sources")
    if saved_srcs is None and saved_m is not None:
        saved_srcs = DEFAULT_LINEUPS.get(saved_m)
    if (branch_sources is not None and saved_srcs is not None
            and tuple(saved_srcs) != tuple(branch_sources)):
        raise ValueError(f"checkpoint {path} was trained with "
                         f"branch_sources={tuple(saved_srcs)}, this model "
                         f"has {tuple(branch_sources)}")


def load_jax_checkpoint(path: str, num_branches: int | None = None,
                        branch_sources=None) -> dict:
    """The ``params`` tree of a JAX pickle checkpoint, numpy leaves, after
    ``check_branch_spec`` against num_branches/branch_sources."""
    payload = read_checkpoint(path)
    check_branch_spec(payload, path, num_branches, branch_sources)
    return payload["params"]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def params_from_jax(tree: dict) -> dict:
    """JAX params pytree -> ``MPGCN.state_dict()`` (CPU float32 tensors)."""
    sd = {}
    for m, br in enumerate(tree["branches"]):
        pre = f"branches.{m}"
        for n, layer in enumerate(br["temporal"]["layers"]):
            for k in ("w_ih", "w_hh", "b_ih", "b_hh"):
                sd[f"{pre}.temporal.layers.{n}.{k}"] = _t(layer[k])
        for n, layer in enumerate(br["spatial"]):
            sd[f"{pre}.spatial.{n}.W"] = _t(layer["W"])
            if "b" in layer:
                sd[f"{pre}.spatial.{n}.b"] = _t(layer["b"])
        sd[f"{pre}.fc.weight"] = _t(np.asarray(br["fc"]["w"]).T)
        sd[f"{pre}.fc.bias"] = _t(br["fc"]["b"])
    return sd


def params_to_jax(state_dict: dict) -> dict:
    """``MPGCN.state_dict()`` -> the JAX params pytree with numpy float32
    leaves (the inverse of ``params_from_jax``)."""
    sd = {k: v.detach().cpu().numpy().astype(np.float32)
          for k, v in state_dict.items()}
    branches = []
    m = 0
    while f"branches.{m}.fc.weight" in sd:
        pre = f"branches.{m}"
        layers, n = [], 0
        while f"{pre}.temporal.layers.{n}.w_ih" in sd:
            layers.append({k: sd[f"{pre}.temporal.layers.{n}.{k}"]
                           for k in ("w_ih", "w_hh", "b_ih", "b_hh")})
            n += 1
        spatial, n = [], 0
        while f"{pre}.spatial.{n}.W" in sd:
            layer = {"W": sd[f"{pre}.spatial.{n}.W"]}
            if f"{pre}.spatial.{n}.b" in sd:
                layer["b"] = sd[f"{pre}.spatial.{n}.b"]
            spatial.append(layer)
            n += 1
        branches.append({
            "temporal": {"layers": layers}, "spatial": spatial,
            "fc": {"w": np.ascontiguousarray(sd[f"{pre}.fc.weight"].T),
                   "b": sd[f"{pre}.fc.bias"]}})
        m += 1
    return {"branches": branches}
