"""The autoregressive rollout (counterpart of ModelTrainer._graphs and
_rollout_fn, mpgcn_tpu/train/trainer.py:387-406, 1090-1102): ``rollout``
for inference, ``rollout_train`` differentiable for multi-step
training."""

from __future__ import annotations

import torch


def graphs_for(banks: dict, keys: torch.Tensor, sources) -> list:
    """Per-branch graph inputs: the static (or POI) (K, N, N) stack, or the
    dynamic pair (banks["o"][keys], banks["d"][keys]) gathered by
    day-of-week key -- dense banks or blocked-ELL containers alike, which
    gather their tiles, ids and transposed index by key. Gathered once per
    batch, before the rollout loop."""
    out = []
    for src in sources:
        if src == "dynamic":
            out.append((banks["o"][keys], banks["d"][keys]))
        else:
            out.append(banks[src])
    return out


def _shift_append(model, graphs, x, horizon: int, inference: bool):
    cur, preds = x, []
    for _ in range(horizon):
        p = model(cur, graphs, inference=inference)
        cur = torch.cat([cur[:, 1:], p], dim=1)
        preds.append(p)
    return torch.cat(preds, dim=1)


@torch.no_grad()
def rollout(model, banks: dict, x: torch.Tensor, keys: torch.Tensor,
            horizon: int) -> torch.Tensor:
    """Autoregressive shift-and-append for ``horizon`` steps (reference:
    Model_Trainer.py:159-164): x (B, T, N, N, 1) -> (B, horizon, N, N, 1),
    on the inference kernels."""
    return _shift_append(model, graphs_for(banks, keys, model.sources), x,
                         horizon, True)


def rollout_train(model, graphs, x: torch.Tensor,
                  horizon: int) -> torch.Tensor:
    """The same rollout on the training forwards, under autograd (the JAX
    ``_rollout_fn(..., inference=False)``): each prediction becomes the
    next step's last input frame, and the gradient flows back through it
    (the input projection's matmul, then each layer's dX: ``LSTMLayerFn``
    returns dx_proj, the BDGCN arms dh1). ``graphs`` as ``graphs_for``
    gives them."""
    return _shift_append(model, graphs, x, horizon, False)
