"""Inference rollout (counterpart of ModelTrainer._graphs and
_rollout_fn, mpgcn_tpu/train/trainer.py:387-406, 1090-1102)."""

from __future__ import annotations

import torch


def graphs_for(banks: dict, keys: torch.Tensor, sources) -> list:
    """Per-branch graph inputs: the static (or POI) (K, N, N) stack, or the
    dynamic pair (banks["o"][keys], banks["d"][keys]) gathered by
    day-of-week key. Gathered once per batch, before the rollout loop."""
    out = []
    for src in sources:
        if src == "dynamic":
            out.append((banks["o"][keys], banks["d"][keys]))
        else:
            out.append(banks[src])
    return out


@torch.no_grad()
def rollout(model, banks: dict, x: torch.Tensor, keys: torch.Tensor,
            horizon: int) -> torch.Tensor:
    """Autoregressive shift-and-append for ``horizon`` steps (reference:
    Model_Trainer.py:159-164): x (B, T, N, N, 1) -> (B, horizon, N, N, 1)."""
    graphs = graphs_for(banks, keys, model.sources)
    cur, preds = x, []
    for _ in range(horizon):
        p = model(cur, graphs, inference=True)
        cur = torch.cat([cur[:, 1:], p], dim=1)
        preds.append(p)
    return torch.cat(preds, dim=1)
