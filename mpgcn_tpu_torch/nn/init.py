"""Parameter initializers drawn from an explicit ``torch.Generator``
(counterpart of mpgcn_tpu/nn/init.py, same distribution families).

  * xavier_normal: N(0, gain^2 * 2 / (fan_in + fan_out)), the BDGCN weights.
  * lstm_uniform: U(-1/sqrt(H), 1/sqrt(H)), every LSTM weight and bias.
  * linear_uniform: U(-1/sqrt(fan_in), 1/sqrt(fan_in)), the FC head.

The draws differ from JAX's for the same seed; tests that compare the two
packages carry the JAX weights across (utils/convert.py) instead.
Generators live on the CPU so one seed gives the same weights whatever
device the model is then moved to.
"""

from __future__ import annotations

import math

import torch


def xavier_normal(shape, generator: torch.Generator,
                  gain: float = 1.0) -> torch.Tensor:
    fan_in, fan_out = shape[0], shape[1]
    std = gain * math.sqrt(2.0 / (fan_in + fan_out))
    return std * torch.randn(shape, generator=generator)


def uniform_bound(shape, bound: float,
                  generator: torch.Generator) -> torch.Tensor:
    return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * bound


def lstm_uniform(shape, hidden_dim: int,
                 generator: torch.Generator) -> torch.Tensor:
    return uniform_bound(shape, 1.0 / math.sqrt(hidden_dim), generator)


def linear_uniform(shape, fan_in: int,
                   generator: torch.Generator) -> torch.Tensor:
    return uniform_bound(shape, 1.0 / math.sqrt(fan_in), generator)
