"""The temporal encoder: a stacked LSTM with zero initial state
(counterpart of mpgcn_tpu/nn/lstm.py).

Weights per layer in torch layout, gate order i, f, g, o:
  w_ih (4H, F)   w_hh (4H, H)   b_ih (4H,)   b_hh (4H,)
``cuda_lstm.lstm_last_step_fused`` runs the stack, one layer at a time
through K-LSTM or its plain version.
"""

from __future__ import annotations

import torch
from torch import nn

from mpgcn_tpu_torch.nn.init import lstm_uniform


class LSTMLayer(nn.Module):
    def __init__(self, input_dim: int, hidden_dim: int,
                 generator: torch.Generator):
        super().__init__()
        H = hidden_dim
        self.w_ih = nn.Parameter(lstm_uniform((4 * H, input_dim), H,
                                              generator))
        self.w_hh = nn.Parameter(lstm_uniform((4 * H, H), H, generator))
        self.b_ih = nn.Parameter(lstm_uniform((4 * H,), H, generator))
        self.b_hh = nn.Parameter(lstm_uniform((4 * H,), H, generator))


class LSTM(nn.Module):
    def __init__(self, input_dim: int, hidden_dim: int, num_layers: int,
                 generator: torch.Generator):
        super().__init__()
        self.layers = nn.ModuleList(
            LSTMLayer(input_dim if i == 0 else hidden_dim, hidden_dim,
                      generator)
            for i in range(num_layers))

