"""Gated feed-forward (GLU-family) layers (counterpart of
``rstnet_tpu/ops/gating.py``)."""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from rstnet_tpu_torch.core import default_generator, new_param, uniform

# jax.nn.gelu defaults to the tanh approximation; the port keeps it
_ACTIVATIONS: dict[str, Callable] = {
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "relu": F.relu,
    "leaky_relu": F.leaky_relu,
    "elu": F.elu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "silu": F.silu,
    "mish": lambda x: x * torch.tanh(F.softplus(x)),
    "softsign": F.softsign,
    "identity": lambda x: x,
}


def get_activation(name: str) -> Callable:
    return _ACTIVATIONS[name]


def gating_hidden_dim(dim: int, dim_feedforward: int) -> int:
    """Hidden width rule so gated-FFN params ~= dense-FFN params."""
    if dim_feedforward == 4 * dim:
        return (21 * dim) // 8
    return (2 * dim_feedforward) // 3


def gated_ffn(x: torch.Tensor, linear_in: torch.Tensor, linear_out: torch.Tensor,
              activation: str) -> torch.Tensor:
    """``W_out (act(a) * b)`` where ``[a; b] = W_in x``."""
    gate, val = (x @ linear_in.T).chunk(2, dim=-1)
    return (get_activation(activation)(gate) * val) @ linear_out.T


class ActivationGating(nn.Module):
    """y = W_out (act(a) * b) where [a; b] = W_in x. ``stack`` prepends
    leading axes (stacked layers, per-step weights) to both weights."""

    def __init__(self, dim: int, dim_feedforward: int, activation: str = "silu", *,
                 stack: tuple = (), device=None, dtype=torch.float32, generator=None):
        super().__init__()
        self.activation = activation
        self.hidden = gating_hidden_dim(dim, dim_feedforward)
        g = default_generator(generator, device)
        self.linear_in = new_param(uniform(
            (*stack, 2 * self.hidden, dim), 1.0 / math.sqrt(dim), g, device, dtype))
        self.linear_out = new_param(uniform(
            (*stack, dim, self.hidden), 1.0 / math.sqrt(self.hidden), g, device, dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return gated_ffn(x, self.linear_in, self.linear_out, self.activation)
