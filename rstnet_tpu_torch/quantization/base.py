"""Quantizer base interface (counterpart of
``rstnet_tpu/quantization/base.py``): the result record and the
pass-through ``DummyQuantizer``, whose "codes" are the float latents with a
codebook axis of 1 (for training and debugging a codec without
quantization)."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn


@dataclasses.dataclass
class QuantizedResult:
    x: torch.Tensor  # quantized latent [B, C, T]
    codes: torch.Tensor  # [B, K, T]
    bandwidth: torch.Tensor  # kbit/s, averaged over the batch
    penalty: Optional[torch.Tensor] = None
    metrics: dict = dataclasses.field(default_factory=dict)


class DummyQuantizer(nn.Module):
    """Identity quantizer; it holds no parameters."""

    def __init__(self, dimension: int = 128, frame_rate: float = 12.5):
        super().__init__()
        self.dimension, self.frame_rate = dimension, frame_rate

    def forward(self, x: torch.Tensor) -> QuantizedResult:
        q = x[:, None]  # [B, 1, C, T] "codes"
        # float32 latents at frame_rate
        bw = torch.tensor(q.shape[2] * 32 * self.frame_rate / 1000.0, dtype=torch.float32)
        return QuantizedResult(x, q, bw, penalty=torch.zeros((), dtype=x.dtype, device=x.device))

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        return x[:, None]

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        return codes[:, 0]

    @property
    def total_codebooks(self) -> int:
        return 1

    @property
    def num_codebooks(self) -> int:
        return 1

    @property
    def cardinality(self) -> int:
        return 1
