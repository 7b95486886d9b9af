"""Euclidean codebook, inference side (counterpart of
``rstnet_tpu/quantization/codebook.py``: ``embedding``, ``decode``). The
codebook is ``embedding_sum / cluster_usage``, the EMA buffers of training;
the EMA, k-means and dead-code updates are not ported yet. The
nearest-centroid search (``quantize`` there) is ``ops/cuda_rvq.py::
rvq_encode``, which runs every level of a residual quantizer in one call.
``stack`` prepends leading axes (a residual quantizer's levels).
"""

from __future__ import annotations

import torch
from torch import nn

from rstnet_tpu_torch.core import new_param


class EuclideanCodebook(nn.Module):
    def __init__(self, dim: int, codebook_size: int, epsilon: float = 1e-5,
                 *, stack: tuple = (), device=None, dtype=torch.float32):
        super().__init__()
        self.dim, self.codebook_size, self.epsilon = dim, codebook_size, epsilon
        self.embedding_sum = new_param(
            torch.zeros((*stack, codebook_size, dim), dtype=dtype, device=device))
        self.cluster_usage = new_param(
            torch.ones((*stack, codebook_size), dtype=dtype, device=device))
        self.initialized = new_param(torch.zeros(stack, dtype=torch.float32, device=device))

    def embedding(self) -> torch.Tensor:
        """``[*stack, K, D]`` centroids."""
        usage = self.cluster_usage.clamp_min(self.epsilon)
        return self.embedding_sum / usage[..., None]

    @staticmethod
    def decode(emb: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
        return emb[codes.long()]
