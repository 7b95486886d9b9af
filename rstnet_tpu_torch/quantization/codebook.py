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
        self._centroids_state, self._centroids = None, {}  # embedding()'s results, by levels

    def embedding(self, levels: int | None = None) -> torch.Tensor:
        """``[*stack, K, D]`` centroids, or only the first ``levels`` of a
        stacked codebook. Each call divides only what it returns (IEEE
        division is exact per element, so the result equals the same slice
        of the full division) and the result is kept across calls until
        ``embedding_sum`` or ``cluster_usage`` changes: in place (their
        ``_version``), replaced, moved or reloaded (their storage)."""
        state = (self.embedding_sum._version, self.cluster_usage._version,
                 self.embedding_sum.data_ptr(), self.cluster_usage.data_ptr(),
                 self.embedding_sum.device, self.embedding_sum.dtype, self.epsilon)
        if self._centroids_state != state:
            self._centroids_state, self._centroids = state, {}
        if levels not in self._centroids:
            emb_sum, usage = self.embedding_sum, self.cluster_usage
            if levels is not None:
                emb_sum, usage = emb_sum[:levels], usage[:levels]
            self._centroids[levels] = emb_sum / usage.clamp_min(self.epsilon)[..., None]
        return self._centroids[levels]

    @staticmethod
    def decode(emb: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
        return emb[codes.long()]
