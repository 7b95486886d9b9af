"""Residual VQ and the split (semantic/acoustic) quantizer, inference side
(counterpart of ``rstnet_tpu/quantization/rvq.py``).

``encode`` runs the whole level sweep through one :func:`rvq_encode` call
(the CUDA kernel K3 on the card) in place of the JAX per-level scan; the math
is the same. Codebooks are stacked ``[n_q, bins, dim]``.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from rstnet_tpu_torch.core import default_generator, new_param, uniform
from rstnet_tpu_torch.ops.cuda_rvq import rvq_encode
from rstnet_tpu_torch.quantization.codebook import EuclideanCodebook


class ResidualVectorQuantizer(nn.Module):
    def __init__(self, dimension: int = 128, input_dimension: int | None = None,
                 output_dimension: int | None = None, n_q: int = 8, bins: int = 1024,
                 force_projection: bool = False,
                 *, device=None, dtype=torch.float32, generator=None):
        super().__init__()
        self.dimension, self.n_q, self.bins = dimension, n_q, bins
        self.in_dim = input_dimension or dimension
        self.out_dim = output_dimension or dimension
        g = default_generator(generator, device)
        self.layers = EuclideanCodebook(dimension, bins, stack=(n_q,), device=device, dtype=dtype)
        if self.in_dim != dimension or force_projection:
            self.input_proj = new_param(uniform(
                (dimension, self.in_dim), 1.0 / math.sqrt(self.in_dim), g, device, dtype))
        if self.out_dim != dimension or force_projection:
            self.output_proj = new_param(uniform(
                (self.out_dim, dimension), 1.0 / math.sqrt(dimension), g, device, dtype))

    def _project_in(self, x: torch.Tensor) -> torch.Tensor:
        x = x.transpose(1, 2)  # [B, C, T] -> [B, T, C]
        if "input_proj" in self._parameters:
            x = x @ self.input_proj.T
        return x

    def _project_out(self, q: torch.Tensor) -> torch.Tensor:
        if "output_proj" in self._parameters:
            q = q @ self.output_proj.T
        return q.transpose(1, 2)

    def encode(self, x: torch.Tensor, n_q: int | None = None) -> torch.Tensor:
        """[B, C, T] -> codes [B, K, T] (int32)."""
        h = self._project_in(x)
        B, T, D = h.shape
        codebooks = self.layers.embedding()[: n_q or self.n_q]
        codes, _ = rvq_encode(h.reshape(B * T, D).contiguous(), codebooks)
        return codes.reshape(B, T, -1).transpose(1, 2)

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        """codes [B, K, T] -> [B, C, T]; the levels are summed in order."""
        emb = self.layers.embedding()
        B, _, T = codes.shape
        q = torch.zeros((B, T, self.dimension), dtype=emb.dtype, device=emb.device)
        for k in range(codes.shape[1]):
            q = q + EuclideanCodebook.decode(emb[k], codes[:, k])
        return self._project_out(q)


class SplitResidualVectorQuantizer(nn.Module):
    """1 semantic + (n_q - 1) acoustic RVQ over the same input."""

    def __init__(self, dimension: int = 256, input_dimension: int | None = None,
                 output_dimension: int | None = None, n_q: int = 8, n_q_semantic: int = 1,
                 bins: int = 2048, *, device=None, dtype=torch.float32, generator=None):
        super().__init__()
        if n_q <= n_q_semantic:
            raise ValueError("n_q must exceed n_q_semantic")
        self.n_q, self.n_q_semantic, self.bins = n_q, n_q_semantic, bins
        g = default_generator(generator, device)
        kw = dict(dimension=dimension, input_dimension=input_dimension,
                  output_dimension=output_dimension, bins=bins, force_projection=True,
                  device=device, dtype=dtype, generator=g)
        self.rvq_first = ResidualVectorQuantizer(n_q=n_q_semantic, **kw)
        self.rvq_rest = ResidualVectorQuantizer(n_q=n_q - n_q_semantic, **kw)

    def encode(self, x: torch.Tensor, n_q: int | None = None) -> torch.Tensor:
        n_q = n_q or self.n_q
        codes = self.rvq_first.encode(x)
        if n_q > self.n_q_semantic:
            codes = torch.cat([codes, self.rvq_rest.encode(x, n_q - self.n_q_semantic)], dim=1)
        return codes

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        quantized = self.rvq_first.decode(codes[:, : self.n_q_semantic])
        if codes.shape[1] > self.n_q_semantic:
            quantized = quantized + self.rvq_rest.decode(codes[:, self.n_q_semantic :])
        return quantized
