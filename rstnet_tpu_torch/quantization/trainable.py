"""Trainable residual VQ with EMA codebooks, the codec trainer's quantizer
(counterpart of ``rstnet_tpu/quantization/trainable.py``).

Shared input and output projections to a small codebook space; per level,
the nearest codeword, a commitment term, a straight-through estimate, and
EMA statistics with dead-code replacement. The projections are parameters;
the EMA statistics (``embed_avg``, ``cluster_size``) are buffers, updated in
place by a training forward (JAX returns them as new buffers).

The nearest-codeword sweep over all levels is one
:func:`~rstnet_tpu_torch.ops.cuda_rvq.rvq_encode` call (K3 on the card; on
a CPU tensor its plain version, whose formula, ``||e||^2 - 2 r.e`` with the
first index on ties, is JAX's). Each level's residual is then rebuilt from
the codes by the same float32 subtraction of gathered codewords, so it is
bit-equal to the residual K3 searched, and the commitment term, the
straight-through sum (whose gradient is ``num_quantizers`` x identity into
the latent), the EMA counts and sums (one-hot products: a fixed order on
every device) and the dead-code replacement are built from those residuals.

Random draws (the dead-code rows) come from a CPU ``torch.Generator``, or
are given as ``dead_indices`` (a JAX key's draws, in the parity tests).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from rstnet_tpu_torch.core import default_generator, new_param, normal, uniform
from rstnet_tpu_torch.ops.cuda_rvq import rvq_encode
from rstnet_tpu_torch.parallel.comm import all_reduce_, batch_mean, gather_dim
from rstnet_tpu_torch.parallel.mesh import batch_groups
from rstnet_tpu_torch.quantization.codebook import axis_groups, sample_indices


class TrainableResidualVQ(nn.Module):
    def __init__(self, dim: int, codebook_dim: int, codebook_size: int, num_quantizers: int,
                 decay: float = 0.9, epsilon: float = 1e-5, commitment_weight: float = 1.0,
                 threshold_ema_dead_code: float = 2.0,
                 *, device=None, dtype=torch.float32, generator=None):
        super().__init__()
        self.dim, self.codebook_dim, self.codebook_size = dim, codebook_dim, codebook_size
        self.num_quantizers, self.decay, self.epsilon = num_quantizers, decay, epsilon
        self.commitment_weight = commitment_weight
        self.threshold_ema_dead_code = threshold_ema_dead_code
        g = default_generator(generator, device)
        if codebook_dim != dim:
            self.project_in = new_param(uniform((codebook_dim, dim), 1.0 / math.sqrt(dim), g,
                                                device, dtype))
            self.project_out = new_param(uniform((dim, codebook_dim),
                                                 1.0 / math.sqrt(codebook_dim), g, device, dtype))
        self.register_buffer("embed_avg", normal((num_quantizers, codebook_size, codebook_dim),
                                                 g, device, dtype))
        self.register_buffer("cluster_size", torch.ones((num_quantizers, codebook_size),
                                                        dtype=dtype, device=device))

    def embed(self) -> torch.Tensor:
        """The centroids ``[Q, K, D]``."""
        usage = torch.clamp(self.cluster_size, min=self.epsilon)
        return self.embed_avg / usage[..., None]

    def _project_in(self, x):
        return x @ self.project_in.T if "project_in" in self._parameters else x

    def _project_out(self, q):
        return q @ self.project_out.T if "project_out" in self._parameters else q

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                update: bool = True, dead_indices: Optional[torch.Tensor] = None,
                axis_name: Optional[str] = None
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """x: [B, T, dim] -> (quantized [B, T, dim] with straight-through
        gradients, codes [B, T, Q] int32, commitment loss). ``update``
        writes the EMA buffers; with a ``generator`` (or ``dead_indices``,
        [Q, K] rows) it also replaces dead codes. The EMA statistics are
        summed over ``axis_name`` (an axis of the ambient mesh), or without
        one over the ambient mesh's batch axes: the whole batch's, as the
        one-process update sees them."""
        groups = axis_groups(axis_name) if axis_name is not None else batch_groups()
        B, T, _ = x.shape
        h = self._project_in(x)
        embeds = self.embed()
        flat = h.detach().reshape(-1, self.codebook_dim).float().contiguous()
        codes, _ = rvq_encode(flat, embeds.float().contiguous())
        residual = h
        total = torch.zeros_like(h)
        commit = 0.0
        inputs = []  # each level's residual, the rows it searched
        for q in range(self.num_quantizers):
            quant = embeds[q][codes[:, q].long()].reshape(B, T, self.codebook_dim)
            commit = commit + batch_mean(torch.square(residual - quant))
            total = total + (residual + (quant - residual).detach())
            inputs.append(residual.detach().reshape(-1, self.codebook_dim).float())
            residual = residual - quant
        if update:
            self._ema_update(codes, inputs, generator, dead_indices, groups)
        out = self._project_out(total)
        return out, codes.reshape(B, T, self.num_quantizers), commit / self.num_quantizers

    @torch.no_grad()
    def _ema_update(self, codes, inputs, generator, dead_indices, groups=()) -> None:
        """The EMA step; under ``groups`` (one batch group: the rows split
        in rank order) the counts and sums are all-reduced, the dead-code
        rows are drawn over every rank's rows alike and gathered."""
        if len(groups) > 1:
            raise ValueError("the codebook EMA splits its rows over one batch group")
        group = groups[0] if groups else None
        n_ranks = dist.get_world_size(group) if group is not None else 1
        d = self.decay
        sizes, avgs = [], []
        for q, r_flat in enumerate(inputs):
            one_hot = F.one_hot(codes[:, q].long(), self.codebook_size).float()
            counts = all_reduce_(one_hot.sum(0), groups)
            sums = all_reduce_(one_hot.T @ r_flat, groups)
            size = self.cluster_size[q] * d + counts * (1 - d)
            avg = self.embed_avg[q] * d + sums.to(self.embed_avg.dtype) * (1 - d)
            if generator is not None or dead_indices is not None:
                # a dead code takes a random vector of this level's residual
                # inputs: deeper levels see residuals of much smaller norm
                th = self.threshold_ema_dead_code
                dead = size < th
                rows = sample_indices(r_flat.shape[0] * n_ranks, self.codebook_size, generator,
                                      None if dead_indices is None else dead_indices[q],
                                      r_flat.device)
                picked = gather_dim(r_flat, 0, group)[rows]
                avg = torch.where(dead[:, None], picked.to(avg.dtype) * th, avg)
                size = torch.where(dead, torch.full_like(size, th), size)
            sizes.append(size)
            avgs.append(avg)
        self.cluster_size.copy_(torch.stack(sizes))
        self.embed_avg.copy_(torch.stack(avgs))

    @torch.no_grad()
    def encode(self, x: torch.Tensor) -> torch.Tensor:
        return self.forward(x, update=False)[1]

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        """codes [B, T, Q'] (the first Q' levels) -> [B, T, dim]."""
        embeds = self.embed()
        total = 0.0
        for q in range(codes.shape[-1]):
            total = total + embeds[q][codes[..., q].long()]
        return self._project_out(total)


class TrainableSplitRVQ(nn.Module):
    """1 semantic + (n_q - 1) acoustic trainable RVQ over the same input,
    with the cosine-similarity semantic distillation loss."""

    def __init__(self, input_dimension: int = 512, dimension: int = 64, bins: int = 2048,
                 n_q: int = 8, n_q_semantic: int = 1, decay: float = 0.9,
                 *, device=None, dtype=torch.float32, generator=None):
        super().__init__()
        self.n_q, self.n_q_semantic = n_q, n_q_semantic
        g = default_generator(generator, device)
        kw = dict(decay=decay, device=device, dtype=dtype, generator=g)
        self.rvq_first = TrainableResidualVQ(input_dimension, dimension, bins, n_q_semantic, **kw)
        self.rvq_rest = TrainableResidualVQ(input_dimension, dimension, bins, n_q - n_q_semantic,
                                            **kw)

    @staticmethod
    def cosine_similarity_loss(feature: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        """-log sigmoid of the cosine similarity over the time axis."""
        n = min(feature.shape[1], target.shape[1])
        a, b = feature[:, :n].float(), target[:, :n].float()
        num = (a * b).sum(1)
        den = torch.linalg.vector_norm(a, dim=1) * torch.linalg.vector_norm(b, dim=1) + 1e-8
        return -batch_mean(F.logsigmoid(num / den))

    def forward(self, x: torch.Tensor, semantic_features: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None, update: bool = True,
                dead_indices: Optional[dict] = None, axis_name: Optional[str] = None):
        """x: [B, T, C] -> (quantized, codes [B, T, n_q], commitment loss,
        distillation loss). ``dead_indices``: {"rvq_first": [Q, K],
        "rvq_rest": [Q, K]} rows, in place of the generator's draws."""
        dead = dead_indices or {}
        q_sem, c_sem, commit_sem = self.rvq_first(x, generator, update, dead.get("rvq_first"),
                                                  axis_name)
        sim_loss = (self.cosine_similarity_loss(q_sem, semantic_features)
                    if semantic_features is not None else torch.zeros((), device=x.device))
        q_ac, c_ac, commit_ac = self.rvq_rest(x, generator, update, dead.get("rvq_rest"),
                                              axis_name)
        n_sem, n_ac = self.n_q_semantic, self.n_q - self.n_q_semantic
        commit = (commit_sem * n_sem + commit_ac * n_ac) / self.n_q
        return q_sem + q_ac, torch.cat([c_sem, c_ac], dim=-1), commit, sim_loss

    @torch.no_grad()
    def encode(self, x: torch.Tensor) -> torch.Tensor:
        return self.forward(x, update=False)[1]

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        q = self.rvq_first.decode(codes[..., : self.n_q_semantic])
        if codes.shape[-1] > self.n_q_semantic:
            q = q + self.rvq_rest.decode(codes[..., self.n_q_semantic:])
        return q
