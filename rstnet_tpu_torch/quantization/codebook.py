"""Euclidean codebook with EMA statistics (counterpart of
``rstnet_tpu/quantization/codebook.py``). The codebook is ``embedding_sum /
cluster_usage``, the EMA buffers of training. The nearest-centroid search
is ``ops/cuda_rvq.py::rvq_encode`` (K3 on the card), which runs every level
of a residual quantizer in one call; ``quantize`` is that call at one level.
``stack`` prepends leading axes (a residual quantizer's levels).

The training updates (``ema_update``, ``replace_expired``, ``kmeans_init``)
write the buffers in place, where the JAX functions return new ones; they
take an unstacked codebook. Random choices come from a ``torch.Generator``
(on the CPU; the indices are moved to the samples' device), or are given
as ``indices`` (a JAX key's draws, in the parity tests). The EMA sums are
one-hot products, which add in a fixed order on every device. Under data
parallelism ``ema_update`` sums the batch statistics over the replicas
first (JAX's ``psum`` over ``axis_name``): a process group, or the name of
an axis of the ambient mesh (``parallel/mesh.py``).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from rstnet_tpu_torch.core import new_param
from rstnet_tpu_torch.ops.cuda_rvq import rvq_encode
from rstnet_tpu_torch.parallel.comm import all_reduce_
from rstnet_tpu_torch.parallel.mesh import current_mesh


class EuclideanCodebook(nn.Module):
    def __init__(self, dim: int, codebook_size: int, epsilon: float = 1e-5,
                 decay: float = 0.99, threshold_usage_ratio: float = 0.1,
                 replaced_usage_ratio: float = 1.0,
                 *, stack: tuple = (), device=None, dtype=torch.float32):
        super().__init__()
        self.dim, self.codebook_size, self.epsilon = dim, codebook_size, epsilon
        self.decay, self.threshold_usage_ratio = decay, threshold_usage_ratio
        self.replaced_usage_ratio, self.stack = replaced_usage_ratio, tuple(stack)
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

    def quantize(self, x: torch.Tensor) -> torch.Tensor:
        """Nearest-centroid indices ``[...]`` (int32) for ``x: [..., D]``,
        through :func:`rvq_encode` at one level."""
        self._unstacked("quantize")
        flat = x.reshape(-1, self.dim).float().contiguous()
        codes, _ = rvq_encode(flat, self.embedding().float()[None].contiguous())
        return codes[:, 0].reshape(x.shape[:-1])

    # -- training -----------------------------------------------------------

    def _unstacked(self, what: str) -> None:
        if self.stack:
            raise ValueError(f"{what} takes an unstacked codebook, this one is {self.stack}")

    @torch.no_grad()
    def ema_update(self, x: torch.Tensor, codes: torch.Tensor,
                   axis_name: str | None = None, group=None) -> dict:
        """One EMA step of the buffers from the vectors ``x [N, D]``
        assigned to ``codes [N]``; returns ``{"rvq_entropy": ...}``. With a
        ``group`` (or ``axis_name``, an axis of the ambient mesh) the usage
        and the sums are summed over it first."""
        self._unstacked("ema_update")
        groups = [group] if group is not None else axis_groups(axis_name)
        one_hot = torch.nn.functional.one_hot(codes.long().reshape(-1),
                                              self.codebook_size).float()
        usage = all_reduce_(one_hot.sum(0), groups)
        embed_sum = all_reduce_(one_hot.T @ x.reshape(-1, self.dim).float(), groups)
        d = self.decay
        self.cluster_usage.copy_(self.cluster_usage * d + usage * (1 - d))
        self.embedding_sum.copy_(self.embedding_sum * d + embed_sum * (1 - d))
        return {"rvq_entropy": normalized_entropy(self.cluster_usage, self.codebook_size)}

    @torch.no_grad()
    def replace_expired(self, samples: torch.Tensor, generator: torch.Generator | None = None,
                        indices: torch.Tensor | None = None) -> torch.Tensor:
        """Replace centroids used less than ``threshold_usage_ratio`` of the
        mean by random rows of ``samples [N, D]``; returns the replaced
        fraction. ``indices`` ([codebook_size] rows) replace the draw."""
        self._unstacked("replace_expired")
        usage = self.cluster_usage
        threshold = self.threshold_usage_ratio * usage.sum() / self.codebook_size
        expired = usage < threshold
        new_vectors = samples[sample_indices(samples.shape[0], self.codebook_size, generator,
                                             indices, samples.device)]
        replace_usage = self.replaced_usage_ratio * usage.sum() / self.codebook_size
        self.embedding_sum.copy_(torch.where(expired[:, None], replace_usage * new_vectors,
                                             self.embedding_sum))
        self.cluster_usage.copy_(torch.where(expired, replace_usage, usage))
        return expired.float().mean()

    @torch.no_grad()
    def kmeans_init(self, samples: torch.Tensor, generator: torch.Generator | None = None,
                    num_iters: int = 50, indices: tuple | None = None) -> None:
        """Set the codebook to k-means over ``samples [N, D]``, unless it is
        initialized already. ``indices``: the (means, resample) draws."""
        self._unstacked("kmeans_init")
        if bool(self.initialized > 0):
            return
        means, bins = kmeans(samples, self.codebook_size, generator, num_iters, indices)
        self.embedding_sum.copy_(means * bins[:, None])
        self.cluster_usage.copy_(bins)
        self.initialized.fill_(1.0)


def axis_groups(axis_name: str | None) -> list:
    """The ambient mesh's group of ``axis_name`` (none without a name, a
    mesh, or when the axis is 1)."""
    mesh = current_mesh()
    if axis_name is None or mesh is None or mesh.group(axis_name) is None:
        return []
    return [mesh.group(axis_name)]


def normalized_entropy(usage: torch.Tensor, size: int) -> torch.Tensor:
    proba = usage / usage.sum()
    p_log_p = torch.where(proba == 0, torch.zeros_like(proba), proba * torch.log(proba))
    return -p_log_p.sum() / math.log(float(size))


def sample_indices(n: int, num: int, generator: torch.Generator | None,
                   indices: torch.Tensor | None, device) -> torch.Tensor:
    """``num`` row indices in [0, n): the given ones, or drawn from
    ``generator`` (a CPU generator), on ``device``."""
    if indices is None:
        indices = torch.randint(0, n, (num,), generator=generator)
    return torch.as_tensor(indices).long().to(device)


def kmeans(samples: torch.Tensor, num_clusters: int, generator: torch.Generator | None,
           num_iters: int, indices: tuple | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Lloyd's k-means (JAX's ``_kmeans``): (means [K, D], clipped bins [K]);
    empty clusters take the resample rows."""
    n = samples.shape[0]
    first, second = indices if indices is not None else (None, None)
    means = samples[sample_indices(n, num_clusters, generator, first, samples.device)]
    resample = samples[sample_indices(n, num_clusters, generator, second, samples.device)]
    bins = torch.ones((num_clusters,), dtype=samples.dtype, device=samples.device)
    for _ in range(num_iters):
        d = means.square().sum(-1)[None, :] - 2.0 * samples @ means.T
        buckets = torch.argmin(d, dim=-1)
        one_hot = torch.nn.functional.one_hot(buckets, num_clusters).to(samples.dtype)
        bins = one_hot.sum(0)
        new_means = (one_hot.T @ samples) / torch.clamp(bins, min=1)[:, None]
        means = torch.where((bins == 0)[:, None], resample, new_means)
        bins = torch.clamp(bins, min=1)
    return means, bins
