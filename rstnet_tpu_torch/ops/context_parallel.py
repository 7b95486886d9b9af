"""Sequence/context-parallel windowed attention over ``torch.distributed``
(counterpart of ``rstnet_tpu/ops/context_parallel.py``).

Activations are split over the mesh's ``seq`` axis ([B, T, D] -> T/n a
rank), and since a query at global position p only attends to keys in
``(p - context, p]``, each rank needs at most ``ceil((context-1)/T_local)``
K/V blocks from its left. They arrive around a ring: each round every rank
sends its last-received block to the right and receives one from the left
(``batch_isend_irecv``), so after j rounds rank i holds the block of rank
i - j; a block that wrapped around the ring gets position -1 and is masked.
The backward sends dK/dV back along the reversed ring (:class:`_RingShift`),
as JAX's ``ppermute`` transposes.

The JAX package computes this attention as a plain einsum (no Pallas
kernel), and so does the port: float32 logits and softmax, the optional
softcap, and the ``context`` and per-layer ``window`` masks.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist

from rstnet_tpu_torch.parallel.mesh import axis_size


def _num_neighbor_blocks(t_local: int, context: Optional[int], n: int) -> int:
    """K/V blocks to fetch from the left: enough to cover ``context-1`` past
    positions (all ``n-1`` for unwindowed causal attention)."""
    if context is None:
        return n - 1
    return min(n - 1, max(0, math.ceil((context - 1) / t_local)))


def shift(x: torch.Tensor, group, step: int) -> torch.Tensor:
    """Send ``x`` to the rank ``step`` to the right on ``group``'s ring and
    return what arrives from the left."""
    n, i = dist.get_world_size(group), dist.get_rank(group)
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, dist.get_global_rank(group, (i + step) % n), group),
           dist.P2POp(dist.irecv, out, dist.get_global_rank(group, (i - step) % n), group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return out


class _RingShift(torch.autograd.Function):
    """One ring round: forward to the right, gradient back to the left."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return shift(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        return shift(g, ctx.group, -1), None


def ring_shift(x: torch.Tensor, group) -> torch.Tensor:
    return _RingShift.apply(x, group)


def context_parallel_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                               context: Optional[int], scale: Optional[float] = None,
                               softcap: Optional[float] = None, window: int = 0,
                               group=None) -> torch.Tensor:
    """Windowed-causal attention over a sequence split on ``group`` (the
    ``seq`` axis), this rank's chunk [B, H, T_local, D] of q/k/v in, its
    chunk of the output out. GQA heads must be repeated first. ``window``
    is a per-layer sliding window (0 = none) on top of ``context``.
    Differentiable; without a group it is the dense attention."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    n = dist.get_world_size(group) if group is not None else 1
    i = dist.get_rank(group) if group is not None else 0
    B, H, Tl, D = q.shape
    ar = torch.arange(Tl, device=q.device)
    pos_q = i * Tl + ar
    nb = _num_neighbor_blocks(Tl, context, n)
    k_blocks, v_blocks, pos_blocks = [k], [v], [pos_q]
    kj, vj = k, v
    for j in range(1, nb + 1):
        kj, vj = ring_shift(kj, group), ring_shift(vj, group)
        base = i - j
        pos_blocks.append(base * Tl + ar if base >= 0 else torch.full_like(ar, -1))
        k_blocks.append(kj)
        v_blocks.append(vj)
    # oldest block first, own block last
    ks = torch.cat(k_blocks[::-1], dim=2)
    vs = torch.cat(v_blocks[::-1], dim=2)
    pos_k = torch.cat(pos_blocks[::-1])
    logits = torch.einsum("bhtd,bhsd->bhts", q.float(), ks.float()) * scale
    if softcap is not None:
        logits = torch.tanh(logits / softcap) * softcap
    delta = pos_q[:, None] - pos_k[None, :]
    mask = (pos_k[None, :] >= 0) & (delta >= 0)
    if context is not None:
        mask = mask & (delta < context)
    if window > 0:
        mask = mask & (delta < window)
    att = torch.softmax(logits.masked_fill(~mask, float("-inf")), dim=-1)
    return torch.einsum("bhts,bhsd->bhtd", att.to(vs.dtype), vs)


def seq_axis_size(mesh=None) -> int:
    """Size of the ambient (or given) mesh's ``seq`` axis; 1 if absent."""
    return axis_size("seq", mesh)
