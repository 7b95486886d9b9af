"""Pipeline parallelism: a GPipe schedule over the ``pipe`` axis
(counterpart of ``rstnet_tpu/parallel/pipeline.py``).

Each stage holds ``n_layer / P`` contiguous blocks (``parallel/sharding.py``).
At step t, stage s runs microbatch ``t - s`` through its blocks and hands
the activation to stage s+1 by send/recv; the last stage's outputs are
summed over the group, so every stage returns the full output (JAX's
``psum``) and computes the loss alike. Bubble fraction ``(P-1)/(M+P-1)``.

Gradients flow through the schedule by autograd: a received activation is
:class:`_Recv`, whose backward sends its gradient back to the stage that
sent it; a sent activation leaves a zero-valued token in the stage's
output, whose backward receives that gradient (:class:`_SendToken`). Every
message is tagged with its microbatch. The input enters through
``copy_to`` over the group: only stage 0 reads it, and its gradient is
summed over the stages, as JAX's transpose of a replicated input is.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import torch
import torch.distributed as dist

from rstnet_tpu_torch.parallel.comm import copy_to, reduce_from
from rstnet_tpu_torch.parallel.mesh import axis_size


def pipe_axis_size(mesh=None) -> int:
    """Size of the ambient (or given) mesh's ``pipe`` axis; 1 if absent."""
    return axis_size("pipe", mesh)


def _peer(group, offset: int) -> int:
    return dist.get_global_rank(group, dist.get_rank(group) + offset)


class _Recv(torch.autograd.Function):
    """An activation from the previous stage; its gradient goes back."""

    @staticmethod
    def forward(ctx, like, group, tag):
        ctx.group, ctx.tag = group, tag
        out = torch.empty_like(like)
        dist.recv(out, _peer(group, -1), group=group, tag=tag)
        return out

    @staticmethod
    def backward(ctx, g):
        dist.send(g.contiguous(), _peer(ctx.group, -1), group=ctx.group, tag=ctx.tag)
        return None, None, None


class _SendToken(torch.autograd.Function):
    """Send an activation to the next stage; the zero scalar returned joins
    the stage's output, and its backward receives the activation's
    gradient from the next stage."""

    @staticmethod
    def forward(ctx, h, group, tag):
        ctx.group, ctx.tag = group, tag
        ctx.shape, ctx.dtype, ctx.device = h.shape, h.dtype, h.device
        dist.send(h.detach().contiguous(), _peer(group, 1), group=group, tag=tag)
        return torch.zeros((), dtype=h.dtype, device=h.device)

    @staticmethod
    def backward(ctx, _):
        g = torch.empty(ctx.shape, dtype=ctx.dtype, device=ctx.device)
        dist.recv(g, _peer(ctx.group, 1), group=ctx.group, tag=ctx.tag)
        return g, None, None


def spmd_pipeline(body: Callable[[torch.Tensor, Any], torch.Tensor], x: torch.Tensor,
                  local_layers: Sequence[Any], *, n_stages: int, n_micro: int,
                  group) -> torch.Tensor:
    """Run ``body(h, layer_input) -> h`` over this stage's ``local_layers``
    as a GPipe pipeline over ``group`` (the ``pipe`` axis, ``n_stages``
    ranks). x: [B, T, D] on every stage (B divisible by ``n_micro``);
    returns [B, T, D] on every stage."""
    B = x.shape[0]
    if B % n_micro:
        raise ValueError(f"batch {B} not divisible by {n_micro} microbatches")
    stage = dist.get_rank(group)
    x_micro = copy_to(x, group).reshape(n_micro, B // n_micro, *x.shape[1:])
    outs, tokens = [None] * n_micro, []
    for t in range(n_micro + n_stages - 1):
        m = t - stage
        if not 0 <= m < n_micro:
            continue
        h = x_micro[m] if stage == 0 else _Recv.apply(x_micro[m], group, m)
        for layer in local_layers:
            h = body(h, layer)
        if stage == n_stages - 1:
            outs[m] = h
        else:
            tokens.append(_SendToken.apply(h, group, m))
    if stage == n_stages - 1:
        mine = torch.stack(outs)
    else:
        mine = torch.zeros_like(x_micro) + torch.stack(tokens).sum()
    return reduce_from(mine, group).reshape(B, *x.shape[1:])
