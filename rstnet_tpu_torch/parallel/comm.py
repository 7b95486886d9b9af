"""Collectives the parallel paths share, with their autograd rules.

Every function takes process groups that may be None (an axis of size 1):
then it does nothing. Forward/backward pairs follow Megatron's ``f`` and
``g``:

* :func:`reduce_from` — all-reduce (sum) forward, identity backward: the
  ranks' partial results become the one value every rank then uses alike
  (a row-parallel product, the expert mixture, a loss's global sums).
* :func:`copy_to` — identity forward, all-reduce backward: a value every
  rank holds whole enters a region whose ranks each contribute part of its
  gradient (a column-parallel product, the local experts).
* :func:`gather_dim` — all-gather along a dim forward; the backward sums
  the gradient over the ranks and keeps this rank's chunk.
* :func:`gather_replicated` — the same gather, for compute every rank runs
  alike: the backward keeps this rank's chunk and sums nothing.

:func:`batch_mean` and :func:`batch_norm` are a loss's reductions over the
whole batch when the ambient mesh splits it.

The tensor-parallel serving step (no autograd) takes its row-parallel sums
through :func:`reduce_from`, the gather of its ``[B, 1, V/T]`` logits through
:func:`gather_dim`, and its token embedding through :func:`table_rows`
(:func:`vocab_parallel_embedding`). :class:`CollectiveLog` records the
collectives that run inside it (their op and bytes), so a test or the card's
smoke run can see that a frame gathered no whole weight.

:func:`all_reduce_buckets` works in place without autograd: the bucketed
all-reduce of a step's gradients.
"""

from __future__ import annotations

import math
from typing import Iterable, Optional, Sequence

import torch
import torch.distributed as dist

from rstnet_tpu_torch.parallel.mesh import batch_groups
from rstnet_tpu_torch.parallel.sharding import dense, local, row_split_group

BUCKET_BYTES = 32 << 20


def _groups(groups) -> list:
    if groups is None:
        return []
    if not isinstance(groups, (list, tuple)):
        groups = [groups]
    return [g for g in groups if g is not None]


def all_reduce_(t: torch.Tensor, groups, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In place over each group in turn (a sum over several axes is the
    sum over each)."""
    for g in _groups(groups):
        dist.all_reduce(t, op=op, group=g)
    return t


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        return all_reduce_(x.clone(), groups)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.groups), None


def reduce_from(x: torch.Tensor, groups) -> torch.Tensor:
    return _ReduceFrom.apply(x, groups) if _groups(groups) else x


def copy_to(x: torch.Tensor, groups) -> torch.Tensor:
    return _CopyTo.apply(x, groups) if _groups(groups) else x


class _GatherDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        n, r = dist.get_world_size(group), dist.get_rank(group)
        ctx.dim, ctx.group, ctx.n, ctx.r = dim, group, n, r
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, g):
        g = all_reduce_(g.contiguous().clone(), ctx.group)
        return g.chunk(ctx.n, ctx.dim)[ctx.r].contiguous(), None, None


def gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return x if group is None else _GatherDim.apply(x, dim, group)


class _GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        n, r = dist.get_world_size(group), dist.get_rank(group)
        ctx.dim, ctx.n, ctx.r = dim, n, r
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.n, ctx.dim)[ctx.r].contiguous(), None, None


def gather_replicated(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """All-gather along ``dim`` for compute that every rank then runs alike:
    the gradient is this rank's chunk of the (equal) whole one."""
    return x if group is None else _GatherReplicated.apply(x, dim, group)


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """``torch.mean(x)`` of the whole batch when the ambient mesh splits it
    (x this rank's equal part): the sum over the batch groups by
    :func:`reduce_from`, so every rank holds the global value and its
    gradient is the rank's share."""
    groups = batch_groups()
    if not groups:
        return torch.mean(x)
    n = x.numel() * math.prod(dist.get_world_size(g) for g in groups)
    return reduce_from(x.sum(), groups) / n


def batch_norm(x: torch.Tensor) -> torch.Tensor:
    """``torch.linalg.vector_norm(x)`` of the whole batch, as
    :func:`batch_mean`."""
    groups = batch_groups()
    if not groups:
        return torch.linalg.vector_norm(x)
    return torch.sqrt(reduce_from(torch.sum(x * x), groups))


def batch_rows(n_local: int) -> tuple[int, int]:
    """(rows of the whole batch, this rank's first row) when the ambient
    mesh splits the batch over one group in rank order; ``(n_local, 0)``
    without one. A draw over the whole batch's rows taken alike on every
    rank, sliced here, is the one-process draw."""
    groups = batch_groups()
    if not groups:
        return n_local, 0
    if len(groups) > 1:
        raise ValueError("whole-batch draws split the rows over one batch group")
    return n_local * dist.get_world_size(groups[0]), n_local * dist.get_rank(groups[0])


@torch.no_grad()
def vocab_parallel_embedding(local_table: torch.Tensor, tokens: torch.Tensor, group
                             ) -> torch.Tensor:
    """Rows of a table split by rows over ``group`` (this rank holds rows
    ``[r n, (r + 1) n)``, ``n = local_table.shape[0]``): each rank looks up
    the tokens that fall in its rows, writes zeros for the rest, and the
    ranks' parts are summed. Exactly the whole table's lookup (one part is
    non-zero). ``tokens`` lie in ``[0, n * ranks)``."""
    n = local_table.shape[0]
    idx = tokens - n * dist.get_rank(group)
    inside = (idx >= 0) & (idx < n)
    rows = local_table[idx.clamp(0, n - 1)]
    rows = torch.where(inside[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                             device=rows.device))
    return reduce_from(rows, group)


def table_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]``. A table split by rows over one mesh axis (a
    ``DTensor``) is looked up vocab-parallel outside autograd (the serving
    step), and gathered whole in a training forward (its gradient is this
    rank's chunk)."""
    group = row_split_group(table)
    if group is not None and not torch.is_grad_enabled():
        return vocab_parallel_embedding(local(table), idx, group)
    return dense(table)[idx]


class CollectiveLog:
    """Records every collective that runs inside it, by op and bytes: an
    all-reduce's tensor, an all-gather's gathered output, whatever calls
    it (this module, ``DTensor.full_tensor``, FSDP2). A
    ``TorchDispatchMode``: each op goes through Python while it is on, so
    keep it off timed frames."""

    _NAMESPACES = ("c10d", "_c10d_functional")

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils._pytree import tree_leaves

        log = self

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                name = func.__name__.split(".")[0]
                if func.namespace in log._NAMESPACES and not name.startswith(
                        ("wait", "_wrap")):
                    log.calls.append((name, sum(t.numel() * t.element_size()
                                                for t in tree_leaves(out)
                                                if isinstance(t, torch.Tensor))))
                return out

        self.calls: list[tuple[str, int]] = []
        self._mode = _Mode()

    @property
    def bytes(self) -> int:
        return sum(b for _, b in self.calls)

    def __enter__(self) -> "CollectiveLog":
        self._mode.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        self._mode.__exit__(*exc)


def chunk_of(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's chunk of ``x`` along ``dim`` over ``group``."""
    if group is None:
        return x
    return x.chunk(dist.get_world_size(group), dim)[dist.get_rank(group)]


@torch.no_grad()
def all_reduce_buckets(tensors: Sequence[torch.Tensor], groups,
                       scale: Optional[float] = None) -> None:
    """Sum ``tensors`` in place over ``groups``, packed into flat buckets of
    one dtype and device of at most ``BUCKET_BYTES`` each (a large tensor is
    a bucket of its own), then multiply by ``scale`` if given."""
    if not _groups(groups):
        if scale is not None:
            for t in tensors:
                t.mul_(scale)
        return
    by_kind: dict = {}
    for t in tensors:
        by_kind.setdefault((t.dtype, t.device), []).append(t)
    for kind_ts in by_kind.values():
        for bucket in _buckets(kind_ts, BUCKET_BYTES):
            flat = torch.cat([t.reshape(-1) for t in bucket])
            all_reduce_(flat, groups)
            if scale is not None:
                flat.mul_(scale)
            off = 0
            for t in bucket:
                t.copy_(flat[off:off + t.numel()].view_as(t))
                off += t.numel()


def _buckets(ts: Iterable[torch.Tensor], limit: int) -> list[list[torch.Tensor]]:
    out, cur, size = [], [], 0
    for t in ts:
        nbytes = t.numel() * t.element_size()
        if cur and size + nbytes > limit:
            out.append(cur)
            cur, size = [], 0
        cur.append(t)
        size += nbytes
    if cur:
        out.append(cur)
    return out

