"""Per-stream weighted cross entropy with masks and accuracies (counterpart
of ``rstnet_tpu/losses/ce.py``).

For each stream k: tokens equal to ``ignore_ids[k]`` add no loss, the CE is
weighted by the loss mask, the stream loss is
``sum(masked_ce) / count(mask != 0) * weight``, and two accuracies are
reported, over all unmasked tokens and over tokens whose mask is exactly 1.

The CE is float32 ``logsumexp(logits) - logits[target]``, never full
log-probs. JAX fuses the float32 conversion into its reductions; eager
PyTorch would write a float32 copy of the logits (``[B, T, 128256]`` at a
Llama-3 vocab), so :class:`_TargetNLL` takes the logits in their own dtype
and converts one chunk of rows at a time, forward and backward.
"""

from __future__ import annotations

import torch

from rstnet_tpu_torch.parallel.comm import all_reduce_, reduce_from

CHUNK_ELEMENTS = 1 << 26  # float32 elements of one chunk of rows (256 MiB)


class _TargetNLL(torch.autograd.Function):
    """logits [N, V] (any float dtype), target [N] -> float32
    ``logsumexp(logits) - logits[target]`` [N]; its gradient is
    ``(softmax - onehot) * g``, cast to the logits' dtype."""

    @staticmethod
    def forward(ctx, logits, target):
        N, V = logits.shape
        rows = max(1, CHUNK_ELEMENTS // V)
        nll = torch.empty(N, dtype=torch.float32, device=logits.device)
        lse = torch.empty_like(nll)
        for s in range(0, N, rows):
            chunk = logits[s:s + rows].float()
            lse[s:s + rows] = torch.logsumexp(chunk, dim=-1)
            nll[s:s + rows] = lse[s:s + rows] - chunk.gather(1, target[s:s + rows, None])[:, 0]
        ctx.save_for_backward(logits, target, lse)
        return nll

    @staticmethod
    def backward(ctx, g):
        logits, target, lse = ctx.saved_tensors
        N, V = logits.shape
        rows = max(1, CHUNK_ELEMENTS // V)
        grad = torch.empty_like(logits)
        for s in range(0, N, rows):
            p = torch.exp(logits[s:s + rows].float() - lse[s:s + rows, None])
            p.scatter_add_(1, target[s:s + rows, None],
                           torch.full_like(p[:, :1], -1.0))
            grad[s:s + rows] = (p * g[s:s + rows, None]).to(logits.dtype)
        return grad, None


def cross_entropy_and_accuracy(logits: torch.Tensor, targets: torch.Tensor, masks: torch.Tensor,
                               loss_weights: tuple[float, ...], ignore_ids: tuple[int, ...],
                               groups=None) -> tuple[torch.Tensor, dict]:
    """logits [B, T, K, V]; targets and masks [B, K, T] (stream-major, as the
    collated grids). Returns (scalar loss, metrics). ``groups``: the process
    groups that split the batch (``parallel/mesh.py::batch_groups``); every
    sum and count is then summed over them, so each rank computes the loss
    of the whole batch (a mean of the ranks' means would weigh their tokens
    wrongly whenever their masks differ), and its gradient is the rank's
    share of the whole one."""
    B, T, K, V = logits.shape
    if tuple(targets.shape) != (B, K, T) or tuple(masks.shape) != (B, K, T):
        raise ValueError(f"targets {tuple(targets.shape)} and masks {tuple(masks.shape)} "
                         f"must be {(B, K, T)}")
    dev = logits.device
    lw = torch.tensor(loss_weights, dtype=torch.float32, device=dev)
    ign = torch.tensor(ignore_ids, dtype=targets.dtype, device=dev)
    tgt = targets.permute(0, 2, 1)  # [B, T, K]
    msk = masks.permute(0, 2, 1).float()
    nll = _TargetNLL.apply(logits.reshape(-1, V), tgt.clamp(0, V - 1).reshape(-1).long())
    nll = torch.where(tgt == ign, 0.0, nll.reshape(B, T, K)) * msk

    seen, target = (msk != 0).float(), (msk == 1).float()
    correct = (logits.argmax(-1) == tgt).float()
    num_tokens, num_target = seen.sum((0, 1)), target.sum((0, 1))  # [K]
    nll_sum = nll.sum((0, 1))
    hits_all, hits_target = (correct * seen).sum(), (correct * target).sum()
    if groups:
        nll_sum = reduce_from(nll_sum, groups)
        num_tokens, num_target, hits_all, hits_target = all_reduce_(
            torch.stack([*num_tokens, *num_target, hits_all, hits_target]), groups
        ).split([K, K, 1, 1])
        hits_all, hits_target = hits_all[0], hits_target[0]
    loss = (nll_sum / num_tokens.clamp_min(1.0) * lw).sum()
    metrics = {
        "acc_all": hits_all / num_tokens.sum().clamp_min(1.0),
        "acc_target": hits_target / num_target.sum().clamp_min(1.0),
        "loss": loss,
    }
    return loss, metrics
