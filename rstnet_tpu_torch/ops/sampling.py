"""Token sampling: temperature, top-k, top-p, audio-vocab clamping
(counterpart of ``rstnet_tpu/ops/sampling.py::sample_token``).

Top-k takes the first k entries of a stable descending sort: values
descending and, among equal values, the lower index first, the order of
``jax.lax.top_k`` (and of ``approx_max_k``, exact on the CPU). Top-p sorts
the probabilities the same way, the order of ``jnp.argsort(-probs)``. The
Gumbel choice indexes into the kept list, so its order matters as well as
its set. Categorical draws use the Gumbel-max trick on noise from the
caller's ``torch.Generator``; the numbers differ from ``jax.random``'s, so
parity tests hold sampled tokens in greedy mode.
"""

from __future__ import annotations

import torch


def _categorical(logits: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
    return torch.argmax(logits + gumbel, dim=-1)


def sort_descending(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) along the last axis, descending, the lower index
    first among ties (``jnp.argsort(-x)``'s order)."""
    return torch.sort(x, dim=-1, descending=True, stable=True)


def select_top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest entries along the last axis in ``jax.lax.top_k``'s
    order: values descending, the lower index first among ties."""
    values, idx = sort_descending(x)
    return values[..., :k], idx[..., :k]


def sample_token(
    logits: torch.Tensor,
    generator: torch.Generator | None,
    use_sampling: bool = True,
    temp: float = 1.0,
    top_k: int = 0,
    top_p: float = 0.0,
    max_card: int | None = None,
) -> torch.Tensor:
    """logits [*, Card] -> tokens [*] (int64). ``max_card`` bans ids >=
    max_card. Greedy (``use_sampling=False`` or ``temp <= 0``) needs no
    generator; argmax ties go to the first index, as in JAX."""
    logits = logits.float()
    if max_card is not None:
        valid = torch.arange(logits.shape[-1], device=logits.device) < max_card
        logits = logits.masked_fill(~valid, float("-inf"))
    if not use_sampling or temp <= 0.0:
        return torch.argmax(logits, dim=-1)
    if top_p > 0.0:
        probs = torch.softmax(logits / temp, dim=-1)
        sorted_probs, sort_idx = sort_descending(probs)
        keep = sorted_probs.cumsum(-1) - sorted_probs <= top_p
        masked = torch.where(keep, sorted_probs, torch.zeros((), device=logits.device))
        choice = _categorical(torch.log(masked.clamp_min(1e-30)), generator)
        return sort_idx.gather(-1, choice[..., None])[..., 0]
    if top_k > 0:
        top_logits, top_idx = select_top_k(logits, min(top_k, logits.shape[-1]))
        choice = _categorical(top_logits / temp, generator)
        return top_idx.gather(-1, choice[..., None])[..., 0]
    return _categorical(logits / temp, generator)
