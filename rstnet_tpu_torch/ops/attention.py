"""Attention core: windowed-causal masked attention + ring KV cache
(counterpart of ``rstnet_tpu/ops/attention.py``).

The ring keeps every written slot valid: ``ring_positions`` gives each slot
its true absolute position, so chunked streaming equals the offline windowed
mask for any length (``ARCHITECTURE.md`` "ring KV"). Unlike the JAX version,
``ring_kv_update`` writes the new steps into the cache in place. The int8 K/V
variant is not ported yet.
"""

from __future__ import annotations

import torch


def ring_positions(capacity: int, end: int, device=None) -> torch.Tensor:
    """Absolute time position of each ring slot; -1 for not-yet-written.
    ``end`` is the number of steps written so far (after the current write)."""
    idx = torch.arange(capacity, dtype=torch.int64, device=device)
    wraps = (end - 1 - idx) // capacity  # largest p <= end-1 with p = idx mod capacity
    pos = idx + wraps * capacity
    return torch.where(idx >= end, -1, pos)


def ring_kv_buffers(shape: tuple, dtype=torch.bfloat16, device=None) -> dict:
    """Ring cache buffers ``[..., capacity, dim_per_head]`` (extra leading
    axes, e.g. a stacked layer axis, are allowed)."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise NotImplementedError(f"ring KV in {dtype}: only float32 and bfloat16")
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


def ring_kv_update(
    cache: dict, end: int, k_new: torch.Tensor, v_new: torch.Tensor
) -> tuple[dict, torch.Tensor, int]:
    """Write T new steps ``[B, H, T, D]`` into the ring at ``(end + t) %
    capacity``, in place. Returns (cache, positions[capacity], new_end)."""
    T = k_new.shape[2]
    capacity = cache["k"].shape[2]
    idx = (torch.arange(T, device=k_new.device) + end) % capacity
    cache["k"].index_copy_(2, idx, k_new.to(cache["k"].dtype))
    cache["v"].index_copy_(2, idx, v_new.to(cache["v"].dtype))
    new_end = end + T
    return cache, ring_positions(capacity, new_end, k_new.device), new_end


def _f32_dot_inputs(a: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``a`` rounded to the matmul input dtype, held in float32: a float32
    product of these is the JAX ``preferred_element_type=float32`` einsum."""
    return a.to(dtype).float()


def masked_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    pos_q: torch.Tensor,
    pos_k: torch.Tensor,
    context: int | None,
    causal: bool = True,
    min_pos: torch.Tensor | None = None,
) -> torch.Tensor:
    """Scaled dot-product attention with a windowed-causal position mask.

    q: [B, H, Tq, D]; k, v: [B, Hkv, S, D]; pos_q: [Tq]; pos_k: [S]. Logits
    and softmax in float32; GQA when Hkv divides H. ``min_pos`` ([B], optional)
    hides keys with ``pos_k < min_pos[b]`` from row b (per-session lookback)."""
    B, H, Tq, D = q.shape
    Hkv = k.shape[1]
    if min_pos is not None and not causal:
        raise ValueError("min_pos requires causal attention")
    if H % Hkv:
        raise ValueError(f"{H} query heads over {Hkv} kv heads")
    qg = q.reshape(B, Hkv, H // Hkv, Tq, D)
    logits = torch.einsum(
        "bhgtd,bhsd->bhgts",
        _f32_dot_inputs(qg, q.dtype), _f32_dot_inputs(k, q.dtype),
    ) * (1.0 / D**0.5)
    if causal:
        delta = pos_q[:, None] - pos_k[None, :]
        mask = (pos_k[None, :] >= 0) & (delta >= 0)
        if context is not None:
            mask = mask & (delta < context)
        if min_pos is not None:
            mask = mask[None] & (pos_k[None, None, :] >= min_pos[:, None, None])
            mask = mask[:, None, None]
        logits = logits.masked_fill(~mask, float("-inf"))
    att = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhgts,bhsd->bhgtd", att, v)
    return out.reshape(B, H, Tq, D)


def multi_linear(weight: torch.Tensor, x: torch.Tensor, offset: int) -> torch.Tensor:
    """Per-time-step linear: weight [S, out, in]; x [B, T, in]; step t uses
    ``weight[offset + t]`` (clipped to the last step, as the JAX gather)."""
    T = x.shape[1]
    steps = (torch.arange(T, device=x.device) + offset).clamp(0, weight.shape[0] - 1)
    return torch.einsum("bti,toi->bto", x, weight[steps].to(x.dtype))
