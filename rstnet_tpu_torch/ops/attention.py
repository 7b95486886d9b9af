"""Attention core: windowed-causal masked attention + ring KV cache
(counterpart of ``rstnet_tpu/ops/attention.py``).

The ring keeps every written slot valid: ``ring_positions`` gives each slot
its true absolute position, so chunked streaming equals the offline windowed
mask for any length (``ARCHITECTURE.md`` "ring KV"). Unlike the JAX version,
``ring_kv_update`` writes the new steps into the cache in place, and its
``end`` may be a 0-dim device tensor (a streaming state's offset), so a step
reads nothing back to the host and can be captured in a CUDA graph. An int8 ring
(``kv_int8``) holds K/V codes with a bf16 scale per step and head;
``masked_attention`` folds the scales into the logits and the weights.
"""

from __future__ import annotations

import torch


def ring_positions(capacity: int, end: int | torch.Tensor, device=None) -> torch.Tensor:
    """Absolute time position of each ring slot; -1 for not-yet-written.
    ``end`` is the number of steps written so far (after the current write):
    an int or a 0-dim tensor on ``device``."""
    idx = torch.arange(capacity, dtype=torch.int64, device=device)
    wraps = (end - 1 - idx) // capacity  # largest p <= end-1 with p = idx mod capacity
    pos = idx + wraps * capacity
    return torch.where(idx >= end, -1, pos)


def ring_kv_buffers(shape: tuple, dtype=torch.bfloat16, device=None, kv_int8: bool = False
                    ) -> dict:
    """Ring cache buffers ``[..., capacity, dim_per_head]`` (extra leading
    axes, e.g. a stacked layer axis, are allowed). ``kv_int8``: int8 K/V and
    bf16 ``k_scale``/``v_scale`` of shape ``[..., capacity]``."""
    if kv_int8:
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.zeros(shape[:-1], dtype=torch.bfloat16, device=device),
            "v_scale": torch.zeros(shape[:-1], dtype=torch.bfloat16, device=device),
        }
    if dtype not in (torch.float32, torch.bfloat16):
        raise NotImplementedError(f"ring KV in {dtype}: only float32 and bfloat16")
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 over the head dim, per step: [..., T, D] -> (int8
    [..., T, D], bf16 scale [..., T]). The scale is ``max(max |x|, 1e-8) /
    127`` (the weight quantizer divides first), codes use it unrounded."""
    xf = x.float()
    scale = torch.clamp_min(xf.abs().amax(-1), 1e-8) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale.to(torch.bfloat16)


def ring_kv_update(
    cache: dict, end: int | torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor
) -> tuple[dict, torch.Tensor, int | torch.Tensor]:
    """Write T new steps ``[B, H, T, D]`` into the ring at ``(end + t) %
    capacity``, in place (quantized first for an int8 ring). ``end``: an int
    or a 0-dim int64 tensor on the cache's device. Returns (cache,
    positions[capacity], new_end)."""
    T = k_new.shape[2]
    capacity = cache["k"].shape[2]
    idx = (torch.arange(T, device=k_new.device) + end) % capacity
    if "k_scale" in cache:
        k_new, k_sc = quantize_kv(k_new)
        v_new, v_sc = quantize_kv(v_new)
        cache["k_scale"].index_copy_(2, idx, k_sc)
        cache["v_scale"].index_copy_(2, idx, v_sc)
    cache["k"].index_copy_(2, idx, k_new.to(cache["k"].dtype))
    cache["v"].index_copy_(2, idx, v_new.to(cache["v"].dtype))
    new_end = end + T
    return cache, ring_positions(capacity, new_end, k_new.device), new_end


def _f32_dot_inputs(a: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``a`` rounded to the matmul input dtype, held in float32: a float32
    product of these is the JAX ``preferred_element_type=float32`` einsum.
    int8 codes convert exactly to any float dtype, so they go to float32 in
    one copy."""
    return a.float() if a.dtype == torch.int8 else a.to(dtype).float()


def masked_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    pos_q: torch.Tensor,
    pos_k: torch.Tensor,
    context: int | None,
    causal: bool = True,
    min_pos: torch.Tensor | None = None,
    k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """Scaled dot-product attention with a windowed-causal position mask.

    q: [B, H, Tq, D]; k, v: [B, Hkv, S, D]; pos_q: [Tq]; pos_k: [S]. Logits
    and softmax in float32; GQA when Hkv divides H. ``min_pos`` ([B], optional)
    hides keys with ``pos_k < min_pos[b]`` from row b (per-session lookback).
    ``k_scale``/``v_scale`` ([B, Hkv, S]): k/v are int8 codes; as in JAX the
    float32 logits take the float32 ``k_scale``, and the weights, cast to
    ``q.dtype``, take ``v_scale`` in ``q.dtype`` before the value product."""
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
    if k_scale is not None:
        logits = logits * k_scale.float()[:, :, None, None, :]
    if causal:
        delta = pos_q[:, None] - pos_k[None, :]
        mask = (pos_k[None, :] >= 0) & (delta >= 0)
        if context is not None:
            mask = mask & (delta < context)
        if min_pos is not None:
            mask = mask[None] & (pos_k[None, None, :] >= min_pos[:, None, None])
            mask = mask[:, None, None]
        logits = logits.masked_fill(~mask, float("-inf"))
    av_dtype = q.dtype if v_scale is not None else v.dtype
    att = torch.softmax(logits, dim=-1).to(av_dtype)
    if v_scale is not None:
        att = att * v_scale.to(av_dtype)[:, :, None, None, :]
    out = torch.einsum("bhgts,bhsd->bhgtd", att, v.to(av_dtype))
    return out.reshape(B, H, Tq, D)


def prefix_lm_mask(loss_mask: torch.Tensor, prefix_lm: bool = True) -> torch.Tensor:
    """Attention mask from a loss mask (counterpart of the JAX function;
    the reference's ``train_utils.py``): ``loss_mask`` [B, T] bool marks one
    contiguous target segment; the prefix attends bidirectionally (with
    ``prefix_lm``), targets are causal over prefix and targets, and padding
    after the segment is never seen as a key. Padding queries still attend
    causally (the loss mask drops their outputs). Returns [B, T, T] bool."""
    B, T = loss_mask.shape
    axis = torch.arange(T, device=loss_mask.device)
    big = 1 << 30
    start = torch.where(loss_mask, axis[None, :], big).amin(1)
    end = torch.where(loss_mask, axis[None, :], -big).amax(1)
    mask = (axis[:, None] >= axis[None, :])[None].expand(B, T, T)
    if prefix_lm:
        mask = mask | (start[:, None, None] > axis[None, None, :])
    return mask & ~(end[:, None, None] < axis[None, None, :])


def multi_linear(weight: torch.Tensor, x: torch.Tensor, offset: int) -> torch.Tensor:
    """Per-time-step linear: weight [S, out, in]; x [B, T, in]; step t uses
    ``weight[offset + t]`` (clipped to the last step, as the JAX gather)."""
    T = x.shape[1]
    steps = (torch.arange(T, device=x.device) + offset).clamp(0, weight.shape[0] - 1)
    return torch.einsum("bti,toi->bto", x, weight[steps].to(x.dtype))
