"""Rotary position embedding (counterpart of ``rstnet_tpu/ops/rope.py``):
the interleaved, offset-aware RoPE of the streaming transformers, and the
litgpt half-split RoPE of the backbone with the Llama-3.1 frequency
adjustment (``build_rope_cache``, ``apply_rope_halved``)."""

from __future__ import annotations

import math

import torch


def apply_rope_interleaved(
    q: torch.Tensor,
    k: torch.Tensor,
    offset: int | torch.Tensor,
    max_period: float = 10_000.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """RoPE over ``[B, H, T, D]`` with (real, imag) pairs interleaved along D;
    the rotation is computed in float32 and cast back. ``offset``: the
    position of the first step, an int or a 0-dim tensor on ``q``'s device
    (a streaming state's), which is read on the device, never on the host."""
    T, D = q.shape[2], q.shape[3]
    if D % 2:
        raise ValueError(f"head dim {D} must be even")
    ds = torch.arange(D // 2, dtype=torch.float32, device=q.device)
    freqs = torch.exp(ds * (-math.log(max_period) * 2 / D))
    ts = (torch.arange(T, device=q.device) + offset).float()
    angles = freqs[None, :] * ts[:, None]  # [T, D//2]
    rotr, roti = torch.cos(angles), torch.sin(angles)

    def rotate(x):
        xs = x.reshape(*x.shape[:3], D // 2, 2)
        xr, xi = xs[..., 0].float(), xs[..., 1].float()
        out_r = xr * rotr - xi * roti
        out_i = xr * roti + xi * rotr
        return torch.stack([out_r.to(x.dtype), out_i.to(x.dtype)], dim=-1).reshape(x.shape)

    return rotate(q), rotate(k)


def build_rope_cache(seq_len: int, n_elem: int, base: float = 10000.0, condense_ratio: int = 1,
                     extra_config: dict | None = None, positions: torch.Tensor | None = None,
                     device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """litgpt (cos, sin) cache ``[T, n_elem]`` in float32, with the optional
    Llama-3.1 frequency adjustment; ``positions`` (float) replaces
    ``arange(seq_len)``."""
    if positions is not None:
        device = positions.device
    theta = 1.0 / (base ** (torch.arange(0, n_elem, 2, dtype=torch.float32, device=device)
                            / n_elem))
    if extra_config is not None:
        orig_context = extra_config["original_max_seq_len"]
        factor = extra_config["factor"]
        low_freq_factor = extra_config["low_freq_factor"]
        high_freq_factor = extra_config["high_freq_factor"]
        wavelen = 2 * math.pi / theta
        ratio = orig_context / wavelen
        smooth = ((ratio - low_freq_factor) / (high_freq_factor - low_freq_factor)).clamp(0.0, 1.0)
        adjusted = (1 - smooth) * theta / factor + smooth * theta
        theta = torch.where(wavelen > orig_context / low_freq_factor, theta / factor, theta)
        theta = torch.where((wavelen <= orig_context / low_freq_factor)
                            & (wavelen >= orig_context / high_freq_factor), adjusted, theta)
    if positions is None:
        positions = torch.arange(seq_len, dtype=torch.float32, device=device)
    idx_theta = torch.outer(positions.float() / condense_ratio, theta)  # [T, n_elem/2]
    idx_theta = torch.cat([idx_theta, idx_theta], dim=-1)
    return torch.cos(idx_theta), torch.sin(idx_theta)


def apply_rope_halved(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """litgpt convention, rotating halves ``[-x2, x1]``: x [B, H, T, D],
    cos/sin [T, D]; computed in float32 and cast back to x's dtype."""
    d = x.shape[-1]
    rotated = torch.cat([-x[..., d // 2:], x[..., : d // 2]], dim=-1)
    return (x.float() * cos + rotated.float() * sin).to(x.dtype)
