"""Rotary position embedding, offset-aware for streaming (counterpart of
``rstnet_tpu/ops/rope.py::apply_rope_interleaved``)."""

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
    the rotation is computed in float32 and cast back."""
    T, D = q.shape[2], q.shape[3]
    if D % 2:
        raise ValueError(f"head dim {D} must be even")
    ds = torch.arange(D // 2, dtype=torch.float32, device=q.device)
    freqs = torch.exp(ds * (-math.log(max_period) * 2 / D))
    ts = torch.as_tensor(offset, device=q.device).float() + torch.arange(
        T, dtype=torch.float32, device=q.device
    )
    angles = freqs[None, :] * ts[:, None]  # [T, D//2]
    rotr, roti = torch.cos(angles), torch.sin(angles)

    def rotate(x):
        xs = x.reshape(*x.shape[:3], D // 2, 2)
        xr, xi = xs[..., 0].float(), xs[..., 1].float()
        out_r = xr * rotr - xi * roti
        out_i = xr * roti + xi * rotr
        return torch.stack([out_r.to(x.dtype), out_i.to(x.dtype)], dim=-1).reshape(x.shape)

    return rotate(q), rotate(k)
