"""Normalization layers (counterpart of ``rstnet_tpu/ops/norms.py``).

The ``*_f32`` kinds compute in float32 and cast back, and keep their scale in
float32 whatever the model dtype. ``stack`` prepends leading axes to every
parameter (a transformer's stacked ``[L, dim]`` layer leaves); ``forward``
then takes the index of the slice to apply.
"""

from __future__ import annotations

import torch
from torch import nn

from rstnet_tpu_torch.core import new_param


def rms_norm(x: torch.Tensor, alpha: torch.Tensor, eps: float, compute_f32: bool) -> torch.Tensor:
    x_dtype = x.dtype
    if compute_f32:
        x = x.float()
    var = eps + x.square().mean(-1, keepdim=True)
    return (x * (alpha.to(var.dtype) * torch.rsqrt(var))).to(x_dtype)


def layer_norm(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float, compute_f32: bool
) -> torch.Tensor:
    x_dtype = x.dtype
    if compute_f32:
        x = x.float()
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + eps)
    y = y * weight.to(y.dtype) + bias.to(y.dtype)
    return y.to(x_dtype)


class Norm(nn.Module):
    """One of {layer_norm, layer_norm_f32, rms_norm, rms_norm_f32, none}."""

    KINDS = ("layer_norm", "layer_norm_f32", "rms_norm", "rms_norm_f32", "none")

    def __init__(self, kind: str, dim: int, *, stack: tuple = (), device=None,
                 dtype=torch.float32):
        super().__init__()
        if kind not in self.KINDS:
            raise ValueError(f"unknown norm {kind!r}")
        self.kind, self.dim = kind, dim
        pdtype = torch.float32 if kind.endswith("_f32") else dtype
        shape = (*stack, dim)
        if kind.startswith("rms_norm"):
            self.alpha = new_param(torch.ones(shape, dtype=pdtype, device=device))
        elif kind != "none":
            self.weight = new_param(torch.ones(shape, dtype=pdtype, device=device))
            self.bias = new_param(torch.zeros(shape, dtype=pdtype, device=device))

    @property
    def eps(self) -> float:
        return 1e-8 if self.kind.endswith("_f32") else 1e-5

    def forward(self, x: torch.Tensor, index: int | None = None) -> torch.Tensor:
        if self.kind == "none":
            return x
        pick = (lambda p: p) if index is None else (lambda p: p[index])
        f32 = self.kind.endswith("_f32")
        if self.kind.startswith("rms_norm"):
            return rms_norm(x, pick(self.alpha), self.eps, f32)
        return layer_norm(x, pick(self.weight), pick(self.bias), self.eps, f32)


class LayerScale(nn.Module):
    """Diagonal residual-branch rescaling [Touvron et al 2021]."""

    def __init__(self, channels: int, init_value: float = 1e-4, *, stack: tuple = (),
                 device=None, dtype=torch.float32):
        super().__init__()
        self.scale = new_param(
            torch.full((*stack, channels), init_value, dtype=dtype, device=device)
        )

    def forward(self, x: torch.Tensor, index: int | None = None) -> torch.Tensor:
        scale = self.scale if index is None else self.scale[index]
        return scale.to(x.dtype) * x
