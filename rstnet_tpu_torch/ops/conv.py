"""Streaming 1-D convolutions with fixed-shape carries (counterpart of
``rstnet_tpu/ops/conv.py``).

Offline: causal (or asymmetric) padding + one convolution. Streaming: for a
causal conv with effective kernel ``K_eff`` and stride ``S`` the carry is the
trailing ``K_eff - S`` input samples, and a zero carry *is* the causal left
padding for ``pad_mode='constant'``. Chunk lengths must be multiples of the
stride. Layouts are PyTorch's: activations ``[B, C, T]``, conv weight
``[out, in/groups, K]``, transposed conv weight ``[in, out/groups, K]``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from rstnet_tpu_torch.core import default_generator, new_param, uniform


def pad1d(x: torch.Tensor, paddings: tuple[int, int], mode: str = "constant") -> torch.Tensor:
    """Pad the last axis; reflect padding works on inputs shorter than the pad."""
    pad_left, pad_right = paddings
    if mode == "reflect":
        length = x.shape[-1]
        max_pad = max(pad_left, pad_right)
        extra = 0
        if length <= max_pad:
            extra = max_pad - length + 1
            x = F.pad(x, (0, extra))
        padded = F.pad(x, (pad_left, pad_right), mode="reflect")
        return padded[..., : padded.shape[-1] - extra]
    if mode == "replicate":
        return F.pad(x, (pad_left, pad_right), mode="replicate")
    return F.pad(x, (pad_left, pad_right))


def unpad1d(x: torch.Tensor, paddings: tuple[int, int]) -> torch.Tensor:
    pad_left, pad_right = paddings
    return x[..., pad_left : x.shape[-1] - pad_right]


class _ConvBase(nn.Module):
    """Holds ``weight`` (or the weight-norm pair ``weight_g``/``weight_v``)
    and an optional ``bias``, initialised like torch's conv defaults."""

    def _init_params(self, weight_shape, fan_in, out_channels, bias, norm, device,
                     dtype, generator):
        if norm not in ("none", "weight_norm"):
            raise ValueError(f"unknown conv norm {norm!r}")
        g = default_generator(generator, device)
        bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
        w = uniform(weight_shape, bound, g, device, dtype)
        if norm == "weight_norm":
            self.weight_g = new_param(w.square().sum((1, 2), keepdim=True).sqrt())
            self.weight_v = new_param(w)
        else:
            self.weight = new_param(w)
        self.bias = new_param(uniform((out_channels,), bound, g, device, dtype)) if bias else None

    def resolved_weight(self) -> torch.Tensor:
        """``weight``, or ``g * v / ||v||`` (norm over all dims but 0)."""
        if "weight_v" not in self._parameters:
            return self.weight
        v = self.weight_v.float()
        w = self.weight_g.float() * v / v.square().sum((1, 2), keepdim=True).sqrt()
        return w.to(self.weight_v.dtype)


class StreamingConv1d(_ConvBase):
    """Causal/same-padded conv with a fixed-shape streaming carry."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, dilation: int = 1, groups: int = 1, bias: bool = True,
                 causal: bool = False, norm: str = "none", pad_mode: str = "constant",
                 *, device=None, dtype=torch.float32, generator=None):
        super().__init__()
        self.in_channels, self.out_channels = in_channels, out_channels
        self.kernel_size, self.stride, self.dilation = kernel_size, stride, dilation
        self.groups, self.causal, self.pad_mode = groups, causal, pad_mode
        if stride > self.effective_kernel_size:
            raise ValueError("stride must be <= kernel")
        if pad_mode not in ("constant", "reflect", "replicate"):
            raise ValueError(f"unknown pad mode {pad_mode!r}")
        self._init_params(
            (out_channels, in_channels // groups, kernel_size),
            in_channels // groups * kernel_size, out_channels, bias, norm, device,
            dtype, generator,
        )

    @property
    def effective_kernel_size(self) -> int:
        return (self.kernel_size - 1) * self.dilation + 1

    @property
    def padding_total(self) -> int:
        return self.effective_kernel_size - self.stride

    def _conv(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv1d(x, self.resolved_weight(), self.bias, stride=self.stride,
                        dilation=self.dilation, groups=self.groups)

    def _extra_padding(self, length: int) -> int:
        """End padding so the last window is full."""
        k, s, pt = self.effective_kernel_size, self.stride, self.padding_total
        n_frames = (length - k + pt) / s + 1
        return (math.ceil(n_frames) - 1) * s + (k - pt) - length

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Offline forward, ``[B, C, T] -> [B, C', T']``."""
        extra = self._extra_padding(x.shape[-1])
        pt = self.padding_total
        if self.causal:
            x = pad1d(x, (pt, extra), self.pad_mode)
        else:
            x = pad1d(x, (pt - pt // 2, pt // 2 + extra), self.pad_mode)
        return self._conv(x)

    def init_state(self, batch_size: int, dtype=torch.float32, device=None) -> dict:
        if not self.causal:
            raise ValueError("streaming is only supported for causal convs")
        state = {"buf": torch.zeros((batch_size, self.in_channels, self.padding_total),
                                    dtype=dtype, device=device)}
        if self.pad_mode != "constant":
            state["first"] = torch.ones((batch_size,), dtype=torch.bool, device=device)
        return state

    def step(self, state: dict, x: torch.Tensor) -> tuple[torch.Tensor, dict]:
        """One streaming chunk ``[B, C, T]`` with ``T % stride == 0``."""
        T = x.shape[-1]
        if T % self.stride or T < self.stride:
            raise ValueError(f"chunk length {T} must be a positive multiple of stride {self.stride}")
        pt = self.padding_total
        buf = state["buf"]
        if self.pad_mode != "constant" and pt > 0:
            # first chunk: the causal left pad reflects/replicates chunk content
            if self.pad_mode == "reflect":
                if T <= pt:
                    raise ValueError("reflect streaming needs chunk length > padding_total")
                pad = x[..., 1 : pt + 1].flip(-1)
            else:
                pad = x[..., :1].expand(*x.shape[:-1], pt)
            buf = torch.where(state["first"][:, None, None], pad, buf)
        full = torch.cat([buf, x], dim=-1)
        in_len = (T // self.stride - 1) * self.stride + self.effective_kernel_size
        y = self._conv(full[..., :in_len])
        new_state = {"buf": full[..., T:]}
        if self.pad_mode != "constant":
            new_state["first"] = torch.zeros_like(state["first"])
        return y, new_state


class StreamingConvTranspose1d(_ConvBase):
    """Transposed conv with causal trimming and a fixed-shape carry of the
    partial output that the next chunk still adds to."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, groups: int = 1, bias: bool = True, causal: bool = False,
                 norm: str = "none", trim_right_ratio: float = 1.0,
                 *, device=None, dtype=torch.float32, generator=None):
        super().__init__()
        if stride > kernel_size:
            raise ValueError("stride must be <= kernel")
        if not causal and trim_right_ratio != 1.0:
            raise ValueError("trim_right_ratio needs a causal conv")
        self.in_channels, self.out_channels = in_channels, out_channels
        self.kernel_size, self.stride, self.groups = kernel_size, stride, groups
        self.causal, self.trim_right_ratio = causal, trim_right_ratio
        out_per_group = out_channels // groups
        self._init_params(
            (in_channels, out_per_group, kernel_size), out_per_group * kernel_size,
            out_channels, bias, norm, device, dtype, generator,
        )

    @property
    def padding_total(self) -> int:
        return self.kernel_size - self.stride

    def _convtr(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose1d(x, self.resolved_weight(), self.bias,
                                  stride=self.stride, groups=self.groups)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self._convtr(x)
        pt = self.padding_total
        pad_right = math.ceil(pt * self.trim_right_ratio) if self.causal else pt // 2
        return unpad1d(y, (pt - pad_right, pad_right))

    def init_state(self, batch_size: int, dtype=torch.float32, device=None) -> dict:
        if not self.causal:
            raise ValueError("streaming is only supported for causal convs")
        return {"partial": torch.zeros((batch_size, self.out_channels, self.padding_total),
                                       dtype=dtype, device=device)}

    def step(self, state: dict, x: torch.Tensor) -> tuple[torch.Tensor, dict]:
        """One streaming chunk: ``[B, C, T] -> [B, C', T*stride]``."""
        T = x.shape[-1]
        y = self._convtr(x)
        pt = self.padding_total
        if pt == 0:
            return y, state
        y[..., :pt] += state["partial"]
        partial = y[..., self.stride * T :]
        if self.bias is not None:
            partial = partial - self.bias[None, :, None]
        return y[..., : self.stride * T], {"partial": partial}
