"""Learned frame-rate resamplers (counterpart of
``rstnet_tpu/modules/resample.py``): stride-S conv / transposed conv with
kernel 2S, bias-free, optionally channel-wise (grouped). Mimi uses learnt
convs with a channel-wise upsampler, which reproduces upstream's
``upsample_channel_wise_bug`` on purpose. The non-learnt (fixed averaging)
mode runs offline only. The params are the conv's own (``weight``), as in
the JAX pytree, so each resampler *is* its conv.
"""

from __future__ import annotations

import torch

from rstnet_tpu_torch.ops.conv import StreamingConv1d, StreamingConvTranspose1d


def _channels(learnt: bool, dimension: int | None, channel_wise: bool) -> tuple[int, int]:
    if not learnt:
        return 1, 1
    if dimension is None:
        raise ValueError("a learnt resampler needs its dimension")
    return dimension, dimension if channel_wise else 1


class ConvDownsample1d(StreamingConv1d):
    def __init__(self, stride: int, dimension: int | None = None, causal: bool = False,
                 learnt: bool = False, channel_wise: bool = False,
                 *, device=None, dtype=torch.float32, generator=None):
        ch, groups = _channels(learnt, dimension, channel_wise)
        super().__init__(ch, ch, kernel_size=2 * stride, stride=stride, causal=causal,
                         groups=groups, bias=False, pad_mode="replicate",
                         device=device, dtype=dtype, generator=generator)
        self.learnt = learnt
        if not learnt:
            with torch.no_grad():
                self.weight.fill_(1.0 / (2 * stride))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.learnt:
            return super().forward(x)
        B, C, T = x.shape
        return super().forward(x.reshape(B * C, 1, T)).reshape(B, C, -1)

    def init_state(self, batch_size: int, dtype=torch.float32, device=None) -> dict:
        if not self.learnt:
            raise NotImplementedError("streaming resample is implemented for learnt convs")
        return super().init_state(batch_size, dtype, device)


class ConvTrUpsample1d(StreamingConvTranspose1d):
    def __init__(self, stride: int, dimension: int | None = None, causal: bool = False,
                 learnt: bool = False, channel_wise: bool = False,
                 *, device=None, dtype=torch.float32, generator=None):
        ch, groups = _channels(learnt, dimension, channel_wise)
        super().__init__(ch, ch, kernel_size=2 * stride, stride=stride, causal=causal,
                         groups=groups, bias=False, device=device, dtype=dtype,
                         generator=generator)
        self.learnt = learnt
        if not learnt:
            with torch.no_grad():
                self.weight.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.learnt:
            return super().forward(x)
        B, C, T = x.shape
        xf = x.reshape(B * C, 1, T)
        norm = super().forward(torch.ones_like(xf[:1]))
        return (super().forward(xf) / norm).reshape(B, C, -1)

    def init_state(self, batch_size: int, dtype=torch.float32, device=None) -> dict:
        if not self.learnt:
            raise NotImplementedError("streaming resample is implemented for learnt convs")
        return super().init_state(batch_size, dtype, device)
