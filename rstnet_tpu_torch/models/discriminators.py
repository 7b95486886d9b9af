"""GAN discriminators for codec training (counterpart of
``rstnet_tpu/models/discriminators.py``): multi-frequency (MFD, the
default ``d_list`` entry), multi-period (MPD), multi-scale (MSD),
multi-resolution (MRD), collaborative multi-band (CoMBD) and sub-band
(SBD). Each ``forward(y, y_hat)`` returns (real outputs, fake outputs, real
feature maps, fake feature maps), one entry a sub-discriminator.
Parameters are named as the JAX param tree (``discs.0.convs.3.weight``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from rstnet_tpu_torch.core import container, default_generator, uniform
from rstnet_tpu_torch.ops.pqmf import pqmf_analysis
from rstnet_tpu_torch.ops.stft import magnitude, spectral_transform


def leaky_relu(x: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    return F.leaky_relu(x, slope)


def _conv(shape, g, device, dtype) -> nn.Module:
    """``{"weight", "bias"}`` drawn U(-1/sqrt(fan_in), 1/sqrt(fan_in))
    (zeros for a layer without inputs: a stack narrower than 32 channels)."""
    fan_in = math.prod(shape[1:])
    bound = 1.0 / math.sqrt(fan_in) if fan_in else 0.0
    return container(weight=uniform(shape, bound, g, device, dtype),
                     bias=uniform((shape[0],), bound, g, device, dtype))


class _MultiDiscriminator(nn.Module):
    """``discs``: sub-discriminators, each run on y and on y_hat."""

    def _views(self, y, y_hat):
        return [(y, y_hat)] * len(self.discs)

    def forward(self, y: torch.Tensor, y_hat: torch.Tensor):
        real_out, fake_out, real_fm, fake_fm = [], [], [], []
        for disc, (yr, yf) in zip(self.discs, self._views(y, y_hat)):
            ro, rf = disc(yr)
            fo, ff = disc(yf)
            real_out.append(ro)
            fake_out.append(fo)
            real_fm.append(rf)
            fake_fm.append(ff)
        return real_out, fake_out, real_fm, fake_fm


# -- frequency discriminator ----------------------------------------------------


class FrequenceDiscriminator(nn.Module):
    """7-stage 3x3 conv2d stack with reflection padding."""

    def __init__(self, in_channels: int, hidden: int = 512,
                 *, device=None, dtype=torch.float32, generator=None):
        super().__init__()
        h = hidden
        self.layout = ((in_channels, h // 32, 1), (h // 32, h // 16, 2), (h // 16, h // 8, 1),
                       (h // 8, h // 4, 2), (h // 4, h // 2, 1), (h // 2, h, 2), (h, 1, 1))
        g = default_generator(generator, device)
        self.convs = nn.ModuleList(_conv((o, i, 3, 3), g, device, dtype)
                                   for i, o, _ in self.layout)

    def forward(self, x: torch.Tensor):
        fmaps = []
        for idx, (p, (_, _, s)) in enumerate(zip(self.convs, self.layout)):
            if idx > 0:
                x = leaky_relu(x, 0.2)
            x = F.pad(x, (1, 1, 1, 1), mode="reflect")
            x = F.conv2d(x, p.weight, p.bias, stride=(s, s))
            fmaps.append(x)
        return x, fmaps[:-1]


class MultiFrequencyDiscriminator(_MultiDiscriminator):
    def __init__(self, hop_lengths=(32, 64, 128, 256, 512, 1024),
                 hidden_channels=(64, 128, 256, 512, 512, 512), domain: str = "double",
                 mel_scale: bool = True, sample_rate: int = 24000,
                 *, device=None, dtype=torch.float32, generator=None):
        super().__init__()
        self.hop_lengths, self.domain = tuple(hop_lengths), domain
        self.mel_scale, self.sample_rate = mel_scale, sample_rate
        g = default_generator(generator, device)
        in_ch = 2 if domain == "double" else 1
        self.discs = nn.ModuleList(
            FrequenceDiscriminator(in_ch, c, device=device, dtype=dtype, generator=g)
            for c in hidden_channels)

    def _spec(self, x: torch.Tensor, hop: int) -> torch.Tensor:
        s = spectral_transform(x.reshape(-1, x.shape[-1]), fft_size=hop * 4, hop_size=hop,
                               win_size=hop * 4, normalized=True, domain=self.domain,
                               mel_scale=self.mel_scale, sample_rate=self.sample_rate)
        return s if self.domain == "double" else s[:, None]

    def _views(self, y, y_hat):
        return [(self._spec(y, hop), self._spec(y_hat, hop)) for hop in self.hop_lengths]


# -- period discriminator ---------------------------------------------------------


class PeriodDiscriminator(nn.Module):
    def __init__(self, period: int, kernel_size: int = 5, stride: int = 3,
                 *, device=None, dtype=torch.float32, generator=None):
        super().__init__()
        self.period, self.kernel_size = period, kernel_size
        self.layout = ((1, 32, stride), (32, 128, stride), (128, 512, stride),
                       (512, 1024, stride), (1024, 1024, 1))
        g = default_generator(generator, device)
        self.convs = nn.ModuleList(_conv((o, i, kernel_size, 1), g, device, dtype)
                                   for i, o, _ in self.layout)
        self.final = _conv((1, 1024, 3, 1), g, device, dtype)

    def forward(self, x: torch.Tensor):
        B, C, T = x.shape
        pad = (-T) % self.period
        if pad:
            x = F.pad(x, (0, pad), mode="reflect" if T > pad else "constant")
        x = x.reshape(B, C, -1, self.period)
        fmaps = []
        kpad = (self.kernel_size - 1) // 2
        for p, (_, _, s) in zip(self.convs, self.layout):
            x = leaky_relu(F.conv2d(x, p.weight, p.bias, stride=(s, 1), padding=(kpad, 0)), 0.1)
            fmaps.append(x)
        x = F.conv2d(x, self.final.weight, self.final.bias, padding=(1, 0))
        fmaps.append(x)
        return x, fmaps[:-1]


class MultiPeriodDiscriminator(_MultiDiscriminator):
    def __init__(self, period_sizes=(2, 3, 5, 7, 11), period_kernel_size: int = 5,
                 *, device=None, dtype=torch.float32, generator=None):
        super().__init__()
        g = default_generator(generator, device)
        self.discs = nn.ModuleList(
            PeriodDiscriminator(p, period_kernel_size, device=device, dtype=dtype, generator=g)
            for p in period_sizes)


# -- scale discriminator -------------------------------------------------------------


class ScaleDiscriminator(nn.Module):
    # (in, out, kernel, stride, groups, padding)
    LAYOUT = ((1, 128, 15, 1, 1, 7), (128, 128, 41, 2, 4, 20), (128, 256, 41, 2, 16, 20),
              (256, 512, 41, 4, 16, 20), (512, 1024, 41, 4, 16, 20), (1024, 1024, 5, 1, 1, 2))

    def __init__(self, *, device=None, dtype=torch.float32, generator=None):
        super().__init__()
        g = default_generator(generator, device)
        self.convs = nn.ModuleList(_conv((o, i // gr, k), g, device, dtype)
                                   for i, o, k, _, gr, _ in self.LAYOUT)
        self.final = _conv((1, 1024, 3), g, device, dtype)

    def forward(self, x: torch.Tensor):
        fmaps = []
        for p, (_, _, _, s, gr, pd) in zip(self.convs, self.LAYOUT):
            x = leaky_relu(F.conv1d(x, p.weight, p.bias, stride=s, padding=pd, groups=gr), 0.1)
            fmaps.append(x)
        x = F.conv1d(x, self.final.weight, self.final.bias, padding=1)
        fmaps.append(x)
        return x, fmaps[:-1]


class MultiScaleDiscriminator(_MultiDiscriminator):
    def __init__(self, num_scales: int = 3, pool_kernel_size: int = 4, pool_stride: int = 2,
                 *, device=None, dtype=torch.float32, generator=None):
        super().__init__()
        self.pool_kernel_size, self.pool_stride = pool_kernel_size, pool_stride
        g = default_generator(generator, device)
        self.discs = nn.ModuleList(ScaleDiscriminator(device=device, dtype=dtype, generator=g)
                                   for _ in range(num_scales))

    def _pool(self, x: torch.Tensor) -> torch.Tensor:
        pad = int(self.pool_stride / 2 + 0.5)
        return F.avg_pool1d(F.pad(x, (pad, pad)), self.pool_kernel_size, self.pool_stride)

    def _views(self, y, y_hat):
        views = []
        for i in range(len(self.discs)):
            if i > 0:
                y, y_hat = self._pool(y), self._pool(y_hat)
            views.append((y, y_hat))
        return views


# -- resolution discriminator (UnivNet-style MRD) --------------------------------------


class ResolutionDiscriminator(nn.Module):
    SHAPES = ((32, 1, 3, 9), (32, 32, 3, 9), (32, 32, 3, 9), (32, 32, 3, 9), (32, 32, 3, 3))
    STRIDES = ((1, 1), (1, 2), (1, 2), (1, 2), (1, 1))

    def __init__(self, fft_size: int, hop_size: int, win_size: int,
                 *, device=None, dtype=torch.float32, generator=None):
        super().__init__()
        self.fft_size, self.hop_size, self.win_size = fft_size, hop_size, win_size
        g = default_generator(generator, device)
        self.convs = nn.ModuleList(_conv(s, g, device, dtype) for s in self.SHAPES)
        self.final = _conv((1, 32, 3, 3), g, device, dtype)

    def forward(self, x: torch.Tensor):
        spec = magnitude(x.reshape(-1, x.shape[-1]), self.fft_size, self.hop_size,
                         self.win_size)[:, None]  # [B, 1, F, T]
        fmaps = []
        for p, s in zip(self.convs, self.STRIDES):
            kh, kw = p.weight.shape[2], p.weight.shape[3]
            spec = leaky_relu(F.conv2d(spec, p.weight, p.bias, stride=s,
                                       padding=(kh // 2, kw // 2)), 0.2)
            fmaps.append(spec)
        spec = F.conv2d(spec, self.final.weight, self.final.bias, padding=(1, 1))
        fmaps.append(spec)
        return spec, fmaps[:-1]


class MultiResolutionDiscriminator(_MultiDiscriminator):
    def __init__(self, resolutions=((1024, 120, 600), (2048, 240, 1200), (512, 50, 240)),
                 *, device=None, dtype=torch.float32, generator=None):
        super().__init__()
        g = default_generator(generator, device)
        self.discs = nn.ModuleList(ResolutionDiscriminator(*r, device=device, dtype=dtype,
                                                           generator=g) for r in resolutions)


# -- collaborative multi-band + sub-band discriminators (Avocodo-style) ----------


class CoMBDBlock(nn.Module):
    FILTERS = (16, 64, 256, 1024, 1024, 1024)
    KERNELS = (7, 11, 11, 11, 11, 5)
    GROUPS = (1, 4, 16, 64, 256, 1)
    STRIDES = (1, 1, 4, 4, 4, 1)

    def __init__(self, *, device=None, dtype=torch.float32, generator=None):
        super().__init__()
        g = default_generator(generator, device)
        convs, in_ch = [], 1
        for f, k, gr in zip(self.FILTERS, self.KERNELS, self.GROUPS):
            convs.append(_conv((f, in_ch // gr, k), g, device, dtype))
            in_ch = f
        self.convs = nn.ModuleList(convs)
        self.post = _conv((1, self.FILTERS[-1], 3), g, device, dtype)

    def forward(self, x: torch.Tensor):
        fmaps = []
        for p, k, gr, s in zip(self.convs, self.KERNELS, self.GROUPS, self.STRIDES):
            x = leaky_relu(F.conv1d(x, p.weight, p.bias, stride=s, padding=(k - 1) // 2,
                                    groups=gr), 0.1)
            fmaps.append(x)
        x = F.conv1d(x, self.post.weight, self.post.bias, padding=1)
        fmaps.append(x)
        return x, fmaps[:-1]


class MultiCoMBDiscriminator(_MultiDiscriminator):
    """Three CoMBD stacks on the signal and on the first band of its 2-band
    and 4-band PQMF analyses."""

    def __init__(self, *, device=None, dtype=torch.float32, generator=None):
        super().__init__()
        g = default_generator(generator, device)
        self.discs = nn.ModuleList(CoMBDBlock(device=device, dtype=dtype, generator=g)
                                   for _ in range(3))

    def _views(self, y, y_hat):
        return [(y, y_hat),
                (pqmf_analysis(y, 2, 62)[:, :1], pqmf_analysis(y_hat, 2, 62)[:, :1]),
                (pqmf_analysis(y, 4, 62)[:, :1], pqmf_analysis(y_hat, 4, 62)[:, :1])]


class SubBandDiscriminator(nn.Module):
    """Multi-dilated conv stacks over the 4-band PQMF decomposition."""

    CHANNELS, KERNEL, STRIDES, DILATIONS = (64, 128, 256), 5, (1, 2, 2), (1, 2, 4)

    def __init__(self, *, device=None, dtype=torch.float32, generator=None):
        super().__init__()
        g = default_generator(generator, device)
        mdcs, in_ch = [], 4
        for c in self.CHANNELS:
            mdc = nn.Module()
            mdc.branch = nn.ModuleList([_conv((c, in_ch, self.KERNEL), g, device, dtype)])
            mdc.out = _conv((c, c, 3), g, device, dtype)
            mdcs.append(mdc)
            in_ch = c
        self.mdcs = nn.ModuleList(mdcs)
        self.post = _conv((1, self.CHANNELS[-1], 3), g, device, dtype)

    def forward(self, x: torch.Tensor):
        h = pqmf_analysis(x, 4, 62)
        fmaps = []
        for mdc, s, d in zip(self.mdcs, self.STRIDES, self.DILATIONS):
            acc = 0.0
            for b in mdc.branch:
                pad = (self.KERNEL - 1) * d // 2
                acc = acc + F.conv1d(h, b.weight, padding=pad, dilation=d) + b.bias[None, :, None]
            h = F.conv1d(leaky_relu(acc, 0.1), mdc.out.weight, mdc.out.bias, stride=s, padding=1)
            h = leaky_relu(h, 0.1)
            fmaps.append(h)
        h = F.conv1d(h, self.post.weight, self.post.bias, padding=1)
        fmaps.append(h)
        return h, fmaps[:-1]


class MultiSubBandDiscriminator(_MultiDiscriminator):
    def __init__(self, *, device=None, dtype=torch.float32, generator=None):
        super().__init__()
        self.discs = nn.ModuleList([SubBandDiscriminator(device=device, dtype=dtype,
                                                         generator=generator)])


DISCRIMINATORS = {
    "mfd": MultiFrequencyDiscriminator,
    "mpd": MultiPeriodDiscriminator,
    "msd": MultiScaleDiscriminator,
    "mrd": MultiResolutionDiscriminator,
    "combd": MultiCoMBDiscriminator,
    "sbd": MultiSubBandDiscriminator,
}
