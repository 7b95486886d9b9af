"""HiFT vocoder: mel -> 22.05 kHz waveform (counterpart of
``rstnet_tpu/models/hift.py``).

CosyVoice's HiFTGenerator (HiFTNet: neural source filter + ISTFTNet): an F0
predictor (five ELU convs and a linear head, then ``abs``), the harmonic NSF
source, and a HiFi-GAN upsampling stack with Snake resblocks into which the
source enters through its STFT (n_fft 16, hop 4) at each resolution; the
head predicts log-magnitude and phase for ``ops/stft.py::istft``.
Channel-first (``[B, C, T]``) inside; mel in and source out are ``[B, T,
C]`` as in JAX.

The source's phase is ``2 pi (cumsum(f0 h / sr) % 1)`` in float32, as JAX
computes it: over the ~440k samples of 20 s the card's parallel cumsum and
the CPU's sequential one drift apart at large indices, which is kept, not
"fixed" in float64. Its random draws (a phase a harmonic and Gaussian noise
a sample) come from a ``draw(kind, shape)`` function
(:func:`generator_draws` over a CPU ``torch.Generator``, so the card and
the CPU draw the same; the tests pass JAX's draws); ``draw=None`` is the
deterministic variant, all draws zero.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from rstnet_tpu_torch.core import default_generator, new_param
from rstnet_tpu_torch.models.glm4v_flow import Conv, Linear, conv1d, conv_transpose1d
from rstnet_tpu_torch.ops.stft import istft, stft

Draw = Callable[[str, tuple], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class HiFTConfig:
    in_channels: int = 80
    base_channels: int = 512
    nb_harmonics: int = 8
    sampling_rate: int = 22050
    nsf_alpha: float = 0.1          # sine amplitude
    nsf_sigma: float = 0.003        # voiced noise std
    nsf_voiced_threshold: float = 10.0
    upsample_rates: tuple = (8, 8)
    upsample_kernel_sizes: tuple = (16, 16)
    istft_n_fft: int = 16
    istft_hop: int = 4
    resblock_kernel_sizes: tuple = (3, 7, 11)
    resblock_dilations: tuple = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    source_resblock_kernel_sizes: tuple = (7, 11)
    source_resblock_dilations: tuple = ((1, 3, 5), (1, 3, 5))
    lrelu_slope: float = 0.1
    audio_limit: float = 0.99
    f0_cond_channels: int = 512

    @property
    def total_upsample(self) -> int:
        return int(np.prod(self.upsample_rates)) * self.istft_hop


def generator_draws(generator: torch.Generator, device) -> Draw:
    """``draw(kind, shape)`` from a CPU generator, moved to ``device``: kind
    ``"phase"`` is U(-pi, pi), ``"z"`` and ``"noise"`` standard normal."""

    def draw(kind: str, shape: tuple) -> torch.Tensor:
        t = torch.empty(shape)
        if kind == "phase":
            t.uniform_(-math.pi, math.pi, generator=generator)
        else:
            t.normal_(generator=generator)
        return t.to(device)

    return draw


def snake(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Snake activation, ``alpha [C]`` on linear scale; x ``[B, C, T]``."""
    a = alpha[:, None]
    return x + (1.0 / (a + 1e-9)) * torch.sin(x * a).square()


class ResBlock(nn.Module):
    def __init__(self, channels: int, kernel: int, dilations: tuple, *, device=None,
                 generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.kernel, self.dilations = kernel, tuple(dilations)
        self.convs1 = nn.ModuleList(Conv(kernel, channels, channels, **kw) for _ in dilations)
        self.convs2 = nn.ModuleList(Conv(kernel, channels, channels, **kw) for _ in dilations)
        self.alpha1 = nn.ParameterList(new_param(torch.ones(channels, device=device))
                                       for _ in dilations)
        self.alpha2 = nn.ParameterList(new_param(torch.ones(channels, device=device))
                                       for _ in dilations)

    def forward(self, x):
        k = self.kernel
        for c1, c2, a1, a2, d in zip(self.convs1, self.convs2, self.alpha1, self.alpha2,
                                     self.dilations):
            pad = (k - 1) * d // 2
            xt = conv1d(c1, snake(x, a1), padding=(pad, pad), dilation=d)
            xt = conv1d(c2, snake(xt, a2), padding=((k - 1) // 2, (k - 1) // 2))
            x = xt + x
        return x


class F0Predictor(nn.Module):
    def __init__(self, cfg: HiFTConfig, *, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        ch = cfg.f0_cond_channels
        self.convs = nn.ModuleList(Conv(3, cfg.in_channels if i == 0 else ch, ch, **kw)
                                   for i in range(5))
        self.head = Linear(ch, 1, **kw)


class HiFTGenerator(nn.Module):
    """mel ``[B, T, 80]`` -> (wav ``[B, T * total_upsample]``, source ``[B,
    T * total_upsample, 1]``)."""

    def __init__(self, config: HiFTConfig = HiFTConfig(), *, device=None, generator=None):
        super().__init__()
        cfg = self.config = config
        g = default_generator(generator, device)
        kw = dict(device=device, generator=g)
        base, n_bins = cfg.base_channels, cfg.istft_n_fft + 2
        self.f0 = F0Predictor(cfg, **kw)
        self.source_linear = Linear(cfg.nb_harmonics + 1, 1, **kw)
        self.conv_pre = Conv(7, cfg.in_channels, base, **kw)
        self.ups, self.source_downs = nn.ModuleList(), nn.ModuleList()
        self.source_resblocks, self.resblocks = nn.ModuleList(), nn.ModuleList()
        for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
            ch = base // (2 ** (i + 1))
            self.ups.append(Conv(k, base // (2**i), ch, transposed=True, **kw))
            d = self.down_cum[i]
            self.source_downs.append(Conv(1 if d == 1 else d * 2, n_bins, ch, **kw))
            self.source_resblocks.append(ResBlock(ch, cfg.source_resblock_kernel_sizes[i],
                                                  cfg.source_resblock_dilations[i], **kw))
            for kk, dd in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilations):
                self.resblocks.append(ResBlock(ch, kk, dd, **kw))
        self.conv_post = Conv(7, ch, n_bins, **kw)

    @property
    def down_cum(self) -> list:
        rates = self.config.upsample_rates
        return [int(v) for v in np.cumprod([1] + list(rates[::-1][:-1]))[::-1]]

    # -- NSF source --------------------------------------------------------------

    def predict_f0(self, mel: torch.Tensor) -> torch.Tensor:
        """mel ``[B, T, 80]`` -> f0 ``[B, T]``."""
        x = mel.transpose(1, 2)
        for conv in self.f0.convs:
            x = F.elu(conv1d(conv, x))
        return self.f0.head(x.transpose(1, 2)).abs()[..., 0]

    def source(self, f0: torch.Tensor, draw: Optional[Draw] = None) -> torch.Tensor:
        """f0 ``[B, T]`` a mel frame -> the harmonic source ``[B, T *
        total_upsample, 1]`` (SineGen + SourceModuleHnNSF). ``draw=None``
        zeroes the random phases and the noise."""
        cfg = self.config
        B, T = f0.shape
        f0 = f0.repeat_interleave(cfg.total_upsample, dim=-1)  # nearest upsample [B, S]
        h = torch.arange(1, cfg.nb_harmonics + 2, device=f0.device, dtype=torch.float32)
        rad = f0[:, None, :] * h[None, :, None] / cfg.sampling_rate  # [B, H+1, S]
        theta = 2.0 * math.pi * torch.remainder(torch.cumsum(rad, dim=-1), 1.0)
        if draw is not None:
            phase = draw("phase", (B, cfg.nb_harmonics + 1, 1)).clone()
            phase[:, 0] = 0.0
            noise = draw("noise", tuple(theta.shape))
        else:
            phase = torch.zeros(B, cfg.nb_harmonics + 1, 1, device=f0.device)
            noise = torch.zeros_like(theta)
        sine = cfg.nsf_alpha * torch.sin(theta + phase)
        uv = (f0 > cfg.nsf_voiced_threshold).float()[:, None, :]
        noise_amp = uv * cfg.nsf_sigma + (1.0 - uv) * cfg.nsf_alpha / 3.0
        sine = sine * uv + noise_amp * noise
        return torch.tanh(self.source_linear(sine.transpose(1, 2)))

    # -- generator ---------------------------------------------------------------

    def decode(self, mel: torch.Tensor, source: torch.Tensor) -> torch.Tensor:
        """mel ``[B, T, 80]`` + source ``[B, T * total_upsample, 1]`` -> wav
        ``[B, T * total_upsample]``."""
        cfg = self.config
        spec = stft(source[..., 0], cfg.istft_n_fft, cfg.istft_hop, cfg.istft_n_fft)
        s_stft = torch.cat([spec.real, spec.imag], dim=1)  # [B, n_fft + 2, frames]
        x = conv1d(self.conv_pre, mel.transpose(1, 2))
        n_kernels = len(cfg.resblock_kernel_sizes)
        for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
            x = conv_transpose1d(self.ups[i], F.leaky_relu(x, cfg.lrelu_slope), stride=u,
                                 torch_padding=(k - u) // 2)
            if i == len(cfg.upsample_rates) - 1:
                x = F.pad(x, (1, 0), mode="reflect")
            d = self.down_cum[i]
            if d == 1:
                si = conv1d(self.source_downs[i], s_stft, padding="VALID")
            else:
                si = conv1d(self.source_downs[i], s_stft, stride=d, padding=(d // 2, d // 2))
            si = self.source_resblocks[i](si)
            x = x + si[:, :, : x.shape[2]]
            xs = None
            for j in range(n_kernels):
                r = self.resblocks[i * n_kernels + j](x)
                xs = r if xs is None else xs + r
            x = xs / n_kernels
        x = conv1d(self.conv_post, F.leaky_relu(x, 0.01))  # torch's default slope
        n_half = cfg.istft_n_fft // 2 + 1
        magnitude = torch.exp(torch.clamp(x[:, :n_half], max=math.log(1e2)))
        phase = torch.sin(x[:, n_half:])
        spec = torch.complex(magnitude * torch.cos(phase), magnitude * torch.sin(phase))
        wav = istft(spec, cfg.istft_n_fft, cfg.istft_hop, cfg.istft_n_fft)
        return torch.clamp(wav, -cfg.audio_limit, cfg.audio_limit)

    @torch.no_grad()
    def inference(self, mel: torch.Tensor, draw: Optional[Draw] = None,
                  cache_source: Optional[torch.Tensor] = None):
        """mel ``[B, T, 80]`` -> (wav ``[B, T*up]``, source ``[B, T*up, 1]``).
        ``cache_source`` ``[B, S_cache, 1]`` overwrites the head of the new
        source (the streaming decoder's anti-glitch cache)."""
        s = self.source(self.predict_f0(mel), draw)
        if cache_source is not None and cache_source.shape[1] > 0:
            s = s.clone()
            s[:, : cache_source.shape[1]] = cache_source
        return self.decode(mel, s), s
