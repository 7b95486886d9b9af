"""Enhancement losses (counterpart of ``rstnet_tpu/losses/enh.py``):
complex STFT L1, waveform L1 and negative SI-SNR, composed as
BasicEnhancementLoss."""

from __future__ import annotations

import torch

from rstnet_tpu_torch.ops.stft import stft


def freq_mae(est: torch.Tensor, target: torch.Tensor, win: int = 2048, stride: int = 512
             ) -> torch.Tensor:
    """Complex STFT L1 (real and imaginary parts)."""
    e = stft(est.reshape(-1, est.shape[-1]), win, stride, win)
    t = stft(target.reshape(-1, target.shape[-1]), win, stride, win)
    return torch.mean(torch.abs(e.real - t.real)) + torch.mean(torch.abs(e.imag - t.imag))


def wav_mae(est: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(est - target))


def si_snr_loss(est: torch.Tensor, target: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Negative SI-SNR in dB (lower is a better reconstruction)."""
    x = est.reshape(-1, est.shape[-1])
    s = target.reshape(-1, target.shape[-1])
    x = x - x.mean(-1, keepdim=True)
    s = s - s.mean(-1, keepdim=True)
    t = (x * s).sum(-1, keepdim=True) * s / (s.square().sum(-1, keepdim=True) + eps)
    num = torch.linalg.vector_norm(t, dim=-1)
    den = torch.linalg.vector_norm(x - t, dim=-1)
    return -torch.mean(20 * torch.log10(eps + num / (den + eps)))


def enhancement_loss(est: torch.Tensor, target: torch.Tensor, freq_weight: float = 1.0,
                     wav_weight: float = 1.0, sisnr_weight: float = 1.0
                     ) -> tuple[torch.Tensor, dict]:
    f = freq_mae(est, target)
    w = wav_mae(est, target)
    s = si_snr_loss(est, target)
    total = freq_weight * f + wav_weight * w + sisnr_weight * s
    return total, {"enh_freq_mae": f, "enh_wav_mae": w, "enh_sisnr": s}
