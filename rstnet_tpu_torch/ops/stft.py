"""STFT, mel filterbanks and spectrograms (counterpart of
``rstnet_tpu/ops/stft.py``).

Framing, windows and filterbanks follow the JAX module; the rFFT and its
inverse are ``torch.fft`` on both devices (the JAX package computes them
outside any Pallas kernel: ``jnp.fft`` on the CPU, a DFT matmul on the TPU).
``stft`` has ``torch.stft`` semantics: a window shorter than ``n_fft`` is
zero-padded to centre it, and ``normalized`` divides by ``sqrt(n_fft)``, not
by the window's energy.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch


def hann_window(win_size: int, device=None) -> torch.Tensor:
    """``torch.hann_window`` (periodic), computed as the JAX module does."""
    n = torch.arange(win_size, device=device, dtype=torch.float32)
    return 0.5 - 0.5 * torch.cos(2.0 * torch.pi * n / win_size)


def _padded_window(fft_size: int, win_size: int, device=None) -> torch.Tensor:
    window = hann_window(win_size, device)
    if win_size < fft_size:
        lpad = (fft_size - win_size) // 2
        window = torch.nn.functional.pad(window, (lpad, fft_size - win_size - lpad))
    return window


def frame_signal(x: torch.Tensor, fft_size: int, hop_size: int, center: bool = True
                 ) -> torch.Tensor:
    """[..., T] -> [..., frames, fft_size] with reflect centre padding."""
    if center:
        x = reflect_pad(x, fft_size // 2)
    return x.unfold(-1, fft_size, hop_size)


def reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Reflect-pad the last axis by ``pad`` on both sides, as ``np.pad``
    does: a pad longer than the signal reflects again."""
    T = x.shape[-1]
    if pad < T:
        flat = torch.nn.functional.pad(x.reshape(-1, 1, T), (pad, pad), mode="reflect")
        return flat.reshape(*x.shape[:-1], T + 2 * pad)
    if T == 1:
        return x.expand(*x.shape[:-1], T + 2 * pad)
    period = 2 * (T - 1)
    idx = torch.arange(-pad, T + pad, device=x.device).remainder(period)
    return x[..., torch.where(idx >= T, period - idx, idx)]


def stft(x: torch.Tensor, fft_size: int, hop_size: int, win_size: int,
         normalized: bool = False, center: bool = True) -> torch.Tensor:
    """[..., T] -> complex [..., freq, frames]."""
    window = _padded_window(fft_size, win_size, x.device)
    frames = frame_signal(x.float(), fft_size, hop_size, center)
    spec = torch.fft.rfft(frames * window, n=fft_size, dim=-1)
    if normalized:
        spec = spec / math.sqrt(fft_size)
    return spec.transpose(-1, -2)


def magnitude(x: torch.Tensor, fft_size: int, hop_size: int, win_size: int,
              normalized: bool = False, eps: float = 1e-7) -> torch.Tensor:
    spec = stft(x, fft_size, hop_size, win_size, normalized)
    return torch.sqrt(torch.clamp(spec.real.square() + spec.imag.square(), min=eps))


def istft(spec: torch.Tensor, fft_size: int, hop_size: int, win_size: int,
          center: bool = True, length: int | None = None) -> torch.Tensor:
    """complex [..., freq, frames] -> [..., T]: overlap-add of windowed
    irFFT frames over the summed squared window, centre padding trimmed."""
    frames = torch.fft.irfft(spec.transpose(-1, -2), n=fft_size, dim=-1)
    window = _padded_window(fft_size, win_size, frames.device)
    frames = frames * window
    n_frames = frames.shape[-2]
    out_len = fft_size + hop_size * (n_frames - 1)
    lead = frames.shape[:-2]
    # overlap-add as a transposed conv: a one-hot kernel scatters each frame
    cols = frames.reshape(-1, n_frames, fft_size).transpose(1, 2)  # [N, n, frames]
    y = torch.nn.functional.fold(cols, (1, out_len), (1, fft_size), stride=(1, hop_size))
    env = torch.nn.functional.fold(
        (window.square()[None, :, None]).expand(1, fft_size, n_frames), (1, out_len),
        (1, fft_size), stride=(1, hop_size))
    y = y.reshape(*lead, out_len)
    env = env.reshape(out_len)
    y = y / torch.where(env > 1e-11, env, torch.ones_like(env))
    if center:
        y = y[..., fft_size // 2: out_len - fft_size // 2]
    if length is not None:
        y = y[..., :length]
    return y


# -- mel filterbanks ----------------------------------------------------------


def _hz_to_mel(f, htk: bool):
    if htk:
        return 2595.0 * np.log10(1.0 + f / 700.0)
    f = np.asarray(f, np.float64)
    mel = f / (200.0 / 3)
    log_region = f >= 1000.0
    return np.where(log_region,
                    15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) / np.log(6.4) * 27.0, mel)


def _mel_to_hz(m, htk: bool):
    if htk:
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    m = np.asarray(m, np.float64)
    f = m * (200.0 / 3)
    log_region = m >= 15.0
    return np.where(log_region, 1000.0 * np.exp(np.log(6.4) / 27.0 * (m - 15.0)), f)


@lru_cache(maxsize=32)
def _mel_filterbank_np(n_freqs: int, f_min: float, f_max: float, n_mels: int,
                       sample_rate: int, htk: bool, slaney_norm: bool) -> np.ndarray:
    all_freqs = np.linspace(0, sample_rate // 2, n_freqs)
    m_pts = np.linspace(_hz_to_mel(f_min, htk), _hz_to_mel(f_max, htk), n_mels + 2)
    f_pts = _mel_to_hz(m_pts, htk)
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    if slaney_norm:
        enorm = 2.0 / (f_pts[2: n_mels + 2] - f_pts[:n_mels])
        fb *= enorm[None, :]
    return fb.astype(np.float32)


def mel_filterbank(n_freqs: int, f_min: float, f_max: float, n_mels: int, sample_rate: int,
                   htk: bool = True, slaney_norm: bool = False, device=None) -> torch.Tensor:
    """Triangular filterbank [n_freqs, n_mels]: htk=True is torchaudio's
    ``create_fb_matrix``, htk=False with slaney_norm librosa's."""
    return _mel_filterbank(n_freqs, float(f_min), float(f_max), n_mels, sample_rate, htk,
                           slaney_norm, torch.device(device or "cpu"))


@lru_cache(maxsize=64)
def _mel_filterbank(n_freqs, f_min, f_max, n_mels, sample_rate, htk, slaney_norm, device):
    """The filterbank on ``device``, copied there once."""
    fb = _mel_filterbank_np(n_freqs, f_min, f_max, n_mels, sample_rate, htk, slaney_norm)
    return torch.from_numpy(fb).to(device)


def mel_spectrogram(x: torch.Tensor, n_fft: int = 1024, num_mels: int = 80,
                    sampling_rate: int = 24000, hop_size: int = 160, win_size: int = 800,
                    fmin: float = 0.0, fmax: float | None = None) -> torch.Tensor:
    """hifigan-style log-mel: [..., T] -> [..., num_mels, frames]."""
    fmax = fmax if fmax is not None else sampling_rate / 2
    mag = magnitude(x, n_fft, hop_size, win_size, normalized=False, eps=1e-9)
    fb = mel_filterbank(n_fft // 2 + 1, fmin, fmax, num_mels, sampling_rate, htk=False,
                        slaney_norm=True, device=x.device)
    mel = torch.einsum("...ft,fm->...mt", mag, fb)
    return torch.log(torch.clamp(mel, min=1e-5))


def spectral_transform(x: torch.Tensor, fft_size: int, hop_size: int, win_size: int,
                       normalized: bool = True, domain: str = "double",
                       mel_scale: bool = False, sample_rate: int = 24000,
                       ref_level_db: float = 20.0, min_level_db: float = -100.0
                       ) -> torch.Tensor:
    """TorchSTFT.transform magnitudes: linear | log | double (magnitude and
    normalized log magnitude stacked on a channel axis)."""
    mag = magnitude(x, fft_size, hop_size, win_size, normalized)
    if mel_scale:
        fb = mel_filterbank(fft_size // 2 + 1, 0.0, sample_rate / 2, 128, sample_rate,
                            htk=True, device=x.device)
        mag = torch.einsum("...ft,fm->...mt", mag, fb)
    if domain == "linear":
        return mag
    log_mag = 20.0 * torch.log10(torch.clamp(mag, min=1e-7)) - ref_level_db
    log_mag = torch.clamp((log_mag - min_level_db) / -min_level_db, 0.0, 1.0)
    if domain == "log":
        return log_mag
    if domain != "double":
        raise ValueError(f"unknown spectral domain {domain!r}")
    return torch.stack([mag, log_mag], dim=-3)
