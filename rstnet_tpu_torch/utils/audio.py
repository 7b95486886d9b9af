"""Minimal wav IO and resampling with no external audio dependencies (a copy
of ``rstnet_tpu/utils/audio.py``).

Data prep and the CLIs only need 16-bit PCM wav read/write and simple
resampling, which the stdlib ``wave`` module plus numpy cover. As in the
JAX package, ``read_wav`` and ``resample_linear`` first try the native C++
loader (``rstnet_tpu_torch/native``) and fall back to those paths where it
cannot be built. ``plot_spectrogram`` draws the hifigan-style log-mel
spectrogram, computed here in numpy.
"""

from __future__ import annotations

import wave

import numpy as np


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """-> (float32 [channels, T] in [-1, 1], sample_rate).

    Uses the native C++ loader (``rstnet_tpu_torch.native``) when available;
    falls back to the stdlib wave module."""
    try:
        from rstnet_tpu_torch import native

        out = native.read_wav(path)
        if out is not None:
            return out
    except Exception:  # noqa: BLE001
        pass
    with wave.open(path, "rb") as f:
        sr = f.getframerate()
        n = f.getnframes()
        ch = f.getnchannels()
        width = f.getsampwidth()
        raw = f.readframes(n)
    if width == 2:
        data = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, np.int32).astype(np.float32) / 2147483648.0
    elif width == 1:
        data = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported sample width {width}")
    return data.reshape(-1, ch).T.copy(), sr


def write_wav(path: str, audio: np.ndarray, sample_rate: int) -> None:
    """audio: float [T] or [channels, T] in [-1, 1] -> 16-bit PCM wav."""
    audio = np.asarray(audio, np.float32)
    if audio.ndim == 1:
        audio = audio[None]
    pcm = np.clip(audio * 32767.0, -32768, 32767).astype(np.int16)
    with wave.open(path, "wb") as f:
        f.setnchannels(pcm.shape[0])
        f.setsampwidth(2)
        f.setframerate(sample_rate)
        f.writeframes(pcm.T.tobytes())


def resample_linear(wav: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Linear-interpolation resampler; wav [channels, T]."""
    if sr_in == sr_out:
        return wav
    try:
        from rstnet_tpu_torch import native

        out = native.resample_linear(wav, sr_in, sr_out)
        if out is not None:
            return out
    except Exception:  # noqa: BLE001
        pass
    n_out = int(round(wav.shape[-1] * sr_out / sr_in))
    x_old = np.linspace(0.0, 1.0, wav.shape[-1], endpoint=False)
    x_new = np.linspace(0.0, 1.0, n_out, endpoint=False)
    return np.stack([np.interp(x_new, x_old, ch) for ch in wav]).astype(np.float32)


def _slaney_mel_filterbank(n_freqs: int, f_min: float, f_max: float, n_mels: int,
                           sample_rate: int) -> np.ndarray:
    """Triangular slaney-normalized filterbank [n_freqs, n_mels] on the
    slaney mel scale (librosa/hifigan)."""

    def hz_to_mel(f):
        f = np.asarray(f, np.float64)
        return np.where(f >= 1000.0,
                        15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) / np.log(6.4) * 27.0,
                        f / (200.0 / 3))

    def mel_to_hz(m):
        return np.where(m >= 15.0, 1000.0 * np.exp(np.log(6.4) / 27.0 * (m - 15.0)),
                        m * (200.0 / 3))

    all_freqs = np.linspace(0, sample_rate // 2, n_freqs)
    f_pts = mel_to_hz(np.linspace(hz_to_mel(f_min), hz_to_mel(f_max), n_mels + 2))
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - all_freqs[:, None]
    fb = np.maximum(0.0, np.minimum(-slopes[:, :-2] / f_diff[:-1], slopes[:, 2:] / f_diff[1:]))
    return (fb * (2.0 / (f_pts[2 : n_mels + 2] - f_pts[:n_mels]))[None, :]).astype(np.float32)


def mel_spectrogram(x: np.ndarray, n_fft: int = 1024, num_mels: int = 80,
                    sampling_rate: int = 24000, hop_size: int = 160, win_size: int = 800,
                    fmin: float = 0.0, fmax: float | None = None) -> np.ndarray:
    """hifigan-style log-mel: [..., T] -> [..., num_mels, frames] (the JAX
    package's ``ops/stft.py::mel_spectrogram``: periodic Hann window
    centred in ``n_fft``, reflect padding, magnitudes clipped at 1e-9)."""
    fmax = fmax if fmax is not None else sampling_rate / 2
    window = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(win_size) / win_size)
    lpad = (n_fft - win_size) // 2
    window = np.pad(window, (lpad, n_fft - win_size - lpad))
    x = np.asarray(x, np.float32)
    x = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(n_fft // 2, n_fft // 2)], mode="reflect")
    n_frames = 1 + (x.shape[-1] - n_fft) // hop_size
    idx = np.arange(n_frames)[:, None] * hop_size + np.arange(n_fft)[None, :]
    spec = np.fft.rfft(x[..., idx] * window.astype(np.float32), n=n_fft, axis=-1)
    mag = np.sqrt(np.clip(spec.real**2 + spec.imag**2, 1e-9, None)).astype(np.float32)
    fb = _slaney_mel_filterbank(n_fft // 2 + 1, fmin, fmax, num_mels, sampling_rate)
    mel = np.einsum("...tf,fm->...mt", mag, fb)
    return np.log(np.clip(mel, 1e-5, None))


def plot_spectrogram(audio: np.ndarray, sr: int = 24000, path: str | None = None):
    """Log-mel spectrogram figure for TensorBoard/debug; saved to ``path``
    (and None returned) when given, else the figure."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    mel = mel_spectrogram(np.asarray(audio)[None], sampling_rate=sr)[0]
    fig, ax = plt.subplots(figsize=(10, 3))
    im = ax.imshow(mel, aspect="auto", origin="lower", interpolation="none")
    fig.colorbar(im, ax=ax)
    ax.set_xlabel("frames")
    ax.set_ylabel("mel bins")
    fig.tight_layout()
    if path:
        fig.savefig(path)
        plt.close(fig)
        return None
    return fig


def pcm16_to_float(data: bytes) -> np.ndarray:
    return np.frombuffer(data, np.int16).astype(np.float32) / 32768.0


def float_to_pcm16(audio: np.ndarray) -> bytes:
    return np.clip(np.asarray(audio) * 32767.0, -32768, 32767).astype(np.int16).tobytes()
