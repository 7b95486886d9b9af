"""Codec quality metrics (counterpart of ``rstnet_tpu/evalsuite/metrics.py``):
SI-SNR, mel-spectrogram SSIM, STOI, MCD and the multi-scale STFT distance
in numpy/scipy and the port's STFT (on the CPU), plus PESQ and ViSQOL,
which stay optional as in JAX (``None`` when the ``pesq`` package or the
``visqol`` binary is absent), and DNSMOS (``None`` without a model).
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.fftpack import dct
from scipy.signal import resample_poly

from rstnet_tpu_torch.ops.stft import magnitude, mel_filterbank


def _align(ref: np.ndarray, deg: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    n = min(ref.shape[-1], deg.shape[-1])
    return ref[..., :n], deg[..., :n]


def _magnitude(x: np.ndarray, n_fft: int, hop: int) -> np.ndarray:
    t = torch.from_numpy(np.asarray(x, np.float32)[None])
    return magnitude(t, n_fft, hop, n_fft)[0].numpy()


def si_snr(ref: np.ndarray, deg: np.ndarray, eps: float = 1e-8) -> float:
    """Scale-invariant SNR in dB."""
    ref, deg = _align(np.asarray(ref, np.float64), np.asarray(deg, np.float64))
    ref = ref - ref.mean()
    deg = deg - deg.mean()
    proj = np.dot(deg, ref) / (np.dot(ref, ref) + eps) * ref
    noise = deg - proj
    return float(10 * np.log10((np.sum(proj**2) + eps) / (np.sum(noise**2) + eps)))


def _mel_db(x: np.ndarray, sr: int, n_fft: int = 1024, hop: int = 256, n_mels: int = 80,
            min_level_db: float = -100.0) -> np.ndarray:
    mag = _magnitude(x, n_fft, hop)
    fb = mel_filterbank(n_fft // 2 + 1, 0, sr / 2, n_mels, sr, htk=False,
                        slaney_norm=True).numpy()
    mel = fb.T @ mag
    min_level = np.exp(min_level_db / 20 * np.log(10))
    db = 20 * np.log10(np.maximum(min_level, mel))
    return np.clip((db - min_level_db) / -min_level_db, 0, 1)


def mel_ssim(ref: np.ndarray, deg: np.ndarray, sr: int = 24000) -> float:
    """SSIM over normalized mel spectrograms."""
    ref, deg = _align(ref, deg)
    a, b = _mel_db(ref, sr), _mel_db(deg, sr)
    c1, c2 = 0.01**2, 0.03**2
    mu_a, mu_b = a.mean(), b.mean()
    var_a, var_b = a.var(), b.var()
    cov = ((a - mu_a) * (b - mu_b)).mean()
    return float(((2 * mu_a * mu_b + c1) * (2 * cov + c2))
                 / ((mu_a**2 + mu_b**2 + c1) * (var_a + var_b + c2)))


def ms_stft_distance(ref: np.ndarray, deg: np.ndarray) -> float:
    """Multi-scale STFT loss (spectral convergence + log-magnitude L1),
    through ``losses/gan.py``."""
    from rstnet_tpu_torch.losses.gan import multi_resolution_stft_loss

    ref, deg = _align(ref, deg)
    sc, mag = multi_resolution_stft_loss(torch.from_numpy(np.asarray(deg, np.float32)[None]),
                                         torch.from_numpy(np.asarray(ref, np.float32)[None]))
    return float(sc + mag)


def mcd(ref: np.ndarray, deg: np.ndarray, sr: int = 24000, n_mfcc: int = 13) -> float:
    """Mel-cepstral distortion (dB) over frame-aligned MFCCs."""
    ref, deg = _align(ref, deg)
    fb = mel_filterbank(513, 0, sr / 2, 40, sr, htk=True).numpy()

    def mfcc(x):
        logmel = np.log(np.maximum(fb.T @ _magnitude(x, 1024, 256), 1e-8))
        return dct(logmel, axis=0, norm="ortho")[1: n_mfcc + 1]

    a, b = mfcc(ref), mfcc(deg)
    n = min(a.shape[1], b.shape[1])
    diff = a[:, :n] - b[:, :n]
    return float(np.mean(np.sqrt(2 * np.sum(diff**2, axis=0))) * 10 / np.log(10))


def stoi(ref: np.ndarray, deg: np.ndarray, sr: int = 24000) -> float:
    """Short-time objective intelligibility (classic STOI, 10 kHz inside)."""
    ref, deg = _align(np.asarray(ref, np.float64), np.asarray(deg, np.float64))
    fs = 10000
    if sr != fs:
        ref = resample_poly(ref, fs, sr)
        deg = resample_poly(deg, fs, sr)
    # 256-sample frames, 50% overlap, zero-padded to a 512-point FFT
    n_fft, frame, hop = 512, 256, 128
    frames = 1 + (len(ref) - frame) // hop
    if frames < 35:
        return float("nan")
    w = np.hanning(frame + 2)[1:-1]
    idx = np.arange(frames)[:, None] * hop + np.arange(frame)[None, :]
    # drop silent frames (40 dB below the loudest)
    e = 20 * np.log10(np.linalg.norm(ref[idx] * w, axis=1) + 1e-12)
    keep = e > (e.max() - 40)
    Xf = np.fft.rfft(ref[idx][keep] * w, n=n_fft, axis=1)
    Yf = np.fft.rfft(deg[idx][keep] * w, n=n_fft, axis=1)
    # 15 one-third octave bands from 150 Hz
    n_bands = 15
    cf = 150 * 2 ** (np.arange(n_bands) / 3)
    lo, hi = cf * 2 ** (-1 / 6), cf * 2 ** (1 / 6)
    freqs = np.fft.rfftfreq(n_fft, 1 / fs)
    bands = [(freqs >= lo_) & (freqs < hi_) for lo_, hi_ in zip(lo, hi)]
    X = np.stack([np.sqrt(np.sum(np.abs(Xf[:, b]) ** 2, axis=1)) for b in bands])
    Y = np.stack([np.sqrt(np.sum(np.abs(Yf[:, b]) ** 2, axis=1)) for b in bands])
    # 30-frame (384 ms) segments, normalized and clipped correlation
    N = 30
    if X.shape[1] < N:
        return float("nan")
    scores = []
    beta = 10 ** (-15 / 20)
    for m in range(N, X.shape[1] + 1):
        x, y = X[:, m - N: m], Y[:, m - N: m]
        alpha = np.sqrt(np.sum(x**2, axis=1, keepdims=True)
                        / (np.sum(y**2, axis=1, keepdims=True) + 1e-12))
        y_clip = np.minimum(alpha * y, (1 + beta) * x)
        xn = x - x.mean(axis=1, keepdims=True)
        yn = y_clip - y_clip.mean(axis=1, keepdims=True)
        denom = np.linalg.norm(xn, axis=1) * np.linalg.norm(yn, axis=1) + 1e-12
        scores.append(np.sum(xn * yn, axis=1) / denom)
    return float(np.mean(scores))


# -- metrics with external backends ---------------------------------------------


def pesq_score(ref: np.ndarray, deg: np.ndarray, sr: int = 16000, mode: str = "wb"):
    """ITU-T PESQ through the ``pesq`` package; None if it is absent."""
    try:
        from pesq import pesq as _pesq
    except ImportError:
        return None
    ref, deg = _align(ref, deg)
    return float(_pesq(sr, ref, deg, mode))


def visqol_score(ref_path: str, deg_path: str, binary: str = "visqol"):
    """The ViSQOL binary's MOS-LQO; None if the binary is absent."""
    import shutil
    import subprocess

    if shutil.which(binary) is None:
        return None
    out = subprocess.run([binary, "--reference_file", ref_path, "--degraded_file", deg_path],
                         capture_output=True, text=True)
    for line in out.stdout.splitlines():
        if "MOS-LQO" in line:
            return float(line.split()[-1])
    return None


def dnsmos_score(deg: np.ndarray, sr: int = 16000, model_path: str = "", session=None):
    """DNSMOS OVRL score (compute_dnsmos.sh); None if the model (and
    onnxruntime) are unavailable. ``session`` injects a prebuilt or stub ONNX
    session (``pipeline/onnx_models.py::DNSMOS``)."""
    from rstnet_tpu_torch.pipeline.onnx_models import DNSMOS

    if session is None:
        if not model_path:
            return None
        try:
            import onnxruntime  # noqa: F401
        except ImportError:
            return None
    try:
        model = DNSMOS(model_path=model_path, session=session)
    except RuntimeError:
        return None
    return float(model.score(deg, sr)["OVRL"])
