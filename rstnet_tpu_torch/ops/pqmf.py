"""Pseudo-QMF filterbank for sub-band STFT losses (counterpart of
``rstnet_tpu/ops/pqmf.py``, the filter design copied).

An N-band filterbank from a Kaiser-windowed lowpass prototype (scipy's
``firwin``), whose cutoff a two-stage scan picks per band count to minimise
the white-noise reconstruction error of analysis -> synthesis. The design
runs once in numpy; analysis is one strided conv, synthesis an upsample and
one conv.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F


def _design(num_bands: int, taps: int, cutoff: float, beta: float):
    from scipy.signal import firwin

    proto = firwin(taps + 1, cutoff, window=("kaiser", beta))
    n = np.arange(taps + 1)
    analysis = np.zeros((num_bands, taps + 1))
    synthesis = np.zeros((num_bands, taps + 1))
    for k in range(num_bands):
        phase = (2 * k + 1) * (np.pi / (2 * num_bands)) * (n - taps / 2)
        offset = (-1) ** k * np.pi / 4
        analysis[k] = 2 * proto * np.cos(phase + offset)
        synthesis[k] = 2 * proto * np.cos(phase - offset)
    return analysis, synthesis


def _recon_error(num_bands: int, taps: int, cutoff: float, beta: float) -> float:
    """White-noise reconstruction error of the full chain (numpy)."""
    analysis, synthesis = _design(num_bands, taps, cutoff, beta)
    rng = np.random.default_rng(0)
    # a multiple of the band count keeps the length through decimation
    x = rng.normal(0.0, 1.0, 2048 - (2048 % num_bands))
    pad = taps // 2
    xp = np.pad(x, (pad, pad))
    y = np.zeros_like(x)
    for k in range(num_bands):
        sub = np.correlate(xp, analysis[k], mode="valid")[::num_bands] * num_bands
        up = np.zeros(sub.size * num_bands)
        up[::num_bands] = sub
        y += np.correlate(np.pad(up, (pad, pad)), synthesis[k], mode="valid")
    m = slice(taps, x.size - taps)
    return float(np.sum((x[m] - y[m]) ** 2) / np.sum(x[m] ** 2))


@lru_cache(maxsize=8)
def _optimal_cutoff(num_bands: int, taps: int, beta: float) -> float:
    """Two-stage scan around the theoretical 1/(2N) cutoff."""
    base = 0.5 / num_bands
    cuts = np.linspace(0.6 * base, 1.6 * base, 41)
    errs = [_recon_error(num_bands, taps, c, beta) for c in cuts]
    best = cuts[int(np.argmin(errs))]
    fine = np.linspace(best - 0.02 * base, best + 0.02 * base, 21)
    fine = fine[(fine > 0) & (fine < 1)]
    errs = [_recon_error(num_bands, taps, c, beta) for c in fine]
    return float(fine[int(np.argmin(errs))])


@lru_cache(maxsize=8)
def pqmf_filters(num_bands: int = 4, taps: int = 62, cutoff: float | None = None,
                 beta: float = 9.0) -> tuple[np.ndarray, np.ndarray]:
    """-> (analysis [N, 1, taps+1], synthesis [N, 1, taps+1]) float32;
    ``cutoff=None`` picks the prototype's cutoff per band count."""
    if cutoff is None:
        cutoff = _optimal_cutoff(num_bands, taps, beta)
    analysis, synthesis = _design(num_bands, taps, cutoff, beta)
    return (analysis[:, None, :].astype(np.float32),
            synthesis[:, None, :].astype(np.float32))


def pqmf_analysis(x: torch.Tensor, num_bands: int = 4, taps: int = 62) -> torch.Tensor:
    """[B, 1, T] -> [B, num_bands, T // num_bands]."""
    h, _ = pqmf_filters(num_bands, taps)
    pad = taps // 2
    x = F.pad(x, (pad, pad))
    return F.conv1d(x, torch.from_numpy(h).to(device=x.device, dtype=x.dtype), stride=num_bands)


def pqmf_synthesis(x: torch.Tensor, num_bands: int = 4, taps: int = 62) -> torch.Tensor:
    """[B, num_bands, T'] -> [B, 1, T' * num_bands]; conv1d is a
    cross-correlation, as ``lax.conv`` is, so the filters apply as designed."""
    _, g = pqmf_filters(num_bands, taps)
    B, N, T = x.shape
    up = torch.zeros((B, N, T * N), dtype=x.dtype, device=x.device)
    up[:, :, ::num_bands] = x * num_bands
    pad = taps // 2
    up = F.pad(up, (pad, pad))
    w = torch.from_numpy(g).to(device=x.device, dtype=x.dtype).transpose(0, 1)
    return F.conv1d(up, w)
