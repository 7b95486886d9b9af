"""Formant-synthesized pseudo-speech for codec training and evaluation
without a corpus (the port's own copy of ``rstnet_tpu/data/synth_speech.py``;
numpy only).

Source-filter clips: a sawtooth at a wandering F0 for voiced segments, noise
for fricatives, syllable-rate segmentation with smooth on/offsets and
silences; per-syllable formant targets (F1-F4) interpolated across frames
and applied as a magnitude envelope of resonance peaks in overlap-added
32 ms STFT frames; fricative frames get a 3-8 kHz band instead. Not
intelligible, but its harmonicity, formant dynamics, modulation and
silences are speech-like, so a codec's quantizer sees realistic code
diversity and its discriminators realistic spectra. With real data,
``data/codec_dataset.py`` is the training path; this module serves tests
and smoke runs.
"""

from __future__ import annotations

import numpy as np

_VOWEL_SPACE = (
    # (F1, F2, F3) targets, Hz — corners + interior of the vowel triangle
    (730, 1090, 2440),  # /a/
    (270, 2290, 3010),  # /i/
    (300, 870, 2240),   # /u/
    (530, 1840, 2480),  # /e/
    (570, 840, 2410),   # /o/
    (490, 1350, 1690),  # /er/
)
_BANDWIDTHS = (90.0, 120.0, 160.0, 220.0)
_F4 = 3400.0


def _smooth_noise(rng: np.random.RandomState, n: int, knots: int) -> np.ndarray:
    """[-1, 1]-ish smooth curve: linear interpolation of random knots."""
    k = max(2, knots)
    xs = np.linspace(0, n - 1, k)
    ys = rng.uniform(-1.0, 1.0, size=k)
    return np.interp(np.arange(n), xs, ys)


def synth_pseudo_speech(
    rng: np.random.RandomState,
    seconds: float = 1.0,
    sample_rate: int = 24000,
    rms: float = 0.06,
) -> np.ndarray:
    """One mono pseudo-speech clip, float32 [T], normalized to ``rms``."""
    sr = sample_rate
    T = int(seconds * sr)

    # --- syllable segmentation ------------------------------------------
    n_syl = max(2, int(round(seconds * rng.uniform(3.0, 5.0))))
    edges = np.sort(rng.uniform(0.05, 0.95, size=n_syl - 1))
    bounds = np.concatenate([[0.0], edges, [1.0]]) * T
    bounds = bounds.astype(np.int64)
    # segment kinds: mostly voiced vowels, some fricatives, some silence
    kinds = rng.choice(["v", "v", "v", "f", "s"], size=n_syl)
    kinds[rng.randint(n_syl)] = "v"  # at least one voiced segment

    # --- F0 contour + voiced source -------------------------------------
    f0_base = rng.uniform(90.0, 220.0)
    f0 = f0_base * (1.0 + 0.15 * _smooth_noise(rng, T, knots=int(seconds * 6) + 2))
    phase = np.cumsum(f0) / sr
    voiced_src = 2.0 * (phase - np.floor(phase)) - 1.0  # sawtooth, -6 dB/oct
    noise_src = rng.randn(T)

    # --- per-sample voicing/amplitude envelopes --------------------------
    env = np.zeros(T)
    voiced = np.zeros(T)
    fric = np.zeros(T)
    ramp = max(1, int(0.012 * sr))  # 12 ms smooth on/offsets
    for i, kind in enumerate(kinds):
        a, b = bounds[i], bounds[i + 1]
        if b - a < 4 or kind == "s":
            continue
        amp = rng.uniform(0.5, 1.0)
        seg = np.ones(b - a) * amp
        r = min(ramp, (b - a) // 2)
        if r > 0:
            win = 0.5 - 0.5 * np.cos(np.pi * np.arange(r) / r)
            seg[:r] *= win
            seg[-r:] *= win[::-1]
        env[a:b] = np.maximum(env[a:b], seg)
        (voiced if kind == "v" else fric)[a:b] = 1.0
    # syllable-internal amplitude modulation
    env = env * (0.8 + 0.2 * _smooth_noise(rng, T, knots=int(seconds * 10) + 2))
    excitation = (
        voiced * env * voiced_src
        + fric * env * 0.7 * noise_src
        + voiced * env * 0.05 * noise_src  # breathiness
        + 0.003 * rng.randn(T)  # room floor
    )

    # --- frame-wise formant envelope filter (magnitude STFT) -------------
    frame = 768  # 32 ms at 24 kHz
    hop = frame // 2
    n_frames = max(1, (T - frame) // hop + 1)
    # per-syllable formant targets, interpolated across frame centers
    syl_formants = np.array(
        [_VOWEL_SPACE[rng.randint(len(_VOWEL_SPACE))] for _ in range(n_syl)]
    ) * rng.uniform(0.9, 1.1, size=(n_syl, 1))  # speaker vocal-tract scale
    centers = (np.arange(n_frames) * hop + frame // 2) / max(T - 1, 1)
    syl_centers = (bounds[:-1] + bounds[1:]) / 2.0 / max(T - 1, 1)
    frame_formants = np.stack(
        [np.interp(centers, syl_centers, syl_formants[:, j]) for j in range(3)],
        axis=1,
    )  # [n_frames, 3]
    freqs = np.fft.rfftfreq(frame, 1.0 / sr)  # [nb]
    f4 = np.full((n_frames, 1), _F4)
    ff = np.concatenate([frame_formants, f4], axis=1)  # [n_frames, 4]
    bw = np.asarray(_BANDWIDTHS)
    # sum of resonance peaks + floor; gentle spectral tilt
    peaks = 1.0 / np.sqrt(
        1.0 + ((freqs[None, None, :] - ff[:, :, None]) / bw[None, :, None]) ** 2
    )  # [n_frames, 4, nb]
    envelope = peaks.max(axis=1) + 0.03
    envelope = envelope * (1.0 / (1.0 + (freqs[None, :] / 4000.0) ** 2))
    # fricative frames: band noise 3-8 kHz instead of formant structure
    fric_frac = np.zeros(n_frames)
    for i in range(n_frames):
        a = i * hop
        fric_frac[i] = fric[a : a + frame].mean()
    band = ((freqs >= 3000) & (freqs <= 8000)).astype(np.float64)
    envelope = (
        envelope * (1.0 - fric_frac[:, None])
        + (0.05 + band[None, :]) * fric_frac[:, None]
    )

    win = np.hanning(frame)
    idx = np.arange(frame)[None, :] + hop * np.arange(n_frames)[:, None]
    pad = np.zeros(max(0, idx.max() + 1 - T))
    x = np.concatenate([excitation, pad])
    frames = x[idx] * win[None, :]
    spec = np.fft.rfft(frames, axis=1) * envelope
    out_frames = np.fft.irfft(spec, n=frame, axis=1) * win[None, :]
    out = np.zeros(len(x))
    norm = np.zeros(len(x))
    np.add.at(out, idx, out_frames)
    np.add.at(norm, idx, (win ** 2)[None, :].repeat(n_frames, axis=0))
    out = (out / np.maximum(norm, 1e-3))[:T]

    cur = float(np.sqrt(np.mean(out**2)) + 1e-9)
    return (out * (rms / cur)).astype(np.float32)


def synth_corpus(
    seed: int, n_clips: int, seconds: float = 1.0, sample_rate: int = 24000
) -> np.ndarray:
    """[n_clips, T] pseudo-speech corpus, deterministic in ``seed``."""
    rng = np.random.RandomState(seed)
    return np.stack(
        [synth_pseudo_speech(rng, seconds, sample_rate) for _ in range(n_clips)]
    )
