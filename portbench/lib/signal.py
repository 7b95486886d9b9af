"""Seeded speech-like audio for the sessions.

A voiced source (eight harmonics of a wandering pitch) under a syllable-rate
envelope, with a little noise: the signal of ``chip_smoke.py``'s serving
paths (a 220 Hz tone under a 1.5 Hz envelope, plus noise), with the pitch,
the syllable rate and the phases drawn per session. Every seed gives the same
amount of audio; only its content changes.
"""

from __future__ import annotations

import numpy as np

SAMPLE_RATE = 24000


def session_frames(seed: int, session: int, n_frames: int, frame_size: int = 1920) -> np.ndarray:
    """[n_frames, frame_size] float32 samples in [-1, 1] for one session."""
    rng = np.random.default_rng([int(seed) % (1 << 63), session])
    n = n_frames * frame_size
    t = np.arange(n) / SAMPLE_RATE
    f0 = rng.uniform(90.0, 260.0)
    wobble = 1.0 + 0.08 * np.sin(2 * np.pi * rng.uniform(0.2, 0.8) * t + rng.uniform(0, 2 * np.pi))
    phase = 2 * np.pi * np.cumsum(f0 * wobble) / SAMPLE_RATE
    voiced = sum(np.sin(h * phase) / h for h in range(1, 9))
    syllable = rng.uniform(2.5, 5.0)
    env = np.sin(np.pi * syllable * t + rng.uniform(0, np.pi)) ** 2
    x = 0.25 * voiced * env + 0.02 * rng.standard_normal(n)
    return np.clip(x, -1.0, 1.0).astype(np.float32).reshape(n_frames, frame_size)
