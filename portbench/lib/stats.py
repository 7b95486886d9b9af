"""Percentiles and rates over every sample of a run.

``percentile`` is the nearest-rank percentile the servers' latency
telemetry uses (frozen here, so that the program cannot change the
yardstick): of n ascending samples, the one at index ``min(int(n q), n - 1)``.
"""

from __future__ import annotations

from typing import Sequence


def percentile(samples: Sequence[float], q: float) -> float:
    """Nearest-rank ``q`` percentile (0 < q < 1) of all ``samples``."""
    if not samples:
        raise ValueError("percentile of no samples")
    s = sorted(samples)
    return s[min(int(len(s) * q), len(s) - 1)]


def rate(count: int, seconds: float) -> float:
    """``count`` items over the whole of ``seconds``."""
    if seconds <= 0:
        raise ValueError("a rate needs a positive time")
    return count / seconds
