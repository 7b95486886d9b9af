"""Frame-latency telemetry: percentiles with recovery-frame accounting (the
port's own copy of what the servers use from ``rstnet_tpu/utils/latency.py``).

A real-time serving budget is a tail budget: the 80 ms frame period must hold
at p99, not only at the median. A stall many times the median (a device or
host hiccup of seconds) is annotated and excluded from the steady-state tail
separately, never silently dropped; and a p99 over a few dozen frames is the
maximum, so a credible tail needs a few hundred frames.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence


def percentile(sorted_ms: Sequence[float], q: float) -> float:
    """Nearest-rank percentile of an ascending-sorted sequence."""
    if not sorted_ms:
        return float("nan")
    idx = min(int(len(sorted_ms) * q), len(sorted_ms) - 1)
    return sorted_ms[idx]


def classify_recovery(lat_ms: Sequence[float], factor: float = 5.0,
                      floor_ms: float = 250.0) -> list[bool]:
    """True for frames above both ``factor * median`` and ``median +
    floor_ms``: the absolute floor keeps real jitter of a fast loop in the
    tail, and the factor keeps a loop that is simply over budget from
    calling itself healthy."""
    if not lat_ms:
        return []
    s = sorted(lat_ms)
    med = s[len(s) // 2]
    cut = max(factor * med, med + floor_ms)
    return [x > cut for x in lat_ms]


@dataclasses.dataclass
class FrameLatencyTracker:
    """Accumulates per-frame wall-clock latencies for one session or loop."""

    budget_ms: float = 80.0
    samples_ms: list = dataclasses.field(default_factory=list)

    def record(self, ms: float) -> None:
        self.samples_ms.append(float(ms))

    def summary(self) -> dict:
        """Raw and steady-state percentiles plus recovery-frame accounting:
        ``p99_ms`` over all frames, ``p99_steady_ms`` without the frames
        ``classify_recovery`` marks (``n_recovery_excluded`` counts them,
        ``recovery_ms`` lists them), ``p99_under_budget`` against the
        frame budget."""
        lat = self.samples_ms
        if not lat:
            return {"n_frames": 0}
        s = sorted(lat)
        mask = classify_recovery(lat)
        steady = sorted(x for x, bad in zip(lat, mask) if not bad)
        recovery = [round(x, 1) for x, bad in zip(lat, mask) if bad]
        out = {
            "n_frames": len(lat),
            "p50_ms": round(percentile(s, 0.50), 3),
            "p90_ms": round(percentile(s, 0.90), 3),
            "p99_ms": round(percentile(s, 0.99), 3),
            "max_ms": round(s[-1], 3),
            "n_recovery_excluded": len(recovery),
        }
        if steady:
            out["p99_steady_ms"] = round(percentile(steady, 0.99), 3)
            out["p99_under_budget"] = out["p99_steady_ms"] < self.budget_ms
        if recovery:
            out["recovery_ms"] = recovery[:16]
        return out
