"""The port's tail-latency telemetry (``rstnet_tpu_torch/utils/latency.py``,
a copy of ``rstnet_tpu/utils/latency.py``), mirroring
``tests/test_latency.py``: each case's result must also EQUAL the JAX
package's on the same latencies (pure Python on both sides)."""

import tests.test_torch_threads  # noqa: F401 - first: one torch CPU thread a process

import math

from rstnet_tpu.utils import latency as jax_latency
from rstnet_tpu_torch.utils.latency import (
    FrameLatencyTracker,
    classify_recovery,
    percentile,
)


def _same_classification(lat):
    mask = classify_recovery(lat)
    assert mask == jax_latency.classify_recovery(lat)
    return mask


def _summary(budget_ms, lat):
    mine, theirs = FrameLatencyTracker(budget_ms=budget_ms), \
        jax_latency.FrameLatencyTracker(budget_ms=budget_ms)
    for x in lat:
        mine.record(x)
        theirs.record(x)
    assert mine.summary() == theirs.summary()
    return mine.summary()


def test_percentile_nearest_rank():
    s = sorted(float(i) for i in range(1, 101))
    assert percentile(s, 0.50) == 51.0
    assert percentile(s, 0.99) == 100.0
    assert percentile(s, 0.0) == 1.0
    assert math.isnan(percentile([], 0.5))
    for q in (0.0, 0.25, 0.5, 0.9, 0.99, 1.0):
        assert percentile(s, q) == jax_latency.percentile(s, q)


def test_classify_empty_and_uniform():
    assert _same_classification([]) == []
    assert _same_classification([6.0] * 50) == [False] * 50


def test_recovery_stall_is_classified():
    # fast pipeline (~6 ms median) with one 4-second backend-recovery stall
    mask = _same_classification([6.0] * 199 + [4000.0])
    assert sum(mask) == 1 and mask[-1]


def test_scheduling_jitter_stays_in_tail():
    # a 40 ms hiccup at a 6 ms median is real jitter: the absolute floor
    # (median + 250 ms) keeps it in the tail
    assert _same_classification([6.0] * 99 + [40.0]) == [False] * 100


def test_over_budget_system_cannot_self_classify_healthy():
    # median 100 ms, frames up to 400 ms: 400 < max(5*100, 100+250) = 500
    lat = [100.0] * 90 + [150.0] * 5 + [400.0] * 5
    assert _same_classification(lat) == [False] * 100


def test_slow_pipeline_multiframe_stall_is_classified():
    # median 70 ms, a 600 ms stall: 600 > max(350, 320) -> excluded
    mask = _same_classification([70.0] * 99 + [600.0])
    assert sum(mask) == 1 and mask[-1]


def test_tracker_summary_reports_both_tails():
    s = _summary(80.0, [35.0] * 195 + [5000.0] * 5)
    assert s["n_frames"] == 200
    assert s["p99_ms"] == 5000.0  # raw tail keeps them
    assert s["p99_steady_ms"] == 35.0  # steady tail excludes them
    assert s["max_ms"] == 5000.0
    assert s["n_recovery_excluded"] == 5
    assert s["recovery_ms"] == [5000.0] * 5  # listed, not silently dropped
    assert s["p99_under_budget"] is True


def test_tracker_over_budget_not_maskable():
    s = _summary(80.0, [95.0] * 100)
    assert s["n_recovery_excluded"] == 0
    assert s["p99_steady_ms"] == 95.0
    assert s["p99_under_budget"] is False


def test_tracker_empty():
    assert FrameLatencyTracker().summary() == {"n_frames": 0} == \
        jax_latency.FrameLatencyTracker().summary()
