"""One run of a cell: set-up, the measured window, an optional traced
window, the check, and the result line's fields.

Set-up (``setup_s``, from the process's start): the sessions' audio and the
weights drawn from the seed, the server built by its own entry (kernel
library loaded or built, int8 quantization, warm-up, CUDA graph capture),
the sessions joined and stepped through the LM's delay warm-up, and what
set-up made frozen out of the garbage collector's scans. The window
then steps every session closed-loop and back to back for ``seconds``, with
the device's peak memory reset at its start and read at its end. With
``trace``, ``trace_steps`` more steps run under the profiler after the
window. The program is freed before the reference runs.
"""

from __future__ import annotations

import gc
import time
import types

import numpy as np
import torch

from portbench.lib import counts
from portbench.lib.judge import NUMBERS, check
from portbench.lib.serve import Driver, build_server
from portbench.lib.signal import session_frames
from portbench.lib.trace import Tracer, breakdown, busy_us
from portbench.lib.weights import draw
from portbench.reference import layout


def run_cell(cell, seed: int, seconds: float, trace: bool, device: str, t_start: float,
             control: bool = False) -> dict:
    cfg, traffic = cell.config, cell.traffic
    z = layout.derived(cfg)
    frames = np.stack([session_frames(seed, s, traffic["signal_frames"], z["frame_size"])
                       for s in range(traffic["sessions"])])
    server, seen = build_server(cfg, traffic, seed, device, draw(layout.spec(cfg), seed, device))
    driver = Driver(server, traffic, frames, traffic["max_steps"])
    ring_bytes = driver.ring_bytes()
    for _ in range(max(z["delays"])):
        driver.step()
    cuda = device.startswith("cuda")
    if cuda:
        torch.cuda.synchronize()
    # what set-up made is never scanned again by the collector in the window
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    first = driver.steps
    step_ms = []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        step_ms.append(driver.step())
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    window = driver.outputs[first:]
    attempted = len(window) * traffic["sessions"]
    failed = sum(o[0] is None for step in window for o in step)
    events, trace_wall_us, trace_steps = [], 0.0, traffic["trace_steps"]
    starts = []  # the first step of each traced attempt; the kept one is the last

    def traced():
        starts.append(driver.steps)
        for _ in range(trace_steps):
            driver.step(record=False)

    if trace:
        events, trace_wall_us = Tracer().trace(traced)
    # the frames each traced step's sessions hold, the one it writes included
    traced_positions = [starts[-1] + i + 1 for i in range(trace_steps)] if starts else []
    record = driver.record()
    del driver, server
    gc.unfreeze()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    readings = check(cfg, traffic, seed, record, frames, device, control) if not failed else {}
    # the numbers the cell's limits file names are compared; the others are
    # printed with the control's readings only
    correct = not failed and all(readings[k] <= limit for k, limit in cell.limits.items())
    run = types.SimpleNamespace(
        cfg=cfg, traffic=traffic, z=z, counts=counts, setup_s=setup_s, step_ms=step_ms,
        window_s=window_s, sessions=traffic["sessions"], peak_bytes=peak, events=events,
        trace_wall_us=trace_wall_us, trace_steps=trace_steps, traced_positions=traced_positions,
        ring_bytes=ring_bytes, hidden_dtype=seen.get("hidden_dtype"))
    metrics = {}
    for name, unit, read in (cell.per_layer if trace else cell.end_to_end):
        value = read(run)
        if value is not None:
            metrics[name] = {"value": value, "unit": unit}
    result = {"correct": bool(correct), "attempted": attempted, "failed": failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if cuda else "cpu",
                         "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                         "count": cell.chips, "memory_peak_bytes": peak}}
    if trace:
        result["device"]["busy_s"] = busy_us(events) / 1e6
        result["device"]["window_s"] = trace_wall_us / 1e6
        result["breakdown"] = breakdown(events)
    if control:
        result["control"] = {"program": {k: readings.get(k) for k in NUMBERS},
                             "control": readings.get("control")}
    # the numbers compared, each beside its limit: the line's last key
    result["checks"] = {k: {"value": readings.get(k), "limit": limit}
                        for k, limit in cell.limits.items()}
    return result
