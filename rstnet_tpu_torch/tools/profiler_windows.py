"""How often ``torch.profiler`` loses device records, and whether
``profile_frame.device_trace`` still counts a call's kernels exactly.

    python -m rstnet_tpu_torch.tools.profiler_windows [--seconds 60] [--out F.json]

One call is three device events: a fill, K3's split-path RVQ encode at
Mimi's quantizer (Q=7, K=2048, D=256, 16 rows; one kernel) and an add. For
``--seconds`` the tool opens plain profiler windows around the call, one
after another, and counts those that did not record all three events, how
many of them came in a row, and when each came and what it kept. For as long again it calls ``device_trace``
on the call and counts the results that were not exactly those three
events (there must be none), the calls that raised ``NoDeviceEvents``, and
its windows and those of them that lost a marker.
"""

from __future__ import annotations

import argparse
import collections
import json
import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile

from rstnet_tpu_torch.ops.cuda_rvq import rvq_encode
from rstnet_tpu_torch.tools.profile_frame import (WINDOWS, NoDeviceEvents, device_trace,
                                                  window_stats)


def _kept(events: list) -> str:
    """Which of the call's three events a window kept: "fill/rvq/add" for
    all of them, "-" in the place of each one missing."""
    names = [e.name for e in sorted(events, key=lambda e: e.time_range.start)]
    return "/".join(key if any(test(n) for n in names) else "-" for key, test in (
        ("fill", lambda n: "Fill" in n), ("rvq", lambda n: "rvq_split_kernel" in n),
        ("add", lambda n: "add" in n.lower())))


def _is_call(events: list) -> bool:
    return len(events) == 3 and _kept(events) == "fill/rvq/add"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seconds", type=float, default=60.0)
    parser.add_argument("--out", default="")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profiler_windows needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    g = torch.Generator(device="cuda").manual_seed(0)
    books = torch.randn((7, 2048, 256), device="cuda", generator=g)
    x = torch.randn((16, 256), device="cuda", generator=g)
    flag = torch.zeros(1, device="cuda")

    def call():
        flag.fill_(1.0)
        rvq_encode(x, books)
        flag.add_(1.0)

    call()
    torch.cuda.synchronize()

    plain, t_end = [], time.perf_counter() + args.seconds
    t0 = time.perf_counter()
    while time.perf_counter() < t_end:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        kept = _kept(dev) if _is_call(dev) or len(dev) <= 3 else f"{len(dev)} events"
        plain.append((time.perf_counter() - t0, kept))
    window_ms = (time.perf_counter() - t0) * 1000 / len(plain)
    runs, run, lost = collections.Counter(), 0, []
    for t, kept in plain + [(0.0, "fill/rvq/add")]:
        if kept != "fill/rvq/add":
            run += 1
            lost.append((round(t, 3), kept))
        elif run:
            runs[run], run = runs[run] + 1, 0

    traced = wrong = raised = 0
    t_end = time.perf_counter() + args.seconds
    while time.perf_counter() < t_end:
        traced += 1
        try:
            wrong += not _is_call(device_trace(call)[0])
        except NoDeviceEvents:
            raised += 1
    result = {"card": card, "torch": torch.__version__, "plain_windows": len(plain),
              "plain_window_ms": window_ms, "plain_lost": len(lost),
              "lost_runs": {str(k): v for k, v in sorted(runs.items())},
              "lost_at_s_kept": lost,
              "device_trace_calls": traced, "device_trace_wrong": wrong,
              "device_trace_raised": raised, "device_trace_windows": WINDOWS["opened"],
              "device_trace_windows_lost": WINDOWS["lost"]}
    print(f"card: {card}; torch {torch.__version__}")
    print(f"plain windows: {len(plain)} of {window_ms:.2f} ms, {len(lost)} without all "
          f"three events; lost in runs of (length: count) {result['lost_runs']}; (s into the "
          f"loop, events kept) {lost[:40]}")
    print(f"device_trace: {traced} calls, {wrong} not exactly the call's three events, "
          f"{raised} raised NoDeviceEvents; {window_stats()}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 1 if wrong else 0


if __name__ == "__main__":
    raise SystemExit(main())
