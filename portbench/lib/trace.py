"""Device events of a few serving steps under ``torch.profiler`` (a frozen
copy of the program's ``tools/profile_frame.py::device_trace``).

On the H100 the profiler loses device records: those of kernels launched
just after a window opens, later the first few of every window, and now and
then whole windows. So a window waits on the host, launches throwaway
kernels, then a marker kernel, the work and a marker; a window counts only
if it holds both markers, and only once another whole window held as many
events between them (a loss inside a window can only remove events). A
window that lost its first marker doubles the throwaway kernels of the next.
"""

from __future__ import annotations

import collections
import time

MARK = "spin_kernel"  # the kernel of ``torch.cuda._sleep``
WAIT_S = 0.002
PRIMERS_MAX = 4096


class NoDeviceEvents(RuntimeError):
    """No profiler window kept all of its device records."""


class Tracer:
    def __init__(self):
        self.primers = 64  # throwaway kernels a window launches before its first marker

    def trace(self, fn, attempts: int = 8) -> tuple[list, float]:
        """([(name, start_us, end_us)] of one ``fn()``'s device events in
        start order, the wall time of ``fn`` and the markers in us). ``fn``
        must launch the same device work each time it runs."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        seen, lost = set(), []
        scrap = torch.empty(1, device="cuda")
        for _ in range(attempts):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                time.sleep(WAIT_S)
                for _ in range(self.primers):
                    scrap.zero_()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                torch.cuda._sleep(1)
                fn()
                torch.cuda._sleep(1)
                torch.cuda.synchronize()
                wall_us = (time.perf_counter() - t0) * 1e6
            dev = sorted(((e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                          if e.device_type == torch.autograd.DeviceType.CUDA),
                         key=lambda e: e[1])
            marks = [i for i, e in enumerate(dev) if MARK in e[0]]
            if len(marks) != 2:
                lost.append(f"{len(dev)} events, markers at {marks}, {self.primers} primers")
                self.primers = min(2 * self.primers, PRIMERS_MAX)
                continue
            body = dev[marks[0] + 1 : marks[1]]
            if len(body) in seen:
                return body, wall_us
            seen.add(len(body))
        raise NoDeviceEvents(f"no whole profiler window in {attempts}: whole ones held "
                             f"{sorted(seen)} events; the others {lost}")


def busy_us(events: list) -> float:
    """The union of the events' intervals."""
    busy, end = 0.0, float("-inf")
    for _, s, e in sorted(events, key=lambda e: e[1]):
        if s > end:
            busy, end = busy + (e - s), e
        elif e > end:
            busy, end = busy + (e - end), e
    return busy


def breakdown(events: list, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle gaps
    (named by the operations on either side), in seconds."""
    by_name = collections.Counter()
    for name, s, e in events:
        by_name[name] += e - s
    gaps, end, last = [], None, None
    for name, s, e in sorted(events, key=lambda e: e[1]):
        if end is not None and s > end:
            gaps.append((f"after {last[:60]} before {name[:60]}", (s - end) / 1e6))
        if end is None or e > end:
            end, last = e, name
    gaps.sort(key=lambda g: -g[1])
    return {"device_ops": [[n[:120], us / 1e6] for n, us in by_name.most_common(top)],
            "idle_gaps": [[n, s] for n, s in gaps[:top]]}
