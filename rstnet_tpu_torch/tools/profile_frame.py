"""Where the time of one serving frame goes, on one GPU.

    python -m rstnet_tpu_torch.tools.profile_frame [--frames 10] [--profile-frames 4]
                                                  [--batch N] [--seed 0] [--out FILE.json]
                                                  [--int8] [--int8-dep] [--int8-head]
                                                  [--kv-int8]

Builds the full slice as ``chip_smoke.py`` does (Mimi 24 kHz in float32 +
Moshi 7B in bf16, seeded random weights, seeded normal codebooks) and
measures, all on the card, the solo frame (``ServerState.handle_frame_array``)
or, with ``--batch N``, one tick of a ``SessionBatcher`` with N sessions,
each fed the same signal. The int8 options are the server's
(``serving/server.py::quantize_for_serving``). Two readings, one after the
other on the same models:

* ``graph``: the frame the server runs, a CUDA graph replay
  (``serving/graphs.py``), after the server's warmup (which captures it; the
  capture's wall time is reported);
* ``eager``: the same frame with the graphs off, and its stage split.

Each reading has:

1. frame (tick) time, p50, p99 and max, over ``--frames`` frames (host
   clock, a synchronize per frame, the device-to-host copy of the outputs
   included);
2. ``torch.profiler`` over ``--profile-frames`` frames: device time (the
   union of the kernel and copy intervals), the device's busy share of the
   wall time, device events per frame, and device time by kernel name;
3. eager only: stage times, medians over ``--frames`` more frames, each
   stage bracketed by ``torch.cuda.synchronize()``: Mimi encode, backbone
   step (``step_global``), depformer (the rest of ``LMGen.step``: 8
   micro-steps, embeddings, sampling, token bookkeeping) and Mimi decode. A
   graph has no stages to bracket, so this split is the eager frame's.

Peak memory is read for each reading, the graph pool included. Prints a
summary; ``--out`` also writes every number as JSON.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import gc
import json
import statistics
import subprocess
import time

import numpy as np
import torch


def _signal(n_frames: int, frame_size: int, seed: int) -> np.ndarray:
    t = np.arange(n_frames * frame_size) / 24000.0
    noise = np.random.default_rng(seed).standard_normal(t.shape)
    sig = 0.3 * np.sin(2 * np.pi * 220.0 * t) * np.sin(2 * np.pi * 1.5 * t) + 0.05 * noise
    return sig.astype(np.float32).reshape(n_frames, frame_size)


def _build_models(args):
    from rstnet_tpu_torch.serving.server import build_models, quantize_for_serving

    device, seed = torch.device("cuda"), args.seed
    mimi, lm_gen = build_models(False, device, seed)
    quantize_for_serving(lm_gen.model, args.int8, args.int8_dep, args.int8_head)
    lm_gen = dataclasses.replace(lm_gen, kv_int8=args.kv_int8)
    g = torch.Generator(device=device).manual_seed(seed + 1)
    for rvq in (mimi.quantizer.rvq_first, mimi.quantizer.rvq_rest):
        rvq.layers.embedding_sum.normal_(generator=g)  # zero codebooks make every code a tie
    return mimi, lm_gen


def _build(args, mimi, lm_gen, graphs: bool):
    """(server, frame size, one frame: pcm [frame_size] -> None, captured
    steps by name)."""
    from rstnet_tpu_torch.serving.batcher import SessionBatcher
    from rstnet_tpu_torch.serving.server import ServerState

    seed, batch = args.seed, args.batch
    if not batch:
        state = ServerState(mimi, lm_gen, seed=seed, cuda_graphs=graphs)
        state.warmup()
        return state, state.frame_size, state.handle_frame_array, state.graphs()
    batcher = SessionBatcher(mimi, lm_gen, max_sessions=batch, seed=seed, cuda_graphs=graphs)
    batcher.warmup()
    sessions = [batcher.acquire() for _ in range(batch)]

    def tick(pcm):
        for sess in sessions:
            sess.inputs.put_nowait(pcm)
        batcher.step_once()
        for sess in sessions:
            while not sess.outputs.empty():
                sess.outputs.get_nowait()

    captured = {"tick": batcher._graph} if batcher._graph is not None else {}
    return batcher, batcher.frame_size, tick, captured


def _timed(fn, record: list):
    def run(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        record.append((time.perf_counter() - t0) * 1000)
        return out

    return run


def stage_times(mimi, gen, run_frame, frames) -> dict:
    """Median ms per stage; the stage wrappers are removed afterwards."""
    rec = collections.defaultdict(list)
    mimi.encode_step = _timed(mimi.encode_step, rec["encode"])
    mimi.decode_step = _timed(mimi.decode_step, rec["decode"])
    gen.model.step_global = _timed(gen.model.step_global, rec["backbone"])
    object.__setattr__(gen, "step", _timed(gen.step, rec["lm_step"]))  # LMGen is frozen
    try:
        for pcm in frames:
            _timed(run_frame, rec["frame"])(pcm)
    finally:
        del mimi.encode_step, mimi.decode_step, gen.model.step_global
        object.__delattr__(gen, "step")
    med = {k: statistics.median(v) for k, v in rec.items()}
    med["depformer"] = statistics.median(a - b for a, b in zip(rec["lm_step"], rec["backbone"]))
    return med


def _union_us(intervals) -> float:
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            busy, end = busy + (e - s), e
        elif e > end:
            busy, end = busy + (e - end), e
    return busy


# the kernel of ``torch.cuda._sleep``, launched at both ends of a window
MARK = "spin_kernel"
# throwaway kernels a window launches before its first marker; doubled, up
# to PRIMERS_MAX, after a window that lost that marker
_primers = [64]
PRIMERS_MAX = 4096
# seconds a window waits on the host after it opens
WAIT_S = 0.002
# windows device_trace opened in this process, those that lost a marker, and
# the most throwaway records one window lost
WINDOWS = collections.Counter()


class NoDeviceEvents(RuntimeError):
    """No profiler window kept all of its device records."""


def device_trace(fn, attempts: int = 8, confirm: bool = True) -> tuple[list, float]:
    """(the device events (kernels, copies, fills) of one ``fn()`` under
    ``torch.profiler``, in the order of their start; the wall time of
    ``fn`` and the markers, in us).

    The profiler loses device records (``chip_smoke.py``'s runs and
    ``tools/profiler_windows.py`` on an H100): those of kernels launched
    just after a window opens, up to 253 back-to-back launches; then, once
    a process has run a while, the first few of every window, however long
    the window waited before them; and now and then every record of a few
    windows in a row. So a window waits WAIT_S on the host, launches
    throwaway kernels, then a marker kernel (:data:`MARK`), ``fn`` and a
    marker; a window that lost its first marker doubles the throwaway
    kernels of the windows after it. A window counts only if it holds both
    markers; with ``confirm``, only once another whole window held as many
    events between them, since a loss inside a long window can only remove
    events. It traces the device only (no host operators), which keeps
    reading it short. ``fn`` must launch the same device work each time it
    runs, and with ``confirm``, or ``attempts`` > 1, be safe to repeat.
    Raises :class:`NoDeviceEvents` after ``attempts`` windows without one
    that counts."""
    from torch.profiler import ProfilerActivity, profile

    seen, lost = set(), []
    scrap = torch.empty(1, device="cuda")
    for _ in range(attempts):
        primers = _primers[0]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(WAIT_S)
            for _ in range(primers):
                scrap.zero_()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            torch.cuda._sleep(1)
            fn()
            torch.cuda._sleep(1)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        dev = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
        marks = [i for i, e in enumerate(dev) if MARK in e.name]
        WINDOWS["opened"] += 1
        if len(marks) != 2:
            WINDOWS["lost"] += 1
            lost.append(f"{len(dev)} events, markers at {marks}, {primers} throwaway kernels")
            _primers[0] = min(2 * primers, PRIMERS_MAX)
            continue
        WINDOWS["most_primers_lost"] = max(WINDOWS["most_primers_lost"], primers - marks[0])
        body = dev[marks[0] + 1 : marks[1]]
        if not confirm or len(body) in seen:
            return body, wall_us
        seen.add(len(body))
    raise NoDeviceEvents(f"torch.profiler kept no whole window in {attempts}: whole ones held "
                         f"{sorted(seen)} events; the others {lost}")


def window_stats() -> str:
    return (f"{WINDOWS['opened']} profiler windows, {WINDOWS['lost']} of them without both "
            f"markers; at most {WINDOWS['most_primers_lost']} throwaway records lost in a whole "
            f"window; {_primers[0]} throwaway kernels a window now")


def device_events(fn) -> list[str]:
    """The names of :func:`device_trace`'s events of one ``fn()``."""
    return [e.name for e in device_trace(fn)[0]]


def device_profile(run_frame, frames) -> dict:
    def run():
        for pcm in frames:
            run_frame(pcm)

    dev, wall_us = device_trace(run)
    n = len(frames)
    spans = [(e.time_range.start, e.time_range.end) for e in dev]
    by_name = collections.Counter()
    for e in dev:
        by_name[e.name] += e.time_range.elapsed_us()
    busy = _union_us(spans)
    return {"frames": n, "wall_ms": wall_us / 1000, "device_events": len(dev),
            "device_ms": busy / 1000, "busy_share": busy / wall_us,
            "launches_per_frame": len(dev) / n,
            "by_kernel_ms": [(name, us / 1000) for name, us in by_name.most_common(15)]}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--frames", type=int, default=10)
    parser.add_argument("--profile-frames", type=int, default=4)
    parser.add_argument("--batch", type=int, default=0, metavar="N",
                        help="profile a SessionBatcher tick with N sessions instead of the "
                             "solo frame")
    parser.add_argument("--int8", action="store_true",
                        help="int8 backbone and depformer slice, as the server's --int8")
    parser.add_argument("--int8-dep", action="store_true", help="int8 depformer slice only")
    parser.add_argument("--int8-head", action="store_true", help="int8 text head")
    parser.add_argument("--kv-int8", action="store_true", help="int8 backbone ring K/V")
    parser.add_argument("--out", default="", help="also write the numbers here, as JSON")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this tool profiles the frame on a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    mimi, lm_gen = _build_models(args)
    n = args.frames
    options = [f"--{k.replace('_', '-')}" for k in ("int8", "int8_dep", "int8_head", "kv_int8")
               if getattr(args, k)]
    what = f"batched tick, {args.batch} sessions" if args.batch else "solo frame"
    what += "".join(f" {o}" for o in options)
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}; {what}")
    result = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
              "batch": args.batch, "options": options}
    for reading in ("graph", "eager"):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()  # the serving peak, not the build's
        server, frame_size, run_frame, captured = _build(args, mimi, lm_gen, reading == "graph")
        frames = _signal(2 * n + args.profile_frames, frame_size, args.seed)
        times = []
        for pcm in frames[:n]:
            _timed(run_frame, times)(pcm)
        prof = device_profile(run_frame, frames[n : n + args.profile_frames])
        stages = (stage_times(mimi, lm_gen, run_frame, frames[n + args.profile_frames :])
                  if reading == "eager" else None)
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        ts = sorted(times)
        res = {"peak_memory_gib": peak_gib,
               "frame_ms": {"p50": statistics.median(times),
                            "p99": ts[min(n - 1, int(0.99 * n))], "max": ts[-1], "n": n},
               "capture_ms": {k: g.capture_ms for k, g in captured.items()},
               "profile": prof}
        if stages is not None:
            res["stage_ms"] = stages
        result[reading] = res
        print(f"[{reading}] frame ms over {n} frames: p50 {res['frame_ms']['p50']:.3f}, p99 "
              f"{res['frame_ms']['p99']:.3f}, max {ts[-1]:.3f}; peak memory {peak_gib:.2f} GiB"
              + "".join(f"; {k} captured in {ms:.1f} ms" for k, ms in res["capture_ms"].items()))
        if stages is not None:
            print("[eager] stage ms (medians, synchronized per stage): " + ", ".join(
                f"{k} {stages[k]:.3f}" for k in ("encode", "backbone", "depformer", "decode",
                                                 "frame")))
        print(f"[{reading}] profiler over {prof['frames']} frames: wall {prof['wall_ms']:.3f} "
              f"ms, device busy {prof['device_ms']:.3f} ms ({100 * prof['busy_share']:.1f} "
              f"%), {prof['launches_per_frame']:.0f} device events per frame")
        for name, ms in prof["by_kernel_ms"]:
            print(f"  {ms:10.3f} ms  {name[:110]}")
        del server, run_frame, captured
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
