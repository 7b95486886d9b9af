"""Where the time of one serving frame goes, on one GPU.

    python -m rstnet_tpu_torch.tools.profile_frame [--frames 10] [--profile-frames 4]
                                                  [--batch N] [--seed 0] [--out FILE.json]
                                                  [--int8] [--int8-dep] [--int8-head]
                                                  [--kv-int8]

Builds the full slice as ``chip_smoke.py`` does (Mimi 24 kHz in float32 +
Moshi 7B in bf16, seeded random weights, seeded normal codebooks), warms it
up, and then measures, all on the card, for the solo frame
(``ServerState.handle_frame_array``) or, with ``--batch N``, for one tick of
a ``SessionBatcher`` with N sessions, each fed the same signal. The int8
options are the server's (``serving/server.py::quantize_for_serving``):

1. frame (tick) time, p50 and max, over ``--frames`` frames (host clock, a
   synchronize per frame);
2. stage times, medians over ``--frames`` more frames, each stage bracketed
   by ``torch.cuda.synchronize()``: Mimi encode, backbone step
   (``step_global``), depformer (the rest of ``LMGen.step``: 8 micro-steps,
   embeddings, sampling, token bookkeeping) and Mimi decode;
3. ``torch.profiler`` over ``--profile-frames`` frames with no stage syncs:
   device time (the union of the kernel and copy intervals), the device's
   busy share of the wall time, launches per frame, and device time by
   kernel name.

Prints a summary; ``--out`` also writes every number as JSON.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
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


def _build(args):
    """(mimi, lm_gen, frame size, one frame: pcm [frame_size] -> None)."""
    from rstnet_tpu_torch.serving.batcher import SessionBatcher
    from rstnet_tpu_torch.serving.server import ServerState, build_models, quantize_for_serving

    device, seed, batch = torch.device("cuda"), args.seed, args.batch
    mimi, lm_gen = build_models(False, device, seed)
    quantize_for_serving(lm_gen.model, args.int8, args.int8_dep, args.int8_head)
    lm_gen = dataclasses.replace(lm_gen, kv_int8=args.kv_int8)
    torch.cuda.reset_peak_memory_stats()  # the serving peak, not the bf16 build's
    g = torch.Generator(device=device).manual_seed(seed + 1)
    for rvq in (mimi.quantizer.rvq_first, mimi.quantizer.rvq_rest):
        rvq.layers.embedding_sum.normal_(generator=g)  # zero codebooks make every code a tie
    if not batch:
        state = ServerState(mimi, lm_gen, seed=seed)
        state.warmup()
        return mimi, lm_gen, state.frame_size, state.handle_frame_array
    batcher = SessionBatcher(mimi, lm_gen, max_sessions=batch, seed=seed)
    batcher.warmup()
    sessions = [batcher.acquire() for _ in range(batch)]

    def tick(pcm):
        for sess in sessions:
            sess.inputs.put_nowait(pcm)
        batcher.step_once()
        for sess in sessions:
            while not sess.outputs.empty():
                sess.outputs.get_nowait()

    return mimi, lm_gen, batcher.frame_size, tick


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


def device_events(fn, attempts: int = 3) -> list[str]:
    """The names of the device events (kernels, copies, fills) of one
    ``fn()``, in the order the profiler lists them. ``fn`` must launch
    device work and be safe to repeat: a window in which the profiler
    recorded no device event at all lost its records (seen once on the
    card), and is profiled again, up to ``attempts`` windows."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        if names:
            break
    return names


def device_profile(run_frame, frames) -> dict:
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for pcm in frames:
            run_frame(pcm)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    n = len(frames)
    out = {"frames": n, "wall_ms": wall_us / 1000, "device_events": len(dev)}
    if not dev:
        return out
    spans = [(e.time_range.start, e.time_range.end) for e in dev]
    by_name = collections.Counter()
    for e in dev:
        by_name[e.name] += e.time_range.elapsed_us()
    busy = _union_us(spans)
    out.update(device_ms=busy / 1000, busy_share=busy / wall_us, launches_per_frame=len(dev) / n,
               by_kernel_ms=[(name, us / 1000) for name, us in by_name.most_common(15)])
    return out


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
    mimi, lm_gen, frame_size, run_frame = _build(args)
    n = args.frames
    frames = _signal(2 * n + args.profile_frames, frame_size, args.seed)

    times = []
    for pcm in frames[:n]:
        _timed(run_frame, times)(pcm)
    stages = stage_times(mimi, lm_gen, run_frame, frames[n : 2 * n])
    prof = device_profile(run_frame, frames[2 * n :])
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    options = [f"--{k.replace('_', '-')}" for k in ("int8", "int8_dep", "int8_head", "kv_int8")
               if getattr(args, k)]
    result = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
              "batch": args.batch, "options": options, "peak_memory_gib": peak_gib,
              "frame_ms": {"p50": statistics.median(times), "max": max(times), "n": n},
              "stage_ms": stages, "profile": prof}
    what = f"batched tick, {args.batch} sessions" if args.batch else "solo frame"
    what += "".join(f" {o}" for o in options)
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}; {what}; "
          f"peak memory {peak_gib:.1f} GiB")
    print(f"frame ms over {n} frames: p50 {statistics.median(times):.3f}, max {max(times):.3f}")
    print("stage ms (medians, synchronized per stage): " + ", ".join(
        f"{k} {stages[k]:.3f}" for k in ("encode", "backbone", "depformer", "decode", "frame")))
    if "device_ms" in prof:
        print(f"profiler over {prof['frames']} frames: wall {prof['wall_ms']:.3f} ms, device busy "
              f"{prof['device_ms']:.3f} ms ({100 * prof['busy_share']:.1f} %), "
              f"{prof['launches_per_frame']:.0f} device events per frame")
        for name, ms in prof["by_kernel_ms"]:
            print(f"  {ms:10.3f} ms  {name[:110]}")
    else:
        print("profiler: no device events recorded; device time not measured")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
