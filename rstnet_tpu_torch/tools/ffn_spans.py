"""Where a K4 or K5 call's time goes on the card: device time kernel by kernel, and host time.

    python -m rstnet_tpu_torch.tools.ffn_spans [--rows 1,16,64] [--calls 6]
        [--seed 0] [--out F.json]

At Llama-3.2-1B's MLP (C=2048, H=8192, the model's init scales, bf16 x),
K4 over bf16 weights and K5 over the same weights quantized by the port's
``quantize_weight_int8``, three weight sets in turn so that no call finds its
weights in L2 (as a frame's 16 layers do not). For each N, ``--calls`` calls
run under ``torch.profiler`` after a warm-up; for each call, from the device
events of its kernels (``csrc/gating_ffn.cu``: the gate/value pass, the down
pass, the split sum, which start early under programmatic dependent launch):
the gate/value pass's span, the down pass's tail after it (down end minus
gate/value end), the split sum's tail after that, and the whole call (first
start to last end). Printed as medians over the calls, in microseconds, with
the gate/value pass's weight stream rate, and beside them the wrapper's host
time a call (entry to return on the host clock over ``HOST_CALLS`` calls made
in rounds of 8 after a synchronize, so that the launch queue never fills and
blocks the host): the median and the 10th percentile, the floor that the
host's other work disturbs least.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

from rstnet_tpu_torch.modules.transformer import quantize_weight_int8
from rstnet_tpu_torch.ops.cuda_ffn import gating_ffn, gating_ffn_int8

C, H, N_SETS = 2048, 8192, 3
PASSES = {"gate_value": "gate_value_tc", "down": "down_tc", "sum": "sum_down_splits"}
HOST_CALLS, HOST_ROUND = 480, 8


def weight_sets(g: torch.Generator) -> tuple[list, list]:
    def uniform(rows, cols):
        return ((torch.rand((rows, cols), device="cuda", generator=g) * 2 - 1)
                * cols**-0.5).to(torch.bfloat16)

    sets = [[uniform(H, C), uniform(H, C), uniform(C, H)] for _ in range(N_SETS)]
    qsets = [[t for w in ws for q in [quantize_weight_int8(w)]
              for t in (q.w_int8.data, q.scale.data)] for ws in sets]
    return sets, qsets


def call_spans(kernel, x, wsets, calls: int) -> list[dict]:
    """Each call's spans (us) from its kernels' device events."""
    for ws in wsets:  # warm-up: the build, the allocator
        kernel(x, *ws)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(calls):
            kernel(x, *wsets[i % len(wsets)])
        torch.cuda.synchronize()
    events = {name: [] for name in PASSES}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for name, key in PASSES.items():
            if key in e.name:
                events[name].append((e.time_range.start, e.time_range.end))
    spans = []
    for gv, down, total in zip(*(sorted(events[n]) for n in PASSES)):
        spans.append({"gate_value_us": gv[1] - gv[0], "down_tail_us": down[1] - gv[1],
                      "sum_tail_us": total[1] - down[1], "call_us": total[1] - gv[0]})
    if len(spans) != calls:
        raise RuntimeError(f"found {len(spans)} calls' kernels in the profile, expected {calls}")
    return spans


def host_us(kernel, x, wsets) -> tuple[float, float]:
    """The host time (us) of a call to the wrapper: (median, 10th
    percentile)."""
    times = []
    for r in range(HOST_CALLS // HOST_ROUND):
        torch.cuda.synchronize()
        for i in range(HOST_ROUND):
            ws = wsets[(r * HOST_ROUND + i) % len(wsets)]
            t0 = time.perf_counter()
            kernel(x, *ws)
            times.append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
    return statistics.median(times), statistics.quantiles(times, n=10)[0]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--rows", default="1,16,64")
    parser.add_argument("--calls", type=int, default=6)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", default="")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this tool profiles the kernels on a GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    g = torch.Generator(device="cuda").manual_seed(args.seed)
    sets, qsets = weight_sets(g)
    report = {"card": card, "C": C, "H": H, "calls": args.calls, "kernels": {}}
    for name, kernel, wsets, weight_bytes in (("gating_ffn", gating_ffn, sets, 2),
                                              ("gating_ffn_int8", gating_ffn_int8, qsets, 1)):
        for n in (int(r) for r in args.rows.split(",")):
            x = torch.randn((n, C), device="cuda", generator=g).to(torch.bfloat16)
            spans = call_spans(kernel, x, wsets, args.calls)
            med = {k: statistics.median(s[k] for s in spans) for k in spans[0]}
            med["gate_value_tb_per_s"] = weight_bytes * 2 * H * C / med["gate_value_us"] / 1e6
            med["host_us"], med["host_p10_us"] = host_us(kernel, x, wsets)
            report["kernels"].setdefault(name, {})[str(n)] = med
            print(f"{name} N={n}: gate/value pass {med['gate_value_us']:.1f} us "
                  f"({med['gate_value_tb_per_s']:.2f} TB/s of weights), down tail "
                  f"{med['down_tail_us']:.1f} us, sum tail {med['sum_tail_us']:.1f} us, call "
                  f"{med['call_us']:.1f} us (medians over {args.calls} calls); host "
                  f"{med['host_us']:.1f} us a call (median of {HOST_CALLS}; 10th percentile "
                  f"{med['host_p10_us']:.1f}) [{card}]")
    if args.out:
        Path(args.out).write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
