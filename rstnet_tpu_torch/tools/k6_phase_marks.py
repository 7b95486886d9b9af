"""Where a pair's time goes in K6's float32 backward on the card.

    python -m rstnet_tpu_torch.tools.k6_phase_marks [--batch 2,4] [--window 1024]
        [--calls 3] [--out F.json]

Copies ``csrc/flash_attention.cu`` into a build directory outside the
package (``$TMPDIR``), compiles it with ``RSTNET_K6_MARKS`` defined, and
runs the float32 backward (``flash_bwd_f32``, through the wrappers of
``ops/cuda_flash.py``) at the training shape (32 query heads over 8 KV
heads, T=1024, D=64) on seeded random inputs, ``--calls`` times, reading the
marks of the last call (see ``k6_marks`` in the source). A pair is one
(query head, 64-row query tile) visited by a work item. Printed for each
consumer warpgroup of the block that ran the most pairs (the critical path
under a causal mask), as medians over its pairs, in SM cycles and
microseconds at the SM clock measured over the call (clock64 against the
global timer): the ring's full wait, the S^T and dP^T products, the
elementwise phase (P^T, dS^T and P^T's parts), dS^T's parts written, the
dV, dK and dQ products, the wait for a staging slot, the staging, and the
whole pair; then the dQ writers' spans over all blocks: the wait for their
turn, for both staged halves, and the add and store. The marks themselves
cost a little: compare totals with ``chip_smoke.py``'s times, not with
these.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch

from rstnet_tpu_torch.ops import cuda_flash, cuda_lib

MARK_BLOCKS, MARK_PAIRS = 132, 160  # as kMarkBlocks, kMarkPairs in the source
PHASES = ("ring wait", "S^T, dP^T products", "elementwise, P^T parts", "dS^T parts to smem",
          "dV, dK, dQ products", "slot wait", "stage dQ half")
WRITER_SPANS = ("turn wait", "halves wait", "add and store")
H, HKV, T, D = 32, 8, 1024, 64


def build_marked() -> ctypes.CDLL:
    out = Path(os.environ.get("TMPDIR", tempfile.gettempdir())) / "rstnet_k6_marks"
    out.mkdir(parents=True, exist_ok=True)
    src = out / "flash_attention.cu"
    shutil.copy(cuda_lib.SRC_DIR / "flash_attention.cu", src)
    lib = out / "libk6_marks.so"
    flags = [f for f in cuda_lib.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    subprocess.run([cuda_lib._nvcc(), *flags, "-DRSTNET_K6_MARKS", "-shared", "-o", str(lib),
                    str(src)], check=True)
    dll = ctypes.CDLL(str(lib))
    for name in ("flash_attention_fwd", "flash_attention_bwd"):
        fn = getattr(dll, name)
        fn.argtypes, fn.restype = cuda_lib.SIGNATURES[name]
    dll.k6_marks_copy.argtypes = [ctypes.c_void_p] * 3
    dll.k6_marks_copy.restype = ctypes.c_int
    return dll


def run(dll, B: int, window: int, calls: int, g) -> tuple:
    """(consumer marks [blocks][2][pairs][8], writer marks [blocks][pairs][4],
    spans [blocks][4]) of the last of ``calls`` backward calls."""
    q, do = (torch.randn((B, H, T, D), device="cuda", generator=g) for _ in range(2))
    k, v = (torch.randn((B, HKV, T, D), device="cuda", generator=g) for _ in range(2))
    q = q * D**-0.5
    library = cuda_lib.kernel_library
    cuda_lib.kernel_library = lambda: dll  # the wrappers launch the marked build
    try:
        o, lse = cuda_flash.flash_attention_fwd(q, k, v, window)
        for _ in range(calls):
            cuda_flash.flash_attention_bwd(q, k, v, o, do, lse, window)
        torch.cuda.synchronize()
    finally:
        cuda_lib.kernel_library = library
    marks = np.zeros((MARK_BLOCKS, 2, MARK_PAIRS, 8), dtype=np.int64)
    writer = np.zeros((MARK_BLOCKS, MARK_PAIRS, 4), dtype=np.int64)
    spans = np.zeros((MARK_BLOCKS, 4), dtype=np.int64)
    cuda_lib.check(dll.k6_marks_copy(marks.ctypes.data, writer.ctypes.data, spans.ctypes.data),
                   "k6_marks_copy")
    return marks, writer, spans


def report(marks, writer, spans) -> dict:
    used = spans[:, 1] > 0
    ghz = float(np.median((spans[used, 1] - spans[used, 0]) / (spans[used, 3] - spans[used, 2])))
    pairs = (marks[:, 0, :, 7] > 0).sum(axis=1)
    b = int(np.argmax(pairs))
    n = int(pairs[b])
    out = {"sm_ghz": ghz, "block": b, "pairs": n, "call_us": float(
        np.median(spans[used, 3] - spans[used, 2]) / 1e3), "warpgroups": []}
    for wg in range(2):
        m = marks[b, wg, :n].astype(np.float64)
        phases = {name: float(np.median(m[:, i + 1] - m[:, i])) for i, name in enumerate(PHASES)}
        phases["pair"] = float(np.median(m[1:, 0] - m[:-1, 0])) if n > 1 else float("nan")
        out["warpgroups"].append(phases)
    w = writer.reshape(-1, 4).astype(np.float64)
    w = w[(w[:, 3] > 0) & (w[:, 0] > 0)]
    out["writers"] = {name: float(np.median(w[:, i + 1] - w[:, i]))
                      for i, name in enumerate(WRITER_SPANS)}
    return out


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--batch", default="2,4", help="B of each case")
    parser.add_argument("--window", type=int, default=T, help="keys visible to a query")
    parser.add_argument("--calls", type=int, default=3)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k6_phase_marks needs a CUDA device")
    dll = build_marked()
    g = torch.Generator(device="cuda").manual_seed(args.seed)
    result = {"device": torch.cuda.get_device_name(0), "cases": {}}
    for B in (int(v) for v in args.batch.split(",")):
        r = report(*run(dll, B, args.window, args.calls, g))
        result["cases"][f"B={B} window={args.window}"] = r
        us = lambda c: c / (r["sm_ghz"] * 1e3)  # noqa: E731
        print(f"B={B} window={args.window}: call {r['call_us']:.1f} us, SM {r['sm_ghz']:.3f} GHz; "
              f"block {r['block']}, {r['pairs']} pairs (cycles, us a pair, median):")
        for wg, phases in enumerate(r["warpgroups"]):
            print(f"  warpgroup {wg}: " + ", ".join(
                f"{name} {c:.0f} ({us(c):.2f})" for name, c in phases.items()))
        print("  dQ writers (all blocks): " + ", ".join(
            f"{name} {c:.0f} ({us(c):.2f})" for name, c in r["writers"].items()))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    return result


if __name__ == "__main__":
    main()
