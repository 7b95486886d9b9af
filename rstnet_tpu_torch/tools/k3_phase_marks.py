"""Where a K3 call's time goes on the card: level by level on the split
path, by kind of work on the tiled path.

    python -m rstnet_tpu_torch.tools.k3_phase_marks [--rows 1,16,64]
        [--levels 1,7] [--tiled-rows 4096] [--calls N] [--out F.json]

Copies ``csrc/rvq_encode.cu`` into a build directory outside the package
(``$TMPDIR``), compiles it with ``RSTNET_RVQ_MARKS`` defined, and runs it at
Mimi's quantizer shapes (D=256, K=2048) on seeded random inputs, each case
``--calls`` times, reading the marks of the last call. Split path: thread 0
of every block writes its SM's clock64 at points of each level (see the
source); printed as medians over blocks, in microseconds at the SM clock
measured over the call (clock64 against the global timer): each level's
dots (slice landed -> own dots done), keys (-> the block's best keys
formed), arrival (-> atomicMins issued and the arrival released), merge
(-> the winners read: waiting for the other blocks), update (-> the
winners' codewords gathered, the residual updated, synced), and the whole
call. Tiled path: thread 0 of each block
sums its time waiting for a stage, issuing the next tile's copies, in
products and in the rest (epilogues, level ends); printed as medians over
blocks in milliseconds.
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

from rstnet_tpu_torch.ops import cuda_lib

D, K = 256, 2048
MARK_BLOCKS = 160  # rows of rvq_marks in the marked build
SPLIT_SPANS = {"dots": (0, 5), "keys": (5, 6), "arrival": (6, 1), "merge": (1, 2),
               "update": (2, 4)}  # (from, to) mark slots of a level


def build_marked() -> ctypes.CDLL:
    out = Path(os.environ.get("TMPDIR", tempfile.gettempdir())) / "rstnet_k3_marks"
    out.mkdir(parents=True, exist_ok=True)
    src = out / "rvq_encode.cu"
    shutil.copy(cuda_lib.SRC_DIR / "rvq_encode.cu", src)
    lib = out / "libk3_marks.so"
    flags = [f for f in cuda_lib.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    subprocess.run([cuda_lib._nvcc(), *flags, "-DRSTNET_RVQ_MARKS", "-shared", "-o", str(lib),
                    str(src)], check=True)
    dll = ctypes.CDLL(str(lib))
    for name in ("rvq_encode", "rvq_encode_scratch_bytes"):
        fn = getattr(dll, name)
        fn.argtypes, fn.restype = cuda_lib.SIGNATURES[name]
    dll.rvq_marks_copy.argtypes, dll.rvq_marks_copy.restype = [ctypes.c_void_p], ctypes.c_int
    return dll


def run(dll, x: torch.Tensor, books: torch.Tensor, split: bool, calls: int) -> np.ndarray:
    """The marks of the last of ``calls`` calls, [blocks][9][8] int64."""
    N, Q = x.shape[0], books.shape[0]
    n_bytes = dll.rvq_encode_scratch_bytes(N, D, Q, K, int(split))
    if split:  # a counter at 0 and key words at all ones, as the wrapper keeps them
        scratch = torch.full((n_bytes // 8,), -1, dtype=torch.int64, device="cuda")
        scratch[0] = 0
    else:
        scratch = torch.empty(n_bytes // 4, dtype=torch.float32, device="cuda")
    codes = torch.empty((N, Q), dtype=torch.int32, device="cuda")
    quant = torch.empty((N, D), dtype=torch.float32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for _ in range(calls):
        cuda_lib.check(dll.rvq_encode(x.data_ptr(), books.data_ptr(), codes.data_ptr(),
                                      quant.data_ptr(), scratch.data_ptr(), N, D, Q, K,
                                      int(split), stream), "rvq_encode (marked)")
    torch.cuda.synchronize()
    marks = np.zeros((MARK_BLOCKS, 9, 8), dtype=np.int64)
    cuda_lib.check(dll.rvq_marks_copy(marks.ctypes.data), "rvq_marks_copy")
    return marks


def split_report(marks: np.ndarray, blocks: int, Q: int) -> dict:
    m = marks[:blocks]
    ghz = float(np.median((m[:, 8, 0] - m[:, 8, 1]) / (m[:, 8, 3] - m[:, 8, 2])))
    us = lambda cycles: float(np.median(cycles)) / (ghz * 1e3)  # noqa: E731
    levels = []
    for q in range(min(Q, 8)):
        levels.append({name: us(m[:, q, b] - m[:, q, a]) for name, (a, b) in SPLIT_SPANS.items()})
        levels[-1]["start"] = us(m[:, q, 0] - m[:, 8, 1])
    return {"sm_ghz": ghz, "call_us": us(m[:, 8, 0] - m[:, 8, 1]), "levels": levels}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--rows", default="1,16,64", help="N of the split-path cases")
    parser.add_argument("--levels", default="1,7", help="Q of every case")
    parser.add_argument("--tiled-rows", type=int, default=4096)
    parser.add_argument("--calls", type=int, default=3)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k3_phase_marks needs a CUDA device")
    dll = build_marked()
    g = torch.Generator(device="cuda").manual_seed(args.seed)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    slice_ = -(-K // sms)
    blocks = -(-K // slice_)
    report = {"device": torch.cuda.get_device_name(0), "split": {}, "tiled": {}}
    for Q in (int(v) for v in args.levels.split(",")):
        books = torch.randn((Q, K, D), device="cuda", generator=g)
        for N in (int(v) for v in args.rows.split(",")):
            x = torch.randn((N, D), device="cuda", generator=g)
            r = split_report(run(dll, x, books, True, args.calls), blocks, Q)
            report["split"][f"Q={Q} N={N}"] = r
            print(f"split Q={Q} N={N}: call {r['call_us']:.2f} us (SM {r['sm_ghz']:.3f} GHz)")
            for q, lv in enumerate(r["levels"]):
                print(f"  level {q}: starts at {lv['start']:.2f} us; " + ", ".join(
                    f"{k} {lv[k]:.2f}" for k in SPLIT_SPANS) + " us")
        x = torch.randn((args.tiled_rows, D), device="cuda", generator=g)
        marks = run(dll, x, books, False, args.calls)
        ghz = next(iter(report["split"].values()))["sm_ghz"] if report["split"] else 1.98
        tiles, ranks = -(-args.tiled_rows // 64), 2
        while ranks < 8 and tiles * ranks * 2 <= sms:  # as csrc/rvq_encode.cu::tiled_ranks
            ranks *= 2
        m = marks.reshape(MARK_BLOCKS, 72)[: min(MARK_BLOCKS, tiles * ranks), :4]
        spans = {k: float(np.median(m[:, i])) / (ghz * 1e6)
                 for i, k in enumerate(("wait", "issue", "products", "rest"))}
        report["tiled"][f"Q={Q} N={args.tiled_rows}"] = spans
        print(f"tiled Q={Q} N={args.tiled_rows} (ms a block, median): " + ", ".join(
            f"{k} {v:.4f}" for k, v in spans.items()))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    return report


if __name__ == "__main__":
    main()
