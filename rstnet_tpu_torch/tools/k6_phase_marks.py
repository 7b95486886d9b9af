"""Where a pair's time goes in K6's backward on the card.

    python -m rstnet_tpu_torch.tools.k6_phase_marks [--dtype f32|bf16]
        [--head-dim 64|128] [--heads H,HKV] [--batch 2,4] [--window 1024]
        [--calls 3] [--baseline FILE] [--out F.json]

Copies ``csrc/flash_attention.cu`` into a build directory outside the
package (``$TMPDIR``), compiles it with ``RSTNET_K6_MARKS`` defined, and
runs its backward (called as ``ops/cuda_flash.py`` calls it, with the
scratch that every design of the kernel reads) at a training shape on
seeded random inputs, ``--calls`` times, reading the marks of the last call (see ``k6_marks`` in the source). Three kernels
carry marks: the float32 backward at head dim 64 (``flash_bwd_f32``,
``--dtype f32``, the default, at 32 query heads over 8 KV heads, T=1024),
the float32 backward at head dim 128 (``flash_bwd_f32_d128``, ``--dtype f32
--head-dim 128``, at Qwen2.5-7B's 28 query heads over 4 KV heads by
default) and the bf16 backward at head dim 128 (``flash_bwd_wgmma_d128``,
``--dtype bf16``, the same heads). ``--baseline FILE`` builds that file
instead, a ``flash_attention.cu`` of an earlier design: with ``--dtype
bf16``, the bf16 design of items of 64 columns (``git show
d4806ed:rstnet_tpu_torch/csrc/flash_attention.cu``), into whose bf16
backward the same eight marks are inserted first
(``mark_column_half_bwd``); with ``--dtype f32 --head-dim 128``, the float32
design whose two warpgroups each formed S^T and dP^T for their own 64
columns (``git show fce3b72:rstnet_tpu_torch/csrc/flash_attention.cu``),
whose float32 backward carries its marks already.

A pair is one (query head, 64-row query tile) visited by a work item.
Printed for each consumer warpgroup of the block that ran the most pairs
(the critical path under a causal mask), as medians over its pairs, in SM
cycles and microseconds at the SM clock measured over the call (clock64
against the global timer): the ring's full wait, the S^T and dP^T products,
the elementwise phase and what follows it, to the pair's end (see
``k6_marks`` in the source, and ``PHASES`` here, for each design's spans),
and the whole pair; then the dQ writers' spans over all blocks: the wait
for their turn, for the consumers, and the store. Also each block's span
and pairs, and when the longest block began each of its pairs (gaps there
are waits between items). The marks themselves cost a little: compare
totals with ``chip_smoke.py``'s times, not with these.
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
PHASES = {
    "f32": ("ring wait", "S^T, dP^T products", "elementwise, P^T parts", "dS^T parts to smem",
            "dV, dK, dQ products", "slot wait", "stage dQ half"),
    "f32 d128": ("P^T formed and stored (wg 0); dP^T - delta, P^T in, dS^T (wg 1)",
                 "dV issued, dS^T in (wg 0); dS^T's parts stored, barrier (wg 1)",
                 "dK issued (wg 0); dQ issued (wg 1)",
                 "the next pair's ring wait and first product issued",
                 "this pair's products done", "wg 1 waits for wg 0's dV and dK",
                 "dQ partial staged (wg 1), the next first product done"),
    "bf16": ("ring wait", "S^T products", "P^T, dV issued, dS^T to smem",
             "dK issued, both dS^T in, dQ slot ready", "dQ product, all three done",
             "dQ into the slot", "hand-off"),
    "bf16 baseline": ("ring wait", "S^T, dP^T products", "elementwise, dS^T to smem",
                      "dV, dK issued, other warpgroup's dS^T", "dQ product, all three done",
                      "slot wait", "stage dQ partial"),
}
WRITER_SPANS = {"f32": ("turn wait", "partial wait", "add and store"),
                "f32 d128": ("turn wait", "partial wait", "TMA read of the partial"),
                "bf16": ("turn wait, sum loaded", "consumers' parts", "store"),
                "bf16 baseline": ("turn wait", "partial wait", "add and store")}
T = 1024
DEFAULT_HEADS = {64: (32, 8), 128: (28, 4)}

# Edits that mark the earlier bf16 backward (one template for both head
# dims, items of 64 columns at D = 128) where flash_bwd_wgmma_d128 is
# marked: (that source's text, the text with the mark).
_RING_WAIT = "      mbar_wait(&sm.full[s], (slot / Stages) & 1);\n"
_BASELINE_MARKS = (
    (_RING_WAIT + "      // S^T = K Q^T and dP^T = V dO^T (64 keys x 64 queries)\n",
     "      K6_MARK(0);\n" + _RING_WAIT + "      K6_MARK(1);\n"
     "      // S^T = K Q^T and dP^T = V dO^T (64 keys x 64 queries)\n"),
    ("      // P^T = exp2(S^T log2(e) - lse log2(e)), dS^T = P^T (dP^T - delta);\n"
     "      // columns are queries: a thread's 16 columns' lse and delta, once\n",
     "      K6_MARK(2);\n"
     "      // P^T = exp2(S^T log2(e) - lse log2(e)), dS^T = P^T (dP^T - delta);\n"
     "      // columns are queries: a thread's 16 columns' lse and delta, once\n"),
    ("      // dV += P^T dO, dK += dS^T Q over the item's columns: the group's sum,\n",
     "      K6_MARK(3);\n"
     "      // dV += P^T dO, dK += dS^T Q over the item's columns: the group's sum,\n"),
    ("      named_sync(1, kConsumers);\n      float dqp[16];\n",
     "      named_sync(1, kConsumers);\n      K6_MARK(4);\n      float dqp[16];\n"),
    ("      mbar_arrive(&sm.empty[s]);\n"
     "      // the partial to its writer warp, through one of the staging slots\n"
     "      const int b = slot % Slots;\n"
     "      mbar_wait(&sm.dq_empty[b], ((slot / Slots) & 1) ^ 1);\n",
     "      mbar_arrive(&sm.empty[s]);\n      K6_MARK(5);\n"
     "      const int b = slot % Slots;\n"
     "      mbar_wait(&sm.dq_empty[b], ((slot / Slots) & 1) ^ 1);\n      K6_MARK(6);\n"),
    ("      mbar_arrive(&sm.dq_full[b]);\n    }\n",
     "      mbar_arrive(&sm.dq_full[b]);\n      K6_MARK(7);\n    }\n"),
    ("    const int item = sm.item;\n    if (item >= geo.n_items) return;\n",
     "    const int item = sm.item;\n"
     "    if (item >= geo.n_items) {\n      K6_SPAN_MARK(1);\n      return;\n    }\n"),
    ("  __syncthreads();\n\n  if (threadIdx.x >= kConsumers) {  // warpgroup 2: the producer "
     "warp and the dQ writers\n    regs_dec<80>();\n",
     "  __syncthreads();\n  K6_SPAN_MARK(0);\n\n  if (threadIdx.x >= kConsumers) {  // warpgroup 2: "
     "the producer warp and the dQ writers\n    regs_dec<80>();\n"),
    ("if (Halves == 2 && lane == 0", "if (lane == 0"),  # writer marks for one-half partials
)


def mark_column_half_bwd(text: str) -> str:
    """The earlier source with K6_MARK(0..7) in its bf16 backward's pair
    loop, the span marks at its consumers' start and end, and writer marks
    for its one-half dQ partials."""
    for old, new in _BASELINE_MARKS:
        if text.count(old) != 1:
            raise ValueError(f"not the column-half source: {old.splitlines()[0].strip()!r}")
        text = text.replace(old, new)
    return text


def build_marked(source: Path | None = None, insert_marks: bool = True) -> ctypes.CDLL:
    """The marked build of ``csrc/flash_attention.cu``, or of ``source``
    (marks inserted first unless ``insert_marks`` is false)."""
    out = Path(os.environ.get("TMPDIR", tempfile.gettempdir())) / "rstnet_k6_marks"
    out.mkdir(parents=True, exist_ok=True)
    tag = "baseline" if source else "current"
    src = out / f"flash_attention_{tag}.cu"
    if source is None:
        shutil.copy(cuda_lib.SRC_DIR / "flash_attention.cu", src)
    elif insert_marks:
        src.write_text(mark_column_half_bwd(Path(source).read_text()))
    else:
        shutil.copy(source, src)
    lib = out / f"libk6_marks_{tag}.so"
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


def backward(dll, q, k, v, o, do, lse, window: int) -> None:
    """One backward through ``dll`` with the scratch of every design, this
    source's and the earlier ones: a float32 dQ workspace at each dtype and
    head dim (float32 at head dim 128 no longer reads one), zeroed counters,
    float32's planes."""
    (B, H, T_, D), Hkv = q.shape, k.shape[1]
    f32 = q.dtype == torch.float32
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty_like(lse)
    dq_acc = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    counters = torch.zeros(B * H * (T_ // cuda_flash.DQ_TILE) * (D // 64) + 1, dtype=torch.int32,
                           device=q.device)
    planes = (torch.empty(4 * (q.numel() + k.numel()), dtype=torch.bfloat16, device=q.device)
              if f32 else None)
    status = dll.flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), dq_acc.data_ptr(),
        counters.data_ptr(), planes.data_ptr() if f32 else None, B, H, Hkv, T_, window, D,
        int(f32), torch.cuda.current_stream().cuda_stream)
    cuda_lib.check(status, "flash_attention_bwd (marked)")


def run(dll, B: int, heads: tuple, D: int, dtype, window: int, calls: int, g) -> tuple:
    """(consumer marks [blocks][2][pairs][8], writer marks [blocks][pairs][4],
    spans [blocks][4]) of the last of ``calls`` backward calls of the
    marked build (the forward through the package's kernels)."""
    H, Hkv = heads
    q, do = (torch.randn((B, H, T, D), device="cuda", generator=g).to(dtype) for _ in range(2))
    k, v = (torch.randn((B, Hkv, T, D), device="cuda", generator=g).to(dtype) for _ in range(2))
    q = (q * D**-0.5).to(dtype)
    o, lse = cuda_flash.flash_attention_fwd(q, k, v, window)
    for _ in range(calls):
        backward(dll, q, k, v, o, do, lse, window)
    torch.cuda.synchronize()
    marks = np.zeros((MARK_BLOCKS, 2, MARK_PAIRS, 8), dtype=np.int64)
    writer = np.zeros((MARK_BLOCKS, MARK_PAIRS, 4), dtype=np.int64)
    spans = np.zeros((MARK_BLOCKS, 4), dtype=np.int64)
    cuda_lib.check(dll.k6_marks_copy(marks.ctypes.data, writer.ctypes.data, spans.ctypes.data),
                   "k6_marks_copy")
    return marks, writer, spans


def report(marks, writer, spans, kind: str) -> dict:
    used = spans[:, 1] > 0
    ghz = float(np.median((spans[used, 1] - spans[used, 0]) / (spans[used, 3] - spans[used, 2])))
    pairs = (marks[:, 0, :, 7] > 0).sum(axis=1)
    b = int(np.argmax(pairs))
    n = int(pairs[b])
    out = {"sm_ghz": ghz, "block": b, "pairs": n, "call_us": float(
        np.median(spans[used, 3] - spans[used, 2]) / 1e3),
        # the whole call: first block's start to last block's end
        "first_to_last_us": float((spans[used, 3].max() - spans[used, 2].min()) / 1e3),
        "block_us_max": float((spans[used, 3] - spans[used, 2]).max() / 1e3),
        "pairs_max_min": [int(pairs.max()), int(pairs[used].min())],
        # each block's start and end (us from the first start) and pairs
        "blocks": [[float((spans[i, 2] - spans[used, 2].min()) / 1e3),
                    float((spans[i, 3] - spans[used, 2].min()) / 1e3), int(pairs[i])]
                   for i in np.flatnonzero(used)], "warpgroups": []}
    # the longest block's pairs: when warpgroup 0 began each (us from its start)
    lb = int(np.flatnonzero(used)[np.argmax((spans[used, 3] - spans[used, 2]))])
    starts = marks[lb, 0, :int(pairs[lb]), 0].astype(np.float64)
    out["longest_block"] = {"block": lb, "pair_starts_us": [
        float((c - spans[lb, 0]) / (ghz * 1e3)) for c in starts]}
    for wg in range(2):
        m = marks[b, wg, :n].astype(np.float64)
        times = {name: float(np.median(m[:, i + 1] - m[:, i]))
                 for i, name in enumerate(PHASES[kind])}
        times["pair"] = float(np.median(m[1:, 0] - m[:-1, 0])) if n > 1 else float("nan")
        out["warpgroups"].append(times)
    w = writer.reshape(-1, 4).astype(np.float64)
    w = w[(w[:, 3] > 0) & (w[:, 0] > 0)]
    out["writers"] = {name: float(np.median(w[:, i + 1] - w[:, i]))
                      for i, name in enumerate(WRITER_SPANS[kind])}
    return out


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--dtype", choices=("f32", "bf16"), default="f32")
    parser.add_argument("--head-dim", type=int, choices=(64, 128), default=None,
                        help="64 for f32, 128 for bf16 by default (the marked kernels)")
    parser.add_argument("--heads", default=None, help="H,HKV (32,8 at D=64, 28,4 at D=128)")
    parser.add_argument("--batch", default="2,4", help="B of each case")
    parser.add_argument("--window", type=int, default=T, help="keys visible to a query")
    parser.add_argument("--calls", type=int, default=3)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--baseline", default=None,
                        help="build this flash_attention.cu of an earlier design instead (bf16: "
                        "the column-half design; f32 at head dim 128: the design of a warpgroup a "
                        "column half)")
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    D = args.head_dim or (64 if args.dtype == "f32" else 128)
    if args.dtype == "bf16" and D != 128:
        raise SystemExit("the bf16 backward carries marks at head dim 128 only")
    heads = tuple(int(x) for x in args.heads.split(",")) if args.heads else DEFAULT_HEADS[D]
    dtype = torch.float32 if args.dtype == "f32" else torch.bfloat16
    if not torch.cuda.is_available():
        raise SystemExit("k6_phase_marks needs a CUDA device")
    # the earlier float32 source carries its marks; the earlier bf16 one gets them
    dll = build_marked(args.baseline, insert_marks=args.dtype == "bf16")
    g = torch.Generator(device="cuda").manual_seed(args.seed)
    result = {"device": torch.cuda.get_device_name(0), "dtype": args.dtype, "head_dim": D,
              "heads": heads, "source": args.baseline or "csrc/flash_attention.cu", "cases": {}}
    for B in (int(v) for v in args.batch.split(",")):
        if args.dtype == "bf16":
            kind = "bf16 baseline" if args.baseline else "bf16"
        else:  # float32: the D = 64 kernel, or the earlier design at D = 128: the same marks
            kind = "f32 d128" if D == 128 and not args.baseline else "f32"
        r = report(*run(dll, B, heads, D, dtype, args.window, args.calls, g), kind)
        result["cases"][f"B={B} window={args.window}"] = r
        us = lambda c: c / (r["sm_ghz"] * 1e3)  # noqa: E731
        print(f"{args.dtype} D={D} H={heads[0]}/{heads[1]} B={B} window={args.window}: a block "
              f"{r['call_us']:.1f} us (median; longest {r['block_us_max']:.1f}, first start to last "
              f"end {r['first_to_last_us']:.1f}), SM {r['sm_ghz']:.3f} GHz; pairs a block "
              f"{r['pairs_max_min'][1]}-{r['pairs_max_min'][0]}; block {r['block']} (cycles, us a "
              "pair, median):")
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
