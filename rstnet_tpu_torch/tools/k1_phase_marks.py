"""Where a K1 micro-step's time goes, phase by phase, on the card.

    python -m rstnet_tpu_torch.tools.k1_phase_marks [--shape moshi|flagship]
        [--int8] [--frames N] [--out F.json]

Copies ``csrc/depformer_step.cu`` into a build directory outside the package
(``$TMPDIR``), compiles it with ``RSTNET_DEP_MARKS`` defined, and runs frames
of 8 micro-steps at full width with seeded random weights. In that build,
thread 0 of every block writes the GPU's global timer (ns) at points of each
phase: its start, its tagged inputs all arrived, its input vector ready
(RMS, attention or a cast), all warps done; the time warp 0 waited for
weights; and thread 0's cycles in its row dots, in the syncs after them and
in the outputs' epilogue. Printed per phase kind, as means over blocks,
layers, micro-steps and frames: prep (start -> vector; of which waiting for
inputs), rows (vector -> done) and its parts, the hand-off (the previous
phase's last block done -> this block's inputs arrived), each layer, and the
whole micro-step.
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

KINDS = ("qkv", "out", "gin", "gout")
SHAPES = {"moshi": dict(L=6, S=8, C=1024, heads=16, H=2816, card=2048),
          "flagship": dict(L=6, S=8, C=1024, heads=16, H=768, card=2048)}


def build_marked() -> ctypes.CDLL:
    out = Path(os.environ.get("TMPDIR", tempfile.gettempdir())) / "rstnet_k1_marks"
    out.mkdir(parents=True, exist_ok=True)
    src = out / "depformer_step.cu"
    shutil.copy(cuda_lib.SRC_DIR / "depformer_step.cu", src)
    lib = out / "libk1_marks.so"
    flags = [f for f in cuda_lib.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    subprocess.run([cuda_lib._nvcc(), *flags, "-DRSTNET_DEP_MARKS", "-shared", "-o", str(lib),
                    str(src)], check=True)
    dll = ctypes.CDLL(str(lib))
    for name in ("depformer_step", "depformer_step_int8"):
        fn = getattr(dll, name)
        fn.argtypes, fn.restype = cuda_lib.SIGNATURES[name]
    return dll


def operands(shape: str, int8: bool, seed: int):
    from rstnet_tpu_torch.modules.transformer import quantize_weight_int8

    d = SHAPES[shape]
    L, S, C, H, card = d["L"], d["S"], d["C"], d["H"], d["card"]
    g = torch.Generator(device="cuda").manual_seed(seed)

    def uni(*shape_, fan_in):
        return ((torch.rand(shape_, device="cuda", generator=g) * 2 - 1) * fan_in**-0.5
                ).bfloat16()

    w = {"in_proj": uni(L, S * 3 * C, C, fan_in=C), "out_proj": uni(L, S * C, C, fan_in=C),
         "gin": uni(L, S, 2 * H, C, fan_in=C), "gout": uni(L, S, C, H, fan_in=H),
         "head_w": uni(S, card, C, fan_in=C)}
    scales = None
    if int8:
        q = {k: quantize_weight_int8(v) for k, v in w.items()}
        w = {k: v.w_int8 for k, v in q.items()}
        scales = [q[k].scale.float().contiguous() for k in w]
    norms = [1 + 0.1 * torch.randn((L, C), device="cuda", generator=g) for _ in range(2)]
    head_b = 0.1 * torch.randn((S, card), device="cuda", generator=g)
    xs = torch.randn((S, 1, C), device="cuda", generator=g).bfloat16()
    return d, w, scales, norms, head_b, xs


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--shape", choices=sorted(SHAPES), default="moshi")
    parser.add_argument("--int8", action="store_true")
    parser.add_argument("--frames", type=int, default=4)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", default="")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this tool reads the kernel's phase marks on a GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    lib = build_marked()
    d, w, scales, (n1, n2), head_b, xs = operands(args.shape, args.int8, args.seed)
    L, S, C, H, card_n, heads = d["L"], d["S"], d["C"], d["H"], d["card"], d["heads"]
    blocks = torch.cuda.get_device_properties(0).multi_processor_count
    n_phases = 4 * L + 1
    logits = torch.empty(card_n, device="cuda")
    head = 16 + 4 * C + H  # the kernel's scratch: launch count, tagged activations
    scratch = torch.zeros(head + blocks * n_phases * 10, device="cuda", dtype=torch.int64)
    stream = torch.cuda.current_stream().cuda_stream
    fn = lib.depformer_step_int8 if args.int8 else lib.depformer_step
    runs = []
    for frame in range(args.frames + 1):  # the first frame warms up
        kc, vc = (torch.zeros((L, S, C), device="cuda") for _ in range(2))
        for cb in range(S):
            ptrs = [t.data_ptr() for t in (xs[cb], n1, w["in_proj"], w["out_proj"], n2, w["gin"],
                                           w["gout"], w["head_w"], head_b, kc, vc, logits,
                                           scratch)]
            extra = [s.data_ptr() for s in scales] if args.int8 else []
            status = fn(*ptrs, *extra, L, S, C, H, card_n, heads, cb, 0, 1e-8, stream)
            cuda_lib.check(status, "depformer_step (marks)")
            torch.cuda.synchronize()
            if frame:
                runs.append(scratch[head:].view(blocks, n_phases, 10).cpu().numpy()
                            .astype(np.float64))
    m = np.stack(runs)  # [runs, blocks, phases, 10], ns (clock64 cycles in 8, 9)
    last_done = m[..., 3].max(1, keepdims=True)  # the last block done, a phase
    per = {
        "prep": m[..., 1] - m[..., 0],
        "inputs_arrived": m[..., 4] - m[..., 0],
        "rows": m[..., 3] - m[..., 1],
        "waiting_for_weights": m[..., 2],
    }
    # thread 0's cycles, as ns at the block's own clock
    ghz = (m[:, :, -1:, 9] - m[:, :, :1, 8]) / (m[:, :, -1:, 3] - m[:, :, :1, 0])
    per.update(dots=m[..., 5] / ghz, syncs_after_dots=m[..., 6] / ghz,
               epilogue=m[..., 7] / ghz)
    # a phase's inputs arriving after the previous phase's last writer was done
    handoff = m[:, :, 1:, 4] - last_done[:, :, :-1]
    report = {"card": card, "shape": args.shape, "int8": args.int8, "blocks": blocks,
              "micro_steps": len(runs), "phases": {}}
    for k, kind in enumerate(KINDS + ("head",)):
        idx = [ph for ph in range(n_phases) if (ph == n_phases - 1) == (kind == "head")
               and (kind == "head" or ph % 4 == k)]
        report["phases"][kind] = {name: float(v[:, :, idx].mean() / 1000)
                                  for name, v in per.items()}
        after = [ph - 1 for ph in idx if ph > 0]
        report["phases"][kind]["handoff"] = float(handoff[:, :, after].mean() / 1000)
    step_us = (m[:, :, -1, 3].max(1) - m[:, :, 0, 0].min(1)) / 1000
    report["micro_step_us"] = float(step_us.mean())
    report["layer_us"] = [float((m[:, :, 4 * l + 3, 3] - m[:, :, 4 * l, 0]).mean() / 1000)
                          for l in range(L)]
    report["handoffs_us_a_step"] = float(handoff.mean(1).sum(1).mean() / 1000)
    # the SM clock over each block's run: cycles over nanoseconds
    report["sm_clock_mhz"] = float(((m[:, :, -1, 9] - m[:, :, 0, 8])
                                    / (m[:, :, -1, 3] - m[:, :, 0, 0])).mean() * 1000)
    print(json.dumps(report, indent=1))
    print(f"K1 marks ({args.shape}, {'int8' if args.int8 else 'bf16'}): micro-step "
          f"{report['micro_step_us']:.2f} us, of which hand-offs {report['handoffs_us_a_step']:.2f} "
          f"us (means over blocks) [{card}]")
    if args.out:
        Path(args.out).write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
