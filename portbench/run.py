"""The benchmark of ``rstnet_tpu_torch``, the PyTorch and CUDA port: one
run of one cell.

    python3 portbench/run.py --workload CELL --seed N --seconds S --trace 0|1

from the root of a checkout. The cell (``BENCHMARK.json``'s ``workloads``)
names a configuration and a traffic mix; ``lib/manifest.py`` finds their
files. The run prints, as the last line of its standard output, one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``,
with ``--trace 1`` a ``breakdown``, and last ``checks``: each number the
check compared, beside its limit. The same numbers end its standard error.

It exits non-zero and prints no result without enough CUDA devices, when a
module of JAX or of the JAX package is loaded, or when the program is not
there. ``--control 1`` (for calibrating limits, never in a benchmark run)
also prints the control's readings. Build and kernel caches stay in fixed
directories inside the checkout.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".portbench_cache"
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = str(CACHE / sub)
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    parser.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    from portbench.lib.guard import forbidden_loaded
    from portbench.lib.manifest import load_cell

    cell = load_cell(ROOT, args.workload)
    import torch

    torch.set_num_threads(1)  # load from one process with few threads

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    from portbench.lib.bench import run_cell

    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START,
                      control=bool(args.control))
    found = forbidden_loaded()
    if found:
        print(f"loaded modules of JAX or of the JAX package: {found}", file=sys.stderr)
        return 3
    if "control" in result:
        print("control " + json.dumps(result["control"]), file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
