"""Does ptxas allocate a warp-specialised kernel's consumers above the
launch's register share when they ask for more with ``setmaxnreg``?

    python -m rstnet_tpu_torch.tools.k6_registers [--out F.json]

K6's kernels launch 384 threads a block (``__launch_bounds__(384, 1)``: 168
registers a thread), and their consumer warpgroups ask for more with
``setmaxnreg.inc`` once the producer's warpgroup has given its own away
with ``setmaxnreg.dec``. This builds a small kernel of the same shape
outside the package (``$TMPDIR``): two consumer warpgroups whose loop keeps
three 64 x 128 float32 ``wgmma`` accumulators live (192 floats a thread),
once with ``setmaxnreg`` (dec 24 / inc 240, as FlashAttention-3's head-dim
128 kernels) and once without, and reports for each what ``-Xptxas -v``
says (registers, spill stores and loads), what the SASS holds
(``cuobjdump -sass``: the highest register named, local-memory loads and
stores), and runs both on the card once: each writes the same sums, which
must agree bit for bit.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import tempfile
from pathlib import Path

import torch

from rstnet_tpu_torch.ops import cuda_lib

SOURCE = r"""
#include <cuda_bf16.h>
#include <stdint.h>
using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ uint64_t desc_k(const void* p) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// 384 threads: warpgroups 0-1 compute, warpgroup 2 leaves (after giving its
// registers away when SETMAXNREG is defined)
extern "C" __global__ void __launch_bounds__(384, 1) probe(float* out, int iters) {
  __shared__ alignas(1024) bf16 a[64 * 64];
  __shared__ alignas(1024) bf16 b[128 * 64];
  for (int i = threadIdx.x; i < 64 * 64; i += blockDim.x) a[i] = __float2bfloat16((i % 7) * 0.125f);
  for (int i = threadIdx.x; i < 128 * 64; i += blockDim.x) b[i] = __float2bfloat16((i % 5) * 0.25f);
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();
  if (threadIdx.x >= 256) {
#ifdef SETMAXNREG
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
#endif
    return;
  }
#ifdef SETMAXNREG
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
#endif
  float x[64], y[64], z[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) x[e] = y[e] = z[e] = 0.f;
  for (int it = 0; it < iters; ++it) {
    fence_regs(x);
    fence_regs(y);
    fence_regs(z);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_n128(x, desc_k(a) + 2 * kk, desc_k(b) + 2 * kk);
      wgmma_n128(y, desc_k(a) + 2 * kk, desc_k(b) + 2 * kk);
      wgmma_n128(z, desc_k(a) + 2 * kk, desc_k(b) + 2 * kk);
    }
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    fence_regs(x);
    fence_regs(y);
    fence_regs(z);
#pragma unroll
    for (int e = 0; e < 64; ++e) {
      x[e] *= 0.5f;
      y[e] = y[e] * 0.25f + x[e];
      z[e] = z[e] * 0.125f - y[e];
    }
  }
  float* o = out + (blockIdx.x * 256 + threadIdx.x) * 192;
#pragma unroll
  for (int e = 0; e < 64; ++e) {
    o[e] = x[e];
    o[64 + e] = y[e];
    o[128 + e] = z[e];
  }
}
"""

VARIANTS = {"setmaxnreg dec 24 / inc 240": ["-DSETMAXNREG"], "no setmaxnreg": []}


def build(out: Path, name: str, defines: list) -> dict:
    lib = out / f"probe_{name}.so"
    flags = [f for f in cuda_lib.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    res = subprocess.run([cuda_lib._nvcc(), *flags, "-Xptxas", "-v", *defines, "-shared", "-o",
                          str(lib), str(out / "probe.cu")], capture_output=True, text=True,
                         check=True)
    ptxas = [ln.strip() for ln in res.stderr.splitlines() if "ptxas info" in ln and (
        "registers" in ln or "spill" in ln.lower())]
    cuobjdump = Path(cuda_lib._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    regs = [int(r) for r in re.findall(r"\bR(\d+)\b", sass)]
    return {"lib": str(lib), "ptxas": ptxas, "sass_max_register": max(regs) if regs else None,
            "sass_local_stores": len(re.findall(r"\bSTL\b", sass)),
            "sass_local_loads": len(re.findall(r"\bLDL\b", sass)),
            "sass_setmaxnreg": len(re.findall(r"USETMAXREG|SETMAXREG", sass))}


def run(lib: str, blocks: int, iters: int) -> torch.Tensor:
    import ctypes

    dll = ctypes.CDLL(lib)
    out = torch.zeros(blocks * 256 * 192, device="cuda")
    fn = dll.probe_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    cuda_lib.check(fn(out.data_ptr(), blocks, iters), "probe")
    torch.cuda.synchronize()
    return out


LAUNCHER = r"""
extern "C" int probe_launch(float* out, int blocks, int iters) {
  probe<<<blocks, 384>>>(out, iters);
  return static_cast<int>(cudaGetLastError());
}
"""


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    out = Path(os.environ.get("TMPDIR", tempfile.gettempdir())) / "rstnet_k6_registers"
    out.mkdir(parents=True, exist_ok=True)
    (out / "probe.cu").write_text(SOURCE + LAUNCHER)
    result = {"variants": {}}
    for i, (name, defines) in enumerate(VARIANTS.items()):
        r = build(out, f"v{i}", defines)
        result["variants"][name] = r
        print(f"{name}: ptxas {r['ptxas']}; SASS: highest register R{r['sass_max_register']}, "
              f"{r['sass_local_stores']} STL, {r['sass_local_loads']} LDL, "
              f"{r['sass_setmaxnreg']} SETMAXREG")
    if torch.cuda.is_available():
        result["device"] = torch.cuda.get_device_name(0)
        sums = [run(r["lib"], 132, 64) for r in result["variants"].values()]
        result["same_results"] = bool(torch.equal(*sums))
        result["finite"] = bool(all(torch.isfinite(s).all() for s in sums))
        print(f"ran both on {result['device']}: results bit-identical {result['same_results']}, "
              f"finite {result['finite']}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    return result


if __name__ == "__main__":
    main()
