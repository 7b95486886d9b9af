"""Build and load the package's hand-written CUDA kernels.

The sources are ``rstnet_tpu_torch/csrc/*.cu``, each with a plain C
interface. At first use they are compiled by ``nvcc`` for Hopper
(``sm_90a``), one ``nvcc`` per source, all started together, and linked into
one shared library under ``rstnet_tpu_torch/_build/`` (git-ignored), named
by a hash of the sources and flags so an edited source rebuilds, and loaded
with ``ctypes``. Nothing here runs at import time, and
nothing is built on a machine without a GPU: only the CUDA path of a kernel
wrapper calls :func:`kernel_library`.

Every C entry point launches on the stream it is given and returns the
``cudaGetLastError()`` status after its launches; :func:`check` turns a
non-zero status into an exception.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
# C signatures (argtypes, restype): every pointer and the stream as void*, so
# ctypes never cuts them to 32 bits
SIGNATURES = {
    "rvq_encode": ([_P] * 5 + [_I] * 5 + [_P], _I),
    "rvq_encode_scratch_bytes": ([_I] * 5, _LL),
    "depformer_step": ([_P] * 13 + [_I] * 8 + [_F, _P], _I),
    "depformer_step_int8": ([_P] * 18 + [_I] * 8 + [_F, _P], _I),
    "gating_ffn_step": ([_P] * 6 + [_I] * 7 + [_P], _I),
    "gating_ffn": ([_P] * 6 + [_I] * 7 + [_P], _I),
    "gating_ffn_int8": ([_P] * 9 + [_I] * 5 + [_P], _I),
    "flash_attention_fwd": ([_P] * 6 + [_I] * 7 + [_P], _I),
    "flash_attention_bwd": ([_P] * 13 + [_I] * 7 + [_P], _I),
}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    nvcc = shutil.which("nvcc") or str(Path(cuda_home) / "bin" / "nvcc")
    if not Path(nvcc).exists():
        raise RuntimeError(f"nvcc not found (looked on PATH and in {cuda_home}/bin)")
    return nvcc


def build() -> tuple[Path, str]:
    """Compile the sources if the library is missing; returns (path, the
    compiler's output, empty when the library was already built)."""
    sources = sorted(SRC_DIR.glob("*.cu"))
    digest = hashlib.sha256()
    for src in sorted(SRC_DIR.glob("*.cu*")):
        digest.update(src.name.encode() + src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    lib = BUILD_DIR / f"librstnet_kernels_{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"{digest.hexdigest()[:16]}.{os.getpid()}"
    objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in sources]
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True))
             for cmd in ([nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)]
                         for src, o in zip(sources, objs))]
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    link = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
    out = []
    try:
        for cmd, proc in procs:
            out.append(proc.communicate()[0])
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out[-1]}")
        res = subprocess.run(link, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"link failed ({res.returncode}):\n{' '.join(link)}\n{res.stderr}")
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for o in objs:
            o.unlink(missing_ok=True)
    os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a library
    return lib, "".join(out)


@functools.lru_cache(maxsize=None)
def kernel_library() -> ctypes.CDLL:
    """The compiled kernels, built on first call, with every entry point's
    ``argtypes`` and ``restype`` declared."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, (argtypes, restype) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def check(status: int, name: str) -> None:
    if status != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {status}")
