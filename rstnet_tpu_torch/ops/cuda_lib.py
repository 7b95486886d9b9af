"""Build and load the package's hand-written CUDA kernels.

The sources are ``rstnet_tpu_torch/csrc/*.cu``, each with a plain C
interface. At first use they are compiled by ``nvcc`` for Hopper
(``sm_90a``) into one shared library under ``rstnet_tpu_torch/_build/``
(git-ignored), named by a hash of the sources and flags so an edited source
rebuilds, and loaded with ``ctypes``. Nothing here runs at import time, and
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
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
# C signatures (argtypes, restype): every pointer and the stream as void*, so
# ctypes never cuts them to 32 bits
SIGNATURES = {
    "rvq_encode": ([_P, _P, _P, _P, _P, _I, _I, _I, _I, _P], _I),
    "rvq_encode_scratch_floats": ([_I] * 4, _LL),
    "depformer_step": ([_P] * 16 + [_I] * 8 + [_F, _P], _I),
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
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{' '.join(cmd)}\n{res.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a library
    return lib, res.stdout + res.stderr


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
