"""Native (C++) host runtime: fast wav IO, PCM conversion and resampling
(counterpart of ``rstnet_tpu/native/__init__.py``, over its own copy of the
C++ source).

``rstnet_native.cpp`` is compiled at first use with ``g++ -O3 -shared -fPIC
-std=c++17 -pthread`` into ``rstnet_tpu_torch/_build/`` (git-ignored), named
by a hash of the source and flags, and bound through ``ctypes`` (no
pybind11). The library is written under a temporary name and renamed into
place, so processes that start at the same moment (the tokenization jobs of
``tools/run_jobs.py``) never load half a library. ``available()`` gates every
use: without ``g++`` each function returns None and the numpy paths of
``rstnet_tpu_torch/utils/audio.py`` give the answer. This is host code; no
device kernel is here.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_SRC = Path(__file__).resolve().parent / "rstnet_native.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False

_P, _L, _I = ctypes.POINTER, ctypes.c_long, ctypes.c_int
_FP, _IP = _P(ctypes.c_float), _P(ctypes.c_int)
SIGNATURES = {
    "wav_read": ([ctypes.c_char_p, _FP, _L, _IP, _IP], _L),
    "resample_linear": ([_FP, _L, _FP, _L], None),
    "float_to_pcm16": ([_FP, _L, _P(ctypes.c_int16)], None),
    "pcm16_to_float": ([_P(ctypes.c_int16), _L, _FP], None),
    "wav_info": ([ctypes.c_char_p, _IP, _IP], _L),
    "load_codec_batch": ([_P(ctypes.c_char_p), _L, _P(_L), _L, _L, _L, _L, _FP, _FP, _P(_L), _I],
                         None),
}


def library_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"librstnet_native_{digest.hexdigest()[:16]}.so"


def _build(lib: Path) -> bool:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        subprocess.run(["g++", *GXX_FLAGS, str(_SRC), "-o", str(tmp)], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a library
        return True
    except Exception as e:  # noqa: BLE001 - no toolchain: the numpy paths answer
        logging.debug(f"native build failed: {e}")
        return False
    finally:
        tmp.unlink(missing_ok=True)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = library_path()
        if not path.exists() and not _build(path):
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            return None
        for name, (argtypes, restype) in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, restype
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def read_wav(path: str) -> Optional[tuple[np.ndarray, int]]:
    """-> (float32 [channels, T], sr) or None on failure / unavailable."""
    lib = _load()
    if lib is None:
        return None
    try:
        # the sample count is bounded by the file size (8-bit PCM worst case)
        max_samples = max(os.path.getsize(path), 64)
    except OSError:
        return None
    buf = np.empty(max_samples, np.float32)
    sr, ch = ctypes.c_int(0), ctypes.c_int(0)
    n = lib.wav_read(path.encode(), buf.ctypes.data_as(_FP), max_samples, ctypes.byref(sr),
                     ctypes.byref(ch))
    if n < 0:
        return None
    return buf[:n].reshape(-1, max(ch.value, 1)).T.copy(), sr.value


def resample_linear(wav: np.ndarray, sr_in: int, sr_out: int) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    if sr_in == sr_out:
        return wav.astype(np.float32)
    n_out = int(round(wav.shape[-1] * sr_out / sr_in))
    out = np.empty(wav.shape[:-1] + (n_out,), np.float32)
    for idx in np.ndindex(wav.shape[:-1]):
        src = np.ascontiguousarray(wav[idx], np.float32)
        lib.resample_linear(src.ctypes.data_as(_FP), src.shape[0], out[idx].ctypes.data_as(_FP),
                            n_out)
    return out


def float_to_pcm16(audio: np.ndarray) -> Optional[bytes]:
    lib = _load()
    if lib is None:
        return None
    src = np.ascontiguousarray(audio.reshape(-1), np.float32)
    out = np.empty(src.shape[0], np.int16)
    lib.float_to_pcm16(src.ctypes.data_as(_FP), src.shape[0],
                       out.ctypes.data_as(_P(ctypes.c_int16)))
    return out.tobytes()


def pcm16_to_float(data: bytes) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    src = np.frombuffer(data, np.int16)
    out = np.empty(src.shape[0], np.float32)
    lib.pcm16_to_float(src.ctypes.data_as(_P(ctypes.c_int16)), src.shape[0],
                       out.ctypes.data_as(_FP))
    return out


def wav_info(path: str) -> Optional[tuple[int, int, int]]:
    """-> (n_frames, sample_rate, channels) from the header only, or None."""
    lib = _load()
    if lib is None:
        return None
    sr, ch = ctypes.c_int(0), ctypes.c_int(0)
    n = lib.wav_info(path.encode(), ctypes.byref(sr), ctypes.byref(ch))
    if n < 0:
        return None
    return int(n), sr.value, ch.value


def load_codec_batch(paths: list[str], starts: list[int], seg24: int, seg16: int,
                     sr_main: int = 24000, sr_side: int = 16000, n_threads: int = 8,
                     ) -> Optional[tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Parallel codec segment loader: a windowed read and the 24k/16k
    resample in C++ worker threads, the GIL released for the whole batch.

    -> (batch24 [N, seg24], batch16 [N, seg16], status [N]; status[i]=0 ok)
    or None when the native library is unavailable.
    """
    lib = _load()
    if lib is None:
        return None
    n = len(paths)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    c_starts = np.asarray(starts, np.int64)
    out24 = np.empty((n, seg24), np.float32)
    out16 = np.empty((n, seg16), np.float32)
    status = np.empty(n, np.int64)
    lib.load_codec_batch(c_paths, n, c_starts.ctypes.data_as(_P(_L)), seg24, seg16, sr_main,
                         sr_side, out24.ctypes.data_as(_FP), out16.ctypes.data_as(_FP),
                         status.ctypes.data_as(_P(_L)), n_threads)
    return out24, out16, status
