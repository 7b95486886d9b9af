"""Opus audio transport over ctypes + libopus (the port's own copy of
``rstnet_tpu/serving/opus.py``, with the PCM16 conversions of
``rstnet_tpu/utils/audio.py``).

The reference duplex server frames audio as Opus over the websocket
(``MLLM_v2/moshi/server.py:80-136`` via ``sphn.OpusStreamWriter/Reader``).
This module provides the same capability without any Python package: a
direct ctypes binding to the system ``libopus``, plus packet framing that
carries one 80 ms model frame (1920 samples at 24 kHz) as four 20 ms Opus
packets inside a single websocket message (``u16le length | packet`` each —
Opus packets are at most 60 ms, so the 80 ms model frame must span several).

``available()`` gates the transport: servers and clients negotiate
``"opus"`` only when libopus loads, falling back to PCM16 otherwise.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import struct
from typing import Optional

import numpy as np

OPUS_APPLICATION_VOIP = 2048
OPUS_APPLICATION_AUDIO = 2049

SAMPLE_RATE = 24000
PACKET_MS = 20
PACKET_SAMPLES = SAMPLE_RATE * PACKET_MS // 1000  # 480
MAX_PACKET_BYTES = 4000  # recommended max opus packet buffer

_lib = None
_load_failed = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    name = ctypes.util.find_library("opus") or "libopus.so.0"
    try:
        lib = ctypes.CDLL(name)
    except OSError:
        _load_failed = True
        return None
    lib.opus_encoder_create.restype = ctypes.c_void_p
    lib.opus_encoder_create.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)
    ]
    lib.opus_encode_float.restype = ctypes.c_int
    lib.opus_encode_float.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ctypes.c_char_p, ctypes.c_int,
    ]
    lib.opus_encoder_destroy.argtypes = [ctypes.c_void_p]
    lib.opus_decoder_create.restype = ctypes.c_void_p
    lib.opus_decoder_create.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)
    ]
    lib.opus_decode_float.restype = ctypes.c_int
    lib.opus_decode_float.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
    ]
    lib.opus_decoder_destroy.argtypes = [ctypes.c_void_p]
    _lib = lib
    return _lib


def available() -> bool:
    """True when the system libopus can be loaded."""
    return _load() is not None


class OpusEncoder:
    """Mono float32 PCM -> Opus packets (one per 20 ms)."""

    def __init__(self, sample_rate: int = SAMPLE_RATE,
                 application: int = OPUS_APPLICATION_VOIP):
        lib = _load()
        if lib is None:
            raise RuntimeError("libopus not available")
        err = ctypes.c_int()
        self._lib = lib
        self._enc = lib.opus_encoder_create(
            sample_rate, 1, application, ctypes.byref(err)
        )
        if err.value != 0 or not self._enc:
            raise RuntimeError(f"opus_encoder_create failed (err={err.value})")
        self.sample_rate = sample_rate
        self.packet_samples = sample_rate * PACKET_MS // 1000

    def encode_packet(self, pcm: np.ndarray) -> bytes:
        """Encode exactly one 20 ms packet worth of float samples."""
        pcm = np.ascontiguousarray(pcm, np.float32)
        assert pcm.shape == (self.packet_samples,), pcm.shape
        buf = ctypes.create_string_buffer(MAX_PACKET_BYTES)
        n = self._lib.opus_encode_float(
            self._enc, pcm.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            self.packet_samples, buf, MAX_PACKET_BYTES,
        )
        if n < 0:
            raise RuntimeError(f"opus_encode_float failed (err={n})")
        return buf.raw[:n]

    def encode_frame(self, pcm: np.ndarray) -> bytes:
        """Encode a model frame (any multiple of 20 ms) into the wire
        payload: length-prefixed packets concatenated."""
        pcm = np.asarray(pcm, np.float32).reshape(-1)
        assert len(pcm) % self.packet_samples == 0, len(pcm)
        out = bytearray()
        for off in range(0, len(pcm), self.packet_samples):
            pkt = self.encode_packet(pcm[off : off + self.packet_samples])
            out += struct.pack("<H", len(pkt)) + pkt
        return bytes(out)

    def __del__(self):  # pragma: no cover - interpreter teardown order
        try:
            if getattr(self, "_enc", None):
                self._lib.opus_encoder_destroy(self._enc)
                self._enc = None
        except Exception:  # noqa: BLE001
            pass


class OpusDecoder:
    """Opus wire payloads -> mono float32 PCM."""

    def __init__(self, sample_rate: int = SAMPLE_RATE):
        lib = _load()
        if lib is None:
            raise RuntimeError("libopus not available")
        err = ctypes.c_int()
        self._lib = lib
        self._dec = lib.opus_decoder_create(sample_rate, 1, ctypes.byref(err))
        if err.value != 0 or not self._dec:
            raise RuntimeError(f"opus_decoder_create failed (err={err.value})")
        self.sample_rate = sample_rate
        self.packet_samples = sample_rate * PACKET_MS // 1000

    def decode_packet(self, packet: bytes) -> np.ndarray:
        out = np.empty(self.packet_samples, np.float32)
        n = self._lib.opus_decode_float(
            self._dec, packet, len(packet),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            self.packet_samples, 0,
        )
        if n < 0:
            raise RuntimeError(f"opus_decode_float failed (err={n})")
        return out[:n]

    def decode_frame(self, payload: bytes) -> np.ndarray:
        """Decode a wire payload (length-prefixed packets) to PCM."""
        chunks = []
        off = 0
        while off + 2 <= len(payload):
            (ln,) = struct.unpack_from("<H", payload, off)
            off += 2
            chunks.append(self.decode_packet(payload[off : off + ln]))
            off += ln
        if not chunks:
            return np.zeros(0, np.float32)
        return np.concatenate(chunks)

    def __del__(self):  # pragma: no cover
        try:
            if getattr(self, "_dec", None):
                self._lib.opus_decoder_destroy(self._dec)
                self._dec = None
        except Exception:  # noqa: BLE001
            pass


# ---------------------------------------------------------------------------
# Transport negotiation: both sides speak "pcm16" always; "opus" when libopus
# loads. The first websocket TEXT message is the client's codec offer; the
# server's TEXT reply is the accepted codec. Legacy clients that open with a
# binary frame get pcm16 (the round-1 wire format) untouched.
# ---------------------------------------------------------------------------


def pcm16_to_float(data: bytes) -> np.ndarray:
    return np.frombuffer(data, np.int16).astype(np.float32) / 32768.0


def float_to_pcm16(audio: np.ndarray) -> bytes:
    return np.clip(np.asarray(audio) * 32767.0, -32768, 32767).astype(np.int16).tobytes()


class Pcm16Transport:
    name = "pcm16"

    def pack(self, pcm: np.ndarray) -> bytes:
        return float_to_pcm16(pcm)

    def unpack(self, payload: bytes) -> np.ndarray:
        return pcm16_to_float(payload)


class OpusTransport:
    name = "opus"

    def __init__(self, sample_rate: int = SAMPLE_RATE):
        self._enc = OpusEncoder(sample_rate)
        self._dec = OpusDecoder(sample_rate)

    def pack(self, pcm: np.ndarray) -> bytes:
        return self._enc.encode_frame(pcm)

    def unpack(self, payload: bytes) -> np.ndarray:
        return self._dec.decode_frame(payload)


def negotiate(offer: str, frame_size: int = SAMPLE_RATE * 80 // 1000) -> str:
    """Server-side codec selection for a client's offer.

    Opus requires libopus AND a model frame that divides into whole 20 ms
    packets (the production 1920-sample frame does; tiny test models may
    not — they fall back to PCM16)."""
    if offer == "opus" and available() and frame_size % PACKET_SAMPLES == 0:
        return "opus"
    return "pcm16"


def make_transport(codec: str):
    return OpusTransport() if codec == "opus" else Pcm16Transport()
