"""The port's Opus wire transport (``rstnet_tpu_torch/serving/opus.py``, a
copy of ``rstnet_tpu/serving/opus.py``), mirroring ``tests/test_opus.py``
with its thresholds (a 0.98 correlation at the best lag, PCM16 within 1e-4),
and held to the JAX module: the same encoded packets from the same frames,
the same decoded samples, the same negotiation. The websocket tests run
against the port's server."""

import tests.test_torch_threads  # noqa: F401 - first: one torch CPU thread a process

import asyncio

import numpy as np
import pytest

from rstnet_tpu.serving import opus as jax_opus
from rstnet_tpu_torch.serving import opus

requires_opus = pytest.mark.skipif(not opus.available(), reason="libopus not present")


@requires_opus
def test_opus_stream_roundtrip_correlation():
    enc, dec = opus.OpusEncoder(), opus.OpusDecoder()
    jenc, jdec = jax_opus.OpusEncoder(), jax_opus.OpusDecoder()
    sr = opus.SAMPLE_RATE
    n = 1920 * 12
    t = np.arange(n) / sr
    sig = (0.3 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
    out = []
    for off in range(0, n, 1920):
        wire = enc.encode_frame(sig[off: off + 1920])
        assert len(wire) < 1920  # far below the 3840-byte PCM16 frame
        assert wire == jenc.encode_frame(sig[off: off + 1920])
        decoded = dec.decode_frame(wire)
        assert decoded.shape == (1920,)
        np.testing.assert_array_equal(decoded, jdec.decode_frame(wire))
        out.append(decoded)
    out = np.concatenate(out)
    # the codec has algorithmic delay; correlate at the best lag
    best = max(range(0, 400), key=lambda lag: np.corrcoef(out[lag:], sig[: len(sig) - lag])[0, 1])
    c = np.corrcoef(out[best:], sig[: len(sig) - best])[0, 1]
    assert c > 0.98


@requires_opus
def test_opus_frame_must_be_packet_multiple():
    enc = opus.OpusEncoder()
    with pytest.raises(AssertionError):
        enc.encode_frame(np.zeros(100, np.float32))


def test_pcm16_transport_roundtrip():
    tr = opus.Pcm16Transport()
    pcm = (0.25 * np.sin(np.linspace(0, 20, 1920))).astype(np.float32)
    wire = tr.pack(pcm)
    assert wire == jax_opus.Pcm16Transport().pack(pcm)
    back = tr.unpack(wire)
    np.testing.assert_allclose(back, pcm, atol=1e-4)
    np.testing.assert_array_equal(back, jax_opus.Pcm16Transport().unpack(wire))


def test_negotiate_rules():
    # pcm16 always available
    assert opus.negotiate("pcm16") == "pcm16"
    assert opus.negotiate("garbage") == "pcm16"
    # opus only with libopus AND a packet-aligned frame
    expected = "opus" if opus.available() else "pcm16"
    assert opus.negotiate("opus", frame_size=1920) == expected
    assert opus.negotiate("opus", frame_size=24) == "pcm16"
    for offer in ("pcm16", "garbage", "opus", ""):
        for frame in (24, 480, 1920):
            assert opus.negotiate(offer, frame_size=frame) == jax_opus.negotiate(
                offer, frame_size=frame)


@requires_opus
def test_opus_transport_pack_unpack():
    # encoder and decoder halves are independent streams; a transport's
    # unpack can decode another transport's pack
    a, b = opus.OpusTransport(), opus.OpusTransport()
    pcm = (0.2 * np.sin(np.linspace(0, 50, 1920))).astype(np.float32)
    for _ in range(3):
        wire = a.pack(pcm)
        out = b.unpack(wire)
    assert out.shape == (1920,)
    assert np.isfinite(out).all()


class _SmallFrameState:
    """A server state with 24-sample frames: not a whole number of 20 ms
    Opus packets, so the server must answer an Opus offer with PCM16."""

    frame_size = 24
    scan_frames = 0
    text_tokenizer = None

    def __init__(self):
        from types import SimpleNamespace

        self.lm_gen = SimpleNamespace(max_delay=0)
        self.lock = asyncio.Lock()
        self.steps = 0

    def reset(self):
        self.steps = 0

    def handle_frame_array(self, pcm):
        self.steps += 1
        return 0.5 * pcm, 7


def test_handshake_negotiation_over_websocket():
    """A client offering opus against a 24-sample-frame server gets pcm16
    back and the audio loop still works end to end."""
    import json

    from aiohttp.test_utils import TestClient, TestServer

    from rstnet_tpu_torch.serving.server import TAG_AUDIO, build_app
    from rstnet_tpu_torch.utils.audio import float_to_pcm16, pcm16_to_float

    app = build_app(_SmallFrameState())

    async def run():
        async with TestClient(TestServer(app)) as client:
            ws = await client.ws_connect("/api/chat")
            await ws.send_str(json.dumps({"codec": "opus"}))
            reply = json.loads(await ws.receive_str())
            assert reply["codec"] == "pcm16"  # frame 24 is not opus-packable
            pcm = np.full(24, 0.25, np.float32)
            await ws.send_bytes(TAG_AUDIO + float_to_pcm16(pcm))
            msg = await asyncio.wait_for(ws.receive(), timeout=30)
            data = bytes(msg.data)
            assert data[:1] == TAG_AUDIO
            out = pcm16_to_float(data[1:])
            assert out.shape == (24,)
            np.testing.assert_allclose(out, 0.125, atol=1e-4)
            await ws.close()

    asyncio.new_event_loop().run_until_complete(run())


def test_index_page_served():
    from aiohttp.test_utils import TestClient, TestServer

    from rstnet_tpu_torch.serving.server import build_app

    app = build_app(_SmallFrameState())

    async def run():
        async with TestClient(TestServer(app)) as client:
            resp = await client.get("/")
            assert resp.status == 200
            body = await resp.text()
            assert "duplex" in body and "api/chat" in body

    asyncio.new_event_loop().run_until_complete(run())
