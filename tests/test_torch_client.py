"""The port's duplex client (``rstnet_tpu_torch/serving/client.py``) and the
JAX client against the port's server, on the CPU.

Both clients drive the port's ``--tiny`` server (greedy) on a localhost port
(``serving/server.py::serve_in_thread``). Through the socket, the port's
``stream_file`` and ``main`` must receive exactly what the JAX
``stream_file`` receives from that same server, and the audio of direct
``ServerState.handle_frame_array`` calls on the same PCM16 frames within one
PCM16 step (1/32768: the direct audio goes through the same PCM16 round
trip, and a sample may round to the next step), and the same text. Warmup
frames (``steps <= max_delay``) send nothing, and the client's one frame a
message never sets off a catch-up scan."""

import tests.test_torch_threads  # noqa: F401 - first: one torch CPU thread a process

import asyncio
import dataclasses

import numpy as np
import pytest
import torch

from rstnet_tpu_torch.serving import client
from rstnet_tpu_torch.serving.server import (
    TEXT_SKIP_IDS,
    ServerState,
    build_app,
    build_batched_app,
    build_server,
    parse_args,
    serve_in_thread,
)
from rstnet_tpu_torch.utils.audio import (
    float_to_pcm16,
    pcm16_to_float,
    read_wav,
    resample_linear,
    write_wav,
)

PCM16_STEP = 1 / 32768


def _state(delayed: bool) -> ServerState:
    """The ``--tiny`` server, greedy; ``delayed``: the same weights through
    an ``LMGen`` with the acoustic streams one step behind the text."""
    from rstnet_tpu_torch.inference.generate import LMGen

    state = build_server(parse_args(["--tiny", "--device", "cpu"]))
    lm = state.lm_gen.model
    delays = (0,) + (1,) * (lm.num_codebooks - 1) if delayed else state.lm_gen.delays
    gen = LMGen(lm, delays=delays, use_sampling=False)
    state = ServerState(state.mimi, gen, seed=0, scan_frames=state.scan_frames)
    state.warmup()
    return state


def _count_scans(state) -> list:
    scans = []
    inner = state.handle_frames_array

    def counted(pcm):
        scans.append(pcm.shape[-1])
        return inner(pcm)

    state.handle_frames_array = counted
    return scans


def _seeded_wav(tmp_path, seconds=0.9, sr=16000) -> str:
    rng = np.random.default_rng(4)
    t = np.arange(int(seconds * sr)) / sr
    wav = (0.3 * np.sin(2 * np.pi * 180 * t) + 0.05 * rng.standard_normal(len(t)))
    path = str(tmp_path / "in.wav")
    write_wav(path, wav.astype(np.float32), sr)
    return path


def _direct(state: ServerState, wav_path: str) -> tuple[np.ndarray, list, int]:
    """The client's frames (resampled, padded, PCM16 on the wire) through
    ``handle_frame_array`` after a ``reset``: (audio as it comes back through
    PCM16, the text the server sends a frame, frames sent)."""
    wav, sr = read_wav(wav_path)
    wav = resample_linear(wav, sr, client.SAMPLE_RATE)[0]
    wav = np.pad(wav, (0, (-len(wav)) % client.FRAME_SIZE))
    state.reset()
    audio, text = [], []
    for off in range(0, len(wav), client.FRAME_SIZE):
        pcm = pcm16_to_float(float_to_pcm16(wav[off: off + client.FRAME_SIZE]))
        a, tok = state.handle_frame_array(pcm)
        if a is not None:
            audio.append(pcm16_to_float(float_to_pcm16(a)))
            text.append("" if tok in TEXT_SKIP_IDS else str(tok))
    return np.concatenate(audio), text, len(wav) // client.FRAME_SIZE


def _texts(per_frame: list, received_all: bool) -> set:
    """The text a client can have received. Once every frame's audio is in,
    the client closes at once (the JAX client's drain), so the last frame's
    text, sent after its audio, may be cut; a client that waited out its
    1 s drain (fewer frames come back than went out) has it all."""
    full = "".join(per_frame)
    return {full, "".join(per_frame[:-1])} if received_all else {full}


@pytest.mark.parametrize("delayed", [False, True], ids=["tiny", "tiny_delayed"])
def test_clients_receive_what_the_server_computes(tmp_path, delayed):
    from rstnet_tpu.serving import client as jax_client

    state = _state(delayed)
    scans = _count_scans(state)
    wav = _seeded_wav(tmp_path)
    with serve_in_thread(build_app(state)) as url:
        port_audio, port_text = asyncio.run(client.stream_file(url, wav, codec="pcm16"))
        jax_audio, jax_text = asyncio.run(jax_client.stream_file(url, wav, codec="pcm16"))
        main_audio, main_text = client.main(["--url", url, "--in-wav", wav, "--codec", "pcm16",
                                             "--out-wav", str(tmp_path / "out.wav")])
    assert scans == []
    want_audio, want_text, n_sent = _direct(state, wav)
    max_delay = state.lm_gen.max_delay
    assert max_delay == (1 if delayed else 0)
    assert len(port_audio) == (n_sent - max_delay) * client.FRAME_SIZE
    np.testing.assert_array_equal(port_audio, jax_audio)
    np.testing.assert_array_equal(main_audio, port_audio)
    texts = _texts(want_text, received_all=max_delay == 0)
    assert {port_text, jax_text, main_text} <= texts
    assert "".join(want_text)  # text tokens went out (as ids: no tokenizer)
    np.testing.assert_allclose(port_audio, want_audio, rtol=0, atol=PCM16_STEP)
    written, sr = read_wav(str(tmp_path / "out.wav"))
    assert sr == client.SAMPLE_RATE and written.shape == (1, len(main_audio))


def test_load_test_against_a_batched_server():
    """``load_test`` (the port's and JAX's) against a ``--batch 2`` server:
    one stats dict a session, each with every frame past the delay warmup;
    ``main --sessions`` returns the same kind of stats."""
    from rstnet_tpu.serving import client as jax_client

    batcher = build_server(parse_args(["--tiny", "--device", "cpu", "--batch", "2"]))
    seconds = 0.8
    n_frames = int(seconds / 0.08)
    with serve_in_thread(build_batched_app(batcher)) as url:
        runs = [asyncio.run(client.load_test(url, 2, seconds=seconds, codec="pcm16")),
                asyncio.run(jax_client.load_test(url, 2, seconds=seconds, codec="pcm16")),
                client.main(["--url", url, "--sessions", "2", "--seconds", str(seconds),
                             "--codec", "pcm16"])]
    for stats in runs:
        assert [s["session"] for s in stats] == [0, 1]
        for s in stats:
            assert s["frames_sent"] == n_frames
            assert s["frames_recv"] >= n_frames - batcher.lm_gen.max_delay
            assert s["first_frame_ms"] is not None and s["first_frame_ms"] > 0


def test_codec_negotiation_falls_back_as_jax(monkeypatch):
    """Against the port's server: the port's and JAX's handshakes pick the
    same transport for each offer, and without libopus both fall back to
    PCM16 before offering Opus."""
    import aiohttp

    from rstnet_tpu.serving import client as jax_client
    from rstnet_tpu.serving import opus as jax_opus
    from rstnet_tpu_torch.serving import opus

    state = _state(False)

    async def transports(url, negotiate, codecs):
        out = []
        async with aiohttp.ClientSession() as session:
            for codec in codecs:
                async with session.ws_connect(url) as ws:
                    out.append(type(await negotiate(ws, codec)).__name__)
        return out

    codecs = ("opus", "pcm16", "legacy", "garbage")
    with serve_in_thread(build_app(state)) as url:
        mine = asyncio.run(transports(url, client._negotiate, codecs))
        theirs = asyncio.run(transports(url, jax_client._negotiate, codecs))
        assert mine == theirs
        opus_name = "OpusTransport" if opus.available() else "Pcm16Transport"
        assert mine == [opus_name, "Pcm16Transport", "Pcm16Transport", "Pcm16Transport"]
        monkeypatch.setattr(opus, "available", lambda: False)
        monkeypatch.setattr(jax_opus, "available", lambda: False)
        assert asyncio.run(transports(url, client._negotiate, ["opus"])) == ["Pcm16Transport"]
        assert asyncio.run(transports(url, jax_client._negotiate, ["opus"])) == [
            "Pcm16Transport"]


def test_stream_file_over_opus(tmp_path):
    """Opus on the wire (where libopus loads): both clients receive every
    frame, finite, and the same decoded audio (the same packets through the
    same decoder)."""
    from rstnet_tpu.serving import client as jax_client
    from rstnet_tpu_torch.serving import opus

    if not opus.available():
        pytest.skip("libopus not present")
    state = _state(False)
    wav = _seeded_wav(tmp_path)
    with serve_in_thread(build_app(state)) as url:
        mine, mine_text = asyncio.run(client.stream_file(url, wav, codec="opus"))
        theirs, theirs_text = asyncio.run(jax_client.stream_file(url, wav, codec="opus"))
    n = -(-int(0.9 * 24000) // client.FRAME_SIZE)
    assert mine.shape == (n * client.FRAME_SIZE,) and np.isfinite(mine).all()
    np.testing.assert_array_equal(mine, theirs)
    assert theirs_text.startswith(mine_text) or mine_text.startswith(theirs_text)


def test_greedy_state_is_deterministic_across_resets():
    """The comparison above rests on this: after a ``reset`` the same frames
    give the same audio and tokens."""
    state = _state(True)
    rng = np.random.default_rng(0)
    frames = [(0.1 * rng.standard_normal(client.FRAME_SIZE)).astype(np.float32)
              for _ in range(4)]
    runs = []
    for _ in range(2):
        state.reset()
        runs.append([state.handle_frame_array(f) for f in frames])
    assert runs[0][0] == (None, None)  # the delay warmup sends nothing
    for (a, ta), (b, tb) in zip(runs[0][1:], runs[1][1:]):
        np.testing.assert_array_equal(a, b)
        assert ta == tb
    assert torch.get_num_threads() == 1
    assert dataclasses.is_dataclass(state.lm_gen) and not state.lm_gen.use_sampling
