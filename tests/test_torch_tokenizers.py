"""The port's tokenizers, wav helpers, offline tokenization and the server's
text output against the JAX package's, on the CPU.

``TextTokenizer`` and ``scp_tools`` are copies: ids, grids and shards must be
equal. ``MimiTokenizer`` runs the port's Mimi on the CPU over the same tiny
weights as JAX's: codes must be equal, decoded audio within 1e-3 (the
float32 codec tolerance of ``tests/test_torch_codec.py``). The offline
tokenization tests mirror ``tests/test_tools_pipeline.py`` and hold each
``.npz`` shard of the port's tool to the JAX tool's on the same inputs,
with the same stand-in Mimi (``_FakeMimiTok``) where the JAX tests use it."""

import tests.test_torch_threads  # noqa: F401 - first: one torch CPU thread a process

import asyncio
import json

import numpy as np
import pytest
import torch

from rstnet_tpu_torch.tools.scp_tools import read_scp, wav_dir_to_scp, write_scp
from rstnet_tpu_torch.utils.audio import read_wav, write_wav
from tests.test_tools_pipeline import _FakeMimiTok, _write_word_tokenizer

JAX_MIMI = "rstnet_tpu.data.tokenizers.mimi_tokenizer.MimiTokenizer"
PORT_MIMI = "rstnet_tpu_torch.data.tokenizers.mimi_tokenizer.MimiTokenizer"
AUDIO_TOL = 1e-3


def _text_dir(tmp_path):
    """The JAX pipeline tests' word tokenizer, plus BOS/EOS from a
    ``tokenizer_config.json`` as a checkpoint directory gives them."""
    from tokenizers import Tokenizer, models, pre_tokenizers

    vocab = {"[UNK]": 0, "<s>": 1, "</s>": 2, "Ġhello": 11, "Ġworld": 13, "Ġhi": 17}
    tok = Tokenizer(models.WordLevel(vocab, unk_token="[UNK]"))
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=True)
    d = tmp_path / "texttok_bos"
    d.mkdir(exist_ok=True)
    tok.save(str(d / "tokenizer.json"))
    (d / "tokenizer_config.json").write_text(json.dumps(
        {"bos_token": "<s>", "eos_token": {"content": "</s>"}}))
    return str(d)


def _both_text(path, **kw):
    from rstnet_tpu.data.tokenizers.text_tokenizer import TextTokenizer as JT
    from rstnet_tpu_torch.data.tokenizers.text_tokenizer import TextTokenizer

    return TextTokenizer(path, **kw), JT(path, **kw)


@pytest.mark.parametrize("which", ["word", "bos_eos"])
def test_text_tokenizer_matches_jax(tmp_path, which):
    path = _write_word_tokenizer(tmp_path) if which == "word" else _text_dir(tmp_path)
    mine, theirs = _both_text(path, max_length=4)
    assert (mine.backend, mine.bos_id, mine.eos_id) == (theirs.backend, theirs.bos_id,
                                                        theirs.eos_id)
    assert (mine.bos_id, mine.eos_id) == ((None, None) if which == "word" else (1, 2))
    for text in ("hello world", "hi hello hi world", "world", ""):
        assert mine.tokenize_text(text) == theirs.tokenize_text(text)
        np.testing.assert_array_equal(mine.tokenize(text), theirs.tokenize(text))
        assert mine.tokenize(text).dtype == np.int64
    assert mine.decode([11, 13]) == theirs.decode([11, 13])
    assert mine.token_to_id("Ġhi") == theirs.token_to_id("Ġhi") == 17
    segments = [{"text": "hello world", "words": [{"word": "hello", "start": 0.0, "end": 0.3},
                                                  {"word": "world", "start": 0.5}]},
                {"text": "hi", "words": [{"word": "hi"}]}]
    words = mine.tokenize_segment(segments)
    assert words == theirs.tokenize_segment(segments)
    for duration in (1.0, 0.45):
        np.testing.assert_array_equal(mine.pad_tokens(words, duration),
                                      theirs.pad_tokens(words, duration))


def test_text_word_alignment_padding():
    """Mirror of ``tests/test_data.py::test_text_word_alignment_padding``."""
    from rstnet_tpu_torch.data.tokenizers.text_tokenizer import TextTokenizer

    tok = TextTokenizer.__new__(TextTokenizer)  # skip file loading
    tok.pad_id = 128004
    tok.epad_id = 128005
    words = [
        {"word": "hello", "start": 0.0, "end": 0.3, "tokens": [11, 12]},
        {"word": "world", "start": 0.5, "end": 0.9, "tokens": [13]},
    ]
    out = tok.pad_tokens(words, duration=1.0, frame_rate=12.5)
    assert out.shape == (13,)
    assert out[0] == tok.epad_id  # start==0 shifts to 1, epad at 0
    assert out[1] == 11 and out[2] == 12
    start2 = round(0.5 * 12.5)
    assert out[start2 - 1] == tok.epad_id
    assert out[start2] == 13
    assert (out[start2 + 1 :] == tok.pad_id).all()


def test_text_tokenizer_names_a_missing_backend(tmp_path, monkeypatch):
    """A backend that is not installed raises an ImportError naming the
    package; nothing falls back to the other backend."""
    import sys

    from rstnet_tpu_torch.data.tokenizers.text_tokenizer import TextTokenizer

    word_dir = _write_word_tokenizer(tmp_path)
    (tmp_path / "tokenizer.model").write_bytes(b"\0")
    for package in ("sentencepiece", "tokenizers"):
        monkeypatch.setitem(sys.modules, package, None)  # import raises ImportError
    with pytest.raises(ImportError, match="'sentencepiece'"):
        TextTokenizer(tmp_path)
    with pytest.raises(ImportError, match="'tokenizers'"):
        TextTokenizer(word_dir)


def _mimi_pair():
    from rstnet_tpu.data.tokenizers.mimi_tokenizer import MimiTokenizer as JT
    from rstnet_tpu_torch.data.tokenizers.mimi_tokenizer import MimiTokenizer
    from tests.test_torch_codec import _tiny_mimi_pair

    jm, params, tm = _tiny_mimi_pair()
    return MimiTokenizer(model=tm, device="cpu"), JT(model=jm, params=params)


def test_mimi_tokenizer_matches_jax():
    """Codes equal to JAX's (int16, [K, frames]) over an input that needs
    the power-of-two bucket and one that needs the resampler; decoded audio
    within ``AUDIO_TOL``."""
    mine, theirs = _mimi_pair()
    assert (mine.sr, mine.codebook_length, mine.is_discrete) == (theirs.sr,
                                                                 theirs.codebook_length, True)
    rng = np.random.default_rng(0)
    wav = rng.normal(0, 0.1, 5 * 1920 + 77).astype(np.float32)  # 6 frames in a bucket of 8
    padded, n = mine._bucket_pad(wav[None])
    assert n == 6 and padded.shape == (1, 8 * 1920)
    np.testing.assert_array_equal(padded, theirs._bucket_pad(wav[None])[0])
    for x, sr in ((wav, None), (wav[None], 24000), (wav[: 16000], 16000)):
        codes = mine.tokenize(x, sr)
        want = theirs.tokenize(x, sr)
        assert codes.dtype == np.int16 and codes.shape == want.shape
        np.testing.assert_array_equal(codes, want)
    codes = mine.tokenize(wav)
    assert codes.shape == (8, 6) and len(np.unique(codes)) > 1
    audio = mine.detokenize(codes)
    assert audio.shape == (1, 6 * 1920) and audio.dtype == np.float32
    np.testing.assert_allclose(audio, theirs.detokenize(codes), rtol=0, atol=AUDIO_TOL)


def test_wav_io_roundtrip(tmp_path):
    """Mirror of ``test_tools_pipeline.py::test_wav_io_roundtrip``; the JAX
    reader gives the same samples."""
    from rstnet_tpu.utils.audio import read_wav as jax_read_wav

    sr = 16000
    wav = (0.3 * np.sin(2 * np.pi * 440 * np.arange(sr) / sr)).astype(np.float32)
    write_wav(str(tmp_path / "a.wav"), wav, sr)
    back, sr2 = read_wav(str(tmp_path / "a.wav"))
    assert sr2 == sr
    np.testing.assert_allclose(back[0], wav, atol=1e-3)
    stereo = np.stack([wav, -wav])
    write_wav(str(tmp_path / "s.wav"), stereo, sr)
    got, want = read_wav(str(tmp_path / "s.wav")), jax_read_wav(str(tmp_path / "s.wav"))
    assert got[1] == want[1] and got[0].shape == (2, sr)
    np.testing.assert_array_equal(got[0], want[0])


def test_wav_dir_to_scp(tmp_path):
    """Mirror of ``test_tools_pipeline.py::test_wav_dir_to_scp``."""
    for i in range(3):
        write_wav(str(tmp_path / f"w{i}.wav"), np.zeros(100, np.float32), 8000)
    n = wav_dir_to_scp(str(tmp_path), str(tmp_path / "wav.scp"))
    assert n == 3
    assert [k for k, _ in read_scp(str(tmp_path / "wav.scp"))] == ["w0", "w1", "w2"]


def test_audio_helpers_match_jax():
    """The resampler, the PCM16 helpers and the numpy log-mel spectrogram
    against the JAX package's (the resampler to 1e-6, the log-mel to 1e-4:
    float32 sums in other orders)."""
    from rstnet_tpu.ops.stft import mel_spectrogram as jax_mel
    from rstnet_tpu.utils import audio as ja
    from rstnet_tpu_torch.utils import audio as ta

    wav = np.random.default_rng(2).normal(0, 0.2, (2, 4000)).astype(np.float32)
    # the JAX package may resample in its C++ helper: the same interpolation
    # to float32 rounding
    np.testing.assert_allclose(ta.resample_linear(wav, 16000, 24000),
                               ja.resample_linear(wav, 16000, 24000), rtol=0, atol=1e-6)
    assert ta.float_to_pcm16(wav[0]) == ja.float_to_pcm16(wav[0])
    np.testing.assert_array_equal(ta.pcm16_to_float(ta.float_to_pcm16(wav[0])),
                                  ja.pcm16_to_float(ja.float_to_pcm16(wav[0])))
    np.testing.assert_allclose(ta.mel_spectrogram(wav), np.asarray(jax_mel(wav)),
                               rtol=1e-4, atol=1e-4)


def _run_both(monkeypatch, argv, tmp_path, jax_mimi, port_mimi):
    """The JAX and the port's ``offline_tokenization.main`` on the same
    arguments (``--output`` aside), each with its Mimi stand-in; returns
    both shards."""
    from rstnet_tpu.tools import offline_tokenization as jot
    from rstnet_tpu_torch.tools import offline_tokenization as tot

    monkeypatch.setattr(JAX_MIMI, jax_mimi)
    monkeypatch.setattr(PORT_MIMI, port_mimi)
    jot.main([*argv, "--output", str(tmp_path / "jax.npz")])
    tot.main([*argv, "--output", str(tmp_path / "port.npz"), "--device", "cpu"])
    return np.load(tmp_path / "port.npz"), np.load(tmp_path / "jax.npz")


def assert_shards_equal(got, want):
    assert sorted(got.files) == sorted(want.files) and got.files
    for k in want.files:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_offline_audio_tokenization_matches_jax(tmp_path, monkeypatch):
    """``--mode audio`` over an scp of a 24 kHz and a 16 kHz clip through
    the tiny Mimi on both sides: equal int16 code shards."""
    mine, theirs = _mimi_pair()
    rng = np.random.default_rng(5)
    write_wav(str(tmp_path / "a.wav"), rng.normal(0, 0.1, 3 * 1920).astype(np.float32), 24000)
    write_wav(str(tmp_path / "b.wav"), rng.normal(0, 0.1, 9000).astype(np.float32), 16000)
    write_scp(str(tmp_path / "wav.scp"), [("a", str(tmp_path / "a.wav")),
                                          ("b", str(tmp_path / "b.wav"))])
    got, want = _run_both(monkeypatch, ["--scp", str(tmp_path / "wav.scp"), "--mode", "audio"],
                          tmp_path, lambda **k: theirs, lambda **k: mine)
    assert_shards_equal(got, want)
    assert got["a"].shape == (8, 3) and got["a"].dtype == np.int16


def test_offline_text_tokenization_matches_jax(tmp_path, monkeypatch):
    """``--mode text`` and ``--mode aligned_text``: equal shards."""
    tok_dir = _text_dir(tmp_path)
    write_scp(str(tmp_path / "text.scp"), [("u0", "hello world"), ("u1", "hi")])
    meta = {"duration": 1.0, "segments": [{"text": "hello world", "words": [
        {"word": "hello", "start": 0.08}, {"word": "world", "start": 0.5}]}]}
    (tmp_path / "u0.json").write_text(json.dumps(meta))
    write_scp(str(tmp_path / "json.scp"), [("u0", str(tmp_path / "u0.json"))])
    for mode, scp in (("text", "text.scp"), ("aligned_text", "json.scp")):
        got, want = _run_both(monkeypatch, ["--scp", str(tmp_path / scp), "--mode", mode,
                                            "--tokenizer-dir", tok_dir],
                              tmp_path, _FakeMimiTok, _FakeMimiTok)
        assert_shards_equal(got, want)
    assert got["u0"].shape == (1, 13)


def test_offline_ssl_mode_names_its_item(tmp_path):
    """``--mode ssl`` is ported (``tests/test_torch_whisper_vq.py`` holds its
    shards to JAX's): without ``--ssl-checkpoint`` it raises as the JAX tool
    does, naming the checkpoint it needs."""
    from rstnet_tpu.tools.offline_tokenization import main as jax_main
    from rstnet_tpu_torch.tools import offline_tokenization as tot

    (tmp_path / "x.scp").write_text("")
    argv = ["--scp", str(tmp_path / "x.scp"), "--output", str(tmp_path / "o.npz"),
            "--mode", "ssl"]
    with pytest.raises(RuntimeError, match="GLM-4-Voice tokenizer checkpoint"):
        tot.main([*argv, "--device", "cpu"])
    with pytest.raises(RuntimeError, match="GLM-4-Voice tokenizer checkpoint"):
        jax_main(argv)


def _duplex_inputs(tmp_path, sr=24000):
    t = np.arange(sr) / sr
    left = (0.3 * np.sin(2 * np.pi * 300 * t)).astype(np.float32)
    right = (0.6 * np.sin(2 * np.pi * 500 * t)).astype(np.float32)
    write_wav(str(tmp_path / "stereo.wav"), np.stack([left, right]), sr)
    write_wav(str(tmp_path / "mono.wav"), left, sr)
    write_scp(str(tmp_path / "wav.scp"), [("conv0", str(tmp_path / "stereo.wav")),
                                          ("conv1", str(tmp_path / "mono.wav"))])
    return left, right


def test_duplex_tokenization_stereo_and_sessions(tmp_path, monkeypatch):
    """Mirror of ``test_tools_pipeline.py::
    test_duplex_tokenization_stereo_and_sessions``: both duplex forms give a
    [17, T] grid per conversation side, equal to the JAX tool's."""
    from rstnet_tpu_torch.data.collate import SpecialTokens

    sr = 24000
    left, right = _duplex_inputs(tmp_path)
    got, want = _run_both(monkeypatch, ["--scp", str(tmp_path / "wav.scp"), "--mode", "duplex"],
                          tmp_path, _FakeMimiTok, _FakeMimiTok)
    assert_shards_equal(got, want)
    g0 = got["conv0_ch0"]
    assert g0.shape == (17, 13) and (g0[0] == SpecialTokens.text_pad).all()
    assert not np.array_equal(g0[1:9], g0[9:17])
    assert np.array_equal(got["conv0_ch1"][1:9], g0[9:17])
    assert "conv1_ch1" not in got.files and (got["conv1_ch0"][9:17] == 0).all()

    write_wav(str(tmp_path / "a.wav"), left[: sr // 2], sr)
    write_wav(str(tmp_path / "b.wav"), right[: sr // 2], sr)
    sessions = [{"start": 10.0, "end": 11.0, "speakers": ["S0", "S1"], "segments": [
        {"utt": "a", "path": str(tmp_path / "a.wav"), "start": 10.0, "end": 10.5,
         "speaker": "S0"},
        {"utt": "b", "path": str(tmp_path / "b.wav"), "start": 10.5, "end": 11.0,
         "speaker": "S1"}]}]
    (tmp_path / "sessions.json").write_text(json.dumps(sessions))
    got, want = _run_both(monkeypatch, ["--sessions", str(tmp_path / "sessions.json"),
                                        "--mode", "duplex"], tmp_path, _FakeMimiTok,
                          _FakeMimiTok)
    assert_shards_equal(got, want)
    g = got["session_000000_ch0"]
    assert g.shape == (17, 13) and not np.array_equal(g[1:9], g[9:17])


def _two_speaker_sessions(tmp_path, words=True):
    sr = 24000
    wav = 0.3 * np.sin(2 * np.pi * 300 * np.arange(sr // 2) / sr)
    write_wav(str(tmp_path / "a.wav"), wav.astype(np.float32), sr)
    write_wav(str(tmp_path / "b.wav"), (2 * wav).astype(np.float32), sr)
    a = {"utt": "a", "path": str(tmp_path / "a.wav"), "start": 10.0, "end": 10.5,
         "speaker": "S0"}
    b = {"utt": "b", "path": str(tmp_path / "b.wav"), "start": 10.5, "end": 11.0,
         "speaker": "S1"}
    if words:
        a["segments"] = [{"text": "hello world", "words": [
            {"word": "hello", "start": 0.08, "end": 0.2},
            {"word": "world", "start": 0.32, "end": 0.45}]}]
        b["segments"] = [{"text": "hi", "words": [{"word": "hi", "start": 0.04, "end": 0.2}]}]
    sessions = [{"start": 10.0, "end": 11.0, "speakers": ["S0", "S1"], "segments": [a, b]}]
    (tmp_path / "sessions.json").write_text(json.dumps(sessions))
    return str(tmp_path / "sessions.json")


def test_duplex_sessions_text_alignment_golden(tmp_path, monkeypatch):
    """Mirror of ``test_tools_pipeline.py::
    test_duplex_sessions_text_alignment_golden``: ASR word times land in
    row 0 shifted to session time, as in the JAX tool's shard."""
    from rstnet_tpu.tools import offline_tokenization as jot
    from rstnet_tpu_torch.data.collate import SpecialTokens
    from rstnet_tpu_torch.tools import offline_tokenization as tot

    monkeypatch.setattr(JAX_MIMI, _FakeMimiTok)
    monkeypatch.setattr(PORT_MIMI, _FakeMimiTok)
    tok_dir = _write_word_tokenizer(tmp_path)
    sessions = _two_speaker_sessions(tmp_path)
    assert tot.tokenize_duplex_sessions(sessions, str(tmp_path / "port.npz"),
                                        tokenizer_dir=tok_dir, device="cpu") == 2
    jot.tokenize_duplex_sessions(sessions, str(tmp_path / "jax.npz"), tokenizer_dir=tok_dir)
    got = np.load(tmp_path / "port.npz")
    assert_shards_equal(got, np.load(tmp_path / "jax.npz"))
    pad, epad = SpecialTokens.text_pad, SpecialTokens.text_empty_pad
    expect = np.full(13, pad, np.int32)
    expect[0], expect[1], expect[3], expect[4] = epad, 11, epad, 13
    np.testing.assert_array_equal(got["session_000000_ch0"][0], expect)
    expect1 = np.full(13, pad, np.int32)
    expect1[6], expect1[7] = epad, 17
    np.testing.assert_array_equal(got["session_000000_ch1"][0], expect1)


def test_duplex_sessions_three_speakers_dropped(tmp_path, monkeypatch, caplog):
    """Mirror of ``test_tools_pipeline.py::
    test_duplex_sessions_three_speakers_dropped``: a third speaker's
    segments are dropped with a warning; the shard equals the JAX tool's."""
    import logging

    from rstnet_tpu.tools import offline_tokenization as jot
    from rstnet_tpu_torch.tools import offline_tokenization as tot

    monkeypatch.setattr(JAX_MIMI, _FakeMimiTok)
    monkeypatch.setattr(PORT_MIMI, _FakeMimiTok)
    sr = 24000
    wav = 0.3 * np.sin(2 * np.pi * 300 * np.arange(sr // 2) / sr)
    paths = {}
    for name, scale in (("a", 1.0), ("b", 2.0), ("c", 3.0)):
        paths[name] = str(tmp_path / f"{name}.wav")
        write_wav(paths[name], (scale * wav).astype(np.float32), sr)
    sessions = [{"start": 0.0, "end": 1.5, "speakers": ["S0", "S1", "S2"], "segments": [
        {"utt": "a", "path": paths["a"], "start": 0.0, "end": 0.5, "speaker": "S0"},
        {"utt": "b", "path": paths["b"], "start": 0.5, "end": 0.95, "speaker": "S1"},
        {"utt": "c", "path": paths["c"], "start": 1.0, "end": 1.1, "speaker": "S2"}]}]
    (tmp_path / "sessions.json").write_text(json.dumps(sessions))
    with caplog.at_level(logging.WARNING):
        n = tot.tokenize_duplex_sessions(str(tmp_path / "sessions.json"),
                                         str(tmp_path / "port.npz"), device="cpu")
    assert n == 2 and any("dropping 1 segment(s)" in r.message for r in caplog.records)
    jot.tokenize_duplex_sessions(str(tmp_path / "sessions.json"), str(tmp_path / "jax.npz"))
    got = np.load(tmp_path / "port.npz")
    assert_shards_equal(got, np.load(tmp_path / "jax.npz"))
    g = got["session_000000_ch0"]
    assert (g[1:9] == int(np.abs(read_wav(paths["a"])[0][0]).sum()) % 100).all()
    assert (g[9:17] == int(np.abs(read_wav(paths["b"])[0][0]).sum()) % 100).all()
    assert tot._session_channel_map(sessions[0], "t") == {"S0": 0, "S1": 1}


class _ScriptedState:
    """What ``handle_chat`` reads of a ``ServerState``, with scripted
    tokens: a warmup frame, single frames that emit ``single``, scans that
    emit ``scan``."""

    frame_size, scan_frames = 24, 2

    def __init__(self, text_tokenizer, single, scan):
        from types import SimpleNamespace

        self.text_tokenizer, self.single, self.scan = text_tokenizer, list(single), scan
        self.lm_gen = SimpleNamespace(max_delay=1)
        self.lock = asyncio.Lock()
        self.steps = 0

    def reset(self):
        self.steps = 0

    def handle_frame_array(self, pcm):
        self.steps += 1
        if self.steps <= self.lm_gen.max_delay:
            return None, None
        return np.zeros(self.frame_size, np.float32), self.single.pop(0)

    def handle_frames_array(self, pcm):
        self.steps += self.scan_frames
        return np.zeros(self.scan_frames * self.frame_size, np.float32), list(self.scan)


def _chat_messages(build_app, state, n_expected):
    from aiohttp.test_utils import TestClient, TestServer

    from rstnet_tpu_torch.utils.audio import float_to_pcm16

    async def run():
        async with TestClient(TestServer(build_app(state))) as client:
            ws = await client.ws_connect("/api/chat")
            zeros = np.zeros(state.frame_size, np.float32)
            for n in (1, 1, 2):  # warmup, a single frame, then a scan's worth at once
                await ws.send_bytes(b"\x01" + float_to_pcm16(np.tile(zeros, n)))
            got = []
            while len(got) < n_expected:
                msg = await asyncio.wait_for(ws.receive(), timeout=30)
                got.append(bytes(msg.data))
            await ws.close()
            return got

    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(run())
    finally:
        loop.close()


@pytest.mark.parametrize("tokenizer", [False, True])
def test_server_sends_text_as_jax(tmp_path, tokenizer):
    """A session's frame and catch-up scan through the port's and the JAX
    server's ``handle_chat``: the same messages, text decoded through the
    tokenizer when one is given (as ids without), padding ids never sent."""
    from rstnet_tpu.serving import server as js
    from rstnet_tpu_torch.serving import server as ts

    tok = _both_text(_write_word_tokenizer(tmp_path))[0] if tokenizer else None
    msgs = []
    for mod in (ts, js):
        state = _ScriptedState(tok, single=[11], scan=[3, 13])
        msgs.append(_chat_messages(mod.build_app, state, n_expected=4))
    assert msgs[0] == msgs[1]
    texts = [m[1:].decode() for m in msgs[0] if m[:1] == b"\x02"]
    assert texts == ([tok.decode([11]), tok.decode([13])] if tokenizer else ["11", "13"])


def test_send_frame_decodes_as_jax(tmp_path):
    """``_send_frame`` of the port and of JAX, token by token: special ids
    dropped, the rest decoded."""
    from rstnet_tpu.serving import opus as jopus
    from rstnet_tpu.serving import server as js
    from rstnet_tpu_torch.serving import opus
    from rstnet_tpu_torch.serving import server as ts

    class Sink:
        def __init__(self):
            self.sent = []

        async def send_bytes(self, b):
            self.sent.append(b)

    tok = _both_text(_write_word_tokenizer(tmp_path))[0]
    audio = np.linspace(-0.5, 0.5, 24).astype(np.float32)
    for text_tokenizer in (None, tok):
        a, b = Sink(), Sink()
        for t in (None, 0, 3, 11, 13, 17):
            asyncio.run(ts._send_frame(a, audio, t, text_tokenizer, opus.Pcm16Transport()))
            asyncio.run(js._send_frame(b, audio, t, text_tokenizer, jopus.Pcm16Transport()))
        assert a.sent == b.sent and len(a.sent) == 9
