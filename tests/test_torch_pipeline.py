"""The port's data-prep pipeline (``rstnet_tpu_torch/pipeline``), its job
fan-out and manifest tools, and the DNSMOS metric, against the JAX package,
on the CPU.

Mirrors ``tests/test_pipeline_diarize.py`` (22), ``tests/test_pipeline_adapters.py``
(5) and the four tests of ``tests/test_tools_pipeline.py`` that
``tests/test_torch_tokenizers.py`` does not mirror, with their tolerances.
The parity tests hold the port to the JAX functions on the same inputs:
``pipeline.main`` must write bit-identical segment wavs, metadata and
``sessions.json`` and an equal filter report; ``dnsmos_score`` and the
DNSMOS/MDX harnesses through an injected session equal JAX's exactly (both
are the same float64 numpy arithmetic)."""

import tests.test_torch_threads  # noqa: F401 - first: one torch CPU thread a process

import json
import sys

import numpy as np
import pytest

from rstnet_tpu_torch.pipeline import adapters
from rstnet_tpu_torch.pipeline.diarize import (
    cut_by_speaker_label,
    merge_session_segments,
    pyannote_diarize,
    single_speaker_track,
    subdivide_turns,
)
from rstnet_tpu_torch.pipeline.filters import calculate_audio_stats, char_count
from rstnet_tpu_torch.pipeline.vad import energy_vad
from rstnet_tpu_torch.tools.scp_tools import (
    filter_scp,
    merge_then_split,
    read_scp,
    split_scp,
    write_scp,
)
from rstnet_tpu_torch.utils.audio import write_wav


def seg(start, end, speaker="A", **kw):
    return {"start": start, "end": end, "speaker": speaker, **kw}


# -- cut_by_speaker_label ---------------------------------------------------


def test_cut_trims_long_segments_to_max_windows():
    out = cut_by_speaker_label([seg(0, 70)], max_segment_s=30.0)
    spans = [(s["start"], s["end"]) for s in out]
    assert spans == [(0, 30), (30, 60), (60, 70)]
    assert all(s["speaker"] == "A" for s in out)


def test_cut_merges_short_same_speaker_across_small_gap():
    out = cut_by_speaker_label(
        [seg(0, 10), seg(10.5, 11.0)], merge_gap_s=2.0, min_segment_s=1.5
    )
    assert len(out) == 1
    assert out[0]["end"] == 11.0


def test_cut_does_not_merge_across_speakers_or_big_gaps():
    out = cut_by_speaker_label(
        [seg(0, 10, "A"), seg(10.5, 11.0, "B")], min_segment_s=0.2
    )
    assert [s["speaker"] for s in out] == ["A", "B"]
    out = cut_by_speaker_label(
        [seg(0, 10), seg(15, 15.5)], merge_gap_s=2.0, min_segment_s=1.5
    )
    assert len(out) == 1  # the distant short segment is dropped, not merged


def test_cut_drops_below_min_length():
    out = cut_by_speaker_label([seg(0, 0.5)], min_segment_s=1.5)
    assert out == []


def test_cut_merge_respects_max_segment_cap():
    # merging would exceed max -> keep separate, then drop the short one
    out = cut_by_speaker_label(
        [seg(0, 29.5), seg(29.6, 30.6)], merge_gap_s=2.0,
        min_segment_s=1.5, max_segment_s=30.0,
    )
    assert [(s["start"], s["end"]) for s in out] == [(0, 29.5)]


# -- subdivide_turns --------------------------------------------------------


def test_subdivide_keeps_short_turns_and_splits_long_ones():
    sr = 8000
    rng = np.random.default_rng(0)
    wav = np.zeros(sr * 40, np.float32)
    # two speech bursts inside the long turn
    wav[sr * 2 : sr * 6] = 0.5 * rng.standard_normal(sr * 4)
    wav[sr * 20 : sr * 25] = 0.5 * rng.standard_normal(sr * 5)
    turns = [seg(0, 40, "S1")]
    fine = subdivide_turns(turns, wav, sr, max_direct_s=30.0)
    assert len(fine) == 2
    assert all(s["speaker"] == "S1" for s in fine)
    assert abs(fine[0]["start"] - 2.0) < 0.5 and abs(fine[1]["end"] - 25.0) < 0.5
    # short turn passes through untouched
    short = subdivide_turns([seg(1, 4, "S2")], wav, sr, max_direct_s=30.0)
    assert short == [seg(1.0, 4.0, "S2")]


def test_subdivide_serializes_overlapping_turns():
    wav = np.zeros(8000 * 10, np.float32)
    fine = subdivide_turns(
        [seg(0, 5, "A"), seg(2, 4, "B"), seg(4, 8, "B")], wav, 8000
    )
    # the fully-contained B turn is skipped; the partially overlapping one is
    # clipped to start after A ends, so no audio region lands in two segments
    assert [(s["start"], s["end"], s["speaker"]) for s in fine] == [
        (0.0, 5.0, "A"), (5.0, 8.0, "B"),
    ]


def test_pyannote_adapter_raises_actionable_error_offline():
    try:
        import pyannote.audio  # noqa: F401

        pytest.skip("pyannote unexpectedly installed")
    except ImportError:
        pass
    with pytest.raises(RuntimeError, match="pyannote"):
        pyannote_diarize(np.zeros(8000, np.float32), 8000)


# -- merge_session_segments -------------------------------------------------


def test_merge_sessions_packs_and_splits_on_blanks():
    segs = [seg(0, 10, "A"), seg(11, 20, "B"), seg(40, 50, "A"), seg(51, 55, "B")]
    sessions = merge_session_segments(segs, chunk_size_s=60, blank_threshold_s=3)
    assert len(sessions) == 2  # 20 s blank splits the conversation
    assert sessions[0]["speakers"] == ["A", "B"]
    assert len(sessions[0]["segments"]) == 2
    assert sessions[1]["start"] == 40 and sessions[1]["end"] == 55


def test_merge_sessions_respects_chunk_size_and_min_length():
    segs = [seg(i * 10, i * 10 + 9, "A") for i in range(8)]  # 80 s of speech
    sessions = merge_session_segments(segs, chunk_size_s=30, blank_threshold_s=3)
    assert all(s["end"] - s["start"] <= 30 for s in sessions)
    assert sum(len(s["segments"]) for s in sessions) == len(segs)
    # a lone sub-threshold session is discarded
    assert merge_session_segments([seg(0, 2)], length_threshold_s=3.0) == []


# -- stats filter -----------------------------------------------------------


def test_char_count_strips_punctuation():
    assert char_count("Hello, world!") == 10
    assert char_count("  ... ") == 0


def test_calculate_audio_stats_filters_each_criterion():
    base = dict(text="a" * 20, dnsmos=3.5)
    segments = [
        seg(0, 10, **base),                       # passes
        seg(0, 1, **base),                        # too short
        seg(0, 10, text="a" * 20, dnsmos=2.0),    # low MOS
        seg(0, 10, text="x", dnsmos=3.5),         # too few chars... and rate outlier
        seg(0, 10, **base),                       # passes
    ]
    valid, report = calculate_audio_stats(
        segments, min_duration=3, max_duration=30, min_dnsmos=3.0,
        min_char_count=2,
    )
    assert valid == [0, 4]
    assert report["total"] == 5 and report["kept"] == 2
    assert report["dropped_by"]["duration"] == 1
    assert report["dropped_by"]["dnsmos"] == 1
    assert report["dropped_by"]["char_count"] == 1
    assert report["avg_dnsmos"] == pytest.approx(np.mean([3.5, 3.5, 2.0, 3.5, 3.5]))


def test_calculate_audio_stats_language_filter():
    """Off-target ASR-detected languages are dropped when a supported list
    is given; segments without a detection pass (reference
    emilia/main.py:287-306 language gating)."""
    base = dict(text="a" * 20, dnsmos=3.5)
    segments = [
        seg(0, 10, language="en", **base),   # passes
        seg(0, 10, language="ZH", **base),   # passes (case-insensitive)
        seg(0, 10, language="fr", **base),   # off-target -> dropped
        seg(0, 10, **base),                  # no detection -> passes
    ]
    valid, report = calculate_audio_stats(
        segments, min_duration=3, max_duration=30,
        supported_languages=["en", "zh"],
    )
    assert valid == [0, 1, 3]
    assert report["dropped_by"]["language"] == 1
    # no list -> no language filtering at all
    valid2, _ = calculate_audio_stats(segments, min_duration=3, max_duration=30)
    assert valid2 == [0, 1, 2, 3]


def test_calculate_audio_stats_without_asr_or_mos_is_duration_only():
    segments = [seg(0, 10), seg(0, 40)]
    valid, report = calculate_audio_stats(segments, min_duration=3, max_duration=30)
    assert valid == [0]
    assert report["avg_dnsmos"] is None


# -- DNSMOS harness (stub session) ------------------------------------------


class _StubSession:
    """Records inputs; returns a fixed raw (sig, bak, ovr) triple."""

    def __init__(self, triple=(3.0, 3.5, 2.8)):
        self.triple = triple
        self.calls = []

    def run(self, _outputs, feeds):
        (name, arr), = feeds.items()
        self.calls.append((name, np.asarray(arr).shape))
        return [np.asarray([list(self.triple)], np.float32)]


def test_dnsmos_framing_and_poly_mapping():
    from rstnet_tpu_torch.pipeline.onnx_models import DNSMOS, DNSMOS_INPUT_SECONDS

    sess = _StubSession()
    model = DNSMOS(session=sess)
    out = model.score(np.zeros(16000 * 12, np.float32), 16000)
    # 12 s clip -> floor(12) - 9.01 + 1 = 3 hops of 9.01 s windows
    assert out["num_hops"] == 3
    assert all(s == ("input_1", (1, int(16000 * DNSMOS_INPUT_SECONDS)))
               for s in sess.calls)
    assert out["SIG_raw"] == pytest.approx(3.0)
    # published polynomial: OVRL(2.8) = -0.06766283*2.8^2 + 1.11546468*2.8 + 0.04602535
    assert out["OVRL"] == pytest.approx(
        -0.06766283 * 2.8**2 + 1.11546468 * 2.8 + 0.04602535
    )


def test_dnsmos_tiles_short_clips():
    from rstnet_tpu_torch.pipeline.onnx_models import DNSMOS

    model = DNSMOS(session=_StubSession())
    out = model.score(0.1 * np.ones(16000, np.float32), 16000)  # 1 s clip
    assert out["num_hops"] >= 1
    assert out["len_in_sec"] == pytest.approx(1.0)


def test_dnsmos_score_metric_uses_session():
    from rstnet_tpu.evalsuite.metrics import dnsmos_score as jax_dnsmos_score
    from rstnet_tpu_torch.evalsuite.metrics import dnsmos_score

    score = dnsmos_score(np.zeros(16000 * 10, np.float32), 16000,
                         session=_StubSession())
    assert score is not None and 2.5 < score < 3.5
    # no model, no session, no onnxruntime -> None (graceful)
    assert dnsmos_score(np.zeros(16000, np.float32), 16000) is None
    # through an injected session, the JAX package's score exactly
    wav = 0.1 * np.random.default_rng(3).standard_normal(16000 * 11).astype(np.float32)
    for sr in (16000, 24000):
        assert dnsmos_score(wav, sr, session=_StubSession()) == jax_dnsmos_score(
            wav, sr, session=_StubSession())


# -- MDX separator harness (stub session) ------------------------------------


class _IdentityMaskSession:
    """Spectrogram model stub that returns its input unchanged (vocal
    estimate == mix), so separate() must reconstruct the input waveform —
    a round-trip test of the STFT framing/overlap logic."""

    def run(self, _outputs, feeds):
        (_, arr), = feeds.items()
        return [np.asarray(arr)]


def test_mdx_stft_istft_roundtrip():
    from rstnet_tpu_torch.pipeline.onnx_models import istft_np, stft_np

    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 4096)).astype(np.float32)
    spec = stft_np(x, n_fft=512, hop=128)
    back = istft_np(spec, n_fft=512, hop=128, length=4096)
    np.testing.assert_allclose(back, x, atol=1e-6)


def test_mdx_separator_identity_session_reconstructs_mix():
    from rstnet_tpu_torch.pipeline.onnx_models import MDXSeparator

    sep = MDXSeparator(session=_IdentityMaskSession(), dim_f=1024,
                       dim_t_log2=5, n_fft=2048, hop=512, chunk_seconds=2.0,
                       margin=4410)
    sr = 44100
    t = np.arange(sr * 3) / sr
    # band-limit well under dim_f bins so the frequency crop is lossless
    mix = (0.3 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
    vocals, inst = sep.separate(mix, sr)
    assert vocals.shape == mix.shape and inst.shape == mix.shape
    assert np.abs(vocals - mix).mean() < 1e-3
    assert np.abs(inst).mean() < 1e-3


def test_separate_vocals_adapter_with_session():
    from rstnet_tpu_torch.pipeline import adapters

    wav = (0.2 * np.sin(2 * np.pi * 330 * np.arange(44100) / 44100)).astype(
        np.float32
    )
    out = adapters.separate_vocals(wav, 44100, session=_IdentityMaskSession())
    assert out.shape == wav.shape
    assert np.abs(out - wav).mean() < 1e-2


# -- pipeline orchestration with speakers ------------------------------------


def test_pipeline_emits_speakers_sessions_and_filter_report(tmp_path):
    from rstnet_tpu_torch.pipeline.main import main as pipeline_main
    from rstnet_tpu_torch.tools.scp_tools import write_scp
    from rstnet_tpu_torch.utils.audio import write_wav

    sr = 24000
    rng = np.random.default_rng(0)
    wav = np.zeros(sr * 6, np.float32)
    wav[sr : sr * 3] = 0.4 * rng.standard_normal(sr * 2)
    wav[sr * 4 : sr * 5] = 0.4 * rng.standard_normal(sr)
    write_wav(str(tmp_path / "raw.wav"), wav, sr)
    write_scp(str(tmp_path / "raw.scp"), [("utt0", str(tmp_path / "raw.wav"))])
    cfg = {"merge_sessions": True, "session_chunk_s": 30.0,
           "use_diarization": True}  # pyannote absent -> fallback track
    (tmp_path / "cfg.json").write_text(json.dumps(cfg))

    out = pipeline_main([
        "--scp", str(tmp_path / "raw.scp"), "--out_dir", str(tmp_path / "seg"),
        "--config", str(tmp_path / "cfg.json"),
    ])
    assert out["segments"] >= 1 and out["sessions"] >= 1
    segs = json.loads((tmp_path / "seg" / "segments.json").read_text())
    assert all(s["speaker"] == "SPEAKER_00" for s in segs)
    report = json.loads((tmp_path / "seg" / "filter_report.json").read_text())
    assert report["utt0"]["kept"] == len(segs)
    sessions = json.loads((tmp_path / "seg" / "sessions.json").read_text())
    assert sessions[0]["speakers"] == ["SPEAKER_00"]
    # single-speaker fallback labelled the whole recording


def test_single_speaker_track():
    assert single_speaker_track(12.5) == [
        {"start": 0.0, "end": 12.5, "speaker": "SPEAKER_00"}
    ]


# -- adapters (tests/test_pipeline_adapters.py) ------------------------------


@pytest.fixture()
def wav():
    rng = np.random.default_rng(0)
    return (0.1 * rng.normal(0, 1, 16000)).astype(np.float32)


def test_whisperx_missing_raises_actionable_error(wav, tmp_path):
    pytest.importorskip("pytest")  # no-op guard; whisperx must NOT be present
    try:
        import whisperx  # noqa: F401

        pytest.skip("whisperx unexpectedly installed")
    except ImportError:
        pass
    with pytest.raises(RuntimeError, match="whisperX is not installed"):
        adapters.whisperx_transcribe(str(tmp_path / "x.wav"))


def test_separate_vocals_passthrough_without_backend(wav):
    try:
        import onnxruntime  # noqa: F401

        pytest.skip("onnxruntime unexpectedly installed")
    except ImportError:
        pass
    out = adapters.separate_vocals(wav, 16000)
    np.testing.assert_array_equal(out, wav)


def test_dnsmos_permissive_without_model(wav):
    assert adapters.dnsmos_filter(wav, 16000) is True


def test_denoise_passthrough(wav):
    try:
        import df  # noqa: F401

        pytest.skip("DeepFilterNet unexpectedly installed")
    except ImportError:
        pass
    out = adapters.denoise(wav, 16000)
    np.testing.assert_array_equal(out, wav)


def test_super_resolve_linear_fallback(wav):
    out = adapters.super_resolve(wav, 16000, 24000)
    assert out.shape[-1] == int(round(wav.shape[-1] * 24000 / 16000))
    assert np.isfinite(out).all()
    # energy is preserved to first order by linear resampling
    assert 0.5 < float(np.std(out) / np.std(wav)) < 2.0


# -- tools (tests/test_tools_pipeline.py) -----------------------------------


def test_scp_split_filter_merge(tmp_path):
    entries = [(f"u{i}", f"/path/{i}.wav") for i in range(10)]
    scp = tmp_path / "all.scp"
    write_scp(str(scp), entries)
    outs = split_scp(str(scp), 3, str(tmp_path / "x.JOB.scp"))
    assert len(outs) == 3
    total = sum(len(read_scp(o)) for o in outs)
    assert total == 10
    keep = tmp_path / "keep.scp"
    write_scp(str(keep), entries[:4])
    n = filter_scp(str(scp), str(keep), str(tmp_path / "kept.scp"))
    assert n == 4
    merged = merge_then_split(outs, 2, str(tmp_path / "m.JOB.scp"))
    assert sum(len(read_scp(o)) for o in merged) == 10


def test_run_jobs(tmp_path):
    from rstnet_tpu_torch.tools.run_jobs import run_jobs

    rc = run_jobs(
        3, str(tmp_path / "log.JOB.txt"),
        [sys.executable, "-c", "print('job JOB done')"],
    )
    assert rc == 0
    assert "job 2 done" in (tmp_path / "log.2.txt").read_text()
    rc = run_jobs(2, str(tmp_path / "f.JOB.txt"), [sys.executable, "-c", "exit(JOB-1)"])
    assert rc == 1  # job 2 fails


def test_energy_vad():
    sr = 8000
    t = np.arange(sr * 3) / sr
    wav = np.zeros(sr * 3, np.float32)
    wav[sr : 2 * sr] = 0.5 * np.sin(2 * np.pi * 300 * t[sr : 2 * sr])
    segs = energy_vad(wav, sr)
    assert len(segs) == 1
    assert abs(segs[0].start - 1.0) < 0.2
    assert abs(segs[0].end - 2.0) < 0.2


def test_pipeline_and_tokenization_end_to_end(tmp_path):
    """raw wav -> pipeline segments -> Mimi tokenization -> manifest."""
    from rstnet_tpu_torch.pipeline.main import main as pipeline_main
    from rstnet_tpu_torch.tools.create_data_json import main as json_main
    from rstnet_tpu_torch.tools.offline_tokenization import main as tok_main

    sr = 24000
    t = np.arange(sr * 2) / sr
    wav = np.zeros(sr * 2, np.float32)
    wav[sr // 2 : sr + sr // 2] = 0.4 * np.sin(2 * np.pi * 440 * t[: sr])
    write_wav(str(tmp_path / "raw.wav"), wav, sr)
    write_scp(str(tmp_path / "raw.scp"), [("utt0", str(tmp_path / "raw.wav"))])

    out = pipeline_main([
        "--scp", str(tmp_path / "raw.scp"), "--out_dir", str(tmp_path / "seg"),
    ])
    assert out["segments"] >= 1
    segs = json.loads((tmp_path / "seg" / "segments.json").read_text())
    assert all("duration" in s for s in segs)

    tok_main([
        "--scp", str(tmp_path / "seg" / "wav.scp"),
        "--output", str(tmp_path / "audio.npz"), "--mode", "audio", "--device", "cpu",
    ])
    shard = np.load(tmp_path / "audio.npz")
    assert len(shard.files) == out["segments"]
    assert shard[shard.files[0]].shape[0] == 8  # 8 codebooks

    json_main([
        "--task", "audio_only", "--audio_seq", str(tmp_path / "audio.npz"),
        "--output", str(tmp_path / "audio.json"),
    ])
    manifest = json.loads((tmp_path / "audio.json").read_text())
    assert manifest["task"] == "audio_only"


# -- parity with the JAX package ----------------------------------------------


def _two_speaker_recordings(tmp_path):
    """Seeded raw recordings: speech bursts between silences, one at the
    target rate (mono) and one off it (44.1 kHz stereo)."""
    rng = np.random.default_rng(17)
    entries = []
    for name, sr, ch, seconds in (("conv0", 24000, 1, 16.0), ("conv1", 44100, 2, 12.0)):
        wav = np.zeros((ch, int(sr * seconds)), np.float32)
        for start, end in ((0.5, 3.2), (3.6, 6.9), (8.4, 9.6), (10.1, 11.7)):
            n = int(sr * end) - int(sr * start)
            burst = 0.3 * rng.standard_normal((ch, n)) * np.sin(np.linspace(0, np.pi, n))
            wav[:, int(sr * start): int(sr * end)] = burst
        path = str(tmp_path / f"{name}.wav")
        write_wav(path, wav, sr)
        entries.append((name, path))
    write_scp(str(tmp_path / "raw.scp"), entries)
    return entries


def _relative(obj, root):
    """Output paths made relative to their output directory."""
    if isinstance(obj, dict):
        return {k: _relative(v, root) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_relative(v, root) for v in obj]
    if isinstance(obj, str) and obj.startswith(root):
        return obj[len(root):]
    return obj


def test_pipeline_main_bit_identical_to_jax(tmp_path, monkeypatch):
    """JAX's ``pipeline.main`` and the port's on the same seeded scp (two
    speakers from a diarization stand-in, silences, one recording off the
    target rate, ``merge_sessions`` on) write bit-identical segment wavs,
    equal metadata and ``sessions.json``, and an equal filter report."""
    from rstnet_tpu.pipeline import main as jax_main
    from rstnet_tpu_torch.pipeline import main as port_main

    _two_speaker_recordings(tmp_path)

    def turns(audio, sr, checkpoint=""):
        d = len(audio) / sr
        return [{"start": 0.0, "end": 3.4, "speaker": "SPEAKER_00"},
                {"start": 3.4, "end": 7.5, "speaker": "SPEAKER_01"},
                {"start": 7.5, "end": d, "speaker": "SPEAKER_00"}]

    monkeypatch.setattr(jax_main, "pyannote_diarize", turns)
    monkeypatch.setattr(port_main, "pyannote_diarize", turns)
    cfg = {"use_diarization": True, "merge_sessions": True, "session_chunk_s": 60.0,
           "min_segment_s": 1.0, "max_segment_s": 30.0, "use_denoise": True,
           "use_super_resolution": True}
    (tmp_path / "cfg.json").write_text(json.dumps(cfg))
    outs = {}
    for name, mod in (("jax", jax_main), ("port", port_main)):
        out_dir = tmp_path / name
        outs[name] = mod.main(["--scp", str(tmp_path / "raw.scp"), "--out_dir", str(out_dir),
                               "--config", str(tmp_path / "cfg.json")])
    assert outs["port"] == outs["jax"]
    assert outs["port"]["segments"] >= 4 and outs["port"]["sessions"] >= 2
    got = {}
    for name in ("jax", "port"):
        root = str(tmp_path / name)
        got[name] = {f: _relative(json.loads((tmp_path / name / f).read_text()), root)
                     for f in ("segments.json", "filter_report.json", "sessions.json")}
        got[name]["wav.scp"] = _relative([list(e) for e in read_scp(str(tmp_path / name / "wav.scp"))],
                                         root)
    assert got["port"] == got["jax"]
    speakers = {s["speaker"] for s in got["port"]["segments.json"]}
    assert speakers == {"SPEAKER_00", "SPEAKER_01"}
    wavs = sorted(p.name for p in (tmp_path / "port" / "wav").iterdir())
    assert wavs == sorted(p.name for p in (tmp_path / "jax" / "wav").iterdir())
    assert len(wavs) == outs["port"]["segments"]
    for w in wavs:
        assert (tmp_path / "port" / "wav" / w).read_bytes() == \
            (tmp_path / "jax" / "wav" / w).read_bytes(), w


def test_vad_and_segment_stages_equal_jax():
    """``energy_vad``, ``subdivide_turns``, ``cut_by_speaker_label``,
    ``merge_session_segments`` and ``calculate_audio_stats`` give the JAX
    functions' results on seeded inputs."""
    from rstnet_tpu.pipeline import diarize as jd
    from rstnet_tpu.pipeline import filters as jf
    from rstnet_tpu.pipeline import vad as jv

    rng = np.random.default_rng(5)
    sr = 8000
    wav = np.zeros(sr * 50, np.float32)
    for start in rng.uniform(0, 48, 9):
        n = int(sr * rng.uniform(0.2, 4.0))
        a = int(sr * start)
        wav[a: a + n] = (0.4 * rng.standard_normal(len(wav[a: a + n]))).astype(np.float32)
    for kw in ({}, {"min_speech_s": 1.0, "min_gap_s": 0.4}, {"threshold_db": -20.0}):
        assert [s.to_dict() for s in energy_vad(wav, sr, **kw)] == \
            [s.to_dict() for s in jv.energy_vad(wav, sr, **kw)]
    turns = [{"start": float(a), "end": float(a + d), "speaker": f"S{i % 2}"}
             for i, (a, d) in enumerate(zip(np.sort(rng.uniform(0, 45, 6)),
                                            rng.uniform(0.5, 40, 6)))]
    fine = subdivide_turns(turns, wav, sr, max_direct_s=10.0)
    assert fine == jd.subdivide_turns(turns, wav, sr, max_direct_s=10.0)
    for kw in ({}, {"merge_gap_s": 1.0, "min_segment_s": 0.5, "max_segment_s": 8.0}):
        cut = cut_by_speaker_label(fine, **kw)
        assert cut == jd.cut_by_speaker_label(fine, **kw)
        assert merge_session_segments(cut, chunk_size_s=20.0) == \
            jd.merge_session_segments(cut, chunk_size_s=20.0)
    segments = [{"start": 0.0, "end": float(d), "text": "a" * int(n), "dnsmos": float(m),
                 "language": lang}
                for d, n, m, lang in zip(rng.uniform(0.5, 40, 12), rng.integers(0, 60, 12),
                                         rng.uniform(2, 4.5, 12), ["en", "zh", "fr"] * 4)]
    kw = dict(min_duration=2.0, max_duration=30.0, min_dnsmos=3.0, min_char_count=3,
              supported_languages=["en", "zh"])
    assert calculate_audio_stats(segments, **kw) == jf.calculate_audio_stats(segments, **kw)


def test_onnx_harnesses_equal_jax():
    """DNSMOS and the MDX separator through injected sessions, and the numpy
    STFT pair, give the JAX package's outputs exactly."""
    from rstnet_tpu.pipeline import onnx_models as jo
    from rstnet_tpu_torch.pipeline import onnx_models as po

    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 3000))
    np.testing.assert_array_equal(po.stft_np(x, 256, 64), jo.stft_np(x, 256, 64))
    spec = jo.stft_np(x, 256, 64)
    np.testing.assert_array_equal(po.istft_np(spec, 256, 64, 3000),
                                  jo.istft_np(spec, 256, 64, 3000))
    clip = (0.2 * rng.standard_normal(16000 * 11)).astype(np.float32)
    for personalized in (False, True):
        assert po.DNSMOS(session=_StubSession(), personalized=personalized).score(clip, 24000) \
            == jo.DNSMOS(session=_StubSession(), personalized=personalized).score(clip, 24000)

    class Halve:
        def run(self, _outputs, feeds):
            (_, arr), = feeds.items()
            return [0.5 * np.asarray(arr)]

    kw = dict(dim_f=512, dim_t_log2=4, n_fft=1024, hop=256, chunk_seconds=1.0, margin=2205)
    mix = (0.3 * rng.standard_normal((2, 44100 * 2))).astype(np.float32)
    for denoise in (False, True):
        mine = po.MDXSeparator(session=Halve(), denoise=denoise, **kw).separate(mix, 44100)
        theirs = jo.MDXSeparator(session=Halve(), denoise=denoise, **kw).separate(mix, 44100)
        for a, b in zip(mine, theirs):
            np.testing.assert_array_equal(a, b)


def test_run_jobs_and_create_data_json_clis_match_jax(tmp_path):
    """The two CLIs' files and exit codes equal the JAX tools' on the same
    arguments, ``--max-parallel`` included."""
    from rstnet_tpu.tools import create_data_json as jc
    from rstnet_tpu.tools import run_jobs as jr
    from rstnet_tpu_torch.tools import create_data_json as pc
    from rstnet_tpu_torch.tools import run_jobs as pr

    for name, mod in (("jax", jr), ("port", pr)):
        cmd = [sys.executable, "-c", "import sys; print('job JOB'); sys.exit(JOB == 3)"]
        rc = mod.main(["--jobs", "4", "--max-parallel", "2", "--log",
                       str(tmp_path / name / "log" / "j.JOB.log"), "--", *cmd])
        assert rc == 1  # job 3 fails
        for task, extra in (("audio_only", ["--audio_seq", "a.npz"]),
                            ("text_only", ["--text_seq", "t.npz"]),
                            ("moshi_ft", ["--audio_seq", "m.npz", "--text_seq", "t.npz"])):
            mod_json = jc if name == "jax" else pc
            mod_json.main(["--task", task, *extra, "--output",
                           str(tmp_path / name / "jsons" / f"{task}.json")])
    for rel in [f"log/j.{i}.log" for i in range(1, 5)] + [
            f"jsons/{t}.json" for t in ("audio_only", "text_only", "moshi_ft")]:
        assert (tmp_path / "port" / rel).read_text() == (tmp_path / "jax" / rel).read_text(), rel
