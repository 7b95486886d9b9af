"""In-the-wild data pipeline orchestrator (counterpart of
``rstnet_tpu/pipeline/main.py``).

    python -m rstnet_tpu_torch.pipeline.main --scp raw_wav.scp --out_dir OUT \
        [--config pipeline.json]

Capability parity with the Emilia-style pipeline
(``MLLM_v2/egs/pretraining/data_scripts/emilia/main.py``, 722 LoC) and the
moshi_ft prep chain (``MLLM/egs/moshi_ft/run.sh:52-280``). Per wav in an
scp: standardize (mono, target rate, loudness) -> optional source separation
-> speaker diarization (pyannote adapter, single-speaker fallback) ->
VAD subdivision of long turns -> speaker-aware merge/trim
(``cut_by_speaker_label``) -> optional denoise + super-resolution per
segment -> optional ASR+alignment -> optional DNSMOS scoring -> stats-based
filter with report -> write segment wavs + metadata (including ``speaker``)
+ optional duplex session packing. Config-driven (json); stages skip
gracefully when their external model is absent.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
from pathlib import Path

import numpy as np

from rstnet_tpu_torch.pipeline import adapters
from rstnet_tpu_torch.pipeline.diarize import (
    cut_by_speaker_label,
    merge_session_segments,
    pyannote_diarize,
    single_speaker_track,
    subdivide_turns,
)
from rstnet_tpu_torch.pipeline.filters import calculate_audio_stats
from rstnet_tpu_torch.pipeline.vad import ENGINES, energy_vad
from rstnet_tpu_torch.tools.scp_tools import read_scp
from rstnet_tpu_torch.utils.audio import read_wav, resample_linear, write_wav

DEFAULT_CONFIG = {
    "target_sr": 24000,
    "loudness_norm": 0.95,
    "use_separation": False,
    "separation_model": "",          # UVR-MDX onnx path
    "use_diarization": False,        # pyannote speaker turns when available
    "diarization_checkpoint": "pyannote/speaker-diarization-3.1",
    "vad": {"engine": "energy", "min_speech_s": 1.0, "min_gap_s": 0.4},
    "merge_gap_s": 2.0,              # cut_by_speaker_label constraints
    "min_segment_s": 1.0,
    "max_segment_s": 30.0,
    "use_denoise": False,            # DeepFilterNet per segment
    "use_super_resolution": False,   # AERO (or linear) to target_sr
    "use_asr": False,
    "asr_model": "large-v2",
    "use_dnsmos_filter": False,
    "dnsmos_model": "",              # DNSMOS onnx path
    "dnsmos_threshold": 3.0,
    "filter_min_duration_s": 0.0,    # stats filter (0 disables the bound)
    "filter_min_char_count": 0,
    "supported_languages": None,     # e.g. ["en", "zh"]: drop segments whose
                                     # ASR-detected language is off-target
                                     # (reference emilia/main.py:287-306)
    "merge_sessions": False,         # pack segments into duplex sessions
    "session_chunk_s": 60.0,
}


def standardize(wav: np.ndarray, sr: int, cfg: dict) -> tuple[np.ndarray, int]:
    mono = wav.mean(axis=0) if wav.ndim > 1 else wav
    target = cfg["target_sr"]
    if sr != target:
        mono = resample_linear(mono[None], sr, target)[0]
    peak = np.abs(mono).max()
    if peak > 0:
        mono = mono / peak * cfg["loudness_norm"]
    return mono.astype(np.float32), target


def _speaker_segments(audio: np.ndarray, sr: int, cfg: dict) -> list[dict]:
    """Diarization turns -> VAD subdivision -> speaker-aware merge/trim."""
    duration = len(audio) / sr
    turns = None
    if cfg.get("use_diarization"):
        try:
            turns = pyannote_diarize(
                audio, sr, checkpoint=cfg["diarization_checkpoint"]
            )
        except RuntimeError as e:
            logging.warning(f"diarization skipped ({e}); single-speaker track")
    if not turns:
        turns = single_speaker_track(duration)
    vad_cfg = dict(cfg.get("vad", {}))
    engine_fn = ENGINES.get(vad_cfg.pop("engine", "energy"), energy_vad)

    def engine(wav, rate):
        return engine_fn(wav, rate, **vad_cfg)

    fine = subdivide_turns(
        turns, audio, sr, vad_engine=engine,
        max_direct_s=cfg["max_segment_s"],
    )
    return cut_by_speaker_label(
        fine, merge_gap_s=cfg["merge_gap_s"],
        min_segment_s=cfg["min_segment_s"],
        max_segment_s=cfg["max_segment_s"],
    )


def process_utterance(
    utt: str, wav_path: str, out_dir: Path, cfg: dict,
) -> tuple[list[dict], dict]:
    """-> (segment metadata list, filter report)."""
    wav, sr = read_wav(wav_path)
    audio, sr = standardize(wav, sr, cfg)
    if cfg.get("use_separation"):
        audio = adapters.separate_vocals(
            audio, sr, model_path=cfg.get("separation_model", "")
        )
    segments = _speaker_segments(audio, sr, cfg)

    metas = []
    clips = []
    for i, seg in enumerate(segments):
        clip = audio[int(seg["start"] * sr) : int(seg["end"] * sr)]
        if cfg.get("use_denoise"):
            clip = adapters.denoise(clip, sr)
        if cfg.get("use_super_resolution"):
            clip = adapters.super_resolve(clip, sr, cfg["target_sr"])
        meta = {
            "utt": f"{utt}_{i:04d}", "source": wav_path,
            "start": seg["start"], "end": seg["end"],
            "duration": seg["end"] - seg["start"],
            "speaker": seg["speaker"],
        }
        if cfg.get("use_asr"):
            seg_tmp = out_dir / "wav" / f"{meta['utt']}.tmp.wav"
            os.makedirs(seg_tmp.parent, exist_ok=True)
            write_wav(str(seg_tmp), clip, sr)
            try:
                meta.update(
                    adapters.whisperx_transcribe(str(seg_tmp), cfg["asr_model"])
                )
                meta["text"] = " ".join(
                    s.get("text", "") for s in meta.get("segments", [])
                ).strip()
            except RuntimeError as e:
                logging.warning(f"{meta['utt']}: ASR skipped ({e})")
            finally:
                seg_tmp.unlink(missing_ok=True)
        if cfg.get("use_dnsmos_filter"):
            from rstnet_tpu_torch.evalsuite.metrics import dnsmos_score

            score = dnsmos_score(clip, sr, model_path=cfg.get("dnsmos_model", ""))
            if score is not None:
                meta["dnsmos"] = score
        metas.append(meta)
        clips.append(clip)

    valid_idx, report = calculate_audio_stats(
        metas,
        min_duration=cfg.get("filter_min_duration_s", 0.0),
        max_duration=cfg["max_segment_s"],
        min_dnsmos=cfg["dnsmos_threshold"],
        min_char_count=cfg.get("filter_min_char_count", 0),
        supported_languages=cfg.get("supported_languages"),
    )
    kept = []
    for idx in valid_idx:
        meta, clip = metas[idx], clips[idx]
        seg_path = out_dir / "wav" / f"{meta['utt']}.wav"
        os.makedirs(seg_path.parent, exist_ok=True)
        write_wav(str(seg_path), clip, sr)
        meta["path"] = str(seg_path)
        kept.append(meta)
    return kept, report


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--scp", required=True, help="wav.scp of raw recordings")
    parser.add_argument("--out_dir", required=True)
    parser.add_argument("--config", default="", help="pipeline config json")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, force=True)
    cfg = dict(DEFAULT_CONFIG)
    if args.config:
        with open(args.config) as f:
            cfg.update(json.load(f))
    out_dir = Path(args.out_dir)
    os.makedirs(out_dir, exist_ok=True)
    all_meta = []
    reports = {}
    all_sessions = []
    for utt, path in read_scp(args.scp):
        try:
            metas, report = process_utterance(utt, path, out_dir, cfg)
            all_meta.extend(metas)
            reports[utt] = report
            if cfg.get("merge_sessions"):
                # session packing is per source recording: start/end times
                # are source-relative, so sessions never span recordings
                all_sessions.extend(
                    merge_session_segments(
                        metas, chunk_size_s=cfg["session_chunk_s"]
                    )
                )
        except Exception as e:  # noqa: BLE001
            logging.warning(f"{utt} failed: {e}")
    with open(out_dir / "segments.json", "w") as f:
        json.dump(all_meta, f, indent=2)
    with open(out_dir / "filter_report.json", "w") as f:
        json.dump(reports, f, indent=2)
    # emit wav.scp of produced segments for the tokenization stage
    with open(out_dir / "wav.scp", "w") as f:
        for m in all_meta:
            f.write(f"{m['utt']} {m['path']}\n")
    out = {"segments": len(all_meta)}
    if cfg.get("merge_sessions"):
        with open(out_dir / "sessions.json", "w") as f:
            json.dump(all_sessions, f, indent=2)
        out["sessions"] = len(all_sessions)
    logging.info(f"pipeline produced {out}")
    return out


if __name__ == "__main__":
    main()
