"""Speaker diarization and speaker-aware segment post-processing
(counterpart of ``rstnet_tpu/pipeline/diarize.py``).

Capability parity with the reference Emilia pipeline's diarization chain
(``MLLM_v2/egs/pretraining/data_scripts/emilia/main.py:148-250`` and
``emilia/models/silero_vad.py:114-181``):

1. ``pyannote_diarize`` — speaker turns from pyannote (external adapter,
   graceful error offline); ``single_speaker_track`` is the no-model
   fallback that labels the whole recording as one speaker.
2. ``subdivide_turns`` — long speaker turns are re-segmented by VAD inside
   the turn; every sub-segment inherits the turn's speaker label.
3. ``cut_by_speaker_label`` — merge/trim/drop: force-trim turns longer than
   ``max_segment_s`` into max-size windows, merge adjacent same-speaker
   segments across small gaps, drop segments shorter than ``min_segment_s``.
4. ``merge_session_segments`` — pack consecutive segments into sessions of
   at most ``chunk_size_s`` split at long blanks (reference
   ``merge_segments``, ``main.py:427-467``), used for duplex (17-stream)
   data prep where both speakers of a conversation stay in one session.

All post-processing is pure Python over ``{"start","end","speaker"}`` dicts
so it is unit-testable with synthetic label tracks.
"""

from __future__ import annotations

import logging
from typing import Callable, Optional

import numpy as np

Segment = dict  # {"start": float, "end": float, "speaker": str, ...}


def single_speaker_track(duration_s: float, speaker: str = "SPEAKER_00") -> list[Segment]:
    """Fallback when no diarization model is available: one speaker turn."""
    return [{"start": 0.0, "end": float(duration_s), "speaker": speaker}]


def pyannote_diarize(
    wav: np.ndarray, sr: int, checkpoint: str = "pyannote/speaker-diarization-3.1",
    hf_token: Optional[str] = None,
) -> list[Segment]:
    """Speaker turns via pyannote.audio (external data-prep adapter).

    Raises RuntimeError with an actionable message when pyannote is not
    installed — callers fall back to :func:`single_speaker_track`.
    """
    try:
        from pyannote.audio import Pipeline
    except ImportError as e:
        raise RuntimeError(
            "pyannote.audio is not installed; install it on the data-prep "
            "host (plus a HF token for the diarization checkpoint) or run "
            "the pipeline with diarization disabled"
        ) from e
    import torch

    pipe = Pipeline.from_pretrained(checkpoint, use_auth_token=hf_token)
    waveform = torch.as_tensor(np.asarray(wav, np.float32))[None]
    annotation = pipe({"waveform": waveform, "sample_rate": sr})
    return [
        {"start": float(turn.start), "end": float(turn.end), "speaker": str(label)}
        for turn, _, label in annotation.itertracks(yield_label=True)
    ]


def subdivide_turns(
    turns: list[Segment], wav: np.ndarray, sr: int,
    vad_engine: Optional[Callable] = None, max_direct_s: float = 30.0,
) -> list[Segment]:
    """Fine-grained segmentation inside long speaker turns.

    Short turns (< ``max_direct_s``) pass through; longer ones are split by
    the VAD engine run on the turn's audio, each sub-segment labelled with
    the turn's speaker (reference ``silero_vad.vad``). Overlapping turns are
    serialized by clipping each turn to start after the previous end.
    """
    if vad_engine is None:
        from rstnet_tpu_torch.pipeline.vad import energy_vad

        vad_engine = energy_vad
    out: list[Segment] = []
    last_end = 0.0
    for turn in sorted(turns, key=lambda t: t["start"]):
        start, end = float(turn["start"]), float(turn["end"])
        if end <= last_end:
            continue  # fully inside an earlier turn
        # partial overlap (pyannote emits overlapped speech as overlapping
        # turns): serialize by clipping this turn to start after the
        # previous end, so no audio region lands in two segments
        start = max(start, last_end)
        last_end = end
        if end - start <= max_direct_s:
            out.append({"start": start, "end": end, "speaker": turn["speaker"]})
            continue
        clip = wav[int(start * sr) : int(end * sr)]
        for sub in vad_engine(clip, sr):
            out.append({
                "start": start + sub.start,
                "end": start + sub.end,
                "speaker": turn["speaker"],
            })
    return out


def cut_by_speaker_label(
    segments: list[Segment], merge_gap_s: float = 2.0,
    min_segment_s: float = 1.5, max_segment_s: float = 30.0,
) -> list[Segment]:
    """Merge/trim/drop segments under speaker-consistency constraints.

    Reference semantics (``emilia/main.py:185-250``): segments at or above
    ``max_segment_s`` are force-trimmed into consecutive max-size windows;
    an adjacent same-speaker segment is merged into its predecessor when the
    gap between them is under ``merge_gap_s`` and the merged span stays
    under ``max_segment_s``; segments shorter than ``min_segment_s`` are
    dropped at the end. (The reference ships MIN_SEGMENT_LENGTH=0, which
    makes its merge branch unreachable; here short same-speaker segments
    actually merge, which is the documented intent of the stage.)
    """
    merged: list[Segment] = []
    for seg in segments:
        seg = dict(seg)
        dur = seg["end"] - seg["start"]
        if dur >= max_segment_s:
            # force-trim to consecutive max-size windows
            cur = seg["start"]
            while seg["end"] - cur >= max_segment_s:
                piece = dict(seg)
                piece["start"], piece["end"] = cur, cur + max_segment_s
                merged.append(piece)
                cur += max_segment_s
            if seg["end"] - cur > 0:
                piece = dict(seg)
                piece["start"] = cur
                merged.append(piece)
            continue
        prev = merged[-1] if merged else None
        if (
            prev is not None
            and prev["speaker"] == seg["speaker"]
            and dur < min_segment_s
            and seg["start"] - prev["end"] < merge_gap_s
            and seg["end"] - prev["start"] < max_segment_s
        ):
            prev["end"] = seg["end"]
        else:
            merged.append(seg)
    kept = [s for s in merged if s["end"] - s["start"] >= min_segment_s]
    if len(kept) < len(segments):
        logging.debug(
            "cut_by_speaker_label: %d -> %d segments", len(segments), len(kept)
        )
    return kept


def merge_session_segments(
    segments: list[Segment], chunk_size_s: float = 60.0,
    blank_threshold_s: float = 3.0, length_threshold_s: float = 3.0,
) -> list[Segment]:
    """Pack consecutive segments into sessions of <= ``chunk_size_s``.

    A new session opens when adding the next segment would exceed the chunk
    size or when the blank before it exceeds ``blank_threshold_s``; sessions
    shorter than ``length_threshold_s`` are discarded. Each session keeps its
    member segments (with speakers) under ``"segments"`` — this is the unit
    duplex (17-stream) data prep consumes (reference ``merge_segments``).
    """
    if not segments:
        return []
    sessions: list[Segment] = []
    cur_start = segments[0]["start"]
    cur_end = cur_start
    members: list[Segment] = []

    def close():
        if members and cur_end - cur_start > length_threshold_s:
            sessions.append({
                "start": cur_start, "end": cur_end,
                "speakers": sorted({m["speaker"] for m in members}),
                "segments": members.copy(),
            })

    for seg in segments:
        if (seg["end"] - cur_start > chunk_size_s) or (
            seg["start"] - cur_end > blank_threshold_s
        ):
            close()
            cur_start = seg["start"]
            members = []
        cur_end = seg["end"]
        members.append(seg)
    close()
    return sessions
