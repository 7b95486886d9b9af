"""Voice activity detection for segmenting in-the-wild audio (counterpart
of ``rstnet_tpu/pipeline/vad.py``).

Capability parity with the reference's VAD stages (silero VAD in
``egs/pretraining/data_scripts/emilia/models/silero_vad.py``; pyannote in
``MLLM/egs/moshi_ft local/vad_segment.py``): produce (start, end) speech
segments. A dependency-free energy VAD is the built-in engine; silero and
pyannote adapters activate when their packages/checkpoints exist.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class VadSegment:
    start: float
    end: float

    def to_dict(self) -> dict:
        return {"start": self.start, "end": self.end}


def energy_vad(
    wav: np.ndarray,
    sr: int,
    frame_ms: float = 30.0,
    threshold_db: float = -40.0,
    min_speech_s: float = 0.25,
    min_gap_s: float = 0.3,
    pad_s: float = 0.1,
) -> list[VadSegment]:
    """Frame-energy VAD with hysteresis merging. wav: [T] float."""
    frame = max(1, int(sr * frame_ms / 1000))
    n = len(wav) // frame
    if n == 0:
        return []
    energy = np.square(wav[: n * frame].reshape(n, frame)).mean(axis=1)
    db = 10 * np.log10(np.maximum(energy, 1e-12))
    ref = np.percentile(db, 95)
    active = db > (ref + threshold_db)
    segments: list[VadSegment] = []
    start = None
    for i, a in enumerate(active):
        if a and start is None:
            start = i
        elif not a and start is not None:
            segments.append(VadSegment(start * frame / sr, i * frame / sr))
            start = None
    if start is not None:
        segments.append(VadSegment(start * frame / sr, n * frame / sr))
    # merge close segments, drop short ones, pad
    merged: list[VadSegment] = []
    for seg in segments:
        if merged and seg.start - merged[-1].end < min_gap_s:
            merged[-1].end = seg.end
        else:
            merged.append(seg)
    out = []
    total = len(wav) / sr
    for seg in merged:
        if seg.end - seg.start >= min_speech_s:
            out.append(
                VadSegment(max(0.0, seg.start - pad_s), min(total, seg.end + pad_s))
            )
    return out


def silero_vad(wav: np.ndarray, sr: int, **kw) -> list[VadSegment]:
    """Silero VAD adapter. Falls back to the built-in energy VAD when the
    model cannot be loaded (no torch hub cache / no network) — external
    adapters must degrade gracefully, not fail the utterance."""
    try:
        import torch

        model, utils = torch.hub.load("snakers4/silero-vad", "silero_vad", onnx=False)
        get_speech_timestamps = utils[0]
        ts = get_speech_timestamps(torch.as_tensor(wav), model, sampling_rate=sr)
        return [VadSegment(t["start"] / sr, t["end"] / sr) for t in ts]
    except Exception as e:  # noqa: BLE001 - hub load fails in many ways offline
        import logging

        logging.warning(f"silero VAD unavailable ({e}); using energy VAD")
        kw = {k: v for k, v in kw.items() if k in ("min_speech_s", "min_gap_s")}
        return energy_vad(wav, sr, **kw)


def pyannote_vad(wav_path: str, **kw) -> list[VadSegment]:
    """pyannote segmentation adapter (requires pyannote.audio + checkpoint)."""
    from pyannote.audio import Pipeline

    pipe = Pipeline.from_pretrained("pyannote/voice-activity-detection")
    out = pipe(wav_path)
    return [VadSegment(s.start, s.end) for s in out.get_timeline().support()]


ENGINES = {"energy": energy_vad, "silero": silero_vad}
