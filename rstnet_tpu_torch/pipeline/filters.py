"""Segment quality filtering for the data pipeline (counterpart of
``rstnet_tpu/pipeline/filters.py``).

Parity with the reference Emilia filter stage (``emilia/main.py:372-424``
and ``emilia/utils/tool.py:276-340``): per-segment DNSMOS aggregation plus
statistics-based filtering — duration bounds, minimum MOS, minimum character
count, and an IQR outlier test on the average per-character duration (a
proxy for broken ASR alignments). Emits a filter report so recipes can see
what was dropped and why.
"""

from __future__ import annotations

import re

import numpy as np

_PUNCT = re.compile(r"[\s\.,!\?;:'\"“”‘’、。，！？；：]+")


def char_count(text: str) -> int:
    """Characters that carry speech content (punctuation/space stripped)."""
    return len(_PUNCT.sub("", text or ""))


def calculate_audio_stats(
    segments: list[dict], min_duration: float = 3.0, max_duration: float = 30.0,
    min_dnsmos: float = 3.0, min_char_count: int = 2,
    supported_languages: "list[str] | tuple[str, ...] | None" = None,
) -> tuple[list[int], dict]:
    """Return (indices of segments that pass, filter report).

    A segment passes when its duration is within bounds, its DNSMOS is at or
    above ``min_dnsmos`` (segments without a score pass this criterion — the
    model is optional), its text has at least ``min_char_count`` content
    characters (only when ASR text is present), its detected ``language`` is
    in ``supported_languages`` (when a list is given and the segment carries
    a detection — the reference's off-target language gate,
    ``emilia/main.py:287-306``), and its average per-character duration lies
    inside the utterance-level IQR fence [Q1 - 1.5 IQR, Q3 + 1.5 IQR].
    """
    rates = []
    for seg in segments:
        dur = float(seg["end"]) - float(seg["start"])
        n = char_count(seg.get("text", ""))
        if n > 0:
            rates.append(dur / n)
    if rates:
        q1, q3 = np.percentile(rates, 25), np.percentile(rates, 75)
        iqr = q3 - q1
        lo, hi = q1 - 1.5 * iqr, q3 + 1.5 * iqr
    else:
        lo, hi = 0.0, np.inf

    valid: list[int] = []
    reasons = {"duration": 0, "dnsmos": 0, "char_count": 0, "char_rate": 0,
               "language": 0}
    langs = (
        {ln.lower() for ln in supported_languages}
        if supported_languages else None
    )
    # force-trimmed windows are emitted as end = start + max_segment_s, whose
    # recomputed end-start can exceed the bound by one ulp — tolerate it
    tol = 1e-6
    for idx, seg in enumerate(segments):
        dur = float(seg["end"]) - float(seg["start"])
        n = char_count(seg.get("text", "")) if "text" in seg else None
        rate = dur / n if n else None
        ok = True
        if not (min_duration - tol <= dur <= max_duration + tol):
            reasons["duration"] += 1
            ok = False
        if seg.get("dnsmos") is not None and seg["dnsmos"] < min_dnsmos:
            reasons["dnsmos"] += 1
            ok = False
        if n is not None and n < min_char_count:
            reasons["char_count"] += 1
            ok = False
        if rate is not None and not (lo <= rate <= hi):
            reasons["char_rate"] += 1
            ok = False
        if (
            langs is not None
            and seg.get("language")
            and seg["language"].lower() not in langs
        ):
            reasons["language"] += 1
            ok = False
        if ok:
            valid.append(idx)

    scored = [s["dnsmos"] for s in segments if s.get("dnsmos") is not None]
    report = {
        "total": len(segments),
        "kept": len(valid),
        "dropped_by": reasons,
        "avg_dnsmos": float(np.mean(scored)) if scored else None,
        "char_rate_bounds": [float(lo), float(hi) if np.isfinite(hi) else None],
    }
    return valid, report
