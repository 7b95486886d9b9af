"""Offline codec/text tokenization CLI (counterpart of
``rstnet_tpu/tools/offline_tokenization.py``, same ``.npz`` shards).

Capability parity with
``MLLM_v2/egs/pretraining/local/offline_codec_tokenization.py`` and
``data_scripts/offline_tokenization.py``: iterate a wav.scp (or a text scp),
tokenize each utterance (audio -> int16 Mimi codes; text -> BPE ids or
word-aligned frames from whisperX segment jsons), and save one .npz shard —
the storage format the training data layer consumes.

    python -m rstnet_tpu_torch.tools.offline_tokenization --scp wav.scp \
        --output audio.npz [--mode audio|ssl|text|aligned_text|duplex] \
        [--mimi-checkpoint M] [--ssl-checkpoint S] [--tokenizer-dir D] [--device cpu]

Mimi and the WhisperVQ tokenizer (``--mode ssl``: 12.5 Hz GLM-4-Voice
semantic tokens, ``[1, T]`` a shard entry) run on ``--device`` (``cuda``
unless ``cpu`` is given), in float32 with TF32 off, as the reference runs.
"""

from __future__ import annotations

import argparse
import json
import logging
import os

import numpy as np


from rstnet_tpu_torch.tools.scp_tools import read_scp
from rstnet_tpu_torch.utils.audio import read_wav


def _ensure_parent(path: str) -> None:
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)


def _wav_entries(scp: str) -> list[tuple[str, str]]:
    """Accept both ``utt path`` and bare-path scp conventions."""
    from pathlib import Path

    return [
        (Path(k).stem, k) if not v else (k, v) for k, v in read_scp(scp)
    ]


def tokenize_audio_scp(scp: str, out: str, checkpoint: str = "", device: str = "cuda") -> int:
    from rstnet_tpu_torch.data.tokenizers.mimi_tokenizer import MimiTokenizer

    tok = MimiTokenizer(checkpoint_path=checkpoint or None, device=device)
    data = {}
    for utt, path in _wav_entries(scp):
        try:
            wav, sr = read_wav(path)
        except Exception as e:  # noqa: BLE001
            logging.warning(f"skipping {utt}: {e}")
            continue
        data[utt] = tok.tokenize(wav[0], sr)
    _ensure_parent(out)
    np.savez(out, **data)
    return len(data)


def tokenize_ssl_scp(scp: str, out: str, checkpoint: str, device: str = "cuda") -> int:
    """wav.scp -> 12.5 Hz WhisperVQ semantic tokens, ``[1, T]`` int32 an
    utterance (the reference's ``offline_codec_tokenization.py``
    tokenizer=ssl)."""
    from rstnet_tpu_torch.data.tokenizers.ssl_tokenizer import SSLTokenizer

    tok = SSLTokenizer(checkpoint=checkpoint, device=device)
    data = {}
    for utt, path in _wav_entries(scp):
        try:
            wav, sr = read_wav(path)
        except Exception as e:  # noqa: BLE001
            logging.warning(f"skipping {utt}: {e}")
            continue
        data[utt] = tok.tokenize(wav[0], sr)[None]  # [1, T] single codebook
    _ensure_parent(out)
    np.savez(out, **data)
    return len(data)


def _text_tokenizer(tokenizer_dir: str):
    """Word-alignment text tokenizer wired to the repo's special-token ids."""
    from rstnet_tpu_torch.data.collate import SpecialTokens
    from rstnet_tpu_torch.data.tokenizers.text_tokenizer import TextTokenizer

    return TextTokenizer(
        tokenizer_dir,
        pad_id=SpecialTokens.text_pad,
        epad_id=SpecialTokens.text_empty_pad,
    )


def _duplex_grids(
    codes: tuple[np.ndarray, np.ndarray],
    text: tuple[np.ndarray | None, np.ndarray | None] = (None, None),
    both_sides: bool = True,
) -> dict[str, np.ndarray]:
    """Channel codes (+ optional word-aligned text rows) -> moshi_ft grids.

    Returns ``{"_ch0": grid, ...}`` suffix-keyed ``[17, T]`` int32 grids,
    one per conversation side taking the Moshi role: row 0 is that side's
    word-aligned text (text-pad when no alignment exists), rows 1-8 its
    Mimi codes, rows 9-16 the peer's — the v1 ``moshi_ft`` storage format
    (``MLLM/egs/moshi_ft/data_scripts/offline_tokenization.py:139-155``,
    each conversation yields a ``utt_ch0`` and ``utt_ch1`` example).
    """
    from rstnet_tpu_torch.data.collate import SpecialTokens

    T = min(codes[0].shape[1], codes[1].shape[1])
    K = codes[0].shape[0]
    out = {}
    for side in range(2 if both_sides else 1):
        grid = np.full((1 + 2 * K, T), SpecialTokens.text_pad, np.int32)
        if text[side] is not None:
            row = np.asarray(text[side], np.int32)[:T]
            grid[0, : len(row)] = row
        grid[1 : 1 + K] = codes[side][:, :T]
        grid[1 + K :] = codes[1 - side][:, :T]
        out[f"_ch{side}"] = grid
    return out


def _aligned_text_row(ttok, meta: dict) -> np.ndarray:
    """whisperX metadata -> word-aligned 12.5 Hz text ids
    (reference ``tokenize_text``, ``offline_tokenization.py:69-99``)."""
    duration = meta.get("duration")
    if duration is None and meta.get("segments"):
        duration = meta["segments"][-1]["end"]
    word_list = ttok.tokenize_segment(meta.get("segments", []))
    return ttok.pad_tokens(word_list, float(duration or 0.0))


def tokenize_duplex_scp(
    scp: str, out: str, checkpoint: str = "",
    text_scp: str = "", tokenizer_dir: str = "", device: str = "cuda",
) -> int:
    """Stereo wav.scp -> ``[17, T]`` duplex grids (one channel per side).

    Fisher-style corpora store each conversation side on its own channel
    (reference ``MLLM/egs/moshi_ft/run.sh:52-120``). Each stereo input
    yields two examples, ``utt_ch0``/``utt_ch1`` (each side as Moshi); mono
    inputs get a silent peer channel and only the ``_ch0`` example. With
    ``text_scp`` (utt2json lines ``<utt>_ch0 <whisperx.json>``, the
    reference's ``--input-text-file``) + ``tokenizer_dir``, row 0 carries
    that side's word-aligned text.
    """
    from rstnet_tpu_torch.data.tokenizers.mimi_tokenizer import MimiTokenizer

    tok = MimiTokenizer(checkpoint_path=checkpoint or None, device=device)
    ttok = _text_tokenizer(tokenizer_dir) if tokenizer_dir else None
    utt2json: dict[str, str] = dict(read_scp(text_scp)) if text_scp else {}
    if utt2json and ttok is None:
        raise ValueError("--text-scp requires --tokenizer-dir")
    data = {}
    for utt, path in _wav_entries(scp):
        try:
            wav, sr = read_wav(path)
        except Exception as e:  # noqa: BLE001
            logging.warning(f"skipping {utt}: {e}")
            continue
        stereo = wav.shape[0] >= 2
        if not stereo:
            wav = np.concatenate([wav[:1], np.zeros_like(wav[:1])], axis=0)
        codes = (tok.tokenize(wav[0], sr), tok.tokenize(wav[1], sr))
        text: list[np.ndarray | None] = [None, None]
        for side in range(2):
            jpath = utt2json.get(f"{utt}_ch{side}")
            if jpath and ttok is not None:
                with open(jpath) as f:
                    text[side] = _aligned_text_row(ttok, json.load(f))
        for suffix, grid in _duplex_grids(
            codes, (text[0], text[1]), both_sides=stereo
        ).items():
            data[utt + suffix] = grid
    _ensure_parent(out)
    np.savez(out, **data)
    return len(data)


def _session_channel_map(sess: dict, label: str) -> dict[str, int]:
    """speaker -> channel, keeping the two most-speaking speakers.

    Diarization can see N speakers, but the duplex format is inherently
    2-channel (Fisher semantics, ``MLLM/egs/moshi_ft/run.sh:52-120``);
    merging extra voices onto one channel would corrupt the assistant
    stream, so they are dropped with a warning instead.
    """
    totals: dict[str, float] = {}
    for m in sess.get("segments", []):
        spk = m.get("speaker")
        totals[spk] = totals.get(spk, 0.0) + (
            float(m.get("end", 0.0)) - float(m.get("start", 0.0))
        )
    # stable under ties: insertion (first-seen) order breaks them
    ranked = sorted(totals, key=lambda s: -totals[s])
    kept = ranked[:2]
    if len(ranked) > 2:
        dropped = [s for s in ranked[2:]]
        n_seg = sum(1 for m in sess["segments"] if m.get("speaker") in dropped)
        logging.warning(
            f"{label}: {len(ranked)} speakers in a 2-channel duplex session; "
            f"dropping {n_seg} segment(s) from {dropped}"
        )
    return {spk: ch for ch, spk in enumerate(kept)}


def tokenize_duplex_sessions(
    sessions_json: str, out: str, checkpoint: str = "", tokenizer_dir: str = "",
    device: str = "cuda",
) -> int:
    """Pipeline ``sessions.json`` -> ``[17, T]`` duplex grids.

    Each session's member segments are rendered onto two channels by
    speaker (the two most-speaking speakers; others are dropped with a
    warning — the duplex format is inherently 2-channel), both channels are
    Mimi-tokenized, and each side yields a ``utt_chN`` example with itself
    as Moshi — the diarization-driven equivalent of Fisher's per-channel
    recording (reference ``emilia/main.py`` speaker labels + ``moshi_ft``
    prep). With ``tokenizer_dir``, the per-segment whisperX word alignments
    the pipeline's ASR stage stored (``pipeline/main.py`` ``use_asr``) are
    shifted to session time and rendered into row 0.
    """
    from rstnet_tpu_torch.data.tokenizers.mimi_tokenizer import MimiTokenizer
    from rstnet_tpu_torch.utils.audio import resample_linear

    tok = MimiTokenizer(checkpoint_path=checkpoint or None, device=device)
    ttok = _text_tokenizer(tokenizer_dir) if tokenizer_dir else None
    with open(sessions_json) as f:
        sessions = json.load(f)
    data = {}
    for i, sess in enumerate(sessions):
        s0, s1 = float(sess["start"]), float(sess["end"])
        n = max(1, int(round((s1 - s0) * tok.sr)))
        chans = np.zeros((2, n), np.float32)
        chan_of = _session_channel_map(sess, f"session {i}")
        word_lists: tuple[list, list] = ([], [])
        ok = True
        for m in sess["segments"]:
            ch = chan_of.get(m.get("speaker"))
            if ch is None:
                continue  # dropped extra speaker
            try:
                wav, msr = read_wav(m["path"])
            except Exception as e:  # noqa: BLE001
                logging.warning(f"session {i}: skipping {m.get('utt')}: {e}")
                ok = False
                break
            seg = wav[0]
            if msr != tok.sr:
                seg = resample_linear(seg[None], msr, tok.sr)[0]
            off = max(0, int(round((float(m["start"]) - s0) * tok.sr)))
            end = min(off + len(seg), n)
            chans[ch, off:end] = seg[: end - off]
            if ttok is not None and m.get("segments"):
                # whisperX word times are clip-relative; shift to session time
                shift = float(m["start"]) - s0
                for word in ttok.tokenize_segment(m["segments"]):
                    if "start" in word:
                        word = dict(word, start=word["start"] + shift)
                    word_lists[ch].append(word)
        if not ok:
            continue
        text: tuple[np.ndarray | None, np.ndarray | None] = (None, None)
        if ttok is not None:
            text = tuple(
                ttok.pad_tokens(sorted(wl, key=lambda w: w.get("start", 0.0)), s1 - s0)
                for wl in word_lists
            )
        utt = sess.get("utt") or f"session_{i:06d}"
        both = len(chan_of) > 1
        codes = (tok.tokenize(chans[0], tok.sr), tok.tokenize(chans[1], tok.sr))
        for suffix, grid in _duplex_grids(codes, text, both_sides=both).items():
            data[utt + suffix] = grid
    _ensure_parent(out)
    np.savez(out, **data)
    return len(data)


def tokenize_text_scp(scp: str, out: str, tokenizer_dir: str) -> int:
    from rstnet_tpu_torch.data.tokenizers.text_tokenizer import TextTokenizer

    tok = TextTokenizer(tokenizer_dir)
    data = {}
    for utt, text in read_scp(scp):
        data[utt] = tok.tokenize(text)
    _ensure_parent(out)
    np.savez(out, **data)
    return len(data)


def tokenize_aligned_json_scp(scp: str, out: str, tokenizer_dir: str) -> int:
    """scp of whisperX-style jsons -> word-aligned 12.5 Hz text frames."""
    from rstnet_tpu_torch.data.tokenizers.text_tokenizer import TextTokenizer

    tok = TextTokenizer(tokenizer_dir)
    data = {}
    for utt, path in read_scp(scp):
        with open(path) as f:
            meta = json.load(f)
        word_list = tok.tokenize_segment(meta["segments"])
        data[utt] = tok.pad_tokens(word_list, meta["duration"])[None]  # [1, T]
    _ensure_parent(out)
    np.savez(out, **data)
    return len(data)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--scp", default="",
                        help="wav/text scp (all modes except --sessions)")
    parser.add_argument("--sessions", default="",
                        help="pipeline sessions.json (mode=duplex)")
    parser.add_argument("--output", required=True, help=".npz shard")
    parser.add_argument("--mode", default="audio",
                        choices=["audio", "ssl", "text", "aligned_text", "duplex"])
    parser.add_argument("--mimi-checkpoint", default="")
    parser.add_argument("--ssl-checkpoint", default="",
                        help="GLM-4-Voice tokenizer checkpoint dir (mode=ssl)")
    parser.add_argument("--tokenizer-dir", default="",
                        help="text tokenizer dir (modes text/aligned_text; "
                             "enables word-aligned text row 0 in mode duplex)")
    parser.add_argument("--text-scp", default="",
                        help="utt2json scp '<utt>_chN <whisperx.json>' for "
                             "duplex text alignment (reference "
                             "--input-text-file format)")
    parser.add_argument("--device", default="cuda",
                        help="torch device for Mimi and WhisperVQ: cuda (default), cuda:N or cpu")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, force=True)
    if not args.scp and not (args.mode == "duplex" and args.sessions):
        parser.error("--scp is required (or --sessions with --mode duplex)")
    if args.mode in ("audio", "ssl", "duplex"):
        import torch

        if torch.device(args.device).type == "cuda":
            # the reference precision: true fp32 matmuls and convolutions
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
    if args.mode == "duplex":
        if args.sessions:
            n = tokenize_duplex_sessions(
                args.sessions, args.output, args.mimi_checkpoint,
                tokenizer_dir=args.tokenizer_dir, device=args.device,
            )
        else:
            n = tokenize_duplex_scp(
                args.scp, args.output, args.mimi_checkpoint,
                text_scp=args.text_scp, tokenizer_dir=args.tokenizer_dir, device=args.device,
            )
    elif args.mode == "audio":
        n = tokenize_audio_scp(args.scp, args.output, args.mimi_checkpoint, args.device)
    elif args.mode == "ssl":
        n = tokenize_ssl_scp(args.scp, args.output, args.ssl_checkpoint, args.device)
    elif args.mode == "text":
        n = tokenize_text_scp(args.scp, args.output, args.tokenizer_dir)
    else:
        n = tokenize_aligned_json_scp(args.scp, args.output, args.tokenizer_dir)
    logging.info(f"wrote {n} utterances to {args.output}")


if __name__ == "__main__":
    main()
