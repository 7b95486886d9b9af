"""ONNX-session inference for the data-pipeline quality models
(counterpart of ``rstnet_tpu/pipeline/onnx_models.py``).

From-scratch numpy implementations of the two ONNX model harnesses the
reference data pipeline runs at prep time:

- DNSMOS perceptual quality scoring (reference:
  ``MLLM_v2/egs/pretraining/data_scripts/emilia/models/dnsmos.py:27-174``):
  9.01 s sliding windows at 1 s hop over the clip, tile-padding short clips,
  raw SIG/BAK/OVRL heads plus the published polynomial correction, averaged
  over hops.
- UVR-MDX vocal separation (reference: ``emilia/models/separate_fast.py``):
  margin-overlapped chunking, centered STFT framing into the ConvTDF net's
  [B, 4, dim_f, dim_t] stereo real/imag layout, spectrogram masking by the
  ONNX model, inverse STFT with margin trimming, vocals + instrumental.

Both accept an injected ``session`` object (anything with ``.run``) so the
framing/aggregation logic is unit-testable without onnxruntime; with a
``model_path`` they build a real ``onnxruntime.InferenceSession``. These run
on the data-prep host (CPU), never on the card.
"""

from __future__ import annotations

import numpy as np

# DNSMOS operating point (microsoft/DNS-Challenge published constants)
DNSMOS_SR = 16000
DNSMOS_INPUT_SECONDS = 9.01
# polynomial MOS corrections (model constants shipped with DNSMOS)
_POLY_OVR = (-0.06766283, 1.11546468, 0.04602535)
_POLY_SIG = (-0.08397278, 1.22083953, 0.0052439)
_POLY_BAK = (-0.13166888, 1.60915514, -0.39604546)
_POLY_P_OVR = (-0.00533021, 0.005101, 1.18058466, -0.11236046)
_POLY_P_SIG = (-0.01019296, 0.02751166, 1.19576786, -0.24348726)
_POLY_P_BAK = (-0.04976499, 0.44276479, -0.1644611, 0.96883132)


def _make_session(model_path: str):
    try:
        import onnxruntime as ort
    except ImportError as e:
        raise RuntimeError(
            "onnxruntime is not installed; install it on the data-prep host "
            "or inject a precomputed-score path"
        ) from e
    return ort.InferenceSession(model_path, providers=["CPUExecutionProvider"])


def _resample(wav: np.ndarray, sr: int, target: int) -> np.ndarray:
    if sr == target:
        return wav
    from rstnet_tpu_torch.utils.audio import resample_linear

    return resample_linear(wav[None], sr, target)[0]


class DNSMOS:
    """DNSMOS P.835 primary-model scorer over an ONNX session.

    ``score(audio, sr)`` returns the per-clip dict with raw and
    polynomial-corrected SIG/BAK/OVRL, averaged over the 9.01 s hops.
    """

    def __init__(self, model_path: str = "", session=None,
                 personalized: bool = False):
        if session is None:
            if not model_path:
                raise RuntimeError("DNSMOS needs a model_path or a session")
            session = _make_session(model_path)
        self.session = session
        self.personalized = personalized
        # input name differs across exported model versions; probe if possible
        self.input_name = "input_1"
        get_inputs = getattr(session, "get_inputs", None)
        if get_inputs:
            try:
                self.input_name = get_inputs()[0].name
            except Exception:  # noqa: BLE001 - stub sessions may not implement
                pass

    @staticmethod
    def _poly(coeffs: tuple, x: float) -> float:
        out = 0.0
        for c in coeffs:
            out = out * x + c
        return out

    def score(self, audio: np.ndarray, sr: int) -> dict:
        fs = DNSMOS_SR
        audio = _resample(np.asarray(audio, np.float32).reshape(-1), sr, fs)
        actual_len = len(audio)
        win = int(DNSMOS_INPUT_SECONDS * fs)
        if len(audio) == 0:
            # doubling an empty array never grows it; score silence instead
            audio = np.zeros(win, np.float32)
        # tile short clips up to one full window (reference framing)
        while len(audio) < win:
            audio = np.concatenate([audio, audio])
        num_hops = int(np.floor(len(audio) / fs) - DNSMOS_INPUT_SECONDS) + 1
        raw = []
        for h in range(max(num_hops, 1)):
            seg = audio[h * fs : h * fs + win]
            if len(seg) < win:
                continue
            feats = seg.astype(np.float32)[None, :]
            out = self.session.run(None, {self.input_name: feats})[0][0]
            raw.append(np.asarray(out, np.float64).reshape(-1)[:3])
        raw = np.stack(raw)  # [H, 3] = sig, bak, ovr
        if self.personalized:
            polys = (_POLY_P_SIG, _POLY_P_BAK, _POLY_P_OVR)
        else:
            polys = (_POLY_SIG, _POLY_BAK, _POLY_OVR)
        fit = np.stack([
            [self._poly(p, v) for p, v in zip(polys, row)] for row in raw
        ])
        return {
            "len_in_sec": actual_len / fs,
            "num_hops": len(raw),
            "SIG_raw": float(raw[:, 0].mean()),
            "BAK_raw": float(raw[:, 1].mean()),
            "OVRL_raw": float(raw[:, 2].mean()),
            "SIG": float(fit[:, 0].mean()),
            "BAK": float(fit[:, 1].mean()),
            "OVRL": float(fit[:, 2].mean()),
        }


# ---------------------------------------------------------------------------
# UVR-MDX separation
# ---------------------------------------------------------------------------


def _hann(n_fft: int) -> np.ndarray:
    # periodic hann, matching the separator's analysis window
    return 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n_fft) / n_fft)


def stft_np(x: np.ndarray, n_fft: int, hop: int) -> np.ndarray:
    """Centered STFT. x: [B, T] -> complex [B, n_bins, frames]."""
    window = _hann(n_fft)
    pad = n_fft // 2
    xp = np.pad(x, ((0, 0), (pad, pad)), mode="reflect")
    n_frames = 1 + (xp.shape[1] - n_fft) // hop
    idx = np.arange(n_fft)[None, :] + hop * np.arange(n_frames)[:, None]
    frames = xp[:, idx] * window
    return np.fft.rfft(frames, axis=-1).transpose(0, 2, 1)


def istft_np(spec: np.ndarray, n_fft: int, hop: int, length: int) -> np.ndarray:
    """Inverse of :func:`stft_np`. spec: complex [B, n_bins, frames]."""
    window = _hann(n_fft)
    frames = np.fft.irfft(spec.transpose(0, 2, 1), n=n_fft, axis=-1)
    B, F, _ = frames.shape
    total = n_fft + hop * (F - 1)
    out = np.zeros((B, total))
    wsum = np.zeros(total)
    for f in range(F):
        out[:, f * hop : f * hop + n_fft] += frames[:, f] * window
        wsum[f * hop : f * hop + n_fft] += window * window
    out = out / np.maximum(wsum, 1e-8)
    pad = n_fft // 2
    return out[:, pad : pad + length]


class MDXSeparator:
    """UVR-MDX-style vocal separator over an ONNX spectrogram-mask model.

    ``separate(mix, sr)`` -> (vocals, instrumental), both [T] at the input
    rate. The model consumes [B, 4, dim_f, dim_t] (stereo x real/imag of a
    centered STFT, frequency-cropped to dim_f) and emits the same layout for
    the vocal estimate.
    """

    MODEL_SR = 44100  # UVR-MDX checkpoints are trained at 44.1 kHz

    def __init__(self, model_path: str = "", session=None, dim_f: int = 3072,
                 dim_t_log2: int = 8, n_fft: int = 6144, hop: int = 1024,
                 chunk_seconds: float = 15.0, margin: int = 44100,
                 denoise: bool = False):
        if session is None:
            if not model_path:
                raise RuntimeError("MDXSeparator needs a model_path or a session")
            session = _make_session(model_path)
        self.session = session
        self.dim_f = dim_f
        self.dim_t = 2 ** dim_t_log2
        self.n_fft = n_fft
        self.hop = hop
        self.n_bins = n_fft // 2 + 1
        self.window_size = hop * (self.dim_t - 1)  # samples per STFT block
        self.chunk_size = int(chunk_seconds * self.MODEL_SR)
        self.margin = min(margin, self.chunk_size)
        self.denoise = denoise
        self.input_name = "input"
        get_inputs = getattr(session, "get_inputs", None)
        if get_inputs:
            try:
                self.input_name = get_inputs()[0].name
            except Exception:  # noqa: BLE001
                pass

    def _spec(self, waves: np.ndarray) -> np.ndarray:
        """[N, 2, window_size] stereo windows -> [N, 4, dim_f, dim_t]."""
        N = waves.shape[0]
        spec = stft_np(waves.reshape(N * 2, self.window_size), self.n_fft, self.hop)
        # interleave real/imag per channel: [N, 2ch x 2(re,im), bins, T]
        ri = np.stack([spec.real, spec.imag], axis=1)  # [N*2, 2, bins, T]
        ri = ri.reshape(N, 4, self.n_bins, self.dim_t)
        return ri[:, :, : self.dim_f].astype(np.float32)

    def _waves(self, spec4: np.ndarray) -> np.ndarray:
        """[N, 4, dim_f, dim_t] -> [N, 2, window_size]."""
        N = spec4.shape[0]
        full = np.zeros((N, 4, self.n_bins, self.dim_t), np.float32)
        full[:, :, : self.dim_f] = spec4
        ri = full.reshape(N * 2, 2, self.n_bins, self.dim_t)
        spec = ri[:, 0] + 1j * ri[:, 1]
        waves = istft_np(spec, self.n_fft, self.hop, self.window_size)
        return waves.reshape(N, 2, self.window_size)

    def _run_model(self, spec4: np.ndarray) -> np.ndarray:
        if self.denoise:
            # noise-invariant trick: average over the +/- input polarity
            neg = self.session.run(None, {self.input_name: -spec4})[0]
            pos = self.session.run(None, {self.input_name: spec4})[0]
            return 0.5 * (pos - neg)
        return self.session.run(None, {self.input_name: spec4})[0]

    def _demix_chunk(self, cmix: np.ndarray) -> np.ndarray:
        """cmix: [2, n] stereo chunk -> vocal estimate [2, n]."""
        n = cmix.shape[1]
        trim = self.n_fft // 2
        gen = self.window_size - 2 * trim  # fresh samples per block
        pad = gen - n % gen if n % gen else 0
        mix_p = np.concatenate(
            [np.zeros((2, trim)), cmix, np.zeros((2, pad + trim))], axis=1
        )
        windows = []
        for i in range(0, n + pad, gen):
            windows.append(mix_p[:, i : i + self.window_size])
        waves = np.stack(windows).astype(np.float32)  # [N, 2, window]
        out = self._run_model(self._spec(waves))
        tar = self._waves(np.asarray(out))  # [N, 2, window]
        # keep each block's interior and concatenate
        sig = tar[:, :, trim:-trim].transpose(1, 0, 2).reshape(2, -1)
        return sig[:, : n] if pad == 0 else sig[:, : -(pad)][:, :n]

    def separate(self, mix: np.ndarray, sr: int) -> tuple[np.ndarray, np.ndarray]:
        mono_in = np.asarray(mix, np.float32)
        if mono_in.ndim == 1:
            stereo = np.stack([mono_in, mono_in])
        else:
            stereo = mono_in
        stereo44 = np.stack([_resample(c, sr, self.MODEL_SR) for c in stereo])
        samples = stereo44.shape[1]
        chunk = self.chunk_size if samples > self.chunk_size else samples
        pieces = []
        skip = 0
        while skip < samples:
            s_margin = 0 if skip == 0 else self.margin
            end = min(skip + chunk + self.margin, samples)
            seg = stereo44[:, skip - s_margin : end]
            voc = self._demix_chunk(seg)
            lead = s_margin
            tail = voc.shape[1] if end == samples else voc.shape[1] - self.margin
            pieces.append(voc[:, lead:tail])
            skip += chunk
            if end == samples:
                break
        vocals44 = np.concatenate(pieces, axis=1)[:, :samples]
        inst44 = stereo44 - vocals44
        vocals = _resample(vocals44.mean(axis=0), self.MODEL_SR, sr)
        inst = _resample(inst44.mean(axis=0), self.MODEL_SR, sr)
        n = len(np.asarray(mix, np.float32).reshape(2, -1)[0]) if mono_in.ndim > 1 else len(mono_in)
        return vocals[:n], inst[:n]
