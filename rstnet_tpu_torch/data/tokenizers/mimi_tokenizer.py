"""Offline audio tokenizer: waveform -> 8 x 12.5 Hz Mimi codes (counterpart
of ``rstnet_tpu/data/tokenizers/mimi_tokenizer.py``).

Loads kyutai Mimi weights into this package's codec (``models/convert.py``),
encodes to int16 codes for compact storage and decodes back. Inputs are
padded up to a power-of-two number of frames, as in JAX (where the bucket
bounds the jitted programs; here it keeps the codes equal to JAX's, whose
encoder sees the same padding). ``MimiModel.encode`` sends more than 64 rows
to K3's tiled path on the card. Random weights are drawn (seed 0) only when
neither a checkpoint nor a model is given: useful for pipeline tests only.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from rstnet_tpu_torch.data.tokenizers.abs_tokenizer import AbsTokenizer
from rstnet_tpu_torch.utils.audio import resample_linear


class MimiTokenizer(AbsTokenizer):
    def __init__(self, checkpoint_path: Optional[str] = None, model=None, device="cuda"):
        from rstnet_tpu_torch.models.mimi import mimi_24k

        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"MimiTokenizer(device={device!r}): torch sees no CUDA device "
                               "(pass device='cpu' to tokenize on the CPU)")
        if model is None:
            model = mimi_24k(device=self.device,
                             generator=torch.Generator(device=self.device).manual_seed(0))
        self.model = model.to(self.device)
        if checkpoint_path is not None:
            from rstnet_tpu_torch.models.convert import load_mimi

            load_mimi(checkpoint_path, self.model)
        self.sr = self.model.sample_rate

    @property
    def is_discrete(self) -> bool:
        return True

    @property
    def codebook_length(self) -> int:
        return self.model.num_codebooks * self.model.quantizer.bins

    def find_length(self, x) -> int:
        return int(np.shape(x)[-1])

    def _bucket_pad(self, wav: np.ndarray) -> tuple[np.ndarray, int]:
        """Pad to a whole number of frames at a power-of-two frame count."""
        fs = self.model.frame_size
        n_frames = max(1, math.ceil(wav.shape[-1] / fs))
        bucket = 1 << (n_frames - 1).bit_length()
        padded = np.zeros(wav.shape[:-1] + (bucket * fs,), np.float32)
        padded[..., : wav.shape[-1]] = wav
        return padded, n_frames

    @torch.no_grad()
    def tokenize(self, wav, sample_rate: Optional[int] = None) -> np.ndarray:
        """wav [T] or [1, T] float -> codes [K, frames] int16."""
        wav = np.asarray(wav, np.float32)
        if wav.ndim == 1:
            wav = wav[None]
        if sample_rate is not None and sample_rate != self.sr:
            wav = resample_linear(wav, sample_rate, self.sr)
        padded, n_frames = self._bucket_pad(wav)
        codes = self.model.encode(torch.from_numpy(padded[None]).to(self.device))
        return codes[0, :, :n_frames].cpu().numpy().astype(np.int16)

    @torch.no_grad()
    def detokenize(self, codes) -> np.ndarray:
        """codes [K, frames] -> wav [1, samples] float32."""
        codes = np.asarray(codes, np.int32)
        assert codes.shape[0] == self.model.num_codebooks
        wav = self.model.decode(torch.from_numpy(codes[None]).long().to(self.device))
        return wav[0].float().cpu().numpy()
