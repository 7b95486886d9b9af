"""GLM-4-Voice semantic (WhisperVQ) tokenizer (counterpart of
``rstnet_tpu/data/tokenizers/ssl_tokenizer.py``).

audio -> 12.5 Hz single-codebook token ids through
:class:`~rstnet_tpu_torch.models.whisper_vq.WhisperVQEncoder`, loaded from
the GLM-4-Voice tokenizer checkpoint directory: 30 s chunks, each padded to
the token stride (2 x pool x 160 samples), its valid mel frames ceil(len /
160), and tokens harvested under the decimated mask. Input at another rate
is resampled linearly to 16 kHz first. ``detokenize`` runs the flow + HiFT
decoder (``models/glm4v_decoder.py``) from the ``glm-4-voice-decoder``
directory. Everything runs on ``device`` (``cuda`` unless ``cpu`` is
given).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from rstnet_tpu_torch.data.tokenizers.abs_tokenizer import AbsTokenizer

CHUNK_SECONDS = 30
SR = 16000


class SSLTokenizer(AbsTokenizer):
    """audio -> 12.5 Hz semantic token ids (single codebook)."""

    def __init__(self, checkpoint: str = "", model=None, decoder_checkpoint: str = "",
                 decoder=None, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"SSLTokenizer(device={device!r}): torch sees no CUDA device "
                               "(pass device='cpu' to tokenize on the CPU)")
        if model is None:
            if not checkpoint:
                raise RuntimeError("SSLTokenizer needs the GLM-4-Voice tokenizer checkpoint "
                                   "directory (or a model)")
            from rstnet_tpu_torch.models.whisper_vq import load_glm4v_encoder

            model = load_glm4v_encoder(checkpoint, device=self.device)
        self.model = model.to(self.device)
        self.sr = SR
        # samples a token: conv2's stride (2) x pooling x the mel hop (160)
        self.stride = 2 * model.config.pooling_kernel_size * 160
        self._decoder = decoder
        self._decoder_checkpoint = decoder_checkpoint

    @property
    def is_discrete(self) -> bool:
        return True

    def find_length(self, x) -> int:
        return int(np.shape(x)[-1])

    @torch.no_grad()
    def tokenize(self, wav, sample_rate: Optional[int] = None) -> np.ndarray:
        """mono waveform -> ``[T]`` int32 tokens (30 s chunks, harvested
        under the mask)."""
        from rstnet_tpu_torch.models.whisper_vq import log_mel_spectrogram

        wav = np.asarray(wav, np.float32).reshape(-1)
        if sample_rate is not None and sample_rate != self.sr:
            from rstnet_tpu_torch.utils.audio import resample_linear

            wav = resample_linear(wav[None], sample_rate, self.sr)[0]
        cfg = self.model.config
        chunk = self.sr * CHUNK_SECONDS
        tokens = []
        for off in range(0, len(wav), chunk):
            seg = wav[off : off + chunk]
            # ceil: a trailing partial mel frame still gives a token
            n_valid_mel = -(-len(seg) // 160)
            seg = np.pad(seg, (0, (-len(seg)) % self.stride))
            mel = log_mel_spectrogram(torch.from_numpy(seg).to(self.device), cfg.n_mels)
            mask = (torch.arange(mel.shape[1], device=self.device) < n_valid_mel).float()[None]
            ids, tok_mask = self.model.encode(mel[None], mask)
            tokens.append(ids[0][tok_mask[0] > 0.5].cpu().numpy())
        if not tokens:
            return np.zeros((0,), np.int32)
        return np.concatenate(tokens).astype(np.int32)

    def decoder(self):
        """The flow + HiFT decoder, loaded from ``decoder_checkpoint`` at
        first use."""
        if self._decoder is None:
            if not self._decoder_checkpoint:
                raise RuntimeError("SSL detokenization needs the glm-4-voice-decoder checkpoint "
                                   "directory (decoder_checkpoint=...) holding config.yaml + "
                                   "flow.pt + hift.pt")
            from rstnet_tpu_torch.models.glm4v_decoder import load_glm4v_decoder

            self._decoder = load_glm4v_decoder(self._decoder_checkpoint, device=self.device)
        return self._decoder

    @torch.no_grad()
    def detokenize(self, tokens, generator: Optional[torch.Generator] = None,
                   draw=None) -> np.ndarray:
        """``[T]`` semantic token ids -> 22.05 kHz waveform ``[samples]``
        (``GLM4VAudioDecoder.offline_inference``, its draws from ``draw`` or
        ``generator``)."""
        tokens = torch.as_tensor(np.asarray(tokens, np.int64).reshape(1, -1), device=self.device)
        wav = self.decoder().offline_inference(tokens, generator=generator, draw=draw)
        return wav[0].cpu().numpy()
