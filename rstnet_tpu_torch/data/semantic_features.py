"""Frozen semantic teachers for codec distillation (counterpart of
``rstnet_tpu/data/semantic_features.py``).

16 kHz SSL feature extractors whose hidden states distill into the semantic
codebook: WavLM, HuBERT, Whisper and w2v-BERT through ``transformers`` (each
imports it only when built, and needs its checkpoint); ``precomputed``,
whose features are extracted offline and given to the train step; and
``none``, which turns distillation off.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


class SemanticTeacher:
    """``extract([B, 1, T16k]) -> [B, T50Hz, D]`` features."""

    feature_dim: int = 1024

    def extract(self, audio_16k: np.ndarray) -> np.ndarray:
        raise NotImplementedError


class _HiddenStateTeacher(SemanticTeacher):
    """A frozen ``transformers`` model; its layer ``layer`` hidden states."""

    def _run(self, inputs) -> np.ndarray:
        import torch

        with torch.no_grad():
            out = self.model(inputs, output_hidden_states=True)
            return out.hidden_states[self.layer].numpy()


class WavLMTeacher(_HiddenStateTeacher):
    def __init__(self, checkpoint: str, layer: int = 6):
        from transformers import WavLMModel

        self.model = WavLMModel.from_pretrained(checkpoint).eval()
        self.layer, self.feature_dim = layer, self.model.config.hidden_size

    def extract(self, audio_16k: np.ndarray) -> np.ndarray:
        import torch

        return self._run(torch.as_tensor(audio_16k[:, 0]))


class HubertTeacher(_HiddenStateTeacher):
    def __init__(self, checkpoint: str, layer: int = 9):
        from transformers import HubertModel

        self.model = HubertModel.from_pretrained(checkpoint).eval()
        self.layer, self.feature_dim = layer, self.model.config.hidden_size

    def extract(self, audio_16k: np.ndarray) -> np.ndarray:
        import torch

        return self._run(torch.as_tensor(audio_16k[:, 0]))


class WhisperTeacher(SemanticTeacher):
    """Whisper encoder hidden states; each clip is padded or trimmed to
    Whisper's 30 s mel window."""

    def __init__(self, checkpoint: str, layer: int = -1):
        from transformers import WhisperFeatureExtractor, WhisperModel

        self.model = WhisperModel.from_pretrained(checkpoint).eval()
        self.fe = WhisperFeatureExtractor.from_pretrained(checkpoint)
        self.layer, self.feature_dim = layer, self.model.config.d_model

    def extract(self, audio_16k: np.ndarray) -> np.ndarray:
        import torch

        with torch.no_grad():
            feats = self.fe(list(audio_16k[:, 0]), sampling_rate=16000,
                            return_tensors="pt").input_features
            enc = self.model.encoder(feats, output_hidden_states=True)
            return enc.hidden_states[self.layer].numpy()


class W2vBertTeacher(_HiddenStateTeacher):
    """w2v-BERT 2.0 hidden states."""

    def __init__(self, checkpoint: str, layer: int = 12):
        from transformers import AutoFeatureExtractor, Wav2Vec2BertModel

        self.model = Wav2Vec2BertModel.from_pretrained(checkpoint).eval()
        self.fe = AutoFeatureExtractor.from_pretrained(checkpoint)
        self.layer, self.feature_dim = layer, self.model.config.hidden_size

    def extract(self, audio_16k: np.ndarray) -> np.ndarray:
        feats = self.fe(list(audio_16k[:, 0]), sampling_rate=16000,
                        return_tensors="pt").input_features
        return self._run(feats)


class PrecomputedTeacher(SemanticTeacher):
    """Features extracted offline; the train step takes them directly."""

    def __init__(self, feature_dim: int = 1024):
        self.feature_dim = feature_dim

    def extract(self, audio_16k: np.ndarray) -> np.ndarray:
        raise RuntimeError("precomputed teacher: pass features through the batch")


class NullTeacher(SemanticTeacher):
    """Turns distillation off (zero distillation loss)."""

    def __init__(self, feature_dim: int = 1024):
        self.feature_dim = feature_dim

    def extract(self, audio_16k: np.ndarray) -> np.ndarray:
        B, _, T = audio_16k.shape
        return np.zeros((B, T // 320, self.feature_dim), np.float32)


def build_teacher(kind: str, checkpoint: Optional[str] = None, **kw) -> SemanticTeacher:
    hf = {"wavlm": WavLMTeacher, "hubert": HubertTeacher, "whisper": WhisperTeacher,
          "w2v-bert": W2vBertTeacher, "w2vbert": W2vBertTeacher}
    if kind in hf:
        assert checkpoint, f"{kind} teacher needs a checkpoint path"
        kw.pop("feature_dim", None)  # the model's own width
        return hf[kind](checkpoint, **kw)
    if kind == "precomputed":
        return PrecomputedTeacher(**kw)
    if kind in ("none", "null"):
        return NullTeacher(**kw)
    raise ValueError(f"unknown semantic teacher {kind}")
