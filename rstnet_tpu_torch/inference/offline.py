"""Offline inference: teacher-forced perplexity and prefix generation
(counterpart of ``rstnet_tpu/inference/offline.py``).

Teacher-forced metrics run the training forward without autograd and report
per-stream CE, perplexity and accuracy. Generation runs the ring-KV
streaming step, O(T) per frame: one ``step_global`` and ``dep_q``
``step_codecformer`` micro-steps a frame, with partial teacher forcing
(``forced``, -1 where free) and, for duplex configs (n_q > dep_q), the user
rows re-fed from the prefix while it lasts and the initial token after. The
ring is float32, as in JAX, so a bf16 model's residual turns float32 after
the first layer; the backbone's MLP takes K4/K5 (``Backbone.step``). Sampling
draws from the caller's ``torch.Generator`` (on the model's device); greedy
(``use_sampling=False``) needs none.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from rstnet_tpu_torch.losses.ce import cross_entropy_and_accuracy
from rstnet_tpu_torch.ops.sampling import sample_token


@dataclasses.dataclass
class OfflineInference:
    model: torch.nn.Module  # SpeechTextLM or MoshiLMModel
    temp: float = 0.8
    temp_text: float = 0.7
    top_k: int = 250
    top_k_text: int = 25
    use_sampling: bool = True
    audio_ignore_id: int = 2049
    text_ignore_id: int = 128003
    # number of real codec codes: sampled audio ids are clamped below it;
    # None -> the model family's own ``codec_card``
    codec_card: Optional[int] = None

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    # -- teacher-forced evaluation --------------------------------------------

    @torch.no_grad()
    def teacher_forced_metrics(self, tokens, masks) -> dict:
        """CE / accuracy / perplexity over a [B, 1 + n_q, S] grid."""
        dep_q = self.model.config.dep_q
        tokens = torch.as_tensor(np.asarray(tokens), device=self.device).long()
        masks = torch.as_tensor(np.asarray(masks), device=self.device).float()
        audio_logits, text_logits = self.model(tokens)
        loss_audio, m_audio = cross_entropy_and_accuracy(
            audio_logits, tokens[:, 1:dep_q + 1], masks[:, 1:dep_q + 1], (1.0,) * dep_q,
            (self.audio_ignore_id,) * dep_q)
        loss_text, m_text = cross_entropy_and_accuracy(
            text_logits[:, :, None, :], tokens[:, 0:1], masks[:, 0:1], (1.0,),
            (self.text_ignore_id,))
        loss_audio, loss_text = float(loss_audio), float(loss_text)
        return {
            "loss_audio": loss_audio,
            "loss_text": loss_text,
            "ppl_audio": math.exp(loss_audio / dep_q),
            "ppl_text": math.exp(loss_text),
            "acc_audio": float(m_audio["acc_all"]),
            "acc_text": float(m_text["acc_all"]),
            # valid-token counts: corpus-level aggregation weights batches by them
            "n_audio_tokens": float(masks[:, 1:dep_q + 1].sum()),
            "n_text_tokens": float(masks[:, 0:1].sum()),
        }

    # -- prefix-conditioned generation ------------------------------------------

    def _one_step(self, lm_state, frame, generator, forced_text, forced_audio):
        """One temporal step: feed ``frame``, sample (or force) the next one."""
        model = self.model
        hidden, text_logits, lm_state = model.step_global(lm_state, frame)
        text_tok = sample_token(text_logits[:, -1], generator, self.use_sampling,
                                self.temp_text, self.top_k_text)
        text_tok = torch.where(forced_text >= 0, forced_text, text_tok)
        cf_state = model.init_codecformer_state(frame.shape[0], dtype=hidden.dtype,
                                                device=hidden.device)
        # ban the empty/pad specials the audio logits may cover
        max_card = self.codec_card if self.codec_card is not None else model.codec_card
        prev, tokens = text_tok[:, None], [text_tok]
        for cb in range(model.config.dep_q):
            logits, cf_state = model.step_codecformer(cf_state, cb, prev, hidden)
            tok = sample_token(logits[:, -1], generator, self.use_sampling, self.temp,
                               self.top_k, max_card=max_card)
            tok = torch.where(forced_audio[:, cb] >= 0, forced_audio[:, cb], tok)
            prev = tok[:, None]
            tokens.append(tok)
        return torch.stack(tokens, dim=1)[:, :, None], lm_state

    @torch.no_grad()
    def generate(self, prefix: np.ndarray, max_new: int,
                 generator: torch.Generator | None = None, prefix_len: Optional[int] = None,
                 forced: Optional[np.ndarray] = None) -> np.ndarray:
        """Continue a [B, 1 + n_q, T0] prefix grid by ``max_new`` frames.

        ``forced`` (-1 where free) forces tokens past the prefix (e.g. TTS:
        text forced, audio generated). Returns [B, 1 + n_q, T0 + max_new];
        for duplex configs (n_q > dep_q) the user rows are teacher-forced
        from the prefix while it lasts and hold the initial token after."""
        model, dev = self.model, self.device
        B, K, T0 = prefix.shape
        n_gen = model.config.dep_q + 1  # rows the model generates (text + dep_q audio)
        prefix_len = prefix_len if prefix_len is not None else T0
        prefix = torch.as_tensor(np.asarray(prefix), device=dev).long()
        if forced is not None:
            forced = torch.as_tensor(np.asarray(forced), device=dev).long()
        lm_state = model.init_state(B, dtype=torch.float32, device=dev)
        initial = model.initial_frame(B, dev).long()
        frame = initial
        free_t = torch.full((B,), -1, dtype=torch.long, device=dev)
        free_a = torch.full((B, n_gen - 1), -1, dtype=torch.long, device=dev)
        frames = []
        for t in range(prefix_len + max_new):
            if t < prefix_len:  # the whole frame is forced from the prefix
                f_text, f_audio = prefix[:, 0, t], prefix[:, 1:n_gen, t]
            elif forced is not None and t < forced.shape[-1]:
                f_text, f_audio = forced[:, 0, t], forced[:, 1:n_gen, t]
            else:
                f_text, f_audio = free_t, free_a
            gen_frame, lm_state = self._one_step(lm_state, frame, generator, f_text, f_audio)
            if K > n_gen:  # duplex: the extra rows are user streams
                user = prefix[:, n_gen:, t:t + 1] if t < prefix_len else initial[:, n_gen:]
                frame = torch.cat([gen_frame, user], dim=1)
            else:
                frame = gen_frame
            frames.append(frame)
        return torch.cat(frames, dim=2).cpu().numpy()
