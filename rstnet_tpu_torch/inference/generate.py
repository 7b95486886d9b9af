"""Streaming frame-step generation engine (counterpart of
``rstnet_tpu/inference/generate.py::LMGen``).

A delay-pattern ring cache ``[B, K, max_delay+2]`` holds recent tokens per
stream; user streams are written at delayed positions; each 80 ms frame runs
one backbone step plus ``dep_q`` sequential depformer micro-steps, and a
complete token frame is emitted once a slot's age exceeds ``max_delay``.

At batch 1 the micro-steps go through :func:`depformer_step` (the CUDA kernel
K1 on the card, its plain version on CPU tensors); batch > 1 runs the model's
``step_codecformer``. ``step_scan`` (several frames per call) is not ported
yet.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from rstnet_tpu_torch.models.lm import UNGENERATED_TOKEN_ID
from rstnet_tpu_torch.ops.cuda_depformer import depformer_kernel_operands, depformer_step
from rstnet_tpu_torch.ops.sampling import sample_token


@dataclasses.dataclass(frozen=True)
class LMGen:
    model: torch.nn.Module  # MoshiLMModel
    delays: tuple[int, ...] = ()  # len 1+n_q; default all-zero
    use_sampling: bool = True
    temp: float = 0.8
    temp_text: float = 0.7
    top_k: int = 250
    top_k_text: int = 25

    def __post_init__(self):
        if not self.delays:
            object.__setattr__(self, "delays", (0,) * self.model.num_codebooks)
        if len(self.delays) != self.model.num_codebooks:
            raise ValueError(f"{len(self.delays)} delays for {self.model.num_codebooks} streams")

    @functools.cached_property
    def _dep_ops(self) -> dict | None:
        """K1's operands, taken from the model's weights at the first step."""
        return depformer_kernel_operands(self.model)

    @property
    def max_delay(self) -> int:
        return max(self.delays)

    @property
    def cache_len(self) -> int:
        return self.max_delay + 2

    @property
    def num_user_streams(self) -> int:
        """Streams supplied by the caller (8 for duplex Moshi configs)."""
        return self.model.num_codebooks - self.model.config.dep_q - 1

    def init_state(self, batch_size: int, dtype=torch.bfloat16, device=None) -> dict:
        K = self.model.num_codebooks
        return {
            "cache": torch.full((batch_size, K, self.cache_len), UNGENERATED_TOKEN_ID,
                                dtype=torch.long, device=device),
            "offset": 0,
            # per-slot frame count: bounds the slot's attention lookback
            # (min_pos) and drives its own delay warmup
            "age": torch.zeros((batch_size,), dtype=torch.long, device=device),
            "lm": self.model.init_state(batch_size, dtype, device=device),
        }

    def reset_slots(self, state: dict, slots) -> dict:
        """Reset batch slots for new sessions: clear their delay-cache rows
        and zero their age (the per-slot ``min_pos`` hides older ring keys)."""
        slots = torch.as_tensor(slots, dtype=torch.long, device=state["age"].device)
        state["cache"][slots] = UNGENERATED_TOKEN_ID
        state["age"][slots] = 0
        return state

    def step(self, state: dict, generator: torch.Generator | None,
             input_tokens: torch.Tensor | None = None
             ) -> tuple[torch.Tensor, torch.Tensor, dict]:
        """One frame step, updating ``state`` in place.

        input_tokens: [B, num_user_streams, 1] (omit when no user streams).
        Returns (frame [B, dep_q+1, 1], valid [B] bool, state). A slot's frame
        holds UNGENERATED during its max_delay warmup (valid False)."""
        model = self.model
        cfg = model.config
        cache, offset, age = state["cache"], state["offset"], state["age"]
        B, K, CT = cache.shape
        device = cache.device
        delays = torch.tensor(self.delays, dtype=torch.long, device=device)

        # 1. write user streams at their delayed positions
        if self.num_user_streams:
            if input_tokens is None or input_tokens.shape[1] != self.num_user_streams:
                raise ValueError(f"expected [B, {self.num_user_streams}, 1] user tokens")
            ks = torch.arange(self.num_user_streams, device=device) + cfg.dep_q + 1
            cache[:, ks, (offset + delays[ks]) % CT] = input_tokens[:, :, 0].long()

        # 2. at the start of a slot's session, delayed streams read the initial token
        position = offset % CT
        initial = model.initial_frame(B, device)[:, :, 0]
        use_initial = age[:, None] <= delays[None, :]
        current = torch.where(use_initial, initial, cache[:, :, position])
        cache[:, :, position] = current

        # 3. backbone step; min_pos hides ring keys from before each slot's session
        hidden, text_logits, state["lm"] = model.step_global(
            state["lm"], current[:, :, None], min_pos=offset - age)
        text_token = sample_token(text_logits[:, 0], generator, self.use_sampling,
                                  self.temp_text, self.top_k_text)

        # 4. depformer micro-steps; the per-codebook input views are one matmul
        dep_ins = model.codecformer_inputs(hidden)  # [B, dep_q, 1, C]
        ops = self._dep_ops if B == 1 else None
        prev = text_token[:, None]
        audio_tokens = []
        if ops is not None:
            kc = torch.zeros((ops["L"], ops["S"], ops["C"]), dtype=hidden.dtype, device=device)
            vc = torch.zeros_like(kc)
            for cb in range(cfg.dep_q):
                emb = model.codecformer_step_embedding(cb, prev)
                x = (dep_ins[:, cb, 0] + emb[:, 0]).to(torch.bfloat16)
                logits, kc, vc = depformer_step(
                    x, cb, ops["norm1"], ops["in_proj"], ops["out_proj"], ops["norm2"],
                    ops["gin"], ops["gout"], ops["head_w"], ops["head_b"], kc, vc,
                    heads=ops["heads"], eps=ops["eps"])
                tok = sample_token(logits, generator, self.use_sampling, self.temp, self.top_k)
                prev = tok[:, None]
                audio_tokens.append(tok)
        else:
            cf_state = model.init_codecformer_state(B, dtype=hidden.dtype, device=device)
            for cb in range(cfg.dep_q):
                logits, cf_state = model.step_codecformer(cf_state, cb, prev, hidden,
                                                          dep_in=dep_ins[:, cb])
                tok = sample_token(logits[:, 0], generator, self.use_sampling, self.temp,
                                   self.top_k)
                prev = tok[:, None]
                audio_tokens.append(tok)
        audio = torch.stack(audio_tokens, dim=1)  # [B, dep_q]

        # 5. write the generated tokens at the next position
        offset += 1
        age += 1
        position = offset % CT
        cache[:, 0, position] = text_token
        cache[:, 1 : cfg.dep_q + 1, position] = audio

        # 6. gather the delayed output frame
        index = (offset - self.max_delay + delays[: cfg.dep_q + 1]) % CT
        out = cache[:, : cfg.dep_q + 1, :].gather(
            2, index[None, :, None].expand(B, cfg.dep_q + 1, 1))
        state["offset"] = offset
        return out, age > self.max_delay, state
