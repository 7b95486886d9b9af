"""Streaming frame-step generation engine (counterpart of
``rstnet_tpu/inference/generate.py::LMGen``).

A delay-pattern ring cache ``[B, K, max_delay+2]`` holds recent tokens per
stream; user streams are written at delayed positions; each 80 ms frame runs
one backbone step plus ``dep_q`` sequential depformer micro-steps, and a
complete token frame is emitted once a slot's age exceeds ``max_delay``.

It drives any model with the step protocol: ``MoshiLMModel`` or
``SpeechTextLM`` (whose backbone step runs its MLP through K4/K5). At batch 1
the micro-steps go through :func:`depformer_step` (the CUDA kernel K1 on the
card, its int8 variant over int8 depformer weights, its plain version on CPU
tensors) when the depth transformer is inside K1's envelope; otherwise, and
at batch > 1, they run the model's ``step_codecformer``. Unlike the JAX
``LMGen``, which takes K1 only under ``RSTNET_PALLAS_DEP``, the port takes it
wherever the shapes allow.
K1's operands are taken from the weights at every frame, as JAX does, so an
in-place change of the weights (padding, int8 quantization) reaches the
kernel. ``step_scan`` runs N frames per call, as N ``step`` calls.

Under ``parallel/mesh.py::set_mesh``, over a ``SpeechTextLM`` placed by
``parallel/sharding.py::shard_params`` (``tensor`` > 1, with or without
``fsdp``; ``data`` ranks serve alike), every rank runs the same frame: the
backbone Megatron-style on its shards (``init_state``'s ring holds this
rank's KV groups), the depth side and K1's operands over
``serving_view``'s whole replica, and every rank samples the same tokens
from the same gathered logits when the ranks pass generators of one seed.

The frame reads nothing back to the host: the state's ``offset`` is a 0-dim
device tensor, and the delays, the user-stream rows and the initial frame
are device tensors built once per device and batch size. So a frame, or N
of them, can be captured as one CUDA graph and replayed
(``serving/graphs.py``), the counterpart of the JAX package's one jitted
dispatch per frame.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from rstnet_tpu_torch.models.lm import UNGENERATED_TOKEN_ID
from rstnet_tpu_torch.ops.cuda_depformer import depformer_kernel_operands, depformer_step
from rstnet_tpu_torch.ops.sampling import sample_token
from rstnet_tpu_torch.parallel.sharding import depth_side


@dataclasses.dataclass(frozen=True)
class LMGen:
    model: torch.nn.Module  # MoshiLMModel or SpeechTextLM
    delays: tuple[int, ...] = ()  # len 1+n_q; default all-zero
    use_sampling: bool = True
    temp: float = 0.8
    temp_text: float = 0.7
    top_k: int = 250
    top_k_text: int = 25
    # ban special ids >= audio_max_card when sampling audio; None: no clamp
    audio_max_card: Optional[int] = None
    # the backbone ring K/V as int8 with per-step scales (serving option)
    kv_int8: bool = False
    # one ring per layer instead of stacked [L, ...] buffers (the model's
    # init_state; the same values either way)
    kv_unstacked: bool = False
    # device constants by (device, batch): built outside any graph capture
    _consts: dict = dataclasses.field(default_factory=dict, init=False, repr=False,
                                      compare=False)

    def __post_init__(self):
        if not self.delays:
            object.__setattr__(self, "delays", (0,) * self.model.num_codebooks)
        if len(self.delays) != self.model.num_codebooks:
            raise ValueError(f"{len(self.delays)} delays for {self.model.num_codebooks} streams")

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

    def _constants(self, device, batch_size: int) -> dict:
        """The frame's constant tensors on ``device``: the delays, the rows of
        the user streams and the initial frame ``[B, K]``. Built at the first
        call for a device and batch size (``init_state`` makes it), so a frame
        copies nothing from the host."""
        key = (device, batch_size)
        if key not in self._consts:
            dep_q = self.model.config.dep_q
            self._consts[key] = {
                "delays": torch.tensor(self.delays, dtype=torch.long, device=device),
                "user_rows": torch.arange(self.num_user_streams, device=device) + dep_q + 1,
                "initial": self.model.initial_frame(batch_size, device)[:, :, 0].long(),
            }
        return self._consts[key]

    def init_state(self, batch_size: int, dtype=torch.bfloat16, device=None) -> dict:
        K = self.model.num_codebooks
        cache = torch.full((batch_size, K, self.cache_len), UNGENERATED_TOKEN_ID,
                           dtype=torch.long, device=device)
        self._constants(cache.device, batch_size)
        return {
            "cache": cache,
            # a device scalar, so the frame never reads it back
            "offset": torch.zeros((), dtype=torch.long, device=device),
            # per-slot frame count: bounds the slot's attention lookback
            # (min_pos) and drives its own delay warmup
            "age": torch.zeros((batch_size,), dtype=torch.long, device=device),
            "lm": self.model.init_state(batch_size, dtype, device=device, kv_int8=self.kv_int8,
                                        kv_unstacked=self.kv_unstacked),
        }

    def reset_slots(self, state: dict, slots) -> dict:
        """Reset batch slots for new sessions: clear their delay-cache rows
        and zero their age (the per-slot ``min_pos`` hides older ring keys)."""
        slots = torch.as_tensor(slots, dtype=torch.long, device=state["age"].device)
        state["cache"][slots] = UNGENERATED_TOKEN_ID
        state["age"][slots] = 0
        return state

    @torch.no_grad()
    def step(self, state: dict, generator: torch.Generator | None,
             input_tokens: torch.Tensor | None = None
             ) -> tuple[torch.Tensor, torch.Tensor, dict]:
        """One frame step, updating ``state`` in place, outside autograd (a
        placed model's text embedding and head then run on their shards).

        input_tokens: [B, num_user_streams, 1] (omit when no user streams).
        Returns (frame [B, dep_q+1, 1], valid [B] bool, state). A slot's frame
        holds UNGENERATED during its max_delay warmup (valid False)."""
        model = self.model
        cfg = model.config
        cache, offset, age = state["cache"], state["offset"], state["age"]
        B, K, CT = cache.shape
        device = cache.device
        consts = self._constants(device, B)
        delays = consts["delays"]

        # 1. write user streams at their delayed positions
        if self.num_user_streams:
            if input_tokens is None or input_tokens.shape[1] != self.num_user_streams:
                raise ValueError(f"expected [B, {self.num_user_streams}, 1] user tokens")
            ks = consts["user_rows"]
            cache[:, ks, (offset + delays[ks]) % CT] = input_tokens[:, :, 0].long()

        # 2. at the start of a slot's session, delayed streams read the initial token
        position = (offset % CT).reshape(1)
        use_initial = age[:, None] <= delays[None, :]
        current = torch.where(use_initial, consts["initial"],
                              cache.index_select(2, position)[:, :, 0])
        cache.index_copy_(2, position, current[:, :, None])

        # 3. backbone step; min_pos hides ring keys from before each slot's session
        hidden, text_logits, state["lm"] = model.step_global(
            state["lm"], current[:, :, None], min_pos=offset - age)
        text_token = sample_token(text_logits[:, 0], generator, self.use_sampling,
                                  self.temp_text, self.top_k_text)

        # 4. depformer micro-steps; the per-codebook input views are one matmul
        dep_ins = model.codecformer_inputs(hidden)  # [B, dep_q, 1, C]
        ops = depformer_kernel_operands(depth_side(model)) if B == 1 else None
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
                    heads=ops["heads"], eps=ops["eps"], scales=ops["scales"])
                tok = sample_token(logits, generator, self.use_sampling, self.temp, self.top_k,
                                   max_card=self.audio_max_card)
                prev = tok[:, None]
                audio_tokens.append(tok)
        else:
            cf_state = model.init_codecformer_state(B, dtype=hidden.dtype, device=device)
            for cb in range(cfg.dep_q):
                logits, cf_state = model.step_codecformer(cf_state, cb, prev, hidden,
                                                          dep_in=dep_ins[:, cb])
                tok = sample_token(logits[:, 0], generator, self.use_sampling, self.temp,
                                   self.top_k, max_card=self.audio_max_card)
                prev = tok[:, None]
                audio_tokens.append(tok)
        audio = torch.stack(audio_tokens, dim=1)  # [B, dep_q]

        # 5. write the generated tokens at the next position
        offset = offset + 1
        age += 1
        position = (offset % CT).reshape(1)
        generated = torch.cat([text_token[:, None], audio], dim=1)  # [B, dep_q + 1]
        cache[:, : cfg.dep_q + 1].index_copy_(2, position, generated[:, :, None])

        # 6. gather the delayed output frame
        index = (offset - self.max_delay + delays[: cfg.dep_q + 1]) % CT
        out = cache[:, : cfg.dep_q + 1, :].gather(
            2, index[None, :, None].expand(B, cfg.dep_q + 1, 1))
        state["offset"] = offset
        return out, age > self.max_delay, state

    def step_scan(self, state: dict, generator: torch.Generator | None,
                  input_tokens: torch.Tensor | None = None, n_frames: int | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor, dict]:
        """N frame steps in one call (the JAX ``lax.scan`` over :meth:`step`).

        input_tokens: [B, num_user_streams, N] (or None when there are no user
        streams, with ``n_frames`` giving N). Returns (frames [B, dep_q+1, N],
        valid [B, N], state), token-identical to N :meth:`step` calls drawing
        from the same generator. The frames are unrolled, so a CUDA graph of
        the call replays all N with one launch."""
        if input_tokens is not None:
            n = input_tokens.shape[-1]
        elif n_frames is None:
            raise ValueError("n_frames is required without user streams")
        else:
            n = n_frames
        outs, valids = [], []
        for t in range(n):
            tokens = None if input_tokens is None else input_tokens[:, :, t : t + 1]
            out, valid, state = self.step(state, generator, tokens)
            outs.append(out[:, :, 0])
            valids.append(valid)
        return torch.stack(outs, dim=2), torch.stack(valids, dim=1), state
