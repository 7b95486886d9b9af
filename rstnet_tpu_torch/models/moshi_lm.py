"""Moshi LMModel: the RQ-Transformer (temporal + depth), inference side
(counterpart of ``rstnet_tpu/models/moshi_lm.py``).

A temporal transformer (dim 4096 x 32 layers for the 7B model) over 1 text +
n_q audio streams with per-codebook embeddings, and a depformer (1024 x 6
layers, weights per step over dep_q codebooks, per-codebook ``depformer_in``
views) with per-codebook output heads. It exposes the step protocol that
``LMGen`` drives: ``initial_frame``, ``step_global``, ``codecformer_inputs``,
``codecformer_step_embedding``, ``step_codecformer``. The training forwards
(``forward_text``, ``forward_local``, ``__call__``) are not ported yet.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from rstnet_tpu_torch.core import container, default_generator, new_param, normal, uniform
from rstnet_tpu_torch.models.lm import ZERO_TOKEN_ID, scaled_embedding
from rstnet_tpu_torch.modules.transformer import StreamingTransformer, resolve_weight
from rstnet_tpu_torch.ops.norms import Norm


class MoshiLMModel(nn.Module):
    def __init__(self, delays: tuple[int, ...] = (0,) * 17, n_q: int = 16, dep_q: int = 8,
                 card: int = 2048, text_card: int = 32000, dim: int = 4096,
                 num_heads: int = 32, num_layers: int = 32, hidden_scale: float = 4.125,
                 norm: str = "rms_norm_f32", gating: str = "silu",
                 positional_embedding: str = "rope", max_period: float = 10000.0,
                 context: int = 3000, causal: bool = True,
                 existing_text_padding_id: int | None = 3, bias_proj: bool = False,
                 depformer_dim: int = 1024, depformer_dim_feedforward: int | None = None,
                 depformer_num_heads: int = 16, depformer_num_layers: int = 6,
                 depformer_multi_linear: bool = True, depformer_weights_per_step: bool = True,
                 depformer_pos_emb: str = "none",
                 *, device=None, dtype=torch.float32, generator=None):
        super().__init__()
        if len(delays) != n_q + 1:
            raise ValueError(f"{len(delays)} delays for {n_q + 1} streams")
        self.delays, self.n_q, self.dep_q, self.card = tuple(delays), n_q, dep_q, card
        self.text_card, self.dim = text_card, dim
        self.existing_text_padding_id = existing_text_padding_id
        self.depformer_dim = depformer_dim
        self.depformer_multi_linear = depformer_multi_linear

        g = default_generator(generator, device)
        kw = dict(device=device, dtype=dtype, generator=g)
        d, dd, card1 = dim, depformer_dim, card + 1
        n_text = text_card + self._extra_text
        self.emb = new_param(normal((n_q, card1, d), g, device, dtype))
        self.text_emb = new_param(normal((text_card + 1, d), g, device, dtype))
        self.text_linear = container(weight=uniform((n_text, d), 1 / math.sqrt(d), g, device, dtype))
        self.transformer = StreamingTransformer(
            d_model=d, num_heads=num_heads, num_layers=num_layers,
            dim_feedforward=int(hidden_scale * d), causal=causal, context=context,
            gating=gating, norm=norm, positional_embedding=positional_embedding,
            max_period=max_period, **kw)
        self.out_norm = Norm(norm, d, device=device, dtype=dtype)
        self.depformer_in = new_param(uniform(
            (dep_q if depformer_multi_linear else 1, dd, d), 1 / math.sqrt(d), g, device, dtype))
        self.depformer_emb = new_param(normal((dep_q - 1, card1, dd), g, device, dtype))
        self.depformer_text_emb = new_param(normal((text_card + 1, dd), g, device, dtype))
        ff = depformer_dim_feedforward or int(hidden_scale * dd)
        self.depformer = StreamingTransformer(
            d_model=dd, num_heads=depformer_num_heads, num_layers=depformer_num_layers,
            dim_feedforward=ff, causal=causal, context=None, gating=gating, norm=norm,
            positional_embedding=depformer_pos_emb, max_period=max_period,
            weights_per_step=dep_q if depformer_weights_per_step else 0, **kw)
        self.linears = container(weight=uniform((dep_q, card, dd), 1 / math.sqrt(dd), g,
                                                device, dtype))
        if bias_proj:
            self.text_linear.bias = new_param(
                torch.zeros(n_text, device=device, dtype=dtype))
            self.linears.bias = new_param(
                torch.zeros((dep_q, card), device=device, dtype=dtype))

    # -- special tokens / protocol shims -------------------------------------

    @property
    def config(self) -> "MoshiLMModel":
        return self  # LMGen reads model.config.dep_q / n_q

    @property
    def num_codebooks(self) -> int:
        return self.n_q + 1

    @property
    def zero_token_id(self) -> int:
        return ZERO_TOKEN_ID

    @property
    def initial_token_id(self) -> int:
        return self.card

    @property
    def text_initial_token_id(self) -> int:
        return self.text_card

    @property
    def _extra_text(self) -> int:
        return 1 if self.existing_text_padding_id is None else 0

    # -- embedding fusion -----------------------------------------------------

    def initial_frame(self, batch_size: int, device=None) -> torch.Tensor:
        text = torch.full((batch_size, 1, 1), self.text_initial_token_id, device=device)
        audio = torch.full((batch_size, self.n_q, 1), self.initial_token_id, device=device)
        return torch.cat([text, audio], dim=1)

    def fuse_embeddings(self, sequence: torch.Tensor) -> torch.Tensor:
        """[B, 1+n_q, T] tokens -> [B, T, dim]: the audio embeddings summed,
        plus the text embedding."""
        card1 = self.card + 1
        audio = sequence[:, 1:, :].long()
        flat = self.emb.reshape(self.n_q * card1, self.dim)
        idx = audio.clamp(0, self.card) + (
            torch.arange(self.n_q, device=audio.device)[None, :, None] * card1)
        emb = flat[idx]  # [B, n_q, T, dim]
        emb = torch.where((audio == self.zero_token_id)[..., None],
                          torch.zeros((), dtype=emb.dtype, device=emb.device), emb)
        return emb.sum(1) + scaled_embedding(self.text_emb, sequence[:, 0, :])

    def _text_logits(self, hidden: torch.Tensor) -> torch.Tensor:
        logits = hidden @ self.text_linear.weight.T.to(hidden.dtype)
        bias = self.text_linear._parameters.get("bias")
        return logits if bias is None else logits + bias.to(logits.dtype)

    # -- streaming protocol -----------------------------------------------------

    def init_state(self, batch_size: int, dtype=torch.bfloat16, device=None) -> dict:
        """Backbone state with one ring buffer per layer: as in the JAX
        server (``kv_unstacked=True``), since a float32 state over bf16
        weights makes the residual float32 after the first layer."""
        return self.transformer.init_state(batch_size, dtype, kv_unstacked=True, device=device)

    def step_global(self, state: dict, frame: torch.Tensor, min_pos=None):
        """One backbone step on a [B, 1+n_q, 1] frame -> (hidden, text
        logits, state)."""
        hidden, state = self.transformer.step(state, self.fuse_embeddings(frame),
                                              min_pos=min_pos)
        hidden = self.out_norm(hidden)
        return hidden, self._text_logits(hidden), state

    def init_codecformer_state(self, batch_size: int, dtype=torch.bfloat16,
                               device=None) -> dict:
        return self.depformer.init_state(batch_size, dtype, device=device)

    def codecformer_inputs(self, hidden: torch.Tensor) -> torch.Tensor:
        """All dep_q per-codebook ``depformer_in`` views of the backbone
        output in one matmul: [B, T, D] -> [B, dep_q, T, C]."""
        w = resolve_weight(self.depformer_in, hidden.dtype)
        if not self.depformer_multi_linear:
            w = w.expand(self.dep_q, -1, -1)
        return torch.einsum("btd,kcd->bktc", hidden, w)

    def codecformer_step_embedding(self, cb_index: int, prev_token: torch.Tensor) -> torch.Tensor:
        """Previous-token embedding for micro-step ``cb_index``."""
        if cb_index == 0:
            return scaled_embedding(self.depformer_text_emb, prev_token)
        return scaled_embedding(self.depformer_emb[cb_index - 1], prev_token)

    def step_codecformer(self, cf_state: dict, cb_index: int, prev_token: torch.Tensor,
                         hidden: torch.Tensor, dep_in: torch.Tensor | None = None):
        """One depformer micro-step -> ([B, 1, card] logits, state).
        ``dep_in``: this step's [B, 1, C] view from ``codecformer_inputs``."""
        if dep_in is None:
            w = resolve_weight(self.depformer_in, hidden.dtype)
            dep_in = hidden @ w[cb_index if self.depformer_multi_linear else 0].T
        x = dep_in + self.codecformer_step_embedding(cb_index, prev_token)
        out, cf_state = self.depformer.step(cf_state, x)
        logits = out @ resolve_weight(self.linears.weight, out.dtype)[cb_index].T
        bias = self.linears._parameters.get("bias")
        if bias is not None:
            logits = logits + bias[cb_index].to(logits.dtype)
        return logits, cf_state


def moshi_7b(delays: tuple[int, ...] | None = None, *, device=None, dtype=torch.float32,
             generator=None) -> MoshiLMModel:
    """Canonical Moshi 7B hyperparameters (``moshi/models/loaders.py``)."""
    return MoshiLMModel(
        delays=tuple(delays or ((0, 0) + (1,) * 7 + (0,) + (1,) * 7)),
        n_q=16, dep_q=8, card=2048, text_card=32000, dim=4096, num_heads=32,
        num_layers=32, hidden_scale=4.125, norm="rms_norm_f32", gating="silu",
        positional_embedding="rope", context=3000, existing_text_padding_id=3,
        depformer_dim=1024, depformer_dim_feedforward=int(4.125 * 1024),
        depformer_num_heads=16, depformer_num_layers=6, depformer_multi_linear=True,
        depformer_weights_per_step=True, depformer_pos_emb="none",
        device=device, dtype=dtype, generator=generator,
    )
