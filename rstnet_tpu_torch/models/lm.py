"""Token conventions, the scaled embedding shared by the LMs, and the
flagship speech-text LM ``SpeechTextLM`` (counterpart of
``rstnet_tpu/models/lm.py``): a pretrained-LLM backbone as the global
transformer and a codecformer (depth transformer with per-step weights) over
the ``dep_q`` audio codebooks.

``SpeechTextLM`` has the training forward (``fuse_embeddings``,
``forward_global``, ``forward_local``) and the streaming step protocol that
``LMGen``, ``OfflineInference`` and ``quant_quality`` drive: ``init_state``,
``step_global`` (the backbone's ring-KV ``step``, its LLaMAMLP through the
fused kernels K4/K5), ``codecformer_inputs``, ``codecformer_step_embedding``,
``init_codecformer_state`` and ``step_codecformer``. The serving
quantizations (``quantize_for_serving``, ``quantize_dep_for_serving``,
``quantize_head_for_serving``) work in place on the model and leave weights
that are already int8 as they are, so they compose in any order; their
``state_dict`` keys are the JAX trees' paths.

On a model placed by ``parallel/sharding.py::shard_params`` over several
ranks, the streaming pieces read the depth side (codecformer, its views,
embeddings and heads) from ``serving_view``'s whole replica
(``depth_side``), and the backbone's step, its text embedding
(vocab-parallel) and its text head (column-parallel, the logits gathered)
run on the local shards of its ``tensor``-sharded weights.
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from rstnet_tpu_torch.core import container, default_generator, new_param, normal, uniform
from rstnet_tpu_torch.models.backbone import Backbone, quantize_backbone_int8, quantize_linear_int8
from rstnet_tpu_torch.models.config import Config
from rstnet_tpu_torch.modules.transformer import (
    StreamingTransformer,
    quantize_param_int8,
    quantize_transformer_int8,
    resolve_weight,
)
from rstnet_tpu_torch.ops.context_parallel import shift
from rstnet_tpu_torch.parallel.comm import table_rows
from rstnet_tpu_torch.parallel.mesh import current_mesh
from rstnet_tpu_torch.parallel.sharding import dense, depth_side

ZERO_TOKEN_ID = -1
UNGENERATED_TOKEN_ID = -2


def _emb_layer_norm(y: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    yf = y.float()
    mu = yf.mean(-1, keepdim=True)
    var = yf.var(-1, keepdim=True, unbiased=False)
    out = (yf - mu) * torch.rsqrt(var + 1e-5) * w.float() + b.float()
    return out.to(y.dtype)


def scaled_embedding(table: torch.Tensor, tokens: torch.Tensor, zero_idx: int = ZERO_TOKEN_ID,
                     norm: dict | None = None) -> torch.Tensor:
    """Embedding where ``zero_idx`` tokens give exactly 0. Indices are
    clipped into the table, as the JAX gather does; ``norm`` ({weight,
    bias}, optional) is a post-embedding layer norm applied before the mask.
    A table split by rows over ``tensor`` (a ``DTensor``) is looked up
    vocab-parallel outside autograd (the serving step), and gathered whole
    in a training forward."""
    is_zero = tokens == zero_idx
    y = table_rows(table, tokens.long().clamp(0, table.shape[0] - 1))
    if norm is not None:
        y = _emb_layer_norm(y, norm["weight"], norm["bias"])
    return torch.where(is_zero[..., None], torch.zeros((), dtype=y.dtype, device=y.device), y)


def _norm_of(src: nn.Module, name: str, index: int | None = None) -> dict | None:
    """The ``{weight, bias}`` of ``src``'s embedding norm ``name`` (row
    ``index`` of a stacked one), or None without it."""
    p = getattr(src, name, None)
    if p is None:
        return None
    if index is None:
        return {"weight": p.weight, "bias": p.bias}
    return {"weight": p.weight[index], "bias": p.bias[index]}


class SpeechTextLM(nn.Module):
    """Backbone + codecformer. Parameter names are the JAX pytree's paths
    (``backbone.blocks.{i}...`` for the JAX package's stacked
    ``backbone.blocks``: see ``STACKED``)."""

    STACKED = ("backbone.blocks",)

    def __init__(self, config: Config, *, device=None, dtype=torch.float32, generator=None):
        super().__init__()
        cfg = self.config = config
        g = default_generator(generator, device)
        self.backbone = Backbone(cfg, device=device, dtype=dtype, generator=g)
        self.codecformer = StreamingTransformer(
            d_model=cfg.codecformer_dim, num_heads=cfg.codecformer_heads,
            num_layers=cfg.codecformer_layers, dim_feedforward=cfg.codecformer_dim_feedforward,
            causal=True, context=None, gating="silu", norm=cfg.codecformer_norm,
            positional_embedding="none", max_period=10000, layer_scale=None,
            weights_per_step=cfg.dep_q if cfg.codecformer_weights_per_step else 0,
            remat=cfg.remat and cfg.codecformer_remat, device=device, dtype=dtype, generator=g)
        card1, D, C = cfg.audio_card + 1, cfg.n_embd, cfg.codecformer_dim
        self.input_emb = new_param(normal((cfg.n_q, card1, D), g, device, dtype))
        self.codecformer_text_emb = new_param(normal((cfg.padded_vocab_size, C), g, device,
                                                     dtype))
        self.codecformer_emb = new_param(normal((cfg.dep_q - 1, card1, C), g, device, dtype))
        # one input view per codebook, or one shared view (multi_linear=False)
        self.codecformer_in = new_param(uniform(
            (cfg.dep_q if cfg.codecformer_multi_linear else 1, C, D), 1.0 / math.sqrt(D), g,
            device, dtype))
        heads = {"weight": uniform((cfg.dep_q, cfg.audio_card, C), 1.0 / math.sqrt(C), g, device,
                                   dtype)}
        if cfg.codecformer_bias_proj:
            heads["bias"] = torch.zeros((cfg.dep_q, cfg.audio_card), device=device, dtype=dtype)
        self.audio_linears = container(**heads)
        if cfg.codecformer_norm_emb:
            def ones_zeros(shape):
                return container(weight=torch.ones(shape, device=device, dtype=dtype),
                                 bias=torch.zeros(shape, device=device, dtype=dtype))

            self.input_emb_norm = ones_zeros((cfg.n_q, 1, D))
            self.codecformer_emb_norm = ones_zeros((cfg.dep_q - 1, C))
            self.codecformer_text_emb_norm = ones_zeros((C,))

    # -- special tokens -------------------------------------------------------

    @property
    def zero_token_id(self) -> int:
        return ZERO_TOKEN_ID

    @property
    def initial_token_id(self) -> int:
        return self.config.audio_card

    @property
    def codec_card(self) -> int:
        # the trainer's audio_card counts the empty (card - 2) and pad
        # (card - 1) specials: the real codec codes are the first card - 2 ids
        return self.config.audio_card - 2

    @property
    def text_initial_token_id(self) -> int:
        # tokenizer-dependent reserved token (llama3: 128002, otherwise 3)
        return 128002 if self.config.padded_vocab_size > 128000 else 3

    @property
    def ungenerated_token_id(self) -> int:
        return UNGENERATED_TOKEN_ID

    @property
    def num_codebooks(self) -> int:
        return self.config.n_q + 1

    # -- input fusion -----------------------------------------------------------

    def initial_frame(self, batch_size: int, device=None) -> torch.Tensor:
        """[B, 1 + n_q, 1] start-of-sequence frame."""
        frame = torch.full((batch_size, self.num_codebooks, 1), self.initial_token_id,
                           dtype=torch.int64, device=device)
        frame[:, 0] = self.text_initial_token_id
        return frame

    def fuse_embeddings(self, sequence: torch.Tensor) -> torch.Tensor:
        """Sum of the text and n_q audio embeddings: [B, 1 + n_q, T] -> [B, T, D],
        one gather over the stacked [n_q, card + 1, D] table."""
        cfg = self.config
        card1 = cfg.audio_card + 1
        audio = sequence[:, 1:, :]
        flat = dense(self.input_emb).reshape(cfg.n_q * card1, cfg.n_embd)
        idx = audio.long().clamp(0, cfg.audio_card) + (
            torch.arange(cfg.n_q, device=audio.device)[None, :, None] * card1)
        emb = flat[idx]  # [B, n_q, T, D]
        if hasattr(self, "input_emb_norm"):
            p = self.input_emb_norm
            emb = _emb_layer_norm(emb, p.weight[None], p.bias[None])
        emb = torch.where((audio == ZERO_TOKEN_ID)[..., None],
                          torch.zeros((), dtype=emb.dtype, device=emb.device), emb)
        x = emb.sum(1) + scaled_embedding(self.backbone.wte, sequence[:, 0, :])
        if cfg.scale_embeddings:
            x = x * torch.tensor(cfg.n_embd**0.5, dtype=x.dtype)
        return x

    # -- training forward ---------------------------------------------------------

    def forward_global(self, sequence: torch.Tensor, dropout_rng: torch.Generator | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
        """[B, 1 + n_q, T] -> (transformer_out [B, T, D], text_logits [B, T, V]).
        ``dropout_rng`` (a CPU generator) turns on LoRA-branch dropout."""
        hidden = self.backbone(self.fuse_embeddings(sequence), dropout_rng)
        return hidden, self.backbone.logits(hidden, dropout_rng)

    def _codecformer_in_weight(self, dtype, src: nn.Module | None = None) -> torch.Tensor:
        w = resolve_weight(dense((src or self).codecformer_in), dtype)
        if w.shape[0] == 1 and self.config.dep_q > 1:
            w = w.expand(self.config.dep_q, *w.shape[1:])
        return w

    def forward_local(self, text_tokens: torch.Tensor, audio_targets: torch.Tensor,
                      transformer_out: torch.Tensor) -> torch.Tensor:
        """Teacher-forced codecformer: text_tokens [B, T] (step-0
        conditioning), audio_targets [B, dep_q, T] (step k > 0 embeds codebook
        k - 1), transformer_out [B, T, D] -> audio logits [B, T, dep_q, card]."""
        cfg = self.config
        B, T, _ = transformer_out.shape
        dep_in = torch.einsum("btd,kcd->btkc", transformer_out,
                              self._codecformer_in_weight(transformer_out.dtype))
        prev = [scaled_embedding(self.codecformer_text_emb, text_tokens,
                                 norm=_norm_of(self, "codecformer_text_emb_norm"))]
        codecformer_emb = dense(self.codecformer_emb)
        for k in range(cfg.dep_q - 1):
            prev.append(scaled_embedding(codecformer_emb[k], audio_targets[:, k, :],
                                         norm=_norm_of(self, "codecformer_emb_norm", k)))
        x = (dep_in + torch.stack(prev, dim=2)).reshape(B * T, cfg.dep_q, cfg.codecformer_dim)
        out = self.codecformer(x)  # [B*T, dep_q, C]
        logits = torch.einsum("nkc,kvc->nkv", out,
                              resolve_weight(dense(self.audio_linears.weight), out.dtype))
        if "bias" in self.audio_linears._parameters:
            logits = logits + self.audio_linears.bias.to(logits.dtype)
        return logits.reshape(B, T, cfg.dep_q, cfg.audio_card)

    def forward(self, sequence: torch.Tensor, dropout_rng: torch.Generator | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """Training forward: sequence [B, 1 + n_q, S] (text row 0, audio rows
        1..n_q) -> (audio_logits [B, S, dep_q, card], text_logits [B, S, V]).
        With ``config.remat`` the codecformer forward is checkpointed whole,
        as in JAX (and each of its layers again, ``codecformer_remat``)."""
        B, K, S = sequence.shape
        if K != self.num_codebooks:
            raise ValueError(f"sequence has {K} rows, expected {self.num_codebooks}")
        start = self.initial_frame(B, sequence.device).to(sequence.dtype)
        mesh = current_mesh()
        if mesh is not None and mesh.size("seq") > 1:
            # this rank's time slice: the frame before it is the last frame
            # of the rank to its left (the start frame on the first rank)
            prev = shift(sequence[:, :, -1:], mesh.group("seq"), 1)
            start = start if mesh.coord("seq") == 0 else prev
        transformer_out, text_logits = self.forward_global(
            torch.cat([start, sequence[:, :, :-1]], dim=2), dropout_rng)
        args = (sequence[:, 0, :], sequence[:, 1:self.config.dep_q + 1, :], transformer_out)
        if self.config.remat and torch.is_grad_enabled():
            audio_logits = checkpoint(self.forward_local, *args, use_reentrant=False)
        else:
            audio_logits = self.forward_local(*args)
        return audio_logits, text_logits

    # -- streaming inference pieces ------------------------------------------------

    def init_state(self, batch_size: int, dtype=torch.bfloat16, kv_int8: bool = False,
                   kv_unstacked: bool = False, device=None) -> dict:
        return self.backbone.init_state(batch_size, dtype, kv_int8=kv_int8,
                                        kv_unstacked=kv_unstacked, device=device)

    def step_global(self, state: dict, frame: torch.Tensor, min_pos=None):
        """One temporal step: frame [B, 1 + n_q, 1] -> (hidden [B, 1, D],
        text_logits [B, 1, V], state). ``min_pos`` [B]: per-slot attention
        lookback floor (multi-session batched decode)."""
        depth_side(self)  # a placed model: FSDP2 unsharded before the backbone reads it
        hidden, state = self.backbone.step(state, self.fuse_embeddings(frame), min_pos=min_pos)
        return hidden, self.backbone.logits(hidden), state

    def codecformer_inputs(self, transformer_out: torch.Tensor) -> torch.Tensor:
        """All dep_q per-codebook views of the backbone output in one matmul:
        [B, T, D] -> [B, dep_q, T, C]."""
        w_in = self._codecformer_in_weight(transformer_out.dtype, depth_side(self))
        return torch.einsum("btd,kcd->bktc", transformer_out, w_in)

    def step_codecformer(self, cf_state: dict, cb_index: int, prev_token: torch.Tensor,
                         transformer_out: torch.Tensor, dep_in: torch.Tensor | None = None):
        """One depth step: prev_token [B, 1], transformer_out [B, 1, D] ->
        (logits [B, 1, card], cf_state). ``dep_in``: this step's [B, 1, C]
        view from ``codecformer_inputs``."""
        depth = depth_side(self)
        if dep_in is None:
            k = cb_index if self.config.codecformer_multi_linear else 0
            dep_in = transformer_out @ resolve_weight(depth.codecformer_in[k],
                                                      transformer_out.dtype).T
        x = dep_in + self.codecformer_step_embedding(cb_index, prev_token)
        out, cf_state = depth.codecformer.step(cf_state, x)
        # the step's head only: the same values as resolving the whole stack
        heads = depth.audio_linears
        logits = out @ resolve_weight(heads.weight[cb_index], out.dtype).T
        if "bias" in heads._parameters:
            logits = logits + heads.bias[cb_index].to(logits.dtype)
        return logits, cf_state

    def codecformer_step_embedding(self, cb_index: int, prev_token: torch.Tensor) -> torch.Tensor:
        """Previous-token embedding for micro-step ``cb_index``: step 0 embeds
        the text token, later steps the previous codebook's token."""
        depth = depth_side(self)
        if cb_index == 0:
            return scaled_embedding(depth.codecformer_text_emb, prev_token,
                                    norm=_norm_of(depth, "codecformer_text_emb_norm"))
        return scaled_embedding(depth.codecformer_emb[cb_index - 1], prev_token,
                                norm=_norm_of(depth, "codecformer_emb_norm", cb_index - 1))

    def init_codecformer_state(self, batch_size: int, dtype=torch.bfloat16, device=None) -> dict:
        return self.codecformer.init_state(batch_size, dtype, device=device)


@torch.no_grad()
def quantize_for_serving(model: SpeechTextLM) -> SpeechTextLM:
    """Weight-only int8 of the decode path, in place: the backbone's linears
    (``quantize_backbone_int8``) and the depformer slice
    (``quantize_dep_for_serving``). Embeddings, norms and biases keep their
    dtype."""
    quantize_dep_for_serving(model)
    quantize_backbone_int8(model.backbone)
    return model


@torch.no_grad()
def quantize_dep_for_serving(model: SpeechTextLM) -> SpeechTextLM:
    """int8 the depformer slice only, in place: the codecformer's projections
    and gating, the per-codebook input views and the audio heads; the
    backbone keeps its dtype."""
    quantize_transformer_int8(model.codecformer)
    quantize_param_int8(model, "codecformer_in")
    quantize_param_int8(model.audio_linears, "weight")
    return model


@torch.no_grad()
def quantize_head_for_serving(model: SpeechTextLM) -> SpeechTextLM:
    """int8 the text head (``backbone.lm_head``, padded vocab x n_embd, the
    largest single weight of a B=1 frame) only, in place."""
    quantize_linear_int8(model.backbone.lm_head)
    return model
