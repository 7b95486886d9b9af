"""Trainable Mimi codec (counterpart of ``rstnet_tpu/models/mimi_train.py``).

SEANet encoder (24 kHz -> 25 Hz with the rates reversed) -> encoder
transformer -> learnt downsample to 12.5 Hz -> trainable split RVQ with
cosine-similarity semantic distillation -> learnt channel-wise upsample ->
decoder transformer -> SEANet decoder. A training forward decodes the
unquantized latent for 40% of the batch items (quantizer bypass);
``map_semantic`` maps 50 Hz teacher features to the 12.5 Hz latent grid
(linear layer, then an average pool of 8 with stride 4).

The parameters are named as the JAX param tree, and the EMA codebook
statistics are buffers named as the JAX buffer tree (``quantizer.rvq_first.
embed_avg``, ...), so ``core.from_jax_params(params, model, buffers=...)``
loads both. Random draws (the bypass mask, the dead codes) come from a CPU
``torch.Generator`` or are given (``draws``), and are moved to the model's
device: the card and the CPU draw the same from the same seed.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from rstnet_tpu_torch.core import container, default_generator, uniform
from rstnet_tpu_torch.modules.resample import ConvDownsample1d, ConvTrUpsample1d
from rstnet_tpu_torch.modules.seanet import SEANetDecoder, SEANetEncoder
from rstnet_tpu_torch.modules.transformer import ProjectedTransformer, StreamingTransformer
from rstnet_tpu_torch.parallel.comm import batch_rows
from rstnet_tpu_torch.quantization.trainable import TrainableSplitRVQ


class TrainableMimiCodec(nn.Module):
    def __init__(self, sample_rate: int = 24000, n_filters: int = 64,
                 encoder_rates: tuple = (4, 5, 6, 8), compress: int = 2, causal: bool = True,
                 latent_dim: int = 512, codebook_size: int = 2048, codebook_dim: int = 64,
                 rvq_layers: int = 8, num_heads: int = 8, num_layers: int = 8,
                 layer_scale: float = 0.01, context: int = 250, dim_feedforward: int = 2048,
                 semantic_feature_dim: int = 1024, target_frame_rate: float = 12.5,
                 bypass_rate: float = 0.4,
                 *, device=None, dtype=torch.float32, generator=None):
        super().__init__()
        self.sample_rate, self.encoder_rates = sample_rate, tuple(encoder_rates)
        self.latent_dim, self.rvq_layers = latent_dim, rvq_layers
        self.semantic_feature_dim, self.target_frame_rate = semantic_feature_dim, target_frame_rate
        self.bypass_rate = bypass_rate
        g = default_generator(generator, device)
        kw = dict(device=device, dtype=dtype, generator=g)
        seanet = dict(
            channels=1, dimension=latent_dim, n_filters=n_filters, n_residual_layers=1,
            ratios=self.encoder_rates, activation="ELU", compress=compress, dilation_base=2,
            disable_norm_outer_blocks=0, kernel_size=7, residual_kernel_size=3,
            last_kernel_size=3, norm="none", pad_mode="constant", causal=causal, true_skip=True)
        self.encoder = SEANetEncoder(**seanet, **kw)
        self.decoder = SEANetDecoder(**seanet, **kw)

        def projected():
            inner = StreamingTransformer(
                d_model=latent_dim, num_heads=num_heads, num_layers=num_layers,
                dim_feedforward=dim_feedforward, causal=causal, context=context, gating="none",
                norm="layer_norm", positional_embedding="rope", layer_scale=layer_scale,
                max_period=10000, **kw)
            return ProjectedTransformer(inner, input_dimension=latent_dim,
                                        output_dimensions=(latent_dim,), conv_layout=True, **kw)

        self.encoder_transformer = projected()
        self.decoder_transformer = projected()
        stride = self.resample_stride
        self.downsample = ConvDownsample1d(stride, dimension=latent_dim, learnt=True,
                                           causal=causal, **kw)
        self.upsample = ConvTrUpsample1d(stride, dimension=latent_dim, learnt=True, causal=causal,
                                         channel_wise=True, **kw)
        self.quantizer = TrainableSplitRVQ(input_dimension=latent_dim, dimension=codebook_dim,
                                           bins=codebook_size, n_q=rvq_layers, n_q_semantic=1,
                                           **kw)
        bound = 1.0 / math.sqrt(semantic_feature_dim)
        self.semantic_mapping = container(
            weight=uniform((latent_dim, semantic_feature_dim), bound, g, device, dtype),
            bias=torch.zeros((latent_dim,), dtype=dtype, device=device))

    @property
    def hop_length(self) -> int:
        return math.prod(self.encoder_rates)

    @property
    def encoder_frame_rate(self) -> float:
        return self.sample_rate / self.hop_length

    @property
    def resample_stride(self) -> int:
        return int(self.encoder_frame_rate / self.target_frame_rate)

    # -- semantic feature mapping ---------------------------------------------

    def map_semantic(self, features: torch.Tensor) -> torch.Tensor:
        """[B, T50, feat_dim] teacher features -> [B, T12.5, latent]."""
        sm = self.semantic_mapping
        h = features @ sm.weight.T.to(features.dtype) + sm.bias.to(features.dtype)
        pooled = h.transpose(1, 2).unfold(-1, 8, 4).mean(-1)  # AvgPool1d(8, 4)
        return pooled.transpose(1, 2)

    # -- encode/decode ----------------------------------------------------------

    def encode_to_latent(self, audio: torch.Tensor) -> torch.Tensor:
        """[B, 1, T] -> [B, T', C] latents at ``target_frame_rate``."""
        z = self.encoder(audio)
        (z,) = self.encoder_transformer(z)
        return self.downsample(z).transpose(1, 2)

    def decode_from_latent(self, z: torch.Tensor) -> torch.Tensor:
        """[B, T', C] -> [B, 1, T] audio."""
        z = self.upsample(z.transpose(1, 2))
        (z,) = self.decoder_transformer(z)
        return self.decoder(z)

    @torch.no_grad()
    def encode(self, audio: torch.Tensor) -> torch.Tensor:
        """[B, 1, T] -> codes [B, K, T'] (int32)."""
        return self.quantizer.encode(self.encode_to_latent(audio)).transpose(1, 2)

    @torch.no_grad()
    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        return self.decode_from_latent(self.quantizer.decode(codes.transpose(1, 2)))

    # -- training forward ---------------------------------------------------------

    def forward(self, audio: torch.Tensor, semantic_features: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None, update_codebooks: bool = True,
                draws: Optional[dict] = None):
        """-> (reconstruction [B, 1, T], codes [B, K, T'], commitment loss,
        distillation loss); the EMA buffers are updated in place when
        ``update_codebooks``. With a ``generator`` (a CPU generator), dead
        codes are replaced and a ``bypass_rate`` share of the items decode
        the unquantized latent. ``draws`` gives those draws instead:
        ``{"keep": [B] bool, "dead": {"rvq_first": [Q, K], "rvq_rest": [Q, K]}}``."""
        length = audio.shape[-1]
        z = self.encode_to_latent(audio)
        sem = self.map_semantic(semantic_features) if semantic_features is not None else None
        draws = draws or {}
        zq, codes, commit, sim_loss = self.quantizer(
            z, sem, generator, update=update_codebooks, dead_indices=draws.get("dead"))
        keep = draws.get("keep")
        if keep is None and generator is not None and self.bypass_rate > 0:
            # drawn over the whole batch (data parallel: every rank alike)
            n, first = batch_rows(audio.shape[0])
            keep = (torch.rand((n,), generator=generator) >= self.bypass_rate)[
                first:first + audio.shape[0]]
        if keep is not None:
            keep = torch.as_tensor(keep, dtype=torch.bool).to(z.device)
            zq = torch.where(keep[:, None, None], zq, z)
        rec = self.decode_from_latent(zq)
        return rec[..., :length], codes.transpose(1, 2), commit, sim_loss
