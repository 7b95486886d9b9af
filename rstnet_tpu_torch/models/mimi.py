"""Mimi streaming audio codec: SEANet + transformers + split RVQ (counterpart
of ``rstnet_tpu/models/mimi.py``).

24 kHz mono -> SEANet encoder (hop 960) -> transformer -> learnt conv
downsample x2 -> split RVQ at 12.5 Hz, and the mirror decode path. Offline
and 80 ms streaming execution share weights; the streaming state is a dict
of tensors that ``encode_step``/``decode_step`` return updated.
"""

from __future__ import annotations

import torch
from torch import nn

from rstnet_tpu_torch.core import default_generator
from rstnet_tpu_torch.modules.resample import ConvDownsample1d, ConvTrUpsample1d
from rstnet_tpu_torch.modules.seanet import SEANetDecoder, SEANetEncoder
from rstnet_tpu_torch.modules.transformer import ProjectedTransformer, StreamingTransformer
from rstnet_tpu_torch.quantization.rvq import SplitResidualVectorQuantizer


class MimiModel(nn.Module):
    def __init__(self, encoder: SEANetEncoder, decoder: SEANetDecoder,
                 encoder_transformer: ProjectedTransformer,
                 decoder_transformer: ProjectedTransformer,
                 quantizer: SplitResidualVectorQuantizer, frame_rate: float = 12.5,
                 encoder_frame_rate: float = 25.0, sample_rate: int = 24000,
                 channels: int = 1, causal: bool = True, num_codebooks: int = 8,
                 *, device=None, dtype=torch.float32, generator=None):
        super().__init__()
        self.encoder, self.decoder = encoder, decoder
        self.encoder_transformer = encoder_transformer
        self.decoder_transformer = decoder_transformer
        self.quantizer = quantizer
        self.frame_rate, self.encoder_frame_rate = frame_rate, encoder_frame_rate
        self.sample_rate, self.channels = sample_rate, channels
        self.causal, self.num_codebooks = causal, num_codebooks
        if self.needs_resample:
            g = default_generator(generator, device)
            kw = dict(dimension=encoder.dimension, learnt=True, causal=causal,
                      device=device, dtype=dtype, generator=g)
            self.downsample = ConvDownsample1d(self.resample_stride, **kw)
            # channel_wise=True reproduces upstream's upsample_channel_wise_bug
            self.upsample = ConvTrUpsample1d(self.resample_stride, channel_wise=True, **kw)
        else:
            self.downsample = self.upsample = None

    @property
    def resample_stride(self) -> int:
        stride = self.encoder_frame_rate / self.frame_rate
        if stride != int(stride):
            raise ValueError("encoder frame rate must be a multiple of the frame rate")
        return int(stride)

    @property
    def needs_resample(self) -> bool:
        return self.encoder_frame_rate != self.frame_rate

    @property
    def frame_size(self) -> int:
        """Samples per token frame (1920 = 80 ms at 24 kHz)."""
        return int(self.sample_rate / self.frame_rate)

    # -- offline ------------------------------------------------------------

    def encode_to_latent(self, x: torch.Tensor) -> torch.Tensor:
        """[B, C, T] audio -> [B, D, T'] unquantized latents at frame_rate."""
        (emb,) = self.encoder_transformer(self.encoder(x))
        return emb if self.downsample is None else self.downsample(emb)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """[B, C, T] audio -> [B, K, T'] integer codes."""
        return self.quantizer.encode(self.encode_to_latent(x), self.num_codebooks)

    def decode_latent(self, codes: torch.Tensor) -> torch.Tensor:
        return self.quantizer.decode(codes)

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        """[B, K, T'] codes -> [B, C, T] audio."""
        emb = self.decode_latent(codes)
        if self.upsample is not None:
            emb = self.upsample(emb)
        (emb,) = self.decoder_transformer(emb)
        return self.decoder(emb)

    # -- streaming ----------------------------------------------------------

    @property
    def _transformer_steps_per_frame(self) -> int:
        return self.resample_stride if self.needs_resample else 1

    def init_encode_state(self, batch_size: int, dtype=torch.float32, chunk_frames: int = 1,
                          device=None) -> dict:
        """``chunk_frames``: most whole codec frames fed per ``encode_step``."""
        chunk = self._transformer_steps_per_frame * chunk_frames
        s = {
            "encoder": self.encoder.init_state(batch_size, dtype, device),
            "encoder_transformer": self.encoder_transformer.init_state(
                batch_size, dtype, chunk_size=chunk, device=device),
        }
        if self.downsample is not None:
            s["downsample"] = self.downsample.init_state(batch_size, dtype, device)
        return s

    def init_decode_state(self, batch_size: int, dtype=torch.float32, chunk_frames: int = 1,
                          device=None) -> dict:
        chunk = self._transformer_steps_per_frame * chunk_frames
        s = {
            "decoder": self.decoder.init_state(batch_size, dtype, device),
            "decoder_transformer": self.decoder_transformer.init_state(
                batch_size, dtype, chunk_size=chunk, device=device),
        }
        if self.upsample is not None:
            s["upsample"] = self.upsample.init_state(batch_size, dtype, device)
        return s

    def encode_step(self, state: dict, x: torch.Tensor) -> tuple[torch.Tensor, dict]:
        """One streaming chunk: [B, C, frame_size*n] -> [B, K, n] codes."""
        new_state = dict(state)
        emb, new_state["encoder"] = self.encoder.step(state["encoder"], x)
        (emb,), new_state["encoder_transformer"] = self.encoder_transformer.step(
            state["encoder_transformer"], emb)
        if self.downsample is not None:
            emb, new_state["downsample"] = self.downsample.step(state["downsample"], emb)
        return self.quantizer.encode(emb, self.num_codebooks), new_state

    def decode_step(self, state: dict, codes: torch.Tensor) -> tuple[torch.Tensor, dict]:
        """One streaming chunk: [B, K, n] codes -> [B, C, frame_size*n]."""
        new_state = dict(state)
        emb = self.decode_latent(codes)
        if self.upsample is not None:
            emb, new_state["upsample"] = self.upsample.step(state["upsample"], emb)
        (emb,), new_state["decoder_transformer"] = self.decoder_transformer.step(
            state["decoder_transformer"], emb)
        out, new_state["decoder"] = self.decoder.step(state["decoder"], emb)
        return out, new_state

    @staticmethod
    def _mask_slot_rows(tree, mask: torch.Tensor):
        """Reset the batch rows where ``mask`` [B] is True to a fresh stream:
        carries to zero, ``first`` flags to True."""

        def walk(node, name=""):
            if isinstance(node, dict):
                return {k: walk(v, k) for k, v in node.items()}
            if isinstance(node, list):
                return [walk(v, name) for v in node]
            if name == "first":
                return node | mask
            if isinstance(node, torch.Tensor) and node.dim() >= 1:
                m = mask.reshape((-1,) + (1,) * (node.dim() - 1))
                return torch.where(m, torch.zeros((), dtype=node.dtype, device=node.device), node)
            return node

        return walk(tree)

    def mask_decode_slots(self, state: dict, mask: torch.Tensor) -> dict:
        """Reset the decode slots where ``mask`` [B] is True (no host sync)."""
        new_state = dict(state)
        new_state["decoder"] = self._mask_slot_rows(state["decoder"], mask)
        if "upsample" in state:
            new_state["upsample"] = self._mask_slot_rows(state["upsample"], mask)
        return new_state


def mimi_24k(num_codebooks: int = 8, n_q_total: int = 32, dimension: int = 512,
             n_filters: int = 64, num_layers: int = 8, d_model: int | None = None,
             quantizer_dim: int = 256, bins: int = 2048,
             *, device=None, dtype=torch.float32, generator=None) -> MimiModel:
    """The canonical Mimi configuration: SEANet dim 512 / 64 filters / ratios
    [8,6,5,4] / causal constant-pad, 8-layer rope transformer with
    layer_scale 0.01 and context 250, split RVQ with 32 codebooks (8
    active), 2048 bins each."""
    d_model = d_model or dimension
    g = default_generator(generator, device)
    kw = dict(device=device, dtype=dtype, generator=g)
    seanet = dict(
        channels=1, dimension=dimension, n_filters=n_filters, n_residual_layers=1,
        ratios=(8, 6, 5, 4), activation="ELU", kernel_size=7, residual_kernel_size=3,
        last_kernel_size=3, dilation_base=2, compress=2, causal=True, pad_mode="constant",
        true_skip=True, norm="none", disable_norm_outer_blocks=0,
    )

    def projected():
        transformer = StreamingTransformer(
            d_model=d_model, num_heads=8, num_layers=num_layers,
            dim_feedforward=2048 * d_model // 512, causal=True, context=250, gating="none",
            norm="layer_norm", positional_embedding="rope", layer_scale=0.01,
            max_period=10000, activation="gelu", **kw)
        return ProjectedTransformer(transformer, input_dimension=dimension,
                                    output_dimensions=(dimension,), conv_layout=True, **kw)

    return MimiModel(
        encoder=SEANetEncoder(**seanet, **kw),
        decoder=SEANetDecoder(**seanet, **kw),
        encoder_transformer=projected(),
        decoder_transformer=projected(),
        quantizer=SplitResidualVectorQuantizer(
            dimension=quantizer_dim, input_dimension=dimension, output_dimension=dimension,
            n_q=n_q_total, n_q_semantic=1, bins=bins, **kw),
        frame_rate=12.5, encoder_frame_rate=24000 / 960, sample_rate=24000, channels=1,
        causal=True, num_codebooks=num_codebooks, **kw,
    )
