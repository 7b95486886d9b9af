"""WhisperVQ semantic tokenizer model of GLM-4-Voice (counterpart of
``rstnet_tpu/models/whisper_vq.py``).

Audio at 16 kHz -> Whisper's log-mel (slaney filterbank, Hann 400 / hop
160) -> two GELU convs (stride 1, then 2) -> learned positions -> pre-LN
layers -> average or max pooling after ``pooling_position`` layers -> the
nearest codeword after ``quantize_position`` layers: 12.5 Hz token ids at
GLM-4-Voice's widths. Only the tokenize direction; detokenization is the
flow + HiFT decoder (``models/glm4v_decoder.py``).

The log-mel runs on the device in float32 (``torch.fft.rfft``); the
filterbank is built in float64 numpy, as in JAX. The encoder is float32; its
attention masks padded keys with an additive -1e9 (block-causal when
``causal_block_size`` is set). The codeword search is one float32 matmul
(||h||^2 - 2 h.c + ||c||^2, the first index on ties): JAX computes it
outside any Pallas kernel, and K3 (``ops/cuda_rvq.py``) takes D <= 512, not
this D of 1280. Parameters are named by the JAX tree's paths; the convs
hold torch's layout (``glm4v_flow.load_jax_tree`` converts a JAX tree).
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from rstnet_tpu_torch.core import default_generator, new_param
from rstnet_tpu_torch.core import normal as _normal
from rstnet_tpu_torch.models.glm4v_flow import (
    Conv,
    Linear,
    Norm,
    conv1d,
    layer_norm,
    load_jax_tree,
)

WHISPER_SR = 16000
N_FFT = 400
HOP = 160


@dataclasses.dataclass(frozen=True)
class WhisperVQConfig:
    n_mels: int = 128               # whisper-large-v3 frontend
    d_model: int = 1280
    num_heads: int = 20
    ffn_dim: int = 5120
    num_layers: int = 16            # layers kept in quantize_encoder_only mode
    pooling_kernel_size: int = 4    # 50 Hz -> 12.5 Hz
    pooling_position: int = 16
    pooling_type: str = "avg"
    quantize_position: int = 16
    quantize_vocab_size: int = 16384
    max_source_positions: int = 1500
    causal_encoder: bool = False    # per-layer causal attention below the VQ
    causal_block_size: Optional[int] = None  # block-causal mask when set


# -- log-mel frontend -------------------------------------------------------------


def _hz_to_mel(f):
    f = np.asarray(f, np.float64)
    logstep = 27.0 / np.log(6.4)
    safe = np.maximum(f, 1e-10)
    return np.where(f >= 1000.0, 15.0 + np.log(safe / 1000.0) * logstep, 3.0 * f / 200.0)


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    logstep = np.log(6.4) / 27.0
    return np.where(m >= 15.0, 1000.0 * np.exp(logstep * (m - 15.0)), 200.0 * m / 3.0)


def mel_filter_bank(n_mels: int, n_fft: int = N_FFT, sr: int = WHISPER_SR) -> np.ndarray:
    """``[n_mels, n_fft//2+1]`` slaney-normalized triangular filterbank."""
    fft_freqs = np.linspace(0, sr / 2, n_fft // 2 + 1)
    hz_pts = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(8000.0), n_mels + 2))
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    fb = np.maximum(0, np.minimum(lower, upper))
    enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])
    return (fb * enorm[:, None]).astype(np.float32)


def log_mel_spectrogram(wav, n_mels: int = 128, device=None) -> torch.Tensor:
    """``[T]`` waveform (numpy or tensor) -> ``[n_mels, frames]`` Whisper
    log-mel on ``device`` (the tensor's own by default): reflect-padded
    centred frames, Hann window, power spectrum, mel, log10 clamped at
    1e-10, a floor of max-8 over the chunk, (x + 4) / 4. The last frame is
    dropped, as Whisper drops it."""
    wav = torch.as_tensor(wav, dtype=torch.float32, device=device).reshape(-1)
    n = torch.arange(N_FFT + 1, device=wav.device, dtype=torch.float64)
    # np.hanning(N + 1)[:-1], in float64 and then float32
    window = (0.5 - 0.5 * torch.cos(2.0 * math.pi * n / N_FFT))[:-1].float()
    xp = F.pad(wav[None, None], (N_FFT // 2, N_FFT // 2), mode="reflect")[0, 0]
    frames = xp.unfold(0, N_FFT, HOP) * window
    power = torch.fft.rfft(frames, dim=-1).abs().square()  # [frames, bins]
    fb = torch.from_numpy(mel_filter_bank(n_mels)).to(wav.device)
    mel = (fb @ power.T)[:, :-1]
    log_spec = torch.log10(torch.clamp(mel, min=1e-10))
    log_spec = torch.maximum(log_spec, log_spec.max() - 8.0)
    return (log_spec + 4.0) / 4.0


# -- encoder ------------------------------------------------------------------------


def vector_quantize(h: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """``[..., D]`` -> the nearest codeword's index ``[...]`` by squared L2,
    the first index on ties."""
    return codeword_distances(h, codebook).argmin(dim=-1)


def codeword_distances(h: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """||h||^2 - 2 h.c + ||c||^2 in float32, ``[..., K]``."""
    return ((h * h).sum(-1, keepdim=True) - (2.0 * h) @ codebook.T
            + (codebook * codebook).sum(-1))


class EncoderLayer(nn.Module):
    def __init__(self, cfg: WhisperVQConfig, *, device=None, generator=None):
        super().__init__()
        d, kw = cfg.d_model, dict(device=device, generator=generator)
        self.attn_ln = Norm(d, device=device)
        self.q = Linear(d, d, **kw)
        self.k = Linear(d, d, bias=False, **kw)
        self.v = Linear(d, d, **kw)
        self.o = Linear(d, d, **kw)
        self.final_ln = Norm(d, device=device)
        self.fc1 = Linear(d, cfg.ffn_dim, **kw)
        self.fc2 = Linear(cfg.ffn_dim, d, **kw)

    def forward(self, x, bias, num_heads: int):
        B, T, D = x.shape
        hd = D // num_heads
        h = layer_norm(self.attn_ln, x)
        q = (self.q(h) * hd ** -0.5).reshape(B, T, num_heads, hd).transpose(1, 2)
        k = self.k(h).reshape(B, T, num_heads, hd).transpose(1, 2)
        v = self.v(h).reshape(B, T, num_heads, hd).transpose(1, 2)
        scores = q @ k.transpose(-1, -2) + bias
        out = (torch.softmax(scores, dim=-1) @ v).transpose(1, 2).reshape(B, T, D)
        h = x + self.o(out)
        return h + self.fc2(F.gelu(self.fc1(layer_norm(self.final_ln, h))))


class WhisperVQEncoder(nn.Module):
    """mel ``[B, n_mels, T_mel]`` + mask ``[B, T_mel]`` -> (token ids, token
    mask), ``[B, T_tok]`` each."""

    def __init__(self, config: WhisperVQConfig = WhisperVQConfig(), *, device=None,
                 generator=None):
        super().__init__()
        cfg = self.config = config
        g = default_generator(generator, device)
        kw = dict(device=device, generator=g)
        self.conv1 = Conv(3, cfg.n_mels, cfg.d_model, std=0.02, **kw)
        self.conv2 = Conv(3, cfg.d_model, cfg.d_model, std=0.02, **kw)
        self.embed_positions = new_param(
            _normal((cfg.max_source_positions, cfg.d_model), g, device) * 0.02)
        self.codebook = new_param(_normal((cfg.quantize_vocab_size, cfg.d_model), g, device)
                                  * 0.02)
        self.layers = nn.ModuleList(EncoderLayer(cfg, **kw) for _ in range(cfg.num_layers))

    def mask_bias(self, mask: torch.Tensor) -> torch.Tensor:
        """mask ``[B, T]`` (1 = valid) -> additive bias ``[B, 1, T, T]``: 0
        where allowed, -1e9 elsewhere."""
        cfg = self.config
        T = mask.shape[1]
        allowed = mask[:, None, :].bool()
        pos = torch.arange(T, device=mask.device)
        if cfg.causal_block_size is not None:
            blk = cfg.causal_block_size
            grid = (pos[:, None] >= pos[None, :]) | ((pos[:, None] // blk) == (pos[None, :] // blk))
            allowed = allowed & grid[None]
        elif cfg.causal_encoder:
            allowed = allowed & (pos[:, None] >= pos[None, :])[None]
        zero = torch.zeros((), device=mask.device)
        return torch.where(allowed[:, None], zero, zero - 1e9)

    @torch.no_grad()
    def hidden(self, mel: torch.Tensor, mask: torch.Tensor):
        """The states the codebook is searched with and their mask: (``[B,
        T_tok, d_model]``, ``[B, T_tok]``)."""
        cfg = self.config
        x = F.gelu(conv1d(self.conv1, mel, padding=(1, 1)))
        x = F.gelu(conv1d(self.conv2, x, stride=2, padding=(1, 1))).transpose(1, 2)
        x = x + self.embed_positions[: x.shape[1]]
        mask = mask[:, ::2]  # conv2's stride
        bias = self.mask_bias(mask)
        pooled = False
        for idx, layer in enumerate(self.layers):
            x = layer(x, bias, cfg.num_heads)
            if idx + 1 == cfg.pooling_position and cfg.pooling_kernel_size > 1 and not pooled:
                k = cfg.pooling_kernel_size
                pad = (-x.shape[1]) % k
                if pad:
                    x = F.pad(x, (0, 0, 0, pad))
                xr = x.reshape(x.shape[0], x.shape[1] // k, k, x.shape[2])
                x = xr.mean(2) if cfg.pooling_type == "avg" else xr.amax(2)
                mask = mask[:, ::k]
                bias = self.mask_bias(mask)
                pooled = True
            if idx + 1 == cfg.quantize_position:
                return x, mask
        # quantize_position beyond the kept layers: the final states
        return x, mask

    @torch.no_grad()
    def encode(self, mel: torch.Tensor, mask: torch.Tensor):
        """mel ``[B, n_mels, T_mel]`` (T_mel a multiple of 2 x pool), mask
        ``[B, T_mel]`` -> (token ids ``[B, T_tok]``, token mask ``[B,
        T_tok]``)."""
        h, mask = self.hidden(mel, mask)
        return vector_quantize(h, self.codebook), mask


# -- GLM-4-Voice checkpoint conversion (HF layout -> the JAX tree) ------------------


def convert_whisper_vq(state, config: WhisperVQConfig) -> dict:
    """A state dict of the HF ``WhisperVQEncoder`` (names plain or under
    ``encoder.`` or ``model.encoder.``) -> the JAX param tree of tensors, in
    JAX layouts (:func:`glm4v_flow.load_jax_tree` loads it)."""

    def t(name):
        for k in (name, "encoder." + name, "model.encoder." + name):
            if k in state:
                return torch.as_tensor(state[k]).float()
        raise KeyError(name)

    def lin(name, bias=True):
        p = {"w": t(name + ".weight").T}
        if bias:
            p["b"] = t(name + ".bias")
        return p

    def ln(name):
        return {"scale": t(name + ".weight"), "bias": t(name + ".bias")}

    params = {
        # torch conv1d weight [out, in, width] -> [width, in, out]
        "conv1": {"w": t("conv1.weight").permute(2, 1, 0), "b": t("conv1.bias")},
        "conv2": {"w": t("conv2.weight").permute(2, 1, 0), "b": t("conv2.bias")},
        "embed_positions": t("embed_positions.weight"),
        "codebook": t("codebook.weight"),
        "layers": [],
    }
    for i in range(config.num_layers):
        pre = f"layers.{i}."
        params["layers"].append({
            "attn_ln": ln(pre + "self_attn_layer_norm"),
            "q": lin(pre + "self_attn.q_proj"),
            "k": lin(pre + "self_attn.k_proj", bias=False),
            "v": lin(pre + "self_attn.v_proj"),
            "o": lin(pre + "self_attn.out_proj"),
            "final_ln": ln(pre + "final_layer_norm"),
            "fc1": lin(pre + "fc1"),
            "fc2": lin(pre + "fc2"),
        })
    return params


def config_from_hf(hf: dict) -> WhisperVQConfig:
    """The fields of a GLM-4-Voice tokenizer's ``config.json``."""
    return WhisperVQConfig(
        n_mels=hf.get("num_mel_bins", 128),
        d_model=hf.get("d_model", 1280),
        num_heads=hf.get("encoder_attention_heads", 20),
        ffn_dim=hf.get("encoder_ffn_dim", 5120),
        num_layers=hf.get("quantize_position", 16),
        pooling_kernel_size=hf.get("pooling_kernel_size") or 1,
        pooling_position=hf.get("pooling_position", 16),
        pooling_type=hf.get("pooling_type", "avg"),
        quantize_position=hf.get("quantize_position", 16),
        quantize_vocab_size=hf.get("quantize_vocab_size", 16384),
        max_source_positions=hf.get("max_source_positions", 1500),
        causal_encoder=hf.get("quantize_causal_encoder", False),
        causal_block_size=hf.get("quantize_causal_block_size"),
    )


def load_glm4v_encoder(path: str, config: Optional[WhisperVQConfig] = None,
                       device="cuda") -> WhisperVQEncoder:
    """The GLM-4-Voice tokenizer checkpoint directory (``*.safetensors`` or
    ``pytorch_model.bin``, and ``config.json`` for the widths when present)
    -> a :class:`WhisperVQEncoder` on ``device``."""
    from rstnet_tpu_torch.models.convert import load_torch_state_dict

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"load_glm4v_encoder(device={str(device)!r}): torch sees no CUDA "
                           "device (pass device='cpu' to run on the CPU)")
    if config is None:
        cfg_file = os.path.join(path, "config.json")
        hf = {}
        if os.path.exists(cfg_file):
            with open(cfg_file) as f:
                hf = json.load(f)
        config = config_from_hf(hf)
    state = {}
    for fname in sorted(os.listdir(path)):
        if fname.endswith(".safetensors") or fname == "pytorch_model.bin":
            state.update(load_torch_state_dict(os.path.join(path, fname)))
    if not state:
        raise FileNotFoundError(f"no checkpoint tensors under {path}")
    model = WhisperVQEncoder(config, device="meta")
    model = model.to_empty(device=device)
    return load_jax_tree(model, convert_whisper_vq(state, config))
