"""GLM-4-Voice audio decoder: semantic tokens -> 22.05 kHz waveform, and its
checkpoint converters (counterpart of ``rstnet_tpu/models/glm4v_decoder.py``).

Ties the flow (``models/glm4v_flow.py``) and HiFT (``models/hift.py``) into
the reference's ``AudioDecoder``: offline synthesis, and block streaming in
which every block takes the whole token and mel history as its flow prompt,
mel blocks are cross-faded with a Hamming window over the carried overlap's
own length, and HiFT carries a 1-frame mel cache and its source's tail
across the seams. The random draws (the flow's z, the source's phases and
noise) come from one ``draw`` function threaded through the blocks
(``hift.generator_draws`` over a CPU generator seeded 42 by default).

The converters read the ``glm-4-voice-decoder`` directory: ``config.yaml``
(hyperpyyaml, read by ``utils/yaml_subset.py`` without running it),
``flow.pt`` and ``hift.pt`` (CosyVoice ``MaskedDiffWithXvec`` and
``HiFTGenerator`` state dicts). Each ``convert_*`` builds the JAX param
tree (JAX layouts, torch tensors): weight norm folded in float64,
``ConvTranspose1d`` kernels ``[in, out, k]`` stored flipped as ``[k, in,
out]``; ``glm4v_flow.load_jax_tree`` loads it.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Mapping, Optional

import numpy as np
import torch

from rstnet_tpu_torch.models.glm4v_flow import (
    ConformerConfig,
    GLM4VFlow,
    GLM4VFlowConfig,
    UNetConfig,
    load_jax_tree,
)
from rstnet_tpu_torch.models.hift import Draw, HiFTConfig, HiFTGenerator, generator_draws

SD = Mapping[str, torch.Tensor]


# -- torch layout helpers -----------------------------------------------------------


def _g(sd: SD, name: str) -> torch.Tensor:
    return torch.as_tensor(sd[name]).float()


def _lin(sd: SD, prefix: str) -> dict:
    p = {"w": _g(sd, f"{prefix}.weight").T}
    if f"{prefix}.bias" in sd:
        p["b"] = _g(sd, f"{prefix}.bias")
    return p


def _ln(sd: SD, prefix: str) -> dict:
    return {"scale": _g(sd, f"{prefix}.weight"), "bias": _g(sd, f"{prefix}.bias")}


def _folded(sd: SD, prefix: str) -> torch.Tensor:
    """A conv's weight, plain or weight-normed (w = g v / ||v|| over every
    dim but 0, in float64)."""
    if f"{prefix}.weight" in sd:
        return torch.as_tensor(sd[f"{prefix}.weight"]).double()
    g = torch.as_tensor(sd[f"{prefix}.weight_g"]).double()
    v = torch.as_tensor(sd[f"{prefix}.weight_v"]).double()
    return g * v / v.square().sum(dim=tuple(range(1, v.ndim)), keepdim=True).sqrt()


def _conv(sd: SD, prefix: str) -> dict:
    """torch Conv1d ``[out, in, k]`` -> ``[k, in, out]``."""
    p = {"w": _folded(sd, prefix).permute(2, 1, 0).float()}
    if f"{prefix}.bias" in sd:
        p["b"] = _g(sd, f"{prefix}.bias")
    return p


def _conv_transpose(sd: SD, prefix: str) -> dict:
    """torch ConvTranspose1d ``[in, out, k]`` -> flipped ``[k, in, out]``."""
    p = {"w": _folded(sd, prefix).flip(-1).permute(2, 0, 1).float()}
    if f"{prefix}.bias" in sd:
        p["b"] = _g(sd, f"{prefix}.bias")
    return p


# -- flow converter --------------------------------------------------------------


def convert_glm4v_flow(sd: SD, cfg: GLM4VFlowConfig) -> dict:
    """CosyVoice ``MaskedDiffWithXvec`` state dict -> the GLM4VFlow tree."""
    enc_layers = []
    for i in range(cfg.encoder.num_blocks):
        pre = f"encoder.encoders.{i}"
        att = f"{pre}.self_attn"
        layer = {
            "norm_mha": _ln(sd, f"{pre}.norm_mha"),
            "q": _lin(sd, f"{att}.linear_q"),
            "k": _lin(sd, f"{att}.linear_k"),
            "v": _lin(sd, f"{att}.linear_v"),
            "o": _lin(sd, f"{att}.linear_out"),
            "pos": _lin(sd, f"{att}.linear_pos"),
            "pos_bias_u": _g(sd, f"{att}.pos_bias_u"),
            "pos_bias_v": _g(sd, f"{att}.pos_bias_v"),
            "norm_ff": _ln(sd, f"{pre}.norm_ff"),
            "ffn": {"w1": _lin(sd, f"{pre}.feed_forward.w_1"),
                    "w2": _lin(sd, f"{pre}.feed_forward.w_2")},
        }
        if cfg.encoder.macaron_style:
            layer["norm_ff_macaron"] = _ln(sd, f"{pre}.norm_ff_macaron")
            layer["ffn_macaron"] = {"w1": _lin(sd, f"{pre}.feed_forward_macaron.w_1"),
                                    "w2": _lin(sd, f"{pre}.feed_forward_macaron.w_2")}
        if cfg.encoder.use_cnn_module:
            cm = f"{pre}.conv_module"
            layer["norm_conv"] = _ln(sd, f"{pre}.norm_conv")
            layer["norm_final"] = _ln(sd, f"{pre}.norm_final")
            layer["pw1"] = _conv(sd, f"{cm}.pointwise_conv1")
            layer["dw"] = _conv(sd, f"{cm}.depthwise_conv")
            layer["pw2"] = _conv(sd, f"{cm}.pointwise_conv2")
            if cfg.encoder.cnn_norm == "batch_norm":
                layer["bn"] = {"scale": _g(sd, f"{cm}.norm.weight"),
                               "bias": _g(sd, f"{cm}.norm.bias"),
                               "mean": _g(sd, f"{cm}.norm.running_mean"),
                               "var": _g(sd, f"{cm}.norm.running_var")}
            else:
                layer["cn_ln"] = _ln(sd, f"{cm}.norm")
        enc_layers.append(layer)

    n = cfg.regulator_stages
    regulator = {
        "convs": [_conv(sd, f"length_regulator.model.{3 * i}") for i in range(n)],
        "norms": [_ln(sd, f"length_regulator.model.{3 * i + 1}") for i in range(n)],
        "out": _conv(sd, f"length_regulator.model.{3 * n}"),
    }

    def resnet(pre: str) -> dict:
        return {"mlp": _lin(sd, f"{pre}.mlp.1"),
                "b1_conv": _conv(sd, f"{pre}.block1.block.0"),
                "b1_gn": _ln(sd, f"{pre}.block1.block.1"),
                "b2_conv": _conv(sd, f"{pre}.block2.block.0"),
                "b2_gn": _ln(sd, f"{pre}.block2.block.1"),
                "res": _conv(sd, f"{pre}.res_conv")}

    def txblock(pre: str) -> dict:
        return {"ln1": _ln(sd, f"{pre}.norm1"),
                "to_q": _lin(sd, f"{pre}.attn1.to_q"),
                "to_k": _lin(sd, f"{pre}.attn1.to_k"),
                "to_v": _lin(sd, f"{pre}.attn1.to_v"),
                "to_out": _lin(sd, f"{pre}.attn1.to_out.0"),
                "ln3": _ln(sd, f"{pre}.norm3"),
                "ff_in": _lin(sd, f"{pre}.ff.net.0.proj"),
                "ff_out": _lin(sd, f"{pre}.ff.net.2")}

    u, est = cfg.unet, "decoder.estimator"
    unet = {
        "time_mlp": {"lin1": _lin(sd, f"{est}.time_mlp.linear_1"),
                     "lin2": _lin(sd, f"{est}.time_mlp.linear_2")},
        "down": [], "mid": [], "up": [],
        "final_block": {"conv": _conv(sd, f"{est}.final_block.block.0"),
                        "gn": _ln(sd, f"{est}.final_block.block.1")},
        "final_proj": _conv(sd, f"{est}.final_proj"),
    }
    n_up = len(u.channels)
    for i in range(n_up):
        last = i == n_up - 1
        pre = f"{est}.down_blocks.{i}"
        unet["down"].append({
            "resnet": resnet(f"{pre}.0"),
            "tx": [txblock(f"{pre}.1.{j}") for j in range(u.n_blocks)],
            # Downsample1D wraps its conv as `.conv`; the last is a bare Conv1d
            "down": _conv(sd, f"{pre}.2" if last else f"{pre}.2.conv"),
        })
    for i in range(u.num_mid_blocks):
        pre = f"{est}.mid_blocks.{i}"
        unet["mid"].append({"resnet": resnet(f"{pre}.0"),
                            "tx": [txblock(f"{pre}.1.{j}") for j in range(u.n_blocks)]})
    for i in range(n_up):
        last = i == n_up - 1
        pre = f"{est}.up_blocks.{i}"
        unet["up"].append({
            "resnet": resnet(f"{pre}.0"),
            "tx": [txblock(f"{pre}.1.{j}") for j in range(u.n_blocks)],
            "up": _conv(sd, f"{pre}.2") if last else _conv_transpose(sd, f"{pre}.2.conv"),
        })
    return {
        "input_embedding": _g(sd, "input_embedding.weight"),
        "spk_affine": _lin(sd, "spk_embed_affine_layer"),
        "encoder": {"embed": {"lin": _lin(sd, "encoder.embed.out.0"),
                              "ln": _ln(sd, "encoder.embed.out.1")},
                    "after_norm": _ln(sd, "encoder.after_norm"),
                    "layers": enc_layers},
        "encoder_proj": _lin(sd, "encoder_proj"),
        "regulator": regulator,
        "unet": unet,
    }


# -- HiFT converter --------------------------------------------------------------


def convert_hift(sd: SD, cfg: HiFTConfig) -> dict:
    """CosyVoice ``HiFTGenerator`` state dict -> the HiFTGenerator tree."""

    def resblock(pre: str, dilations: tuple) -> dict:
        n = len(dilations)
        return {"convs1": [_conv(sd, f"{pre}.convs1.{j}") for j in range(n)],
                "convs2": [_conv(sd, f"{pre}.convs2.{j}") for j in range(n)],
                "alpha1": [_g(sd, f"{pre}.activations1.{j}.alpha") for j in range(n)],
                "alpha2": [_g(sd, f"{pre}.activations2.{j}.alpha") for j in range(n)]}

    n_up, n_kernels = len(cfg.upsample_rates), len(cfg.resblock_kernel_sizes)
    return {
        "f0": {"convs": [_conv(sd, f"f0_predictor.condnet.{2 * i}") for i in range(5)],
               "head": _lin(sd, "f0_predictor.classifier")},
        "source_linear": _lin(sd, "m_source.l_linear"),
        "conv_pre": _conv(sd, "conv_pre"),
        "ups": [_conv_transpose(sd, f"ups.{i}") for i in range(n_up)],
        "source_downs": [_conv(sd, f"source_downs.{i}") for i in range(n_up)],
        "source_resblocks": [resblock(f"source_resblocks.{i}", cfg.source_resblock_dilations[i])
                             for i in range(n_up)],
        "resblocks": [resblock(f"resblocks.{i * n_kernels + j}", cfg.resblock_dilations[j])
                      for i in range(n_up) for j in range(n_kernels)],
        "conv_post": _conv(sd, "conv_post"),
    }


# -- config.yaml ---------------------------------------------------------------------


def parse_hyperpyyaml(text: str) -> dict:
    """A CosyVoice ``config.yaml`` read WITHOUT running it: ``!new:pkg.Class``
    on a mapping gives ``{"_class": "pkg.Class", **kwargs}``, ``!name:x`` the
    string ``x``, ``!ref <k>`` the text ``<k>`` (``utils/yaml_subset.py``)."""
    from rstnet_tpu_torch.utils import yaml_subset

    return yaml_subset.loads(text)


def configs_from_yaml(text: str) -> tuple[GLM4VFlowConfig, HiFTConfig]:
    """The checkpoint's flow and HiFT hyperparameters as the configs, as the
    JAX function maps them; HiFT's ``f0_predictor.cond_channels`` also sets
    ``f0_cond_channels`` (the port builds its modules from the config)."""
    y = parse_hyperpyyaml(text)
    f = y["flow"]
    enc = f.get("encoder", {})
    dec = f.get("decoder", {})
    est = dec.get("estimator", {})
    cfm = dec.get("cfm_params", {})
    reg = f.get("length_regulator", {})
    enc_cfg = ConformerConfig(
        input_size=enc.get("input_size", 512),
        output_size=enc.get("output_size", 512),
        attention_heads=enc.get("attention_heads", 8),
        linear_units=enc.get("linear_units", 2048),
        num_blocks=enc.get("num_blocks", 6),
        block_size=enc.get("block_size", 25),
        pos_enc="rel_pos_espnet" if enc.get("pos_enc_layer_type", "rel_pos")
        in ("rel_pos_espnet",) else "rel_pos",
        macaron_style=enc.get("macaron_style", True),
        use_cnn_module=enc.get("use_cnn_module", True),
        cnn_kernel=enc.get("cnn_module_kernel", 15),
        cnn_causal=enc.get("causal", False),
        cnn_norm=enc.get("cnn_module_norm", "batch_norm"),
        key_bias=enc.get("key_bias", True),
    )
    unet_cfg = UNetConfig(
        in_channels=est.get("in_channels", 320),
        out_channels=est.get("out_channels", 80),
        channels=tuple(est.get("channels", (256, 256))),
        attention_head_dim=est.get("attention_head_dim", 64),
        n_blocks=est.get("n_blocks", 4),
        num_mid_blocks=est.get("num_mid_blocks", 12),
        num_heads=est.get("num_heads", 8),
        act_fn=est.get("act_fn", "gelu"),
    )
    flow_cfg = GLM4VFlowConfig(
        vocab_size=f.get("vocab_size", 16384),
        input_size=f.get("input_size", 512),
        output_size=f.get("output_size", 80),
        spk_embed_dim=f.get("spk_embed_dim", 192),
        input_frame_rate=float(f.get("input_frame_rate", 12.5)),
        regulator_stages=len(reg.get("sampling_ratios", (1, 1, 1, 1))),
        encoder=enc_cfg,
        unet=unet_cfg,
        inference_cfg_rate=float(cfm.get("inference_cfg_rate", 0.7)),
        sigma_min=float(cfm.get("sigma_min", 1e-6)),
    )
    h = y["hift"]
    istft = h.get("istft_params", {"n_fft": 16, "hop_len": 4})
    f0_pred = h.get("f0_predictor", {})
    hift_cfg = HiFTConfig(
        in_channels=h.get("in_channels", 80),
        base_channels=h.get("base_channels", 512),
        nb_harmonics=h.get("nb_harmonics", 8),
        sampling_rate=h.get("sampling_rate", 22050),
        nsf_alpha=h.get("nsf_alpha", 0.1),
        nsf_sigma=h.get("nsf_sigma", 0.003),
        nsf_voiced_threshold=h.get("nsf_voiced_threshold", 10),
        upsample_rates=tuple(h.get("upsample_rates", (8, 8))),
        upsample_kernel_sizes=tuple(h.get("upsample_kernel_sizes", (16, 16))),
        istft_n_fft=istft.get("n_fft", 16),
        istft_hop=istft.get("hop_len", 4),
        resblock_kernel_sizes=tuple(h.get("resblock_kernel_sizes", (3, 7, 11))),
        resblock_dilations=tuple(tuple(d) for d in h.get(
            "resblock_dilation_sizes", ((1, 3, 5), (1, 3, 5), (1, 3, 5)))),
        source_resblock_kernel_sizes=tuple(h.get("source_resblock_kernel_sizes", (7, 11))),
        source_resblock_dilations=tuple(tuple(d) for d in h.get(
            "source_resblock_dilation_sizes", ((1, 3, 5), (1, 3, 5)))),
        lrelu_slope=h.get("lrelu_slope", 0.1),
        audio_limit=h.get("audio_limit", 0.99),
        f0_cond_channels=(f0_pred.get("cond_channels", 512) if isinstance(f0_pred, dict)
                          else 512),
    )
    return flow_cfg, hift_cfg


def load_glm4v_decoder(ckpt_dir: str, device="cuda") -> "GLM4VAudioDecoder":
    """A ``glm-4-voice-decoder`` directory (``config.yaml`` + ``flow.pt`` +
    ``hift.pt``) -> a :class:`GLM4VAudioDecoder` on ``device``."""
    from rstnet_tpu_torch.models.convert import load_torch_state_dict

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"load_glm4v_decoder(device={str(device)!r}): torch sees no CUDA "
                           "device (pass device='cpu' to run on the CPU)")
    with open(os.path.join(ckpt_dir, "config.yaml")) as fh:
        flow_cfg, hift_cfg = configs_from_yaml(fh.read())
    flow = GLM4VFlow(flow_cfg, device="meta").to_empty(device=device)
    hift = HiFTGenerator(hift_cfg, device="meta").to_empty(device=device)
    load_jax_tree(flow, convert_glm4v_flow(
        load_torch_state_dict(os.path.join(ckpt_dir, "flow.pt")), flow_cfg))
    load_jax_tree(hift, convert_hift(
        load_torch_state_dict(os.path.join(ckpt_dir, "hift.pt")), hift_cfg))
    return GLM4VAudioDecoder(flow, hift)


# -- AudioDecoder: offline and block-streaming token2wav ---------------------------------


@dataclasses.dataclass
class GLM4VAudioDecoder:
    """The reference ``AudioDecoder`` over the flow + HiFT modules."""

    flow: GLM4VFlow
    hift: HiFTGenerator
    token_overlap_len: int = 5
    mel_cache_len: int = 1

    @property
    def device(self) -> torch.device:
        return self.flow.input_embedding.device

    @property
    def mel_overlap_len(self) -> int:
        cfg = self.flow.config
        return int(self.token_overlap_len / cfg.input_frame_rate
                   * cfg.mel_sample_rate / cfg.mel_hop)

    @property
    def source_cache_len(self) -> int:
        h = self.hift.config
        return self.mel_cache_len * h.istft_hop * int(np.prod(h.upsample_rates))

    def _draw(self, generator, draw) -> Draw:
        if draw is not None:
            return draw
        return generator_draws(generator or torch.Generator().manual_seed(42), self.device)

    def _mel(self, token, draw: Draw, prompt_token=None, prompt_feat=None):
        cfg = self.flow.config
        if prompt_token is not None and prompt_token.shape[1] > 0:
            token = torch.cat([prompt_token, token], dim=1)
        z = draw("z", (token.shape[0], cfg.mel_len(token.shape[1]), cfg.output_size))
        mel = self.flow.inference(token, z, prompt_feat=prompt_feat)
        if prompt_feat is not None and prompt_feat.shape[1] > 0:
            mel = mel[:, prompt_feat.shape[1]:]
        return mel

    @torch.no_grad()
    def offline_inference(self, token: torch.Tensor, generator: Optional[torch.Generator] = None,
                          draw: Optional[Draw] = None) -> torch.Tensor:
        """token ``[B, T_tok]`` -> wav ``[B, mel_len(T_tok) * total_upsample]``.
        The draws come from ``draw``, else from ``generator`` (a CPU one;
        seeded 42 when None)."""
        draw = self._draw(generator, draw)
        wav, _ = self.hift.inference(self._mel(token.to(self.device), draw), draw=draw)
        return wav

    @torch.no_grad()
    def stream_inference(self, token: torch.Tensor, block_size: Optional[int] = None,
                         generator: Optional[torch.Generator] = None,
                         draw: Optional[Draw] = None) -> torch.Tensor:
        """Block-streaming synthesis. ``block_size`` defaults to the
        conformer's grid width (``encoder.block_size``), so the blocks stay
        aligned with the block-causal mask the model was trained with."""
        cfg = self.flow.config
        block_size = block_size or cfg.encoder.block_size
        draw = self._draw(generator, draw)
        token = token.to(self.device)
        T = token.shape[1]
        windows: dict = {}  # cross-fade windows by overlap length
        mel_overlap = hift_mel_cache = hift_source_cache = None
        mels, wavs = [], []
        for start in range(0, T, block_size):
            block = token[:, start : start + block_size]
            finalize = start + block_size >= T
            if mels:
                prompt_feat, prompt_token = torch.cat(mels, dim=1), token[:, :start]
            else:
                prompt_feat = prompt_token = None
            mel = self._mel(block, draw, prompt_token, prompt_feat)
            if mel_overlap is not None and mel_overlap.shape[1] > 0:
                # the regenerated head is as long as what the last block
                # trimmed, which may be shorter than mel_overlap_len
                n = mel_overlap.shape[1]
                if n not in windows:
                    windows[n] = torch.from_numpy(np.hamming(2 * n)).float().to(self.device)
                window = windows[n]
                head = mel[:, :n] * window[:n, None] + mel_overlap * window[n:, None]
                mel = torch.cat([head, mel[:, n:]], dim=1)
            if hift_mel_cache is not None:
                full_mel = torch.cat([hift_mel_cache, mel], dim=1)
                cache_source = hift_source_cache
            else:
                full_mel, cache_source = mel, None
            if not finalize:
                # trim at most full_mel - 1 frames, so every block emits audio
                # and the HiFT mel cache stays non-empty
                trim = min(self.mel_overlap_len, max(full_mel.shape[1] - 1, 0))
                mel_overlap = full_mel[:, full_mel.shape[1] - trim:]
                full_mel = full_mel[:, : full_mel.shape[1] - trim]
                wav, src = self.hift.inference(full_mel, draw=draw, cache_source=cache_source)
                hift_mel_cache = full_mel[:, -self.mel_cache_len:]
                hift_source_cache = src[:, -self.source_cache_len:]
                wav = wav[:, : wav.shape[1] - self.source_cache_len]
            else:
                wav, _ = self.hift.inference(full_mel, draw=draw, cache_source=cache_source)
            mels.append(mel if finalize else full_mel)
            wavs.append(wav)
        return torch.cat(wavs, dim=1)
