"""A model of this package written under the upstream checkpoint names: the
inverse of ``models/convert.py``.

``upstream_mimi``, ``upstream_moshi``, ``upstream_backbone`` and
``upstream_speech_lm`` give ``{upstream name: tensor}`` (views of the
module's parameters where the layout allows) in the naming of kyutai's Mimi
and Moshi checkpoints and of litgpt's ``lit_model.pth``; ``write_upstream``
writes such a dict to a ``.safetensors`` file (its own writer: the header
length, the JSON header padded to 8 bytes, then each tensor's bytes) or to
a torch ``.pth``/``.pt`` file. The tests build the upstream files both
converters read with it, and ``chip_smoke.py`` the full-width ones it serves
and trains from. Mimi's convs can be written in each of the three upstream
namings (``conv_naming``: ``plain`` ``weight``, ``weight_norm``
``weight_g``/``weight_v``, ``parametrizations``
``parametrizations.weight.original0/1``).

GLM-4-Voice's two directories, from seeded modules of this package at any
width: ``write_glm4v_tokenizer`` writes ``glm-4-voice-tokenizer``
(``config.json`` and ``model.safetensors`` under the HF ``WhisperVQEncoder``
names) and ``write_glm4v_decoder`` writes ``glm-4-voice-decoder``
(``config.yaml`` in hyperpyyaml form, ``flow.pt`` and ``hift.pt`` under
CosyVoice's names, HiFT's convs weight-normed as ``weight_g``/``weight_v``
unless ``weight_norm=False``). The names are exactly those the converters
read.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path

import torch

from rstnet_tpu_torch.models.convert import SAFETENSORS_DTYPES, seanet_positions
from rstnet_tpu_torch.ops.conv import StreamingConvTranspose1d

CONV_NAMINGS = ("plain", "weight_norm", "parametrizations")
_DTYPE_NAMES = {v: k for k, v in SAFETENSORS_DTYPES.items()}


def _conv(out: dict, prefix: str, conv, naming: str) -> None:
    """One conv's weight (and bias) under ``prefix`` in ``naming``."""
    params = conv._parameters
    if naming == "plain":
        out[f"{prefix}.weight"] = conv.resolved_weight() if "weight_v" in params else conv.weight
    else:
        if "weight_v" in params:
            g, v = conv.weight_g, conv.weight_v
        else:
            v = conv.weight
            g = v.float().square().sum((1, 2), keepdim=True).sqrt().to(v.dtype)
        names = (("weight_g", "weight_v") if naming == "weight_norm" else
                 ("parametrizations.weight.original0", "parametrizations.weight.original1"))
        out[f"{prefix}.{names[0]}"], out[f"{prefix}.{names[1]}"] = g, v
    if params.get("bias") is not None:
        out[f"{prefix}.bias"] = conv.bias


def upstream_transformer(prefix: str, module) -> dict:
    layers, out = module.layers, {}
    S = module.weights_per_step
    for i in range(module.num_layers):
        b = f"{prefix}.layers.{i}"
        out[f"{b}.self_attn.in_proj_weight"] = layers.in_proj[i]
        out[f"{b}.self_attn.out_proj.weight"] = layers.out_proj[i]
        for n in ("norm1", "norm2"):
            norm = getattr(layers, n)
            if "alpha" in norm._parameters:
                out[f"{b}.{n}.alpha"] = norm.alpha[i].reshape(1, 1, -1)
            else:
                out[f"{b}.{n}.weight"], out[f"{b}.{n}.bias"] = norm.weight[i], norm.bias[i]
        if module.gating == "none":
            out[f"{b}.linear1.weight"] = layers.linear1[i]
            out[f"{b}.linear2.weight"] = layers.linear2[i]
        elif S:
            for s in range(S):
                out[f"{b}.gating.{s}.linear_in.weight"] = layers.gating.linear_in[i, s]
                out[f"{b}.gating.{s}.linear_out.weight"] = layers.gating.linear_out[i, s]
        else:
            out[f"{b}.gating.linear_in.weight"] = layers.gating.linear_in[i]
            out[f"{b}.gating.linear_out.weight"] = layers.gating.linear_out[i]
        if module.has_layer_scale:
            out[f"{b}.layer_scale_1.scale"] = layers.layer_scale_1.scale[i]
            out[f"{b}.layer_scale_2.scale"] = layers.layer_scale_2.scale[i]
    return out


def upstream_projected(prefix: str, module) -> dict:
    out = upstream_transformer(f"{prefix}.transformer", module.transformer)
    if "input_proj" in module._parameters:
        out[f"{prefix}.input_proj.weight"] = module.input_proj
    for i in range(len(module.output_dimensions)):
        if f"output_proj_{i}" in module._parameters:
            out[f"{prefix}.output_projs.{i}.weight"] = getattr(module, f"output_proj_{i}")
    return out


def upstream_seanet(prefix: str, module, naming: str = "plain") -> dict:
    out = {}
    for pos, layer in seanet_positions(module):
        if isinstance(layer, StreamingConvTranspose1d):
            _conv(out, f"{prefix}.model.{pos}.convtr.convtr", layer, naming)
        elif hasattr(layer, "block"):
            for j, conv in enumerate(layer.block):
                _conv(out, f"{prefix}.model.{pos}.block.{2 * j + 1}.conv.conv", conv, naming)
            if layer.shortcut is not None:
                _conv(out, f"{prefix}.model.{pos}.shortcut.conv.conv", layer.shortcut, naming)
        else:
            _conv(out, f"{prefix}.model.{pos}.conv.conv", layer, naming)
    return out


def upstream_rvq(prefix: str, module) -> dict:
    out = {}
    for name in ("input_proj", "output_proj"):
        if name in module._parameters:
            out[f"{prefix}.{name}.weight"] = getattr(module, name)[..., None]
    cb = module.layers
    for k in range(module.n_q):
        b = f"{prefix}.vq.layers.{k}._codebook"
        out[f"{b}.embedding_sum"] = cb.embedding_sum[k]
        out[f"{b}.cluster_usage"] = cb.cluster_usage[k]
        out[f"{b}._initialized"] = cb.initialized[k].reshape(1)
    return out


def upstream_mimi(model, conv_naming: str = "plain") -> dict:
    """A ``MimiModel`` under kyutai's Mimi names."""
    if conv_naming not in CONV_NAMINGS:
        raise ValueError(f"conv naming {conv_naming!r}, expected one of {CONV_NAMINGS}")
    out = {**upstream_seanet("encoder", model.encoder, conv_naming),
           **upstream_seanet("decoder", model.decoder, conv_naming),
           **upstream_projected("encoder_transformer", model.encoder_transformer),
           **upstream_projected("decoder_transformer", model.decoder_transformer),
           **upstream_rvq("quantizer.rvq_first", model.quantizer.rvq_first),
           **upstream_rvq("quantizer.rvq_rest", model.quantizer.rvq_rest)}
    if model.downsample is not None:
        _conv(out, "downsample.conv.conv.conv", model.downsample, conv_naming)
        _conv(out, "upsample.convtr.convtr.convtr", model.upsample, conv_naming)
    return out


def _linear(out: dict, prefix: str, module) -> None:
    out[f"{prefix}.weight"] = module.weight
    if module._parameters.get("bias") is not None:
        out[f"{prefix}.bias"] = module.bias


def _norm(out: dict, prefix: str, module) -> None:
    if "alpha" in module._parameters:
        out[f"{prefix}.alpha"] = module.alpha.reshape(1, 1, -1)
    else:
        _linear(out, prefix, module)


def upstream_backbone(backbone, prefix: str = "") -> dict:
    """A ``Backbone`` under litgpt's names (``lit_model.pth``)."""
    out = {f"{prefix}transformer.wte.weight": backbone.wte}
    for i, block in enumerate(backbone.blocks):
        b = f"{prefix}transformer.h.{i}"
        for name, module in block.named_children():
            if name == "mlp":
                for sub, lin in module.named_children():
                    _linear(out, f"{b}.mlp.{sub}", lin)
            elif name in ("attn", "proj"):
                _linear(out, f"{b}.attn.{name}", module)
            else:
                _linear(out, f"{b}.{name}", module)
    _linear(out, f"{prefix}transformer.ln_f", backbone.ln_f)
    _linear(out, f"{prefix}lm_head", backbone.lm_head)
    return out


def upstream_speech_lm(model) -> dict:
    """A ``SpeechTextLM`` under the flagship's names
    (``models/llama_streaming.py``)."""
    cfg = model.config
    out = {**upstream_backbone(model.backbone),
           **upstream_transformer("codecformer", model.codecformer),
           "codecformer_text_emb.weight": model.codecformer_text_emb}
    for k in range(cfg.n_q):
        out[f"input_emb.{k}.weight"] = model.input_emb[k]
    for k in range(cfg.dep_q - 1):
        out[f"codecformer_emb.{k}.weight"] = model.codecformer_emb[k]
    for k in range(model.codecformer_in.shape[0]):
        out[f"codecformer_in.{k}.weight"] = model.codecformer_in[k]
    bias = model.audio_linears._parameters.get("bias")
    for k in range(cfg.dep_q):
        out[f"audio_linears.{k}.weight"] = model.audio_linears.weight[k]
        if bias is not None:
            out[f"audio_linears.{k}.bias"] = bias[k]
    if cfg.codecformer_norm_emb:
        for w in ("weight", "bias"):
            for k in range(cfg.n_q):
                out[f"input_emb.{k}.norm.{w}"] = getattr(model.input_emb_norm, w)[k, 0]
            for k in range(cfg.dep_q - 1):
                out[f"codecformer_emb.{k}.norm.{w}"] = getattr(model.codecformer_emb_norm, w)[k]
            out[f"codecformer_text_emb.norm.{w}"] = getattr(model.codecformer_text_emb_norm, w)
    return out


def upstream_moshi(model) -> dict:
    """A ``MoshiLMModel`` under kyutai's Moshi names."""
    out = {"text_emb.weight": model.text_emb,
           "depformer_text_emb.weight": model.depformer_text_emb,
           **upstream_transformer("transformer", model.transformer),
           **upstream_transformer("depformer", model.depformer)}
    for k in range(model.n_q):
        out[f"emb.{k}.weight"] = model.emb[k]
    _linear(out, "text_linear", model.text_linear)
    _norm(out, "out_norm", model.out_norm)
    for k in range(model.depformer_in.shape[0]):
        out[f"depformer_in.{k}.weight"] = model.depformer_in[k]
    for k in range(model.dep_q - 1):
        out[f"depformer_emb.{k}.weight"] = model.depformer_emb[k]
    bias = model.linears._parameters.get("bias")
    for k in range(model.dep_q):
        out[f"linears.{k}.weight"] = model.linears.weight[k]
        if bias is not None:
            out[f"linears.{k}.bias"] = bias[k]
    return out


# -- GLM-4-Voice -----------------------------------------------------------------


def _glm4v_lin(out: dict, name: str, p) -> None:
    out[f"{name}.weight"] = p.w.T
    if p.b is not None:
        out[f"{name}.bias"] = p.b


def _glm4v_norm(out: dict, name: str, p) -> None:
    out[f"{name}.weight"], out[f"{name}.bias"] = p.scale, p.bias


def _glm4v_conv(out: dict, name: str, p, weight_norm: bool = False) -> None:
    """A ``glm4v_flow.Conv`` (torch's layout), its weight plain or as
    ``weight_g`` (the norm over every dim but 0) and ``weight_v`` (twice the
    weight, so only the folded pair gives it back)."""
    if weight_norm:
        w = p.w.detach()
        out[f"{name}.weight_g"] = w.double().square().sum((1, 2), keepdim=True).sqrt().float()
        out[f"{name}.weight_v"] = 2.0 * w
    else:
        out[f"{name}.weight"] = p.w
    if p.b is not None:
        out[f"{name}.bias"] = p.b


def upstream_whisper_vq(model, prefix: str = "") -> dict:
    """A ``WhisperVQEncoder`` under the HF names (``prefix`` ``""``,
    ``"encoder."`` or ``"model.encoder."``)."""
    out = {}
    for name in ("conv1", "conv2"):
        _glm4v_conv(out, f"{prefix}{name}", getattr(model, name))
    out[f"{prefix}embed_positions.weight"] = model.embed_positions
    out[f"{prefix}codebook.weight"] = model.codebook
    for i, layer in enumerate(model.layers):
        pre = f"{prefix}layers.{i}."
        _glm4v_norm(out, pre + "self_attn_layer_norm", layer.attn_ln)
        for ours, theirs in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"),
                             ("o", "out_proj")):
            _glm4v_lin(out, f"{pre}self_attn.{theirs}", getattr(layer, ours))
        _glm4v_norm(out, pre + "final_layer_norm", layer.final_ln)
        _glm4v_lin(out, pre + "fc1", layer.fc1)
        _glm4v_lin(out, pre + "fc2", layer.fc2)
    return out


def whisper_vq_hf_config(cfg) -> dict:
    """The ``config.json`` fields ``load_glm4v_encoder`` reads; the layers
    kept are ``quantize_position``, so the config must keep as many."""
    if cfg.num_layers != cfg.quantize_position:
        raise ValueError(f"num_layers {cfg.num_layers} != quantize_position "
                         f"{cfg.quantize_position}: config.json cannot say so")
    return {"num_mel_bins": cfg.n_mels, "d_model": cfg.d_model,
            "encoder_attention_heads": cfg.num_heads, "encoder_ffn_dim": cfg.ffn_dim,
            "quantize_position": cfg.quantize_position,
            "pooling_kernel_size": cfg.pooling_kernel_size,
            "pooling_position": cfg.pooling_position, "pooling_type": cfg.pooling_type,
            "quantize_vocab_size": cfg.quantize_vocab_size,
            "max_source_positions": cfg.max_source_positions,
            "quantize_causal_encoder": cfg.causal_encoder,
            "quantize_causal_block_size": cfg.causal_block_size}


def write_glm4v_tokenizer(root: str | Path, model, prefix: str = "") -> Path:
    """``root`` as a ``glm-4-voice-tokenizer`` directory: ``config.json``
    and ``model.safetensors`` (float32)."""
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    (root / "config.json").write_text(json.dumps(whisper_vq_hf_config(model.config), indent=1))
    write_safetensors(root / "model.safetensors", upstream_whisper_vq(model, prefix))
    return root


def upstream_glm4v_flow(flow) -> dict:
    """A ``GLM4VFlow`` under CosyVoice's ``MaskedDiffWithXvec`` names."""
    cfg, out = flow.config, {}
    out["input_embedding.weight"] = flow.input_embedding
    _glm4v_lin(out, "spk_embed_affine_layer", flow.spk_affine)
    enc = flow.encoder
    _glm4v_lin(out, "encoder.embed.out.0", enc.embed.lin)
    _glm4v_norm(out, "encoder.embed.out.1", enc.embed.ln)
    _glm4v_norm(out, "encoder.after_norm", enc.after_norm)
    for i, layer in enumerate(enc.layers):
        pre = f"encoder.encoders.{i}"
        att = f"{pre}.self_attn"
        _glm4v_norm(out, f"{pre}.norm_mha", layer.norm_mha)
        for ours, theirs in (("q", "linear_q"), ("k", "linear_k"), ("v", "linear_v"),
                             ("o", "linear_out"), ("pos", "linear_pos")):
            _glm4v_lin(out, f"{att}.{theirs}", getattr(layer, ours))
        out[f"{att}.pos_bias_u"], out[f"{att}.pos_bias_v"] = layer.pos_bias_u, layer.pos_bias_v
        _glm4v_norm(out, f"{pre}.norm_ff", layer.norm_ff)
        _glm4v_lin(out, f"{pre}.feed_forward.w_1", layer.ffn.w1)
        _glm4v_lin(out, f"{pre}.feed_forward.w_2", layer.ffn.w2)
        if cfg.encoder.macaron_style:
            _glm4v_norm(out, f"{pre}.norm_ff_macaron", layer.norm_ff_macaron)
            _glm4v_lin(out, f"{pre}.feed_forward_macaron.w_1", layer.ffn_macaron.w1)
            _glm4v_lin(out, f"{pre}.feed_forward_macaron.w_2", layer.ffn_macaron.w2)
        if cfg.encoder.use_cnn_module:
            cm = f"{pre}.conv_module"
            _glm4v_norm(out, f"{pre}.norm_conv", layer.norm_conv)
            _glm4v_norm(out, f"{pre}.norm_final", layer.norm_final)
            _glm4v_conv(out, f"{cm}.pointwise_conv1", layer.pw1)
            _glm4v_conv(out, f"{cm}.depthwise_conv", layer.dw)
            _glm4v_conv(out, f"{cm}.pointwise_conv2", layer.pw2)
            if cfg.encoder.cnn_norm == "batch_norm":
                bn = layer.bn
                out[f"{cm}.norm.weight"], out[f"{cm}.norm.bias"] = bn.scale, bn.bias
                out[f"{cm}.norm.running_mean"], out[f"{cm}.norm.running_var"] = bn.mean, bn.var
            else:
                _glm4v_norm(out, f"{cm}.norm", layer.cn_ln)
    _glm4v_lin(out, "encoder_proj", flow.encoder_proj)
    reg = flow.regulator
    for i, (conv, norm) in enumerate(zip(reg.convs, reg.norms)):
        _glm4v_conv(out, f"length_regulator.model.{3 * i}", conv)
        _glm4v_norm(out, f"length_regulator.model.{3 * i + 1}", norm)
    _glm4v_conv(out, f"length_regulator.model.{3 * len(reg.convs)}", reg.out)

    def block(pre: str, blk) -> None:
        r = blk.resnet
        _glm4v_lin(out, f"{pre}.0.mlp.1", r.mlp)
        _glm4v_conv(out, f"{pre}.0.block1.block.0", r.b1_conv)
        _glm4v_norm(out, f"{pre}.0.block1.block.1", r.b1_gn)
        _glm4v_conv(out, f"{pre}.0.block2.block.0", r.b2_conv)
        _glm4v_norm(out, f"{pre}.0.block2.block.1", r.b2_gn)
        _glm4v_conv(out, f"{pre}.0.res_conv", r.res)
        for j, tx in enumerate(blk.tx):
            t = f"{pre}.1.{j}"
            _glm4v_norm(out, f"{t}.norm1", tx.ln1)
            for name in ("to_q", "to_k", "to_v"):
                _glm4v_lin(out, f"{t}.attn1.{name}", getattr(tx, name))
            _glm4v_lin(out, f"{t}.attn1.to_out.0", tx.to_out)
            _glm4v_norm(out, f"{t}.norm3", tx.ln3)
            _glm4v_lin(out, f"{t}.ff.net.0.proj", tx.ff_in)
            _glm4v_lin(out, f"{t}.ff.net.2", tx.ff_out)

    unet, est = flow.unet, "decoder.estimator"
    _glm4v_lin(out, f"{est}.time_mlp.linear_1", unet.time_mlp.lin1)
    _glm4v_lin(out, f"{est}.time_mlp.linear_2", unet.time_mlp.lin2)
    n = len(unet.down)
    for i, blk in enumerate(unet.down):
        block(f"{est}.down_blocks.{i}", blk)
        _glm4v_conv(out, f"{est}.down_blocks.{i}.2" + ("" if i == n - 1 else ".conv"), blk.down)
    for i, blk in enumerate(unet.mid):
        block(f"{est}.mid_blocks.{i}", blk)
    for i, blk in enumerate(unet.up):
        block(f"{est}.up_blocks.{i}", blk)
        _glm4v_conv(out, f"{est}.up_blocks.{i}.2" + ("" if i == n - 1 else ".conv"), blk.up)
    _glm4v_conv(out, f"{est}.final_block.block.0", unet.final_block.conv)
    _glm4v_norm(out, f"{est}.final_block.block.1", unet.final_block.gn)
    _glm4v_conv(out, f"{est}.final_proj", unet.final_proj)
    return out


def upstream_hift(hift, weight_norm: bool = True) -> dict:
    """A ``HiFTGenerator`` under CosyVoice's names; with ``weight_norm`` the
    convs upstream wraps in weight norm (all but ``source_downs``) as
    ``weight_g``/``weight_v``."""
    out, wn = {}, weight_norm
    for i, conv in enumerate(hift.f0.convs):
        _glm4v_conv(out, f"f0_predictor.condnet.{2 * i}", conv, wn)
    _glm4v_lin(out, "f0_predictor.classifier", hift.f0.head)
    _glm4v_lin(out, "m_source.l_linear", hift.source_linear)
    _glm4v_conv(out, "conv_pre", hift.conv_pre, wn)
    for i, conv in enumerate(hift.ups):
        _glm4v_conv(out, f"ups.{i}", conv, wn)
    for i, conv in enumerate(hift.source_downs):
        _glm4v_conv(out, f"source_downs.{i}", conv)
    for group in ("source_resblocks", "resblocks"):
        for i, rb in enumerate(getattr(hift, group)):
            for j in range(len(rb.dilations)):
                _glm4v_conv(out, f"{group}.{i}.convs1.{j}", rb.convs1[j], wn)
                _glm4v_conv(out, f"{group}.{i}.convs2.{j}", rb.convs2[j], wn)
                out[f"{group}.{i}.activations1.{j}.alpha"] = rb.alpha1[j]
                out[f"{group}.{i}.activations2.{j}.alpha"] = rb.alpha2[j]
    _glm4v_conv(out, "conv_post", hift.conv_post, wn)
    return out


def _yaml_scalar(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, float):
        text = repr(v)
        # YAML 1.1 reads a float only with a dot: 1e-06 -> 1.0e-06
        return text if "." in text or "e" not in text else text.replace("e", ".0e", 1)
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_yaml_scalar(x) for x in v) + "]"
    if v is None:
        return "null"
    return str(v)


def _yaml_lines(tree: dict, indent: int = 0) -> list[str]:
    """A nested dict as block YAML; a dict's ``_class`` becomes its ``!new:``
    tag."""
    lines = []
    for key, value in tree.items():
        if key == "_class":
            continue
        pad = " " * indent
        if isinstance(value, dict):
            tag = f" !new:{value['_class']}" if "_class" in value else ""
            lines.append(f"{pad}{key}:{tag}")
            lines += _yaml_lines(value, indent + 4)
        else:
            lines.append(f"{pad}{key}: {_yaml_scalar(value)}")
    return lines


def glm4v_decoder_yaml(flow_cfg, hift_cfg) -> str:
    """``config.yaml`` in hyperpyyaml form: the fields
    ``glm4v_decoder.configs_from_yaml`` reads, under CosyVoice's classes. The
    mel rate, hop and solver steps keep their defaults (the file cannot say
    otherwise)."""
    enc, u = flow_cfg.encoder, flow_cfg.unet
    flow = {
        "_class": "cosyvoice.flow.flow.MaskedDiffWithXvec",
        "input_size": flow_cfg.input_size, "output_size": flow_cfg.output_size,
        "spk_embed_dim": flow_cfg.spk_embed_dim, "vocab_size": flow_cfg.vocab_size,
        "input_frame_rate": float(flow_cfg.input_frame_rate),
        "encoder": {
            "_class": "cosyvoice.transformer.encoder.BlockConformerEncoder",
            "input_size": enc.input_size, "output_size": enc.output_size,
            "attention_heads": enc.attention_heads, "linear_units": enc.linear_units,
            "num_blocks": enc.num_blocks, "block_size": enc.block_size,
            "pos_enc_layer_type": enc.pos_enc, "selfattention_layer_type": "block_rel_selfattn",
            "macaron_style": enc.macaron_style, "use_cnn_module": enc.use_cnn_module,
            "cnn_module_kernel": enc.cnn_kernel, "causal": enc.cnn_causal,
            "cnn_module_norm": enc.cnn_norm, "key_bias": enc.key_bias,
        },
        "length_regulator": {
            "_class": "cosyvoice.flow.length_regulator.InterpolateRegulator",
            "channels": flow_cfg.output_size,
            "sampling_ratios": [1] * flow_cfg.regulator_stages,
        },
        "decoder": {
            "_class": "cosyvoice.flow.flow_matching.ConditionalCFM",
            "in_channels": u.in_channels - flow_cfg.output_size,
            "cfm_params": {"_class": "omegaconf.DictConfig",
                           "sigma_min": float(flow_cfg.sigma_min),
                           "inference_cfg_rate": float(flow_cfg.inference_cfg_rate)},
            "estimator": {
                "_class": "cosyvoice.flow.decoder.ConditionalDecoder",
                "in_channels": u.in_channels, "out_channels": u.out_channels,
                "channels": list(u.channels), "attention_head_dim": u.attention_head_dim,
                "n_blocks": u.n_blocks, "num_mid_blocks": u.num_mid_blocks,
                "num_heads": u.num_heads, "act_fn": u.act_fn,
            },
        },
    }
    h = hift_cfg
    hift = {
        "_class": "cosyvoice.hifigan.generator.HiFTGenerator",
        "in_channels": h.in_channels, "base_channels": h.base_channels,
        "nb_harmonics": h.nb_harmonics, "sampling_rate": h.sampling_rate,
        "nsf_alpha": float(h.nsf_alpha), "nsf_sigma": float(h.nsf_sigma),
        "nsf_voiced_threshold": h.nsf_voiced_threshold,
        "upsample_rates": list(h.upsample_rates),
        "upsample_kernel_sizes": list(h.upsample_kernel_sizes),
        "istft_params": {"n_fft": h.istft_n_fft, "hop_len": h.istft_hop},
        "resblock_kernel_sizes": list(h.resblock_kernel_sizes),
        "resblock_dilation_sizes": [list(d) for d in h.resblock_dilations],
        "source_resblock_kernel_sizes": list(h.source_resblock_kernel_sizes),
        "source_resblock_dilation_sizes": [list(d) for d in h.source_resblock_dilations],
        "lrelu_slope": float(h.lrelu_slope), "audio_limit": float(h.audio_limit),
        "f0_predictor": {"_class": "cosyvoice.hifigan.f0_predictor.ConvRNNF0Predictor",
                         "num_class": 1, "in_channels": h.in_channels,
                         "cond_channels": h.f0_cond_channels},
    }
    return "\n".join(_yaml_lines({"flow": flow, "hift": hift})) + "\n"


def write_glm4v_decoder(root: str | Path, flow, hift, weight_norm: bool = True) -> Path:
    """``root`` as a ``glm-4-voice-decoder`` directory: ``config.yaml``,
    ``flow.pt`` and ``hift.pt`` (float32)."""
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    (root / "config.yaml").write_text(glm4v_decoder_yaml(flow.config, hift.config))
    write_upstream(root / "flow.pt", upstream_glm4v_flow(flow))
    write_upstream(root / "hift.pt", upstream_hift(hift, weight_norm))
    return root


def _cast(t: torch.Tensor, dtype) -> torch.Tensor:
    t = t.detach()
    return t.to(dtype) if dtype is not None and t.is_floating_point() else t


def write_safetensors(path: str | Path, tensors: dict, dtype=None) -> int:
    """``tensors`` as a ``.safetensors`` file (float ones cast to ``dtype``
    when given), one tensor at a time, each cast and copied to the host as
    it is written; returns the bytes written."""
    header, offset = {}, 0
    for name, t in tensors.items():
        out_dtype = dtype if dtype is not None and t.is_floating_point() else t.dtype
        n = t.numel() * torch.empty((), dtype=out_dtype).element_size()
        header[name] = {"dtype": _DTYPE_NAMES[out_dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for t in tensors.values():
            host = _cast(t, dtype).contiguous().cpu()
            if host.numel():
                f.write(memoryview(host.reshape(-1).view(torch.uint8).numpy()))
    return 8 + len(raw) + offset


def write_upstream(path: str | Path, tensors: dict, dtype=None, wrap: bool = False) -> Path:
    """Write ``tensors`` (float ones cast to ``dtype`` when given) to
    ``path``: ``.safetensors``/``.sft``/``.sfts`` through
    :func:`write_safetensors`, else ``torch.save`` (under ``{"model": ...}``
    with ``wrap``)."""
    path = Path(path)
    if str(path).endswith((".safetensors", ".sft", ".sfts")):
        write_safetensors(path, tensors, dtype)
    else:
        sd = {k: _cast(v, dtype).contiguous().cpu().clone() for k, v in tensors.items()}
        torch.save({"model": sd} if wrap else sd, path)
    return path
