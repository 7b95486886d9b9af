"""The weights of a Mimi + Moshi configuration: every tensor's name, shape,
dtype and how a random one is drawn.

The names are the published parameter paths of the two models (the JAX
package's pytree paths, which the PyTorch port's ``state_dict`` keys also
are), prefixed ``mimi.`` or ``lm.``. The sizes follow from the
configuration file alone (``derived``), the way upstream's loaders derive
them: a gated FFN's hidden width is two thirds of ``hidden_scale * dim``
(``21 * dim // 8`` when ``hidden_scale`` is 4), and a depformer FFN width is
given outright. Random weights follow the usual initialisers: linear and
conv weights uniform in +-1/sqrt(fan_in), embeddings
standard normal (codebook sums at ``init.codebook_std``), norms at one and
zero, layer scales at their constant.
"""

from __future__ import annotations

import math


def gating_hidden(dim: int, dim_feedforward: int) -> int:
    if dim_feedforward == 4 * dim:
        return (21 * dim) // 8
    return (2 * dim_feedforward) // 3


def derived(cfg: dict) -> dict:
    """The sizes the reference and the counts use, from a configuration."""
    lm, mimi = cfg["lm"], cfg["mimi"]
    d, dd = lm["dim"], lm["depformer_dim"]
    out = {
        "dim": d, "num_heads": lm["num_heads"], "num_layers": lm["num_layers"],
        "hidden": gating_hidden(d, int(lm["hidden_scale"] * d)),
        "context": lm["context"], "card": lm["card"], "text_card": lm["text_card"],
        "n_q": lm["n_q"], "dep_q": lm["dep_q"], "delays": tuple(lm["delays"]),
        "dep_dim": dd, "dep_heads": lm["depformer_num_heads"],
        "dep_layers": lm["depformer_num_layers"],
        "dep_hidden": gating_hidden(dd, lm["depformer_dim_feedforward"]),
        "max_period": lm.get("max_period", 10000.0),
        "n_text": lm["text_card"] + (1 if lm.get("existing_text_padding_id") is None else 0),
        "mimi_dim": mimi["dimension"], "n_filters": mimi["n_filters"],
        "ratios": tuple(mimi.get("ratios", (8, 6, 5, 4))),
        "mimi_layers": mimi["num_layers"], "mimi_heads": mimi.get("num_heads", 8),
        "mimi_ff": 2048 * mimi["dimension"] // 512, "mimi_context": mimi.get("context", 250),
        "q_dim": mimi["quantizer_dim"], "q_total": mimi["n_q_total"], "bins": mimi["bins"],
        "num_codebooks": mimi["num_codebooks"],
        # random codebooks at the scale of the random encoder's projected
        # latents, so that the codes follow the audio
        "codebook_std": cfg.get("init", {}).get("codebook_std", 1.0),
        "sample_rate": 24000, "frame_size": 1920,
    }
    out["hop"] = math.prod(out["ratios"])
    out["resample"] = out["frame_size"] // out["hop"]  # encoder steps a codec frame
    return out


def _conv(spec, name, cout, cin, k, groups=1):
    bound = 1.0 / math.sqrt(cin // groups * k)
    spec.append((f"{name}.weight", (cout, cin // groups, k), "float32", "uniform", bound))
    spec.append((f"{name}.bias", (cout,), "float32", "uniform", bound))


def _convtr(spec, name, cin, cout, k, groups=1, bias=True):
    bound = 1.0 / math.sqrt(cout // groups * k)
    spec.append((f"{name}.weight", (cin, cout // groups, k), "float32", "uniform", bound))
    if bias:
        spec.append((f"{name}.bias", (cout,), "float32", "uniform", bound))


def _resblock(spec, name, dim):
    _conv(spec, f"{name}.block.0", dim // 2, dim, 3)
    _conv(spec, f"{name}.block.1", dim, dim // 2, 1)


def mimi_spec(z: dict) -> list:
    spec: list = []
    nf, D, ratios = z["n_filters"], z["mimi_dim"], z["ratios"]
    # encoder: conv, then per ratio (reversed) a residual block and a strided conv
    i, mult = 0, 1
    _conv(spec, "mimi.encoder.layers.0", nf, 1, 7)
    for r in reversed(ratios):
        _resblock(spec, f"mimi.encoder.layers.{i + 1}", mult * nf)
        _conv(spec, f"mimi.encoder.layers.{i + 2}", 2 * mult * nf, mult * nf, 2 * r)
        i, mult = i + 2, mult * 2
    _conv(spec, f"mimi.encoder.layers.{i + 1}", D, mult * nf, 3)
    # decoder: conv, then per ratio a transposed conv and a residual block
    _conv(spec, "mimi.decoder.layers.0", mult * nf, D, 7)
    i = 0
    for r in ratios:
        _convtr(spec, f"mimi.decoder.layers.{i + 1}", mult * nf, mult * nf // 2, 2 * r)
        _resblock(spec, f"mimi.decoder.layers.{i + 2}", mult * nf // 2)
        i, mult = i + 2, mult // 2
    _conv(spec, f"mimi.decoder.layers.{i + 1}", 1, nf, 3)
    L, ff, b = z["mimi_layers"], z["mimi_ff"], 1.0 / math.sqrt(D)
    for side in ("encoder_transformer", "decoder_transformer"):
        p = f"mimi.{side}.transformer.layers"
        spec += [
            (f"{p}.in_proj", (L, 3 * D, D), "float32", "uniform", b),
            (f"{p}.out_proj", (L, D, D), "float32", "uniform", b),
            (f"{p}.linear1", (L, ff, D), "float32", "uniform", b),
            (f"{p}.linear2", (L, D, ff), "float32", "uniform", 1.0 / math.sqrt(ff)),
            (f"{p}.norm1.weight", (L, D), "float32", "ones", None),
            (f"{p}.norm1.bias", (L, D), "float32", "zeros", None),
            (f"{p}.norm2.weight", (L, D), "float32", "ones", None),
            (f"{p}.norm2.bias", (L, D), "float32", "zeros", None),
            (f"{p}.layer_scale_1.scale", (L, D), "float32", "const", 0.01),
            (f"{p}.layer_scale_2.scale", (L, D), "float32", "const", 0.01),
        ]
    qd, bins = z["q_dim"], z["bins"]
    for rvq, n in (("rvq_first", 1), ("rvq_rest", z["q_total"] - 1)):
        p = f"mimi.quantizer.{rvq}"
        spec += [
            (f"{p}.input_proj", (qd, D), "float32", "uniform", 1.0 / math.sqrt(D)),
            (f"{p}.output_proj", (D, qd), "float32", "uniform", 1.0 / math.sqrt(qd)),
            (f"{p}.layers.embedding_sum", (n, bins, qd), "float32", "normal",
             z["codebook_std"]),
            (f"{p}.layers.cluster_usage", (n, bins), "float32", "ones", None),
            (f"{p}.layers.initialized", (n,), "float32", "zeros", None),
        ]
    s = z["resample"]
    spec.append(("mimi.downsample.weight", (D, D, 2 * s), "float32", "uniform",
                 1.0 / math.sqrt(D * 2 * s)))
    # channel-wise (grouped) upsampler, upstream's upsample_channel_wise_bug
    spec.append(("mimi.upsample.weight", (D, 1, 2 * s), "float32", "uniform",
                 1.0 / math.sqrt(2 * s)))
    return spec


def lm_spec(z: dict, dtype: str) -> list:
    d, dd, L, Ld = z["dim"], z["dep_dim"], z["num_layers"], z["dep_layers"]
    H, Hd, S, card = z["hidden"], z["dep_hidden"], z["dep_q"], z["card"]
    b, bd = 1.0 / math.sqrt(d), 1.0 / math.sqrt(dd)
    return [
        ("lm.emb", (z["n_q"], card + 1, d), dtype, "normal", None),
        ("lm.text_emb", (z["text_card"] + 1, d), dtype, "normal", None),
        ("lm.depformer_in", (S, dd, d), dtype, "uniform", b),
        ("lm.depformer_emb", (S - 1, card + 1, dd), dtype, "normal", None),
        ("lm.depformer_text_emb", (z["text_card"] + 1, dd), dtype, "normal", None),
        ("lm.text_linear.weight", (z["n_text"], d), dtype, "uniform", b),
        ("lm.transformer.layers.in_proj", (L, 3 * d, d), dtype, "uniform", b),
        ("lm.transformer.layers.out_proj", (L, d, d), dtype, "uniform", b),
        ("lm.transformer.layers.norm1.alpha", (L, d), "float32", "ones", None),
        ("lm.transformer.layers.norm2.alpha", (L, d), "float32", "ones", None),
        ("lm.transformer.layers.gating.linear_in", (L, 2 * H, d), dtype, "uniform", b),
        ("lm.transformer.layers.gating.linear_out", (L, d, H), dtype, "uniform",
         1.0 / math.sqrt(H)),
        ("lm.out_norm.alpha", (d,), "float32", "ones", None),
        ("lm.depformer.layers.in_proj", (Ld, S * 3 * dd, dd), dtype, "uniform", bd),
        ("lm.depformer.layers.out_proj", (Ld, S * dd, dd), dtype, "uniform", bd),
        ("lm.depformer.layers.norm1.alpha", (Ld, dd), "float32", "ones", None),
        ("lm.depformer.layers.norm2.alpha", (Ld, dd), "float32", "ones", None),
        ("lm.depformer.layers.gating.linear_in", (Ld, S, 2 * Hd, dd), dtype, "uniform", bd),
        ("lm.depformer.layers.gating.linear_out", (Ld, S, dd, Hd), dtype, "uniform",
         1.0 / math.sqrt(Hd)),
        ("lm.linears.weight", (S, card, dd), dtype, "uniform", bd),
    ]


def spec(cfg: dict) -> list:
    """(name, shape, dtype, init, scale) of every weight of the configuration."""
    z = derived(cfg)
    return mimi_spec(z) + lm_spec(z, cfg["lm_dtype"])
