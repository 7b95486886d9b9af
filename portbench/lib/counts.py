"""Operations and bytes of the serving step and of its kernels, from the
configuration's shapes, and the card's peaks.

Each byte a call must read or write is counted once, in the dtype it is
stored in: weights once per step whatever
the batch, a ring's keys and values only at the positions a session holds.
Operations are 2 per multiply-add. A bound is the larger of bytes over the
HBM rate and operations over the peak of the unit that does them.
"""

from __future__ import annotations

# NVIDIA H100 SXM (data sheet, dense, 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "tf32": 495e12, "f32": 67e12}

BYTES = {"float32": 4, "bfloat16": 2, "int8": 1}


def bound_s(nbytes: float, flops: float, unit: str) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[unit])


def _matrix_bytes(n: int, rows: int, int8: bool, dtype: str) -> float:
    """A weight of ``n`` elements and ``rows`` output rows: int8 codes and a
    float32 scale a row, or ``dtype``."""
    return n + 4 * rows if int8 else n * BYTES[dtype]


# -- kernels ---------------------------------------------------------------

def k1_call(z: dict, cb: int, int8: bool, cache_dtype: str, weight_dtype: str) -> tuple:
    """(bytes, flops) of one depformer micro-step (K1 / K1-int8) for codebook
    ``cb`` at batch 1: the step's weights in every layer and its head, the
    norms, the keys and values of steps 0..cb read and step cb's written,
    the input row and the logits."""
    C, Hd, L, card = z["dep_dim"], z["dep_hidden"], z["dep_layers"], z["card"]
    mats = [(3 * C * C, 3 * C), (C * C, C), (2 * Hd * C, 2 * Hd), (C * Hd, C)]
    w = L * sum(_matrix_bytes(n, r, int8, weight_dtype) for n, r in mats)
    w += _matrix_bytes(card * C, card, int8, weight_dtype)
    norms = 2 * L * C * 4
    kv = L * 2 * C * (cb + 1 + 1) * BYTES[cache_dtype]
    io = C * 2 + card * 4
    flops = 2 * (L * sum(n for n, _ in mats) + card * C) + L * 4 * C * (cb + 1)
    return w + norms + kv + io, flops


def k2_call(z: dict, rows: int, x_dtype: str, weight_dtype: str) -> tuple:
    """(bytes, flops) of one K2 call: one layer's one step of the depformer
    FFN over ``rows`` rows (gate/value and down weights, input and output)."""
    C, Hd = z["dep_dim"], z["dep_hidden"]
    w = 3 * Hd * C * BYTES[weight_dtype]
    io = 2 * rows * C * BYTES[x_dtype]
    return w + io, 2 * rows * 3 * Hd * C


def k3_call(z: dict, rows: int, levels: int) -> tuple:
    """(bytes, flops) of one residual-VQ encode over ``rows`` rows and
    ``levels`` levels: input rows, the levels' centroids (float32), codes and
    the quantized sum out; a distance is a multiply-add per element."""
    D, K = z["q_dim"], z["bins"]
    nbytes = rows * D * 4 + levels * K * D * 4 + rows * levels * 4 + rows * D * 4
    return nbytes, 2 * rows * levels * K * D


def k3_unit(rows: int) -> str:
    """The split path (up to 64 rows) runs float32 CUDA cores; the tiled path
    three TF32 products a product (counted as TF32 operations)."""
    return "f32" if rows <= 64 else "tf32"


# -- the whole step ----------------------------------------------------------

def _conv_macs(z: dict) -> int:
    """Multiply-adds of Mimi's SEANet encoder and decoder for one 80 ms frame."""
    nf, D, ratios = z["n_filters"], z["mimi_dim"], z["ratios"]
    n = z["frame_size"]
    macs, mult, t = 0, 1, n
    macs += t * nf * 7
    for r in reversed(ratios):
        c = mult * nf
        macs += t * (c // 2 * c * 3 + c * (c // 2))  # residual block
        t //= r
        macs += t * (2 * c) * c * 2 * r  # strided conv
        mult *= 2
    macs += t * D * (mult * nf) * 3
    enc = macs
    # decoder mirrors it: conv, then transposed conv + residual block per ratio
    dec, c = t * (mult * nf) * D * 7, mult * nf
    for r in ratios:
        dec += t * c * (c // 2) * 2 * r  # transposed conv: input samples x out x k
        t *= r
        h = c // 2
        dec += t * (h // 2 * h * 3 + h * (h // 2))
        c = h
    dec += t * 1 * nf * 3
    return enc + dec


def step(z: dict, cfg: dict, sessions: int, positions: int, ring_bytes: float) -> tuple:
    """(bytes, flops) of one serving step of ``sessions`` sessions that each
    hold ``positions`` frames, the one the step writes included: every
    weight once in its stored dtype, the rows it touches, and the rings at
    the held positions (at most the context). ``ring_bytes``: what the
    program's backbone ring stores for one position of one session in one
    layer, keys, values and any scales."""
    B = sessions
    int8 = "--int8" in cfg["server_flags"]
    dt = cfg["lm_dtype"]
    d, L, H = z["dim"], z["num_layers"], z["hidden"]
    C, Ld, Hd, S, card = z["dep_dim"], z["dep_layers"], z["dep_hidden"], z["dep_q"], z["card"]
    back = [(3 * d * d, 3 * d), (d * d, d), (2 * H * d, 2 * H), (d * H, d)]
    dep = [(3 * C * C, 3 * C), (C * C, C), (2 * Hd * C, 2 * Hd), (C * Hd, C)]
    nbytes = L * sum(_matrix_bytes(n, r, int8, dt) for n, r in back)
    nbytes += S * Ld * sum(_matrix_bytes(n, r, int8, dt) for n, r in dep)
    nbytes += _matrix_bytes(S * C * d, S * C, int8, dt) + _matrix_bytes(S * card * C, S * card,
                                                                       int8, dt)
    nbytes += z["n_text"] * d * BYTES[dt]  # the text head stays in the stored dtype
    nbytes += (2 * L + 1) * d * 4 + 2 * Ld * C * 4  # norms
    nbytes += B * ((z["n_q"] + 1) * d + S * C) * BYTES[dt]  # embedding rows
    lm_matmul = L * sum(n for n, _ in back) + S * Ld * sum(n for n, _ in dep) \
        + S * C * d + S * card * C + z["n_text"] * d
    flops = 2 * B * lm_matmul
    # backbone ring at the held positions
    held = min(positions, z["context"])
    nbytes += B * L * ring_bytes * held
    flops += B * L * 4 * d * held
    # Mimi: weights once (float32), the transformers' rings, convs, quantizer
    D, Lm, ff, s = z["mimi_dim"], z["mimi_layers"], z["mimi_ff"], z["resample"]
    tr = 2 * Lm * (3 * D * D + D * D + 2 * ff * D)
    n_q, qd, bins = z["num_codebooks"], z["q_dim"], z["bins"]
    macs = _conv_macs(z)
    conv_w = _seanet_weights(z)
    nbytes += 4 * (tr + conv_w + D * D * 2 * s + D * 2 * s + 4 * qd * D + n_q * bins * qd)
    held = min(s * positions, z["mimi_context"])
    nbytes += B * 2 * Lm * 2 * D * held * 4
    flops += B * (2 * macs + 2 * s * tr + 2 * s * 2 * Lm * 2 * D * held
                  + 2 * (D * D * 2 * s + D * 2 * s) + 2 * 4 * qd * D + 2 * n_q * bins * qd)
    return nbytes, flops


def _seanet_weights(z: dict) -> int:
    """Elements of the SEANet encoder's and decoder's weights and biases."""
    from portbench.reference.layout import mimi_spec

    return sum(_numel(shape) for name, shape, *_ in mimi_spec(z)
               if name.startswith(("mimi.encoder.", "mimi.decoder.")))


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n
