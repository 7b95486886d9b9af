"""One depformer micro-step at batch 1: the CUDA kernel
``csrc/depformer_step.cu`` and its plain PyTorch version (counterpart of
``rstnet_tpu/ops/pallas_depformer.py``, bf16 and int8 variants).

The micro-step runs every layer of the depth transformer for codebook ``cb``
and then that codebook's audio head. Semantics match
``StreamingTransformer.step`` with ``weights_per_step``, no positional
embedding, RMS norms and SiLU gating, followed by the head of
``step_codecformer``. GEMV inputs are bf16 with float32 accumulation; norms,
softmax and the residual stream are float32. The per-frame cache ``kc``/
``vc`` is ``[L, S, C]``, position-major; both versions write row ``cb`` in
place and take the new row in float32 for this step's attention, as the
Pallas kernel does.

int8 variant (``scales`` given, int8 serving): the five weight stacks are
int8 with a float32 scale per output row, and each weight element is
dequantized as ``bf16(float(q) * scale[row])`` before the bf16 GEMV, the
Pallas kernel's ``wload`` rounding.

:func:`depformer_step` launches the kernel on a CUDA tensor and runs
:func:`depformer_step_reference` on a CPU tensor. It counts bf16 launches in
``depformer_step.launches`` and int8 launches in
``depformer_step.launches_int8``. On the card a micro-step is one cooperative
launch of one block per SM; where the grid cannot be co-resident the launch
fails and the wrapper raises (there is no other route). The kernel keeps a
small scratch per device and stream (its launch count and its tagged
activations), zeroed once: a launch resets nothing, so it can be captured in
a CUDA graph.
"""

from __future__ import annotations

import torch

from rstnet_tpu_torch.modules.transformer import is_int8
from rstnet_tpu_torch.ops import cuda_lib

MAX_DIM = 8192  # largest C or H the kernel stages in shared memory
MAX_STEPS = 32  # one warp lane per cache row in the kernel's softmax
MAX_LAYERS = 63  # the kernel's activation tags name (launch, phase): 4L + 1 < 256
WEIGHTS = ("in_proj", "out_proj", "gin", "gout", "head_w")  # the stacks int8 serving quantizes


def _rms(x: torch.Tensor, alpha: torch.Tensor, eps: float) -> torch.Tensor:
    var = eps + x.square().mean(-1, keepdim=True)
    return x * (alpha * torch.rsqrt(var))


def _dot_t(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a [B, in] @ w [out, in]^T with bf16 inputs and float32 accumulation."""
    return a.to(torch.bfloat16).float() @ w.to(torch.bfloat16).float().T


def _wload(w: torch.Tensor, scale: torch.Tensor | None) -> torch.Tensor:
    """A weight block as the kernel reads it: bf16, or int8 rows times their
    float32 scales ``[rows, 1]`` rounded to bf16 (the Pallas ``wload``)."""
    if scale is None:
        return w.to(torch.bfloat16)
    return (w.float() * scale.float()).to(torch.bfloat16)


def depformer_step_reference(x, cb: int, norm1, in_proj, out_proj, norm2, gin, gout, head_w,
                             head_b, kc, vc, heads: int, eps: float = 1e-8, scales=None):
    """Plain PyTorch micro-step. Shapes as :func:`depformer_step`; weights
    of any float dtype are rounded to bf16 as the kernel reads them, int8
    weights dequantized with ``scales`` as the kernel does.
    Returns (logits [1, card] float32, kc, vc) with row ``cb`` written."""
    L, S, C = kc.shape
    H = gout.shape[3]
    dh = C // heads
    sc = scales or {}
    s_in, s_out, s_gin, s_gout, s_head = (sc.get(k) for k in WEIGHTS)

    def block(w, s, *idx):  # the (layer, step) weight block and its row scales
        return _wload(w[idx], None if s is None else s[idx])

    in_proj = in_proj.reshape(L, S, 3 * C, C)
    out_proj = out_proj.reshape(L, S, C, C)
    if s_in is not None:
        s_in, s_out = s_in.reshape(L, S, 3 * C, 1), s_out.reshape(L, S, C, 1)
    xs = x.float()
    for l in range(L):
        h = _rms(xs, norm1[l].float(), eps)
        qkv = _dot_t(h, block(in_proj, s_in, l, cb))
        q, k_new, v_new = qkv[:, :C], qkv[:, C : 2 * C], qkv[:, 2 * C :]
        kc[l, cb] = k_new[0].to(kc.dtype)
        vc[l, cb] = v_new[0].to(vc.dtype)
        kf, vf = kc[l, : cb + 1].float(), vc[l, : cb + 1].float()
        kf[cb], vf[cb] = k_new[0], v_new[0]
        scores = (kf.reshape(cb + 1, heads, dh) * q.reshape(1, heads, dh)).sum(-1) / dh**0.5
        p = torch.softmax(scores, dim=0)  # [cb+1, heads]: positions > cb never enter
        attn = (p[:, :, None] * vf.reshape(cb + 1, heads, dh)).sum(0).reshape(1, C)
        xs = xs + _dot_t(attn, block(out_proj, s_out, l, cb))
        gate, val = _dot_t(_rms(xs, norm2[l].float(), eps), block(gin, s_gin, l, cb)).split(
            H, dim=-1)
        xs = xs + _dot_t(gate * torch.sigmoid(gate) * val, block(gout, s_gout, l, cb))
    logits = _dot_t(xs, block(head_w, s_head, cb)) + head_b[cb].float()[None]
    return logits, kc, vc


def _check_cuda_operands(x, cb, norm1, in_proj, out_proj, norm2, gin, gout, head_w, head_b,
                         kc, vc, heads, scales=None):
    """The kernel's envelope: exact shapes and dtypes (bf16 weights, or int8
    weights with float32 scales ``[..., rows, 1]``), every operand
    contiguous and 16-byte aligned on x's device, and the dims below."""
    L, S, C = kc.shape
    H, card = gout.shape[-1], head_w.shape[1]
    wt = torch.bfloat16 if scales is None else torch.int8
    expected = {
        "x": (x, (1, C), torch.bfloat16),
        "norm1": (norm1, (L, C), torch.float32),
        "in_proj": (in_proj, (L, S * 3 * C, C), wt),
        "out_proj": (out_proj, (L, S * C, C), wt),
        "norm2": (norm2, (L, C), torch.float32),
        "gin": (gin, (L, S, 2 * H, C), wt),
        "gout": (gout, (L, S, C, H), wt),
        "head_w": (head_w, (S, card, C), wt),
        "head_b": (head_b, (S, card), torch.float32),
        "vc": (vc, (L, S, C), kc.dtype),
    }
    if scales is not None:
        if set(scales) != set(WEIGHTS):
            raise ValueError(f"scales for {sorted(scales)}, expected {sorted(WEIGHTS)}")
        for name in WEIGHTS:  # one scale per weight row
            rows = expected[name][1][:-1]
            expected[f"{name} scale"] = (scales[name], (*rows, 1), torch.float32)
    if kc.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"depformer kernel caches are float32 or bfloat16, got {kc.dtype}")
    for name, (t, shape, dtype) in expected.items():
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name}: expected {dtype}{shape}, got {t.dtype}{tuple(t.shape)}")
    for name, t in {**{k: v[0] for k, v in expected.items()}, "kc": kc}.items():
        if t.device != x.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: must be a contiguous, 16-byte aligned tensor on {x.device}")
    if C % 128 or H % 128 or card % 128 or C % heads or (C // heads) % 8:
        raise ValueError(f"outside the kernel envelope: C={C}, H={H}, card={card}, heads={heads}")
    if C > MAX_DIM or H > MAX_DIM or S > MAX_STEPS or L > MAX_LAYERS:
        raise ValueError(f"C, H <= {MAX_DIM}, S <= {MAX_STEPS} and L <= {MAX_LAYERS}: got "
                         f"{C}, {H}, {S}, {L}")
    if not 0 <= cb < S:
        raise ValueError(f"micro-step {cb} outside [0, {S})")


def depformer_step(x, cb: int, norm1, in_proj, out_proj, norm2, gin, gout, head_w, head_b,
                   kc, vc, heads: int, eps: float = 1e-8, scales: dict | None = None):
    """One fused depformer micro-step, batch 1.

    x [1, C] bf16 (dep_in + previous-token embedding); cb: micro-step index;
    norm1/norm2 [L, C] f32; in_proj [L, S*3C, C]; out_proj [L, S*C, C];
    gin [L, S, 2H, C]; gout [L, S, C, H]; head_w [S, card, C] (bf16 on the
    card); head_b [S, card] f32; kc/vc [L, S, C] (f32 or bf16), written at
    row cb in place. Returns (logits [1, card] f32, kc, vc).

    ``scales`` (int8 variant): the five weights are int8 and ``scales`` maps
    each of their names to float32 per-row scales shaped like the weight
    with its last axis 1 (in_proj [L, S*3C, 1], ..., head_w [S, card, 1]).

    On a CUDA tensor it launches the kernel or raises; on a CPU tensor it
    runs :func:`depformer_step_reference`."""
    args = (x, cb, norm1, in_proj, out_proj, norm2, gin, gout, head_w, head_b, kc, vc, heads)
    if x.device.type == "cpu":
        return depformer_step_reference(*args, eps=eps, scales=scales)
    if x.device.type != "cuda":
        raise NotImplementedError(f"depformer_step has no kernel for {x.device}")
    _check_cuda_operands(*args, scales=scales)
    L, S, C = kc.shape
    H, card = gout.shape[-1], head_w.shape[1]
    logits = torch.empty((1, card), dtype=torch.float32, device=x.device)
    dims = (L, S, C, H, card, heads, cb, int(kc.dtype == torch.bfloat16), eps)
    lib = cuda_lib.kernel_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = [t.data_ptr() for t in (x, norm1, in_proj, out_proj, norm2, gin, gout, head_w,
                                       head_b, kc, vc, logits, _scratch(x.device, stream, C, H))]
        if scales is None:
            status = lib.depformer_step(*ptrs, *dims, stream)
        else:
            status = lib.depformer_step_int8(*ptrs, *(scales[k].data_ptr() for k in WEIGHTS),
                                             *dims, stream)
    cuda_lib.check(status, "depformer_step" if scales is None else "depformer_step_int8")
    if scales is None:
        depformer_step.launches += 1
    else:
        depformer_step.launches_int8 += 1
    return logits, kc, vc


# kernel launches, bf16 and int8 variants; reset freely by callers
depformer_step.launches = 0
depformer_step.launches_int8 = 0

_SCRATCH: dict = {}


def _scratch(device: torch.device, stream: int, C: int, H: int) -> torch.Tensor:
    """The kernel's scratch for this device and stream: the launch count,
    then the tagged activations (16 + 4C + H 64-bit words). Zeroed once here
    (a zero tag never matches), then left to the kernel, so a launch needs no
    reset and stays capturable in a CUDA graph. One per stream, since two
    launches in flight must not share it."""
    key, n = (device, stream), 16 + 4 * C + H
    if key not in _SCRATCH or _SCRATCH[key].numel() < n:
        _SCRATCH[key] = torch.zeros(n, dtype=torch.int64, device=device)
    return _SCRATCH[key]


def bf16_rounding(w: torch.Tensor) -> torch.Tensor:
    """``w`` as K1 reads it: ``w`` itself when bf16; for another float dtype
    its bf16 rounding (the Pallas ``wload``'s ``astype(bf16)``), taken once
    and kept on the tensor until the tensor is written in place (its
    ``_version``) or its storage changes. A converted checkpoint is float32,
    and a frame then reads the copy instead of casting every stack anew."""
    if w.dtype == torch.bfloat16:
        return w
    key = (w.data_ptr(), w._version)
    cached = getattr(w, "_bf16_rounding", None)
    if cached is None or cached[0] != key:
        with torch.no_grad():
            cached = (key, w.detach().to(torch.bfloat16).contiguous())
        w._bf16_rounding = cached
    return cached[1]


def depformer_kernel_operands(model) -> dict | None:
    """The kernel's operands from a model's depth transformer and heads: a
    ``SpeechTextLM``'s ``codecformer`` and ``audio_linears`` or a
    ``MoshiLMModel``'s ``depformer`` and ``linears``; or None when the
    configuration is outside the kernel's envelope (no
    per-step weights, a positional embedding, non-RMS norm, non-SiLU gating,
    misaligned dims, some but not all five weight stacks int8); callers then
    keep the ``step_codecformer`` path. When all five are int8 the operands
    are their codes and ``scales`` their float32 row scales ``[..., rows,
    1]``; otherwise ``scales`` is None. Cheap (views of the weights), so
    callers take it afresh at every frame and follow in-place changes.
    Float weights of another dtype than bf16 (a converted float32
    checkpoint) come as their bf16 rounding (:func:`bf16_rounding`), which
    is what K1 and its plain version compute with."""
    if hasattr(model, "codecformer"):
        tf, head = model.codecformer, model.audio_linears
    else:
        tf, head = model.depformer, model.linears
    if not tf.weights_per_step or tf.positional_embedding != "none":
        return None
    if not tf.norm.startswith("rms_norm") or tf.gating != "silu":
        return None
    layers = tf.layers
    weights = dict(zip(WEIGHTS, (layers.in_proj, layers.out_proj, layers.gating.linear_in,
                                 layers.gating.linear_out, head.weight)))
    n_int8 = sum(is_int8(w) for w in weights.values())
    scales = None
    if n_int8 == len(weights):
        scales = {k: w.scale.float()[..., None] for k, w in weights.items()}
        weights = {k: w.w_int8 for k, w in weights.items()}
    elif n_int8:  # mixed quantization: keep the step_codecformer path
        return None
    else:
        weights = {k: bf16_rounding(w) for k, w in weights.items()}
    C, S = tf.d_model, tf.weights_per_step
    H = weights["gin"].shape[-2] // 2
    card = weights["head_w"].shape[-2]
    if C % 128 or H % 128 or card % 128 or (C // tf.num_heads) % 8:
        return None
    head_b = head._parameters.get("bias")
    head_b = (torch.zeros((S, card), device=weights["head_w"].device) if head_b is None
              else head_b.float())
    return {
        "norm1": layers.norm1.alpha.float(),
        "norm2": layers.norm2.alpha.float(),
        "head_b": head_b,
        "scales": scales,
        "heads": tf.num_heads,
        "eps": tf.norm_eps,
        "L": tf.num_layers,
        "S": S,
        "C": C,
        **weights,
    }
