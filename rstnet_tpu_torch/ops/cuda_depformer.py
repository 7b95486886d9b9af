"""One depformer micro-step at batch 1: the CUDA kernel
``csrc/depformer_step.cu`` and its plain PyTorch version (counterpart of
``rstnet_tpu/ops/pallas_depformer.py``, bf16 variant).

The micro-step runs every layer of the depth transformer for codebook ``cb``
and then that codebook's audio head. Semantics match
``StreamingTransformer.step`` with ``weights_per_step``, no positional
embedding, RMS norms and SiLU gating, followed by the head of
``step_codecformer``. GEMV inputs are bf16 with float32 accumulation; norms,
softmax and the residual stream are float32. The per-frame cache ``kc``/
``vc`` is ``[L, S, C]``, position-major; both versions write row ``cb`` in
place and take the new row in float32 for this step's attention, as the
Pallas kernel does.

:func:`depformer_step` launches the kernel on a CUDA tensor and runs
:func:`depformer_step_reference` on a CPU tensor. The int8 variant of the
TPU kernel is not ported yet.
"""

from __future__ import annotations

import torch

from rstnet_tpu_torch.ops import cuda_lib

MAX_DIM = 8192  # largest C or H the kernel stages in shared memory
MAX_STEPS = 32


def _rms(x: torch.Tensor, alpha: torch.Tensor, eps: float) -> torch.Tensor:
    var = eps + x.square().mean(-1, keepdim=True)
    return x * (alpha * torch.rsqrt(var))


def _dot_t(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a [B, in] @ w [out, in]^T with bf16 inputs and float32 accumulation."""
    return a.to(torch.bfloat16).float() @ w.to(torch.bfloat16).float().T


def depformer_step_reference(x, cb: int, norm1, in_proj, out_proj, norm2, gin, gout, head_w,
                             head_b, kc, vc, heads: int, eps: float = 1e-8):
    """Plain PyTorch micro-step. Shapes as :func:`depformer_step`; weights
    of any float dtype are rounded to bf16 as the kernel reads them.
    Returns (logits [1, card] float32, kc, vc) with row ``cb`` written."""
    L, S, C = kc.shape
    H = gout.shape[3]
    dh = C // heads
    xs = x.float()
    for l in range(L):
        h = _rms(xs, norm1[l].float(), eps)
        qkv = _dot_t(h, in_proj[l].reshape(S, 3 * C, C)[cb])
        q, k_new, v_new = qkv[:, :C], qkv[:, C : 2 * C], qkv[:, 2 * C :]
        kc[l, cb] = k_new[0].to(kc.dtype)
        vc[l, cb] = v_new[0].to(vc.dtype)
        kf, vf = kc[l, : cb + 1].float(), vc[l, : cb + 1].float()
        kf[cb], vf[cb] = k_new[0], v_new[0]
        scores = (kf.reshape(cb + 1, heads, dh) * q.reshape(1, heads, dh)).sum(-1) / dh**0.5
        p = torch.softmax(scores, dim=0)  # [cb+1, heads]: positions > cb never enter
        attn = (p[:, :, None] * vf.reshape(cb + 1, heads, dh)).sum(0).reshape(1, C)
        xs = xs + _dot_t(attn, out_proj[l].reshape(S, C, C)[cb])
        gate, val = _dot_t(_rms(xs, norm2[l].float(), eps), gin[l, cb]).split(H, dim=-1)
        xs = xs + _dot_t(gate * torch.sigmoid(gate) * val, gout[l, cb])
    logits = _dot_t(xs, head_w[cb]) + head_b[cb].float()[None]
    return logits, kc, vc


def _check_cuda_operands(x, cb, norm1, in_proj, out_proj, norm2, gin, gout, head_w, head_b,
                         kc, vc, heads):
    L, S, C = kc.shape
    H, card = gout.shape[-1], head_w.shape[1]
    expected = {
        "x": (x, (1, C), torch.bfloat16),
        "norm1": (norm1, (L, C), torch.float32),
        "in_proj": (in_proj, (L, S * 3 * C, C), torch.bfloat16),
        "out_proj": (out_proj, (L, S * C, C), torch.bfloat16),
        "norm2": (norm2, (L, C), torch.float32),
        "gin": (gin, (L, S, 2 * H, C), torch.bfloat16),
        "gout": (gout, (L, S, C, H), torch.bfloat16),
        "head_w": (head_w, (S, card, C), torch.bfloat16),
        "head_b": (head_b, (S, card), torch.float32),
        "vc": (vc, (L, S, C), kc.dtype),
    }
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
    if C > MAX_DIM or H > MAX_DIM or S > MAX_STEPS:
        raise ValueError(f"C, H <= {MAX_DIM} and S <= {MAX_STEPS}: got {C}, {H}, {S}")
    if not 0 <= cb < S:
        raise ValueError(f"micro-step {cb} outside [0, {S})")


def depformer_step(x, cb: int, norm1, in_proj, out_proj, norm2, gin, gout, head_w, head_b,
                   kc, vc, heads: int, eps: float = 1e-8):
    """One fused depformer micro-step, batch 1.

    x [1, C] bf16 (dep_in + previous-token embedding); cb: micro-step index;
    norm1/norm2 [L, C] f32; in_proj [L, S*3C, C]; out_proj [L, S*C, C];
    gin [L, S, 2H, C]; gout [L, S, C, H]; head_w [S, card, C] (bf16 on the
    card); head_b [S, card] f32; kc/vc [L, S, C] (f32 or bf16), written at
    row cb in place. Returns (logits [1, card] f32, kc, vc).

    On a CUDA tensor it launches the kernel or raises; on a CPU tensor it
    runs :func:`depformer_step_reference`."""
    args = (x, cb, norm1, in_proj, out_proj, norm2, gin, gout, head_w, head_b, kc, vc, heads)
    if x.device.type == "cpu":
        return depformer_step_reference(*args, eps=eps)
    if x.device.type != "cuda":
        raise NotImplementedError(f"depformer_step has no kernel for {x.device}")
    _check_cuda_operands(*args)
    L, S, C = kc.shape
    H, card = gout.shape[-1], head_w.shape[1]
    f32 = dict(dtype=torch.float32, device=x.device)
    logits = torch.empty((1, card), **f32)
    scratch = [torch.empty(n, **f32) for n in (C, 3 * C, C, H)]  # xs, qkv, attn, hid
    ptrs = [t.data_ptr() for t in (x, norm1, in_proj, out_proj, norm2, gin, gout, head_w,
                                   head_b, kc, vc, logits, *scratch)]
    with torch.cuda.device(x.device):
        status = cuda_lib.kernel_library().depformer_step(
            *ptrs, L, S, C, H, card, heads, cb, int(kc.dtype == torch.bfloat16), eps,
            torch.cuda.current_stream().cuda_stream)
    cuda_lib.check(status, "depformer_step")
    depformer_step.launches += 1
    return logits, kc, vc


depformer_step.launches = 0  # kernel launches; reset freely by callers


def depformer_kernel_operands(model) -> dict | None:
    """The kernel's operands from a ``MoshiLMModel``'s depformer and heads,
    or None when the configuration is outside the kernel's envelope (no
    per-step weights, a positional embedding, non-RMS norm, non-SiLU gating,
    misaligned dims); callers then keep the ``step_codecformer`` path."""
    tf = model.depformer
    if not tf.weights_per_step or tf.positional_embedding != "none":
        return None
    if not tf.norm.startswith("rms_norm") or tf.gating != "silu":
        return None
    layers = tf.layers
    C, S = tf.d_model, tf.weights_per_step
    H = layers.gating.linear_in.shape[-2] // 2
    head_w = model.linears.weight
    card = head_w.shape[-2]
    if C % 128 or H % 128 or card % 128 or (C // tf.num_heads) % 8:
        return None
    head_b = model.linears._parameters.get("bias")
    head_b = (torch.zeros((S, card), device=head_w.device) if head_b is None
              else head_b.float())
    return {
        "norm1": layers.norm1.alpha.float(),
        "in_proj": layers.in_proj,
        "out_proj": layers.out_proj,
        "norm2": layers.norm2.alpha.float(),
        "gin": layers.gating.linear_in,
        "gout": layers.gating.linear_out,
        "head_w": head_w,
        "head_b": head_b,
        "heads": tf.num_heads,
        "eps": tf.norm_eps,
        "L": tf.num_layers,
        "S": S,
        "C": C,
    }
