"""The per-step gated FFN of a depformer micro-step at batch B: the CUDA
kernel ``csrc/gating_ffn_step.cu`` (K2) and its plain PyTorch version
(counterpart of ``rstnet_tpu/ops/pallas_ffn.py::gating_ffn_pallas_step``).

``out = (silu(x Wg[s]^T) * (x Wv[s]^T)) Wo[s]^T`` with ``lin_in [S, 2H, C]``
(gate rows, then value rows) and ``lin_out [S, C, H]``, as the JAX call site
in ``StreamingTransformer._ffn`` feeds the Pallas kernel: the step index is
clamped to ``[0, S-1]``; the weights are taken in x's dtype (an exact
widening for bf16 weights and f32 x, a rounding to bf16 for f32 weights and
bf16 x), then x and the weights are widened to float32, the sums and the
hidden ``silu(gate) * val`` stay float32, and the output is cast to x's
dtype.

:func:`gating_ffn_step` launches the kernel on a CUDA tensor and runs
:func:`gating_ffn_step_reference` on a CPU tensor.
"""

from __future__ import annotations

import torch

from rstnet_tpu_torch.ops import cuda_lib
from rstnet_tpu_torch.ops.gating import get_activation

_DTYPES = (torch.float32, torch.bfloat16)


def _clamp_step(step: int, S: int) -> int:
    return min(max(int(step), 0), S - 1)


def gating_ffn_step_reference(x: torch.Tensor, lin_in: torch.Tensor, lin_out: torch.Tensor,
                              step: int, activation: str = "silu") -> torch.Tensor:
    """Plain PyTorch version: x [B, C], lin_in [S, 2H, C], lin_out [S, C, H]
    -> [B, C] in x's dtype."""
    s = _clamp_step(step, lin_in.shape[0])
    w_in = lin_in[s].to(x.dtype).float()
    w_out = lin_out[s].to(x.dtype).float()
    gate, val = (x.float() @ w_in.T).chunk(2, dim=-1)
    return ((get_activation(activation)(gate) * val) @ w_out.T).to(x.dtype)


def _check_cuda_operands(x, lin_in, lin_out, activation):
    if activation != "silu":
        raise NotImplementedError(f"the gating_ffn_step kernel computes silu, not {activation!r}")
    if x.dim() != 2 or lin_in.dim() != 3 or lin_out.dim() != 3:
        raise ValueError(f"shapes x {tuple(x.shape)}, lin_in {tuple(lin_in.shape)}, "
                         f"lin_out {tuple(lin_out.shape)}")
    B, C = x.shape
    S, H2, C2 = lin_in.shape
    H = H2 // 2
    if C2 != C or H2 % 2 or tuple(lin_out.shape) != (S, C, H):
        raise ValueError(f"shapes x {tuple(x.shape)}, lin_in {tuple(lin_in.shape)}, "
                         f"lin_out {tuple(lin_out.shape)}")
    if x.dtype not in _DTYPES or lin_in.dtype not in _DTYPES or lin_out.dtype != lin_in.dtype:
        raise TypeError(f"gating_ffn_step kernel takes float32 or bfloat16, got x {x.dtype}, "
                        f"lin_in {lin_in.dtype}, lin_out {lin_out.dtype}")
    if C % 8 or H % 8 or B < 1 or S < 1:
        raise ValueError(f"outside the kernel envelope: B={B}, C={C}, H={H}, S={S} "
                         "(C and H multiples of 8)")
    for name, t in (("x", x), ("lin_in", lin_in), ("lin_out", lin_out)):
        if t.device != x.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: must be a contiguous, 16-byte aligned tensor on {x.device}")


def gating_ffn_step(x: torch.Tensor, lin_in: torch.Tensor, lin_out: torch.Tensor, step: int,
                    activation: str = "silu") -> torch.Tensor:
    """Fused per-step gated FFN: x [B, C] (float32 or bf16), lin_in
    [S, 2H, C], lin_out [S, C, H] (float32 or bf16), step an int -> [B, C]
    in x's dtype. Launches the kernel on a CUDA tensor (or raises), runs the
    plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return gating_ffn_step_reference(x, lin_in, lin_out, step, activation)
    if x.device.type != "cuda":
        raise NotImplementedError(f"gating_ffn_step has no kernel for {x.device}")
    _check_cuda_operands(x, lin_in, lin_out, activation)
    B, C = x.shape
    H = lin_in.shape[1] // 2
    s = _clamp_step(step, lin_in.shape[0])
    w_in, w_out = lin_in[s], lin_out[s]  # views of the step's slice: no copy
    if x.dtype == torch.bfloat16 and w_in.dtype == torch.float32:
        # the JAX call site takes the weights in x's dtype
        w_in, w_out = w_in.to(torch.bfloat16), w_out.to(torch.bfloat16)
    hid = torch.empty((B, H), dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        status = cuda_lib.kernel_library().gating_ffn_step(
            x.data_ptr(), w_in.data_ptr(), w_out.data_ptr(), hid.data_ptr(), out.data_ptr(),
            B, C, H, int(x.dtype == torch.bfloat16), int(w_in.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    cuda_lib.check(status, "gating_ffn_step")
    gating_ffn_step.launches += 1
    return out


gating_ffn_step.launches = 0  # kernel launches; reset freely by callers
