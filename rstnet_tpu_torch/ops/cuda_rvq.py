"""Residual-VQ encode: the CUDA kernel ``csrc/rvq_encode.cu`` and its plain
PyTorch version (counterpart of ``rstnet_tpu/ops/pallas_rvq.py``).

The JAX package's Mimi encode runs the jnp level sweep
(``quantization/codebook.py`` via ``quantization/rvq.py``); the port runs the
whole sweep as one :func:`rvq_encode` call, which on a CUDA tensor launches
the kernel and on a CPU tensor runs :func:`rvq_encode_reference`. Both keep
the math of ``rvq_encode_pallas``: ``||e||^2 - 2 r.e`` in float32, argmin
with the first index winning ties, gather, subtract.
"""

from __future__ import annotations

import torch

from rstnet_tpu_torch.ops import cuda_lib

MAX_DIM = 512  # shared-memory tile limit of the kernel


def rvq_encode_reference(x: torch.Tensor, codebooks: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """x [N, D], codebooks [Q, K, D] -> (codes [N, Q] int32, quantized sum
    [N, D] in x's dtype)."""
    residual = x.float()
    total = torch.zeros_like(residual)
    codes = []
    for q in range(codebooks.shape[0]):
        emb = codebooks[q].float()
        dist = emb.square().sum(1)[None] - 2.0 * (residual @ emb.T)
        idx = torch.argmin(dist, dim=1)
        quant = emb[idx]
        codes.append(idx.to(torch.int32))
        residual = residual - quant
        total = total + quant
    return torch.stack(codes, -1), total.to(x.dtype)


def rvq_encode(x: torch.Tensor, codebooks: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Residual-VQ encode over all levels in one call: the CUDA kernel on a
    CUDA tensor (float32, D % 4 == 0, D <= 512), the plain version on a CPU
    tensor. Raises for anything else."""
    if x.device.type == "cpu":
        return rvq_encode_reference(x, codebooks)
    if x.device.type != "cuda":
        raise NotImplementedError(f"rvq_encode has no kernel for {x.device}")
    if x.dim() != 2 or codebooks.dim() != 3 or codebooks.shape[2] != x.shape[1]:
        raise ValueError(f"shapes x {tuple(x.shape)}, codebooks {tuple(codebooks.shape)}")
    N, D = x.shape
    Q, K, _ = codebooks.shape
    if x.dtype != torch.float32 or codebooks.dtype != torch.float32:
        raise TypeError(f"rvq_encode kernel takes float32, got {x.dtype}, {codebooks.dtype}")
    if codebooks.device != x.device:
        raise ValueError("x and codebooks on different devices")
    if D % 4 or D > MAX_DIM or Q < 1 or K < 1:
        raise ValueError(f"rvq_encode kernel needs D % 4 == 0, D <= {MAX_DIM}, Q, K >= 1")
    for t in (x, codebooks):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("rvq_encode kernel needs contiguous, 16-byte aligned inputs")
    codes = torch.empty((N, Q), dtype=torch.int32, device=x.device)
    quant = torch.empty((N, D), dtype=torch.float32, device=x.device)
    if N == 0:
        return codes, quant
    lib = cuda_lib.kernel_library()
    scratch = torch.empty(lib.rvq_encode_scratch_floats(N, D, Q, K), dtype=torch.float32,
                          device=x.device)
    with torch.cuda.device(x.device):
        status = lib.rvq_encode(
            x.data_ptr(), codebooks.data_ptr(), codes.data_ptr(), quant.data_ptr(),
            scratch.data_ptr(), N, D, Q, K, torch.cuda.current_stream().cuda_stream)
    cuda_lib.check(status, "rvq_encode")
    rvq_encode.launches += 1
    return codes, quant


rvq_encode.launches = 0  # kernel launches; reset freely by callers
