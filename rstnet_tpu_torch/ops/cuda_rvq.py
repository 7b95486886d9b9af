"""Residual-VQ encode: the CUDA kernel ``csrc/rvq_encode.cu`` and its plain
PyTorch version (counterpart of ``rstnet_tpu/ops/pallas_rvq.py``).

The JAX package's Mimi encode runs the jnp level sweep
(``quantization/codebook.py`` via ``quantization/rvq.py``); the port runs the
whole sweep as one :func:`rvq_encode` call, which on a CUDA tensor launches
the kernel and on a CPU tensor runs :func:`rvq_encode_reference`. Both keep
the math of ``rvq_encode_pallas``: ``||e||^2 - 2 r.e`` in float32, argmin
with the first index winning ties, gather, subtract.

On the card a call up to :data:`SPLIT_MAX_ROWS` rows is one cooperative
launch (the split path: the codewords split over the SMs, merged between
levels through a small scratch that this module keeps per device and stream,
initialized once); a larger call takes the tiled path (tensor cores, 3xTF32),
two launches. A shape the kernel cannot take, or a refused launch, raises:
there is no other route on the card.
"""

from __future__ import annotations

import torch

from rstnet_tpu_torch.ops import cuda_lib

MAX_DIM = 512  # shared-memory row limit of both paths
# The kernel's split path takes up to 64 rows, the tiled path any number.
# The paths do not cross within the split path's range: at Mimi's shapes
# (D=256, K=2048) the split path took 0.010-0.015 ms at Q=1 and 0.034-0.056
# ms at Q=7 for N = 1-64, the tiled path 0.032-0.035 and 0.185-0.201 (it
# runs ceil(N / 64) clusters, 16 blocks at most here, each streaming a
# share of every level), so the split path is 2.3-5.4x faster at every N
# it takes (chip_smoke.py's check_k3, NVIDIA H100 80GB HBM3, 700 W; PERF.md,
# K3). The wrapper takes it up to its limit.
SPLIT_MAX_ROWS = 64


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
    split = N <= SPLIT_MAX_ROWS
    lib = cuda_lib.kernel_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        n_bytes = lib.rvq_encode_scratch_bytes(N, D, Q, K, int(split))
        if split:
            scratch = _split_scratch(x.device, stream, n_bytes // 8)
        else:
            scratch = torch.empty(n_bytes // 4, dtype=torch.float32, device=x.device)
        status = lib.rvq_encode(
            x.data_ptr(), codebooks.data_ptr(), codes.data_ptr(), quant.data_ptr(),
            scratch.data_ptr(), N, D, Q, K, int(split), stream)
    cuda_lib.check(status, "rvq_encode")
    rvq_encode.launches += 1
    return codes, quant


rvq_encode.launches = 0  # calls that launched the kernel; reset freely by callers

_SCRATCH: dict = {}


def _split_scratch(device: torch.device, stream: int, words: int) -> torch.Tensor:
    """The split path's scratch for this device and stream: an arrival
    counter (0) and then key words (all ones), at least ``words`` 64-bit
    words. Set here once; the kernel's last block restores every word it
    used, so a launch needs no reset (and no other device work). One per
    stream, since two launches in flight must not share it."""
    key = (device, stream)
    if key not in _SCRATCH or _SCRATCH[key].numel() < words:
        buf = torch.full((max(words, 1024),), -1, dtype=torch.int64, device=device)
        buf[:1].zero_()  # a fill on the device: no copy from the host
        _SCRATCH[key] = buf
    return _SCRATCH[key]
