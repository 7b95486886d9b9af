"""Flash attention, forward and backward: the CUDA kernels of
``csrc/flash_attention.cu`` (K6) and their plain PyTorch versions
(counterpart of the splash kernel behind
``rstnet_tpu/ops/flash_attention.py::flash_attention`` and its VJP).

Every function here takes q pre-scaled in its own dtype and k, v with q's
head count, all ``[B, H, T, D]``; key j is visible to query i iff
``0 <= i - j < window``. Three wrappers, one kernel each:

- :func:`flash_attention_fwd` -> (o in q's dtype, float32 lse ``[B, H, T]``);
- :func:`flash_attention_bwd_dq` -> (dq, float32 delta = rowsum(dO * O));
- :func:`flash_attention_bwd_dkv` -> (dk, dv), after ``bwd_dq`` (it reads
  delta).

Each launches its kernel on a CUDA tensor (or raises) and runs its plain
version on a CPU tensor. :func:`flash_attention_kernel` is the autograd
function over the three, the route of the backbone's training forwards.
"""

from __future__ import annotations

import torch

from rstnet_tpu_torch.ops import cuda_lib

HEAD_DIM = 64  # the kernels' head dim
TILE = 64  # rows of a kernel tile: T must be a multiple
_DTYPES = (torch.float32, torch.bfloat16)


def masked_logits(q: torch.Tensor, k: torch.Tensor, window: int) -> torch.Tensor:
    """float32 logits ``q k^T`` with invisible pairs at -inf."""
    pos = torch.arange(q.shape[2], device=q.device)
    delta = pos[:, None] - pos[None, :]
    s = torch.einsum("bhtd,bhsd->bhts", q.float(), k.float())
    return s.masked_fill(~((delta >= 0) & (delta < window)), float("-inf"))


def flash_attention_fwd_reference(q, k, v, window: int):
    """Plain forward: float32 softmax, its weights rounded to v's dtype
    before the product with v (the splash reference's order)."""
    s = masked_logits(q, k, window)
    o = torch.einsum("bhts,bhsd->bhtd", torch.softmax(s, dim=-1).to(v.dtype), v)
    return o, torch.logsumexp(s, dim=-1)


def flash_attention_bwd_dq_reference(q, k, v, o, do, lse, window: int):
    """Plain dQ in float32: P = exp(S - lse), dS = P (dO V^T - delta)."""
    delta = (do.float() * o.float()).sum(-1)
    p = torch.exp(masked_logits(q, k, window) - lse[..., None])
    ds = p * (torch.einsum("bhtd,bhsd->bhts", do.float(), v.float()) - delta[..., None])
    return torch.einsum("bhts,bhsd->bhtd", ds, k.float()).to(q.dtype), delta


def flash_attention_bwd_dkv_reference(q, k, v, do, lse, delta, window: int):
    """Plain dK = dS^T Q and dV = P^T dO in float32."""
    p = torch.exp(masked_logits(q, k, window) - lse[..., None])
    ds = p * (torch.einsum("bhtd,bhsd->bhts", do.float(), v.float()) - delta[..., None])
    dk = torch.einsum("bhts,bhtd->bhsd", ds, q.float()).to(k.dtype)
    dv = torch.einsum("bhts,bhtd->bhsd", p, do.float()).to(v.dtype)
    return dk, dv


def relative_error_by_tile(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """How far ``got`` is from ``want`` (both ``[B, H, T, D]``, T a multiple
    of TILE): ``||got - want|| / ||want||`` over the whole tensor, and the
    largest of the same ratio over the TILE-row tiles of each ``[B, H]``
    slice. Each tile is held to its own scale, so a wrong tile of small
    outputs (late causal rows, a window edge) shows as clearly as a wrong
    tile of large ones."""
    d, w = got.float() - want.float(), want.float()
    B, H, T, D = w.shape
    dt = d.reshape(B * H, T // TILE, TILE * D).norm(dim=-1)
    wt = w.reshape(B * H, T // TILE, TILE * D).norm(dim=-1)
    tiles = torch.where(wt > 0, dt / wt, dt)
    return (d.norm() / w.norm()).item(), tiles.max().item()


def _check_cuda_operands(window: int, *ts: torch.Tensor) -> tuple[int, int]:
    """(B * H, T) after checking what the kernels take."""
    q = ts[0]
    if q.dim() != 4:
        raise ValueError(f"q must be [B, H, T, D], got {tuple(q.shape)}")
    B, H, T, D = q.shape
    if D != HEAD_DIM or T % TILE or T < TILE or window < 1 or B * H > 65535:
        raise ValueError(f"outside the flash kernels' envelope: B={B} H={H} T={T} D={D} "
                         f"window={window} (D == {HEAD_DIM}, T a multiple of {TILE})")
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash kernels take float32 or bfloat16, got {q.dtype}")
    for t in ts:
        if (tuple(t.shape) != tuple(q.shape) or t.dtype != q.dtype or t.device != q.device
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"operands must be contiguous, 16-byte aligned {q.dtype} "
                             f"{tuple(q.shape)} tensors on {q.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    return B * H, T


def _check_rows(t: torch.Tensor, q: torch.Tensor, name: str) -> None:
    if (tuple(t.shape) != tuple(q.shape[:3]) or t.dtype != torch.float32
            or t.device != q.device or not t.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous float32 {tuple(q.shape[:3])} tensor")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _device_check(q: torch.Tensor, name: str) -> None:
    if q.device.type != "cuda":
        raise NotImplementedError(f"{name} has no kernel for {q.device}")


def flash_attention_fwd(q, k, v, window: int):
    """-> (o [B, H, T, D] in q's dtype, lse [B, H, T] float32)."""
    if q.device.type == "cpu":
        return flash_attention_fwd_reference(q, k, v, window)
    _device_check(q, "flash_attention_fwd")
    bh, T = _check_cuda_operands(window, q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        status = cuda_lib.kernel_library().flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(), bh, T,
            window, int(q.dtype == torch.float32), _stream())
    cuda_lib.check(status, "flash_attention_fwd")
    flash_attention_fwd.launches += 1
    return o, lse


def flash_attention_bwd_dq(q, k, v, o, do, lse, window: int):
    """-> (dq in q's dtype, delta [B, H, T] float32)."""
    if q.device.type == "cpu":
        return flash_attention_bwd_dq_reference(q, k, v, o, do, lse, window)
    _device_check(q, "flash_attention_bwd_dq")
    bh, T = _check_cuda_operands(window, q, k, v, o, do)
    _check_rows(lse, q, "lse")
    dq = torch.empty_like(q)
    delta = torch.empty_like(lse)
    with torch.cuda.device(q.device):
        status = cuda_lib.kernel_library().flash_attention_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), bh, T, window,
            int(q.dtype == torch.float32), _stream())
    cuda_lib.check(status, "flash_attention_bwd_dq")
    flash_attention_bwd_dq.launches += 1
    return dq, delta


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, window: int):
    """-> (dk, dv) in k's and v's dtype."""
    if q.device.type == "cpu":
        return flash_attention_bwd_dkv_reference(q, k, v, do, lse, delta, window)
    _device_check(q, "flash_attention_bwd_dkv")
    bh, T = _check_cuda_operands(window, q, k, v, do)
    _check_rows(lse, q, "lse")
    _check_rows(delta, q, "delta")
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        status = cuda_lib.kernel_library().flash_attention_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), bh, T, window,
            int(q.dtype == torch.float32), _stream())
    cuda_lib.check(status, "flash_attention_bwd_dkv")
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


# kernel launches; reset freely by callers
flash_attention_fwd.launches = 0
flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dkv.launches = 0


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, window):
        o, lse = flash_attention_fwd(q, k, v, window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.window = window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        dq, delta = flash_attention_bwd_dq(q, k, v, o, do, lse, ctx.window)
        dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, ctx.window)
        return dq, dk, dv, None


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           window: int) -> torch.Tensor:
    """Differentiable attention through the three wrappers: q (pre-scaled),
    k, v ``[B, H, T, D]`` contiguous, same dtype -> o ``[B, H, T, D]``."""
    return _FlashAttention.apply(q, k, v, window)
