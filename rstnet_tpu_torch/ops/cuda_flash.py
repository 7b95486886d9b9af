"""Flash attention, forward and backward: the CUDA kernels of
``csrc/flash_attention.cu`` (K6) and their plain PyTorch versions
(counterpart of the splash kernel behind
``rstnet_tpu/ops/flash_attention.py::flash_attention`` and its VJP).

Every function here takes q pre-scaled in its own dtype, ``[B, H, T, D]``
(D = 64 or 128 for the kernels; the plain versions take any D),
and k, v at their own head count, ``[B, Hkv, T, D]`` with ``H % Hkv == 0``:
query head h reads KV head ``h // (H // Hkv)`` (GQA inside the kernels;
the plain versions repeat K/V). Key j is visible to query i iff
``0 <= i - j < window``. Two wrappers:

- :func:`flash_attention_fwd` -> (o in q's dtype, float32 lse ``[B, H, T]``);
- :func:`flash_attention_bwd` -> (dq, dk, dv, float32 delta = rowsum(dO * O)),
  dk and dv at the KV heads, summed over each group.

Each launches its kernel on a CUDA tensor (or raises) and runs its plain
version on a CPU tensor. Both dtypes go through the Hopper kernels (TMA,
``wgmma``, persistent; the backward is one launch after a row pre-pass for
delta). float32 runs them on split operands: a pre-pass writes bf16 planes
hi = bf16(x) and lo = bf16(x - hi) of K and V (forward) or of Q, dO, K and
V (backward, with delta) into scratch that the wrapper allocates, and every
product is hi.hi + hi.lo + lo.hi (:func:`split_hi_lo_reference` is the
split's plain version). The wrappers count the two dtypes and the two head
dims apart: ``launches`` and ``launches_f32`` at D = 64,
``launches_d128`` and ``launches_f32_d128`` at D = 128 (:data:`COUNTERS`).
:func:`flash_attention_kernel` is the autograd function over the two, the
route of the backbone's training forwards.
"""

from __future__ import annotations

import torch

from rstnet_tpu_torch.ops import cuda_lib

HEAD_DIMS = (64, 128)  # the kernels' head dims
SEQ_TILE = 128  # T must be a multiple
TILE = 64  # rows of a tile of the per-tile error measure
DQ_TILE = 64  # query rows of a dQ turn counter of the backward
_DTYPES = (torch.float32, torch.bfloat16)


def repeat_kv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """k, v repeated from Hkv to q's H heads, each KV head's group of query
    heads side by side (query head h reads KV head ``h // (H // Hkv)``)."""
    if k.shape[1] != q.shape[1]:
        rep = q.shape[1] // k.shape[1]
        k, v = k.repeat_interleave(rep, dim=1), v.repeat_interleave(rep, dim=1)
    return k, v


def masked_logits(q: torch.Tensor, k: torch.Tensor, window: int) -> torch.Tensor:
    """float32 logits ``q k^T`` with invisible pairs at -inf (k at q's
    heads)."""
    pos = torch.arange(q.shape[2], device=q.device)
    delta = pos[:, None] - pos[None, :]
    s = torch.einsum("bhtd,bhsd->bhts", q.float(), k.float())
    return s.masked_fill(~((delta >= 0) & (delta < window)), float("-inf"))


def flash_attention_fwd_reference(q, k, v, window: int):
    """Plain forward: float32 softmax, its weights rounded to v's dtype
    before the product with v (the splash reference's order)."""
    k, v = repeat_kv(q, k, v)
    s = masked_logits(q, k, window)
    o = torch.einsum("bhts,bhsd->bhtd", torch.softmax(s, dim=-1).to(v.dtype), v)
    return o, torch.logsumexp(s, dim=-1)


def flash_attention_bwd_reference(q, k, v, o, do, lse, window: int):
    """Plain backward in float32: P = exp(S - lse), delta = rowsum(dO * O),
    dS = P (dO V^T - delta); dQ = dS K, dK = dS^T Q and dV = P^T dO, dK and
    dV summed over each KV head's group -> (dq, dk, dv, delta)."""
    (B, H, T, D), Hkv = q.shape, k.shape[1]
    kr, vr = repeat_kv(q, k, v)
    delta = (do.float() * o.float()).sum(-1)
    p = torch.exp(masked_logits(q, kr, window) - lse[..., None])
    ds = p * (torch.einsum("bhtd,bhsd->bhts", do.float(), vr.float()) - delta[..., None])
    dq = torch.einsum("bhts,bhsd->bhtd", ds, kr.float()).to(q.dtype)
    dk = torch.einsum("bhts,bhtd->bhsd", ds, q.float())
    dv = torch.einsum("bhts,bhtd->bhsd", p, do.float())
    dk, dv = (t.reshape(B, Hkv, H // Hkv, T, D).sum(2) for t in (dk, dv))
    return dq, dk.to(k.dtype), dv.to(v.dtype), delta


def split_hi_lo_reference(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The float32 pre-pass's split, plain: hi = bf16(x) rounded to nearest,
    lo = bf16(x - hi); x - hi - lo is within 2**-16 |x|."""
    hi = x.to(torch.bfloat16)
    return hi, (x - hi.float()).to(torch.bfloat16)


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


def _check_cuda_operands(window: int, q: torch.Tensor, q_like=(), kv=()) -> tuple:
    """(B, H, Hkv, T) after checking what the kernels take: q and the
    tensors of ``q_like`` ``[B, H, T, D]``, those of ``kv`` ``[B, Hkv, T, D]``."""
    if q.dim() != 4 or not kv or kv[0].dim() != 4:
        raise ValueError(f"q, k, v must be [B, H, T, D] / [B, Hkv, T, D], got {tuple(q.shape)}")
    B, H, T, D = q.shape
    Hkv = kv[0].shape[1]
    if (D not in HEAD_DIMS or T % SEQ_TILE or T < SEQ_TILE or window < 1 or Hkv < 1 or H % Hkv
            or B * H > 65535):
        raise ValueError(f"outside the flash kernels' envelope: B={B} H={H} Hkv={Hkv} T={T} "
                         f"D={D} window={window} (D in {HEAD_DIMS}, T a multiple of {SEQ_TILE}, "
                         "H a multiple of Hkv)")
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash kernels take float32 or bfloat16, got {q.dtype}")
    for shape, ts in (((B, H, T, D), (q, *q_like)), ((B, Hkv, T, D), kv)):
        for t in ts:
            if (tuple(t.shape) != shape or t.dtype != q.dtype or t.device != q.device
                    or not t.is_contiguous() or t.data_ptr() % 16):
                raise ValueError(f"operands must be contiguous, 16-byte aligned {q.dtype} "
                                 f"{shape} tensors on {q.device}, got {t.dtype} "
                                 f"{tuple(t.shape)} on {t.device}")
    return B, H, Hkv, T


def _check_rows(t: torch.Tensor, q: torch.Tensor, name: str) -> None:
    if (tuple(t.shape) != tuple(q.shape[:3]) or t.dtype != torch.float32
            or t.device != q.device or not t.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous float32 {tuple(q.shape[:3])} tensor")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _device_check(q: torch.Tensor, name: str) -> None:
    if q.device.type != "cuda":
        raise NotImplementedError(f"{name} has no kernel for {q.device}")


# a wrapper's launch counters: (dtype, head dim) -> attribute
COUNTERS = {(torch.bfloat16, 64): "launches", (torch.float32, 64): "launches_f32",
            (torch.bfloat16, 128): "launches_d128", (torch.float32, 128): "launches_f32_d128"}


def _count(fn, q: torch.Tensor) -> None:
    attr = COUNTERS[q.dtype, q.shape[3]]
    setattr(fn, attr, getattr(fn, attr) + 1)


def flash_attention_fwd(q, k, v, window: int):
    """-> (o [B, H, T, D] in q's dtype, lse [B, H, T] float32)."""
    if q.device.type == "cpu":
        return flash_attention_fwd_reference(q, k, v, window)
    _device_check(q, "flash_attention_fwd")
    B, H, Hkv, T = _check_cuda_operands(window, q, kv=(k, v))
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    f32 = q.dtype == torch.float32
    D = q.shape[3]
    # float32: K's and V's hi and lo planes (Q is split in the kernel's registers)
    planes = torch.empty(4 * k.numel(), dtype=torch.bfloat16, device=q.device) if f32 else None
    with torch.cuda.device(q.device):
        status = cuda_lib.kernel_library().flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            planes.data_ptr() if f32 else None, B, H, Hkv, T, window, D, int(f32), _stream())
    cuda_lib.check(status, "flash_attention_fwd")
    _count(flash_attention_fwd, q)
    return o, lse


def flash_attention_bwd(q, k, v, o, do, lse, window: int):
    """-> (dq in q's dtype, dk, dv at the KV heads in k's and v's dtype,
    delta [B, H, T] float32). The kernel sums dQ in key-tile order behind
    per-tile turn counters, in a float32 workspace (float32 at head dim 128:
    in dq itself), both allocated here, as are float32's planes."""
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(q, k, v, o, do, lse, window)
    _device_check(q, "flash_attention_bwd")
    B, H, Hkv, T = _check_cuda_operands(window, q, q_like=(o, do), kv=(k, v))
    _check_rows(lse, q, "lse")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty_like(lse)
    f32 = q.dtype == torch.float32
    D = q.shape[3]
    # dQ's float32 running sum; float32 at head dim 128 keeps it in dq itself
    dq_acc = (None if f32 and D == 128 else
              torch.empty(q.shape, dtype=torch.float32, device=q.device))
    # one turn counter per (batch, head, query tile, 64 columns of the head
    # dim), then the work counter
    counters = torch.zeros(B * H * (T // DQ_TILE) * (D // 64) + 1, dtype=torch.int32,
                           device=q.device)
    # float32: the hi and lo planes of Q, dO, K and V
    planes = (torch.empty(4 * (q.numel() + k.numel()), dtype=torch.bfloat16, device=q.device)
              if f32 else None)
    with torch.cuda.device(q.device):
        status = cuda_lib.kernel_library().flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            None if dq_acc is None else dq_acc.data_ptr(), counters.data_ptr(),
            planes.data_ptr() if f32 else None, B, H,
            Hkv, T, window, D, int(f32), _stream())
    cuda_lib.check(status, "flash_attention_bwd")
    _count(flash_attention_bwd, q)
    return dq, dk, dv, delta


# kernel launches by dtype and head dim (COUNTERS); reset freely by callers
for _fn in (flash_attention_fwd, flash_attention_bwd):
    for _attr in COUNTERS.values():
        setattr(_fn, _attr, 0)


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
        dq, dk, dv, _ = flash_attention_bwd(q, k, v, o, do, lse, ctx.window)
        return dq, dk, dv, None


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           window: int) -> torch.Tensor:
    """Differentiable attention through the two wrappers: q (pre-scaled)
    ``[B, H, T, D]``, k, v ``[B, Hkv, T, D]``, contiguous, same dtype -> o
    ``[B, H, T, D]``; the gradients of k and v come back at Hkv heads."""
    return _FlashAttention.apply(q, k, v, window)
