"""The fused gated FFNs: the CUDA kernels and their plain PyTorch versions.

K2, ``csrc/gating_ffn_step.cu`` (counterpart of
``rstnet_tpu/ops/pallas_ffn.py::gating_ffn_pallas_step``): the per-step
gated FFN of a depformer micro-step at batch B. ``out = (silu(x Wg[s]^T) *
(x Wv[s]^T)) Wo[s]^T`` with ``lin_in [S, 2H, C]`` (gate rows, then value
rows) and ``lin_out [S, C, H]``, as the JAX call site in
``StreamingTransformer._ffn`` feeds the Pallas kernel: the step index is
clamped to ``[0, S-1]``; the weights are taken in x's dtype (an exact
widening for bf16 weights and f32 x, a rounding to bf16 for f32 weights and
bf16 x), then x and the weights are widened to float32, the sums and the
hidden ``silu(gate) * val`` stay float32, and the output is cast to x's
dtype.

K4 and K5, ``csrc/gating_ffn.cu`` (counterparts of ``gating_ffn_pallas`` and
``gating_ffn_pallas_int8``): the same function over separate ``w_gate``,
``w_val [H, C]`` and ``w_out [C, H]``, the backbone LLaMAMLP's ``fc_1``,
``fc_2`` and ``proj`` read in place, for N <= 64 decode rows. K4 takes the
weights in x's dtype first, as ``models/backbone.py::linear`` does; K5 takes
int8 weights with float32 row scales. Both keep the sums and the hidden in
float32 and cast the output once to x's dtype. On the card, bf16 or int8
weights with C and H multiples of 128 run on the tensor cores: one stream of
the weights (int8 as int8) for any N up to 64, x and the hidden as bf16
parts (an f32 value as hi + lo), K5's row scale applied to each row's float32
sum; the plain versions dequantize each element as ``float(q) * scale[row]``
in float32, as the Pallas body does, one float32 rounding from the kernel.
Float32 weights take the same route, streamed as float32 and never copied:
split in registers into bf16 parts, hi = bf16(w) alone under a bf16 x
(exactly the weights in x's dtype), hi + lo against x's hi + lo under an
f32 x. Other widths take the CUDA-core kernels of the same source.
``Backbone.step`` routes its MLP through them. The JAX ``_mlp`` instead
rounds ``fc_1``'s and ``fc_2``'s outputs and the hidden to x's dtype (and its
int8 ``linear`` dequantizes in x's dtype): with float32 activations the two
agree up to summation order, with bf16 activations they differ by those
bf16 roundings. That difference is deliberate: the kernels keep the Pallas
kernels' precision.

Each wrapper launches its kernel on a CUDA tensor (or raises) and runs its
plain version on a CPU tensor; it counts launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from rstnet_tpu_torch.ops import cuda_lib
from rstnet_tpu_torch.ops.gating import get_activation

_DTYPES = (torch.float32, torch.bfloat16)


def clamp_step(step: int, S: int) -> int:
    """The step index as the JAX call site clamps it: into [0, S-1]."""
    return min(max(int(step), 0), S - 1)


def gating_ffn_step_reference(x: torch.Tensor, lin_in: torch.Tensor, lin_out: torch.Tensor,
                              step: int, activation: str = "silu") -> torch.Tensor:
    """Plain PyTorch version: x [B, C], lin_in [S, 2H, C], lin_out [S, C, H]
    -> [B, C] in x's dtype."""
    s = clamp_step(step, lin_in.shape[0])
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
                    activation: str = "silu", schedule: tuple[int, int] | None = None
                    ) -> torch.Tensor:
    """Fused per-step gated FFN: x [B, C] (float32 or bf16), lin_in
    [S, 2H, C], lin_out [S, C, H] (float32 or bf16), step an int -> [B, C]
    in x's dtype. Launches the kernel on a CUDA tensor (or raises), runs the
    plain version on a CPU tensor. ``schedule``: (groups, splits) of the
    tensor-core passes in place of ``k2_schedule``'s, to compare them."""
    if x.device.type == "cpu":
        return gating_ffn_step_reference(x, lin_in, lin_out, step, activation)
    if x.device.type != "cuda":
        raise NotImplementedError(f"gating_ffn_step has no kernel for {x.device}")
    _check_cuda_operands(x, lin_in, lin_out, activation)
    B, C = x.shape
    H = lin_in.shape[1] // 2
    s = clamp_step(step, lin_in.shape[0])
    w_in, w_out = lin_in[s], lin_out[s]  # views of the step's slice: no copy
    if x.dtype == torch.bfloat16 and w_in.dtype == torch.float32:
        # the JAX call site takes the weights in x's dtype
        w_in, w_out = w_in.to(torch.bfloat16), w_out.to(torch.bfloat16)
    hid = torch.empty((B, H), dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        groups, splits = schedule or k2_schedule(x.device, B, C, H)
        partial = torch.empty((splits, B, C) if splits > 1 else (0,), dtype=torch.float32,
                              device=x.device)
        status = cuda_lib.kernel_library().gating_ffn_step(
            x.data_ptr(), w_in.data_ptr(), w_out.data_ptr(), hid.data_ptr(), out.data_ptr(),
            partial.data_ptr(), splits, groups, B, C, H, int(x.dtype == torch.bfloat16),
            int(w_in.dtype == torch.bfloat16), stream)
    cuda_lib.check(status, "gating_ffn_step")
    gating_ffn_step.launches += 1
    return out


gating_ffn_step.launches = 0  # kernel launches; reset freely by callers


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def k2_schedule(device: torch.device, B: int, C: int, H: int) -> tuple[int, int]:
    """(groups, splits) of K2's tensor-core passes over B rows. Two blocks
    an SM stay resident at once. The rows are shared among ``groups`` groups
    of blocks, each a copy of both passes' grids over at least 8 rows: the
    most (a power of two) whose gate/value blocks (H / 16 a group) all stay
    resident, since a second wave costs more than the narrower tiles save.
    The down pass splits H (``splits``, then a launch adds the partial sums
    in order) only where a block would otherwise stream more 128-column
    chunks than a gate/value block does (H > C), into as many splits as
    keep its blocks (C / 32 x groups x splits) resident. The times it rests
    on: ``chip_smoke.check_k2``, beside one group and PR 7's splits."""
    slots = 2 * _sm_count(device.index)
    groups = 1
    while 2 * groups <= B // 8 and H // 16 * 2 * groups <= slots:
        groups *= 2
    splits = 1 if H <= C else max(1, min(H // 128, slots // (max(1, C // 32) * groups)))
    return groups, splits


# K4/K5's decode envelope: the Pallas docstring's batch-1..64. On the H100
# the tensor-core kernels stream the weights once for any N up to 64 and beat
# the eager three-GEMM chain at every N measured there, 1, 4, 16 and 64 (by
# ~1.2-2x; PERF.md section 6): the measurement this envelope rests on.
FFN_MAX_ROWS = 64


def ffn_splits(device: torch.device, C: int, H: int) -> int:
    """Parts of H in K4/K5's tensor-core down pass: its C / 128 blocks of
    128 output rows times the parts fill the SMs once, each part at least
    one 128-column chunk of H."""
    return max(1, min(H // 128, _sm_count(device.index) // max(1, C // 128)))


def _ffn_scratch(x: torch.Tensor, C: int, H: int) -> tuple[torch.Tensor, int]:
    """(K4/K5's float32 scratch, the down pass's parts of H): the hidden
    [N, H] (as two bf16 planes on the tensor cores), an f32 x's bf16 planes
    [N, C], and the down pass's partial sums [splits, N, C]."""
    N = x.shape[0]
    splits = ffn_splits(x.device, C, H)
    return torch.empty(N * (H + C + splits * C), dtype=torch.float32, device=x.device), splits


def gating_ffn_reference(x: torch.Tensor, w_gate: torch.Tensor, w_val: torch.Tensor,
                         w_out: torch.Tensor, out_dtype: torch.dtype | None = None
                         ) -> torch.Tensor:
    """Plain version of K4: x [N, C]; w_gate, w_val [H, C]; w_out [C, H]
    -> [N, C] in ``out_dtype`` (x's dtype by default). The weights are
    taken in x's dtype, then widened to float32 with x; sums and hidden in
    float32."""
    xf = x.float()
    wg, wv, wo = (w.to(x.dtype).float() for w in (w_gate, w_val, w_out))
    return ((F.silu(xf @ wg.T) * (xf @ wv.T)) @ wo.T).to(out_dtype or x.dtype)


def dequantize_rows(w_int8: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``float(q) * scale[row]`` in float32, as K5 (and its Pallas body)
    dequantizes each element."""
    return w_int8.float() * scale.float().reshape(-1, 1)


def gating_ffn_int8_reference(x: torch.Tensor, w_gate: torch.Tensor, gate_scale: torch.Tensor,
                              w_val: torch.Tensor, val_scale: torch.Tensor, w_out: torch.Tensor,
                              out_scale: torch.Tensor) -> torch.Tensor:
    """Plain version of K5: int8 w_gate, w_val [H, C] with float32 scales
    [H], int8 w_out [C, H] with float32 scale [C] -> [N, C] in x's dtype."""
    xf = x.float()
    wg, wv = dequantize_rows(w_gate, gate_scale), dequantize_rows(w_val, val_scale)
    wo = dequantize_rows(w_out, out_scale)
    return ((F.silu(xf @ wg.T) * (xf @ wv.T)) @ wo.T).to(x.dtype)


def _check_ffn_operands(name, x, weights, wtypes, scales=()):
    """The K4/K5 envelope: x [N, C] float32 or bf16; w_gate, w_val [H, C] and
    w_out [C, H] of one dtype in ``wtypes``; scales [H], [H], [C] float32;
    all contiguous, 16-byte aligned on x's device; C and H multiples of 8."""
    w_gate, w_val, w_out = weights
    if x.dim() != 2 or w_gate.dim() != 2:
        raise ValueError(f"{name}: x {tuple(x.shape)}, w_gate {tuple(w_gate.shape)}")
    N, C = x.shape
    H = w_gate.shape[0]
    if (tuple(w_gate.shape) != (H, C) or tuple(w_val.shape) != (H, C)
            or tuple(w_out.shape) != (C, H)):
        raise ValueError(f"{name}: shapes x {tuple(x.shape)}, w_gate {tuple(w_gate.shape)}, "
                         f"w_val {tuple(w_val.shape)}, w_out {tuple(w_out.shape)}")
    if x.dtype not in _DTYPES or w_gate.dtype not in wtypes or {
            w_val.dtype, w_out.dtype} != {w_gate.dtype}:
        raise TypeError(f"{name}: x {x.dtype}, weights {w_gate.dtype}, {w_val.dtype}, "
                        f"{w_out.dtype}")
    for s, rows in zip(scales, (H, H, C)):
        if tuple(s.shape) != (rows,) or s.dtype != torch.float32:
            raise ValueError(f"{name}: scales must be float32 [{H}], [{H}], [{C}], got "
                             f"{[(str(t.dtype), tuple(t.shape)) for t in scales]}")
    if N < 1 or C % 8 or H % 8:
        raise ValueError(f"{name}: outside the kernel envelope: N={N}, C={C}, H={H} (C and H "
                         "multiples of 8)")
    for t in (x, *weights, *scales):
        if t.device != x.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: operands must be contiguous, 16-byte aligned tensors on "
                             f"{x.device}")


def gating_ffn(x: torch.Tensor, w_gate: torch.Tensor, w_val: torch.Tensor,
               w_out: torch.Tensor, out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """K4: fused ``(silu(x Wg^T) * (x Wv^T)) Wo^T`` for x [N, C] (float32 or
    bf16) and float32 or bf16 weights -> [N, C] in ``out_dtype``: x's dtype
    by default, or float32 (a tensor-parallel rank's partial of the down
    product, summed over the ranks before its one rounding). Launches the
    kernel on a CUDA tensor (or raises), runs the plain version on a CPU
    tensor. Counts launches over bf16 weights in ``gating_ffn.launches``
    and over float32 weights in ``gating_ffn.launches_f32w``.

    Precondition on the card: the kernels start streaming the weights
    before the kernel launched just ahead of the call on the stream has
    finished (programmatic dependent launch), so that kernel must not have
    written them."""
    out_dtype = out_dtype or x.dtype
    if out_dtype not in (x.dtype, torch.float32):
        raise TypeError(f"gating_ffn writes x's dtype or float32, not {out_dtype}")
    if x.device.type == "cpu":
        return gating_ffn_reference(x, w_gate, w_val, w_out, out_dtype)
    if x.device.type != "cuda":
        raise NotImplementedError(f"gating_ffn has no kernel for {x.device}")
    weights = (w_gate, w_val, w_out)
    _check_ffn_operands("gating_ffn", x, weights, _DTYPES)
    N, C = x.shape
    H = w_gate.shape[0]
    w_bf16 = w_gate.dtype == torch.bfloat16
    out = torch.empty_like(x, dtype=out_dtype)
    with torch.cuda.device(x.device):
        scratch, splits = _ffn_scratch(x, C, H)
        status = cuda_lib.kernel_library().gating_ffn(
            x.data_ptr(), *(w.data_ptr() for w in weights), scratch.data_ptr(), out.data_ptr(),
            N, C, H, splits, int(x.dtype == torch.bfloat16), int(w_bf16),
            int(out_dtype == torch.float32), torch.cuda.current_stream().cuda_stream)
    cuda_lib.check(status, "gating_ffn")
    if w_bf16:
        gating_ffn.launches += 1
    else:
        gating_ffn.launches_f32w += 1
    return out


# kernel launches over bf16 and over float32 weights; reset freely by callers
gating_ffn.launches = gating_ffn.launches_f32w = 0


def gating_ffn_int8(x: torch.Tensor, w_gate: torch.Tensor, gate_scale: torch.Tensor,
                    w_val: torch.Tensor, val_scale: torch.Tensor, w_out: torch.Tensor,
                    out_scale: torch.Tensor) -> torch.Tensor:
    """K5: K4 over int8 weights with float32 row scales (``gate_scale``,
    ``val_scale`` [H], ``out_scale`` [C], the ``scale`` that
    ``quantize_linear_int8`` writes). Launches the kernel on a CUDA tensor
    (or raises), runs the plain version on a CPU tensor. The precondition of
    ``gating_ffn`` holds, with no exception: the kernel launched just ahead
    of the call must not have written the int8 weights."""
    args = (x, w_gate, gate_scale, w_val, val_scale, w_out, out_scale)
    if x.device.type == "cpu":
        return gating_ffn_int8_reference(*args)
    if x.device.type != "cuda":
        raise NotImplementedError(f"gating_ffn_int8 has no kernel for {x.device}")
    _check_ffn_operands("gating_ffn_int8", x, (w_gate, w_val, w_out), (torch.int8,),
                        (gate_scale, val_scale, out_scale))
    N, C = x.shape
    H = w_gate.shape[0]
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        scratch, splits = _ffn_scratch(x, C, H)
        status = cuda_lib.kernel_library().gating_ffn_int8(
            *(t.data_ptr() for t in args), scratch.data_ptr(), out.data_ptr(), N, C, H, splits,
            int(x.dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream)
    cuda_lib.check(status, "gating_ffn_int8")
    gating_ffn_int8.launches += 1
    return out


gating_ffn_int8.launches = 0  # kernel launches; reset freely by callers
