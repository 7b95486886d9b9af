"""K2, the per-step gated FFN of a depformer micro-step: the port's plain
version (what the wrapper runs on CPU tensors) against the Pallas kernel
``gating_ffn_pallas_step`` in interpret mode, fed as the JAX call site feeds
it (weights cast to x's dtype); ``pad_codecformer_gating`` against the JAX
function; and the port's per-step ``StreamingTransformer.step`` at B > 1,
whose FFN goes through the K2 wrapper, against the JAX step.

Tolerances: float32 outputs 1e-5 (relative and absolute), the same float32
math summed in another order. bf16 outputs: one bf16 step, 2**-7 relative
(plus 1e-5 absolute), since two float32 sums that differ in the last bits
can round to neighbouring bf16 values."""

import tests.test_torch_threads  # noqa: F401 - first: one torch CPU thread a process

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rstnet_tpu.core import flatten_dict
from rstnet_tpu_torch.core import from_jax_params, to_numpy

F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2.0**-7, atol=1e-5)
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _load(params, module):
    return from_jax_params({k: np.asarray(v) for k, v in flatten_dict(params)}, module)


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _t(a, dtype):
    """numpy -> torch in ``dtype``, bf16 through JAX's rounding so both
    sides hold the same bits."""
    return torch.from_numpy(np.array(jnp.asarray(a, DTYPES[dtype][0]).astype(jnp.float32))).to(
        DTYPES[dtype][1])


@pytest.mark.parametrize("B,C,H,S,step", [
    (1, 128, 128, 8, 0), (3, 128, 256, 8, 7), (9, 256, 128, 4, 2), (2, 128, 384, 2, -1),
    (4, 128, 128, 4, 9),  # steps outside [0, S) clamp
])
@pytest.mark.parametrize("x_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("w_dtype", ["f32", "bf16"])
def test_plain_matches_pallas_step_interpret(B, C, H, S, step, x_dtype, w_dtype):
    from rstnet_tpu.ops.pallas_ffn import gating_ffn_pallas_step
    from rstnet_tpu_torch.ops.cuda_ffn import gating_ffn_step

    rng = np.random.default_rng(B * 100 + C + H + S)
    x = rng.normal(size=(B, C)).astype(np.float32)
    lin_in = (rng.uniform(-1, 1, (S, 2 * H, C)) / np.sqrt(C)).astype(np.float32)
    lin_out = (rng.uniform(-1, 1, (S, C, H)) / np.sqrt(H)).astype(np.float32)
    jx = jnp.asarray(x, DTYPES[x_dtype][0])
    jw_in, jw_out = (jnp.asarray(w, DTYPES[w_dtype][0]) for w in (lin_in, lin_out))
    want = gating_ffn_pallas_step(jx, jw_in.astype(jx.dtype), jw_out.astype(jx.dtype),
                                  jnp.int32(step), interpret=True)
    got = gating_ffn_step(_t(x, x_dtype), _t(lin_in, w_dtype), _t(lin_out, w_dtype), step)
    assert got.dtype == DTYPES[x_dtype][1] and tuple(got.shape) == (B, C)
    np.testing.assert_allclose(_np(got), _np(want), **(F32_TOL if x_dtype == "f32" else BF16_TOL))


def _split_bf16(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """f32 -> (hi, lo) bf16 parts, hi = bf16(v), lo = bf16(v - hi), as the
    tensor-core route of K2 splits an f32 operand."""
    hi = v.to(torch.bfloat16)
    return hi, (v - hi.float()).to(torch.bfloat16)


def _products(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a [B, K] @ w [N, K]^T from bf16 parts: an f32 ``a`` as hi + lo, a
    bf16 one as is; bf16 x bf16 products are exact in f32, summed in f32."""
    parts = _split_bf16(a) if a.dtype == torch.float32 else (a,)
    return sum(p.float() @ w.float().T for p in parts)


def _k2_tensor_core_emulation(x, lin_in, lin_out, step):
    """K2's tensor-core route (bf16 weights) in plain torch: x (hi + lo if
    f32) against the bf16 weights, the f32 hidden silu(gate) * val split
    into hi + lo for the down pass, the output cast to x's dtype."""
    s = min(max(step, 0), lin_in.shape[0] - 1)
    gate, val = _products(x, lin_in[s]).chunk(2, dim=-1)
    hid = gate * torch.sigmoid(gate) * val
    return _products(hid, lin_out[s]).to(x.dtype)


# the card tests' tolerances for K2 (chip_smoke.K2_TOL, tests/test_torch_cuda.py):
# float32 outputs 1e-4 relative + 1e-5 absolute, bf16 outputs one bf16 step
K2_CARD_TOL = {"f32": dict(rtol=1e-4, atol=1e-5), "bf16": dict(rtol=2.0**-7, atol=1e-5)}


@pytest.mark.parametrize("B,C,H,S,step", [
    (1, 128, 128, 8, 0), (3, 256, 128, 4, 3), (9, 128, 256, 2, 1), (16, 256, 384, 8, 7),
    (2, 128, 128, 4, 9),  # a step outside [0, S) clamps
])
@pytest.mark.parametrize("x_dtype", ["f32", "bf16"])
def test_k2_tensor_core_rounding_matches_pallas_step(B, C, H, S, step, x_dtype):
    """The rounding of K2's tensor-core route, emulated in plain torch,
    against the Pallas kernel in interpret mode (bf16 weights, fed as the JAX
    call site feeds it), within the tolerance the card tests hold the kernel
    to: the split leaves ~2**-17 of each f32 operand out, well inside the
    1e-4 that two f32 summation orders already take."""
    from rstnet_tpu.ops.pallas_ffn import gating_ffn_pallas_step

    rng = np.random.default_rng(B * 1000 + C + H + S)
    x = rng.normal(size=(B, C)).astype(np.float32)
    lin_in = (rng.uniform(-1, 1, (S, 2 * H, C)) / np.sqrt(C)).astype(np.float32)
    lin_out = (rng.uniform(-1, 1, (S, C, H)) / np.sqrt(H)).astype(np.float32)
    jx = jnp.asarray(x, DTYPES[x_dtype][0])
    jw_in, jw_out = (jnp.asarray(w, jnp.bfloat16) for w in (lin_in, lin_out))
    want = gating_ffn_pallas_step(jx, jw_in.astype(jx.dtype), jw_out.astype(jx.dtype),
                                  jnp.int32(step), interpret=True)
    got = _k2_tensor_core_emulation(_t(x, x_dtype), _t(lin_in, "bf16"), _t(lin_out, "bf16"),
                                    step)
    assert got.dtype == DTYPES[x_dtype][1] and tuple(got.shape) == (B, C)
    np.testing.assert_allclose(_np(got), _np(want), **K2_CARD_TOL[x_dtype])


def _depformer(ff=192, num_layers=2, S=4):
    return dict(d_model=128, num_heads=2, num_layers=num_layers, dim_feedforward=ff, causal=True,
                context=None, gating="silu", norm="rms_norm_f32", positional_embedding="none",
                weights_per_step=S)


@pytest.mark.parametrize("ff", [160, 192])  # gating hidden 106 (padded) and 128 (already aligned)
def test_pad_codecformer_gating_matches_jax(ff):
    from rstnet_tpu.modules.transformer import StreamingTransformer as JT
    from rstnet_tpu.modules.transformer import pad_codecformer_gating as jax_pad
    from rstnet_tpu_torch.modules.transformer import StreamingTransformer, pad_codecformer_gating

    cfg = _depformer(ff)
    jm = JT(**cfg)
    params = jm.init(jax.random.PRNGKey(5))
    tm = _load(params, StreamingTransformer(**cfg))
    x = np.random.default_rng(6).normal(size=(3, 1, 128)).astype(np.float32)
    before, _ = tm.step(tm.init_state(3, torch.float32), torch.from_numpy(x))
    assert pad_codecformer_gating(tm) is tm
    want = {k: np.asarray(v) for k, v in flatten_dict(jax_pad(params))}
    got = to_numpy(tm)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert tm.layers.gating.linear_in.shape[-2] % 256 == 0
    after, _ = tm.step(tm.init_state(3, torch.float32), torch.from_numpy(x))
    np.testing.assert_allclose(_np(after), _np(before), rtol=1e-6, atol=1e-6)
    # JAX-padded params load into the port's padded module
    _load(jax_pad(params), tm)


@pytest.mark.parametrize("w_dtype", ["f32", "bf16"])
def test_depformer_step_through_k2_matches_jax(monkeypatch, w_dtype):
    """B=3 per-step micro-steps: the FFN of every layer and step goes
    through the K2 wrapper (the JAX CPU side runs its einsum branch, since
    ``use_pallas_ffn`` is False off the TPU)."""
    import rstnet_tpu_torch.modules.transformer as tmod
    from rstnet_tpu.modules.transformer import StreamingTransformer as JT

    cfg = _depformer()
    jm = JT(**cfg)
    params = jm.init(jax.random.PRNGKey(7), DTYPES[w_dtype][0])
    tm = _load(params, tmod.StreamingTransformer(**cfg, dtype=DTYPES[w_dtype][1]))
    calls = []
    real = tmod.gating_ffn_step

    def counted(*args, **kwargs):
        calls.append(args[3])
        return real(*args, **kwargs)

    monkeypatch.setattr(tmod, "gating_ffn_step", counted)
    x = np.random.default_rng(8).normal(size=(4, 3, 1, 128)).astype(np.float32)
    jst = jm.init_state(3, jnp.float32, kv_unstacked=True)
    tst = tm.init_state(3, torch.float32, kv_unstacked=True)
    step = jax.jit(jm.step)
    for t in range(4):
        jy, jst = step(params, jst, jnp.asarray(x[t]))
        ty, tst = tm.step(tst, torch.from_numpy(x[t]))
        np.testing.assert_allclose(_np(ty), _np(jy), rtol=1e-5, atol=1e-5)
    assert calls == [t for t in range(4) for _ in range(2)]  # each layer, each step


# (B, C, H) -> K2's (groups, splits) on a card of 132 SMs: Moshi 7B's
# depformer (C=1024, H=2816) keeps one group (its 176 gate/value blocks
# already fill the SMs) and splits H eight ways; the flagship codecformer
# (H=768 <= C) never splits H and shares 16 or more rows among groups of
# blocks, as many as keep every block resident; K2's CUDA test shape (H > C)
# splits H too.
K2_SCHEDULES = {(2, 1024, 2816): (1, 8), (64, 1024, 2816): (1, 8), (2, 1024, 768): (1, 1),
                (8, 1024, 768): (1, 1), (16, 1024, 768): (2, 1), (64, 1024, 768): (4, 1),
                (300, 256, 384): (8, 3)}


@pytest.mark.parametrize("shape", sorted(K2_SCHEDULES), ids=lambda s: "B%d-C%d-H%d" % s)
def test_k2_schedule(monkeypatch, shape):
    """``k2_schedule`` on a 132-SM card: the table above, and in every case
    at least 8 rows a group and at most two blocks an SM in each pass."""
    from rstnet_tpu_torch.ops import cuda_ffn

    monkeypatch.setattr(cuda_ffn, "_sm_count", lambda index: 132)
    B, C, H = shape
    groups, splits = cuda_ffn.k2_schedule(torch.device("cuda", 0), B, C, H)
    assert (groups, splits) == K2_SCHEDULES[shape]
    assert groups == 1 or B // groups >= 8
    assert groups == 1 or H // 16 * groups <= 2 * 132
    assert splits == 1 or C // 32 * groups * splits <= 2 * 132
