"""K4 and K5, the fused gated FFN over the backbone's LLaMAMLP weights: the
port's plain versions (what the wrappers run on CPU tensors) against the
Pallas kernels ``gating_ffn_pallas`` / ``gating_ffn_pallas_int8`` in
interpret mode, against ``gating_ffn_reference``, and against the JAX
backbone's ``_mlp``.

Tolerances: float32 outputs 1e-5 relative and absolute (the same float32
math summed in another order). bf16 outputs one bf16 step, 2**-7 relative
(plus 1e-5 absolute): two float32 sums that differ in their last bits may
round to neighbouring bf16 values. Against the JAX ``_mlp`` in bf16 the
kernels differ on purpose (the JAX MLP rounds the gate, the value and the
hidden to bf16, the kernels keep them in float32): held there to 2e-2 of
the output's norm, ||plain - jax|| / ||jax|| (a few bf16 roundings of ~2**-9
each; observed 5.8e-3 for K4 and 7.5e-3 for K5).

The rounding of the kernels' tensor-core route (bf16 or int8 weights, C and
H multiples of 128), emulated in plain torch, is held to the Pallas kernels
within the card tolerances (``chip_smoke.K2_TOL``): float32 outputs 1e-4
relative + 1e-5 absolute, bf16 outputs one bf16 step; so is the rounding of
its float32-weight route (weights split into bf16 hi + lo in registers)."""

import tests.test_torch_threads  # noqa: F401 - first: one torch CPU thread a process

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rstnet_tpu.core import flatten_dict
from rstnet_tpu_torch.modules.transformer import quantize_weight_int8
from rstnet_tpu_torch.ops.cuda_ffn import (
    gating_ffn,
    gating_ffn_int8,
    gating_ffn_int8_reference,
    gating_ffn_reference,
)
from tests.test_torch_ffn import _products, _split_bf16

F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2.0**-7, atol=1e-5)
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
# (N, C, H): tests/test_pallas_ffn.py's K4 and K5 shapes, plus the route's largest N
SHAPES = [(1, 128, 256), (4, 256, 768), (2, 256, 512), (64, 128, 256)]


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _both(a: np.ndarray, dtype: str):
    """The same values on both sides: JAX's array and torch's, bf16 rounded
    by JAX so both hold the same bits."""
    j = jnp.asarray(a, DTYPES[dtype][0])
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(DTYPES[dtype][1])


def _weights(C, H, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(H, C)) * 0.02, rng.normal(size=(H, C)) * 0.02,
            rng.normal(size=(C, H)) * 0.02)


@pytest.mark.parametrize("N,C,H", SHAPES)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_k4_plain_matches_pallas_interpret(N, C, H, dtype):
    from rstnet_tpu.ops.pallas_ffn import gating_ffn_pallas

    x = np.random.default_rng(N + C).normal(size=(N, C))
    (jx, tx), *ws = (_both(a, dtype) for a in (x, *_weights(C, H, 1)))
    want = gating_ffn_pallas(jx, *(j for j, _ in ws), interpret=True)
    got = gating_ffn(tx, *(t for _, t in ws))
    assert got.dtype == DTYPES[dtype][1] and tuple(got.shape) == (N, C)
    np.testing.assert_allclose(_np(got), _np(want), **(F32_TOL if dtype == "f32" else BF16_TOL))


@pytest.mark.parametrize("N,C,H", SHAPES)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_k5_plain_matches_pallas_interpret(N, C, H, dtype):
    """Codes and scales from the port's quantizer (equal to JAX's); both
    sides dequantize each element as float(q) * scale in float32."""
    from rstnet_tpu.ops.pallas_ffn import gating_ffn_pallas_int8

    x = np.random.default_rng(N + H).normal(size=(N, C))
    jx, tx = _both(x, dtype)
    q = [quantize_weight_int8(torch.from_numpy(w.astype(np.float32))) for w in _weights(C, H, 2)]
    args = [t for w in q for t in (w.w_int8.data, w.scale.data)]
    want = gating_ffn_pallas_int8(jx, *(jnp.asarray(a.numpy()) for a in args), interpret=True)
    got = gating_ffn_int8(tx, *args)
    assert got.dtype == DTYPES[dtype][1]
    np.testing.assert_allclose(_np(got), _np(want), **(F32_TOL if dtype == "f32" else BF16_TOL))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_k4_plain_matches_jax_reference(dtype):
    from rstnet_tpu.ops.pallas_ffn import gating_ffn_reference as jax_reference

    N, C, H = 3, 256, 384
    (jx, tx), *ws = (_both(a, dtype) for a in (np.random.default_rng(3).normal(size=(N, C)),
                                                *_weights(C, H, 4)))
    want = jax_reference(jx, *(j for j, _ in ws))
    got = gating_ffn_reference(tx, *(t for _, t in ws))
    np.testing.assert_allclose(_np(got), _np(want), **(F32_TOL if dtype == "f32" else BF16_TOL))


def _jax_mlp(dtype, int8):
    """The JAX backbone's layer-0 MLP params (LLaMAMLP, C=128, H=256) in
    ``dtype``, int8-quantized by the JAX function when asked."""
    from rstnet_tpu.models.backbone import Backbone, quantize_backbone_int8
    from rstnet_tpu.models.config import Config

    cfg = Config(name="ffn-tiny", block_size=64, vocab_size=64, padded_vocab_size=64, n_layer=1,
                 n_head=2, n_embd=128, n_query_groups=1, bias=False, norm_class_name="RMSNorm",
                 mlp_class_name="LLaMAMLP", intermediate_size=256, context=16)
    bb = Backbone(cfg)
    params = bb.init(jax.random.PRNGKey(5), DTYPES[dtype][0])
    if int8:
        params = quantize_backbone_int8(params)
    mlp = jax.tree_util.tree_map(lambda a: a[0], params["blocks"]["mlp"])
    flat = {k: torch.from_numpy(np.array(jnp.asarray(v).astype(jnp.float32)
                                         if v.dtype == jnp.bfloat16 else v))
            for k, v in flatten_dict(mlp)}
    if dtype == "bf16":
        flat = {k: v.bfloat16() if v.is_floating_point() and "scale" not in k else v
                for k, v in flat.items()}
    return bb, mlp, flat


@pytest.mark.parametrize("int8", [False, True], ids=["k4", "k5"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_plain_against_jax_mlp(dtype, int8):
    """The kernels' plain versions against ``Backbone._mlp`` (float or int8
    linears) on decode rows: float32 to summation order, bf16 within the
    stated norm-relative limit (the deliberate float32 gate/value/hidden)."""
    bb, mlp, w = _jax_mlp(dtype, int8)
    x = np.random.default_rng(6).normal(size=(4, 1, 128))
    jx, tx = _both(x, dtype)
    want = _np(bb._mlp(mlp, jx))[:, 0]
    if int8:
        got = gating_ffn_int8(tx[:, 0], *(w[f"{n}.{k}"] for n in ("fc_1", "fc_2", "proj")
                                          for k in ("w_int8", "scale")))
    else:
        got = gating_ffn(tx[:, 0], *(w[f"{n}.weight"] for n in ("fc_1", "fc_2", "proj")))
    if dtype == "f32":
        np.testing.assert_allclose(_np(got), want, **F32_TOL)
    else:
        assert np.linalg.norm(_np(got) - want) / np.linalg.norm(want) < 2e-2


def test_wrappers_take_the_plain_version_on_cpu_only():
    """A CPU tensor runs the plain version and counts no launch; a tensor on
    a device without a kernel raises."""
    x = torch.randn(2, 128)
    w = [torch.randn(256, 128), torch.randn(256, 128), torch.randn(128, 256)]
    launches = gating_ffn.launches, gating_ffn.launches_f32w, gating_ffn_int8.launches
    torch.testing.assert_close(gating_ffn(x, *w), gating_ffn_reference(x, *w), rtol=0, atol=0)
    bf16 = [t.bfloat16() for t in w]
    torch.testing.assert_close(gating_ffn(x, *bf16), gating_ffn_reference(x, *bf16), rtol=0,
                               atol=0)
    q = [quantize_weight_int8(t) for t in w]
    args = [t for wq in q for t in (wq.w_int8.data, wq.scale.data)]
    torch.testing.assert_close(gating_ffn_int8(x, *args), gating_ffn_int8_reference(x, *args),
                               rtol=0, atol=0)
    assert (gating_ffn.launches, gating_ffn.launches_f32w, gating_ffn_int8.launches) == launches
    with pytest.raises(NotImplementedError):
        gating_ffn(x.to("meta"), *(t.to("meta") for t in w))
    with pytest.raises(NotImplementedError):
        gating_ffn_int8(x.to("meta"), *(t.to("meta") for t in args))


# the card tests' tolerances (chip_smoke.K2_TOL, tests/test_torch_cuda.py)
CARD_TOL = {"f32": dict(rtol=1e-4, atol=1e-5), "bf16": dict(rtol=2.0**-7, atol=1e-5)}
# (N, C, H): N from single-row decode to the route's largest, C and H on
# the tensor-core route's 128 grid
TC_SHAPES = [(1, 128, 256), (3, 256, 384), (16, 128, 512), (64, 256, 256)]


def _tensor_core_ffn(x, w_gate, w_val, w_out, scales=(1.0, 1.0, 1.0)):
    """K4's and K5's tensor-core route in plain torch (``_products``: an f32
    operand as hi + lo bf16 parts, exact products, f32 sums): x against bf16
    weights (K5: bf16(q), exact), each row's sum times its row scale, the
    f32 hidden silu(gate) * val as the down pass's operand, the output cast
    to x's dtype."""
    gs, vs, os = scales
    gate = _products(x, w_gate) * gs
    val = _products(x, w_val) * vs
    hid = gate * torch.sigmoid(gate) * val
    return (_products(hid, w_out) * os).to(x.dtype)


@pytest.mark.parametrize("N,C,H", TC_SHAPES)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_k4_tensor_core_rounding_matches_pallas(N, C, H, dtype):
    """K4's tensor-core rounding against ``gating_ffn_pallas`` in interpret
    mode (bf16 weights): the hi + lo split leaves ~2**-17 of each f32
    operand out, inside the 1e-4 that two f32 summation orders take."""
    from rstnet_tpu.ops.pallas_ffn import gating_ffn_pallas

    x = np.random.default_rng(N + C + H).normal(size=(N, C))
    (jx, tx), *ws = (_both(a, d) for a, d in zip((x, *_weights(C, H, 7)),
                                                  (dtype, "bf16", "bf16", "bf16")))
    want = gating_ffn_pallas(jx, *(j for j, _ in ws), interpret=True)
    got = _tensor_core_ffn(tx, *(t for _, t in ws))
    assert got.dtype == DTYPES[dtype][1] and tuple(got.shape) == (N, C)
    np.testing.assert_allclose(_np(got), _np(want), **CARD_TOL[dtype])


@pytest.mark.parametrize("N,C,H", TC_SHAPES)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_k5_tensor_core_rounding_matches_pallas(N, C, H, dtype):
    """K5's tensor-core rounding against ``gating_ffn_pallas_int8`` in
    interpret mode: exact bf16(x) . q products (hi + lo for an f32 x)
    summed in f32, the row scale applied to the row's sum where the Pallas
    body rounds float(q) * scale per element."""
    from rstnet_tpu.ops.pallas_ffn import gating_ffn_pallas_int8

    x = np.random.default_rng(N + C + H + 1).normal(size=(N, C))
    jx, tx = _both(x, dtype)
    q = [quantize_weight_int8(torch.from_numpy(w.astype(np.float32))) for w in _weights(C, H, 8)]
    args = [t for w in q for t in (w.w_int8.data, w.scale.data)]
    want = gating_ffn_pallas_int8(jx, *(jnp.asarray(a.numpy()) for a in args), interpret=True)
    got = _tensor_core_ffn(tx, *(w.w_int8.data.to(torch.bfloat16) for w in q),
                           scales=[w.scale.data.float() for w in q])
    assert got.dtype == DTYPES[dtype][1] and tuple(got.shape) == (N, C)
    np.testing.assert_allclose(_np(got), _np(want), **CARD_TOL[dtype])


def _f32_weight_products(a: torch.Tensor, w: torch.Tensor, lo: bool) -> torch.Tensor:
    """a [N, K] @ w [M, K]^T as K4's float32-weight route runs it: w as hi =
    bf16(w) and lo = bf16(w - hi), ``a`` as hi + lo if f32; hi . a_hi (+
    hi . a_lo), and with ``lo`` (an f32 x) lo . a_hi too; exact products,
    f32 sums."""
    w_hi, w_lo = _split_bf16(w)
    a_parts = _split_bf16(a) if a.dtype == torch.float32 else (a,)
    out = sum(p.float() @ w_hi.float().T for p in a_parts)
    return out + a_parts[0].float() @ w_lo.float().T if lo else out


def _f32_weight_ffn(x, w_gate, w_val, w_out):
    """K4's tensor-core route over float32 weights in plain torch: under an
    f32 x three products a weight (hi . x_hi + hi . x_lo + lo . x_hi), the
    hidden likewise in the down pass; under a bf16 x only bf16(w) enters,
    against x and against the hidden's hi + lo."""
    lo = x.dtype == torch.float32
    gate, val = (_f32_weight_products(x, w, lo) for w in (w_gate, w_val))
    hid = gate * torch.sigmoid(gate) * val
    return _f32_weight_products(hid, w_out, lo).to(x.dtype)


@pytest.mark.parametrize("N,C,H", TC_SHAPES)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_k4_f32_weight_route_rounding_matches_pallas(N, C, H, dtype):
    """The rounding of K4's float32-weight route against
    ``gating_ffn_pallas`` in interpret mode over float32 weights, fed as the
    port's function takes them: as they are under an f32 x, in x's dtype
    under a bf16 x (as ``gating_ffn_reference`` and the JAX ``linear`` take
    them; bf16(w) is exactly the route's hi). The split leaves ~2**-17 of
    each f32 operand out, inside the card tolerance."""
    from rstnet_tpu.ops.pallas_ffn import gating_ffn_pallas

    x = np.random.default_rng(N + C + H + 2).normal(size=(N, C))
    jx, tx = _both(x, dtype)
    ws = [_both(a, "f32") for a in _weights(C, H, 9)]
    want = gating_ffn_pallas(jx, *(j.astype(jx.dtype) for j, _ in ws), interpret=True)
    got = _f32_weight_ffn(tx, *(t for _, t in ws))
    assert got.dtype == DTYPES[dtype][1] and tuple(got.shape) == (N, C)
    np.testing.assert_allclose(_np(got), _np(want), **CARD_TOL[dtype])
