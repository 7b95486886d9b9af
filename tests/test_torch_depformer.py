"""K1, the depformer micro-step: the port's plain version (what the wrapper
runs on CPU tensors) against the Pallas kernel in interpret mode and its jnp
reference, on the Moshi layout that ``depformer_kernel_operands`` extracts.

Tolerance 2e-2 (relative and absolute), as the Pallas kernel's own
interpret-mode test: GEMV inputs are rounded to bf16 (normalized
activations, attention output, gated hidden), and one bf16 ulp of
difference there moves the float32 outputs by that much."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rstnet_tpu.core import flatten_dict
from rstnet_tpu.ops.pallas_depformer import (
    depformer_frame_reference,
    depformer_kernel_operands as jax_operands,
    depformer_step_pallas,
)
from rstnet_tpu_torch.core import from_jax_params
from rstnet_tpu_torch.ops.cuda_depformer import (
    _check_cuda_operands,
    depformer_kernel_operands,
    depformer_step,
)

TOL = dict(rtol=2e-2, atol=2e-2)
MOSHI = dict(delays=(0,) * 9, n_q=8, dep_q=8, card=128, text_card=64, dim=128, num_heads=2,
             num_layers=1, hidden_scale=2.0, context=16, depformer_dim=128,
             depformer_dim_feedforward=192, depformer_num_heads=2, depformer_num_layers=2)
NAMES = ("norm1", "in_proj", "out_proj", "norm2", "gin", "gout", "head_w", "head_b")


def _models(bias=False):
    from rstnet_tpu.models.moshi_lm import MoshiLMModel as JM
    from rstnet_tpu_torch.models.moshi_lm import MoshiLMModel

    cfg = dict(MOSHI, bias_proj=bias)
    jm = JM(**cfg)
    params = jm.init(jax.random.PRNGKey(0), jnp.bfloat16)
    if bias:
        params["linears"]["bias"] = 0.1 * jax.random.normal(
            jax.random.PRNGKey(9), params["linears"]["bias"].shape, jnp.bfloat16)
    flat = {k: np.asarray(v) for k, v in flatten_dict(params)}
    return jm, params, from_jax_params(flat, MoshiLMModel(**cfg, dtype=torch.bfloat16))


def _f32(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else a, np.float32)


@pytest.mark.parametrize("bias", [False, True])
def test_operands_match_jax(bias):
    jm, params, tm = _models(bias)
    jops, tops = jax_operands(jm, params), depformer_kernel_operands(tm)
    for k in ("heads", "eps", "L", "S", "C"):
        assert tops[k] == jops[k], k
    for k in NAMES:
        np.testing.assert_array_equal(_f32(tops[k]), _f32(jops[k]), err_msg=k)
    assert tops["norm1"].dtype == tops["head_b"].dtype == torch.float32


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_plain_micro_steps_match_pallas_interpret(cache_dtype):
    """A whole frame of 8 micro-steps, teacher-forced inputs, carrying the
    per-frame cache: logits and caches against the Pallas kernel and the jnp
    frame reference."""
    jm, params, tm = _models(bias=True)
    jops, tops = jax_operands(jm, params), depformer_kernel_operands(tm)
    L, S, C = jops["L"], jops["S"], jops["C"]
    x = np.random.default_rng(0).normal(size=(S, 1, C)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    jdt, tdt = getattr(jnp, cache_dtype), getattr(torch, cache_dtype)
    jkc = jvc = jnp.zeros((L, S, C), jdt)
    tkc, tvc = torch.zeros((L, S, C), dtype=tdt), torch.zeros((L, S, C), dtype=tdt)
    for cb in range(S):
        jl, jkc, jvc = depformer_step_pallas(
            xb[cb], jnp.int32(cb), *(jops[k] for k in NAMES), jkc, jvc, heads=jops["heads"],
            eps=jops["eps"], interpret=True)
        tl, tkc, tvc = depformer_step(
            torch.from_numpy(x[cb]).bfloat16(), cb,
            *(tops[k] for k in NAMES), tkc, tvc, heads=tops["heads"], eps=tops["eps"])
        assert tl.shape == (1, 128) and tl.dtype == torch.float32
        np.testing.assert_allclose(_f32(tl), _f32(jl), **TOL)
    np.testing.assert_allclose(_f32(tkc), _f32(jkc), **TOL)
    np.testing.assert_allclose(_f32(tvc), _f32(jvc), **TOL)
    ref, rkc, _ = depformer_frame_reference(jops, xb, jnp.zeros((L, S, C), jdt),
                                            jnp.zeros((L, S, C), jdt))
    np.testing.assert_allclose(_f32(tl), _f32(ref[-1]), **TOL)
    np.testing.assert_allclose(_f32(tkc), _f32(rkc), **TOL)


def test_plain_step_is_causal():
    """Cache rows past cb never reach step cb's logits."""
    _, _, tm = _models()
    ops = depformer_kernel_operands(tm)
    L, S, C = ops["L"], ops["S"], ops["C"]
    x = torch.randn((1, C), generator=torch.Generator().manual_seed(0)).bfloat16()
    args = [ops[k] for k in NAMES]
    clean = torch.zeros((L, S, C))
    dirty = clean.clone()
    dirty[:, 2:] = 37.0
    a, _, _ = depformer_step(x, 1, *args, clean, clean.clone(), heads=ops["heads"])
    b, _, _ = depformer_step(x, 1, *args, dirty, dirty.clone(), heads=ops["heads"])
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_operands_outside_envelope_are_refused():
    from rstnet_tpu_torch.models.moshi_lm import MoshiLMModel

    small = MoshiLMModel(**dict(MOSHI, depformer_dim=32, depformer_dim_feedforward=64))
    assert depformer_kernel_operands(small) is None  # C = 32 is not a multiple of 128
    unaligned = MoshiLMModel(**dict(MOSHI, depformer_dim_feedforward=128))
    assert depformer_kernel_operands(unaligned) is None  # H = 85


def test_cuda_operand_checks_raise_on_what_the_kernel_does_not_take():
    _, _, tm = _models()
    ops = depformer_kernel_operands(tm)
    L, S, C = ops["L"], ops["S"], ops["C"]
    kc = torch.zeros((L, S, C))
    args = [torch.zeros((1, C), dtype=torch.bfloat16), 0, *(ops[k] for k in NAMES), kc,
            kc.clone(), ops["heads"]]
    _check_cuda_operands(*args)  # the path's operands pass
    bad = list(args)
    bad[0] = args[0].float()  # x must be bf16
    with pytest.raises(ValueError):
        _check_cuda_operands(*bad)
    bad = list(args)
    bad[1] = S  # micro-step out of range
    with pytest.raises(ValueError):
        _check_cuda_operands(*bad)
    bad = list(args)
    bad[3] = ops["in_proj"].float()  # weights must be bf16
    with pytest.raises(ValueError):
        _check_cuda_operands(*bad)
    bad = list(args)
    bad[10] = kc.double()
    with pytest.raises(TypeError):
        _check_cuda_operands(*bad)
