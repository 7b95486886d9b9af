"""K6's plain versions (``rstnet_tpu_torch/ops/cuda_flash.py``,
``ops/flash_attention.py``) against the JAX package on the CPU.

The forward is held to jax's splash kernel run in interpret mode, as
``tests/test_flash_attention.py`` runs it, within that test's 2e-3 (splash
sums its blocks in its own order). Gradients through the port's autograd
function (the kernels' plain dQ and dK/dV) and through autograd of
``flash_attention_reference`` are held to ``jax.grad`` of the JAX masked
reference within 1e-4: float32 sums over 512 keys in another order; so is
the plain backward, with K/V at fewer heads than Q (GQA: the plain versions
repeat K/V, the kernels do not). The float32 kernels' scheme (every operand
split into bf16 hi and lo parts, three products hi.hi + hi.lo + lo.hi) is
emulated in plain PyTorch and held to JAX within SPLIT_TOL of each 64-row
tile's scale, the card's limit for those kernels. Inputs come from numpy
with a seed."""

import tests.test_torch_threads  # noqa: F401 - first: one torch CPU thread a process

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rstnet_tpu.ops.flash_attention as jax_flash
from rstnet_tpu_torch.ops import cuda_flash
from rstnet_tpu_torch.ops.flash_attention import (
    attention_window,
    flash_attention,
    flash_attention_reference,
    flash_qualifies,
)

SPLASH_TOL = 2e-3
GRAD_TOL = 1e-4
# the split-bf16 scheme against JAX's float32: ||got - want|| / ||want|| over
# every 64-row tile (cuda_flash.relative_error_by_tile) within 1e-4, the
# card's limit for the float32 kernels; the split drops ~2**-16 of each
# operand (lo.lo and lo's own rounding), where one bf16 product would read
# ~2e-3
SPLIT_TOL = 1e-4


def _inputs(seed, B, H, Hkv, T, D=64):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, T, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, T, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, T, D)).astype(np.float32)
    do = rng.standard_normal((B, H, T, D)).astype(np.float32)
    return q, k, v, do


def _jax_masked(q, k, v, context, scale):
    """The backbone's masked path for one attention call, with splash's
    pre-scale of q (``tests/test_flash_attention.py::_reference``)."""
    H, Hkv, T = q.shape[1], k.shape[1], q.shape[2]
    if Hkv != H:
        k, v = jnp.repeat(k, H // Hkv, axis=1), jnp.repeat(v, H // Hkv, axis=1)
    q = (q * scale).astype(q.dtype)
    logits = jnp.einsum("bhtd,bhsd->bhts", q, k, preferred_element_type=jnp.float32)
    pos = jnp.arange(T)
    delta = pos[:, None] - pos[None, :]
    mask = delta >= 0
    if context is not None:
        mask = mask & (delta < context)
    att = jax.nn.softmax(jnp.where(mask[None, None], logits, -jnp.inf), axis=-1)
    return jnp.einsum("bhts,bhsd->bhtd", att.astype(v.dtype), v)


@pytest.mark.parametrize("context,heads", [(None, (2, 2)), (256, (2, 2)), (None, (4, 2))])
def test_forward_matches_splash_interpret(context, heads):
    H, Hkv = heads
    q, k, v, _ = _inputs(0, 1, H, Hkv, 512)
    scale = 1.0 / math.sqrt(64)
    want = np.asarray(jax_flash.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                                context, scale, interpret=True))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = flash_attention(tq, tk, tv, context, scale)
    np.testing.assert_allclose(got.numpy(), want, atol=SPLASH_TOL, rtol=SPLASH_TOL)
    ref = flash_attention_reference(tq, tk, tv, context, scale)
    np.testing.assert_allclose(ref.numpy(), want, atol=SPLASH_TOL, rtol=SPLASH_TOL)


@pytest.mark.parametrize("context", [None, 256, 100])
def test_gradients_match_jax_grad(context):
    q, k, v, do = _inputs(1, 2, 4, 2, 512)
    scale = 1.0 / math.sqrt(64)

    def loss(q, k, v):
        return jnp.sum(_jax_masked(q, k, v, context, scale) * do)

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for fn in (flash_attention, flash_attention_reference):
        leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        out = fn(*leaves, context, scale)
        got = torch.autograd.grad(out, leaves, torch.from_numpy(do))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=GRAD_TOL, rtol=GRAD_TOL)


def test_plain_lse_and_delta():
    """The forward's log-sum-exp and the backward's delta = rowsum(dO * O),
    as the kernels write them, against JAX (K/V at half the query heads)."""
    q, k, v, do = _inputs(2, 1, 4, 2, 128)
    window = 40
    o, lse = cuda_flash.flash_attention_fwd(*map(torch.from_numpy, (q, k, v)), window)
    kr = np.repeat(k, 2, axis=1)
    logits = np.einsum("bhtd,bhsd->bhts", q, kr)
    delta_pos = np.arange(128)[:, None] - np.arange(128)[None, :]
    logits = np.where((delta_pos >= 0) & (delta_pos < window), logits, -np.inf)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jax.nn.logsumexp(logits, axis=-1)),
                               atol=1e-5, rtol=1e-5)
    *_, delta = cuda_flash.flash_attention_bwd(
        *map(torch.from_numpy, (q, k, v)), o, torch.from_numpy(do), lse, window)
    np.testing.assert_allclose(delta.numpy(), (do * o.numpy()).sum(-1), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("context,heads", [(None, (4, 1)), (256, (4, 2)), (100, (8, 2))])
def test_plain_backward_matches_jax_grad_with_gqa(context, heads):
    """``flash_attention_bwd_reference`` at Hkv < H (dK, dV summed over each
    group, at the KV heads) against ``jax.grad`` of the JAX masked reference
    on the same pre-scaled q."""
    H, Hkv = heads
    q, k, v, do = _inputs(6, 2, H, Hkv, 512)
    q = q * 0.125
    window = attention_window(512, context)

    def loss(q, k, v):
        return jnp.sum(_jax_masked(q, k, v, context, 1.0) * do)

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    o, lse = cuda_flash.flash_attention_fwd_reference(tq, tk, tv, window)
    *got, _ = cuda_flash.flash_attention_bwd_reference(tq, tk, tv, o, torch.from_numpy(do), lse,
                                                       window)
    assert got[1].shape == (2, Hkv, 512, 64) and got[2].shape == (2, Hkv, 512, 64)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=GRAD_TOL, rtol=GRAD_TOL)


def test_kernel_route_passes_kv_unrepeated(monkeypatch):
    """The route hands K/V to the wrappers at their own head count and gets
    dK/dV back there; only the plain versions repeat."""
    q, k, v, do = _inputs(7, 1, 4, 1, 512)
    seen = []
    fwd, bwd = cuda_flash.flash_attention_fwd, cuda_flash.flash_attention_bwd

    def spy(fn):
        def wrapped(q, k, v, *rest):
            seen.append((fn.__name__, k.shape[1], v.shape[1]))
            return fn(q, k, v, *rest)
        return wrapped

    monkeypatch.setattr(cuda_flash, "flash_attention_fwd", spy(fwd))
    monkeypatch.setattr(cuda_flash, "flash_attention_bwd", spy(bwd))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = flash_attention(*leaves, None, 0.125)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    assert seen == [("flash_attention_fwd", 1, 1), ("flash_attention_bwd", 1, 1)]
    assert grads[1].shape == grads[2].shape == (1, 1, 512, 64)


def test_bf16_plain_forward_close_to_splash():
    """bf16 inputs: the plain forward against splash in interpret mode on
    the same bf16 values, within one bf16 step (2**-7) of the output scale."""
    q, k, v, _ = _inputs(3, 1, 2, 2, 512)
    bf = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    want = np.asarray(jax_flash.flash_attention(*bf, 256, 0.125, interpret=True), np.float32)
    got = flash_attention(*[torch.from_numpy(np.asarray(a, np.float32)).bfloat16() for a in bf],
                          256, 0.125)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=2.0**-7 * max(1.0, float(np.abs(want).max())))


def test_flash_qualifies_predicate():
    """The JAX predicate with its TPU condition taken as met: the port's
    ``enabled`` carries the device condition instead."""
    cases = [(1024, 3000, None, True), (640, 3000, None, True), (1024, 3000, 50.0, True),
             (1024, 3000, None, False), (256, 3000, None, True), (512, None, None, True),
             (1536, 256, None, True)]
    orig = jax_flash.splash_available
    jax_flash.splash_available = lambda: True
    try:
        for case in cases:
            assert flash_qualifies(*case) == jax_flash.flash_qualifies(*case), case
    finally:
        jax_flash.splash_available = orig
    assert flash_qualifies(1024, 3000, None, True)
    assert not flash_qualifies(1000, 3000, None, True)  # the --max_length 1000 buckets


def test_attention_window():
    assert attention_window(1024, 3000) == 1024  # causal: splash's CausalMask
    assert attention_window(1024, None) == 1024
    assert attention_window(1024, 256) == 256  # LocalMask window (255, 0)


def test_relative_error_by_tile_sees_small_outputs():
    """The card checks' measure: bf16 rounding of a causal O reads well
    under their 1e-2 limit, and one late tile wrong by 10 % reads far over
    it in that tile (not over the whole tensor), where a limit of 2e-2 x
    max |O| would let it pass."""
    q, k, v, _ = _inputs(5, 1, 2, 2, 1024)
    o, _ = cuda_flash.flash_attention_fwd(*map(torch.from_numpy, (q * 0.125, k, v)), 1024)
    whole, tile = cuda_flash.relative_error_by_tile(o.bfloat16(), o)
    assert whole < 3e-3 and tile < 3e-3
    bad = o.clone()
    bad[0, 1, 960:1024] *= 1.1
    assert float((bad - o).abs().max()) < 2e-2 * float(o.abs().max())
    whole, tile = cuda_flash.relative_error_by_tile(bad, o)
    assert tile > 5e-2 and whole < 1e-2


def test_wrappers_take_the_plain_version_only_on_cpu():
    """A tensor on another device gets the kernel or an error, never the
    plain version."""
    x = torch.zeros((1, 1, 128, 64), device="meta")
    with pytest.raises(NotImplementedError):
        cuda_flash.flash_attention_fwd(x, x, x, 64)
    with pytest.raises(NotImplementedError):
        cuda_flash.flash_attention_bwd(x, x, x, x, x, torch.zeros((1, 1, 128), device="meta"), 64)
    fns = (cuda_flash.flash_attention_fwd, cuda_flash.flash_attention_bwd)
    before = [(f.launches, f.launches_f32) for f in fns]
    t = [torch.zeros((1, 2, 128, 64)) for _ in range(5)]
    o, lse = cuda_flash.flash_attention_fwd(t[0], t[1][:, :1], t[2][:, :1], 64)
    cuda_flash.flash_attention_bwd(t[0], t[1][:, :1], t[2][:, :1], o, t[3], lse, 64)
    assert [(f.launches, f.launches_f32) for f in fns] == before  # the plain versions count none


def test_split_hi_lo_reference():
    """hi is x rounded to the nearest bf16 (ties to even, from the bits),
    lo is x - hi rounded to bf16, and x - hi - lo is within 2**-16 |x|
    (lo's own rounding, 2**-9 of |x - hi| <= 2**-9 |x|, bounds it by
    2**-18 |x|)."""
    rng = np.random.default_rng(11)
    x = (rng.standard_normal(4096) * 10.0 ** rng.uniform(-6, 6, 4096)).astype(np.float32)
    u = x.view(np.uint32).astype(np.uint64)
    want_hi = (((u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000).astype(np.uint32)).view(np.float32)
    hi, lo = cuda_flash.split_hi_lo_reference(torch.from_numpy(x))
    assert hi.dtype == lo.dtype == torch.bfloat16
    np.testing.assert_array_equal(hi.float().numpy(), want_hi)
    np.testing.assert_array_equal(lo.float().numpy(),
                                  torch.from_numpy(x - want_hi).bfloat16().float().numpy())
    rest = x.astype(np.float64) - hi.double().numpy() - lo.double().numpy()
    assert np.all(np.abs(rest) <= 2.0**-16 * np.abs(x.astype(np.float64)))


def _split_mm(a, b):
    """a @ b as the float32 kernels form it: both operands split, three bf16
    products (exact in float32) summed in float32."""
    (ah, al), (bh, bl) = ([t.float() for t in cuda_flash.split_hi_lo_reference(x)]
                          for x in (a, b))
    return ah @ bh + ah @ bl + al @ bh


def _split_scheme(q, k, v, do, window):
    """The float32 kernels' arithmetic in plain PyTorch (q pre-scaled, K/V
    at q's heads): S = Q K^T and P V on split operands, P unnormalized
    (exp(S - rowmax)) when split as the forward's online softmax splits it;
    then the backward's five products on split operands. -> o, (dq, dk,
    dv), dk and dv still at q's heads."""
    pos = torch.arange(q.shape[2])
    delta_pos = pos[:, None] - pos[None, :]
    visible = (delta_pos >= 0) & (delta_pos < window)
    s = _split_mm(q, k.transpose(-1, -2)).masked_fill(~visible, float("-inf"))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    o = _split_mm(p, v) / l
    lse = m + torch.log(l)
    p = torch.exp(s - lse)
    delta = (do * o).sum(-1, keepdim=True)
    ds = p * (_split_mm(do, v.transpose(-1, -2)) - delta)
    grads = (_split_mm(ds, k), _split_mm(ds.transpose(-1, -2), q),
             _split_mm(p.transpose(-1, -2), do))
    return o, grads


@pytest.mark.parametrize("context", [None, 100])
def test_split_scheme_forward_matches_splash(context):
    """The emulated float32 forward against jax's splash kernel in interpret
    mode (float32), T=512, GQA 4:1, within SPLIT_TOL of every tile."""
    q, k, v, do = _inputs(12, 1, 4, 1, 512)
    q = q * 0.125  # pre-scaled, as the route hands it to the kernels
    want = np.asarray(jax_flash.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                                context, 1.0, interpret=True))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    kr, vr = cuda_flash.repeat_kv(tq, tk, tv)
    o, _ = _split_scheme(tq, kr, vr, torch.from_numpy(do), attention_window(512, context))
    assert max(cuda_flash.relative_error_by_tile(o, torch.from_numpy(want))) <= SPLIT_TOL


@pytest.mark.parametrize("context", [None, 100])
def test_split_scheme_gradients_match_jax_grad(context):
    """The emulated float32 backward (dK and dV summed over the group)
    against ``jax.grad`` of the JAX masked reference, run as
    ``test_gradients_match_jax_grad`` runs it, T=512, GQA 4:1, within
    SPLIT_TOL of every tile."""
    q, k, v, do = _inputs(13, 1, 4, 1, 512)
    q = q * 0.125

    def loss(q, k, v):
        return jnp.sum(_jax_masked(q, k, v, context, 1.0) * do)

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    kr, vr = cuda_flash.repeat_kv(tq, tk, tv)
    _, (dq, dk, dv) = _split_scheme(tq, kr, vr, torch.from_numpy(do),
                                    attention_window(512, context))
    dk, dv = (t.reshape(1, 1, 4, 512, 64).sum(2) for t in (dk, dv))
    for got, w in zip((dq, dk, dv), want):
        assert max(cuda_flash.relative_error_by_tile(got, torch.from_numpy(np.asarray(w)))) \
            <= SPLIT_TOL


@pytest.mark.parametrize("context,heads", [(None, (7, 1)), (256, (4, 2))])
def test_head_dim_128_matches_splash_and_jax_grad(context, heads):
    """Head dim 128 (the flagship's Qwen2.5-7B: GQA 7:1): the route's
    forward against splash in interpret mode, and its gradients (the plain
    backward on the CPU) against ``jax.grad`` of the masked reference."""
    H, Hkv = heads
    q, k, v, do = _inputs(7, 1, H, Hkv, 512, D=128)
    scale = 1.0 / math.sqrt(128)
    want = np.asarray(jax_flash.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                                context, scale, interpret=True))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    got = flash_attention(*leaves, context, scale)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=SPLASH_TOL, rtol=SPLASH_TOL)

    def loss(q, k, v):
        return jnp.sum(_jax_masked(q, k, v, context, scale) * do)

    want_grads = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    got_grads = torch.autograd.grad(got, leaves, torch.from_numpy(do))
    assert got_grads[1].shape == (1, Hkv, 512, 128)
    for g, w in zip(got_grads, want_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=GRAD_TOL, rtol=GRAD_TOL)


def test_wrappers_refuse_other_head_dims():
    """The kernels take head dims 64 and 128 only: any other D is refused
    on a CUDA tensor before anything launches, never sent to the plain
    version (the envelope check, reached here without a card)."""
    for D in (96, 32, 256):
        x = torch.zeros((1, 2, 128, D))
        with pytest.raises(ValueError, match="envelope"):
            cuda_flash._check_cuda_operands(128, x, kv=(x, x))
    for D in cuda_flash.HEAD_DIMS:
        x = torch.zeros((1, 2, 128, D))
        assert cuda_flash._check_cuda_operands(128, x, kv=(x, x)) == (1, 2, 2, 128)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _d128_backward_scheme(q, k, v, do, window):
    """The bf16 backward at head dim 128 (``flash_bwd_wgmma<128>``) in plain
    PyTorch, on bf16 values held in float32 (q pre-scaled, K/V at their own
    heads): O as the forward kernel hands it over (P rounded to bf16 before
    P V, O rounded to bf16); delta = rowsum(dO * O) and the products S^T,
    dP^T in float32; P^T and dS^T rounded to bf16 before the products that
    read them; dV and dK summed over the group in float32 and rounded; the
    dQ partials dS K over each 128-key tile summed in float32 in key-tile
    order, then rounded. -> (dq, dk, dv)."""
    kr, vr = cuda_flash.repeat_kv(q, k, v)
    s = cuda_flash.masked_logits(q, kr, window)
    lse = torch.logsumexp(s, dim=-1, keepdim=True)
    o = _bf16(_bf16(torch.softmax(s, dim=-1)) @ vr)
    delta = (do * o).sum(-1, keepdim=True)
    p = torch.exp(s - lse)
    ds = p * (do @ vr.transpose(-1, -2) - delta)
    p16, ds16 = _bf16(p), _bf16(ds)
    B, H, T, D = q.shape
    Hkv = k.shape[1]
    dv = (p16.transpose(-1, -2) @ do).reshape(B, Hkv, H // Hkv, T, D).sum(2)
    dk = (ds16.transpose(-1, -2) @ q).reshape(B, Hkv, H // Hkv, T, D).sum(2)
    keys = cuda_flash.SEQ_TILE  # a work item's key tile
    dq = torch.zeros_like(q)
    for j in range(T // keys):
        tile = slice(j * keys, (j + 1) * keys)
        dq = dq + ds16[..., tile] @ kr[..., tile, :]
    return _bf16(dq), _bf16(dk), _bf16(dv)


@pytest.mark.parametrize("context", [None, 100])
def test_head_dim_128_bf16_backward_scheme_matches_splash_grad(context):
    """The bf16 backward's arithmetic at head dim 128, emulated in plain
    PyTorch (``_d128_backward_scheme``), against ``jax.grad`` of jax's
    splash kernel in interpret mode, T=512, GQA 7:1, causal and window 100,
    within 1e-2 of every 64-row tile's scale (cuda_flash.relative_error_by_tile,
    the card's limit for the bf16 kernels). Each pair's S^T and dP^T are
    formed once over all 128 columns; the design rounds exactly where the
    earlier design's column-half items did (P^T and dS^T to bf16 before the
    products, dQ's float32 partials over 128-key tiles summed in key-tile
    order), so the emulation is that of both."""
    q, k, v, do = _inputs(19, 1, 7, 1, 512, D=128)
    q, k, v, do = (_bf16(torch.from_numpy(a)) for a in (q * 128**-0.5, k, v, do))
    window = attention_window(512, context)
    got = _d128_backward_scheme(q, k, v, do, window)

    def loss(q, k, v):
        return jnp.sum(jax_flash.flash_attention(q, k, v, context, 1.0, interpret=True)
                       * jnp.asarray(do.numpy()))

    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(t.numpy()) for t in (q, k, v)))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert max(cuda_flash.relative_error_by_tile(g, torch.from_numpy(np.array(w)))) <= 1e-2
