"""The port's training step (``rstnet_tpu_torch/training/train_step.py``)
against the JAX package's on the CPU, float32: the same params, the same
seeded batches.

Tolerances: loss and metrics 1e-5 relative (float32 sums in another order);
gradients 1e-5 of each leaf's largest magnitude. Parameters after AdamW
updates are held against the farthest the updates could move them (the sum
of the learning rates, Adam's step being at most ~1 lr per element): 99.9 %
of the elements within 1e-4 of it, every element within 5 %. Where a
gradient element is near eps, Adam's g / (|g| + eps) amplifies the float32
summation-order error of g (seen: g = 1.758e-8 vs 1.794e-8 on a leaf whose
largest gradient is 0.115, steps 0.637 vs 0.642 lr): about one element in
1e4 lands ~1 % of a step apart."""

import tests.test_torch_threads  # noqa: F401 - first: one torch CPU thread a process

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rstnet_tpu.core import flatten_dict
from rstnet_tpu.training import schedulers as jax_sched
from rstnet_tpu.training import train_step as jts
from rstnet_tpu_torch.core import stack_layers, tensor_to_numpy, to_numpy
from rstnet_tpu_torch.training import schedulers, train_step
from tests.test_torch_speech_lm import CFG, lm_pair, rand_sequence

AUDIO_IGNORE, TEXT_IGNORE = 47, 159
METRIC_RTOL = 1e-5
GRAD_RTOL = 1e-5
PARAM_STEP_FRACTION = 5e-2  # every element
PARAM_STEP_FRACTION_MOST = 1e-4  # 99.9 % of the elements


def make_batch(seed, B, S, lead=()):
    rng = np.random.default_rng(seed)
    shape = lead + (B,)
    tokens = np.stack([rand_sequence(seed + i, B, S, CFG)
                       for i in range(int(np.prod(lead)) if lead else 1)]).reshape(
        *shape, 9, S)
    tokens[..., 0, :][rng.random(tokens[..., 0, :].shape) < 0.2] = TEXT_IGNORE
    tokens[..., 1:, :][rng.random(tokens[..., 1:, :].shape) < 0.1] = AUDIO_IGNORE
    masks = rng.choice(np.array([0.0, 1.0, 1.0, 0.25], np.float32), tokens.shape)
    return tokens, masks


def _loss_fns(tm, jm):
    kw = dict(audio_ignore_id=AUDIO_IGNORE, text_ignore_id=TEXT_IGNORE)
    return train_step.make_loss_fn(tm, **kw), jts.make_loss_fn(jm, **kw)


def _torch_batch(tokens, masks):
    return {"tokens": torch.from_numpy(tokens), "masks": torch.from_numpy(masks)}


def _jax_batch(tokens, masks):
    return {"tokens": jnp.asarray(tokens), "masks": jnp.asarray(masks)}


def _assert_metrics(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k].detach()), float(want[k]), rtol=METRIC_RTOL,
                                   err_msg=k)


def _assert_params(tm, params, lr_sum: float):
    got = to_numpy(tm, stacked=tm.STACKED)
    diffs = []
    for k, w in flatten_dict(params):
        np.testing.assert_allclose(got[k], np.asarray(w), atol=PARAM_STEP_FRACTION * lr_sum,
                                   rtol=0, err_msg=k)
        diffs.append(np.abs(got[k] - np.asarray(w)).ravel())
    diffs = np.concatenate(diffs)
    assert np.mean(diffs <= PARAM_STEP_FRACTION_MOST * lr_sum) >= 0.999


def test_loss_and_metrics_match_make_loss_fn():
    jm, params, tm = lm_pair()
    tloss, jloss = _loss_fns(tm, jm)
    tokens, masks = make_batch(0, 3, 7)
    _, want = jloss(params, _jax_batch(tokens, masks))
    with torch.no_grad():
        _, got = tloss(_torch_batch(tokens, masks))
    _assert_metrics(got, want)


def test_gradients_match_jax_grad():
    jm, params, tm = lm_pair(remat=True)
    tloss, jloss = _loss_fns(tm, jm)
    tokens, masks = make_batch(1, 2, 6)
    (_, want_m), want = jax.value_and_grad(jloss, has_aux=True)(params, _jax_batch(tokens, masks))
    state = train_step.init_train_state(tm, train_step.make_optimizer(schedulers.constant_lr(0)))
    loss, got_m = tloss(_torch_batch(tokens, masks))
    loss.backward()
    _assert_metrics(got_m, want_m)
    got = stack_layers({n: tensor_to_numpy(p.grad) for n, p in state["model"].named_parameters()},
                       tm.STACKED)
    want = {k: np.asarray(v) for k, v in flatten_dict(want)}
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0, atol=GRAD_RTOL * max(1e-3, np.abs(w).max()),
                                   err_msg=k)


def test_adamw_steps_with_grad_accum_match_optax():
    """Three steps of AdamW under ``warmup_lr``, a global-norm clip that
    triggers, and ``grad_accum=2`` (a leading microbatch axis)."""
    jm, params, tm = lm_pair()
    tloss, jloss = _loss_fns(tm, jm)
    kw = dict(weight_decay=1e-2, grad_clip=0.5)
    jtx = jts.make_optimizer(jax_sched.warmup_lr(1e-3, 3), **kw)
    ttx = train_step.make_optimizer(schedulers.warmup_lr(1e-3, 3), **kw)
    jstate = jts.init_train_state(params, jtx)
    jstep = jts.make_train_step(jloss, jtx, grad_accum=2, donate=False)
    tstate = train_step.init_train_state(tm, ttx)
    tstep = train_step.make_train_step(tloss, ttx, grad_accum=2)
    for i in range(3):
        tokens, masks = make_batch(10 + i, 2, 6, lead=(2,))
        if i == 0:  # the clip must act for the test to hold it
            g = jax.grad(lambda p: jloss(p, _jax_batch(tokens[0], masks[0]))[0])(params)
            assert float(optax.global_norm(g)) > 0.5
        jstate, jmetrics = jstep(jstate, _jax_batch(tokens, masks))
        tstate, tmetrics = tstep(tstate, _torch_batch(tokens, masks))
        _assert_metrics(tmetrics, jmetrics)
    assert tstate["step"] == int(jstate["step"]) == 3
    assert tstate["opt_state"]["count"] == 3
    _assert_params(tm, jstate["params"], sum(schedulers.warmup_lr(1e-3, 3)(i) for i in range(3)))


def test_cross_batch_grad_accum_matches_jax():
    """The trainer's ``--grad_accum``: two batches of different lengths
    accumulated, then one update."""
    jm, params, tm = lm_pair()
    tloss, jloss = _loss_fns(tm, jm)
    jtx = jts.make_optimizer(jax_sched.warmup_lr(1e-3, 2))
    ttx = train_step.make_optimizer(schedulers.warmup_lr(1e-3, 2))
    jacc, japply = jts.make_grad_accum_steps(jloss, jtx)
    tacc, tapply = train_step.make_grad_accum_steps(tloss, ttx)
    jstate = jts.init_train_state(params, jtx)
    jstate["acc_grads"] = jax.tree.map(jnp.zeros_like, jstate["params"])
    jstate["micro"] = jnp.zeros((), jnp.int32)
    tstate = train_step.init_train_state(tm, ttx)
    for seed, S in ((20, 5), (21, 8)):
        tokens, masks = make_batch(seed, 2, S)
        jstate, jm_ = jacc(jstate, _jax_batch(tokens, masks))
        tstate, tm_ = tacc(tstate, _torch_batch(tokens, masks))
        _assert_metrics(tm_, jm_)
    jstate = japply(jstate)
    tstate = tapply(tstate)
    assert tstate["micro"] == 0 and tstate["step"] == 1
    _assert_params(tm, jstate["params"], schedulers.warmup_lr(1e-3, 2)(0))


@pytest.mark.parametrize("max_errors", [1, 2])
def test_apply_if_finite_matches_optax(max_errors):
    """Non-finite gradients are rejected (parameters and optimizer state as
    they were) until more than ``max_errors`` arrive in a row."""
    rng = np.random.default_rng(3)
    w0 = rng.standard_normal((3, 4)).astype(np.float32)
    grads = [rng.standard_normal((3, 4)).astype(np.float32) for _ in range(7)]
    for i in (1, 2, 3, 5):
        grads[i][0, 0] = np.nan if i % 2 else np.inf
    sched = dict(base_lr=1e-2, warmup_steps=2)
    jtx = jts.make_optimizer(jax_sched.warmup_lr(**sched), grad_clip=1.0,
                             skip_nonfinite=max_errors)
    ttx = train_step.make_optimizer(schedulers.warmup_lr(**sched), grad_clip=1.0,
                                    skip_nonfinite=max_errors)
    jparams = {"w": jnp.asarray(w0)}
    jstate = jtx.init(jparams)
    tparams = {"w": torch.from_numpy(w0.copy())}
    tstate = ttx.init(tparams)
    for g in grads:
        updates, jstate = jtx.update({"w": jnp.asarray(g)}, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        ttx.update({"w": torch.from_numpy(g)}, tstate, tparams)
        assert tstate["notfinite_count"] == int(jstate.notfinite_count)
        assert tstate["total_notfinite"] == int(jstate.total_notfinite)
        assert tstate["last_finite"] == bool(jstate.last_finite)
        np.testing.assert_allclose(tparams["w"].numpy(), np.asarray(jparams["w"]), atol=1e-7,
                                   equal_nan=True)


def test_eval_step_keeps_no_graph():
    jm, params, tm = lm_pair()
    tloss, jloss = _loss_fns(tm, jm)
    train_step.init_train_state(tm, train_step.make_optimizer(schedulers.constant_lr(0)))
    tokens, masks = make_batch(4, 2, 5)
    got = train_step.make_eval_step(tloss)(_torch_batch(tokens, masks))
    assert all(not v.requires_grad for v in got.values())
    _assert_metrics(got, jts.make_eval_step(jloss)(params, _jax_batch(tokens, masks)))


@pytest.mark.parametrize("step", [0, 1, 7, 4999, 5000, 123456])
def test_schedulers_match_jax(step):
    pairs = [(schedulers.warmup_lr(5e-5, 5000), jax_sched.warmup_lr(5e-5, 5000)),
             (schedulers.constant_lr(3e-4), jax_sched.constant_lr(3e-4)),
             (schedulers.exponential_decay_lr(1e-3, 0.9, 7),
              jax_sched.exponential_decay_lr(1e-3, 0.9, 7))]
    for mine, theirs in pairs:
        assert float(mine(step)) == float(theirs(step))
