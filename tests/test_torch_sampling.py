"""The port's token sampling (``rstnet_tpu_torch/ops/sampling.py``) against
the JAX package's, mirroring ``tests/test_sampling.py``.

A ``jax.random`` draw cannot be reproduced in torch, so each case holds the
port to JAX on a shared draw: greedy, or the same Gumbel noise on both
sides (``jax.random.categorical`` takes ``argmax(logits + gumbel(key))``;
the port's categorical draw is given that noise in place of its own). The
tokens must then be EQUAL. Each case also runs the port on its own
``torch.Generator`` and makes the JAX test's statistical check, with its
thresholds."""

import tests.test_torch_threads  # noqa: F401 - first: one torch CPU thread a process

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rstnet_tpu.ops.sampling import sample_token as jax_sample_token
from rstnet_tpu.ops.sampling import sample_top_k, sample_top_p
from rstnet_tpu_torch.ops import sampling
from rstnet_tpu_torch.ops.sampling import sample_token


@pytest.fixture()
def shared_noise(monkeypatch):
    """``use(keys, card)``: the port's next categorical draws add JAX's
    Gumbel noise of ``keys`` (one row a key) instead of its own."""
    state = {}

    def categorical(logits, generator):
        noise = state["noise"][:, : logits.shape[-1]].reshape(logits.shape)
        return torch.argmax(logits + noise, dim=-1)

    def use(keys, card):
        g = jax.vmap(lambda k: jax.random.gumbel(k, (card,), jnp.float32))(keys)
        state["noise"] = torch.from_numpy(np.array(g))

    monkeypatch.setattr(sampling, "_categorical", categorical)
    return use


def _draws(logits: torch.Tensor, n: int, seed: int, **kw) -> np.ndarray:
    g = torch.Generator().manual_seed(seed)
    return sample_token(logits.expand(n, -1), g, **kw).numpy()


def test_multinomial_distribution(shared_noise):
    ps = np.asarray([5.0, 2.0, 12.0, 6.0, 8.0, 1.0, 0.0, 4.0], np.float32)
    logits = np.log(np.maximum(ps, 1e-9))
    keys = jax.random.split(jax.random.PRNGKey(1234), 2000)
    want = jax.vmap(lambda k: jax_sample_token(k, jnp.asarray(logits), True, 1.0))(keys)
    shared_noise(keys, 8)
    got = sample_token(torch.from_numpy(logits).expand(2000, -1), None, True, 1.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert np.bincount(got.numpy(), minlength=8)[6] == 0


def test_multinomial_distribution_own_draws():
    ps = np.asarray([5.0, 2.0, 12.0, 6.0, 8.0, 1.0, 0.0, 4.0], np.float32)
    logits = torch.from_numpy(np.log(np.maximum(ps, 1e-9)))[None]
    toks = _draws(logits, 2000, seed=1234, use_sampling=True, temp=1.0)
    counts = np.bincount(toks, minlength=8)
    emp = counts / counts.sum()
    assert np.abs(emp - ps / ps.sum()).max() < 1.5e-2
    assert counts[6] == 0  # a zero-probability token is never sampled


def test_top_k_restricts_support(shared_noise):
    probs = np.asarray([[0.4, 0.3, 0.2, 0.05, 0.03, 0.02]], np.float32)
    keys = jax.random.split(jax.random.PRNGKey(0), 500)
    want = jax.vmap(lambda k: sample_top_k(k, jnp.asarray(probs), 2, approx=False))(keys)
    shared_noise(keys, 2)
    logits = torch.log(torch.from_numpy(probs)).expand(500, -1)
    got = sample_token(logits, None, True, 1.0, top_k=2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).ravel())
    assert set(got.tolist()) <= {0, 1}
    own = _draws(torch.log(torch.from_numpy(probs)), 500, seed=0, top_k=2)
    assert set(own.tolist()) <= {0, 1}


def test_top_p_restricts_support(shared_noise):
    probs = np.asarray([[0.5, 0.3, 0.1, 0.05, 0.05]], np.float32)
    keys = jax.random.split(jax.random.PRNGKey(0), 500)
    want = jax.vmap(lambda k: sample_top_p(k, jnp.asarray(probs), 0.8))(keys)
    shared_noise(keys, 5)
    logits = torch.log(torch.from_numpy(probs)).expand(500, -1)
    got = sample_token(logits, None, True, 1.0, top_p=0.8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).ravel())
    # nucleus: cumsum - p_i <= 0.8 keeps {0, 1, 2}
    assert set(got.tolist()) <= {0, 1, 2}
    own = _draws(torch.log(torch.from_numpy(probs)), 500, seed=0, top_p=0.8)
    assert set(own.tolist()) <= {0, 1, 2}


def test_greedy_and_max_card():
    logits = np.asarray([[1.0, 5.0, 3.0, 9.0]], np.float32)
    for max_card, want in ((None, 3), (3, 1)):  # id 3 banned -> argmax over the first 3
        tok = sample_token(torch.from_numpy(logits), None, use_sampling=False, max_card=max_card)
        jtok = jax_sample_token(jax.random.PRNGKey(0), jnp.asarray(logits), use_sampling=False,
                                max_card=max_card)
        assert int(tok[0]) == int(jtok[0]) == want


def test_temperature_sharpens(shared_noise):
    logits = np.asarray([2.0, 1.0, 0.0], np.float32)
    keys = jax.random.split(jax.random.PRNGKey(7), 1000)
    fracs = []
    for temp in (0.1, 5.0):
        want = jax.vmap(lambda k: jax_sample_token(k, jnp.asarray(logits), True, temp))(keys)
        shared_noise(keys, 3)
        got = sample_token(torch.from_numpy(logits).expand(1000, -1), None, True, temp)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        fracs.append(float(np.mean(got.numpy() == 0)))
    assert fracs[0] > 0.95 and fracs[1] < 0.6


def test_temperature_sharpens_own_draws():
    logits = torch.tensor([[2.0, 1.0, 0.0]])
    cold = _draws(logits, 1000, seed=7, temp=0.1)
    hot = _draws(logits, 1000, seed=7, temp=5.0)
    assert float(np.mean(cold == 0)) > 0.95
    assert float(np.mean(hot == 0)) < 0.6
