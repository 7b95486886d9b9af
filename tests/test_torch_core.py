"""The PyTorch port's scaffold: the numpy param bridge, param-tree naming
against the JAX pytrees, and that the port never imports JAX."""

import tests.test_torch_threads  # noqa: F401 - first: one torch CPU thread a process

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from rstnet_tpu.core import flatten_dict
from rstnet_tpu_torch.core import from_jax_params, to_numpy


def _flat(params):
    return {k: np.asarray(v) for k, v in flatten_dict(params)}


def test_bridge_bf16_round_trip_is_bit_exact():
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2**16, size=(7, 5), dtype=np.uint16)
    bits[0, :4] = [0x7F80, 0xFF80, 0x7FC1, 0x0001]  # inf, -inf, a NaN payload, a subnormal
    arr = bits.view(ml_dtypes.bfloat16)
    m = torch.nn.Module()
    m.register_parameter("w", torch.nn.Parameter(torch.zeros(7, 5, dtype=torch.bfloat16),
                                                 requires_grad=False))
    from_jax_params({"w": arr}, m)
    back = to_numpy(m)["w"]
    assert back.dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(back.view(np.uint16), bits)


def test_bridge_carries_jax_bf16_params():
    from rstnet_tpu.modules.transformer import StreamingTransformer as JT
    from rstnet_tpu_torch.modules.transformer import StreamingTransformer as TT

    cfg = dict(d_model=16, num_heads=2, num_layers=2, dim_feedforward=32, gating="silu",
               norm="rms_norm_f32", causal=True, context=8, positional_embedding="rope")
    params = JT(**cfg).init(jax.random.PRNGKey(0), jnp.bfloat16)
    flat = _flat(params)
    mod = from_jax_params(flat, TT(**cfg, dtype=torch.bfloat16))
    back = to_numpy(mod)
    assert set(back) == set(flat)
    for k in flat:
        assert back[k].dtype == flat[k].dtype, k
        np.testing.assert_array_equal(back[k].view(np.uint8), flat[k].view(np.uint8))


def test_bridge_rejects_mismatched_trees():
    m = torch.nn.Module()
    m.register_parameter("w", torch.nn.Parameter(torch.zeros(3), requires_grad=False))
    with pytest.raises(KeyError):
        from_jax_params({"v": np.zeros(3, np.float32)}, m)
    with pytest.raises(ValueError):
        from_jax_params({"w": np.zeros(4, np.float32)}, m)
    with pytest.raises(ValueError):
        from_jax_params({"w": np.zeros(3, np.float64)}, m)


@pytest.mark.parametrize("which", ["mimi_tiny", "moshi_small"])
def test_state_dict_keys_and_shapes_match_jax_pytrees(which):
    """state_dict() keys are the JAX pytree paths, with the same shapes and
    dtypes, so the bridge is a key-by-key copy."""
    if which == "mimi_tiny":
        from rstnet_tpu.models.mimi import mimi_24k as jax_mimi
        from rstnet_tpu_torch.models.mimi import mimi_24k as torch_mimi

        kw = dict(n_q_total=8, dimension=64, n_filters=8, num_layers=2, quantizer_dim=32,
                  bins=64)
        params, mod = jax_mimi(**kw).init(jax.random.PRNGKey(0)), torch_mimi(**kw)
    else:
        from rstnet_tpu.models.moshi_lm import MoshiLMModel as JM
        from rstnet_tpu_torch.models.moshi_lm import MoshiLMModel as TM

        kw = dict(delays=(0,) * 17, n_q=16, dep_q=8, card=128, text_card=64, dim=64,
                  num_heads=4, num_layers=2, context=16, depformer_dim=128,
                  depformer_dim_feedforward=192, depformer_num_heads=2,
                  depformer_num_layers=2, bias_proj=True)
        params, mod = JM(**kw).init(jax.random.PRNGKey(0), jnp.bfloat16), TM(
            **kw, dtype=torch.bfloat16)
    flat = _flat(params)
    own = to_numpy(mod)
    assert sorted(own) == sorted(flat)
    for k, v in flat.items():
        assert own[k].shape == v.shape and own[k].dtype == v.dtype, k


def test_port_imports_no_jax():
    """Importing every module of the port leaves jax out of sys.modules."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import rstnet_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(rstnet_tpu_torch.__path__, 'rstnet_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib')))\n"
        "assert len(names) >= 20, names\n"
        "assert not bad, bad\n"
        "jax_pkg = sorted(m for m in sys.modules if m.split('.')[0] == 'rstnet_tpu')\n"
        "assert not jax_pkg, jax_pkg\n"
        "print(len(names))\n"
    )
    # the JAX package imports jax when this is set; the port must not reach it
    env = {**os.environ, "RSTNET_PLATFORM": "cpu"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=Path(__file__).resolve().parents[1], timeout=120)
    assert res.returncode == 0, res.stderr
