"""The port's tensor-parallel serving frame (``LMGen.step`` over a
``SpeechTextLM`` placed by ``parallel/sharding.py::shard_params`` under
``set_mesh``) against the JAX package's one-device stream, the counterpart of
``tests/test_parallel.py::test_tensor_parallel_serving_frame_step``.

The LM is ``tests/test_speech_lm.py``'s tiny one from the JAX init, carried
across; greedy frames, float32, the flagship's delay pattern, 5 frames at
batch 2 and at batch 1. The meshes run as 4 gloo ranks on the CPU, started
once for the whole file (``tests/torch_parallel_ranks.py``):

* ``fsdp2tp2``: JAX's mesh, ``data`` 1 x ``fsdp`` 2 x ``tensor`` 2;
* ``dp2tp2``: ``data`` 2 x ``tensor`` 2;
* ``tp4``: ``tensor`` 4, where the 2 KV groups do not divide and every rank
  holds all heads (the QKV output gathered);
* ``dp2tp2_wide``: ``data`` 2 x ``tensor`` 2 at 128 wide with a 256 MLP, so
  that each rank's ``[128, 128]`` MLP shards lie in K4's envelope (its plain
  version here) and its partials are summed over ``tensor``.

Every rank's tokens must equal the JAX stream and the port's one-process
stream exactly; its hidden state and text logits lie within
``HIDDEN_LOGIT_TOL`` of the one-process values (float32 sums of the same
terms in another order). A frame after the first may move at most the
row-parallel sums, the embedding's sum and the logits' gather (and the QKV
output's gather where the groups do not divide): a step that gathers a
whole weight at every frame (``DTensor.full_tensor``) moves more.
"""

import tests.test_torch_threads  # noqa: F401 - first: one torch CPU thread a process

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rstnet_tpu.core import flatten_dict
from rstnet_tpu.inference.generate import LMGen as JaxGen
from rstnet_tpu.models.config import Config as JaxConfig
from rstnet_tpu.models.lm import SpeechTextLM as JaxLM
from rstnet_tpu_torch.inference.generate import LMGen
from tests.test_speech_lm import CFG
from tests.torch_parallel_ranks import _lm, run_ranks

WIDE = dict(CFG, n_embd=128, intermediate_size=256)
CASES = {
    "fsdp2tp2": (CFG, {"data": 1, "fsdp": 2, "tensor": 2}),
    "dp2tp2": (CFG, {"data": 2, "tensor": 2}),
    "tp4": (CFG, {"tensor": 4}),
    "dp2tp2_wide": (WIDE, {"data": 2, "tensor": 2}),
}
BATCHES = (2, 1)
N_FRAMES = 5
WORLD = 4
HIDDEN_LOGIT_TOL = 1e-5
RUNS = [f"{name}-B{B}" for name in CASES for B in BATCHES]


def _flat(cfg: dict) -> tuple:
    jm = JaxLM(JaxConfig(**cfg))
    params = jm.init(jax.random.PRNGKey(0))
    return jm, params, {k: np.array(v) for k, v in flatten_dict(params)}


@pytest.fixture(scope="module")
def models():
    return {id(cfg): _flat(cfg) for cfg in (CFG, WIDE)}


@pytest.fixture(scope="module")
def ranks(models, tmp_path_factory):
    cases = {name: (cfg, models[id(cfg)][2], shape) for name, (cfg, shape) in CASES.items()}
    return run_ranks(tmp_path_factory.mktemp("tp_serving"), WORLD, "tp_serving", timeout=240,
                     cases=cases, batches=BATCHES, n_frames=N_FRAMES)


@pytest.fixture(scope="module")
def references(models):
    """By run: (JAX one-device frames, the port's one-process frames,
    hidden states and text logits)."""
    out = {}
    for name, (cfg, _) in CASES.items():
        jm, params, flat = models[id(cfg)]
        delays = (0,) + (1,) * cfg["n_q"]
        jgen = JaxGen(jm, delays=delays, use_sampling=False)
        step = jax.jit(jgen.step)
        model = _lm(cfg, flat)
        seen = []
        real = model.step_global

        def step_global(*a, _real=real, **k):
            hidden, logits, state = _real(*a, **k)
            seen.append((hidden.numpy().copy(), logits.numpy().copy()))
            return hidden, logits, state

        model.step_global = step_global
        tgen = LMGen(model, delays=delays, use_sampling=False)
        for B in BATCHES:
            seen.clear()
            jstate, jframes = jgen.init_state(B, dtype=jnp.float32), []
            tstate, tframes = tgen.init_state(B, torch.float32), []
            with torch.no_grad():
                for _ in range(N_FRAMES):
                    jout, _, jstate = step(params, jstate, jax.random.PRNGKey(5))
                    jframes.append(np.asarray(jout))
                    tout, _, tstate = tgen.step(tstate, None)
                    tframes.append(tout.numpy().copy())
            out[f"{name}-B{B}"] = (jframes, tframes, [h for h, _ in seen],
                                   [lg for _, lg in seen])
    return out


def _runs(ranks, run):
    return [r[run] for r in ranks]


@pytest.mark.parametrize("run", RUNS)
def test_tokens_equal_jax_one_device_stream(ranks, references, run):
    jframes = references[run][0]
    for rank, got in enumerate(_runs(ranks, run)):
        for t, (a, b) in enumerate(zip(got["frames"], jframes)):
            np.testing.assert_array_equal(a, b, err_msg=f"rank {rank} frame {t}")


@pytest.mark.parametrize("run", RUNS)
def test_tokens_equal_one_process_stream(ranks, references, run):
    tframes = references[run][1]
    for rank, got in enumerate(_runs(ranks, run)):
        assert len(got["frames"]) == len(tframes) == N_FRAMES
        for t, (a, b) in enumerate(zip(got["frames"], tframes)):
            np.testing.assert_array_equal(a, b, err_msg=f"rank {rank} frame {t}")


@pytest.mark.parametrize("run", RUNS)
def test_hidden_and_logits_close_to_one_process(ranks, references, run):
    _, _, hidden, logits = references[run]
    for rank, got in enumerate(_runs(ranks, run)):
        for t in range(N_FRAMES):
            for what, a, b in (("hidden", got["hidden"][t], hidden[t]),
                               ("logits", got["logits"][t], logits[t])):
                assert a.shape == b.shape, (what, a.shape, b.shape)
                np.testing.assert_allclose(a, b, rtol=0, atol=HIDDEN_LOGIT_TOL,
                                           err_msg=f"rank {rank} frame {t} {what}")


@pytest.mark.parametrize("run", RUNS)
def test_step_scan_equals_step_under_the_mesh(ranks, run):
    for rank, got in enumerate(_runs(ranks, run)):
        np.testing.assert_array_equal(got["scan"], np.concatenate(got["frames"], axis=2),
                                      err_msg=f"rank {rank}")


def _frame_budget(cfg: dict, shape: dict, B: int) -> int:
    """Bytes a frame may move: float32 sums of [B, C] (the embedding, and
    attention's and the MLP's row-parallel outputs in every layer), the
    gathered [B, V] logits, and where T does not divide G the gathered QKV
    output of every layer."""
    T, G, C = shape["tensor"], cfg["n_query_groups"], cfg["n_embd"]
    qkv = (cfg["n_head"] + 2 * G) * (C // cfg["n_head"])
    per_layer = 2 * B * C + (B * qkv if G % T else 0)
    return 4 * (B * C + cfg["n_layer"] * per_layer + B * cfg["padded_vocab_size"])


@pytest.mark.parametrize("run", RUNS)
def test_frame_gathers_no_whole_weight(ranks, run):
    """After the first frame (FSDP2's one unshard and the depth side's one
    gather) a frame moves the row-parallel sums and the logits' gather, no
    more: a whole ``lm_head`` or ``wte`` alone is 160 x 32 x 4 bytes."""
    name, B = run.rsplit("-B", 1)
    cfg, shape = CASES[name]
    budget = _frame_budget(cfg, shape, int(B))
    for rank, got in enumerate(_runs(ranks, run)):
        for t, calls in enumerate(got["collectives"][1:], 1):
            moved = sum(b for _, b in calls)
            ops = {op for op, _ in calls}
            assert moved <= budget, (rank, t, moved, budget, calls)
            assert ops <= {"allreduce_", "allgather_"}, (rank, t, ops)
            assert any(op == "allgather_" for op in ops), (rank, t, ops)  # the logits


@pytest.mark.parametrize("name", list(CASES))
def test_ring_holds_this_ranks_kv_groups(ranks, name):
    cfg, shape = CASES[name]
    G, T = cfg["n_query_groups"], shape["tensor"]
    for got in ranks:
        for B in BATCHES:
            ring = got[f"{name}-B{B}"]["ring"]
            assert ring[1:3] == (B, G // T if G % T == 0 else G), ring


def test_captured_step_refuses_a_sharded_model(ranks):
    for got in ranks:
        for run in RUNS:
            refusal = got[run]["refusal"]
            assert refusal is not None and "CUDA graph" in refusal, refusal
