"""Batched multi-session serving in the PyTorch port: Mimi's slot resets and
per-slot session age against the JAX package, ``SessionBatcher._fused_step``
against the JAX batcher on the same weights, the JAX batcher and server
tests mirrored (``tests/test_server.py``), LMGen's slot isolation mirrored
(``tests/test_generate.py``), and the solo server's ``/api/stats``.

The models are small: the JAX tests' Mimi (frame 24 samples, 4 codebooks of
16, random codebooks so that codes are not all ties) and a Moshi LM whose
depformer is 128 wide with a gating hidden dim of 128, so that every
batched micro-step's FFN goes through K2's wrapper (its plain version on
the CPU); for the fused step also a ``SpeechTextLM`` (4 codebooks, no user
streams) whose backbone MLP is on K4's route (n_embd 256, MLP 512).
Everything is float32 and greedy. Tolerances: codes and tokens equal;
audio within 1e-5 (float32 rounding in other summation orders; the
measured gap is ~1e-7)."""

import tests.test_torch_threads  # noqa: F401 - first: one torch CPU thread a process

import asyncio
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rstnet_tpu.core import flatten_dict
from rstnet_tpu_torch.core import from_jax_params
from rstnet_tpu_torch.serving.opus import float_to_pcm16, pcm16_to_float
from rstnet_tpu_torch.serving.server import TAG_AUDIO
from tests.test_mimi import SEANET

AUDIO_TOL = 1e-5
FRAME = 24
MOSHI = dict(delays=(0,) + (1,) * 8, n_q=8, dep_q=4, card=16, text_card=64, dim=32,
             num_heads=4, num_layers=2, hidden_scale=4.0, context=16,
             existing_text_padding_id=3, depformer_dim=128, depformer_dim_feedforward=192,
             depformer_num_heads=2, depformer_num_layers=1)


def _load(params, module):
    return from_jax_params({k: np.asarray(v) for k, v in flatten_dict(params)}, module)


def _port_mimi():
    from rstnet_tpu_torch.models.mimi import MimiModel
    from rstnet_tpu_torch.modules.seanet import SEANetDecoder, SEANetEncoder
    from rstnet_tpu_torch.modules.transformer import ProjectedTransformer, StreamingTransformer
    from rstnet_tpu_torch.quantization.rvq import SplitResidualVectorQuantizer

    def projected():
        return ProjectedTransformer(StreamingTransformer(
            d_model=64, num_heads=4, num_layers=2, dim_feedforward=128, causal=True, context=8,
            gating="none", norm="layer_norm", positional_embedding="rope", layer_scale=0.01),
            64, (64,), conv_layout=True)

    return MimiModel(
        SEANetEncoder(**SEANET), SEANetDecoder(**SEANET), projected(), projected(),
        SplitResidualVectorQuantizer(dimension=32, input_dimension=64, output_dimension=64,
                                     n_q=4, n_q_semantic=1, bins=16),
        frame_rate=2.0, encoder_frame_rate=4.0, sample_rate=48, channels=1, causal=True,
        num_codebooks=4)


def _mimi_pair(seed=0):
    from tests.test_mimi import _my_model

    jm = _my_model()
    params = jm.init(jax.random.PRNGKey(seed))
    for i, name in enumerate(("rvq_first", "rvq_rest")):
        layers = params["quantizer"][name]["layers"]
        layers["embedding_sum"] = jax.random.normal(jax.random.PRNGKey(seed + 11 + i),
                                                    layers["embedding_sum"].shape)
    return jm, params, _load(params, _port_mimi())


def _lm_pair(**overrides):
    from rstnet_tpu.models.moshi_lm import MoshiLMModel as JM
    from rstnet_tpu_torch.models.moshi_lm import MoshiLMModel

    cfg = dict(MOSHI, **overrides)
    jm = JM(**cfg)
    params = jm.init(jax.random.PRNGKey(1))
    return jm, params, _load(params, MoshiLMModel(**cfg))


def _batcher(max_sessions=2, **kwargs):
    from rstnet_tpu_torch.inference.generate import LMGen
    from rstnet_tpu_torch.serving.batcher import SessionBatcher

    _, _, mimi = _mimi_pair()
    _, _, lm = _lm_pair()
    gen = LMGen(lm, delays=lm.delays, use_sampling=False)
    return SessionBatcher(mimi, gen, max_sessions=max_sessions, dtype=torch.float32, **kwargs)


def _run(coro):
    return asyncio.get_event_loop_policy().new_event_loop().run_until_complete(coro)


def _pcm(seed):
    return np.random.default_rng(seed).normal(0, 0.1, FRAME).astype(np.float32)


# -- Mimi and the fused step against the JAX package ---------------------------


def test_mimi_slot_resets_and_session_age_match_jax():
    """Three streams; slot 1 rejoins at frame 2: its conv carries reset and
    its session age floors the transformers' lookback. Codes equal and
    audio close to JAX every frame, and the reset rows are fresh."""
    jm, params, tm = _mimi_pair()
    B = 3
    x = np.random.default_rng(2).normal(0, 0.1, (6, B, 1, FRAME)).astype(np.float32)
    jenc, tenc = jm.init_encode_state(B), tm.init_encode_state(B)
    jdec, tdec = jm.init_decode_state(B), tm.init_decode_state(B)
    encode, decode = jax.jit(jm.encode_step), jax.jit(jm.decode_step)
    age = np.zeros(B, np.int64)
    for t in range(6):
        if t == 2:
            jenc, tenc = jm.reset_encode_slots(jenc, [1]), tm.reset_encode_slots(tenc, [1])
            jdec, tdec = jm.reset_decode_slots(jdec, [1]), tm.reset_decode_slots(tdec, [1])
            conv = tenc["encoder"]["layers"][0]
            assert not conv["buf"][1].any() and conv["buf"][0].any()
            age[1] = 0
        jcodes, jenc = encode(params, jenc, jnp.asarray(x[t]), jnp.asarray(age, jnp.int32))
        tcodes, tenc = tm.encode_step(tenc, torch.from_numpy(x[t]), torch.from_numpy(age))
        np.testing.assert_array_equal(tcodes.numpy(), np.asarray(jcodes))
        jaudio, jdec = decode(params, jdec, jcodes, jnp.asarray(age, jnp.int32))
        taudio, tdec = tm.decode_step(tdec, tcodes, torch.from_numpy(age))
        np.testing.assert_allclose(taudio.numpy(), np.asarray(jaudio), rtol=0, atol=AUDIO_TOL)
        age += 1


def _speech_pair():
    """A JAX and a port ``SpeechTextLM`` with the same params: 4 codebooks
    (Mimi's), backbone MLP widths on K4's route (C=256, H=512)."""
    from tests.test_torch_speech_lm import lm_pair

    return lm_pair(n_embd=256, intermediate_size=512, n_q=4, dep_q=4, audio_card=16, context=16)


@pytest.mark.parametrize("lm", ["moshi", "speech"])
def test_fused_step_matches_jax_batcher(monkeypatch, lm):
    """Both batchers, three slots, greedy, the same inputs through
    ``_device_step``: two sessions join at once, a third joins later, and
    one leaves and a new session takes its slot. Tokens of every active
    slot equal, audio of every valid frame within 1e-5. Each tick runs the
    fused FFN's wrapper at N = 3, the batch's width (every slot is computed,
    active or not): Moshi's K2 once per depformer layer and micro-step, the
    ``SpeechTextLM``'s K4 once per backbone layer."""
    import rstnet_tpu_torch.models.backbone as bmod
    import rstnet_tpu_torch.modules.transformer as tmod
    from rstnet_tpu.inference.generate import LMGen as JGen
    from rstnet_tpu.serving.batcher import SessionBatcher as JBatcher
    from rstnet_tpu_torch.inference.generate import LMGen
    from rstnet_tpu_torch.serving.batcher import SessionBatcher

    jmimi, mimi_params, tmimi = _mimi_pair()
    if lm == "moshi":
        jlm, lm_params, tlm = _lm_pair()
        delays = jlm.delays
        module, wrapper, per_tick = tmod, "gating_ffn_step", tlm.dep_q * tlm.depformer.num_layers
    else:
        jlm, lm_params, tlm = _speech_pair()
        delays = (0,) + (1,) * tlm.config.n_q
        module, wrapper, per_tick = bmod, "gating_ffn", tlm.config.n_layer
    jb = JBatcher(jmimi, mimi_params, JGen(jlm, delays=delays, use_sampling=False),
                  lm_params, max_sessions=3, dtype=jnp.float32)
    tb = SessionBatcher(tmimi, LMGen(tlm, delays=delays, use_sampling=False),
                        max_sessions=3, dtype=torch.float32)
    rows = []
    real = getattr(module, wrapper)
    monkeypatch.setattr(module, wrapper,
                        lambda *a, **k: rows.append(a[0].shape[0]) or real(*a, **k))

    async def run():
        jsess = {0: jb.acquire(), 1: jb.acquire()}
        tsess = {0: tb.acquire(), 1: tb.acquire()}
        rng = np.random.default_rng(4)
        n_valid = 0
        for t in range(7):
            if t == 2:
                jsess[2], tsess[2] = jb.acquire(), tb.acquire()
            if t == 4:
                jb.release(jsess[0])
                tb.release(tsess[0])
                jsess[0], tsess[0] = jb.acquire(), tb.acquire()
            assert {s.slot for s in tsess.values()} == {s.slot for s in jsess.values()}
            pcm = rng.normal(0, 0.1, (3, 1, FRAME)).astype(np.float32)
            jpcm, jsnap = jb._gather_inputs()
            tpcm, tsnap = tb._gather_inputs()
            jpcm[:], tpcm[:] = pcm, pcm
            rows.clear()
            _, jaudio, jout, jvalid = jb._device_step(jpcm, jsnap)
            _, taudio, tout, tvalid = tb._device_step(tpcm, tsnap)
            assert rows == [3] * per_tick
            np.testing.assert_array_equal(tvalid, jvalid)
            for slot in sorted(tsess):
                np.testing.assert_array_equal(tout[slot], np.asarray(jout)[slot])
                if tvalid[slot]:
                    n_valid += 1
                    np.testing.assert_allclose(taudio[slot], np.asarray(jaudio)[slot], rtol=0,
                                               atol=AUDIO_TOL)
        assert n_valid >= 12

    _run(run())


# -- the JAX batcher and server tests, mirrored --------------------------------


def test_batched_server_two_concurrent_sessions():
    """Two websocket clients share one batched frame step; both receive
    audio frames in real time and the slots are freed after."""
    from aiohttp.test_utils import TestClient, TestServer

    from rstnet_tpu_torch.serving.server import build_batched_app

    batcher = _batcher(max_sessions=3)
    batcher.warmup()
    app = build_batched_app(batcher)

    async def one_client(client, seed, n_frames=3):
        ws = await client.ws_connect("/api/chat")
        rng = np.random.default_rng(seed)
        for _ in range(n_frames):
            await ws.send_bytes(TAG_AUDIO + float_to_pcm16(rng.normal(0, 0.1, FRAME)))
        got_audio = []
        for _ in range(20):
            msg = await asyncio.wait_for(ws.receive(), timeout=30)
            if msg.type.name != "BINARY":
                break
            data = bytes(msg.data)
            if data[:1] == TAG_AUDIO:
                got_audio.append(pcm16_to_float(data[1:]))
            if len(got_audio) >= n_frames:
                break
        await ws.close()
        return got_audio

    async def run():
        async with TestClient(TestServer(app)) as client:
            a, b = await asyncio.gather(one_client(client, 0), one_client(client, 1))
            stats = await (await client.get("/api/stats")).json()
            return a, b, stats

    a, b, stats = _run(run())
    assert len(a) == 3 and len(b) == 3
    assert all(x.shape == (FRAME,) for x in a + b)
    assert len(batcher.sessions) == 0 and sorted(batcher._free) == [0, 1, 2]
    assert stats["pipeline_depth"] == 1 and stats["n_frames"] >= 3
    assert stats["delivery"]["n_frames"] == stats["n_frames"]  # warmup frames left out
    assert {"active_sessions", "fetch_pool", "async_fetch", "delivery"} <= stats.keys()


def test_batched_audio_matches_solo_with_delays():
    """The batched pipeline must not let LM delay-warmup frames advance a
    slot's decoder state: a batched session's audio equals the solo loop
    that skips decode on invalid frames."""
    batcher = _batcher()
    mimi, gen = batcher.mimi, batcher.lm_gen
    pcm = np.zeros((FRAME,), np.float32)
    es, ds = mimi.init_encode_state(1), mimi.init_decode_state(1)
    ls = gen.init_state(1, dtype=torch.float32)
    solo = []
    with torch.no_grad():
        for _ in range(5):
            codes, es = mimi.encode_step(es, torch.from_numpy(pcm).reshape(1, 1, -1))
            out, valid, ls = gen.step(ls, None, codes[:, : gen.num_user_streams, :])
            if bool(valid[0]):
                audio, ds = mimi.decode_step(ds, out[:, 1:, :])
                solo.append(audio[0, 0].numpy())
    sess = batcher.acquire()
    for _ in range(5):
        sess.inputs.put_nowait(pcm)
        batcher.step_once()
    got = []
    while not sess.outputs.empty():
        got.append(sess.outputs.get_nowait()[0])
    assert len(got) == len(solo) == 4
    for g, w in zip(got, solo):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)


def test_batcher_fetch_modes_and_killswitches(monkeypatch):
    """At depth 2: the fetch pool (default: the depth; the env sets its size
    or turns it off) and the copy to pinned memory at dispatch (the env
    turns it off) each tick, deliver frames and track delivery latency."""
    base = _batcher()
    # (pool env, async env) -> (fetch_pool, _async_fetch)
    cases = [(None, None, 2, True), ("0", None, 0, True), ("0", "0", 0, False),
             ("3", None, 3, True), (None, "0", 2, False)]
    for pool_env, async_env, want_pool, want_async in cases:
        for name, val in (("RSTNET_BATCHER_FETCH_POOL", pool_env),
                          ("RSTNET_BATCHER_ASYNC_FETCH", async_env)):
            if val is None:
                monkeypatch.delenv(name, raising=False)
            else:
                monkeypatch.setenv(name, val)
        b = type(base)(base.mimi, base.lm_gen, max_sessions=2, dtype=torch.float32,
                       pipeline_depth=2)
        assert (b.fetch_pool, b._async_fetch) == (want_pool, want_async), (pool_env, async_env)
        sess = b.acquire()
        for _ in range(4):
            b.step_once()
        assert b.delivery_latency.summary()["n_frames"] >= 3
        assert sess.outputs.qsize() > 0


def test_batched_handshake_reply_precedes_any_audio():
    """The slot is acquired only after the codec handshake reply is sent,
    so a client never gets audio before the reply."""
    from aiohttp.test_utils import TestClient, TestServer

    from rstnet_tpu_torch.serving.server import build_batched_app

    batcher = _batcher()
    batcher.warmup()
    app = build_batched_app(batcher)

    async def run():
        async with TestClient(TestServer(app)) as client:
            ws = await client.ws_connect("/api/chat")
            await asyncio.sleep(0.4)  # several clock ticks with the offer unsent
            await ws.send_str(json.dumps({"codec": "pcm16"}))
            msg = await asyncio.wait_for(ws.receive(), timeout=30)
            assert msg.type.name == "TEXT", msg.type.name
            assert json.loads(msg.data)["codec"] == "pcm16"
            for i in range(3):
                await ws.send_bytes(TAG_AUDIO + float_to_pcm16(_pcm(i)))
            got = 0
            for _ in range(20):
                msg = await asyncio.wait_for(ws.receive(), timeout=30)
                if msg.type.name != "BINARY":
                    break
                got += bytes(msg.data)[:1] == TAG_AUDIO
                if got >= 2:
                    break
            await ws.close()
            return got

    assert _run(run()) >= 2
    assert len(batcher.sessions) == 0


def test_batcher_slot_reacquire_drops_inflight_frame():
    """A frame computed for a released slot is not delivered to the new
    session that took the slot while the step was in flight."""

    async def run():
        batcher = _batcher(max_sessions=1)
        sess_a = batcher.acquire()
        _, snapshot = batcher._gather_inputs()
        batcher.release(sess_a)
        sess_b = batcher.acquire()
        assert sess_b.slot == sess_a.slot
        audio = np.zeros((1, 1, batcher.frame_size), np.float32)
        out = np.zeros((1, 5, 1), np.int64)
        valid = np.ones((1,), bool)
        batcher._distribute((snapshot, audio, out, valid))
        assert sess_b.outputs.empty(), "stale frame leaked into a new session"
        _, snap2 = batcher._gather_inputs()
        batcher._distribute((snap2, audio, out, valid))
        assert sess_b.outputs.qsize() == 1

    _run(run())


def test_batcher_pipeline_depth2_matches_depth1():
    """The depth-2 clock (fetch frame t-1 while frame t runs) delivers the
    same frames as depth 1, one tick later."""
    streams = {}
    for depth in (1, 2):
        b = _batcher(pipeline_depth=depth)
        sess = b.acquire()
        n = 6
        for i in range(n + depth - 1):  # depth - 1 flush ticks
            if i < n:
                sess.inputs.put_nowait(_pcm(i))
            b.step_once()
        streams[depth] = []
        while not sess.outputs.empty():
            streams[depth].append(sess.outputs.get_nowait())
    assert len(streams[1]) == len(streams[2]) > 0
    for (a1, t1), (a2, t2) in zip(streams[1], streams[2]):
        assert t1 == t2
        np.testing.assert_array_equal(a1, a2)


def test_batcher_int16_wire_matches_float():
    """int16 PCM between host and device reproduces the float32 wire on
    silence: identical tokens, audio within one pcm16 step."""
    streams = {}
    for wire in ("float32", "int16"):
        b = _batcher(wire_dtype=wire)
        sess = b.acquire()
        for _ in range(5):
            b.step_once()  # a starved slot steps with exact silence
        streams[wire] = []
        while not sess.outputs.empty():
            streams[wire].append(sess.outputs.get_nowait())
    assert len(streams["float32"]) == len(streams["int16"]) > 0
    for (a_f, t_f), (a_i, t_i) in zip(streams["float32"], streams["int16"]):
        assert t_f == t_i
        np.testing.assert_allclose(a_f, a_i, atol=1.5 / 32767.0)


def test_batcher_step_failure_closes_sessions_and_keeps_clock():
    """A failed tick closes the active sessions with a sentinel and leaves
    the batcher usable for new sessions."""

    async def run():
        batcher = _batcher()
        batcher.warmup()
        sess = batcher.acquire()
        batcher._device_step = lambda pcm, snapshot=None: (_ for _ in ()).throw(
            RuntimeError("injected device failure"))
        task = asyncio.get_running_loop().create_task(batcher.run())
        try:
            assert await asyncio.wait_for(sess.outputs.get(), timeout=10) is None
            assert not batcher.sessions
            batcher.release(sess)  # after the failure freed the slot: idempotent
            assert sorted(batcher._free) == [0, 1]
            assert batcher.acquire() is not None
        finally:
            task.cancel()

    _run(run())


# -- LMGen slot isolation (tests/test_generate.py), mirrored --------------------


def _gen():
    from rstnet_tpu_torch.inference.generate import LMGen

    _, _, lm = _lm_pair(delays=(0,) + (1,) * 4, n_q=4)  # no user streams
    return LMGen(lm, delays=lm.delays, use_sampling=False)


@torch.no_grad()
def test_multi_session_staggered_join_matches_solo():
    """A slot reset mid-stream behaves as a fresh solo session: its age
    floors the shared ring, its delay warmup restarts."""
    gen = _gen()
    state = gen.init_state(3, dtype=torch.float32)
    for _ in range(4):
        gen.step(state, None)
    state = gen.reset_slots(state, [1])
    assert int(state["age"][1]) == 0 and int(state["age"][0]) == 4
    batched = []
    for _ in range(6):
        out, valid, state = gen.step(state, None)
        batched.append((out[1].clone(), bool(valid[1])))
    solo_state = gen.init_state(1, dtype=torch.float32)
    for got, want_valid in batched:
        out, valid, solo_state = gen.step(solo_state, None)
        assert want_valid == bool(valid[0])
        np.testing.assert_array_equal(got.numpy(), out[0].numpy())


@torch.no_grad()
def test_multi_session_running_slot_unaffected_by_reset():
    """Resetting one slot does not change another slot's stream at all."""
    gen = _gen()
    state_a = gen.init_state(2, dtype=torch.float32)
    state_b = gen.init_state(2, dtype=torch.float32)
    for t in range(8):
        if t == 4:
            state_b = gen.reset_slots(state_b, [1])
        out_a, _, state_a = gen.step(state_a, None)
        out_b, _, state_b = gen.step(state_b, None)
        np.testing.assert_array_equal(out_b[0].numpy(), out_a[0].numpy())


# -- the solo server's /api/stats (tests/test_server.py), mirrored --------------


def test_stats_endpoint_reports_session_tail():
    """After a solo chat session, /api/stats reports its frames with p50/p99."""
    from aiohttp.test_utils import TestClient, TestServer

    from rstnet_tpu_torch.inference.generate import LMGen
    from rstnet_tpu_torch.serving.server import ServerState, build_app

    _, _, mimi = _mimi_pair()
    _, _, lm = _lm_pair(delays=(0,) * 9)
    state = ServerState(mimi, LMGen(lm, delays=lm.delays))
    state.warmup(2)
    app = build_app(state)

    async def run():
        async with TestClient(TestServer(app)) as client:
            before = await (await client.get("/api/stats")).json()
            ws = await client.ws_connect("/api/chat")
            for i in range(3):
                await ws.send_bytes(TAG_AUDIO + float_to_pcm16(_pcm(i)))
            got = 0
            while got < 3:
                msg = await asyncio.wait_for(ws.receive(), timeout=30)
                if msg.type.name != "BINARY":
                    break
                got += bytes(msg.data)[:1] == TAG_AUDIO
            await ws.close()
            after = await (await client.get("/api/stats")).json()
            return before, after

    before, after = _run(run())
    assert before == {"n_frames": 0}
    assert after["n_frames"] >= 3
    assert after["p50_ms"] > 0 and after["p99_ms"] >= after["p50_ms"]
    assert "p99_steady_ms" in after
