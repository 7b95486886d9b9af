"""Multi-frame serving in the PyTorch port, on the CPU: ``LMGen.step_scan``
and ``ServerState.handle_frames_array`` mirrored from ``tests/test_generate.py``
and ``tests/test_server.py`` and held to the JAX package, and the frame held
to reading nothing back to the host (what lets the card capture it as a CUDA
graph).

Models: the tiny ``SpeechTextLM`` of ``tests/test_torch_speech_lm.py`` for
``step_scan``, and the small Mimi (frame 24 samples) + Moshi pair of
``tests/test_torch_batcher.py`` for the server, all float32. Tolerances:
tokens and ``valid`` exact; audio within 1e-5, as the JAX test holds a scan
against single frames (a chunk's convolutions sum in another order than
single frames' do)."""

import tests.test_torch_threads  # noqa: F401 - first: one torch CPU thread a process

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rstnet_tpu_torch.inference.generate import LMGen
from rstnet_tpu_torch.models.config import Config
from rstnet_tpu_torch.models.lm import SpeechTextLM
from tests.test_torch_batcher import FRAME, _lm_pair, _mimi_pair
from tests.test_torch_speech_lm import CFG, lm_pair

AUDIO_TOL = 1e-5


def _model(**over) -> SpeechTextLM:
    return SpeechTextLM(Config(**dict(CFG, **over)), generator=torch.Generator().manual_seed(0))


def _steps(gen, state, generator, n, user=None):
    outs, valids = [], []
    for t in range(n):
        tokens = None if user is None else user[:, :, t : t + 1]
        out, valid, state = gen.step(state, generator, tokens)
        outs.append(out[:, :, 0].clone())
        valids.append(valid.clone())
    return torch.stack(outs, dim=2), torch.stack(valids, dim=1), state


def test_step_scan_matches_sequential_steps():
    """``step_scan`` is token-identical to N ``step`` calls drawing from the
    same generator (sampling on), and leaves the same state: the next frame
    after both paths matches."""
    m = _model()
    gen = LMGen(m, delays=(0,) + (1,) * m.config.n_q, use_sampling=True)
    N = 5
    seq_out, seq_valid, state_a = _steps(gen, gen.init_state(2, torch.float32),
                                         torch.Generator().manual_seed(3), N)
    g = torch.Generator().manual_seed(3)
    out_s, valid_s, state_b = gen.step_scan(gen.init_state(2, torch.float32), g, n_frames=N)
    assert out_s.shape == (2, m.config.dep_q + 1, N) and valid_s.shape == (2, N)
    torch.testing.assert_close(out_s, seq_out, rtol=0, atol=0)
    torch.testing.assert_close(valid_s, seq_valid, rtol=0, atol=0)
    assert int(state_a["offset"]) == int(state_b["offset"]) == N
    out_a2, _, _ = gen.step(state_a, torch.Generator().manual_seed(9))
    out_b2, _, _ = gen.step(state_b, torch.Generator().manual_seed(9))
    torch.testing.assert_close(out_a2, out_b2, rtol=0, atol=0)


def test_step_scan_needs_n_frames_without_user_streams():
    gen = LMGen(_model(), use_sampling=False)
    with pytest.raises(ValueError, match="n_frames"):
        gen.step_scan(gen.init_state(1, torch.float32), None)


def test_step_scan_with_user_streams():
    """``step_scan`` threads per-frame user tokens exactly like ``step``."""
    m = _model(n_q=16)  # duplex: 8 user streams
    gen = LMGen(m, delays=(0,) * 9 + (1,) * 8)
    assert gen.num_user_streams == 8
    N, B = 4, 1
    user = torch.from_numpy(np.random.default_rng(6).integers(0, CFG["audio_card"], (B, 8, N)))
    seq_out, _, _ = _steps(gen, gen.init_state(B, torch.float32),
                           torch.Generator().manual_seed(5), N, user)
    out_s, _, _ = gen.step_scan(gen.init_state(B, torch.float32),
                                torch.Generator().manual_seed(5), user)
    torch.testing.assert_close(out_s, seq_out, rtol=0, atol=0)


@pytest.mark.parametrize("duplex", [False, True], ids=["no_user", "user_streams"])
def test_step_scan_matches_jax(duplex):
    """Greedy ``step_scan`` of the port equals the JAX ``step_scan``: frames
    and ``valid`` exactly, float32 weights and state, two scans of 3 frames
    (the second from the state the first left). With user streams (n_q 16,
    8 of them the caller's, delayed by one) at B=1, without at B=2."""
    from rstnet_tpu.inference.generate import LMGen as JGen

    over = dict(n_q=16) if duplex else {}
    jm, params, tm = lm_pair(**over)
    n_q, dep_q = tm.config.n_q, tm.config.dep_q
    delays = (0,) * (dep_q + 1) + (1,) * (n_q - dep_q) if duplex else (0,) + (1,) * n_q
    jgen = JGen(jm, delays=delays, use_sampling=False)
    tgen = LMGen(tm, delays=delays, use_sampling=False)
    B, N = (1, 3) if duplex else (2, 3)
    jstate, tstate = jgen.init_state(B, jnp.float32), tgen.init_state(B, torch.float32)
    scan = jax.jit(jgen.step_scan, static_argnames=("n_frames",))
    rng = np.random.default_rng(1)
    for _ in range(2):
        if duplex:
            user = rng.integers(0, CFG["audio_card"], (B, n_q - dep_q, N))
            jout, jvalid, jstate = scan(params, jstate, jax.random.PRNGKey(0),
                                        jnp.asarray(user, jnp.int32))
            tout, tvalid, tstate = tgen.step_scan(tstate, None, torch.from_numpy(user))
        else:
            jout, jvalid, jstate = scan(params, jstate, jax.random.PRNGKey(0), n_frames=N)
            tout, tvalid, tstate = tgen.step_scan(tstate, None, n_frames=N)
        np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
        np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))


def _port_state(scan_frames):
    from rstnet_tpu_torch.serving.server import ServerState

    _, _, mimi = _mimi_pair()
    _, _, lm = _lm_pair()
    return ServerState(mimi, LMGen(lm, delays=lm.delays, use_sampling=False),
                       scan_frames=scan_frames)


def _jax_state(scan_frames):
    from rstnet_tpu.inference.generate import LMGen as JGen
    from rstnet_tpu.serving.server import ServerState as JState

    jmimi, mimi_params, _ = _mimi_pair()
    jlm, lm_params, _ = _lm_pair()
    return JState(mimi=jmimi, mimi_params=mimi_params,
                  lm_gen=JGen(jlm, delays=jlm.delays, use_sampling=False, kv_unstacked=True),
                  lm_params=lm_params, scan_frames=scan_frames)


def test_scan_catchup_matches_single_frames():
    """``handle_frames_array`` (N frames in one step) gives the text of N
    ``handle_frame_array`` calls exactly and their audio within 1e-5, the
    port against itself and against the JAX ``ServerState``: two single
    frames (the delay warmup, max_delay 1), then two scans of 4, with the
    codec state sized by ``reset`` for the chunk."""
    a, b, j = _port_state(0), _port_state(4), _jax_state(4)
    pcm = np.random.default_rng(0).normal(0, 0.1, (10, FRAME)).astype(np.float32)
    for t in range(2):
        outs = [s.handle_frame_array(pcm[t]) for s in (a, b, j)]
        if t == 0:
            assert all(o == (None, None) for o in outs)
            continue
        (audio_a, text_a), (audio_b, text_b), (audio_j, text_j) = outs
        np.testing.assert_array_equal(audio_a, audio_b)
        np.testing.assert_allclose(audio_b, audio_j, rtol=0, atol=AUDIO_TOL)
        assert text_a == text_b == text_j
    for start in (2, 6):
        singles = [a.handle_frame_array(pcm[t]) for t in range(start, start + 4)]
        block = pcm[start : start + 4].reshape(-1)
        scan_audio, scan_text = b.handle_frames_array(block)
        jaudio, jtext = j.handle_frames_array(block)
        assert scan_text == [tok for _, tok in singles] == jtext
        np.testing.assert_allclose(scan_audio, np.concatenate([au for au, _ in singles]),
                                   rtol=0, atol=AUDIO_TOL)
        np.testing.assert_allclose(scan_audio, jaudio, rtol=0, atol=AUDIO_TOL)
    assert a.steps == b.steps == j.steps == 10
    # reset refills the same buffers in place, sized for the chunk
    ring = b.enc_state["encoder_transformer"]["kv"]["k"]
    b.reset()
    assert b.enc_state["encoder_transformer"]["kv"]["k"] is ring
    assert int(b.lm_state["offset"]) == 0 and b.steps == 0


def test_handle_frames_array_warmup_gate_raises():
    """The scan's warmup precondition is a real error (a bare assert would
    let warmup frames decode UNGENERATED tokens as audio), and a scan longer
    than the codec state's chunk is refused."""
    state = _port_state(2)
    with pytest.raises(RuntimeError, match="warmup"):
        state.handle_frames_array(np.zeros(2 * FRAME, np.float32))
    for _ in range(2):
        state.handle_frame_array(np.zeros(FRAME, np.float32))
    with pytest.raises(ValueError, match="whole frames"):
        state.handle_frames_array(np.zeros(3 * FRAME, np.float32))


def test_warmup_runs_frames_and_a_scan_then_resets(monkeypatch):
    """``warmup`` follows JAX: at least max_delay + 1 single frames, then one
    scan when ``scan_frames > 1``, then a reset."""
    state = _port_state(3)
    calls = []
    for name in ("handle_frame_array", "handle_frames_array"):
        real = getattr(state, name)
        monkeypatch.setattr(state, name, lambda pcm, real=real, name=name: (
            calls.append((name, pcm.shape[-1] // FRAME)), real(pcm))[1])
    state.warmup(n_frames=1)
    assert calls == [("handle_frame_array", 1)] * 2 + [("handle_frames_array", 3)]
    assert state.steps == 0 and int(state.lm_state["offset"]) == 0


def _raising(name):
    def method(self, *args, **kwargs):
        raise AssertionError(f"the frame read a tensor back to the host ({name})")

    return method


@pytest.fixture
def no_host_reads(monkeypatch):
    """``Tensor.item``, ``__bool__``, ``__int__`` and ``tolist`` patched to
    raise while the fixture's user runs its frame."""
    def patch():
        for name in ("item", "__bool__", "__int__", "tolist"):
            monkeypatch.setattr(torch.Tensor, name, _raising(name))

    return patch


def test_frame_reads_nothing_back(no_host_reads):
    """``LMGen.step`` (B=1 and B=2, with user streams), Mimi's
    ``encode_step`` and ``decode_step`` (a frame and a chunk of 2, with a
    per-slot session age), ``ServerState._fused_frame`` and
    ``_fused_frames`` and ``SessionBatcher._fused_step`` read no tensor back
    to the host: the state's offsets are device tensors and the frame's
    constants were built with the state."""
    from rstnet_tpu_torch.serving.batcher import SessionBatcher

    m = _model(n_q=16)
    gen = LMGen(m, delays=(0,) * 9 + (1,) * 8)
    states = {B: gen.init_state(B, torch.float32) for B in (1, 2)}
    _, _, mimi = _mimi_pair()
    enc, dec = (mimi.init_encode_state(2, chunk_frames=2), mimi.init_decode_state(2, chunk_frames=2))
    server = _port_state(2)
    server_state = server._state
    _, _, lm = _lm_pair()
    batcher = SessionBatcher(mimi, LMGen(lm, delays=lm.delays, use_sampling=False),
                             max_sessions=2, dtype=torch.float32)
    g = torch.Generator().manual_seed(0)
    user = {B: torch.zeros((B, 8, 1), dtype=torch.long) for B in (1, 2)}
    age = torch.zeros(2, dtype=torch.long)
    no_host_reads()
    for _ in range(2):
        for B in (1, 2):
            gen.step(states[B], g, user[B])
        for n in (1, 2):
            codes, enc = mimi.encode_step(enc, torch.zeros((2, 1, n * FRAME)), age)
            _, dec = mimi.decode_step(dec, codes, age)
        _, _, server_state = server._fused_frame(server_state, torch.zeros((1, 1, FRAME)))
        batcher._fused_step(batcher._state, torch.zeros((2, 1, FRAME)))
    server._fused_frames(server_state, torch.zeros((1, 1, 2 * FRAME)))
    with pytest.raises(AssertionError, match="host"):
        torch.zeros(()).item()


def test_int8_frame_reads_nothing_back(no_host_reads):
    """The served ``--int8 --kv-int8`` frame, scan and batched tick (the
    tiny pair, weights quantized in place, an int8 ring) read no tensor
    back to the host either: on the card they are graph replays too."""
    from rstnet_tpu_torch.serving.server import build_server, parse_args

    flags = ["--tiny", "--device", "cpu", "--int8", "--kv-int8"]
    server = build_server(parse_args([*flags, "--scan-frames", "4"]))
    batcher = build_server(parse_args([*flags, "--batch", "2", "--pipeline", "1"]))
    assert server.lm_gen.kv_int8 and batcher.lm_gen.kv_int8
    state = server._state
    no_host_reads()
    for _ in range(2):
        _, _, state = server._fused_frame(state, torch.zeros((1, 1, server.frame_size)))
        batcher._fused_step(batcher._state, torch.zeros((2, 1, batcher.frame_size)))
    server._fused_frames(state, torch.zeros((1, 1, 4 * server.frame_size)))


@pytest.mark.parametrize("flags", [["--scan-frames", "4"],
                                   ["--batch", "2", "--pipeline", "1", "--scan-frames", "4"],
                                   ["--int8", "--kv-int8", "--scan-frames", "4"]],
                         ids=["solo", "batch", "int8"])
def test_server_scan_frames_option_builds_the_server(flags):
    """``--scan-frames`` reaches a built, warmed-up server (the tiny pair on
    the CPU): solo, a ``ServerState`` whose codec state takes a chunk of 4
    frames; with ``--batch`` the flag is accepted and a ``SessionBatcher``
    is built (its clock steps one frame a tick, as the JAX batcher's does).
    Its default is 4, as in the JAX server."""
    from rstnet_tpu_torch.serving.batcher import SessionBatcher
    from rstnet_tpu_torch.serving.server import ServerState, build_server, parse_args

    assert parse_args([]).scan_frames == 4
    args = parse_args(["--tiny", "--device", "cpu", *flags])
    assert args.scan_frames == 4
    server = build_server(args)
    if "--batch" in flags:
        assert isinstance(server, SessionBatcher)
        assert server.max_sessions == 2 and not server.cuda_graphs
        return
    assert server.scan_frames == 4
    assert isinstance(server, ServerState) and server.steps == 0 and not server.cuda_graphs
    assert server.lm_gen.kv_int8 == ("--kv-int8" in flags)
    ring = server.enc_state["encoder_transformer"]["kv"]["k"]
    assert ring.shape[-2] == 250 + 2 * 4 - 1  # context + chunk of 4 frames x 2 steps - 1
    audio, tokens = (None, None)
    for _ in range(max(1, server.lm_gen.max_delay + 1)):
        audio, tokens = server.handle_frame_array(np.zeros(server.frame_size, np.float32))
    audio, tokens = server.handle_frames_array(np.zeros(4 * server.frame_size, np.float32))
    assert audio.shape == (4 * server.frame_size,) and len(tokens) == 4

