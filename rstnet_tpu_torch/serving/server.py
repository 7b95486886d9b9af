"""Full-duplex streaming voice server (counterpart of
``rstnet_tpu/serving/server.py``: ``ServerState``, the chat handlers, the
apps and ``main``).

Per 80 ms frame: audio in -> Mimi ``encode_step`` -> ``LMGen.step`` -> Mimi
``decode_step`` -> audio out + a text token. Solo (the default), one
connection at a time owns a ``ServerState`` whose streaming state is reset
when it opens; Mimi and the LM state run in float32 and the LM weights in
bf16, as in the reference. With ``--batch N``, up to N connections share one
``SessionBatcher`` (``serving/batcher.py``) whose LM state is bf16. Wire
protocol and codec handshake are the JAX server's (``b"\\x01"`` audio,
``b"\\x02"`` text, Opus or PCM16 via ``serving/opus.py``). Text goes out
decoded through the text tokenizer of ``--tokenizer-dir``, or as the token
id without one.
``/api/stats`` reports the frame-latency tail.

With ``--scan-frames N`` (default 4, as in JAX) a solo session that has N
whole frames buffered past the LM's delay warmup runs them as one step
(``handle_frames_array``: encode chunk -> ``LMGen.step_scan`` -> decode
chunk). On the card the solo frame, the scan and the batched tick are each
captured once as a CUDA graph (``serving/graphs.py``) and replayed, the
counterpart of the JAX server's one jitted dispatch a frame.

Run: ``python -m rstnet_tpu_torch.serving.server [--tiny] [--device cuda]
[--batch N] [--scan-frames N] [--int8] [--int8-dep] [--int8-head]
[--kv-int8] [--mimi-checkpoint M] [--lm-checkpoint L] [--tokenizer-dir D]``.
The checkpoint options load kyutai's public files (``models/convert.py``):
the LM then runs on the converted float32 weights, as the JAX server serves
them, and K1 reads their bf16 rounding (``ops/cuda_depformer.py::
bf16_rounding``). Without them the weights are random, drawn from ``--seed``
(Moshi in bf16). The int8 options follow the JAX ``main``
(``quantize_for_serving``): ``--int8`` quantizes the depformer slice and the
backbone, ``--int8-dep`` the depformer slice only, ``--int8-head`` the text
head (only without ``--int8``), and ``--kv-int8`` stores the backbone ring
K/V as int8. One difference: the JAX server returns from its ``--tiny``
branch before its int8 block, so there the weight options do nothing on the
tiny pair, while the port applies them to whichever pair it builds. As in
JAX, ``--tiny`` ignores the checkpoint and tokenizer options.

``serve_in_thread(app)`` serves an app from a background thread on a local
port, for a client in the same process (``serving/client.py``: its
``stream_file``, ``load_test`` and ``main`` run their own event loop).
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import dataclasses
import json
import logging
import os
import threading
import time
from typing import Optional

import numpy as np
import torch

from rstnet_tpu_torch.inference.generate import LMGen
from rstnet_tpu_torch.serving import opus
from rstnet_tpu_torch.serving.graphs import CapturedStep, copy_tree_, weights_key
from rstnet_tpu_torch.utils.latency import FrameLatencyTracker

TAG_AUDIO = b"\x01"
TAG_TEXT = b"\x02"
TEXT_SKIP_IDS = (0, 3)  # <unk>/<epad> and <pad>


class ServerState:
    """The codec and the LM engine in streaming state for one session, and
    the text tokenizer its text goes out through (None: token ids).

    ``seed`` seeds the sampling generator at every ``reset``, so a session is
    reproducible. ``scan_frames`` (0 or 1: off) sizes the codec state for a
    catch-up chunk of that many frames (``handle_frames_array``).

    On a CUDA device (unless ``cuda_graphs`` is False) the frame and the
    scan are each captured once as a CUDA graph (``serving/graphs.py``) and
    then replayed, over one set of state buffers that ``reset`` refills in
    place, so a new session replays the same graphs. On the CPU the same
    functions run eagerly."""

    def __init__(self, mimi, lm_gen: LMGen, seed: int = 0, scan_frames: int = 0,
                 cuda_graphs: bool = True, text_tokenizer=None):
        self.mimi, self.lm_gen = mimi, lm_gen
        self.text_tokenizer = text_tokenizer
        self.seed = seed
        self.scan_frames = int(scan_frames)
        self.frame_size = mimi.frame_size
        self.device = next(mimi.parameters()).device
        self.lock = asyncio.Lock()
        self.cuda_graphs = cuda_graphs and self.device.type == "cuda"
        self.generator = torch.Generator(device=self.device)
        self._state = None
        self._frame_graph = None
        self._scan_graphs: dict = {}  # by frames per scan
        self.reset()

    def reset(self) -> None:
        dev = self.device
        chunk_frames = max(1, self.scan_frames)
        fresh = {
            "enc": self.mimi.init_encode_state(1, chunk_frames=chunk_frames, device=dev),
            "dec": self.mimi.init_decode_state(1, chunk_frames=chunk_frames, device=dev),
            "lm": self.lm_gen.init_state(1, dtype=torch.float32, device=dev),
            "dec_age": torch.zeros((1,), dtype=torch.long, device=dev),
        }
        if self._state is None:
            self._state = fresh
        else:  # in place: captured graphs hold these buffers
            copy_tree_(self._state, fresh)
        self.generator.manual_seed(self.seed)
        self.steps = 0  # completed frames; validity is deterministic from it

    @property
    def enc_state(self) -> dict:
        return self._state["enc"]

    @property
    def dec_state(self) -> dict:
        return self._state["dec"]

    @property
    def lm_state(self) -> dict:
        return self._state["lm"]

    @torch.no_grad()
    def _fused_frame(self, state: dict, chunk: torch.Tensor):
        """Codec encode + LM frame + codec decode, with no host sync. Warmup
        frames decode clamped garbage that the host discards; the decoder
        state they advanced is reset at the first valid frame."""
        mimi, gen = self.mimi, self.lm_gen
        codes, enc = mimi.encode_step(state["enc"], chunk)
        user = codes[:, : gen.num_user_streams, :] if gen.num_user_streams else None
        out, valid, lm = gen.step(state["lm"], self.generator, user)
        first_valid = valid & (state["dec_age"] == 0)
        dec_in = mimi.mask_decode_slots(state["dec"], first_valid)
        codes_out = out[:, 1:, :].clamp(0, mimi.quantizer.bins - 1)
        audio, dec = mimi.decode_step(dec_in, codes_out)
        new_state = {"enc": enc, "dec": dec, "lm": lm,
                     "dec_age": state["dec_age"] + valid.long()}
        return audio, out, new_state

    @torch.no_grad()
    def _fused_frames(self, state: dict, chunk: torch.Tensor):
        """N whole frames (encode chunk -> ``LMGen.step_scan`` -> decode
        chunk). The caller gates on the warmup being over, so every frame of
        the scan is valid."""
        mimi, gen = self.mimi, self.lm_gen
        n_frames = chunk.shape[-1] // self.frame_size
        codes, enc = mimi.encode_step(state["enc"], chunk)
        user = codes[:, : gen.num_user_streams, :] if gen.num_user_streams else None
        out, _, lm = gen.step_scan(state["lm"], self.generator, user,
                                   n_frames=None if gen.num_user_streams else n_frames)
        audio, dec = mimi.decode_step(state["dec"], out[:, 1:, :])
        new_state = {"enc": enc, "dec": dec, "lm": lm,
                     "dec_age": state["dec_age"] + out.shape[-1]}
        return audio, out, new_state

    def _captured(self, fn, n_samples: int) -> CapturedStep:
        """A graph of ``fn`` over this session's state buffers and a static
        [1, 1, n_samples] input; the frame and scan graphs share the state,
        the memory pool and the capture stream."""
        first = self._frame_graph or next(iter(self._scan_graphs.values()), None)
        pcm = torch.zeros((1, 1, n_samples), dtype=torch.float32, device=self.device)

        def step(state, chunk):
            audio, out, new_state = fn(state, chunk)
            return (audio, out), new_state

        return CapturedStep(
            step, self._state, (pcm,), pool=first.pool if first else None,
            stream=first.stream if first else None, generators=(self.generator,),
            key=lambda: weights_key(self.mimi, self.lm_gen.model), name=fn.__name__,
            modules=(self.mimi, self.lm_gen.model))

    def _run(self, pcm: np.ndarray, n_frames: int):
        """One frame (``n_frames`` 0) or a scan of ``n_frames``: (audio, out)
        on the device."""
        if not self.cuda_graphs:
            chunk = torch.as_tensor(pcm, dtype=torch.float32).reshape(1, 1, -1).to(self.device)
            fn = self._fused_frames if n_frames else self._fused_frame
            audio, out, self._state = fn(self._state, chunk)
            return audio, out
        if n_frames:
            if n_frames not in self._scan_graphs:
                self._scan_graphs[n_frames] = self._captured(self._fused_frames, pcm.shape[-1])
            graph = self._scan_graphs[n_frames]
        else:
            if self._frame_graph is None:
                self._frame_graph = self._captured(self._fused_frame, pcm.shape[-1])
            graph = self._frame_graph
        # pageable memory: the copy returns once the source is staged
        graph.inputs[0].copy_(torch.from_numpy(np.ascontiguousarray(pcm, np.float32))
                              .reshape(1, 1, -1), non_blocking=True)
        return graph()

    def graphs(self) -> dict:
        """The captured steps by name (``frame``, ``scan_N``)."""
        out = {f"scan_{n}": g for n, g in self._scan_graphs.items()}
        if self._frame_graph is not None:
            out["frame"] = self._frame_graph
        return out

    def warmup(self, n_frames: int = 4) -> None:
        """Run silent frames and, with ``scan_frames > 1``, scans (the
        allocator, the kernel build, the graph captures), then reset. The
        scan needs the LM's delay warmup behind it, so at least
        ``max_delay + 1`` frames run first; on the card each step runs
        eagerly once and is captured at its second call."""
        calls = 2 if self.cuda_graphs else 1
        if self.scan_frames > 1:
            n_frames = max(n_frames, self.lm_gen.max_delay + 1)
        for _ in range(max(n_frames, calls)):
            self.handle_frame_array(np.zeros(self.frame_size, np.float32))
        if self.scan_frames > 1 and self.steps > self.lm_gen.max_delay:
            for _ in range(calls):
                self.handle_frames_array(np.zeros(self.scan_frames * self.frame_size,
                                                  np.float32))
        self.reset()

    def handle_frame_array(self, pcm: np.ndarray) -> tuple[Optional[np.ndarray], Optional[int]]:
        """One 80 ms frame: float samples in -> (float samples out | None,
        text token | None). Warmup frames (``steps <= max_delay``) return
        (None, None) without reading anything back from the device."""
        if pcm.shape[-1] != self.frame_size:
            raise ValueError(f"frame of {pcm.shape[-1]} samples, expected {self.frame_size}")
        audio, out = self._run(pcm, 0)
        self.steps += 1
        if self.steps <= self.lm_gen.max_delay:
            return None, None
        return audio[0, 0].cpu().numpy(), int(out[0, 0, 0])

    def handle_frames_array(self, pcm: np.ndarray) -> tuple[np.ndarray, list]:
        """N whole frames in one step (encode chunk -> ``LMGen.step_scan`` ->
        decode chunk): [N * frame_size] float samples -> (audio samples, N
        text tokens). Only past the warmup (``steps > max_delay``), so every
        frame of the scan is valid; N at most ``max(1, scan_frames)``, the
        chunk the codec state is sized for."""
        if self.steps <= self.lm_gen.max_delay:
            raise RuntimeError(
                "handle_frames_array called during warmup "
                f"(step {self.steps} <= max_delay {self.lm_gen.max_delay}); "
                "route warmup frames through handle_frame_array")
        n, rest = divmod(pcm.shape[-1], self.frame_size)
        if rest or not 1 <= n <= max(1, self.scan_frames):
            raise ValueError(f"{pcm.shape[-1]} samples: expected 1 to {max(1, self.scan_frames)} "
                             f"whole frames of {self.frame_size}")
        audio, out = self._run(pcm, n)
        self.steps += n
        audio_np, out_np = audio[0, 0].cpu().numpy(), out[0, 0, :].cpu().numpy()
        return audio_np, [int(t) for t in out_np]


def _handshake_reply(raw: str, frame_size: int) -> tuple[object, str]:
    """Negotiate the audio codec from the client's JSON offer."""
    try:
        offer = json.loads(raw).get("codec", "pcm16")
    except (ValueError, AttributeError):
        offer = "pcm16"
    codec = opus.negotiate(offer, frame_size)
    return opus.make_transport(codec), json.dumps({"codec": codec})


async def _send_text(ws, text_token, text_tokenizer):
    """One text token: decoded through ``text_tokenizer`` (nothing is sent
    for an empty piece), or its id without one; padding and unknown ids are
    never sent."""
    if text_token is None or text_token in TEXT_SKIP_IDS:
        return
    if text_tokenizer is None:
        await ws.send_bytes(TAG_TEXT + str(text_token).encode())
        return
    text = text_tokenizer.decode([text_token])
    if text:
        await ws.send_bytes(TAG_TEXT + text.encode())


async def _send_frame(ws, audio, text_token, text_tokenizer, transport):
    await ws.send_bytes(TAG_AUDIO + transport.pack(audio))
    await _send_text(ws, text_token, text_tokenizer)


async def handle_chat(state: ServerState, request):
    """Per-connection duplex loop: one session at a time."""
    from aiohttp import WSMsgType, web

    ws = web.WebSocketResponse()
    await ws.prepare(request)
    async with state.lock:
        state.reset()
        logging.info("chat session started")
        buffered = np.zeros((0,), np.float32)
        transport = None
        tracker = FrameLatencyTracker()  # this session's frame-latency tail
        state.last_latency_summary = tracker.summary
        async for msg in ws:
            if msg.type == WSMsgType.TEXT and transport is None:
                transport, reply = _handshake_reply(msg.data, state.frame_size)
                await ws.send_str(reply)
                continue
            if msg.type != WSMsgType.BINARY:
                continue
            data = bytes(msg.data)
            if not data or data[0:1] != TAG_AUDIO:
                continue
            if transport is None:  # legacy client: PCM16, no handshake
                transport = opus.Pcm16Transport()
            buffered = np.concatenate([buffered, transport.unpack(data[1:])])
            while buffered.shape[0] >= state.frame_size:
                sf = state.scan_frames
                if (sf > 1 and buffered.shape[0] >= sf * state.frame_size
                        and state.steps > state.lm_gen.max_delay):
                    # catch-up: sf buffered frames in one step; each frame
                    # records the scan's time a frame
                    block = buffered[: sf * state.frame_size]
                    buffered = buffered[sf * state.frame_size :]
                    t0 = time.perf_counter()
                    audio, text_tokens = state.handle_frames_array(block)
                    ms = (time.perf_counter() - t0) * 1000
                    logging.info("%d frames handled in %.1f ms (scan)", sf, ms)
                    for _ in range(sf):
                        tracker.record(ms / sf)
                    await ws.send_bytes(TAG_AUDIO + transport.pack(audio))
                    for tok in text_tokens:
                        await _send_text(ws, tok, state.text_tokenizer)
                    continue
                frame = buffered[: state.frame_size]
                buffered = buffered[state.frame_size :]
                t0 = time.perf_counter()
                audio, text_token = state.handle_frame_array(frame)
                ms = (time.perf_counter() - t0) * 1000
                logging.info("frame handled in %.1f ms", ms)
                tracker.record(ms)
                if audio is not None:
                    await _send_frame(ws, audio, text_token, state.text_tokenizer, transport)
        logging.info("chat session ended; frame latency: %s", tracker.summary())
    return ws


async def handle_chat_batched(batcher, request):
    """Per-connection duplex loop on the shared batched pipeline: the
    connection owns one batch slot; its audio is framed into the slot's
    input queue while the slot's output queue streams back."""
    from aiohttp import WSMsgType, web

    ws = web.WebSocketResponse()
    await ws.prepare(request)
    # the slot is acquired only once the codec is decided (handshake reply
    # sent, or a legacy client's first binary frame): the batcher steps an
    # acquired slot at once, and no frame may be packed with a transport the
    # client did not negotiate, nor precede the handshake reply
    holder = {"transport": None}
    sess = None
    out_task = None

    async def pump_outputs(sess):
        try:
            while True:
                item = await sess.outputs.get()
                if item is None:  # the batcher failed the session: close loudly
                    logging.error("slot %d terminated by a step failure", sess.slot)
                    await ws.close(code=1011, message=b"server step failed")
                    return
                audio, text_token = item
                await _send_frame(ws, audio, text_token, batcher.text_tokenizer,
                                  holder["transport"])
        except asyncio.CancelledError:
            raise
        except Exception as e:  # noqa: BLE001 - a dead client must free the slot
            logging.info("slot %d output stream closed (%s)", sess.slot, e)
            await ws.close()

    async def start_session():
        nonlocal sess, out_task
        sess = batcher.acquire()
        if sess is None:
            await ws.close(code=1013, message=b"server full")
            return False
        logging.info("chat session started (slot %d)", sess.slot)
        out_task = asyncio.get_running_loop().create_task(pump_outputs(sess))
        return True

    try:
        buffered = np.zeros((0,), np.float32)
        frame_size = batcher.frame_size
        async for msg in ws:
            if msg.type == WSMsgType.TEXT and holder["transport"] is None:
                holder["transport"], reply = _handshake_reply(msg.data, frame_size)
                await ws.send_str(reply)
                if not await start_session():
                    break
                continue
            if msg.type != WSMsgType.BINARY:
                continue
            data = bytes(msg.data)
            if not data or data[0:1] != TAG_AUDIO:
                continue
            if holder["transport"] is None:  # legacy client: PCM16, no handshake
                holder["transport"] = opus.Pcm16Transport()
            if sess is None and not await start_session():
                break
            buffered = np.concatenate([buffered, holder["transport"].unpack(data[1:])])
            while buffered.shape[0] >= frame_size:
                frame, buffered = buffered[:frame_size], buffered[frame_size:]
                await sess.inputs.put(frame)
    finally:
        if out_task is not None:
            out_task.cancel()
        if sess is not None:
            batcher.release(sess)
            logging.info("chat session ended (slot %d)", sess.slot)
    return ws


async def handle_index(request):
    """The minimal browser client."""
    from aiohttp import web

    return web.FileResponse(os.path.join(os.path.dirname(__file__), "static", "index.html"))


def build_app(state: ServerState):
    from aiohttp import web

    app = web.Application()
    app.router.add_get("/", handle_index)
    app.router.add_get("/api/chat", lambda req: handle_chat(state, req))

    async def stats(request):
        # the frame-latency tail of the current or most recent session
        summary = getattr(state, "last_latency_summary", None)
        return web.json_response(summary() if summary else {"n_frames": 0})

    app.router.add_get("/api/stats", stats)
    return app


def build_batched_app(batcher):
    """App serving up to ``batcher.max_sessions`` concurrent duplex chats
    through one batched frame step; text goes out through the batcher's
    ``text_tokenizer``."""
    from aiohttp import web

    app = web.Application()
    app.router.add_get("/", handle_index)
    app.router.add_get("/api/chat", lambda req: handle_chat_batched(batcher, req))

    async def stats(request):
        # every tick is one frame for every active session, so the tick
        # distribution is the per-session frame-latency tail; "delivery" is
        # the dispatch->delivery tail of each frame
        return web.json_response({
            "active_sessions": len(batcher.sessions),
            "pipeline_depth": batcher.pipeline_depth,
            "cuda_graphs": batcher.cuda_graphs,
            "fetch_pool": batcher.fetch_pool,
            "async_fetch": batcher._async_fetch,
            "delivery": batcher.delivery_latency.summary(),
            **batcher.latency.summary(),
        })

    app.router.add_get("/api/stats", stats)

    async def start_clock(app):
        batcher.start()

    app.on_startup.append(start_clock)
    return app


@contextlib.contextmanager
def serve_in_thread(app, host: str = "127.0.0.1", port: int = 0):
    """Serve ``app`` on ``host``:``port`` (0: a free port) from an event loop
    on a background thread; yields the ``ws://`` URL of its chat endpoint.
    The app's startup hooks (the batched clock) run on that loop; the server
    and the loop stop on exit."""
    from aiohttp import web

    loop = asyncio.new_event_loop()
    runner = web.AppRunner(app)
    try:
        loop.run_until_complete(runner.setup())
        loop.run_until_complete(web.TCPSite(runner, host, port).start())
    except BaseException:
        loop.run_until_complete(runner.cleanup())
        loop.close()
        raise
    bound = runner.addresses[0][1]
    thread = threading.Thread(target=loop.run_forever, name="serve_in_thread", daemon=True)
    thread.start()
    async def shutdown():
        await runner.cleanup()
        # the batched clock's task and any handler still running
        tasks = [t for t in asyncio.all_tasks() if t is not asyncio.current_task()]
        for t in tasks:
            t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)

    try:
        yield f"ws://{host}:{bound}/api/chat"
    finally:
        asyncio.run_coroutine_threadsafe(shutdown(), loop).result(timeout=60)
        loop.call_soon_threadsafe(loop.stop)
        thread.join(timeout=60)
        loop.close()


@torch.no_grad()
def quantize_for_serving(lm, int8: bool = False, int8_dep: bool = False,
                         int8_head: bool = False):
    """The JAX ``main``'s int8 serving options on a ``MoshiLMModel``, in
    place, in its order (pad the depformer gating before this: padding works
    on plain weights). ``int8`` and ``int8_dep`` quantize the depformer slice
    (the depformer, ``depformer_in``, ``linears.weight``), which keeps it
    inside K1-int8's envelope; ``int8`` also the backbone transformer, but
    not the text head; ``int8_head`` the text head, only without ``int8``."""
    from rstnet_tpu_torch.modules.transformer import (
        quantize_param_int8,
        quantize_transformer_int8,
    )

    if int8 or int8_dep:
        quantize_transformer_int8(lm.depformer)
        quantize_param_int8(lm, "depformer_in")
        quantize_param_int8(lm.linears, "weight")
    if int8:
        quantize_transformer_int8(lm.transformer)
    if int8_head and not int8:
        quantize_param_int8(lm.text_linear, "weight")
    return lm


def build_models(tiny: bool, device, seed: int, mimi_checkpoint: str = "",
                 lm_checkpoint: str = ""):
    """(mimi, lm_gen): the tiny demo pair with random weights drawn from
    ``seed``, or Mimi 24 kHz (f32) + Moshi 7B. Moshi is bf16 with random
    weights, or float32 loaded from ``lm_checkpoint`` (the JAX converter's
    dtype); Mimi is random or loaded from ``mimi_checkpoint``. The
    depformer's gating hidden dim is padded to a multiple of 128 for K2 (a
    no-op for Moshi 7B, whose hidden dim is 2816 = 22 x 128)."""
    from rstnet_tpu_torch.models.mimi import mimi_24k
    from rstnet_tpu_torch.models.moshi_lm import MoshiLMModel, moshi_7b
    from rstnet_tpu_torch.modules.transformer import pad_codecformer_gating

    g = torch.Generator(device=device).manual_seed(seed)
    if tiny:
        mimi = mimi_24k(n_q_total=8, dimension=64, n_filters=8, num_layers=2,
                        quantizer_dim=32, bins=64, device=device, generator=g)
        lm = MoshiLMModel(
            delays=(0,) * 17, n_q=16, dep_q=8, card=64, text_card=256, dim=64,
            num_heads=4, num_layers=2, hidden_scale=4.0, context=64,
            existing_text_padding_id=3, depformer_dim=32, depformer_dim_feedforward=64,
            depformer_num_heads=2, depformer_num_layers=1, device=device, generator=g)
        pad_codecformer_gating(lm.depformer)
        return mimi, LMGen(lm, delays=lm.delays, top_k=32)
    from rstnet_tpu_torch.models.convert import load_mimi, load_moshi_lm

    mimi = mimi_24k(device=device, generator=g)
    if mimi_checkpoint:
        t0 = time.perf_counter()
        load_mimi(mimi_checkpoint, mimi)
        logging.info("loaded %s in %.1f s", mimi_checkpoint, time.perf_counter() - t0)
    lm = moshi_7b(device=device, dtype=torch.float32 if lm_checkpoint else torch.bfloat16,
                  generator=g)
    if lm_checkpoint:
        t0 = time.perf_counter()
        load_moshi_lm(lm_checkpoint, lm)
        logging.info("loaded %s in %.1f s", lm_checkpoint, time.perf_counter() - t0)
    pad_codecformer_gating(lm.depformer)
    return mimi, LMGen(lm, delays=lm.delays)


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("--host", default="localhost")
    parser.add_argument("--port", type=int, default=8998)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--seed", type=int, default=0,
                        help="seeds the random weights and the sampling generator")
    parser.add_argument("--tiny", action="store_true",
                        help="small random-weight models (demo/smoke; no checkpoints needed)")
    parser.add_argument("--mimi-checkpoint", default="", metavar="FILE",
                        help="kyutai Mimi checkpoint (.safetensors or .pt)")
    parser.add_argument("--lm-checkpoint", default="", metavar="FILE",
                        help="kyutai Moshi checkpoint (.safetensors or .pt); served in float32")
    parser.add_argument("--tokenizer-dir", default="", metavar="DIR",
                        help="text tokenizer (tokenizer.json or tokenizer*.model) to send "
                             "text as words instead of token ids")
    parser.add_argument("--ssl", default="", metavar="DIR",
                        help="serve wss/https with DIR/cert.pem + DIR/key.pem")
    parser.add_argument("--batch", type=int, default=0, metavar="N",
                        help="serve up to N concurrent sessions through one batched frame "
                             "step (0: one session at a time)")
    parser.add_argument("--pipeline", default="auto", metavar="DEPTH",
                        help="batched pipeline depth: 1 fetches each frame in its tick, 2 "
                             "fetches frame t-1 while frame t runs (+1 frame of latency); "
                             "auto picks 2 only when a device->host round trip is a "
                             "material slice of the 80 ms budget")
    parser.add_argument("--wire", default="auto", choices=("auto", "pcm16", "f32"),
                        help="host<->device PCM of the batched pipeline: pcm16 moves 16-bit "
                             "samples and converts on the card; auto picks pcm16 when the "
                             "pipeline depth is > 1")
    parser.add_argument("--fetch-pool", default="auto", metavar="N",
                        help="threads that wait for in-flight frames' device->host copies; "
                             "auto = the pipeline depth when it is > 1, 0 turns it off")
    parser.add_argument("--scan-frames", type=int, default=4, metavar="N",
                        help="when a session has >= N whole frames buffered (file streaming, "
                             "catch-up after a stall), run them as one step "
                             "(LMGen.step_scan; one graph replay on the card); 0 disables. "
                             "The batched clock takes one frame a tick and ignores it")
    parser.add_argument("--int8", action="store_true",
                        help="weight-only int8 for the backbone and the depformer slice (the "
                             "text head stays)")
    parser.add_argument("--int8-dep", action="store_true",
                        help="weight-only int8 for the depformer slice only")
    parser.add_argument("--int8-head", action="store_true",
                        help="weight-only int8 text head (ignored with --int8)")
    parser.add_argument("--kv-int8", action="store_true",
                        help="the backbone ring K/V as int8 with per-step scales")
    return parser.parse_args(argv)


def build_server(args: argparse.Namespace):
    """The warmed-up ``ServerState`` (solo) or ``SessionBatcher``
    (``--batch``) that ``main`` serves; its steps are captured as CUDA
    graphs on the card. Its ``text_tokenizer`` (``--tokenizer-dir``, else
    None) is what the app decodes text with."""
    device = torch.device(args.device)
    if device.type == "cuda":
        # the reference precision: true fp32 matmuls and convolutions
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    mimi, lm_gen = build_models(args.tiny, device, args.seed, args.mimi_checkpoint,
                                args.lm_checkpoint)
    text_tokenizer = None
    if args.tokenizer_dir and not args.tiny:
        from rstnet_tpu_torch.data.tokenizers.text_tokenizer import TextTokenizer

        text_tokenizer = TextTokenizer(args.tokenizer_dir)
    # the weights are final before any graph is captured
    quantize_for_serving(lm_gen.model, args.int8, args.int8_dep, args.int8_head)
    lm_gen = dataclasses.replace(lm_gen, kv_int8=args.kv_int8)
    if args.batch:
        from rstnet_tpu_torch.serving.batcher import SessionBatcher, auto_pipeline_depth

        depth = (auto_pipeline_depth(device=device) if args.pipeline == "auto"
                 else int(args.pipeline))
        wire = {"auto": "int16" if depth > 1 else "float32", "pcm16": "int16",
                "f32": "float32"}[args.wire]
        batcher = SessionBatcher(
            mimi, lm_gen, max_sessions=args.batch,
            dtype=torch.float32 if args.tiny else torch.bfloat16, pipeline_depth=depth,
            wire_dtype=wire,
            fetch_pool=None if args.fetch_pool == "auto" else int(args.fetch_pool),
            seed=args.seed, text_tokenizer=text_tokenizer)
        logging.info("warming up (batch %d, pipeline depth %d, wire %s)...", args.batch, depth,
                     wire)
        batcher.warmup()
        return batcher
    state = ServerState(mimi, lm_gen, seed=args.seed, scan_frames=args.scan_frames,
                        text_tokenizer=text_tokenizer)
    logging.info("warming up (scan frames %d)...", args.scan_frames)
    state.warmup()
    return state


def main(argv=None):
    args = parse_args(argv)
    from aiohttp import web

    ssl_context = None
    if args.ssl:
        import ssl

        ssl_context = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ssl_context.load_cert_chain(certfile=os.path.join(args.ssl, "cert.pem"),
                                    keyfile=os.path.join(args.ssl, "key.pem"))
    server = build_server(args)
    app = build_batched_app(server) if args.batch else build_app(server)
    logging.info("serving ws://%s:%d/api/chat", args.host, args.port)
    web.run_app(app, host=args.host, port=args.port, ssl_context=ssl_context)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
