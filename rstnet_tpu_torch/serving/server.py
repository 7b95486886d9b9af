"""Full-duplex streaming voice server, solo session (counterpart of
``rstnet_tpu/serving/server.py``: ``ServerState``, the chat handler and
``main``).

Per 80 ms frame: audio in -> Mimi ``encode_step`` -> ``LMGen.step`` -> Mimi
``decode_step`` -> audio out + a text token. Mimi and the LM state run in
float32 and the LM weights in bf16, as in the reference. One connection at a
time; its streaming state is reset when it opens. Wire protocol and codec
handshake are the JAX server's (``b"\\x01"`` audio, ``b"\\x02"`` text as the
token id, Opus or PCM16 via ``rstnet_tpu.serving.opus``, which imports no
JAX). The connection handlers import that module when they run, so importing
this one, or driving ``ServerState``, leaves the JAX package out.

Run: ``python -m rstnet_tpu_torch.serving.server [--tiny] [--device cuda]``.
The JAX server's batching and int8 options raise ``NotImplementedError``
naming their ``ROADMAP.md`` item; its checkpoint and tokenizer options come
with checkpoint loading (``ROADMAP.md`` queue 1).
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
import os
import time
from typing import Optional

import numpy as np
import torch

from rstnet_tpu_torch.inference.generate import LMGen

TAG_AUDIO = b"\x01"
TAG_TEXT = b"\x02"
TEXT_SKIP_IDS = (0, 3)  # <unk>/<epad> and <pad>


class ServerState:
    """The codec and the LM engine in streaming state for one session.

    ``seed`` seeds the sampling generator at every ``reset``, so a session is
    reproducible."""

    def __init__(self, mimi, lm_gen: LMGen, seed: int = 0):
        self.mimi, self.lm_gen = mimi, lm_gen
        self.seed = seed
        self.frame_size = mimi.frame_size
        self.device = next(mimi.parameters()).device
        self.lock = asyncio.Lock()
        self.reset()

    def reset(self) -> None:
        dev = self.device
        self._state = {
            "enc": self.mimi.init_encode_state(1, device=dev),
            "dec": self.mimi.init_decode_state(1, device=dev),
            "lm": self.lm_gen.init_state(1, dtype=torch.float32, device=dev),
            "dec_age": torch.zeros((1,), dtype=torch.long, device=dev),
        }
        self.generator = torch.Generator(device=dev).manual_seed(self.seed)
        self.steps = 0  # completed frames; validity is deterministic from it

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

    def warmup(self, n_frames: int = 4) -> None:
        """Run a few silent frames (allocator, cuDNN plans, kernel build), then reset."""
        for _ in range(n_frames):
            self.handle_frame_array(np.zeros(self.frame_size, np.float32))
        self.reset()

    def handle_frame_array(self, pcm: np.ndarray) -> tuple[Optional[np.ndarray], Optional[int]]:
        """One 80 ms frame: float samples in -> (float samples out | None,
        text token | None). Warmup frames (``steps <= max_delay``) return
        (None, None) without reading anything back from the device."""
        if pcm.shape[-1] != self.frame_size:
            raise ValueError(f"frame of {pcm.shape[-1]} samples, expected {self.frame_size}")
        chunk = torch.as_tensor(pcm, dtype=torch.float32).reshape(1, 1, -1).to(self.device)
        audio, out, self._state = self._fused_frame(self._state, chunk)
        self.steps += 1
        if self.steps <= self.lm_gen.max_delay:
            return None, None
        return audio[0, 0].cpu().numpy(), int(out[0, 0, 0])


def _handshake_reply(raw: str, frame_size: int) -> tuple[object, str]:
    """Negotiate the audio codec from the client's JSON offer."""
    from rstnet_tpu.serving import opus

    try:
        offer = json.loads(raw).get("codec", "pcm16")
    except (ValueError, AttributeError):
        offer = "pcm16"
    codec = opus.negotiate(offer, frame_size)
    return opus.make_transport(codec), json.dumps({"codec": codec})


async def _send_frame(ws, audio, text_token, transport):
    await ws.send_bytes(TAG_AUDIO + transport.pack(audio))
    if text_token is not None and text_token not in TEXT_SKIP_IDS:
        await ws.send_bytes(TAG_TEXT + str(text_token).encode())


async def handle_chat(state: ServerState, request):
    """Per-connection duplex loop: one session at a time."""
    from aiohttp import WSMsgType, web

    from rstnet_tpu.serving import opus

    ws = web.WebSocketResponse()
    await ws.prepare(request)
    async with state.lock:
        state.reset()
        logging.info("chat session started")
        buffered = np.zeros((0,), np.float32)
        transport = None
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
                frame = buffered[: state.frame_size]
                buffered = buffered[state.frame_size :]
                t0 = time.perf_counter()
                audio, text_token = state.handle_frame_array(frame)
                logging.info("frame handled in %.1f ms", (time.perf_counter() - t0) * 1000)
                if audio is not None:
                    await _send_frame(ws, audio, text_token, transport)
        logging.info("chat session ended")
    return ws


def build_app(state: ServerState):
    from aiohttp import web

    from rstnet_tpu.serving import opus

    async def handle_index(request):
        return web.FileResponse(os.path.join(os.path.dirname(opus.__file__), "static",
                                             "index.html"))

    app = web.Application()
    app.router.add_get("/", handle_index)
    app.router.add_get("/api/chat", lambda req: handle_chat(state, req))
    return app


_NOT_YET = {
    "batch": "queue 1: the session batcher (--batch/--pipeline/--wire)",
    "scan_frames": "queue 1: LMGen.step_scan as a CUDA-graph replay (--scan-frames)",
    "int8": "queue 1: int8 K1 (--int8/--int8-dep/--int8-head)",
    "int8_dep": "queue 1: int8 K1 (--int8/--int8-dep/--int8-head)",
    "int8_head": "queue 1: int8 K1 (--int8/--int8-dep/--int8-head)",
    "kv_int8": "queue 1: int8 ring K/V (--kv-int8)",
}


def build_models(tiny: bool, device, seed: int):
    """(mimi, lm_gen) with random weights drawn from ``seed``: the tiny demo
    pair, or Mimi 24 kHz (f32) + Moshi 7B (bf16)."""
    from rstnet_tpu_torch.models.mimi import mimi_24k
    from rstnet_tpu_torch.models.moshi_lm import MoshiLMModel, moshi_7b

    g = torch.Generator(device=device).manual_seed(seed)
    if tiny:
        mimi = mimi_24k(n_q_total=8, dimension=64, n_filters=8, num_layers=2,
                        quantizer_dim=32, bins=64, device=device, generator=g)
        lm = MoshiLMModel(
            delays=(0,) * 17, n_q=16, dep_q=8, card=64, text_card=256, dim=64,
            num_heads=4, num_layers=2, hidden_scale=4.0, context=64,
            existing_text_padding_id=3, depformer_dim=32, depformer_dim_feedforward=64,
            depformer_num_heads=2, depformer_num_layers=1, device=device, generator=g)
        return mimi, LMGen(lm, delays=lm.delays, top_k=32)
    mimi = mimi_24k(device=device, generator=g)
    lm = moshi_7b(device=device, dtype=torch.bfloat16, generator=g)
    return mimi, LMGen(lm, delays=lm.delays)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--host", default="localhost")
    parser.add_argument("--port", type=int, default=8998)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--seed", type=int, default=0,
                        help="seeds the random weights and the sampling generator")
    parser.add_argument("--tiny", action="store_true",
                        help="small random-weight models (demo/smoke)")
    parser.add_argument("--ssl", default="", metavar="DIR",
                        help="serve wss/https with DIR/cert.pem + DIR/key.pem")
    parser.add_argument("--batch", type=int, default=0, metavar="N")
    parser.add_argument("--scan-frames", type=int, default=0, metavar="N")
    parser.add_argument("--int8", action="store_true")
    parser.add_argument("--int8-dep", action="store_true")
    parser.add_argument("--int8-head", action="store_true")
    parser.add_argument("--kv-int8", action="store_true")
    args = parser.parse_args(argv)
    for name, item in _NOT_YET.items():
        if getattr(args, name):
            raise NotImplementedError(f"--{name.replace('_', '-')} is not ported yet "
                                      f"(ROADMAP.md {item})")
    from aiohttp import web

    ssl_context = None
    if args.ssl:
        import ssl

        ssl_context = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ssl_context.load_cert_chain(certfile=os.path.join(args.ssl, "cert.pem"),
                                    keyfile=os.path.join(args.ssl, "key.pem"))
    device = torch.device(args.device)
    if device.type == "cuda":
        # the reference precision: true fp32 matmuls and convolutions
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    mimi, lm_gen = build_models(args.tiny, device, args.seed)
    state = ServerState(mimi, lm_gen, seed=args.seed)
    logging.info("warming up...")
    state.warmup()
    logging.info("serving ws://%s:%d/api/chat", args.host, args.port)
    web.run_app(build_app(state), host=args.host, port=args.port, ssl_context=ssl_context)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
