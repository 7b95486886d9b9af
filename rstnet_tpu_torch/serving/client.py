"""Duplex voice client (counterpart of ``rstnet_tpu/serving/client.py``,
against the port's server: its ``TAG_AUDIO``/``TAG_TEXT`` and
``serving/opus.py``).

    python -m rstnet_tpu_torch.serving.client --url ws://localhost:8998/api/chat \
        [--in-wav IN.wav --out-wav OUT.wav | --sessions N --seconds S] [--codec pcm16]

Capability parity with ``MLLM_v2/moshi/client.py:19-196``: streams 80 ms
audio frames to the server and plays/collects the response audio and text.
Microphone/speaker IO uses ``sounddevice`` when importable; otherwise the
client runs in file mode — read a wav, stream it frame by frame, write the
response wav and print text (which is also what the tests drive).
"""

from __future__ import annotations

import argparse
import asyncio
from typing import Optional

import numpy as np

from rstnet_tpu_torch.serving.server import TAG_AUDIO, TAG_TEXT
from rstnet_tpu_torch.utils.audio import pcm16_to_float, read_wav, resample_linear, write_wav

SAMPLE_RATE = 24000
FRAME_SIZE = 1920


async def _negotiate(ws, codec: str):
    """Send the codec handshake; return the transport for the accepted
    codec (reference clients negotiate Opus framing, ``client.py:60-120``)."""
    import json

    from rstnet_tpu_torch.serving import opus

    if codec == "legacy":  # pre-handshake wire format: raw PCM16
        return opus.Pcm16Transport()
    if codec == "opus" and not opus.available():
        # never offer a codec this host can't decode: the server would
        # accept and the reply would be unusable — fall back before offering
        codec = "pcm16"
    await ws.send_str(json.dumps({"codec": codec}))
    reply = await ws.receive_str()
    accepted = json.loads(reply).get("codec", "pcm16")
    return opus.make_transport(accepted)


async def stream_file(
    url: str, in_wav: str, out_wav: Optional[str] = None,
    drain_timeout: float = 30.0, codec: str = "opus",
) -> tuple[np.ndarray, str]:
    """Send a wav file frame-by-frame; return (response audio, text).

    Waits until the server has answered (close to) one audio frame per
    frame sent before closing — a ``--batch`` server consumes one frame
    per 80 ms tick, so closing right after the last send would drop most
    of the response.
    """
    import aiohttp

    wav, sr = read_wav(in_wav)
    wav = resample_linear(wav, sr, SAMPLE_RATE)[0]
    pad = (-len(wav)) % FRAME_SIZE
    wav = np.pad(wav, (0, pad))
    n_frames = len(wav) // FRAME_SIZE
    out_audio: list[np.ndarray] = []
    text_parts: list[str] = []
    drained = asyncio.Event()
    async with aiohttp.ClientSession() as session:
        async with session.ws_connect(url) as ws:
            transport = await _negotiate(ws, codec)

            async def sender():
                for off in range(0, len(wav), FRAME_SIZE):
                    frame = wav[off : off + FRAME_SIZE]
                    await ws.send_bytes(TAG_AUDIO + transport.pack(frame))
                    await asyncio.sleep(0)  # yield; real-time pacing optional
                # drain: all frames answered, 1 s of silence (the server owes
                # fewer than n_frames when the model has delays), or timeout
                deadline = asyncio.get_event_loop().time() + drain_timeout
                while not drained.is_set():
                    before = len(out_audio)
                    try:
                        await asyncio.wait_for(drained.wait(), timeout=1.0)
                    except asyncio.TimeoutError:
                        pass
                    if len(out_audio) == before or (
                        asyncio.get_event_loop().time() > deadline
                    ):
                        break
                await ws.close()

            async def receiver():
                async for msg in ws:
                    if not isinstance(msg.data, (bytes, bytearray)):
                        continue
                    data = bytes(msg.data)
                    if data[:1] == TAG_AUDIO:
                        out_audio.append(transport.unpack(data[1:]))
                        if len(out_audio) >= n_frames:
                            drained.set()
                    elif data[:1] == TAG_TEXT:
                        text_parts.append(data[1:].decode())

            await asyncio.gather(sender(), receiver())
    audio = np.concatenate(out_audio) if out_audio else np.zeros((0,), np.float32)
    if out_wav:
        write_wav(out_wav, audio, SAMPLE_RATE)
    return audio, "".join(text_parts)


async def load_test(
    url: str, sessions: int, seconds: float = 4.0, real_time: bool = True,
    codec: str = "pcm16",
) -> list[dict]:
    """Drive N concurrent duplex sessions against a ``--batch`` server.

    Each session streams ``seconds`` of synthetic audio at the real-time
    frame cadence (80 ms) and measures what it gets back: frames received,
    end-to-end latency of the first response frame, and receive rate.
    Returns one stats dict per session.
    """
    import time as _time

    import aiohttp

    n_frames = int(seconds / 0.08)

    async def one(i: int) -> dict:
        t = np.arange(n_frames * FRAME_SIZE) / SAMPLE_RATE
        wav = (0.1 * np.sin(2 * np.pi * (220 + 20 * i) * t)).astype(np.float32)
        stats = {"session": i, "frames_sent": n_frames, "frames_recv": 0,
                 "first_frame_ms": None}
        async with aiohttp.ClientSession() as session:
            async with session.ws_connect(url) as ws:
                transport = await _negotiate(ws, codec)
                t0 = _time.perf_counter()
                done = asyncio.Event()

                async def sender():
                    for off in range(0, len(wav), FRAME_SIZE):
                        await ws.send_bytes(
                            TAG_AUDIO + transport.pack(wav[off : off + FRAME_SIZE])
                        )
                        if real_time:
                            await asyncio.sleep(0.08)
                    # allow the tail of the pipeline to drain, then close
                    try:
                        await asyncio.wait_for(done.wait(), timeout=2.0)
                    except asyncio.TimeoutError:
                        pass
                    await ws.close()

                async def receiver():
                    async for msg in ws:
                        if not isinstance(msg.data, bytes):
                            break
                        if bytes(msg.data[:1]) == TAG_AUDIO:
                            if stats["first_frame_ms"] is None:
                                stats["first_frame_ms"] = round(
                                    (_time.perf_counter() - t0) * 1000, 1
                                )
                            stats["frames_recv"] += 1
                            if stats["frames_recv"] >= n_frames:
                                done.set()

                await asyncio.gather(sender(), receiver())
        return stats

    return list(await asyncio.gather(*(one(i) for i in range(sessions))))


async def stream_microphone(url: str) -> None:  # pragma: no cover - needs audio HW
    """Live mic/speaker loop (requires sounddevice)."""
    import aiohttp
    import sounddevice as sd

    in_q: asyncio.Queue = asyncio.Queue()
    loop = asyncio.get_event_loop()

    def on_input(indata, frames, time_info, status):
        loop.call_soon_threadsafe(in_q.put_nowait, bytes(indata))

    out_buf = np.zeros((0,), np.float32)

    def on_output(outdata, frames, time_info, status):
        nonlocal out_buf
        n = min(len(out_buf), frames)
        outdata[:n, 0] = out_buf[:n]
        outdata[n:, 0] = 0
        out_buf = out_buf[n:]

    with sd.InputStream(
        samplerate=SAMPLE_RATE, channels=1, dtype="int16",
        blocksize=FRAME_SIZE, callback=on_input,
    ), sd.OutputStream(
        samplerate=SAMPLE_RATE, channels=1, callback=on_output
    ):
        async with aiohttp.ClientSession() as session:
            async with session.ws_connect(url) as ws:
                async def sender():
                    while True:
                        data = await in_q.get()
                        await ws.send_bytes(TAG_AUDIO + data)

                async def receiver():
                    nonlocal out_buf
                    async for msg in ws:
                        data = bytes(msg.data)
                        if data[:1] == TAG_AUDIO:
                            out_buf = np.concatenate([out_buf, pcm16_to_float(data[1:])])
                        elif data[:1] == TAG_TEXT:
                            print(data[1:].decode(), end="", flush=True)

                await asyncio.gather(sender(), receiver())


def main(argv=None):
    """Returns what the mode got: the load test's stats, or the file mode's
    (response audio, text); None in microphone mode."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--url", default="ws://localhost:8998/api/chat")
    parser.add_argument("--in-wav", default="", help="file mode input")
    parser.add_argument("--out-wav", default="out.wav")
    parser.add_argument(
        "--sessions", type=int, default=0, metavar="N",
        help="load-test mode: N concurrent synthetic sessions",
    )
    parser.add_argument("--seconds", type=float, default=4.0)
    parser.add_argument(
        "--codec", default="opus", choices=["opus", "pcm16", "legacy"],
        help="wire codec offer (server falls back to pcm16 without libopus)",
    )
    args = parser.parse_args(argv)
    if args.sessions:
        stats = asyncio.run(
            load_test(args.url, args.sessions, args.seconds, codec=args.codec)
        )
        for s in stats:
            print(s)
        return stats
    if args.in_wav:
        audio, text = asyncio.run(
            stream_file(args.url, args.in_wav, args.out_wav, codec=args.codec)
        )
        print(f"received {len(audio)} samples; text: {text}")
        return audio, text
    asyncio.run(stream_microphone(args.url))
    return None


if __name__ == "__main__":
    main()
