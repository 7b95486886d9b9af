"""Multi-session batched serving: one frame step, many concurrent calls
(counterpart of ``rstnet_tpu/serving/batcher.py``).

Up to ``max_sessions`` WebSocket sessions share one batched pipeline (codec
encode step + LM frame step + codec decode step) on an 80 ms frame clock:

* Every active connection owns a batch slot. Joining resets the slot
  (``LMGen.reset_slots`` and ``MimiModel.reset_*_slots``); the per-slot
  session age then floors each slot's attention lookback (``min_pos``), so
  slots are isolated while sharing the same ring caches.
* Starved slots (no audio queued this tick) step with silence, which keeps
  their streams real-time, as a duplex user who stays quiet.
* The batch is always ``max_sessions`` wide; empty slots compute rows that
  are never read.
* The tick is one method (``_fused_step``) over a dict of device tensors
  that it updates in place under ``_state_lock``. On the card it is
  captured once as a CUDA graph over static ``[B, 1, frame]`` input and
  output buffers (``serving/graphs.py``) and replayed every tick; joins and
  leaves reset their slots in place on the same buffers between replays,
  and the CPU runs it eagerly. At B > 1 every
  depformer micro-step's FFN runs kernel K2 (``ops/cuda_ffn.py``) and the
  batched Mimi encode runs K3 on B rows. Over int8 serving weights the FFN
  takes the dequantizing gather path instead of K2, as in JAX, so the tick
  runs K3 only; an int8 ring (``LMGen.kv_int8``) needs no slot clearing
  either, since ``min_pos`` hides a slot's older keys.

``pipeline_depth > 1`` copies each frame's outputs to pinned host memory at
dispatch and fetches frame ``t - depth + 1`` on tick ``t``, overlapping the
copy with the next frame's work at the price of ``depth - 1`` frames of
latency; ``auto_pipeline_depth`` decides from the measured round trip.
"""

from __future__ import annotations

import asyncio
import collections
import concurrent.futures
import dataclasses
import logging
import os
import threading
import time
from typing import Optional

import numpy as np
import torch

from rstnet_tpu_torch.inference.generate import LMGen
from rstnet_tpu_torch.serving.graphs import CapturedStep, copy_tree_, weights_key
from rstnet_tpu_torch.utils.latency import FrameLatencyTracker

FRAME_SECONDS = 0.08


def auto_pipeline_depth(budget_ms: float = FRAME_SECONDS * 1000.0, device="cuda") -> int:
    """Depth 2 (dispatch frame t, fetch frame t-1) only when a 4-element
    device->host round trip is a material slice of the frame budget;
    otherwise depth 1 avoids the extra frame of latency."""
    z = torch.zeros((4,), dtype=torch.int32, device=device)
    for _ in range(3):
        (z + 1).cpu()  # settle the allocator and the launch path
    rtts = []
    for _ in range(5):
        t0 = time.perf_counter()
        (z + 1).cpu()
        rtts.append((time.perf_counter() - t0) * 1000.0)
    rtt = sorted(rtts)[len(rtts) // 2]
    return 2 if rtt > 0.2 * budget_ms else 1


@dataclasses.dataclass
class Session:
    """One connection's handle onto a batch slot."""

    slot: int
    inputs: asyncio.Queue  # np.ndarray float32 [frame_size] PCM chunks
    outputs: asyncio.Queue  # (np.ndarray float32 [frame_size], text_token) or None


class SessionBatcher:
    """Batched multi-session duplex pipeline on a fixed frame clock."""

    def __init__(self, mimi, lm_gen: LMGen, max_sessions: int = 8, dtype=torch.bfloat16,
                 pipeline_depth: int = 1, wire_dtype: str = "float32",
                 fetch_pool: Optional[int] = None, seed: int = 0, cuda_graphs: bool = True,
                 text_tokenizer=None):
        """``dtype``: the LM state's (the codec state is float32).
        ``text_tokenizer`` is what the batched app decodes text with (None:
        token ids).
        ``seed`` seeds the batcher's sampling generator. The clock steps one
        frame a tick, as the JAX batcher does. ``cuda_graphs`` (on a CUDA
        device) replays the tick as a CUDA graph.

        ``wire_dtype="int16"`` moves PCM between host and device as 16-bit
        integers, the format WebSocket clients send and receive, and converts
        to and from float on the device.

        ``fetch_pool`` (default: ``pipeline_depth`` when depth > 1, else
        none) waits for each in-flight frame's device->host copy in a small
        thread pool, submitted at dispatch, so the tick thread keeps
        dispatching. ``RSTNET_BATCHER_FETCH_POOL=N`` overrides it (0 turns
        it off); ``RSTNET_BATCHER_ASYNC_FETCH=0`` turns off the copy to
        pinned memory at dispatch (the fetch then copies when it runs).
        Dispatch->delivery latency per frame is tracked in
        ``delivery_latency``, the tick time in ``latency``."""
        self.text_tokenizer = text_tokenizer
        # Slot isolation relies on relative positions: a slot joining at
        # global offset t must behave as a fresh stream at 0, which absolute
        # sin embeddings would break.
        for tr in (getattr(lm_gen.model, "transformer", None),
                   mimi.encoder_transformer.transformer, mimi.decoder_transformer.transformer):
            if tr is not None and tr.positional_embedding not in ("rope", "none"):
                raise ValueError("multi-session batching needs relative positions "
                                 f"(rope/none), got {tr.positional_embedding!r}")
        self.mimi, self.lm_gen = mimi, lm_gen
        self.max_sessions = B = int(max_sessions)
        self.frame_size = mimi.frame_size
        self.device = dev = next(mimi.parameters()).device
        self._state = {
            "enc": mimi.init_encode_state(B, device=dev),
            "dec": mimi.init_decode_state(B, device=dev),
            "lm": lm_gen.init_state(B, dtype=dtype, device=dev),
            "age": torch.zeros((B,), dtype=torch.long, device=dev),
            # the decoder age counts only valid frames: during a slot's LM
            # delay warmup the generated rows hold UNGENERATED ids, whose
            # decode the step discards and undoes at the first valid frame
            "dec_age": torch.zeros((B,), dtype=torch.long, device=dev),
        }
        self.generator = torch.Generator(device=dev).manual_seed(seed)
        self.wire_int16 = wire_dtype in ("int16", "pcm16")
        self.cuda_graphs = cuda_graphs and dev.type == "cuda"
        self._graph: Optional[CapturedStep] = None
        # host mirrors of the per-slot ages: validity is a deterministic
        # counter, so the host never reads the device copies
        self.age = np.zeros((B,), np.int32)
        self.dec_age = np.zeros((B,), np.int32)
        self.sessions: dict[int, Session] = {}
        self._free = list(range(B))
        # per-slot generation, bumped on every acquire: a frame computed for
        # a slot's previous occupant is never delivered to a new one
        self._gen = [0] * B
        self._task: Optional[asyncio.Task] = None
        self.pipeline_depth = max(1, int(pipeline_depth))
        self._async_fetch = (self.pipeline_depth > 1
                             and os.environ.get("RSTNET_BATCHER_ASYNC_FETCH") != "0")
        env_pool = os.environ.get("RSTNET_BATCHER_FETCH_POOL")
        if env_pool is not None:
            fetch_pool = int(env_pool)
        if fetch_pool is None:
            fetch_pool = self.pipeline_depth if self.pipeline_depth > 1 else 0
        self.fetch_pool = max(0, int(fetch_pool))
        self._pool = (concurrent.futures.ThreadPoolExecutor(
            max_workers=self.fetch_pool, thread_name_prefix="batcher-fetch")
            if self.fetch_pool > 0 else None)
        # a frame is delivered depth - 1 ticks after dispatch by construction,
        # so the delivery budget is depth frames
        self.delivery_latency = FrameLatencyTracker(
            budget_ms=self.pipeline_depth * FRAME_SECONDS * 1000.0)
        # dispatched, not yet fetched: (snapshot, payload or future, valid, t0)
        self._inflight: collections.deque = collections.deque()
        self.last_step_ms = 0.0
        # every tick is one frame for every active session: this is the
        # per-session frame-latency distribution
        self.latency = FrameLatencyTracker(budget_ms=FRAME_SECONDS * 1000.0)
        # the tick runs in a worker thread while acquire/release reset slots
        # of the same state from the event loop
        self._state_lock = threading.Lock()

    # -- the frame step -------------------------------------------------------

    @torch.no_grad()
    def _fused_step(self, state: dict, pcm: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Codec encode + LM frame + codec decode + age bookkeeping on
        [B, 1, frame_size] PCM, updating ``state`` in place: (audio
        [B, 1, frame_size], tokens [B, dep_q + 1, 1])."""
        mimi, gen = self.mimi, self.lm_gen
        if self.wire_int16:
            pcm = pcm.float() * (1.0 / 32767.0)
        codes, state["enc"] = mimi.encode_step(state["enc"], pcm, state["age"])
        user = codes[:, : gen.num_user_streams, :] if gen.num_user_streams else None
        out, valid, state["lm"] = gen.step(state["lm"], self.generator, user)
        # slots at their first valid frame drop the decoder state that their
        # warmup frames advanced
        first_valid = valid & (state["dec_age"] == 0)
        dec_state = mimi.mask_decode_slots(state["dec"], first_valid)
        # warmup rows hold UNGENERATED ids: clamp them so the discarded
        # decode stays finite
        codes_out = out[:, 1:, :].clamp(0, mimi.quantizer.bins - 1)
        audio, state["dec"] = mimi.decode_step(dec_state, codes_out, state["dec_age"])
        state["age"] += 1
        state["dec_age"] += valid.long()
        if self.wire_int16:
            audio = (audio.clamp(-1.0, 1.0) * 32767.0).to(torch.int16)
        return audio, out

    @property
    def enc_state(self) -> dict:
        return self._state["enc"]

    @property
    def dec_state(self) -> dict:
        return self._state["dec"]

    @property
    def lm_state(self) -> dict:
        return self._state["lm"]

    # -- slot management ------------------------------------------------------

    def acquire(self) -> Optional[Session]:
        """Join: claim a slot and reset its streams. None when full."""
        if not self._free:
            return None
        slot = self._free.pop(0)
        with self._state_lock:
            # the generation bump and the reset are seen together by a tick
            self._gen[slot] += 1
            st = self._state
            # in place: a captured tick holds these buffers
            copy_tree_(st["enc"], self.mimi.reset_encode_slots(st["enc"], [slot]))
            copy_tree_(st["dec"], self.mimi.reset_decode_slots(st["dec"], [slot]))
            self.lm_gen.reset_slots(st["lm"], [slot])
            st["age"][slot] = 0
            st["dec_age"][slot] = 0
            self.age[slot] = 0
            self.dec_age[slot] = 0
        sess = Session(slot, asyncio.Queue(maxsize=64), asyncio.Queue(maxsize=64))
        self.sessions[slot] = sess
        return sess

    def release(self, sess: Session) -> None:
        # idempotent: _fail_sessions may have freed the slot already
        if self.sessions.get(sess.slot) is sess or (
                sess.slot not in self.sessions and sess.slot not in self._free):
            self.sessions.pop(sess.slot, None)
            if sess.slot not in self._free:
                self._free.append(sess.slot)

    # -- the frame clock ------------------------------------------------------

    def _gather_inputs(self) -> tuple[np.ndarray, dict[int, int]]:
        """One frame per active session (event-loop thread only: asyncio
        queues are not thread-safe), with each active slot's generation."""
        pcm = np.zeros((self.max_sessions, 1, self.frame_size), np.float32)
        snapshot: dict[int, int] = {}
        for slot, sess in list(self.sessions.items()):
            snapshot[slot] = self._gen[slot]
            try:
                pcm[slot, 0] = sess.inputs.get_nowait()
            except asyncio.QueueEmpty:
                pass  # silence keeps the duplex clock running
        return pcm, snapshot

    def _tick(self, pcm: np.ndarray) -> tuple[torch.Tensor, torch.Tensor]:
        """One tick on the device: eager, or a replay of the captured tick
        (captured at its second call; the first warms it up)."""
        pcm_t = torch.from_numpy(pcm)
        if not self.cuda_graphs:
            return self._fused_step(self._state, pcm_t.to(self.device))
        if self._graph is None:
            def step(state, pcm_in):
                return self._fused_step(state, pcm_in), state

            self._graph = CapturedStep(
                step, self._state, (torch.zeros(pcm_t.shape, dtype=pcm_t.dtype,
                                                device=self.device),),
                generators=(self.generator,),
                key=lambda: weights_key(self.mimi, self.lm_gen.model), name="batched tick",
                modules=(self.mimi, self.lm_gen.model))
        # pageable memory: the copy returns once the source is staged
        self._graph.inputs[0].copy_(pcm_t, non_blocking=True)
        return self._graph()

    def _start_fetch(self, audio: torch.Tensor, out: torch.Tensor):
        """At dispatch: with async fetch on the card, start copies of the
        outputs into pinned host memory and record an event after them. A
        replayed tick's outputs are static, so without async fetch they are
        copied on the device: the next replay, later on the same stream,
        cannot overwrite a frame that is still to be fetched."""
        if not (self._async_fetch and audio.is_cuda):
            if self._graph is not None and self._graph.graph is not None:
                audio, out = audio.clone(), out.clone()
            return audio, out, None
        host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in (audio, out)]
        for h, t in zip(host, (audio, out)):
            h.copy_(t, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return host[0], host[1], event

    @staticmethod
    def _finish_fetch(payload) -> tuple[np.ndarray, np.ndarray]:
        audio, out, event = payload
        if event is not None:
            event.synchronize()
        return audio.cpu().numpy(), out.cpu().numpy()

    def _device_step(self, pcm: np.ndarray, snapshot: Optional[dict[int, int]] = None):
        """One tick (safe in a worker thread): dispatch this frame's step,
        then fetch the oldest in-flight frame once ``pipeline_depth`` are
        queued (at depth 1, the frame just dispatched).

        Returns ``(snapshot, audio_np, out_np, valid_np)`` of the fetched
        frame, or None while the pipeline fills."""
        with self._state_lock:
            if snapshot is not None:
                # a slot re-acquired after the gather must not feed the
                # previous occupant's audio into the new session's state
                for slot, gen in snapshot.items():
                    if self._gen[slot] != gen:
                        pcm[slot] = 0.0
            t0 = time.perf_counter()
            if self.wire_int16:
                pcm = (np.clip(pcm, -1.0, 1.0) * 32767.0).astype(np.int16)
            audio, out = self._tick(pcm)
            # validity is deterministic from the ages: no device sync
            valid_np = (self.age + 1) > self.lm_gen.max_delay
            self.age += 1
            self.dec_age += valid_np.astype(np.int32)
            payload = self._start_fetch(audio, out)
            if self._pool is not None:
                payload = self._pool.submit(self._finish_fetch, payload)
            self._inflight.append((snapshot, payload, valid_np, t0))
            if len(self._inflight) < self.pipeline_depth:
                return None
            old_snap, old_payload, valid_old, t_dispatch = self._inflight.popleft()
            if self._pool is not None:
                audio_np, out_np = old_payload.result()
            else:
                audio_np, out_np = self._finish_fetch(old_payload)
            now = time.perf_counter()
            self.delivery_latency.record((now - t_dispatch) * 1000.0)
            self.last_step_ms = (now - t0) * 1000.0
            self.latency.record(self.last_step_ms)
        if self.wire_int16:
            audio_np = audio_np.astype(np.float32) * (1.0 / 32767.0)
        return old_snap, audio_np, out_np, valid_old

    def _distribute(self, result) -> None:
        """Route a fetched frame to session queues (event-loop thread only):
        a frame goes only to the occupant it was computed for."""
        if result is None:
            return
        snapshot, audio_np, out_np, valid_np = result
        snapshot = snapshot or {}
        for slot, sess in list(self.sessions.items()):
            if snapshot.get(slot) != self._gen[slot] or not valid_np[slot]:
                continue
            try:
                sess.outputs.put_nowait((audio_np[slot, 0], int(out_np[slot, 0, 0])))
            except asyncio.QueueFull:
                logging.warning("slot %d output queue full; dropping frame", slot)

    def step_once(self) -> None:
        """One batched frame across all active sessions (synchronous)."""
        if not self.sessions:
            return
        pcm, snapshot = self._gather_inputs()
        self._distribute(self._device_step(pcm, snapshot))

    def _fail_sessions(self, exc: BaseException) -> None:
        """Close every active session after a step failure, so clients see
        the error instead of a frozen stream."""
        for slot, sess in list(self.sessions.items()):
            # the close sentinel must not be lost to a full queue: the
            # stream is dead, so drop its buffered frames to make room
            try:
                sess.outputs.put_nowait(None)
            except asyncio.QueueFull:
                while True:
                    try:
                        sess.outputs.get_nowait()
                    except asyncio.QueueEmpty:
                        break
                sess.outputs.put_nowait(None)
            self.sessions.pop(slot, None)
            if slot not in self._free:
                self._free.append(slot)
        self._inflight.clear()  # in-flight frames belong to dead sessions
        logging.error("batched frame step failed; closed all sessions: %r", exc)

    async def run(self) -> None:
        """The 80 ms frame clock; start once per server. The tick runs in a
        worker thread so the event loop keeps serving every connection's
        WebSocket while the card works."""
        loop = asyncio.get_running_loop()
        next_tick = loop.time()
        while True:
            next_tick += FRAME_SECONDS
            if self.sessions:
                try:
                    pcm, snapshot = self._gather_inputs()
                    result = await loop.run_in_executor(None, self._device_step, pcm, snapshot)
                    self._distribute(result)
                except asyncio.CancelledError:
                    raise
                except Exception as e:  # noqa: BLE001 - the clock must survive
                    # close the broken sessions and keep ticking: new
                    # sessions reset their slots on join
                    self._fail_sessions(e)
                if self.last_step_ms > FRAME_SECONDS * 1000:
                    logging.warning("frame step %.1f ms exceeds the %.0f ms budget",
                                    self.last_step_ms, FRAME_SECONDS * 1000)
                n = len(self.latency.samples_ms)
                if n and n % 750 == 0:  # about once a minute at the frame rate
                    logging.info("frame latency: %s", self.latency.summary())
            delay = next_tick - loop.time()
            if delay <= 0:  # fell behind: resync the clock instead of bursting
                next_tick = loop.time()
                delay = 0.0
            await asyncio.sleep(delay)

    def start(self) -> None:
        if self._task is None or self._task.done():
            self._task = asyncio.get_running_loop().create_task(self.run())

    def warmup(self, n_frames: int = 2) -> None:
        """A few frames before accepting traffic (allocator, cuDNN plans,
        kernel build), enough to fill the pipeline and exercise the fetch."""
        sess = self.acquire()
        for _ in range(max(n_frames, self.pipeline_depth + 1)):
            self.step_once()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.release(sess)
        self._inflight.clear()
        # warmup frames (first launches, kernel build) are not the serving tail
        self.latency.samples_ms.clear()
        self.delivery_latency.samples_ms.clear()
