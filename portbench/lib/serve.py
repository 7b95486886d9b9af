"""Build the program's server from the harness's weights and drive it.

The server is built by its own entry, ``serving/server.py::build_server``
over ``parse_args`` with the cell's flags (int8 quantization, the batcher,
warm-up and CUDA graph capture all happen there). The harness stands in for
one function only, ``build_models``, the one that draws random weights: its
stand-in builds the same modules empty (on the ``meta`` device, then
allocated), loads the harness's seeded weights into them by name, pads the
depformer gating as the original does, and decodes greedily, so that every
served token can be judged against the reference's best.

:class:`Driver` then runs the sessions closed-loop and back to back, one
step as the server runs it: ``ServerState.handle_frame_array`` (solo) or
``SessionBatcher.step_once`` over the sessions' queues (batched). A step's
time runs from handing its inputs over until its audio and text token are
numpy arrays on the host. After each recorded step the LM's token ring (the
tokens the step generated and the codes it took from the user's audio) is
copied on the device into a history buffer, for the check after the window.
"""

from __future__ import annotations

import asyncio
import time

import numpy as np
import torch

from portbench.lib.weights import DTYPES, load


def build_server(cfg: dict, traffic: dict, seed: int, device: str, weights: dict):
    """(the server, what the program showed of itself while it warmed up:
    ``hidden_dtype``, the dtype of the backbone's output that the depth
    transformer's kernels take in)."""
    from rstnet_tpu_torch.inference.generate import LMGen
    from rstnet_tpu_torch.models.mimi import mimi_24k
    from rstnet_tpu_torch.models.moshi_lm import MoshiLMModel
    from rstnet_tpu_torch.modules.transformer import pad_codecformer_gating
    from rstnet_tpu_torch.serving import server as srv

    def build_models(tiny, dev, model_seed, mimi_checkpoint="", lm_checkpoint=""):
        mimi = mimi_24k(**cfg["mimi"], device="meta").to_empty(device=dev)
        lm = MoshiLMModel(**cfg["lm"], device="meta",
                          dtype=DTYPES[cfg["lm_dtype"]]).to_empty(device=dev)
        load(mimi, weights, "mimi.")
        load(lm, weights, "lm.")
        pad_codecformer_gating(lm.depformer)
        # eager calls only (warm-up, capture): a graph replay runs no hook
        lm.out_norm.register_forward_hook(
            lambda module, args, out: seen.update(hidden_dtype=str(out.dtype).split(".")[-1]))
        return mimi, LMGen(lm, delays=lm.delays, use_sampling=False)

    seen: dict = {}

    argv = ["--device", device, "--seed", str(seed), *cfg["server_flags"],
            *traffic["server_flags"]]
    original = srv.build_models
    srv.build_models = build_models
    try:
        return srv.build_server(srv.parse_args(argv)), seen
    finally:
        srv.build_models = original


class Driver:
    """The cell's sessions on a built server, stepped one at a time."""

    def __init__(self, server, traffic: dict, frames: np.ndarray, max_steps: int):
        self.server = server
        self.batched = traffic["mode"] == "batched"
        self.frames = frames  # [sessions, n, frame_size], fed cyclically
        if self.batched:
            self.sessions = [server.acquire() for _ in range(frames.shape[0])]
            if any(s is None for s in self.sessions):
                raise RuntimeError(f"the server took fewer than {frames.shape[0]} sessions")
            self.slots = [s.slot for s in self.sessions]
        else:
            if frames.shape[0] != 1:
                raise ValueError("a solo cell has one session")
            server.reset()
            self.slots = [0]
        cache = server.lm_state["cache"]
        self.offset0 = int(server.lm_state["offset"])  # the ring position of step 0
        self.hist = torch.empty((max_steps, *cache.shape), dtype=cache.dtype, device=cache.device)
        self.outputs: list = []  # per recorded step: [(audio | None, token | None)] a session
        self.steps = 0

    def step(self, record: bool = True) -> float:
        """One step for every session; its time in ms."""
        pcm = self.frames[:, self.steps % self.frames.shape[1]]
        t0 = time.perf_counter()
        if self.batched:
            for sess, frame in zip(self.sessions, pcm):
                sess.inputs.put_nowait(frame)
            self.server.step_once()
            outs = [self._delivered(sess) for sess in self.sessions]
        else:
            outs = [self.server.handle_frame_array(pcm[0])]
        ms = (time.perf_counter() - t0) * 1000.0
        if record:
            if self.steps >= self.hist.shape[0]:
                raise RuntimeError(f"more than {self.hist.shape[0]} steps: raise max_steps")
            self.hist[self.steps].copy_(self.server.lm_state["cache"])
            self.outputs.append(outs)
        self.steps += 1
        return ms

    @staticmethod
    def _delivered(sess):
        try:
            return sess.outputs.get_nowait()
        except asyncio.QueueEmpty:
            return (None, None)

    def ring_bytes(self) -> float:
        """What the backbone's ring stores for one position of one session in
        one layer (keys, values and any scales), from the program's state."""
        kv = self.server.lm_state["lm"]["kv"]
        layers = kv if isinstance(kv, list) else [kv]
        total = sum(t.numel() * t.element_size() for ring in layers for t in ring.values())
        k = layers[0]["k"]
        rings = len(layers) * (k.shape[0] if k.dim() == 5 else 1)  # a stacked [L, ...] ring
        return total / (rings * k.shape[-4] * k.shape[-2])

    def record(self) -> dict:
        """What the recorded steps produced, on the host: ``ring``
        [steps, sessions, streams, ring length] after each step, the ring
        position of step 0, and the served (audio, token) of each step."""
        ring = self.hist[: len(self.outputs)].cpu()[:, self.slots]
        return {"ring": ring, "offset0": self.offset0, "outputs": self.outputs}
