"""Decide ``correct``: the program's outputs against the plain reference.

Once the window has closed and the program is freed, the reference draws
the weights again from the seed and works out, for every session and every
recorded step, from the same audio:

* ``enc_gap``: Mimi's encode. Along the residual chain of the codes the
  program chose (the user codes its LM took in), the widest gap between the
  float64 distance to the chosen centroid and to the nearest one, over the
  median distance of that row.
* ``text_gap``, ``audio_gap``: ``LMGen.step``. The reference runs the
  backbone over the session's backbone inputs (rebuilt from its generated
  tokens and user codes) and the depformer over each frame's generated
  tokens; the widest gap by which a served text token, and a generated audio
  token, lies below the reference's best logit at its position, over the
  standard deviation of that position's logits. Decoding is greedy, so the
  program's tokens are its own best. ``text_mean`` and ``audio_mean`` are
  the same gaps' means over every judged token: steadier from seed to seed,
  and they grow with both how often a token departs from the reference's
  best and by how much.
* ``dec_err``: Mimi's decode. The served audio against the reference's
  decode of the same codes: the largest absolute difference over the
  reference audio's RMS, the widest over sessions.

The control (``control=True``) puts the reference in the program's place one
precision step down: Mimi in TF32, the LM's matrices and embedding tables
one step below what the configuration stores (bf16 -> float8 e4m3, int8 ->
int4), and an int8 ring as int4. Its codes
come from its own encode, its tokens are what it puts first at each position
of the same inputs, and its audio is its decode of the program's codes.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.lib.weights import draw
from portbench.reference import layout
from portbench.reference.mimi import MimiReference
from portbench.reference.moshi import MATRICES, TABLES, MoshiReference

NUMBERS = ("enc_gap", "text_gap", "audio_gap", "text_mean", "audio_mean", "dec_err")
CHUNK = 4  # sessions the reference takes at once


def program_formats(cfg: dict) -> dict:
    """The matrices the configuration serves in int8 (``--int8``)."""
    return {m: "int8" for m in MATRICES} if "--int8" in cfg["server_flags"] else {}


def control_formats(cfg: dict) -> dict:
    """One step below what the configuration stores: int8 -> int4, and the
    bf16 matrices and embedding tables to float8 e4m3."""
    bf16 = ("text_linear.weight", *TABLES)
    if "--int8" in cfg["server_flags"]:
        return {**{m: "int4" for m in MATRICES}, **{m: "fp8" for m in bf16}}
    return {m: "fp8" for m in (*MATRICES, *bf16)}


def unpack(record: dict, z: dict) -> dict:
    """Per session and step, from the ring after each step: the backbone
    input (``current``), the generated tokens (``gen``), the user codes
    (``user``, -3 where the ring no longer held them), the codes the step
    decoded (``dec_codes``) and the served text tokens."""
    ring = record["ring"].long()  # [T, B, K, CT]
    T, B, K, CT = ring.shape
    M, delays, S = max(z["delays"]), z["delays"], z["dep_q"]
    t = torch.arange(T)

    def pick(shift: int) -> torch.Tensor:
        """[T, B, K]: each step's ring column at its position + ``shift``."""
        return ring[t, :, :, (record["offset0"] + t + shift) % CT]

    current = pick(0)
    nxt = pick(1)
    gen = nxt[:, :, : S + 1]
    user = torch.full((T, B, K - S - 1), -3, dtype=torch.long)
    for j in range(K - S - 1):
        d = delays[S + 1 + j]
        held = pick(d)[:, :, S + 1 + j]
        user[:, :, j] = torch.where((t >= 1)[:, None] | (d > 0), held, -3)
    # the step's output frame: stream k at ring position t + 1 - M + d_k
    dec = torch.empty((T, B, S), dtype=torch.long)
    for k in range(1, S + 1):
        p = t + 1 - M + delays[k]
        src = torch.where((p == t + 1)[:, None], gen[:, :, k],
                          current[p.clamp(0, T - 1), :, k])
        dec[:, :, k - 1] = src
    text = torch.tensor([[o[1] if o[1] is not None else -3 for o in step]
                         for step in record["outputs"]])  # [T, B]
    # the served text token at step t was generated at step t - M + d_0
    text_step = t - M + delays[0]
    return {"gen": gen.permute(1, 2, 0), "user": user.permute(1, 2, 0),
            "dec_codes": dec.permute(1, 2, 0), "text": text.T, "text_step": text_step,
            "M": M, "T": T}


def _token_gaps(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """(best - chosen) / std over the last axis of ``logits`` [..., V]."""
    chosen = logits.gather(-1, tokens[..., None].clamp(0, logits.shape[-1] - 1))[..., 0]
    return (logits.amax(-1) - chosen) / logits.std(-1)


def _code_gaps(xs: list, codebooks: list, codes: torch.Tensor) -> torch.Tensor:
    """Widest relative distance gap of ``codes`` [B, Q, T] (-3: unknown, then
    the nearest is taken) along their residual chain over ``xs``."""
    worst = torch.zeros((), dtype=torch.float64, device=codes.device)
    level = 0
    for x, (_, cb) in zip(xs, codebooks):
        r = x.double()
        for i in range(cb.shape[0]):
            c = cb[i].double()
            dist = r.square().sum(-1, keepdim=True) + c.square().sum(-1) - 2.0 * (r @ c.T)
            chosen = codes[:, level]
            chosen = torch.where(chosen >= 0, chosen, dist.argmin(-1))
            gap = (dist.gather(-1, chosen[..., None])[..., 0] - dist.amin(-1)) \
                / dist.median(-1).values
            worst = torch.maximum(worst, gap.max())
            r = r - c[chosen]
            level += 1
    return worst


def check(cfg: dict, traffic: dict, seed: int, record: dict, frames: np.ndarray, device: str,
          control: bool = False) -> dict:
    """{number: reading} for the program, and with ``control`` also
    {"control": {number: reading}}."""
    z = layout.derived(cfg)
    u = unpack(record, z)
    W = draw(layout.spec(cfg), seed, device)
    kv_int8 = "--kv-int8" in cfg["server_flags"]
    mimi = MimiReference(W, z)
    lm = MoshiReference(W, z, program_formats(cfg), "int8" if kv_int8 else None)
    ctrl_mimi = MimiReference(W, z, tf32=True)
    ctrl_lm = MoshiReference(W, z, control_formats(cfg), "int4" if kv_int8 else None)
    solo = traffic["mode"] == "solo"
    M, T = u["M"], u["T"]
    n_sig = frames.shape[1]
    idx = np.arange(T) % n_sig
    worst = {k: 0.0 for k in NUMBERS}
    ctrl = {k: 0.0 for k in NUMBERS}
    sums = {"program": [0.0, 0.0, 0, 0], "control": [0.0, 0.0, 0, 0]}  # text, audio, counts
    for lo in range(0, frames.shape[0], CHUNK):
        sl = slice(lo, min(lo + CHUNK, frames.shape[0]))
        pcm = torch.from_numpy(frames[sl][:, idx].reshape(-1, 1, T * frames.shape[2])).to(device)
        gen, user = u["gen"][sl].to(device), u["user"][sl].to(device)
        # encode
        xs, cbs = mimi.projected(mimi.latent(pcm)), mimi.codebooks()
        worst["enc_gap"] = max(worst["enc_gap"], float(_code_gaps(xs, cbs, user)))
        # LM: text tokens as served, audio tokens as generated
        tokens = lm.backbone_inputs(gen, user.clamp(min=0))
        hidden, tlog = lm.backbone(tokens)
        steps = u["text_step"][M:]
        served = u["text"][sl, M:].to(device)
        alog = lm.depformer(hidden, gen)  # [b, T, S, card]
        _gaps(worst, sums["program"], _token_gaps(tlog[:, steps.to(device)], served),
              _token_gaps(alog, gen[:, 1:].permute(0, 2, 1)))
        # decode
        codes = u["dec_codes"][sl].to(device).clamp(0, z["bins"] - 1)
        ref_audio = (mimi.decode(codes, warm_frames=M) if solo
                     else mimi.decode(codes[..., M:]))[:, 0]
        served_audio = torch.from_numpy(np.stack([
            np.concatenate([record["outputs"][t][s][0] for t in range(M, T)])
            for s in range(sl.start, sl.stop)])).to(device)
        worst["dec_err"] = max(worst["dec_err"], _audio_err(served_audio, ref_audio))
        if control:
            ctrl_codes = ctrl_mimi.encode(pcm)
            ctrl["enc_gap"] = max(ctrl["enc_gap"], float(_code_gaps(xs, cbs, ctrl_codes)))
            c_hidden, c_tlog = ctrl_lm.backbone(tokens)
            c_alog = ctrl_lm.depformer(c_hidden, gen)
            _gaps(ctrl, sums["control"], _token_gaps(tlog, c_tlog.argmax(-1)),
                  _token_gaps(alog, c_alog.argmax(-1)))
            c_audio = (ctrl_mimi.decode(codes, warm_frames=M) if solo
                       else ctrl_mimi.decode(codes[..., M:]))[:, 0]
            ctrl["dec_err"] = max(ctrl["dec_err"], _audio_err(c_audio, ref_audio))
        del hidden, tlog, alog
    for numbers, (text, audio, n_text, n_audio) in ((worst, sums["program"]),
                                                    (ctrl, sums["control"])):
        numbers["text_mean"] = text / max(n_text, 1)
        numbers["audio_mean"] = audio / max(n_audio, 1)
    if control:
        worst["control"] = ctrl
    return worst


def _gaps(worst: dict, sums: list, text: torch.Tensor, audio: torch.Tensor) -> None:
    worst["text_gap"] = max(worst["text_gap"], float(text.max()))
    worst["audio_gap"] = max(worst["audio_gap"], float(audio.max()))
    sums[0] += float(text.double().sum())
    sums[1] += float(audio.double().sum())
    sums[2] += text.numel()
    sums[3] += audio.numel()


def _audio_err(audio: torch.Tensor, ref: torch.Tensor) -> float:
    err = (audio.float() - ref).abs().amax(-1) / ref.square().mean(-1).sqrt()
    return float(err.max())
