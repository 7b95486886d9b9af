"""Quantization quality bounds for the int8 serving modes (counterpart of
``rstnet_tpu/evalsuite/quant_quality.py``).

Three measures against the bf16 reference, on the streaming decode path the
server runs (ring KV, int8 rings included):

1. **Streaming teacher-forced CE/PPL** over a fixed token grid: every frame
   is forced and the model is scored on its next-frame logits, through
   ``step_global``/``step_codecformer`` (the backbone's MLP through K4/K5).
2. **Per-step sampled-token agreement**: at every step both models see the
   same forced history and the same random numbers (each step's generator
   is seeded from the seed and the step index), so the agreement of their
   samples bounds how often an int8 stack would emit another token.
3. **Greedy agreement** (argmax match), the temperature-free variant of 2.

The JAX version scans the frames in one jitted call; here a Python loop runs
them, with the same conditioning.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from rstnet_tpu_torch.ops.sampling import sample_token


@dataclasses.dataclass(frozen=True)
class TFStreamResult:
    """Per-variant result of a teacher-forced streaming pass."""

    ce_text: float       # mean CE (nats/token) over the text row
    ce_audio: float      # mean CE (nats/token) over the dep_q audio rows
    ppl_text: float
    ppl_audio: float
    sampled: np.ndarray  # [B, 1 + dep_q, T] per-step sampled tokens
    greedy: np.ndarray   # [B, 1 + dep_q, T] per-step argmax tokens


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of step ``step`` under ``seed``: the same pair gives the
    same samples in every call."""
    state = np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state))


@torch.no_grad()
def teacher_forced_stream(model, grid: np.ndarray, seed: int, kv_int8: bool = False,
                          kv_unstacked: bool = False, temp: float = 0.8, temp_text: float = 0.7,
                          top_k: int = 250, top_k_text: int = 25,
                          audio_max_card: Optional[int] = None,
                          state_dtype=torch.bfloat16) -> TFStreamResult:
    """Score and sample every next frame under forced history.

    grid: [B, K, T] tokens (text row 0, audio rows 1..n_q). Step t feeds
    ``[initial, grid[..., :-1]][t]`` and scores ``grid[..., t]``, the
    conditioning of the training forward, so the streaming CE equals the
    offline teacher-forced CE position for position."""
    cfg = model.config
    B, K, T = grid.shape
    if K != model.num_codebooks or T < 2:
        raise ValueError(f"grid {grid.shape}: expected [B, {model.num_codebooks}, T >= 2]")
    dev = next(model.parameters()).device
    dep_q = cfg.dep_q
    grid = torch.as_tensor(np.asarray(grid), device=dev).long()
    inputs = torch.cat([model.initial_frame(B, dev).long(), grid[:, :, :-1]], dim=2)
    lm_state = model.init_state(B, state_dtype, kv_int8=kv_int8, kv_unstacked=kv_unstacked,
                                device=dev)
    lps, sampled, greedy = [], [], []
    for t in range(T):
        g = step_generator(seed, t, dev)
        target = grid[:, :dep_q + 1, t]  # [B, 1 + dep_q]
        hidden, text_logits, lm_state = model.step_global(lm_state, inputs[:, :, t:t + 1])
        logits = [text_logits[:, 0].float()]
        step_s = [sample_token(logits[0], g, True, temp_text, top_k_text)]
        cf_state = model.init_codecformer_state(B, dtype=hidden.dtype, device=dev)
        prev = target[:, 0:1]  # the forced text conditions the depformer
        for cb in range(dep_q):
            out, cf_state = model.step_codecformer(cf_state, cb, prev, hidden)
            logits.append(out[:, 0].float())
            step_s.append(sample_token(logits[-1], g, True, temp, top_k, max_card=audio_max_card))
            prev = target[:, cb + 1:cb + 2]  # the forced audio conditions the next step
        lps.append(torch.stack([torch.log_softmax(lg, -1).gather(-1, target[:, i:i + 1])[:, 0]
                                for i, lg in enumerate(logits)], dim=1))
        sampled.append(torch.stack(step_s, dim=1))
        greedy.append(torch.stack([lg.argmax(-1) for lg in logits], dim=1))
    lps = torch.stack(lps).double().cpu().numpy()  # [T, B, 1 + dep_q]
    ce_text, ce_audio = float(-lps[:, :, 0].mean()), float(-lps[:, :, 1:].mean())
    return TFStreamResult(
        ce_text=ce_text, ce_audio=ce_audio, ppl_text=float(np.exp(ce_text)),
        ppl_audio=float(np.exp(ce_audio)),
        sampled=torch.stack(sampled, dim=2).cpu().numpy(),
        greedy=torch.stack(greedy, dim=2).cpu().numpy())


def agreement(a: np.ndarray, b: np.ndarray) -> float:
    """Fraction of token positions where two [B, n_gen, T] streams agree."""
    if a.shape != b.shape:
        raise ValueError(f"shapes differ: {a.shape} and {b.shape}")
    return float((a == b).mean())


def compare_quant_variants(model_bf16, variants: dict, grid: np.ndarray, seed: int,
                           **sample_kwargs) -> dict:
    """Quality table: each variant against the bf16 reference on one grid.

    ``variants``: name -> (model, kv_int8 flag); the models are separate
    (quantization works in place: quantize a copy). Returns ``{"rows",
    "results"}``; the ``bf16`` row is the reference (deltas zero)."""
    ref = teacher_forced_stream(model_bf16, grid, seed, **sample_kwargs)
    rows = {"bf16": {"ppl_text": round(ref.ppl_text, 4), "ppl_audio": round(ref.ppl_audio, 4),
                     "d_ce_text": 0.0, "d_ce_audio": 0.0, "agree_sampled": 1.0,
                     "agree_greedy": 1.0}}
    results = {"bf16": ref}
    for name, (m, kv8) in variants.items():
        r = teacher_forced_stream(m, grid, seed, kv_int8=kv8, **sample_kwargs)
        rows[name] = {
            "ppl_text": round(r.ppl_text, 4),
            "ppl_audio": round(r.ppl_audio, 4),
            "d_ce_text": round(r.ce_text - ref.ce_text, 6),
            "d_ce_audio": round(r.ce_audio - ref.ce_audio, 6),
            "agree_sampled": round(agreement(r.sampled, ref.sampled), 4),
            "agree_greedy": round(agreement(r.greedy, ref.greedy), 4),
        }
        results[name] = r
    return {"rows": rows, "results": results}
