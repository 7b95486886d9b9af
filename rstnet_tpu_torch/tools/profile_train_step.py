"""Where the time of one training step goes, on one GPU.

    python -m rstnet_tpu_torch.tools.profile_train_step [--out FILE.json] [trainer flags ...]

Builds the model as ``rstnet_tpu_torch.training.trainer`` does, from the
trainer's own flags (``--model_config``, by default
``configs/llama_1b_speech.yaml``; ``--dtype``, ``--seed``, ``--device``,
``--remat``, ...): weights from ``1337 + seed`` drawn on the CPU and moved
to the device, flash attention and remat as the trainer's defaults. Then one
seeded synthetic batch of the shape the profile is defined on, B=4 x T=1024
(the 2.01 B config's steps under ``--max_length 1023 --batch_scale 2500``,
K6 on every layer), ``[B, 9, T]`` (text tokens, audio codes, unit loss
masks), and the trainer's AdamW. It warms up one step, and measures:

1. step time, median over 5 steps (host clock, a synchronize per step), and
   padded frames per second;
2. stage times, medians over 5 more steps, each stage bracketed by a
   synchronize: forward (model and loss), backward, optimizer update;
3. ``torch.profiler`` over 2 steps with no stage syncs: device time, the
   device's busy share of the wall time, device events per step, device
   time by kernel name;

and K6's launches per step. Prints a summary; ``--out`` also writes every
number as JSON. ``--device cpu`` runs 1 and 2 on the CPU and skips the
profiler (no device numbers).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import numpy as np
import torch

from rstnet_tpu_torch.ops import cuda_flash
from rstnet_tpu_torch.tools.profile_frame import device_profile
from rstnet_tpu_torch.training.schedulers import warmup_lr
from rstnet_tpu_torch.training.train_step import (
    init_train_state,
    make_loss_fn,
    make_optimizer,
    trainable_params,
)
from rstnet_tpu_torch.training.trainer import build_model, synchronize
from rstnet_tpu_torch.utils.arguments import get_args

BATCH, SEQ = 4, 1024  # the shape the profile is defined on
STEPS, PROFILE_STEPS = 5, 2
K6 = (cuda_flash.flash_attention_fwd, cuda_flash.flash_attention_bwd)


def synthetic_batch(model, B: int, T: int, seed: int, device) -> dict:
    cfg = model.config
    rng = np.random.default_rng(seed)
    text = rng.integers(0, cfg.vocab_size, (B, 1, T))
    audio = rng.integers(0, cfg.audio_card - 2, (B, cfg.n_q, T))
    tokens = torch.from_numpy(np.concatenate([text, audio], axis=1)).to(device)
    return {"tokens": tokens, "masks": torch.ones(tokens.shape, device=device)}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default="", help="also write the numbers here, as JSON")
    args, trainer_flags = parser.parse_known_args(argv)
    targs = get_args(["--model_config", "configs/llama_1b_speech.yaml", *trainer_flags])
    device = torch.device(targs.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run on the CPU")
    card = "cpu"
    if device.type == "cuda":
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"],
                              capture_output=True, text=True, check=True).stdout.strip()
    dtype = torch.bfloat16 if targs.dtype == "bfloat16" else torch.float32
    model = build_model(targs, device, dtype)
    loss_fn = make_loss_fn(model, audio_ignore_id=targs.acoustic_pad_token,
                           text_ignore_id=targs.text_pad_token)
    tx = make_optimizer(warmup_lr(targs.global_learning_rate, targs.warmup_steps),
                        weight_decay=targs.weight_decay)
    state = init_train_state(model, tx)
    params = trainable_params(model)
    batch = synthetic_batch(model, BATCH, SEQ, targs.seed, device)

    def step(stages=None):
        t0 = time.perf_counter()
        loss, _ = loss_fn(batch)
        if stages is not None:
            synchronize(device)
            t1 = time.perf_counter()
        loss.backward()
        if stages is not None:
            synchronize(device)
            t2 = time.perf_counter()
        tx.update({n: p.grad for n, p in params.items()}, state["opt_state"], params)
        for p in params.values():
            p.grad = None
        synchronize(device)
        if stages is not None:
            t3 = time.perf_counter()
            for name, (a, b) in (("forward", (t0, t1)), ("backward", (t1, t2)),
                                 ("optimizer", (t2, t3)), ("step", (t0, t3))):
                stages.setdefault(name, []).append((b - a) * 1000)

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    step()  # warm-up
    for fn in K6:
        for attr in cuda_flash.COUNTERS.values():
            setattr(fn, attr, 0)
    times = []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        step()
        times.append((time.perf_counter() - t0) * 1000)
    k6 = [sum(getattr(fn, a) for a in cuda_flash.COUNTERS.values()) / STEPS for fn in K6]
    stages: dict = {}
    for _ in range(STEPS):
        step(stages)
    stage_ms = {k: statistics.median(v) for k, v in stages.items()}
    prof = ({"frames": PROFILE_STEPS} if device.type != "cuda"
            else device_profile(lambda _: step(), range(PROFILE_STEPS)))
    peak_gib = torch.cuda.max_memory_allocated() / 2**30 if device.type == "cuda" else None
    frames = BATCH * SEQ
    n_params = sum(p.numel() for p in model.parameters())
    result = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
              "model": model.config.name, "params": n_params, "dtype": targs.dtype,
              "batch": BATCH, "seq": SEQ, "remat": targs.remat, "peak_memory_gib": peak_gib,
              "step_ms": {"p50": statistics.median(times), "max": max(times), "n": STEPS},
              "frames_per_s": frames / statistics.median(times) * 1000,
              "stage_ms": stage_ms, "k6_launches_per_step": dict(zip(
                  ("flash_attention_fwd", "flash_attention_bwd"), k6)), "profile": prof}
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
          f"{model.config.name} ({n_params / 1e9:.3f} B params, {targs.dtype}, remat "
          f"{targs.remat}), B={BATCH} T={SEQ}; peak memory "
          + (f"{peak_gib:.1f} GiB" if peak_gib is not None else "not measured"))
    print(f"step ms over {STEPS} steps: p50 {statistics.median(times):.3f}, max "
          f"{max(times):.3f}; {result['frames_per_s']:.0f} padded frames/s (host clock)")
    print("stage ms (medians, synchronized per stage): " + ", ".join(
        f"{k} {v:.3f}" for k, v in stage_ms.items()))
    print(f"K6 launches per step: {result['k6_launches_per_step']}")
    if "device_ms" in prof:
        print(f"profiler over {prof['frames']} steps: wall {prof['wall_ms']:.3f} ms, device busy "
              f"{prof['device_ms']:.3f} ms ({100 * prof['busy_share']:.1f} %), "
              f"{prof['launches_per_frame']:.0f} device events per step")
        for name, ms in prof["by_kernel_ms"]:
            print(f"  {ms:10.3f} ms  {name[:110]}")
    else:
        print("profiler: no device events recorded; device time not measured")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
