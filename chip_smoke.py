#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--frames N] [--sessions N]

Phases (each prints its findings; any failure exits non-zero):

1. environment: torch, CUDA, nvcc, and the card's name and power limit;
2. build: the hand-written kernels from ``rstnet_tpu_torch/csrc``;
3. kernels: K1 (depformer micro-step), its int8 variant K1-int8, K2
   (per-step gated FFN) and K3 (RVQ encode, both of its paths) against their
   plain PyTorch versions on the card, at the full-width shapes of the
   serving paths (Moshi 7B's depformer, Mimi's quantizer), with device times
   and bounds;
4. small slices: a small Mimi + Moshi serving frame (solo, K1), the same
   under ``--int8 --kv-int8`` (K1-int8) and a small batched tick
   (``SessionBatcher`` at B=4, K2) on the card against the same weights on
   the CPU (plain versions), teacher-forced;
5. full slices, on one build of Mimi 24 kHz (f32) + Moshi 7B (bf16) with
   seeded random weights: the solo frame through
   ``ServerState.handle_frame_array``, then ``SessionBatcher.step_once``
   with ``--sessions`` sessions; then the same model quantized in place as
   the server's ``--int8`` does, with an int8 ring (``--kv-int8``), through
   both again. Each path's kernel launches are counted from zero just
   before it runs and read just after;
6. training: K6 (flash attention forward, dQ and dK/dV) against its plain
   versions at the training shapes (H=32 over 8 KV heads, T=1024, D=64;
   causal and a 256 window; bf16 at B=2 and at the main path's B=4, float32
   at B=2), with device, plain, bound and SDPA times; a small
   ``SpeechTextLM`` trained through
   ``rstnet_tpu_torch.training.trainer.main`` (float32, bucket 512) on the
   card and on the CPU from the same weights and data, one epoch and then a
   resumed second, per-step losses compared; then the full Llama-3.2-1B
   speech config (2.01 B parameters, bf16) for ``TRAIN_STEPS`` steps on
   synthetic data, K6 on every step whose bucket is 1024 and on no other.

Every phase prints its wall time.

Kernel times are device times: a device sleep holds the stream while the
host enqueues the timed calls, so the host's launch cost is not in them.
The line before the last is the card's ``nvidia-smi`` name and power limit
again, before it a ``{"kernels": [...]}`` JSON line, and the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device it exits non-zero
and prints no result. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import gc
import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

# K1 is compared like the Pallas kernel's interpret-mode test: bf16 rounding of
# the normalized activations, the attention output and the gated hidden can
# differ by one bf16 ulp between two summation orders.
K1_ATOL = K1_RTOL = 2e-2
# K2: float32 outputs are the same float32 sums in another order (1e-4
# relative, 1e-5 absolute); bf16 outputs may round those sums to neighbouring
# bf16 values, one step of 2**-7 relative.
K2_TOL = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (2.0**-7, 1e-5)}  # (rtol, atol)
# K3: a differing code is allowed only at a near-tie (the two candidates'
# squared distances, in float64, within this fraction of each other); rows
# whose codes agree add the same codewords in the same order, so their
# quantized sums agree to float32 rounding.
K3_TIE_RTOL = 1e-5
K3_QUANT_ATOL = 1e-5
# small slice, card vs CPU: float32 codec, bf16 LM weights with other kernels'
# summation orders on each side
SLICE_LOGIT_TOL = 5e-2
SLICE_AUDIO_TOL = 1e-3
# K6 against its plain versions (ops/cuda_flash.py), each output held to its
# own scale: ||kernel - plain|| / ||plain|| over the tensor and over every
# 64-row tile of every head (cuda_flash.relative_error_by_tile). bf16: 1e-2,
# a few times what rounding gives (the bf16 operands of the P V and dS
# products and the bf16 outputs, one rounding of ~2**-9 each on either
# side); float32 inputs go through split-bf16 products (hi.hi + hi.lo +
# lo.hi, a dropped term of ~2**-16): 1e-4, where a bf16-only product would
# read ~2e-3. The float32 log-sum-exp: within 1e-3 (bf16 inputs) or 1e-4.
K6_REL_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}
K6_LSE_TOL = {torch.bfloat16: 1e-3, torch.float32: 1e-4}
# small training slice, card (K6 on float32 inputs, split-bf16 products)
# against the CPU (masked path), float32, same weights and data: per-step
# losses within 1e-5 relative (PR 4's runs read 1.7e-7; float32 sums in two
# orders over a few steps), accuracies within 1e-2 (a near-tie argmax may
# flip a token)
TRAIN_LOSS_RTOL = 1e-5
TRAIN_ACC_ATOL = 1e-2
# steps of the full training slice: five land on the 1024 bucket, one on a
# shorter one
TRAIN_STEPS = 6
# NVIDIA H100 SXM data sheet: HBM bandwidth and dense peak rates (at 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "f32": 67e12}


def log(*args) -> None:
    print(*args, flush=True)


@contextlib.contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    yield
    log(f"phase {name}: {time.perf_counter() - t0:.1f} s wall")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def time_ms(fn, reps: int) -> float:
    """Device time of one ``fn()``: CUDA events around ``reps`` calls, after
    a warm-up. A device sleep first holds the stream until the host has
    enqueued every call, so host launch cost does not enter the time; keep
    ``reps`` times the launches per call to a few hundred, or the launch
    queue fills and the host's pace returns."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1000
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e6 * (2 * reps * host_ms + 20)))  # >= 1 ms per 2e6 cycles
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(n_bytes: float, n_ops: float, kind: str) -> tuple[float, str]:
    """(least time in ms, what bounds it): each input read once and each
    output written once at the HBM rate, against the operations at the peak
    rate of their type."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS_PER_S[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_environment() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this smoke run needs one GPU")
    from rstnet_tpu_torch.ops import cuda_lib

    nvcc = subprocess.run([cuda_lib._nvcc(), "--version"], capture_output=True, text=True)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, nvcc: {nvcc.stdout.strip().splitlines()[-1]}")
    log(f"devices: {torch.cuda.device_count()} x {torch.cuda.get_device_name(0)}")
    card = card_line()
    log(f"card (nvidia-smi name, power.limit): {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


def phase_build() -> None:
    from rstnet_tpu_torch.ops import cuda_lib

    t0 = time.perf_counter()
    path, out = cuda_lib.build()
    log(f"built {path.name} in {time.perf_counter() - t0:.1f} s")
    for line in out.splitlines():
        if "Used" in line or "Compiling entry" in line:
            log("  ptxas:", line.split("ptxas info    :")[-1].strip())
    cuda_lib.kernel_library()


def _k1_operands(g, L=6, S=8, C=1024, heads=16, H=2816, card=2048):
    """Moshi 7B's depformer at full width, with the model's init scales."""
    dev = "cuda"

    def uni(shape, fan_in):
        return torch.empty(shape, device=dev).uniform_(
            -fan_in**-0.5, fan_in**-0.5, generator=g).to(torch.bfloat16)

    ops = {
        "norm1": 1 + 0.1 * torch.randn((L, C), device=dev, generator=g),
        "in_proj": uni((L, S * 3 * C, C), C),
        "out_proj": uni((L, S * C, C), C),
        "norm2": 1 + 0.1 * torch.randn((L, C), device=dev, generator=g),
        "gin": uni((L, S, 2 * H, C), C),
        "gout": uni((L, S, C, H), H),
        "head_w": uni((S, card, C), C),
        "head_b": 0.1 * torch.randn((S, card), device=dev, generator=g),
    }
    xs = torch.randn((S, 1, C), device=dev, generator=g).to(torch.bfloat16)
    return ops, xs, dict(L=L, S=S, C=C, heads=heads)


def _k1_frame(step, ops, xs, kc, vc, heads):
    logits = []
    for cb in range(xs.shape[0]):
        lg, kc, vc = step(xs[cb], cb, ops["norm1"], ops["in_proj"], ops["out_proj"],
                          ops["norm2"], ops["gin"], ops["gout"], ops["head_w"],
                          ops["head_b"], kc, vc, heads=heads, eps=1e-8)
        logits.append(lg)
    return torch.stack(logits), kc, vc


def _quantized(ops: dict) -> tuple[dict, dict]:
    """K1's weight stacks as int8 codes and their float32 row scales
    [..., rows, 1], from the port's ``quantize_weight_int8``."""
    from rstnet_tpu_torch.modules.transformer import quantize_weight_int8
    from rstnet_tpu_torch.ops.cuda_depformer import WEIGHTS

    q = {k: quantize_weight_int8(ops[k]) for k in WEIGHTS}
    return ({**ops, **{k: w.w_int8 for k, w in q.items()}},
            {k: w.scale[..., None] for k, w in q.items()})


def check_k1(g, card: str, int8: bool = False) -> dict:
    """K1 (bf16 weights) or K1-int8 at Moshi 7B's depformer width, a frame
    of all 8 micro-steps, float32 caches (the solo path's) and bf16 caches."""
    from rstnet_tpu_torch.ops.cuda_depformer import depformer_step, depformer_step_reference

    ops, xs, dims = _k1_operands(g)
    scales = None
    if int8:
        ops, scales = _quantized(ops)
    L, S, C, heads = dims["L"], dims["S"], dims["C"], dims["heads"]
    name = "K1-int8" if int8 else "K1"
    kernel = functools.partial(depformer_step, scales=scales)
    plain = functools.partial(depformer_step_reference, scales=scales)
    err = 0.0
    for cache in (torch.float32, torch.bfloat16):
        zeros = lambda: torch.zeros((L, S, C), device="cuda", dtype=cache)  # noqa: E731
        got, kck, vck = _k1_frame(kernel, ops, xs, zeros(), zeros(), heads)
        want, kcr, vcr = _k1_frame(plain, ops, xs, zeros(), zeros(), heads)
        torch.cuda.synchronize()
        err = max(err, (got - want).abs().max().item())
        for what, a, b in (("logits", got, want), ("kc", kck, kcr), ("vc", vck, vcr)):
            a, b = a.float(), b.float()
            diff = (a - b).abs()
            bad = diff > K1_ATOL + K1_RTOL * b.abs()
            log(f"{name} {what}, {str(cache)[6:]} cache: max |kernel - plain| = "
                f"{diff.max().item():.3e} (max |plain| {b.abs().max().item():.3e}), "
                f"{int(bad.sum())} outside atol={K1_ATOL} rtol={K1_RTOL}")
            if bad.any() or not torch.isfinite(a).all():
                raise AssertionError(f"{name} {what} disagrees with depformer_step_reference")
    zeros = lambda: torch.zeros((L, S, C), device="cuda")  # noqa: E731 - the path's f32 cache
    ms = time_ms(lambda: _k1_frame(kernel, ops, xs, zeros(), zeros(), heads), 4) / S
    plain_ms = time_ms(lambda: _k1_frame(plain, ops, xs, zeros(), zeros(), heads), 2) / S
    # one micro-step, averaged over the frame's S: the step's weight slices
    # and head (and their row scales), the norms, x, the cache rows read (cb
    # of them, f32 K and V) and written (one), the logits
    H, card_n = ops["gout"].shape[-1], ops["head_w"].shape[1]
    weights = L * (3 * C * C + C * C + 2 * H * C + C * H) + card_n * C
    rows = L * (3 * C + C + 2 * H + C) + card_n
    n_bytes = (ops["in_proj"].element_size() * weights + (4 * rows if int8 else 0)
               + 4 * (2 * L * C + card_n) + 2 * C + 8 * L * C * (sum(range(S)) / S + 1)
               + 4 * card_n)
    # bf16: a multiply and an add per weight at the bf16 rate; int8: the
    # dequantizing multiply as well, all on the CUDA cores in float32
    bound_ms, bound_by = (bound(n_bytes, 3 * weights, "f32") if int8
                          else bound(n_bytes, 2 * weights, "bf16"))
    log(f"{name} one micro-step (L=6, C=1024, H=2816, card=2048): kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}, {n_bytes / 1e6:.1f} MB) "
        f"[{card}]")
    return {"name": "depformer_step_int8" if int8 else "depformer_step", "route": "cuda",
            "source": "rstnet_tpu_torch/csrc/depformer_step.cu",
            "replaces": "rstnet_tpu/ops/pallas_depformer.py:167"
                        + (" (int8 variant, scales set)" if int8 else ""),
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


def check_k2(g, card: str, sessions: int) -> dict:
    """K2 at Moshi 7B's depformer shapes (S=8, C=1024, H=2816, bf16
    weights), B in {2, 16, 64} and the sessions' B, x in bf16 and f32,
    steps 0 and 7."""
    from rstnet_tpu_torch.ops.cuda_ffn import gating_ffn_step, gating_ffn_step_reference

    S, C, H = 8, 1024, 2816
    lin_in = ((torch.rand((S, 2 * H, C), device="cuda", generator=g) * 2 - 1) * C**-0.5
              ).to(torch.bfloat16)
    lin_out = ((torch.rand((S, C, H), device="cuda", generator=g) * 2 - 1) * H**-0.5
               ).to(torch.bfloat16)
    err, result = 0.0, None
    for B in sorted({2, 16, 64, sessions}):
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn((B, C), device="cuda", generator=g).to(dtype)
            rtol, atol = K2_TOL[dtype]
            for step in (0, 7):
                got = gating_ffn_step(x, lin_in, lin_out, step)
                want = gating_ffn_step_reference(x, lin_in, lin_out, step)
                torch.cuda.synchronize()
                diff = (got.float() - want.float()).abs()
                bad = int((diff > atol + rtol * want.float().abs()).sum())
                err = max(err, diff.max().item())
                if bad or not torch.isfinite(got).all():
                    raise AssertionError(f"K2 B={B} {dtype} step={step}: {bad} elements outside "
                                         f"rtol={rtol} atol={atol} (max err {diff.max().item():.3e})")
            ms = time_ms(lambda: gating_ffn_step(x, lin_in, lin_out, 7), 100)
            plain = time_ms(lambda: gating_ffn_step_reference(x, lin_in, lin_out, 7), 50)
            xb = x.element_size()
            bound_ms, bound_by = bound(2 * 3 * H * C + 2 * B * C * xb, 2 * B * 3 * H * C, "bf16")
            log(f"K2 B={B} x {str(dtype)[6:]}: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
                f"bound {bound_ms:.4f} ms ({bound_by}) [{card}]")
            if B == sessions and dtype == torch.bfloat16:  # the batched tick's shape
                result = {"ms": ms, "plain_ms": plain, "bound_ms": bound_ms,
                          "bound_by": bound_by}
    log(f"K2 max |kernel - plain| {err:.3e} over B, dtypes and steps")
    return {"name": "gating_ffn_step", "route": "cuda",
            "source": "rstnet_tpu_torch/csrc/gating_ffn_step.cu",
            "replaces": "rstnet_tpu/ops/pallas_ffn.py:230", "max_abs_err": err, **result,
            "library_ms": None}


def _k3_mismatches(x, cbs, codes_k, codes_r):
    """(near-tie rows, other mismatching rows, mask of agreeing rows)."""
    agree = (codes_k == codes_r).all(1)
    ties = other = 0
    xd, cd = x.double().cpu(), cbs.double().cpu()
    for row in torch.nonzero(~agree).flatten().tolist():
        ck, cr = codes_k[row].cpu(), codes_r[row].cpu()
        q = int(torch.nonzero(ck != cr)[0])
        residual = xd[row] - sum(cd[j, int(ck[j])] for j in range(q))
        da = (residual - cd[q, int(ck[q])]).square().sum().item()
        db = (residual - cd[q, int(cr[q])]).square().sum().item()
        if abs(da - db) <= K3_TIE_RTOL * max(da, db):
            ties += 1
        else:
            other += 1
    return ties, other, agree


@contextlib.contextmanager
def rvq_split_rows(n: int):
    """Let K3's wrapper take the split-over-K path up to ``n`` rows."""
    from rstnet_tpu_torch.ops import cuda_rvq

    saved, cuda_rvq.SPLIT_MAX_ROWS = cuda_rvq.SPLIT_MAX_ROWS, n
    try:
        yield
    finally:
        cuda_rvq.SPLIT_MAX_ROWS = saved


def check_k3(g, card: str, sessions: int) -> dict:
    """K3 at Mimi's quantizer shapes, both paths where both apply; the
    entry for the kernels line is the wrapper's own choice at Q=7 and the
    batched tick's N (one row per session)."""
    from rstnet_tpu_torch.ops import cuda_rvq
    from rstnet_tpu_torch.ops.cuda_rvq import rvq_encode, rvq_encode_reference

    D, K = 256, 2048
    books = torch.randn((7, K, D), device="cuda", generator=g)
    err, result = 0.0, None
    for Q in (1, 7):
        cbs = books[:Q].contiguous()
        for N in sorted({1, 8, 16, 32, 64, 4096, sessions}):
            x = torch.randn((N, D), device="cuda", generator=g)
            codes_r, quant_r = rvq_encode_reference(x, cbs)
            plain = time_ms(lambda: rvq_encode_reference(x, cbs), 20)
            paths = {"tiled": 0, "split": 64} if N <= 64 else {"tiled": 0}
            times = {}
            for path, rows in paths.items():
                with rvq_split_rows(rows):
                    codes_k, quant_k = rvq_encode(x, cbs)
                    torch.cuda.synchronize()
                    ties, other, agree = _k3_mismatches(x, cbs, codes_k, codes_r)
                    qerr = ((quant_k[agree] - quant_r[agree]).abs().max().item()
                            if agree.any() else 0.0)
                    err = max(err, qerr)
                    if other or qerr > K3_QUANT_ATOL:
                        raise AssertionError(f"K3 {path} disagrees with rvq_encode_reference at "
                                             f"Q={Q} N={N}: {other} rows, quant err {qerr:.3e}")
                    times[path] = time_ms(lambda: rvq_encode(x, cbs), 30)
            n_bytes = 4 * (N * D + Q * K * D + N * Q + N * D)
            bound_ms, bound_by = bound(n_bytes, 2 * N * Q * K * D, "f32")
            chosen = "split" if N <= cuda_rvq.SPLIT_MAX_ROWS else "tiled"
            log(f"K3 Q={Q} N={N}: " + ", ".join(f"{p} {t:.4f} ms" for p, t in times.items())
                + f" (wrapper takes {chosen}), plain {plain:.4f} ms, bound {bound_ms:.4f} ms "
                f"({bound_by}); {int(agree.sum())}/{N} rows with equal codes, {ties} near-tie "
                f"[{card}]")
            if Q == 7 and N == sessions:
                result = {"ms": times[chosen], "plain_ms": plain, "bound_ms": bound_ms,
                          "bound_by": bound_by}
    return {"name": "rvq_encode", "route": "cuda", "source": "rstnet_tpu_torch/csrc/rvq_encode.cu",
            "replaces": "rstnet_tpu/ops/pallas_rvq.py:67", "max_abs_err": err, **result,
            "library_ms": None}


@contextlib.contextmanager
def recorded_sampling(forced=None):
    """Record the logits ``LMGen`` samples from; with ``forced`` (a list of
    token tensors), return those tokens in order instead."""
    from rstnet_tpu_torch.inference import generate

    orig, record = generate.sample_token, []
    pending = iter(forced) if forced is not None else None

    def sample(logits, generator, *args, **kwargs):
        tok = orig(logits, generator, *args, **kwargs)
        record.append((logits.float().cpu(), tok.cpu()))
        return tok if pending is None else next(pending).to(tok.device)

    generate.sample_token = sample
    try:
        yield record
    finally:
        generate.sample_token = orig


def _small_models(device, seed, int8: bool = False):
    """Small Mimi + Moshi (depformer 128 wide: inside K1's envelope), built
    on the CPU from ``seed`` and moved to ``device``; ``int8`` quantizes as
    the server's ``--int8`` and gives LMGen an int8 ring (``--kv-int8``)."""
    from rstnet_tpu_torch.inference.generate import LMGen
    from rstnet_tpu_torch.models.mimi import mimi_24k
    from rstnet_tpu_torch.models.moshi_lm import MoshiLMModel
    from rstnet_tpu_torch.serving.server import quantize_for_serving

    g = torch.Generator(device="cpu").manual_seed(seed)
    mimi = mimi_24k(n_q_total=8, dimension=64, n_filters=8, num_layers=2, quantizer_dim=32,
                    bins=64, generator=g)
    for rvq in (mimi.quantizer.rvq_first, mimi.quantizer.rvq_rest):
        rvq.layers.embedding_sum.normal_(generator=g)
    lm = MoshiLMModel(
        delays=(0, 0) + (1,) * 7 + (0,) + (1,) * 7, n_q=16, dep_q=8, card=128, text_card=256,
        dim=64, num_heads=4, num_layers=2, hidden_scale=4.0, context=64, depformer_dim=128,
        depformer_dim_feedforward=192, depformer_num_heads=2, depformer_num_layers=2,
        dtype=torch.bfloat16, generator=g)
    quantize_for_serving(lm, int8=int8)
    return mimi.to(device), LMGen(lm.to(device), delays=lm.delays, use_sampling=False,
                                  kv_int8=int8)


def check_small_slice(seed: int, n_frames: int = 6, int8: bool = False) -> None:
    """The small solo frame on the card against the CPU, teacher-forced on
    the CPU's tokens; ``int8``: under ``--int8 --kv-int8``, through K1-int8."""
    from rstnet_tpu_torch.serving.server import ServerState

    frames = np.random.default_rng(seed).normal(0, 0.1, (n_frames, 1920)).astype(np.float32)
    runs = {}
    for device in ("cpu", "cuda"):
        state = ServerState(*_small_models(device, seed, int8), seed=seed)
        forced = None if device == "cpu" else [tok for _, tok in runs["cpu"][0]]
        reset_counts()
        with recorded_sampling(forced) as record:
            audio = [state.handle_frame_array(f)[0] for f in frames]
        runs[device] = (record, audio, read_counts())
    (rec_c, audio_c, _), (rec_g, audio_g, counts) = runs["cpu"], runs["cuda"]
    k1, other = ("depformer_step_int8", "depformer_step")[:: 1 if int8 else -1]
    if counts[k1] != 8 * n_frames or counts[other]:
        raise AssertionError(f"small slice launched {counts}, expected {k1} {8 * n_frames} "
                             f"times and {other} none")
    logit_err = max((a - b).abs().max().item() for (a, _), (b, _) in zip(rec_c, rec_g))
    scale = max(a.abs().max().item() for a, _ in rec_c)
    flips = 0
    for (a, tok), (b, _) in zip(rec_c, rec_g):
        top2 = a.topk(2, dim=-1).values
        clear = (top2[..., 0] - top2[..., 1]) > 2 * SLICE_LOGIT_TOL * max(1.0, scale)
        flips += int(((b.argmax(-1) != tok) & clear).sum())
    audio_err = max(float(np.abs(a - b).max()) for a, b in zip(audio_c, audio_g)
                    if a is not None)
    log(f"small slice{' --int8 --kv-int8' if int8 else ''}, card vs CPU over {n_frames} frames: "
        f"logits max abs err {logit_err:.3e} "
        f"(max |logit| {scale:.3e}), {flips} greedy flips past the margin, "
        f"audio max abs err {audio_err:.3e}")
    if logit_err > SLICE_LOGIT_TOL * max(1.0, scale) or flips or audio_err > SLICE_AUDIO_TOL:
        raise AssertionError("the small slice on the card disagrees with the CPU")


def check_small_batched_slice(seed: int, sessions: int = 4, n_ticks: int = 6) -> None:
    """``SessionBatcher`` at B=4 on the small models (depformer 128 wide,
    gating hidden dim 128: inside K2's envelope), float32 state, greedy; the
    card is teacher-forced on the CPU's tokens."""
    from rstnet_tpu_torch.serving.batcher import SessionBatcher

    pcm = np.random.default_rng(seed + 1).normal(0, 0.1, (n_ticks, sessions, 1920))
    runs = {}
    for device in ("cpu", "cuda"):
        mimi, gen = _small_models(device, seed)
        batcher = SessionBatcher(mimi, gen, max_sessions=sessions, dtype=torch.float32, seed=seed)
        active = [batcher.acquire() for _ in range(sessions)]
        forced = None if device == "cpu" else [tok for _, tok in runs["cpu"][0]]
        reset_counts()
        with recorded_sampling(forced) as record:
            for t in range(n_ticks):
                for i, sess in enumerate(active):
                    sess.inputs.put_nowait(pcm[t, i].astype(np.float32))
                batcher.step_once()
        audio = [[sess.outputs.get_nowait()[0] for _ in range(sess.outputs.qsize())]
                 for sess in active]
        counts = read_counts()
        runs[device] = (record, audio, counts["gating_ffn_step"], counts["rvq_encode"])
    (rec_c, audio_c, _, _), (rec_g, audio_g, k2, k3) = runs["cpu"], runs["cuda"]
    layers = gen.model.depformer.num_layers
    if k2 != 8 * layers * n_ticks or k3 != 2 * n_ticks:
        raise AssertionError(f"small batched slice launched K2 {k2} and K3 {k3} times, expected "
                             f"{8 * layers * n_ticks} and {2 * n_ticks}")
    logit_err = max((a - b).abs().max().item() for (a, _), (b, _) in zip(rec_c, rec_g))
    scale = max(a.abs().max().item() for a, _ in rec_c)
    flips = 0
    for (a, tok), (b, _) in zip(rec_c, rec_g):
        top2 = a.topk(2, dim=-1).values
        clear = (top2[..., 0] - top2[..., 1]) > 2 * SLICE_LOGIT_TOL * max(1.0, scale)
        flips += int(((b.argmax(-1) != tok) & clear).sum())
    if [len(a) for a in audio_c] != [len(a) for a in audio_g] or not audio_c[0]:
        raise AssertionError("the card and the CPU delivered different frame counts")
    audio_err = max(float(np.abs(a - b).max()) for sa, sb in zip(audio_c, audio_g)
                    for a, b in zip(sa, sb))
    log(f"small batched slice (B={sessions}), card vs CPU over {n_ticks} ticks: logits max abs "
        f"err {logit_err:.3e} (max |logit| {scale:.3e}), {flips} greedy flips past the margin, "
        f"audio max abs err {audio_err:.3e}; K2 launches {k2}, K3 {k3}")
    if logit_err > SLICE_LOGIT_TOL * max(1.0, scale) or flips or audio_err > SLICE_AUDIO_TOL:
        raise AssertionError("the small batched slice on the card disagrees with the CPU")


def build_full_models(seed: int):
    """Mimi 24 kHz + Moshi 7B as the server builds them, with seeded normal
    codebooks: the default init leaves every codebook at zero, where every
    code is a tie won by 0."""
    from rstnet_tpu_torch.ops.cuda_depformer import depformer_kernel_operands
    from rstnet_tpu_torch.serving.server import build_models

    t0 = time.perf_counter()
    mimi, lm_gen = build_models(False, torch.device("cuda"), seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    for rvq in (mimi.quantizer.rvq_first, mimi.quantizer.rvq_rest):
        rvq.layers.embedding_sum.normal_(generator=g)
    if depformer_kernel_operands(lm_gen.model) is None:
        raise AssertionError("Moshi 7B's depformer is outside K1's envelope")
    n_params = sum(p.numel() for m in (mimi, lm_gen.model) for p in m.parameters())
    log(f"full models: Mimi 24 kHz + Moshi 7B, {n_params / 1e9:.2f} B params, built in "
        f"{time.perf_counter() - t0:.1f} s")
    return mimi, lm_gen


def _signal(seed: int, n_samples: int, freq: float = 220.0) -> np.ndarray:
    t = np.arange(n_samples) / 24000.0
    rng = np.random.default_rng(seed)
    return (0.3 * np.sin(2 * np.pi * freq * t) * np.sin(2 * np.pi * 1.5 * t)
            + 0.05 * rng.standard_normal(t.shape)).astype(np.float32)


def _percentiles(times: list) -> str:
    ts = sorted(times)
    return (f"p50 {ts[len(ts) // 2]:.2f} ms, p99 {ts[min(len(ts) - 1, int(0.99 * len(ts)))]:.2f} "
            f"ms")


def _counters() -> dict:
    """Each kernel's launch counter, by the kernel line's name: (the
    wrapper, the attribute it counts in)."""
    from rstnet_tpu_torch.ops import cuda_flash
    from rstnet_tpu_torch.ops.cuda_depformer import depformer_step
    from rstnet_tpu_torch.ops.cuda_ffn import gating_ffn_step
    from rstnet_tpu_torch.ops.cuda_rvq import rvq_encode

    return {"depformer_step": (depformer_step, "launches"),
            "depformer_step_int8": (depformer_step, "launches_int8"),
            "gating_ffn_step": (gating_ffn_step, "launches"),
            "rvq_encode": (rvq_encode, "launches"),
            "flash_attention_fwd": (cuda_flash.flash_attention_fwd, "launches"),
            "flash_attention_bwd_dq": (cuda_flash.flash_attention_bwd_dq, "launches"),
            "flash_attention_bwd_dkv": (cuda_flash.flash_attention_bwd_dkv, "launches")}


def reset_counts() -> None:
    for fn, attr in _counters().values():
        setattr(fn, attr, 0)


def read_counts() -> dict:
    return {name: getattr(fn, attr) for name, (fn, attr) in _counters().items()}


def run_full_slice(mimi, lm_gen, seed: int, n_frames: int, card: str, path: str,
                   expected: dict) -> dict:
    """The solo frame through ``ServerState.handle_frame_array`` for
    ``n_frames`` frames; ``expected``: the launches of each kernel."""
    from rstnet_tpu_torch.serving.server import ServerState

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    state = ServerState(mimi, lm_gen, seed=seed)
    state.warmup()
    torch.cuda.synchronize()
    log(f"{path}: warmed up in {time.perf_counter() - t0:.1f} s")
    frames = _signal(seed, n_frames * state.frame_size).reshape(n_frames, state.frame_size)
    n_text = lm_gen.model.text_card + lm_gen.model._extra_text

    reset_counts()
    times, valid = [], 0
    for pcm in frames:
        t0 = time.perf_counter()
        audio, tok = state.handle_frame_array(pcm)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1000)
        if audio is None:
            continue
        valid += 1
        if audio.shape != (state.frame_size,) or not np.isfinite(audio).all():
            raise AssertionError(f"frame {len(times)}: audio {audio.shape}, finite "
                                 f"{np.isfinite(audio).all()}")
        if not 0 <= tok < n_text:
            raise AssertionError(f"frame {len(times)}: text token {tok} outside [0, {n_text})")
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"{path}: {n_frames} frames, {valid} valid; launches {counts}")
    if valid != n_frames - lm_gen.max_delay:
        raise AssertionError(f"{valid} valid frames, expected {n_frames - lm_gen.max_delay}")
    if counts != expected:
        raise AssertionError(f"{path}: launches {counts}, expected {expected}")
    log(f"{path} frame time: {_percentiles(times)} over {n_frames} frames (host clock, "
        f"informational); peak memory {peak:.1f} GiB [{card}]")
    return counts


def run_full_batched_slice(mimi, lm_gen, seed: int, sessions: int, n_ticks: int,
                           card: str, path: str, expected: dict) -> dict:
    """``sessions`` sessions through ``SessionBatcher.step_once`` (bf16 LM
    state, pipeline depth 1), each fed its own seeded signal; ``expected``:
    the launches of each kernel."""
    from rstnet_tpu_torch.serving.batcher import SessionBatcher

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    batcher = SessionBatcher(mimi, lm_gen, max_sessions=sessions, seed=seed)
    batcher.warmup()
    active = [batcher.acquire() for _ in range(sessions)]
    torch.cuda.synchronize()
    log(f"{path}: {sessions} sessions, warmed up in {time.perf_counter() - t0:.1f} s")
    frame = batcher.frame_size
    signals = np.stack([_signal(seed + i, n_ticks * frame, 110.0 + 20.0 * i)
                        for i in range(sessions)]).reshape(sessions, n_ticks, frame)
    n_text = lm_gen.model.text_card + lm_gen.model._extra_text

    reset_counts()
    times = []
    for t in range(n_ticks):
        for i, sess in enumerate(active):
            sess.inputs.put_nowait(signals[i, t])
        t0 = time.perf_counter()
        batcher.step_once()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1000)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    for i, sess in enumerate(active):
        got = [sess.outputs.get_nowait() for _ in range(sess.outputs.qsize())]
        if len(got) != n_ticks - lm_gen.max_delay:
            raise AssertionError(f"session {i}: {len(got)} frames, expected "
                                 f"{n_ticks - lm_gen.max_delay}")
        for audio, tok in got:
            if audio.shape != (frame,) or not np.isfinite(audio).all():
                raise AssertionError(f"session {i}: audio {audio.shape}, finite "
                                     f"{np.isfinite(audio).all()}")
            if not 0 <= tok < n_text:
                raise AssertionError(f"session {i}: text token {tok} outside [0, {n_text})")
    log(f"{path}: {n_ticks} ticks x {sessions} sessions; launches {counts}")
    if counts != expected:
        raise AssertionError(f"{path}: launches {counts}, expected {expected}")
    log(f"{path} tick time: {_percentiles(times)} over {n_ticks} ticks (host clock, "
        f"informational); peak memory {peak:.1f} GiB [{card}]")
    return counts


def _visible_pairs(T: int, window: int) -> int:
    """(query, key) pairs that a causal mask with this window leaves."""
    return sum(min(i + 1, window) for i in range(T))


def _check_k6_route(q, k, v, do, context: int, scale: float, err: dict) -> None:
    """The differentiable route (GQA repeat, pre-scale, the three kernels)
    against autograd of the plain reference, O and dQ/dK/dV, and the forward
    kernel's log-sum-exp against its plain version; each within the limits
    of q's dtype. Adds each kernel's max |kernel - plain| to ``err``."""
    from rstnet_tpu_torch.ops import cuda_flash as cf
    from rstnet_tpu_torch.ops.flash_attention import (
        attention_window,
        flash_attention,
        flash_attention_reference,
    )

    (B, H, T, D), dtype = q.shape, q.dtype
    window = attention_window(T, context)
    tol = K6_REL_TOL[dtype]
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    got = flash_attention(*leaves, context, scale)
    got_grads = torch.autograd.grad(got, leaves, do)
    want = flash_attention_reference(*leaves, context, scale)
    want_grads = torch.autograd.grad(want, leaves, do)
    torch.cuda.synchronize()
    what = f"K6 B={B} context {context} {str(dtype).split('.')[-1]}"
    for name, a, b, kernel in (("o", got, want, "flash_attention_fwd"),
                               ("dq", got_grads[0], want_grads[0], "flash_attention_bwd_dq"),
                               ("dk", got_grads[1], want_grads[1], "flash_attention_bwd_dkv"),
                               ("dv", got_grads[2], want_grads[2], "flash_attention_bwd_dkv")):
        whole, tile = cf.relative_error_by_tile(a, b)
        if dtype == torch.bfloat16:
            err[kernel] = max(err[kernel], (a.float() - b.float()).abs().max().item())
        log(f"{what} {name}: ||kernel - plain|| / ||plain|| {whole:.3e}, worst 64-row tile "
            f"{tile:.3e} (limit {tol})")
        if not (whole <= tol and tile <= tol and torch.isfinite(a).all()):
            raise AssertionError(f"{what} {name} disagrees with the plain version")
    qs = (q * scale).to(dtype)
    kr, vr = (t.repeat_interleave(H // k.shape[1], dim=1).contiguous() for t in (k, v))
    lse = cf.flash_attention_fwd(qs, kr, vr, window)[1]
    lse_err = (lse - cf.flash_attention_fwd_reference(qs, kr, vr, window)[1]).abs().max().item()
    log(f"{what} lse: max |kernel - plain| = {lse_err:.3e} (limit {K6_LSE_TOL[dtype]})")
    if not lse_err <= K6_LSE_TOL[dtype]:
        raise AssertionError(f"{what} lse disagrees with the plain version")


def _time_k6(q, k, v, do, context: int, scale: float, card: str) -> dict:
    """Device times of the three kernels, their plain versions and, causal
    only, SDPA; bounds of the GQA function (K and V at their own head count,
    as the attention that K6 replaces reads and writes them; the wrapper's
    repeat to H is the kernels' own cost)."""
    import torch.nn.functional as F

    from rstnet_tpu_torch.ops import cuda_flash as cf
    from rstnet_tpu_torch.ops.flash_attention import attention_window

    (B, H, T, D), Hkv = q.shape, k.shape[1]
    window = attention_window(T, context)
    qs = (q * scale).to(q.dtype)
    kr, vr = (t.repeat_interleave(H // Hkv, dim=1).contiguous() for t in (k, v))
    o, lse = cf.flash_attention_fwd(qs, kr, vr, window)
    dq, delta = cf.flash_attention_bwd_dq(qs, kr, vr, o, do, lse, window)
    pairs = B * H * _visible_pairs(T, window)
    # bytes of one [B, H, T, D] / [B, Hkv, T, D] bf16 tensor, of one [B, H, T] f32 row vector
    row, kv, rows = B * H * T * D * 2, B * Hkv * T * D * 2, B * H * T * 4
    runs = {
        "flash_attention_fwd": (  # q, k, v -> o, lse
            lambda: cf.flash_attention_fwd(qs, kr, vr, window),
            lambda: cf.flash_attention_fwd_reference(qs, kr, vr, window),
            2 * row + 2 * kv + rows, 4 * D * pairs),
        "flash_attention_bwd_dq": (  # q, k, v, o, do, lse -> dq, delta
            lambda: cf.flash_attention_bwd_dq(qs, kr, vr, o, do, lse, window),
            lambda: cf.flash_attention_bwd_dq_reference(qs, kr, vr, o, do, lse, window),
            4 * row + 2 * kv + 2 * rows, 6 * D * pairs),
        "flash_attention_bwd_dkv": (  # q, k, v, do, lse, delta -> dk, dv
            lambda: cf.flash_attention_bwd_dkv(qs, kr, vr, do, lse, delta, window),
            lambda: cf.flash_attention_bwd_dkv_reference(qs, kr, vr, do, lse, delta, window),
            2 * row + 4 * kv + 2 * rows, 8 * D * pairs),
    }
    library = {}
    if window >= T:  # SDPA's causal route: the same pre-scaled, repeated inputs
        sdpa = functools.partial(F.scaled_dot_product_attention, qs, kr, vr, is_causal=True,
                                 scale=1.0)
        library["fwd"] = time_ms(sdpa, 20)
        leaves_l = [t.clone().requires_grad_() for t in (qs, kr, vr)]

        def sdpa_fwd_bwd():
            out = F.scaled_dot_product_attention(*leaves_l, is_causal=True, scale=1.0)
            torch.autograd.grad(out, leaves_l, do)

        library["fwd_bwd"] = time_ms(sdpa_fwd_bwd, 10)
    entries = {}
    for name, (kernel, plain, n_bytes, n_ops) in runs.items():
        ms = time_ms(kernel, 20)
        plain_ms = time_ms(plain, 5)
        bound_ms, bound_by = bound(n_bytes, n_ops, "bf16")
        lib = library.get("fwd") if name == "flash_attention_fwd" else None
        log(f"K6 {name} context {context} (B={B}, H={H} over {Hkv}, T={T}, D={D}, bf16): kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
            f"SDPA {'none' if lib is None else f'{lib:.4f} ms'} [{card}]")
        entries[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                         "bound_by": bound_by, "library_ms": lib}
    log(f"K6 B={B} context {context} forward + backward: kernels "
        f"{sum(e['ms'] for e in entries.values()):.4f} ms, SDPA "
        + (f"{library['fwd_bwd']:.4f} ms" if library else "none (no windowed SDPA route)")
        + f" [{card}]")
    return entries


def check_k6(g, card: str) -> list[dict]:
    """K6 at the training shapes (Llama-3.2-1B: 32 heads over 8 KV heads,
    head dim 64, the T=1024 bucket), causal (context 3000 >= T) and local
    (context 256), bf16 at B=2 and at the main path's B=4 (2 audio plus 2
    text utterances a step), then on float32 inputs (the split-bf16 variant
    that float32 training runs): correctness of every kernel, and times.
    The kernels line carries the times of the main path's case, B=4 causal."""
    H, Hkv, T, D = 32, 8, 1024, 64
    scale = D**-0.5
    err = {"flash_attention_fwd": 0.0, "flash_attention_bwd_dq": 0.0,
           "flash_attention_bwd_dkv": 0.0}
    entries = {}
    for B, dtype in ((2, torch.bfloat16), (4, torch.bfloat16), (2, torch.float32)):
        q, do = (torch.randn((B, H, T, D), device="cuda", generator=g).to(dtype)
                 for _ in range(2))
        k, v = (torch.randn((B, Hkv, T, D), device="cuda", generator=g).to(dtype)
                for _ in range(2))
        for context in (3000, 256):
            _check_k6_route(q, k, v, do, context, scale, err)
            if dtype == torch.bfloat16:
                times = _time_k6(q, k, v, do, context, scale, card)
                if B == 4 and context >= T:
                    entries = times
        del q, k, v, do
        torch.cuda.empty_cache()
    return [{"name": name, "route": "cuda", "source": "rstnet_tpu_torch/csrc/flash_attention.cu",
             "replaces": "rstnet_tpu/ops/flash_attention.py:46"
                         + ("" if name == "flash_attention_fwd" else " (the splash VJP)"),
             "max_abs_err": err[name], **entries[name]} for name in err]


def write_training_data(root, seed: int, long_frames: tuple[int, int], n_long: int,
                        short_frames: tuple[int, int], n_short: int,
                        text_frames: tuple[int, int], n_text: int, audio_card: int,
                        vocab: int) -> str:
    """Synthetic offline-tokenized ``audio_only`` and ``text_only`` manifests
    from ``seed`` (numpy .npz shards); returns the manifests' glob."""
    rng = np.random.default_rng(seed)
    lengths = list(rng.integers(*long_frames, n_long, endpoint=True)) + list(
        rng.integers(*short_frames, n_short, endpoint=True))
    audio = {f"a{i}": rng.integers(0, audio_card, (8, n)).astype(np.int16)
             for i, n in enumerate(lengths)}
    text = {f"t{i}": rng.integers(0, vocab, (int(n),)).astype(np.int32)
            for i, n in enumerate(rng.integers(*text_frames, n_text, endpoint=True))}
    np.savez(root / "audio.npz", **audio)
    np.savez(root / "text.npz", **text)
    for name, task, key, shard in (("a.json", "audio_only", "audio_seq", "audio.npz"),
                                   ("t.json", "text_only", "text_seq", "text.npz")):
        (root / name).write_text(json.dumps({"task": task, "keys": {key: str(root / shard)}}))
    return str(root / "*.json")


def expected_k6(steps: list, n_layer: int) -> dict:
    """K6 launches of a training run under the trainer's default remat: on
    each step whose bucket length qualifies, the forward twice per layer
    (the backward recomputes each block) and each backward kernel once."""
    from rstnet_tpu_torch.ops.flash_attention import flash_qualifies

    n = sum(flash_qualifies(s["seq_len"], None, None, True) for s in steps)
    return {"flash_attention_fwd": 2 * n_layer * n,
            "flash_attention_bwd_dq": n_layer * n, "flash_attention_bwd_dkv": n_layer * n}


SMALL_LM = dict(name="smoke-small", block_size=1024, vocab_size=512, padded_vocab_size=512,
                n_layer=2, n_head=2, n_embd=128, n_query_groups=1, rotary_percentage=1.0,
                parallel_residual=False, bias=False, norm_class_name="RMSNorm",
                mlp_class_name="LLaMAMLP", intermediate_size=256, rope_base=500000,
                rope_adjustments=[8.0, 1.0, 4.0, 256], context=256)


def check_small_training_slice(seed: int) -> None:
    """A small SpeechTextLM (2 layers, head dim 64, a 256 window) trained in
    float32 by the trainer on the card and on the CPU: one epoch, then a
    resumed second; bucket 512 (``--max_length 511``) and smaller ones."""
    import tempfile

    from rstnet_tpu_torch.models.config import write_flat_yaml
    from rstnet_tpu_torch.training import trainer

    root = Path(tempfile.mkdtemp(prefix="smoke_small_train_"))
    try:
        write_flat_yaml(root / "model.yaml", SMALL_LM)
        data = write_training_data(root, seed, (487, 510), 6, (100, 300), 6, (20, 120), 6,
                                   audio_card=60, vocab=500)
        runs = {}
        for device in ("cpu", "cuda"):
            exp = root / f"exp_{device}"
            args = ["--train_data_jsons", data, "--model_config", str(root / "model.yaml"),
                    "--exp_dir", str(exp), "--batch_scale", "1200", "--max_length", "511",
                    "--warmup_steps", "4", "--global_learning_rate", "1e-3", "--dtype",
                    "float32", "--audio_card", "64", "--text_empty_token", "500",
                    "--text_pad_token", "501", "--semantic_empty_token", "60",
                    "--acoustic_empty_token", "60", "--semantic_pad_token", "61",
                    "--acoustic_pad_token", "61", "--codecformer_dim", "64",
                    "--codecformer_heads", "2", "--codecformer_layers", "2",
                    "--codecformer_dim_feedforward", "128", "--grad_clip", "1.0",
                    "--minibatch_debug", "4", "--print_freq", "100", "--seed", str(seed),
                    "--device", device]
            reset_counts()
            first = trainer.main(args + ["--n_epoch", "1"])
            resumed = trainer.main(args + ["--n_epoch", "2"])
            counts = read_counts()
            if not (exp / "ep2.checkpoint").is_dir() or {s["epoch"] for s in resumed["steps"]} != {2}:
                raise AssertionError(f"small training slice on {device}: the second run did not "
                                     "resume from the first epoch's checkpoint")
            runs[device] = (first["steps"] + resumed["steps"], counts)
        (steps_c, counts_c), (steps_g, counts_g) = runs["cpu"], runs["cuda"]
        want = expected_k6(steps_g, SMALL_LM["n_layer"])
        lengths = sorted({s["seq_len"] for s in steps_g})
        if not any(n % 512 == 0 for n in lengths) or all(n % 512 == 0 for n in lengths):
            raise AssertionError(f"small training slice buckets {lengths}: need both a 512 "
                                 "bucket and another")
        got = {k: counts_g[k] for k in want}
        if got != want or any(counts_c[k] for k in want):
            raise AssertionError(f"small training slice K6 launches: card {got} (expected {want}),"
                                 f" CPU {[counts_c[k] for k in want]} (expected none)")
        worst = {"loss": 0.0, "acc": 0.0}
        for sc, sg in zip(steps_c, steps_g, strict=True):
            if (sc["seq_len"], sc["batch_size"]) != (sg["seq_len"], sg["batch_size"]):
                raise AssertionError("the card and the CPU saw different batches")
            for key in ("loss", "loss_audio", "loss_text"):
                rel = abs(sc[key] - sg[key]) / max(abs(sc[key]), 1e-6)
                worst["loss"] = max(worst["loss"], rel)
            for key in ("acc_audio", "acc_text", "acc_audio_tgt", "acc_text_tgt"):
                worst["acc"] = max(worst["acc"], abs(sc[key] - sg[key]))
            if not math.isfinite(sg["loss"]):
                raise AssertionError("non-finite loss on the card")
        log(f"small training slice (2 epochs, 2nd resumed), card vs CPU over {len(steps_g)} "
            f"steps, buckets {lengths}: losses max rel err {worst['loss']:.3e} (limit "
            f"{TRAIN_LOSS_RTOL}), accuracies max abs err {worst['acc']:.3e} (limit "
            f"{TRAIN_ACC_ATOL}); card K6 launches {got}, CPU none; losses "
            + ", ".join(f"{s['loss']:.4f}" for s in steps_g))
        if worst["loss"] > TRAIN_LOSS_RTOL or worst["acc"] > TRAIN_ACC_ATOL:
            raise AssertionError("the small training slice on the card disagrees with the CPU")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def run_full_training_slice(seed: int, n_steps: int, card: str) -> dict:
    """``trainer.main`` on ``configs/llama_1b_speech.yaml`` (bf16, full width
    and depth) for ``n_steps`` steps of synthetic data: long utterances on
    the 1024 bucket (K6) and one batch of short ones (bucket 487, the masked
    path); then the epoch checkpoint. Returns the path's launches."""
    import tempfile

    from rstnet_tpu_torch.models.config import Config
    from rstnet_tpu_torch.training import trainer

    cfg = Config.from_file("configs/llama_1b_speech.yaml")
    root = Path(tempfile.mkdtemp(prefix="smoke_full_train_"))
    # params + AdamW moments, bf16, 2.01 B parameters: ~12 GB on disk
    need = 16 * 2**30
    free = shutil.disk_usage(root).free
    log(f"full training slice: {free / 2**30:.1f} GiB free under {root}")
    if free < need:
        raise RuntimeError(f"the full training slice's checkpoint needs {need / 2**30:.0f} GiB "
                           f"free under {root}, {free / 2**30:.1f} GiB are")
    try:
        data = write_training_data(root, seed, (951, 1023), 2 * n_steps, (430, 470), 6,
                                   (300, 600), 2 * n_steps, audio_card=2048, vocab=128000)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        out = trainer.main(["--train_data_jsons", data,
                            "--model_config", "configs/llama_1b_speech.yaml",
                            "--exp_dir", str(root / "exp"), "--max_length", "1023",
                            "--batch_scale", "2500", "--dtype", "bfloat16", "--n_epoch", "1",
                            "--minibatch_debug", str(n_steps), "--print_freq", "1",
                            "--seed", str(seed), "--device", "cuda"])
        wall = time.perf_counter() - t0
        counts = read_counts()
        steps = out["steps"]
        peak = torch.cuda.max_memory_allocated() / 2**30
        want = expected_k6(steps, cfg.n_layer)
        log(f"full training slice: {len(steps)} steps, buckets "
            f"{[(s['batch_size'], s['seq_len']) for s in steps]}, launches {counts}")
        if len(steps) != n_steps:
            raise AssertionError(f"{len(steps)} train steps, expected {n_steps}")
        if not all(math.isfinite(s[k]) for s in steps for k in ("loss", "loss_audio",
                                                                  "loss_text")):
            raise AssertionError(f"non-finite loss: {[s['loss'] for s in steps]}")
        if not any(s["seq_len"] == 1024 for s in steps):
            raise AssertionError("no step landed on the 1024 bucket: K6 never ran")
        if {k: counts[k] for k in want} != want or any(
                v for k, v in counts.items() if k not in want):
            raise AssertionError(f"full training slice launches {counts}, expected {want}")
        ckpt = Path(out["checkpoints"][-1]["path"])
        size = sum(f.stat().st_size for f in ckpt.rglob("*") if f.is_file())
        for s in steps:
            log(f"  step: B={s['batch_size']} T={s['seq_len']} loss {s['loss']:.4f} (audio "
                f"{s['loss_audio']:.4f}, text {s['loss_text']:.4f}), {s['step_time'] * 1e3:.1f} "
                f"ms, {s['batch_size'] * s['seq_len'] / s['step_time']:.0f} frames/s "
                "(padded, host clock)")
        steady = [s for s in steps[1:] if s["seq_len"] == 1024]
        if steady:
            frames = sum(s["batch_size"] * s["seq_len"] for s in steady)
            log(f"full training slice steady 1024-bucket steps: "
                f"{frames / sum(s['step_time'] for s in steady):.0f} frames/s (padded frames over "
                f"{len(steady)} steps, host clock, informational) [{card}]")
        log(f"full training slice: {wall:.1f} s wall (init included), peak memory {peak:.1f} GiB, "
            f"epoch checkpoint {size / 2**30:.2f} GiB saved in "
            f"{out['checkpoints'][-1]['seconds']:.1f} s [{card}]")
        return counts
    finally:
        shutil.rmtree(root, ignore_errors=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--frames", type=int, default=16,
                        help="frames of the solo slices and ticks of the batched ones")
    parser.add_argument("--sessions", type=int, default=16)
    args = parser.parse_args(argv)
    t_start = time.perf_counter()

    with phase("environment"):
        card = phase_environment()
    with phase("build"):
        phase_build()
    g = torch.Generator(device="cuda").manual_seed(args.seed)
    with phase("kernels"):
        kernels = [check_k1(g, card), check_k1(g, card, int8=True),
                   check_k2(g, card, args.sessions), check_k3(g, card, args.sessions),
                   *check_k6(g, card)]
    with phase("small slices"):
        check_small_slice(args.seed)
        check_small_slice(args.seed, int8=True)
        check_small_batched_slice(args.seed)
    with phase("small training slice"):
        check_small_training_slice(args.seed)
    with phase("full models"):
        mimi, lm_gen = build_full_models(args.seed)
    n, ticks = args.frames, args.frames
    layers = lm_gen.model.depformer.num_layers
    none = dict.fromkeys(_counters(), 0)
    paths = {}
    with phase("full solo slice"):
        paths["solo_frame"] = run_full_slice(
            mimi, lm_gen, args.seed, n, card, "full solo slice",
            {**none, "depformer_step": 8 * n, "rvq_encode": 2 * n})
    with phase("full batched slice"):
        paths["batched_tick"] = run_full_batched_slice(
            mimi, lm_gen, args.seed, args.sessions, ticks, card, "full batched slice",
            {**none, "gating_ffn_step": 8 * layers * ticks, "rvq_encode": 2 * ticks})
    with phase("int8 quantization"):
        from rstnet_tpu_torch.serving.server import quantize_for_serving

        gc.collect()
        torch.cuda.empty_cache()
        quantize_for_serving(lm_gen.model, int8=True)  # the server's --int8, in place
        lm_int8 = dataclasses.replace(lm_gen, kv_int8=True)  # --kv-int8
        torch.cuda.synchronize()
    with phase("full int8 solo slice"):
        paths["solo_frame_int8"] = run_full_slice(
            mimi, lm_int8, args.seed, n, card, "full int8 solo slice (--int8 --kv-int8)",
            {**none, "depformer_step_int8": 8 * n, "rvq_encode": 2 * n})
    with phase("full int8 batched slice"):
        paths["batched_tick_int8"] = run_full_batched_slice(
            mimi, lm_int8, args.seed, args.sessions, ticks, card,
            "full int8 batched slice (--int8 --kv-int8)", {**none, "rvq_encode": 2 * ticks})
    del mimi, lm_gen, lm_int8  # free the card for training
    with phase("full training slice"):
        paths["train_step"] = run_full_training_slice(args.seed, TRAIN_STEPS, card)
    for k in kernels:
        k["launches_by_path"] = {p: counts[k["name"]] for p, counts in paths.items()}
        k["launches"] = sum(k["launches_by_path"].values())
    log(f"chip_smoke total: {time.perf_counter() - t_start:.1f} s wall")
    log(json.dumps({"kernels": kernels}))
    log(card_line())
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
