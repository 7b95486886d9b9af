#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--frames N]

Phases (each prints its findings; any failure exits non-zero):

1. environment: torch, CUDA, nvcc, and the card's name and power limit;
2. build: the hand-written kernels from ``rstnet_tpu_torch/csrc``;
3. kernels: K1 (depformer micro-step) and K3 (RVQ encode) against their
   plain PyTorch versions on the card, at the full-width shapes of the
   serving path (Moshi 7B's depformer, Mimi's quantizer), with timings;
4. small slice: a small Mimi + Moshi serving frame on the card (kernels)
   against the same weights on the CPU (plain versions), teacher-forced;
5. full slice: Mimi 24 kHz (f32) + Moshi 7B (bf16) with seeded random
   weights, driven through ``ServerState.handle_frame_array`` for a few
   80 ms frames, counting each kernel's launches.

The line before the last is the card's ``nvidia-smi`` name and power limit
again, before it a ``{"kernels": [...]}`` JSON line, and the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device it exits non-zero
and prints no result. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# K1 is compared like the Pallas kernel's interpret-mode test: bf16 rounding of
# the normalized activations, the attention output and the gated hidden can
# differ by one bf16 ulp between two summation orders.
K1_ATOL = K1_RTOL = 2e-2
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


def log(*args) -> None:
    print(*args, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def time_ms(fn, reps: int) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn()``, after a warm-up."""
    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


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


def check_k1(g, card: str) -> dict:
    from rstnet_tpu_torch.ops.cuda_depformer import depformer_step, depformer_step_reference

    ops, xs, dims = _k1_operands(g)
    L, S, C = dims["L"], dims["S"], dims["C"]
    zeros = lambda: torch.zeros((L, S, C), device="cuda")  # noqa: E731 - the path's f32 cache
    got, kck, vck = _k1_frame(depformer_step, ops, xs, zeros(), zeros(), dims["heads"])
    want, kcr, vcr = _k1_frame(depformer_step_reference, ops, xs, zeros(), zeros(),
                               dims["heads"])
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    for name, a, b in (("logits", got, want), ("kc", kck, kcr), ("vc", vck, vcr)):
        diff = (a - b).abs()
        bad = diff > K1_ATOL + K1_RTOL * b.abs()
        log(f"K1 {name}: max |kernel - plain| = {diff.max().item():.3e} "
            f"(max |plain| {b.abs().max().item():.3e}), {int(bad.sum())} outside "
            f"atol={K1_ATOL} rtol={K1_RTOL}")
        if bad.any() or not torch.isfinite(a).all():
            raise AssertionError(f"K1 {name} disagrees with depformer_step_reference")
    heads = dims["heads"]
    ms = time_ms(lambda: _k1_frame(depformer_step, ops, xs, zeros(), zeros(), heads), 20) / S
    plain = time_ms(lambda: _k1_frame(depformer_step_reference, ops, xs, zeros(), zeros(),
                                      heads), 5) / S
    log(f"K1 one micro-step (L=6, C=1024, H=2816, card=2048): kernel {ms:.4f} ms, "
        f"plain {plain:.4f} ms [{card}]")
    return {"name": "depformer_step", "route": "cuda",
            "source": "rstnet_tpu_torch/csrc/depformer_step.cu",
            "replaces": "rstnet_tpu/ops/pallas_depformer.py:167",
            "max_abs_err": err, "ms": ms, "plain_ms": plain}


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


def check_k3(g, card: str) -> dict:
    from rstnet_tpu_torch.ops.cuda_rvq import rvq_encode, rvq_encode_reference

    D, K = 256, 2048
    books = torch.randn((7, K, D), device="cuda", generator=g)
    err, timings = 0.0, {}
    for Q in (1, 7):
        for N in (1, 4096):
            x = torch.randn((N, D), device="cuda", generator=g)
            cbs = books[:Q].contiguous()
            codes_k, quant_k = rvq_encode(x, cbs)
            codes_r, quant_r = rvq_encode_reference(x, cbs)
            torch.cuda.synchronize()
            ties, other, agree = _k3_mismatches(x, cbs, codes_k, codes_r)
            qerr = (quant_k[agree] - quant_r[agree]).abs().max().item() if agree.any() else 0.0
            err = max(err, qerr)
            log(f"K3 Q={Q} N={N}: {int(agree.sum())}/{N} rows with equal codes, {ties} near-tie "
                f"rows, {other} other mismatches; quant max abs err {qerr:.3e}")
            if other or qerr > K3_QUANT_ATOL:
                raise AssertionError(f"K3 disagrees with rvq_encode_reference at Q={Q} N={N}")
            timings[(Q, N)] = (time_ms(lambda: rvq_encode(x, cbs), 50),
                               time_ms(lambda: rvq_encode_reference(x, cbs), 50))
            log(f"K3 Q={Q} N={N}: kernel {timings[(Q, N)][0]:.4f} ms, "
                f"plain {timings[(Q, N)][1]:.4f} ms [{card}]")
    ms, plain = timings[(7, 1)]
    return {"name": "rvq_encode", "route": "cuda", "source": "rstnet_tpu_torch/csrc/rvq_encode.cu",
            "replaces": "rstnet_tpu/ops/pallas_rvq.py:67", "max_abs_err": err,
            "ms": ms, "plain_ms": plain}


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


def _small_models(device, seed):
    from rstnet_tpu_torch.inference.generate import LMGen
    from rstnet_tpu_torch.models.mimi import mimi_24k
    from rstnet_tpu_torch.models.moshi_lm import MoshiLMModel

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
    return mimi.to(device), LMGen(lm.to(device), delays=lm.delays, use_sampling=False)


def check_small_slice(seed: int, n_frames: int = 6) -> None:
    from rstnet_tpu_torch.ops.cuda_depformer import depformer_step
    from rstnet_tpu_torch.serving.server import ServerState

    frames = np.random.default_rng(seed).normal(0, 0.1, (n_frames, 1920)).astype(np.float32)
    runs = {}
    for device in ("cpu", "cuda"):
        state = ServerState(*_small_models(device, seed), seed=seed)
        forced = None if device == "cpu" else [tok for _, tok in runs["cpu"][0]]
        before = depformer_step.launches
        with recorded_sampling(forced) as record:
            audio = [state.handle_frame_array(f)[0] for f in frames]
        runs[device] = (record, audio, depformer_step.launches - before)
    (rec_c, audio_c, _), (rec_g, audio_g, k1) = runs["cpu"], runs["cuda"]
    if k1 != 8 * n_frames:
        raise AssertionError(f"small slice launched K1 {k1} times, expected {8 * n_frames}")
    logit_err = max((a - b).abs().max().item() for (a, _), (b, _) in zip(rec_c, rec_g))
    scale = max(a.abs().max().item() for a, _ in rec_c)
    flips = 0
    for (a, tok), (b, _) in zip(rec_c, rec_g):
        top2 = a.topk(2, dim=-1).values
        clear = (top2[..., 0] - top2[..., 1]) > 2 * SLICE_LOGIT_TOL * max(1.0, scale)
        flips += int(((b.argmax(-1) != tok) & clear).sum())
    audio_err = max(float(np.abs(a - b).max()) for a, b in zip(audio_c, audio_g)
                    if a is not None)
    log(f"small slice, card vs CPU over {n_frames} frames: logits max abs err {logit_err:.3e} "
        f"(max |logit| {scale:.3e}), {flips} greedy flips past the margin, "
        f"audio max abs err {audio_err:.3e}")
    if logit_err > SLICE_LOGIT_TOL * max(1.0, scale) or flips or audio_err > SLICE_AUDIO_TOL:
        raise AssertionError("the small slice on the card disagrees with the CPU")


def run_full_slice(seed: int, n_frames: int, card: str) -> dict:
    from rstnet_tpu_torch.ops.cuda_depformer import depformer_kernel_operands, depformer_step
    from rstnet_tpu_torch.ops.cuda_rvq import rvq_encode
    from rstnet_tpu_torch.serving.server import ServerState, build_models

    t0 = time.perf_counter()
    device = torch.device("cuda")
    mimi, lm_gen = build_models(False, device, seed)
    g = torch.Generator(device=device).manual_seed(seed + 1)
    # the default init leaves every codebook at zero, where every code is a
    # tie won by 0; seeded normal codebooks make K3's choices real
    for rvq in (mimi.quantizer.rvq_first, mimi.quantizer.rvq_rest):
        rvq.layers.embedding_sum.normal_(generator=g)
    model = lm_gen.model
    if depformer_kernel_operands(model) is None:
        raise AssertionError("Moshi 7B's depformer is outside K1's envelope")
    n_params = sum(p.numel() for p in model.parameters()) + sum(
        p.numel() for p in mimi.parameters())
    state = ServerState(mimi, lm_gen, seed=seed)
    state.warmup()
    torch.cuda.synchronize()
    log(f"full slice: Mimi 24 kHz + Moshi 7B, {n_params / 1e9:.2f} B params, built and "
        f"warmed up in {time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB peak")

    t = np.arange(n_frames * state.frame_size) / 24000.0
    rng = np.random.default_rng(seed)
    signal = (0.3 * np.sin(2 * np.pi * 220.0 * t) * np.sin(2 * np.pi * 1.5 * t)
              + 0.05 * rng.standard_normal(t.shape)).astype(np.float32)
    frames = signal.reshape(n_frames, state.frame_size)
    n_text = model.text_card + model._extra_text

    rvq_encode.launches = depformer_step.launches = 0
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
    k1, k3 = depformer_step.launches, rvq_encode.launches
    log(f"full slice: {n_frames} frames, {valid} valid; K1 launches {k1} "
        f"({k1 / n_frames:g}/frame), K3 launches {k3} ({k3 / n_frames:g}/frame)")
    if valid != n_frames - lm_gen.max_delay:
        raise AssertionError(f"{valid} valid frames, expected {n_frames - lm_gen.max_delay}")
    if k1 != 8 * n_frames or k3 != 2 * n_frames:
        raise AssertionError("a frame did not go through both kernels as expected")
    ts = sorted(times)
    log(f"full slice frame time: p50 {ts[len(ts) // 2]:.2f} ms, "
        f"p99 {ts[min(len(ts) - 1, int(0.99 * len(ts)))]:.2f} ms over {n_frames} frames "
        f"(host clock, informational) [{card}]")
    return {"depformer_step": k1, "rvq_encode": k3}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--frames", type=int, default=16)
    args = parser.parse_args(argv)

    card = phase_environment()
    phase_build()
    g = torch.Generator(device="cuda").manual_seed(args.seed)
    kernels = [check_k1(g, card), check_k3(g, card)]
    check_small_slice(args.seed)
    launches = run_full_slice(args.seed, args.frames, card)
    for k in kernels:
        k["launches"] = launches[k["name"]]
    log(json.dumps({"kernels": kernels}))
    log(card_line())
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
