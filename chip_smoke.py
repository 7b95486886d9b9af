#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--frames N] [--sessions N]
    python3 chip_smoke.py --trees DIR,DIR [--out F.json]
    python3 chip_smoke.py --codec-only
    python3 chip_smoke.py --ssl-only
    python3 chip_smoke.py --prep-only
    python3 chip_smoke.py --parallel-only
    python3 chip_smoke.py --k6-only

The second form times K4 over float32 weights in each checkout in turn
(``compare_trees``) and runs nothing else.

Phases (each prints its findings; any failure exits non-zero):

1. environment: torch, CUDA, nvcc, and the card's name and power limit;
2. build: the hand-written kernels from ``rstnet_tpu_torch/csrc``;
3. kernels: K1 (depformer micro-step), its int8 variant K1-int8, K2
   (per-step gated FFN) and K3 (RVQ encode, both of its paths) against their
   plain PyTorch versions on the card, at the full-width shapes of the
   serving paths (Moshi 7B's depformer and the flagship's codecformer for
   K1, Mimi's quantizer), with device times and bounds; K1, K2 and K3 are
   also held to bit-identical results across two calls, a K1 micro-step
   and a K3 split-path call to exactly one device kernel under
   ``torch.profiler``, and K2 is timed beside the eager three-call chain and
   two matmuls over the step's slices as views at B in {2, 16, 32, 64};
4. small slices: a small Mimi + Moshi serving frame (solo, K1), the same
   under ``--int8 --kv-int8`` (K1-int8) and a small batched tick
   (``SessionBatcher`` at B=4, K2) on the card against the same weights on
   the CPU (plain versions), teacher-forced; then Mimi 24 kHz alone: the
   device time of one ``encode_step`` + ``decode_step`` with the centroids
   kept across calls and with every level divided on every call (the call
   site before), and path ``codec_encode``: ``MimiModel.encode`` over 8
   seeded clips of 40.96 s (K3's tiled path at 4096 rows), held to the same
   encode through K3's plain version; then codec training: K3 at the
   trainable quantizer's shapes (D=64, K=2048, Q 1 and 7, N=152 on the
   tiled path and N=50 on the split path; entry ``codec_train`` of K3's
   kernels line), path ``small_codec_train`` (``CODEC_SMALL``: 2 G/D steps
   through ``codec_trainer.make_steps`` on the card and on the CPU from the
   same weights, data, teacher features and draws; losses and EMA buffers
   compared) and path ``codec_train_mimi24k`` (``codec_trainer.main`` on
   ``egs/codec/mimi24k.yaml`` at full width over seeded pseudo-speech
   wavs, 3 steps and 2 resumed, the validation step, ``codec_infer`` and
   ``compute_metrics``; step times, device peak, K3 launches asserted, one
   G+D step profiled). ``--codec-only`` runs K3's checks and these two
   paths alone and prints no result line;
5. full slices, on one build of Mimi 24 kHz (f32) + Moshi 7B (bf16) with
   seeded random weights: the solo frame through
   ``ServerState.handle_frame_array``, then ``SessionBatcher.step_once``
   with ``--sessions`` sessions; then the same model quantized in place as
   the server's ``--int8`` does, with an int8 ring (``--kv-int8``), through
   both again. Each path's kernel launches are counted from zero just
   before it runs and read just after; two more ticks of each batched path
   run under ``torch.profiler`` (device busy and K2's time a tick). These
   paths run eagerly (``cuda_graphs=False``). Between the bf16 and the int8
   runs, the same steps as CUDA graph replays (``serving/graphs.py``), each
   against an eager run of the same greedy model on the same frames (text
   tokens equal, audio within ``SLICE_AUDIO_TOL``): paths
   ``solo_frame_graph`` and ``solo_scan_4`` (a ``ServerState`` with
   ``scan_frames`` 4: ``--frames`` single frames, then 4 scans of 4) and
   ``batched_tick_graph`` (``--sessions`` sessions); after the int8 runs,
   the same three as ``solo_frame_int8_graph``, ``solo_scan_4_int8`` and
   ``batched_tick_int8_graph`` (``--int8 --kv-int8``, K1-int8). A graph
   step's warm-up call, capture and first replays run under
   ``torch.cuda.set_sync_debug_mode("error")``; the host counters count
   the warm-up call and the capture (a capture records kernels and
   launches none), and are checked; one replay's launches are counted by
   name, weight type included, from ``torch.profiler``'s device events
   (``CALL_KERNELS``); a path's launches are its warm-up call's and its
   replays' (``graph_launches``). Each path reports graph and eager
   p50/p99, device busy share, capture time and peak memory;
   then public checkpoints (``models/convert.py``), from files written in
   the upstream layouts by ``tools/upstream_layout.py`` under a temporary
   directory removed at the end: Mimi 24 kHz (float32 ``.safetensors``) and
   Moshi 7B (bf16 ``.safetensors``, 15.4 GB) from seeded models, served
   through ``build_server(parse_args(["--mimi-checkpoint", ...,
   "--lm-checkpoint", ...]))`` (Moshi converted to float32, K1 over the
   bf16 rounding of its depformer), every loaded parameter held bit for bit
   to the file's tensor widened to float32, then 16 graph frames and one
   4-frame scan against an eager server (paths ``checkpoint_solo_frame``
   and ``checkpoint_scan_4``; without room on the disk for the Moshi file,
   the Moshi leg converts the in-memory upstream dict and says so); and
   ``offline_tokenization --mode audio`` over 4 seeded clips of 10 s through
   the Mimi file (path ``mimi_tokenize``: K3's tiled path; codes equal to
   ``MimiModel.encode``, ``MimiTokenizer.detokenize`` equal to
   ``MimiModel.decode``);
6. training: K6 (flash attention: the forward and the one-launch backward,
   GQA inside the kernels) against its plain versions at the training shapes
   (H=32 over 8 KV heads, T=1024, D=64; causal and a 256 window; B=2 and the
   main paths' B=4, bf16 and float32, the float32 route on split-bf16
   operands; and head dim 128 at B=4: Qwen2.5-7B's 28 heads over 4 and
   Llama-3.1-8B's 32 over 8, its entries named ``..._d128``), two backward
   calls compared bit for bit, with device, plain, bound and SDPA times; a
   small ``SpeechTextLM`` trained through
   ``rstnet_tpu_torch.training.trainer.main`` (float32, bucket 512; head
   dim 64, then 128) on the
   card and on the CPU from the same weights and data, one epoch and then a
   resumed second, per-step losses compared; then the full Llama-3.2-1B
   speech config (2.01 B parameters, bf16) for ``TRAIN_STEPS`` steps on
   synthetic data, K6 on every step whose bucket is 1024 and on no other;
   then, on that run's experiment, the inference CLIs ``lm_eval`` and
   ``infer_cli`` (path ``speech_cli``: K4 in every backbone step; with
   ``--mimi_checkpoint`` on the Mimi file, a wav beside each grid); then the
   same training run in float32 (path ``train_step_f32``: K6's float32
   kernels, each step's loss held to the bf16 run's, one step profiled),
   and the two CLIs on its float32 checkpoint (path ``speech_cli_f32``: K4
   over float32 weights in every backbone step); and last, a seeded
   Llama-3.2-1B backbone written as litgpt's ``lit_model.pth`` (bf16, 2.5 GB)
   and ``trainer --checkpoint_path`` on it for 3 bf16 steps (path
   ``train_from_litgpt``: the loaded backbone equal to the file after the
   cast, K6 on every 1024-bucket step, step 0's loss equal to that of the
   same model assembled from the source weights); then LM fine-tuning
   through the trainer CLI, weights drawn on the card: the flagship speech
   config ``configs/qwen_7b_speech.yaml`` (Qwen2.5-7B, full width and depth)
   with LoRA r 16 over an int8 frozen base (``--base_int8``), bf16, the
   T=1024 bucket, ``PEFT_STEPS`` steps and as many of a second epoch resumed
   from the first one's trainable-only checkpoint (path
   ``train_qwen7b_peft``: K6 at head dim 128 on every 1024-bucket step), and
   ``--model_family moshi`` at Moshi 7B's widths with LoRA r 16 on the
   temporal transformer (path ``train_moshi7b_lora``: no counted kernel),
   each printing its step time, device and host peaks and frozen and
   trainable bytes; and phase ``moe_small``: a Mixtral-8x7B-width backbone
   cut to 2 layers, float32, forward and backward on the card against the
   CPU;
7. speech streaming: K4 and K5 (the fused gated FFN of the backbone's
   LLaMAMLP, bf16, int8 and float32 weights) against their plain versions
   at Llama-3.2-1B's MLP (C=2048, H=8192; N in {1, 4, 16, 64}, x in bf16
   and float32), two calls bit for bit, with device, plain, bound and eager
   three-GEMM times (phase ``kernels``); a small ``SpeechTextLM`` through
   ``teacher_forced_stream`` on the card and on the CPU from the same
   weights, bf16, then ``quantize_for_serving`` with an int8 ring, then in
   float32; and
   the full flagship (Llama-3.2-1B backbone, codecformer 1024 x 6, bf16,
   seeded random weights) through ``LMGen.step`` at B=1 (path
   ``speech_frame``), then with Mimi 24 kHz through
   ``SessionBatcher.step_once`` with an int8 ring, 16 and then 64 sessions,
   8 ticks each after 3 of warm-up (paths ``speech_batched_tick_16`` and
   ``speech_batched_tick_64``: K4 at N = the sessions), then at B=1 again
   in three more variants, each quantized in place on top of the last:
   ``quantize_head_for_serving``, plus ``quantize_dep_for_serving``, and
   ``quantize_for_serving`` with an int8 ring (paths
   ``speech_frame_head_int8``, ``speech_frame_mixed_int8``,
   ``speech_frame_int8``); each path's frames or ticks timed on the host
   clock, and 4 frames or 2 ticks more under ``torch.profiler``. As CUDA
   graph replays against the eager runs, as in phase 5: the flagship's
   ``LMGen.step`` at B=1 in bf16 (path ``speech_frame_graph``, a
   ``CapturedStep``) and the batched speech tick at 16 sessions (path
   ``speech_batched_tick_16_graph``);
8. last, the GLM-4-Voice SSL stack, which reaches no counted kernel (each
   path asserts so), its seeded weights written in the upstream directory
   layouts by ``tools/upstream_layout.py`` under a temporary directory and
   loaded back: path ``small_ssl`` (the encoder, the flow's conformer,
   U-Net and solver, and HiFT at small widths, card against CPU on the same
   weights and draws), ``ssl_tokenize_glm4v`` (the GLM-4-Voice tokenizer
   at its widths through ``offline_tokenization --mode ssl`` over 63 s of
   seeded pseudo-speech, twice; tokens against a CPU run on a 5 s clip
   beyond near-ties), ``ssl_decode_glm4v`` (the decoder at its widths: 250
   tokens offline and 100 streamed) and ``ssl_resynth`` (the CLI on the
   shard and an scp round trip with ``--stream``); each CLI starts with
   TF32 allowed and must turn it off; wall, device busy, peak memory,
   audio seconds a second or real-time factor, on a ``{"ssl_paths":
   ...}`` line. ``--ssl-only`` runs these four alone and prints no result
   line;
9. last of all, the data-prep slice: the recipes below, then, on Mimi
   24 kHz + Moshi 7B built again (greedy), path ``duplex_ws_solo`` (a
   ``ServerState`` served by ``build_app`` on a localhost port,
   ``serving.client.main --in-wav --codec pcm16`` over 4 s of seeded audio;
   frames back, text and audio held to ``handle_frame_array`` on the same
   frames after a reset, no catch-up scan, K1 and K3) and
   ``duplex_ws_batched_16`` (``build_batched_app`` over a 16-slot
   ``SessionBatcher``, ``client.load_test`` from 16 sockets at the 80 ms
   cadence; K2 and K3); their launches are the frame or tick graph's
   replays during the run times one replay's kernels. The recipes run
   over 4 seeded raw recordings of ~40 s at 44.1 kHz stereo: path
   ``recipe_pretraining`` (stages 1-3 of ``egs/pretraining/run.sh`` as
   ``python -m`` subprocesses: ``pipeline.main``, ``scp_tools split`` and
   ``run_jobs --jobs 2`` of ``offline_tokenization --mode audio``,
   ``create_data_json``; the shards equal an in-process tokenization whose
   K3 launches are counted; stages 4-5 in this process through the same
   ``main``s: the trainer on ``configs/llama_1b_speech.yaml`` cut to 2
   layers for 2 steps, K6 as its buckets imply, and ``lm_eval``) and
   ``recipe_moshi_ft`` (``pipeline.main`` with diarization, denoise,
   super-resolution and sessions; ``--mode duplex`` over the sessions;
   ``create_data_json --task moshi_ft``; 2 trainer steps at
   ``--parallel_number 17 --n_q 16``). Their readings go on a
   ``{"prep_paths": ...}`` line. ``--prep-only`` runs these four alone and
   prints no result line. Phase 4's ``codec_train_mimi24k`` also asserts
   that the codec trainer read every batch through the native loader
   (``WaveDataset.load_batch``), whose first batch equals the per-item
   path's bit for bit;
10. after the data-prep slice, parallel training (``rstnet_tpu_torch/
   parallel``) as two ranks on the one card: each a process of this script
   (``--rank-job``) joined through a ``file://`` store in a temporary
   directory and over gloo (NCCL refuses two ranks on one device), joined
   with a time limit (``RANK_TIMEOUT_S``); a rank that fails or hangs fails
   the run. First a probe: each collective once on CUDA tensors over gloo
   (``PROBED_COLLECTIVES``, send/recv last: it may abort the process) and
   NCCL's answer to two ranks on the device, every answer word for word,
   with the mesh axes each leaves to this card, on a ``{"parallel_probe":
   ...}`` line. Then path ``train_dp2_llama1b``: ``trainer.main --dp 2`` on
   ``configs/llama_1b_speech.yaml`` at full width (bf16, remat), global
   batch B=4 x T=1024 (2 rows a rank), ``DP2_STEPS`` steps, against one
   process on the same global batches (``DP2_*`` tolerances): each rank's
   K6 launches asserted, the losses and every parameter held to the one
   process and the ranks' parameters to each other; step times, the
   gradient all-reduce's time a step, rank 0's step under
   ``tools/profile_frame.py::device_trace`` and both ranks' peaks. And path
   ``codec_train_dp2``: ``codec_trainer.main --dp 2`` on ``CODEC_CONFIG``
   at full width, batch 4 (2 a rank), ``CODEC_DP2_STEPS`` steps, against
   ``--dp 1`` on the same clips and draws (``CODEC_DP2_*``): K3 launches,
   G/D parameters and EMA buffers. Then K4 at a tensor-parallel rank's
   MLP shard of the flagship (``check_k4_shard``: C=2048, H=4096, N 1 and
   2, bf16 and float32 weights, a float32 partial out) against its plain
   version, timed beside the eager three-call chain, and path
   ``tp2_speech_frame``: the flagship at full width served as two ranks
   over ``{"tensor": 2}`` (``LMGen.step`` on weights placed by
   ``shard_params``, greedy): ``TP2_FRAMES`` float32 frames at B=1 (K1)
   and at B=2 (K2), each rank's tokens equal to one process's frames from
   the same weights on the card, and ``TP2_FRAMES`` bf16 frames at B=1
   whose first frame's text logits lie within ``SLICE_LOGIT_TOL`` of one
   process's (over their norm; the token agreement printed, not gated);
   each rank's K4, K1 and K2 launches asserted, and no whole backbone
   weight gathered after the first frame (``parallel/comm.py::
   CollectiveLog``); frame p50/p99 beside the one-process frames, the
   collectives' share of a frame and each rank's peak. Their readings go
   on a ``{"parallel_paths": ...}`` line; their launches (both ranks')
   join the kernels line. ``--parallel-only`` runs this phase alone and
   prints no result line.

Every phase prints its wall time.

Kernel times are device times: a device sleep holds the stream while the
host enqueues the timed calls, so the host's launch cost is not in them.
The line before the last is the card's ``nvidia-smi`` name and power limit
again, before it a ``{"kernels": [...]}`` JSON line (a graph path's
launches of one replay under ``replay_launches_by_path``, and under
``launches_by_path`` its device launches over the run), before that the
graph paths' readings as ``{"graph_paths": ...}`` (and before that the
``{"ssl_paths": ...}``, ``{"prep_paths": ...}`` and ``{"parallel_paths":
...}`` lines), and the last line is
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
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
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
# the float32 run of the full training slice against the bf16 run, same
# weights (the bf16 run's are the float32 ones rounded), data and batches:
# each step's loss within 2e-2 relative, the slack of bf16 against float32
# rounding of weights, activations and updates
F32_LOSS_RTOL = 2e-2
# steps of the full training slice: five land on the 1024 bucket, one on a
# shorter one
TRAIN_STEPS = 6
# K4/K5 use K2's tolerances (K2_TOL): float32 sums in two orders, and for
# bf16 outputs one bf16 step. The small speech slice, card against CPU from
# the same bf16 weights: logits within SLICE_LOGIT_TOL of their scale, and
# the mean CE (nats a token) within this: both sides round bf16 products and
# activations in other places (cuBLAS against ATen on the CPU), a few bf16
# ulps (2**-8 relative) of each logit, which move a mean over hundreds of
# tokens by far less.
SPEECH_CE_TOL = 2e-2
# its float32 variant (K4 over float32 weights, split-bf16 products that
# leave ~2**-17 of each operand out, against float32 on the CPU): logits
# within 1e-5 of their scale and the mean CE within 1e-6. Sound runs read
# ~1e-6 of the logits and ~1.5e-7 of the CE; a control run whose card MLP
# weights are rounded to bf16 (what a route that dropped the weights' lo
# parts computes) reads ~4.7e-4 of the logits (1.5e-4 of their scale) and
# ~1.9e-6 of the CE, and the check must fail it (PERF.md section 6)
SPEECH_F32_LOGIT_TOL = 1e-5
SPEECH_F32_CE_TOL = 1e-6
# a small SpeechTextLM whose widths reach K4/K5's route (n_embd 256, MLP
# 512); its codecformer (128 x 2, card 128, gating hidden 170) stays off K2
SMALL_SPEECH = dict(name="smoke-speech", block_size=256, vocab_size=512, padded_vocab_size=512,
                    n_layer=2, n_head=4, n_embd=256, n_query_groups=2, rotary_percentage=1.0,
                    parallel_residual=False, bias=False, norm_class_name="RMSNorm",
                    mlp_class_name="LLaMAMLP", intermediate_size=512, context=64,
                    audio_card=128, n_q=8, dep_q=8, codecformer_dim=128, codecformer_heads=2,
                    codecformer_layers=2, codecformer_dim_feedforward=256)
# the JAX package's flagship (``__graft_entry__._flagship(tiny=False)``),
# written out: Llama-3.2-1B backbone (16 x 2048, 32 heads over 8 KV groups,
# MLP 8192, vocab 128256, context 3000), codecformer 1024 x 6 with weights
# per step, 8 codebooks of 2048; RoPE at the Config defaults
FLAGSHIP = dict(name="graft-entry", block_size=4096, vocab_size=128000, padded_vocab_size=128256,
                n_layer=16, n_head=32, n_embd=2048, n_query_groups=8, rotary_percentage=1.0,
                parallel_residual=False, bias=False, norm_class_name="RMSNorm",
                mlp_class_name="LLaMAMLP", intermediate_size=8192, context=3000, audio_card=2048,
                codecformer_dim=1024, n_q=8, dep_q=8, codecformer_heads=16, codecformer_layers=6,
                codecformer_dim_feedforward=1024)
# the small codec phase, card against CPU from the same weights, data, teacher
# features and draws, float32 (TF32 off): each G/D loss item within 1e-3 of
# its size (convolutions, FFTs and reductions in other orders over two steps,
# the second after an AdamW update whose g / |g| turns rounding noise of a
# near-zero gradient into a full lr step); each EMA buffer, over its largest
# magnitude, within 1e-5 after the first G step (the same codewords' residual
# sums, the latent's float32 rounding) and within 1e-3 after the second,
# whose forward runs on parameters that one AdamW update may have moved
# apart by up to 2 lr an element where the gradient was ~0 (the first card
# runs read 8.0e-5 there, 1.1e-4 absolute)
CODEC_LOSS_RTOL = 1e-3
CODEC_BUFFER_RTOL = (1e-5, 1e-3)
CODEC_SMALL = {
    "generator": {"name": "MimiCodec", "config": {
        "sample_rate": 24000, "n_filters": 8, "encoder_rates": [4, 5, 6, 8], "latent_dim": 64,
        "codebook_size": 256, "codebook_dim": 16, "rvq_layers": 4, "num_heads": 2,
        "num_layers": 2, "context": 50, "dim_feedforward": 128, "semantic_feature_dim": 32,
        "target_frame_rate": 12.5}},
    "d_list": ["mfd"],
    "mfd": {"config": {"hop_lengths": [32, 64], "hidden_channels": [32, 64], "domain": "double",
                       "mel_scale": True, "sample_rate": 24000}},
    "optimizer": {"g": {"config": {"lr": 2.0e-4, "betas": [0.8, 0.99], "eps": 1.0e-6}},
                  "d": {"config": {"lr": 2.0e-4, "betas": [0.8, 0.99], "eps": 1.0e-6}}},
    "seed": 2333,
}
CODEC_CONFIG = "egs/codec/mimi24k.yaml"
CODEC_STEPS, CODEC_RESUMED_STEPS = 3, 2  # G/D steps of codec_train_mimi24k, then resumed
# codec_train_mimi24k's corpus: seeded pseudo-speech clips (train, then validation)
CODEC_TRAIN_CLIPS, CODEC_CLIP_SECONDS, CODEC_VALID_CLIPS = 8, 4.0, 2
# NVIDIA H100 SXM data sheet: HBM bandwidth and dense peak rates (at 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "tf32": 495e12, "f32": 67e12}


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
        if "Used" in line or "Compiling entry" in line or "spill" in line:
            log("  ptxas:", line.split("ptxas info    :")[-1].strip())
    cuda_lib.kernel_library()


# K1's two shapes on the main paths: Moshi 7B's depformer (solo_frame*) and
# the flagship's codecformer after pad_codecformer_gating (speech_frame*)
K1_SHAPES = {"moshi": dict(H=2816), "flagship": dict(H=768)}


def _k1_operands(g, L=6, S=8, C=1024, heads=16, H=2816, card=2048):
    """K1's operands at full width (Moshi 7B's depformer by default), with
    the model's init scales."""
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
    """K1 (bf16 weights) or K1-int8 at both of its shapes (``K1_SHAPES``), a
    frame of all 8 micro-steps, float32 caches (the solo path's) and bf16
    caches, against the plain version; two frames compared bit for bit; one
    micro-step under ``torch.profiler`` must be exactly one device kernel.
    The kernels line carries Moshi's shape, the flagship's under
    ``"flagship"``."""
    from rstnet_tpu_torch.ops.cuda_depformer import depformer_step, depformer_step_reference
    from rstnet_tpu_torch.tools.profile_frame import device_events

    name = "K1-int8" if int8 else "K1"
    result, err = {}, 0.0
    for shape, dims_kw in K1_SHAPES.items():
        ops, xs, dims = _k1_operands(g, **dims_kw)
        scales = None
        if int8:
            ops, scales = _quantized(ops)
        L, S, C, heads = dims["L"], dims["S"], dims["C"], dims["heads"]
        kernel = functools.partial(depformer_step, scales=scales)
        plain = functools.partial(depformer_step_reference, scales=scales)
        for cache in (torch.float32, torch.bfloat16):
            zeros = lambda: torch.zeros((L, S, C), device="cuda", dtype=cache)  # noqa: E731
            got, kck, vck = _k1_frame(kernel, ops, xs, zeros(), zeros(), heads)
            again = _k1_frame(kernel, ops, xs, zeros(), zeros(), heads)
            want, kcr, vcr = _k1_frame(plain, ops, xs, zeros(), zeros(), heads)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip((got, kck, vck), again)):
                raise AssertionError(f"{name} ({shape}): two frames are not bit-identical")
            err = max(err, (got - want).abs().max().item())
            for what, a, b in (("logits", got, want), ("kc", kck, kcr), ("vc", vck, vcr)):
                a, b = a.float(), b.float()
                diff = (a - b).abs()
                bad = diff > K1_ATOL + K1_RTOL * b.abs()
                log(f"{name} ({shape}) {what}, {str(cache)[6:]} cache: max |kernel - plain| = "
                    f"{diff.max().item():.3e} (max |plain| {b.abs().max().item():.3e}), "
                    f"{int(bad.sum())} outside atol={K1_ATOL} rtol={K1_RTOL}; two frames "
                    "bit-identical")
                if bad.any() or not torch.isfinite(a).all():
                    raise AssertionError(f"{name} {what} disagrees with depformer_step_reference")
        kc, vc = (torch.zeros((L, S, C), device="cuda") for _ in range(2))
        events = device_events(lambda: kernel(xs[S - 1], S - 1, ops["norm1"], ops["in_proj"],
                                              ops["out_proj"], ops["norm2"], ops["gin"],
                                              ops["gout"], ops["head_w"], ops["head_b"], kc, vc,
                                              heads=heads, eps=1e-8))
        if len(events) != 1 or "dep_step_kernel" not in events[0]:
            raise AssertionError(f"{name} ({shape}): a micro-step ran {len(events)} device "
                                 f"events, not one kernel: {events}")
        zeros = lambda: torch.zeros((L, S, C), device="cuda")  # noqa: E731 - the path's f32 cache
        ms = time_ms(lambda: _k1_frame(kernel, ops, xs, zeros(), zeros(), heads), 8) / S
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
        # dequantizing multiply as well, all three at the float32 rate
        bound_ms, bound_by = (bound(n_bytes, 3 * weights, "f32") if int8
                              else bound(n_bytes, 2 * weights, "bf16"))
        log(f"{name} ({shape}) one micro-step (L={L}, C={C}, H={H}, card={card_n}): kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}, "
            f"{n_bytes / 1e6:.1f} MB); one device kernel a micro-step [{card}]")
        result[shape] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                         "bound_by": bound_by}
        del ops, xs
    return {"name": "depformer_step_int8" if int8 else "depformer_step", "route": "cuda",
            "source": "rstnet_tpu_torch/csrc/depformer_step.cu",
            "replaces": "rstnet_tpu/ops/pallas_depformer.py:167"
                        + (" (int8 variant, scales set)" if int8 else ""),
            "max_abs_err": err, **result["moshi"], "library_ms": None,
            "flagship": result["flagship"]}


# K2's two shapes on the main paths (S=8 steps, C=1024): Moshi 7B's
# depformer (batched_tick, at the sessions' B) and the flagship's
# codecformer after pad_codecformer_gating (speech_batched_tick_16 and _64).
# Timed over `layers` layers' 8 steps in turn, beyond the 50 MB L2 as a
# tick's calls find them: Moshi's one layer is 138 MB, the codecformer's
# six 226 MB.
K2_SHAPES = {"moshi": dict(H=2816, batches=(2, 16, 32, 64), layers=1),
             "flagship": dict(H=768, batches=(16, 32, 64), layers=6)}


def check_k2(g, card: str, sessions: int) -> dict:
    """K2 (bf16 weights) at both of its shapes (``K2_SHAPES``), x in bf16 and
    f32, steps 0 and 7, against the plain version; two calls compared bit
    for bit. Timed beside the plain version, the eager three-call chain
    ``silu(x Wg^T) * (x Wv^T) Wo^T`` on the same slices in x's dtype (a
    yardstick: no single PyTorch call computes the function, so it is not
    ``library_ms``), the two matmuls over the step's slices as views that
    the route runs at T == 1 where K2 does not (``step_gated_ffn``), and K2
    on PR 7's schedule (one group of rows, H split to fill the SMs) where
    ``k2_schedule`` picks another; logged: the B at which K2 beats the two
    matmuls at both shapes in this call. The kernels line carries Moshi's
    shape at the sessions' B, the codecformer's at B=16 under
    ``"flagship"``, and each shape's bf16 times by B."""
    import torch.nn.functional as F

    from rstnet_tpu_torch.modules.transformer import step_gated_ffn
    from rstnet_tpu_torch.ops.cuda_ffn import (
        gating_ffn_step,
        gating_ffn_step_reference,
        k2_schedule,
    )

    S, C = 8, 1024
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    err, result = 0.0, {}
    for shape, dims in K2_SHAPES.items():
        H, slices = dims["H"], 8 * dims["layers"]
        lin_in = ((torch.rand((slices, 2 * H, C), device="cuda", generator=g) * 2 - 1) * C**-0.5
                  ).to(torch.bfloat16)
        lin_out = ((torch.rand((slices, C, H), device="cuda", generator=g) * 2 - 1) * H**-0.5
                   ).to(torch.bfloat16)
        headline = sessions if shape == "moshi" else 16
        by_b = {}
        for B in sorted({*dims["batches"], headline}):
            for dtype in (torch.bfloat16, torch.float32):
                x = torch.randn((B, C), device="cuda", generator=g).to(dtype)
                rtol, atol = K2_TOL[dtype]
                for step in (0, 7):
                    got = gating_ffn_step(x, lin_in, lin_out, step)
                    again = gating_ffn_step(x, lin_in, lin_out, step)
                    want = gating_ffn_step_reference(x, lin_in, lin_out, step)
                    torch.cuda.synchronize()
                    if not torch.equal(got, again):
                        raise AssertionError(f"K2 ({shape}) B={B} {dtype} step={step}: two "
                                             "calls differ")
                    diff = (got.float() - want.float()).abs()
                    bad = int((diff > atol + rtol * want.float().abs()).sum())
                    err = max(err, diff.max().item())
                    if bad or not torch.isfinite(got).all():
                        raise AssertionError(
                            f"K2 ({shape}) B={B} {dtype} step={step}: {bad} elements outside "
                            f"rtol={rtol} atol={atol} (max err {diff.max().item():.3e})")
                turn = iter(range(1 << 30))
                ms = time_ms(lambda: gating_ffn_step(x, lin_in, lin_out, next(turn) % slices), 96)
                plain = time_ms(lambda: gating_ffn_step_reference(x, lin_in, lin_out,
                                                                  next(turn) % slices), 48)
                w_in, w_out = lin_in.to(dtype), lin_out.to(dtype)  # the chain's, in x's dtype

                def chain():
                    s = next(turn) % slices
                    gate, val = (x @ w_in[s].T).chunk(2, dim=-1)
                    return (F.silu(gate) * val) @ w_out[s].T

                chain_ms = time_ms(chain, 96)
                del w_in, w_out
                h = x[:, None]
                views_ms = time_ms(lambda: step_gated_ffn(h, lin_in, lin_out,
                                                          next(turn) % slices, "silu"), 96)
                schedule = k2_schedule(x.device, B, C, H)
                pr7 = (1, max(1, min(H // 128, 2 * sms // (C // 32))))
                pr7_ms = None if schedule == pr7 else time_ms(
                    lambda: gating_ffn_step(x, lin_in, lin_out, next(turn) % slices,
                                            schedule=pr7), 96)
                xb = x.element_size()
                bound_ms, bound_by = bound(2 * 3 * H * C + 2 * B * C * xb, 2 * B * 3 * H * C,
                                           "bf16")
                log(f"K2 ({shape}) B={B} x {str(dtype)[6:]} (C={C}, H={H}): kernel {ms:.4f} ms "
                    f"(groups, splits {schedule}"
                    + ("" if pr7_ms is None else f"; PR 7's {pr7}: {pr7_ms:.4f} ms") + "), "
                    f"plain {plain:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), eager "
                    f"three-call chain {chain_ms:.4f} ms, two matmuls on the slices as views "
                    f"{views_ms:.4f} ms; two calls bit-identical [{card}]")
                if dtype == torch.bfloat16:
                    by_b[B] = {"ms": ms, "chain_ms": chain_ms, "views_chain_ms": views_ms,
                               "pr7_schedule_ms": pr7_ms, "bound_ms": bound_ms,
                               "schedule": schedule}
                    if B == headline:
                        result[shape] = {"ms": ms, "plain_ms": plain, "bound_ms": bound_ms,
                                         "bound_by": bound_by, "three_call_chain_ms": chain_ms,
                                         "H": H, "B": B}
        result[shape]["by_batch_bf16"] = by_b
        del lin_in, lin_out
    by_shape = [r["by_batch_bf16"] for r in result.values()]
    wins = [B for B in sorted(set.intersection(*map(set, by_shape)))
            if all(t[B]["ms"] < t[B]["views_chain_ms"] for t in by_shape)]
    log(f"K2 against two matmuls on the slices as views, bf16 x: K2 is faster at both shapes "
        f"at B = {wins or 'none'} of those timed at both [{card}]")
    log(f"K2 max |kernel - plain| {err:.3e} over shapes, B, dtypes and steps")
    return {"name": "gating_ffn_step", "route": "cuda",
            "source": "rstnet_tpu_torch/csrc/gating_ffn_step.cu",
            "replaces": "rstnet_tpu/ops/pallas_ffn.py:230", "max_abs_err": err,
            **result["moshi"], "library_ms": None, "flagship": result["flagship"]}


# K4/K5's rows on the paths: the flagship frame (1), the batched speech tick
# (16 and 64 sessions), and 4 between
K4_K5_ROWS = (1, 4, 16, 64)
# the device kernels of one K4 or K5 call (csrc/gating_ffn.cu)
K4_KERNEL_NAMES = ("gate_value_tc", "down_tc", "sum_down_splits", "split_rows",
                   "core_gate_value", "core_down")


def check_k4_k5(g, card: str, only: tuple = ()) -> list[dict]:
    """K4 (bf16 weights), K5 (the same weights quantized by the port's
    ``quantize_weight_int8``) and K4 over the same weights in float32 (its
    entry ``gating_ffn_f32_weights``: split into bf16 parts in registers,
    path ``speech_cli_f32``) at Llama-3.2-1B's MLP (C=2048, H=8192, the
    model's init scales), N in ``K4_K5_ROWS``, x in bf16 and float32, each
    against its plain version, two calls compared bit for bit. Timed over
    three weight sets in turn, so no call finds its weights in the 50 MB L2
    (as a frame's 16 layers do not); beside each kernel its plain version
    and the eager three-GEMM chain ``silu(x Wg^T) * (x Wv^T) Wo^T`` in x's
    dtype (a yardstick: no single PyTorch call computes the function; over
    float32 weights and a bf16 x timed on weights cast before timing, and
    with the cast in every call, the same function as the kernel's). Each
    kernels entry carries its first case (K4 and K5: the main path's N=1
    with bf16 x; K4 over float32 weights: ``speech_cli_f32``'s N=1 with an
    f32 x) and under ``by_rows`` every N's kernel, chain and bound times
    (bf16 x, and with an ``f32_`` prefix float32 x). ``only``: the entries
    to run, by name (all when empty)."""
    import torch.nn.functional as F

    from rstnet_tpu_torch.modules.transformer import quantize_weight_int8
    from rstnet_tpu_torch.ops.cuda_ffn import (
        dequantize_rows,
        gating_ffn,
        gating_ffn_int8,
        gating_ffn_int8_reference,
        gating_ffn_reference,
    )

    C, H, n_sets = 2048, 8192, 3
    bf16, f32 = torch.bfloat16, torch.float32

    def uniform(rows, cols):
        return ((torch.rand((rows, cols), device="cuda", generator=g) * 2 - 1)
                * cols**-0.5).to(bf16)

    sets = [[uniform(H, C), uniform(H, C), uniform(C, H)] for _ in range(n_sets)]
    qsets = []
    for ws in sets:
        q = [quantize_weight_int8(w) for w in ws]
        qsets.append([t for wq in q for t in (wq.w_int8.data, wq.scale.data)])
    k4 = "rstnet_tpu/ops/pallas_ffn.py:79"
    # name: (kernel, plain, weight sets, replaces, x dtypes: the first one's N=1 heads the entry)
    kernels = {
        "gating_ffn": (gating_ffn, gating_ffn_reference, sets, k4, (bf16, f32)),
        "gating_ffn_int8": (gating_ffn_int8, gating_ffn_int8_reference, qsets,
                            "rstnet_tpu/ops/pallas_ffn.py:152", (bf16, f32)),
        "gating_ffn_f32_weights": (gating_ffn, gating_ffn_reference,
                                   [[t.float() for t in ws] for ws in sets],
                                   k4 + " (float32 weights)", (f32, bf16)),
    }
    kernels = {k: v for k, v in kernels.items() if not only or k in only}
    entries = []
    for name, (kernel, plain, wsets, replaces, dtypes) in kernels.items():
        err, result, by_rows = 0.0, None, {}
        wtype = wsets[0][0].dtype
        for N in K4_K5_ROWS:
            for dtype in dtypes:
                x = torch.randn((N, C), device="cuda", generator=g).to(dtype)
                rtol, atol = K2_TOL[dtype]
                got = kernel(x, *wsets[0])
                again = kernel(x, *wsets[0])
                want = plain(x, *wsets[0])
                torch.cuda.synchronize()
                if not torch.equal(got, again):
                    raise AssertionError(f"{name} N={N} {dtype}: two calls differ")
                diff = (got.float() - want.float()).abs()
                bad = int((diff > atol + rtol * want.float().abs()).sum())
                err = max(err, diff.max().item())
                if bad or not torch.isfinite(got).all() or got.dtype != dtype:
                    raise AssertionError(f"{name} N={N} {dtype}: {bad} elements outside rtol={rtol}"
                                         f" atol={atol} (max err {diff.max().item():.3e})")
                turn = iter(range(1 << 30))
                ms = time_ms(lambda: kernel(x, *wsets[next(turn) % n_sets]), 60)
                plain_ms = time_ms(lambda: plain(x, *wsets[next(turn) % n_sets]), 10)
                # the yardstick's weights in x's dtype (dequantized for K5), made before timing
                chains = [[t.to(dtype) for t in ws] if wtype != torch.int8 else
                          [dequantize_rows(*ws[i:i + 2]).to(dtype) for i in (0, 2, 4)]
                          for ws in wsets]

                def chain():
                    wg, wv, wo = chains[next(turn) % n_sets]
                    return (F.silu(x @ wg.T) * (x @ wv.T)) @ wo.T

                chain_ms = time_ms(chain, 30)
                del chains
                cast_ms = None
                if wtype == f32 and dtype != f32:
                    # the same function as the kernel's: the wrapper's cast of the float32
                    # weights to x's dtype is part of every call

                    def chain_cast():
                        wg, wv, wo = (t.to(dtype) for t in wsets[next(turn) % n_sets])
                        return (F.silu(x @ wg.T) * (x @ wv.T)) @ wo.T

                    cast_ms = time_ms(chain_cast, 30)
                xb, wb = x.element_size(), wsets[0][0].element_size()
                n_bytes = wb * 3 * H * C + 2 * N * C * xb + (4 * (2 * H + C) if wb == 1 else 0)
                # the products as the tensor-core kernels run them, a multiply and
                # an add a weight and row each: in the gate/value pass once for a
                # bf16 x and twice for an f32 one (hi + lo), in the down pass twice
                # (the f32 hidden as hi + lo); float32 weights under an f32 x add
                # their lo part against the hi part of x and of the hidden (three
                # products in each pass), under a bf16 x they enter as bf16(w) only;
                # K5's int8 weights are widened exactly and its row scales multiply
                # row sums
                parts = 1 if dtype == bf16 else 2
                lo = int(wtype == f32 and dtype == f32)
                bound_ms, bound_by = bound(
                    n_bytes, 2 * N * (2 * H * C * (parts + lo) + C * H * (2 + lo)), "bf16")
                log(f"{name} N={N} x {str(dtype)[6:]} (C={C}, H={H}): kernel {ms:.4f} ms, plain "
                    f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}, "
                    f"{n_bytes / 1e6:.1f} MB), eager three-GEMM chain {chain_ms:.4f} ms"
                    + ("" if cast_ms is None else f" on weights cast before timing, "
                       f"{cast_ms:.4f} ms with the cast in the call")
                    + f"; two calls bit-identical [{card}]")
                prefix = "" if dtype == bf16 else "f32_"
                row = by_rows.setdefault(str(N), {})
                row.update({prefix + "ms": ms, prefix + "chain_ms": chain_ms,
                            prefix + "bound_ms": bound_ms})
                if cast_ms is not None:
                    row[prefix + "chain_cast_ms"] = cast_ms
                if result is None:  # the entry's first case
                    result = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                              "bound_by": bound_by, "three_gemm_ms": chain_ms}
        log(f"{name} max |kernel - plain| {err:.3e} over N and dtypes")
        entries.append({"name": name, "route": "cuda",
                        "source": "rstnet_tpu_torch/csrc/gating_ffn.cu", "replaces": replaces,
                        "max_abs_err": err, **result, "library_ms": None, "by_rows": by_rows})
    del sets, qsets, kernels
    torch.cuda.empty_cache()
    return entries


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
    """K3 at Mimi's quantizer shapes (D=256, K=2048), Q in {1, 7} x N in
    {1, 8, 16, 32, 64, 4096, sessions}: both paths where both apply (the
    split path up to 64 rows, the tiled path at every N), each held to
    ``rvq_encode_reference`` by the near-tie rule and two calls compared bit
    for bit, a split call asserted to be one device kernel; device times
    beside plain and each path's bound (the split path's float32 FMAs at the
    f32 rate; the tiled path's three TF32 products a product at the TF32
    rate). The kernels line carries Q=7 at the sessions' N (the wrapper's
    path), and the tiled path at Q=7, N=4096 under ``tiled_4096``."""
    from rstnet_tpu_torch.ops import cuda_rvq
    from rstnet_tpu_torch.ops.cuda_rvq import rvq_encode, rvq_encode_reference
    from rstnet_tpu_torch.tools.profile_frame import device_events

    D, K = 256, 2048
    books = torch.randn((7, K, D), device="cuda", generator=g)
    err, result, tiled_4096 = 0.0, None, None
    for Q in (1, 7):
        cbs = books[:Q].contiguous()
        for N in sorted({1, 8, 16, 32, 64, 4096, sessions}):
            x = torch.randn((N, D), device="cuda", generator=g)
            codes_r, quant_r = rvq_encode_reference(x, cbs)
            plain = time_ms(lambda: rvq_encode_reference(x, cbs), 20)
            paths = {"tiled": 0, "split": 64} if N <= 64 else {"tiled": 0}
            times, notes = {}, []
            for path, rows in paths.items():
                with rvq_split_rows(rows):
                    codes_k, quant_k = rvq_encode(x, cbs)
                    codes_2, quant_2 = rvq_encode(x, cbs)
                    torch.cuda.synchronize()
                    if not (torch.equal(codes_k, codes_2) and torch.equal(quant_k, quant_2)):
                        raise AssertionError(f"K3 {path} Q={Q} N={N}: two calls differ")
                    ties, other, agree = _k3_mismatches(x, cbs, codes_k, codes_r)
                    qerr = ((quant_k[agree] - quant_r[agree]).abs().max().item()
                            if agree.any() else 0.0)
                    err = max(err, qerr)
                    if other or qerr > K3_QUANT_ATOL:
                        raise AssertionError(f"K3 {path} disagrees with rvq_encode_reference at "
                                             f"Q={Q} N={N}: {other} rows, quant err {qerr:.3e}")
                    if path == "split":
                        events = device_events(lambda: rvq_encode(x, cbs))
                        if len(events) != 1 or "rvq_split_kernel" not in events[0]:
                            raise AssertionError(f"K3 split Q={Q} N={N}: {len(events)} device "
                                                 f"events, not one kernel: {events}")
                    times[path] = time_ms(lambda: rvq_encode(x, cbs), 30)
                    notes.append(f"{path} {int(agree.sum())}/{N} rows with equal codes, {ties} "
                                 "near-tie")
            n_bytes = 4 * (N * D + Q * K * D + N * Q + N * D)
            products = 2 * N * Q * K * D
            bounds = {"split": bound(n_bytes, products, "f32"),
                      "tiled": bound(n_bytes, 3 * products, "tf32")}
            chosen = "split" if N <= cuda_rvq.SPLIT_MAX_ROWS else "tiled"
            log(f"K3 Q={Q} N={N}: " + ", ".join(
                f"{p} {t:.4f} ms (bound {bounds[p][0]:.4f}, {bounds[p][1]})"
                for p, t in times.items())
                + f"; wrapper takes {chosen}; plain {plain:.4f} ms; " + "; ".join(notes)
                + f"; two calls bit-identical{', a split call one kernel' if N <= 64 else ''} "
                f"[{card}]")
            entry = {"ms": times[chosen], "plain_ms": plain, "bound_ms": bounds[chosen][0],
                     "bound_by": bounds[chosen][1]}
            if Q == 7 and N == sessions:
                result = entry
            if Q == 7 and N == 4096:
                tiled_4096 = {"ms": times["tiled"], "plain_ms": plain,
                              "bound_ms": bounds["tiled"][0], "bound_by": bounds["tiled"][1]}
    codec_train, codec_err = check_k3_codec_shapes(g, card)
    return {"name": "rvq_encode", "route": "cuda", "source": "rstnet_tpu_torch/csrc/rvq_encode.cu",
            "replaces": "rstnet_tpu/ops/pallas_rvq.py:67", "max_abs_err": max(err, codec_err),
            **result, "library_ms": None, "tiled_4096": tiled_4096, "codec_train": codec_train}


# the trainable quantizer's sweep: D=64, K=2048, rvq_first Q=1 and rvq_rest
# Q=7, at one training step's rows (batch 4 x 38 frames: the tiled path) and
# one 4 s clip's of codec_infer (50 frames: the split path)
K3_CODEC_SHAPES = [(Q, N) for N in (152, 50) for Q in (1, 7)]


def check_k3_codec_shapes(g, card: str) -> tuple[dict, float]:
    """K3 at ``K3_CODEC_SHAPES`` through the wrapper (the path it takes),
    each held to ``rvq_encode_reference`` by the near-tie rule and two calls
    compared bit for bit, with device, plain and bound times. -> ({"Q{Q}_
    N{N}": entry}, the largest quantized-sum error of agreeing rows)."""
    from rstnet_tpu_torch.ops import cuda_rvq
    from rstnet_tpu_torch.ops.cuda_rvq import rvq_encode, rvq_encode_reference

    D, K = 64, 2048
    books = torch.randn((7, K, D), device="cuda", generator=g)
    out, err = {}, 0.0
    for Q, N in K3_CODEC_SHAPES:
        cbs = books[:Q].contiguous()
        x = torch.randn((N, D), device="cuda", generator=g)
        codes_k, quant_k = rvq_encode(x, cbs)
        codes_2, quant_2 = rvq_encode(x, cbs)
        if not (torch.equal(codes_k, codes_2) and torch.equal(quant_k, quant_2)):
            raise AssertionError(f"K3 D=64 Q={Q} N={N}: two calls differ")
        codes_r, quant_r = rvq_encode_reference(x, cbs)
        ties, other, agree = _k3_mismatches(x, cbs, codes_k, codes_r)
        qerr = (quant_k[agree] - quant_r[agree]).abs().max().item() if agree.any() else 0.0
        err = max(err, qerr)
        if other or qerr > K3_QUANT_ATOL:
            raise AssertionError(f"K3 D=64 disagrees with rvq_encode_reference at Q={Q} N={N}: "
                                 f"{other} rows, quant err {qerr:.3e}")
        path = "split" if N <= cuda_rvq.SPLIT_MAX_ROWS else "tiled"
        ms = time_ms(lambda: rvq_encode(x, cbs), 30)
        plain = time_ms(lambda: rvq_encode_reference(x, cbs), 20)
        n_bytes = 4 * (N * D + Q * K * D + N * Q + N * D)
        products = 2 * N * Q * K * D
        b_ms, b_by = (bound(n_bytes, products, "f32") if path == "split"
                      else bound(n_bytes, 3 * products, "tf32"))
        out[f"Q{Q}_N{N}"] = {"path": path, "ms": ms, "plain_ms": plain, "bound_ms": b_ms,
                             "bound_by": b_by}
        log(f"K3 D=64 K=2048 Q={Q} N={N}: {path} {ms:.4f} ms (bound {b_ms:.4f}, {b_by}); plain "
            f"{plain:.4f} ms; {int(agree.sum())}/{N} rows with equal codes, {ties} near-tie; two "
            f"calls bit-identical [{card}]")
    return out, err


def _all_levels_embedding(self, levels=None):
    """The centroids as the call site built them before they were kept:
    every level divided on every call, then sliced."""
    emb = self.embedding_sum / self.cluster_usage.clamp_min(self.epsilon)[..., None]
    return emb if levels is None else emb[:levels]


def check_codec_centroids(mimi, seed: int, card: str) -> None:
    """Device time of one Mimi ``encode_step`` + ``decode_step`` (B=1, one
    80 ms frame) under ``torch.profiler``: with the centroids divided once
    and kept (``EuclideanCodebook.embedding``), and with every level divided
    on every call (``_all_levels_embedding`` patched in), in turns (kept,
    all levels, all levels, kept; 4 profiled frames each after 2 of
    warm-up). Both give the same codes."""
    from rstnet_tpu_torch.quantization.codebook import EuclideanCodebook

    pcm = torch.from_numpy(_signal(seed, 6 * 1920)).cuda().view(1, 1, -1)
    kept = EuclideanCodebook.embedding
    busy, div, first = {"kept": [], "all levels": []}, {"kept": [], "all levels": []}, {}
    for mode in ("kept", "all levels", "all levels", "kept"):
        EuclideanCodebook.embedding = kept if mode == "kept" else _all_levels_embedding
        try:
            state = {"enc": mimi.init_encode_state(1, device=pcm.device),
                     "dec": mimi.init_decode_state(1, device=pcm.device)}

            def frame(i):
                codes, state["enc"] = mimi.encode_step(state["enc"],
                                                       pcm[..., 1920 * i: 1920 * (i + 1)])
                _, state["dec"] = mimi.decode_step(state["dec"], codes)
                return codes

            with torch.no_grad():
                first.setdefault(mode, frame(0))
                frame(1)
                b, d = device_kernel_ms(lambda: [frame(i) for i in range(2, 6)], ("DivFunctor",))
        finally:
            EuclideanCodebook.embedding = kept
        busy[mode].append(b / 4)
        div[mode].append(d / 4)
    if not torch.equal(first["kept"], first["all levels"]):
        raise AssertionError("kept centroids change Mimi's codes")
    for mode in busy:
        log(f"Mimi encode_step + decode_step, centroids {mode}: device busy "
            f"{', '.join(f'{t:.4f}' for t in busy[mode])} ms a frame, of which division "
            f"{', '.join(f'{t:.4f}' for t in div[mode])} ms [{card}]")


CODEC_CLIPS, CODEC_SECONDS = 8, 40.96  # 8 x 512 frames at 12.5 Hz: 4096 rows a K3 call


def run_codec_encode(mimi, seed: int, card: str, expected: dict) -> dict:
    """Path ``codec_encode``: ``MimiModel.encode`` (the non-streaming
    encode) over ``CODEC_CLIPS`` seeded clips of ``CODEC_SECONDS`` s, one K3
    call of 4096 rows a quantizer (the tiled path). Each call's codes are
    held by the near-tie rule against ``rvq_encode_reference`` on the same
    inputs, and the whole encode's codes against the same encode routed
    through ``rvq_encode_reference`` on the card; wall and device time."""
    from rstnet_tpu_torch.ops.cuda_rvq import rvq_encode, rvq_encode_reference
    from rstnet_tpu_torch.quantization import rvq as rvq_module

    n = int(CODEC_SECONDS * 24000)
    audio = torch.from_numpy(np.stack([_signal(seed + i, n, 110.0 * (i + 1))
                                       for i in range(CODEC_CLIPS)])).cuda().view(CODEC_CLIPS, 1, n)
    calls = []

    def recorded(x, cbs):
        codes, quant = rvq_encode(x, cbs)
        calls.append((x, cbs, codes))
        return codes, quant

    with torch.no_grad():
        mimi.encode(audio[:1, :, : 24000 * 2])  # warm-up
        torch.cuda.synchronize()
        rvq_module.rvq_encode = recorded
        try:
            reset_counts()
            t0 = time.perf_counter()
            codes = mimi.encode(audio)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = read_counts()
        finally:
            rvq_module.rvq_encode = rvq_encode
        rvq_module.rvq_encode = rvq_encode_reference
        try:
            codes_ref = mimi.encode(audio)
        finally:
            rvq_module.rvq_encode = rvq_encode
        busy, k3 = device_kernel_ms(lambda: mimi.encode(audio), ("rvq_", "codeword_sq_norms"))
    if counts != expected:
        raise AssertionError(f"codec_encode launched {counts}, expected {expected}")
    rows, ties = 0, 0
    for x, cbs, ck in calls:
        n_ties, other, _ = _k3_mismatches(x, cbs, ck, rvq_encode_reference(x, cbs)[0])
        if other:
            raise AssertionError(f"codec_encode: K3 disagrees with rvq_encode_reference on "
                                 f"{other} rows")
        rows, ties = rows + x.shape[0], ties + n_ties
    differ = int((codes != codes_ref).any(1).sum())  # frames, each a row of a K3 call
    if differ > ties:
        raise AssertionError(f"codec_encode: {differ} frames differ from the reference route "
                             f"with {ties} near-ties")
    log(f"codec_encode: MimiModel.encode of {CODEC_CLIPS} x {CODEC_SECONDS} s, codes "
        f"{tuple(codes.shape)} ({calls[0][0].shape[0]} rows a K3 call); {differ} frames differ "
        f"from the encode through rvq_encode_reference, {ties} near-ties of {rows} rows; wall "
        f"{wall:.3f} s, device busy {busy:.3f} ms, K3 {k3:.3f} ms; K3 launches "
        f"{counts['rvq_encode']} [{card}]")
    return counts


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
        state = ServerState(*_small_models(device, seed, int8), seed=seed, cuda_graphs=False)
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
        batcher = SessionBatcher(mimi, gen, max_sessions=sessions, dtype=torch.float32, seed=seed,
                                 cuda_graphs=False)
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
    from rstnet_tpu_torch.ops.cuda_ffn import gating_ffn, gating_ffn_int8, gating_ffn_step
    from rstnet_tpu_torch.ops.cuda_rvq import rvq_encode

    return {"depformer_step": (depformer_step, "launches"),
            "depformer_step_int8": (depformer_step, "launches_int8"),
            "gating_ffn_step": (gating_ffn_step, "launches"),
            "rvq_encode": (rvq_encode, "launches"),
            "flash_attention_fwd": (cuda_flash.flash_attention_fwd, "launches"),
            "flash_attention_bwd": (cuda_flash.flash_attention_bwd, "launches"),
            "flash_attention_fwd_f32": (cuda_flash.flash_attention_fwd, "launches_f32"),
            "flash_attention_bwd_f32": (cuda_flash.flash_attention_bwd, "launches_f32"),
            "flash_attention_fwd_d128": (cuda_flash.flash_attention_fwd, "launches_d128"),
            "flash_attention_bwd_d128": (cuda_flash.flash_attention_bwd, "launches_d128"),
            "flash_attention_fwd_f32_d128": (cuda_flash.flash_attention_fwd,
                                             "launches_f32_d128"),
            "flash_attention_bwd_f32_d128": (cuda_flash.flash_attention_bwd,
                                             "launches_f32_d128"),
            "gating_ffn": (gating_ffn, "launches"),
            "gating_ffn_int8": (gating_ffn_int8, "launches"),
            "gating_ffn_f32_weights": (gating_ffn, "launches_f32w")}


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
    state = ServerState(mimi, lm_gen, seed=seed, cuda_graphs=False)
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
    batcher = SessionBatcher(mimi, lm_gen, max_sessions=sessions, seed=seed, cuda_graphs=False)
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

    def tick(_):
        for i, sess in enumerate(active):
            sess.inputs.put_nowait(signals[i, -1])
        batcher.step_once()

    busy, k2_ms = device_kernel_ms(lambda: [tick(t) for t in range(2)], K2_KERNEL_NAMES)
    log(f"{path} profiler over 2 ticks: device busy {busy / 2:.3f} ms a tick, K2 "
        f"{k2_ms / 2:.3f} ms a tick ({expected.get('gating_ffn_step', 0) // n_ticks} calls) "
        f"[{card}]")
    return counts


# the device kernels of one K2 call (csrc/gating_ffn_step.cu)
K2_KERNEL_NAMES = ("gate_value_mma", "down_mma", "sum_splits", "gate_value_kernel", "down_kernel")


def device_kernel_ms(fn, names, once: bool = False) -> tuple[float, float]:
    """(device busy ms, ms the device spent in events whose name holds one
    of ``names``: the union of their spans, so kernels that overlap, as K2's
    do, count once) over one ``fn()`` under ``torch.profiler``
    (``device_trace``; ``once``: one window, not confirmed, for an ``fn``
    that must not run twice)."""
    from rstnet_tpu_torch.tools.profile_frame import _union_us, device_trace

    dev = (device_trace(fn, attempts=1, confirm=False) if once else device_trace(fn))[0]
    busy = _union_us([(e.time_range.start, e.time_range.end) for e in dev]) / 1000
    matched = _union_us([(e.time_range.start, e.time_range.end) for e in dev
                         if any(n in e.name for n in names)])
    return busy, matched / 1000


@contextlib.contextmanager
def recorded_stream_logits():
    """Record the logits ``teacher_forced_stream`` samples from (text, then
    each codebook, every frame)."""
    from rstnet_tpu_torch.evalsuite import quant_quality

    orig, record = quant_quality.sample_token, []

    def sample(logits, *args, **kwargs):
        record.append(logits.float().cpu())
        return orig(logits, *args, **kwargs)

    quant_quality.sample_token = sample
    try:
        yield record
    finally:
        quant_quality.sample_token = orig


def _speech_slice_readings(runs: dict, tol: float, ce_tol: float) -> tuple[dict, bool]:
    """The small speech slice's card run against its CPU run: the readings,
    and whether they lie within the limits (logits within ``tol`` of their
    scale, no greedy token flipped past the near-tie margin, CE within
    ``ce_tol``)."""
    (rc, lc, _), (rg, lg, _) = runs["cpu"], runs["cuda"]
    scale = max(a.abs().max().item() for a in lc)
    logit_err = max((a - b).abs().max().item() for a, b in zip(lc, lg))
    flips = 0
    for a, b in zip(lc, lg):
        top2 = a.topk(2, dim=-1).values
        clear = (top2[..., 0] - top2[..., 1]) > 2 * tol * max(1.0, scale)
        flips += int(((a.argmax(-1) != b.argmax(-1)) & clear).sum())
    ce_err = max(abs(rc.ce_text - rg.ce_text), abs(rc.ce_audio - rg.ce_audio))
    r = dict(scale=scale, logit_err=logit_err, flips=flips, ce_err=ce_err,
             greedy_diff=int((rc.greedy != rg.greedy).sum()), tokens=rc.greedy.size,
             ce=(rg.ce_text, rc.ce_text, rg.ce_audio, rc.ce_audio))
    return r, logit_err <= tol * max(1.0, scale) and not flips and ce_err <= ce_tol


def check_small_speech_slice(seed: int, n_frames: int = 8) -> None:
    """A small ``SpeechTextLM`` (widths inside K4/K5's route) through
    ``teacher_forced_stream`` at B=2 on the card and on the CPU from the
    same weights and grid: bf16, then ``quantize_for_serving`` (quantized on
    the CPU, copied to the card) with an int8 ring, then the model built in
    float32 from the same seed. The card launches K4 (bf16), K5 (int8) or
    K4 over float32 weights once a layer a frame and nothing else. bf16 and
    int8 are held to ``SLICE_LOGIT_TOL`` and ``SPEECH_CE_TOL``, float32 to
    its own ``SPEECH_F32_*`` limits; a float32 control run, the card's
    backbone MLP weights rounded to bf16, must fall outside them."""
    import copy

    from rstnet_tpu_torch.evalsuite.quant_quality import teacher_forced_stream
    from rstnet_tpu_torch.models.config import Config
    from rstnet_tpu_torch.models.lm import SpeechTextLM, quantize_for_serving

    cfg = Config(**SMALL_SPEECH)
    cpu = SpeechTextLM(cfg, dtype=torch.bfloat16, generator=torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    grid = np.concatenate([rng.integers(0, cfg.padded_vocab_size, (2, 1, n_frames)),
                           rng.integers(0, cfg.audio_card - 2, (2, cfg.n_q, n_frames))], axis=1)
    none = dict.fromkeys(_counters(), 0)

    def mlp_weights_to_bf16(m):
        for mod in m.modules():
            if all(hasattr(mod, k) for k in ("fc_1", "fc_2", "proj")):
                for lin in (mod.fc_1, mod.fc_2, mod.proj):
                    lin.weight.data = lin.weight.data.to(torch.bfloat16).float()
        return m

    for label, kernel, int8 in (("bf16", "gating_ffn", False),
                                ("int8 --kv-int8", "gating_ffn_int8", True),
                                ("float32", "gating_ffn_f32_weights", False),
                                ("float32 control", "gating_ffn_f32_weights", False)):
        if int8:
            quantize_for_serving(cpu)
        if label == "float32":
            cpu = SpeechTextLM(cfg, dtype=torch.float32,
                               generator=torch.Generator().manual_seed(seed))
        control = label == "float32 control"
        runs = {}
        for device, m in (("cpu", cpu), ("cuda", copy.deepcopy(cpu).to("cuda"))):
            if control and device == "cuda":
                mlp_weights_to_bf16(m)
            reset_counts()
            with recorded_stream_logits() as record:
                r = teacher_forced_stream(m, grid, seed, kv_int8=int8)
            runs[device] = (r, record, read_counts())
        counts_c, counts_g = runs["cpu"][2], runs["cuda"][2]
        want = {**none, kernel: cfg.n_layer * n_frames}
        if counts_g != want or counts_c != none:
            raise AssertionError(f"small speech slice ({label}) launched {counts_g} on the card "
                                 f"(expected {want}) and {counts_c} on the CPU (expected none)")
        tol, ce_tol = ((SPEECH_F32_LOGIT_TOL, SPEECH_F32_CE_TOL) if label.startswith("float32")
                       else (SLICE_LOGIT_TOL, SPEECH_CE_TOL))
        r, within = _speech_slice_readings(runs, tol, ce_tol)
        log(f"small speech slice ({label}), card vs CPU over {n_frames} frames at B=2: logits max "
            f"abs err {r['logit_err']:.3e} (max |logit| {r['scale']:.3e}, limit {tol} of it), CE "
            f"text {r['ce'][0]:.7f} / {r['ce'][1]:.7f}, audio {r['ce'][2]:.7f} / "
            f"{r['ce'][3]:.7f} (max diff {r['ce_err']:.3e}, limit {ce_tol}), greedy tokens "
            f"differ at {r['greedy_diff']} of {r['tokens']} ({r['flips']} past the near-tie "
            f"margin); card {kernel} launches {counts_g[kernel]}"
            + ("; the card's MLP weights rounded to bf16, must fall outside" if control else ""))
        if control and within:
            raise AssertionError("the small speech slice's float32 limits do not catch MLP "
                                 "weights rounded to bf16")
        if not control and not within:
            raise AssertionError(f"the small speech slice ({label}) on the card disagrees with "
                                 "the CPU")


def build_flagship(seed: int, dtype=torch.bfloat16):
    """The flagship in ``dtype`` on the card from ``seed``, its
    codecformer's gating padded to a multiple of 128 so that K1 takes its
    micro-steps."""
    from rstnet_tpu_torch.models.config import Config
    from rstnet_tpu_torch.models.lm import SpeechTextLM
    from rstnet_tpu_torch.modules.transformer import pad_codecformer_gating
    from rstnet_tpu_torch.ops.cuda_depformer import depformer_kernel_operands

    t0 = time.perf_counter()
    model = SpeechTextLM(Config(**FLAGSHIP), device="cuda", dtype=dtype,
                         generator=torch.Generator(device="cuda").manual_seed(seed))
    pad_codecformer_gating(model.codecformer)
    if depformer_kernel_operands(model) is None:
        raise AssertionError("the flagship's codecformer is outside K1's envelope")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"flagship SpeechTextLM (Llama-3.2-1B backbone, codecformer 1024 x 6), "
        f"{n_params / 1e9:.3f} B params, {str(dtype)[6:]}, built in "
        f"{time.perf_counter() - t0:.1f} s")
    return model


def run_speech_slice(model, seed: int, n_frames: int, card: str, path: str, expected: dict,
                     kv_int8: bool = False) -> dict:
    """``LMGen.step`` at B=1 over the flagship (bf16 ring, or int8 with
    ``kv_int8``), the bench's delays, sampling from a seeded generator: two
    warm-up frames, then ``n_frames`` counted and timed frames, then 4 frames
    under ``torch.profiler`` (device busy time and its largest kernels)."""
    from rstnet_tpu_torch.inference.generate import LMGen
    from rstnet_tpu_torch.tools.profile_frame import device_profile

    cfg = model.config
    gen = LMGen(model, delays=(0,) + (1,) * cfg.n_q, kv_unstacked=True, kv_int8=kv_int8)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = gen.init_state(1, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(seed)
    for _ in range(2):
        gen.step(state, g)
    torch.cuda.synchronize()
    reset_counts()
    times, valid = [], 0
    for t in range(n_frames):
        t0 = time.perf_counter()
        out, ok, state = gen.step(state, g)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1000)
        out = out.cpu()
        valid += int(ok.all())
        if not (0 <= out[:, 0].min() and out[:, 0].max() < cfg.padded_vocab_size
                and 0 <= out[:, 1:].min() and out[:, 1:].max() < cfg.audio_card):
            raise AssertionError(f"{path} frame {t}: tokens out of range: {out[0, :, 0].tolist()}")
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"{path}: {n_frames} frames, {valid} valid; launches {counts}")
    if valid != n_frames:
        raise AssertionError(f"{path}: {valid} valid frames after the warm-up, expected {n_frames}")
    if counts != expected:
        raise AssertionError(f"{path}: launches {counts}, expected {expected}")
    log(f"{path} frame time: {_percentiles(times)} over {n_frames} frames (host clock, "
        f"informational); peak memory {peak:.2f} GiB [{card}]")
    prof = device_profile(lambda _: gen.step(state, g), range(4))
    top = ", ".join(f"{name[:48]} {ms / 4:.3f}" for name, ms in prof["by_kernel_ms"][:6])
    log(f"{path} profiler over 4 frames: device busy {prof['device_ms'] / 4:.3f} ms a frame, "
        f"{100 * prof['busy_share']:.1f} % of the wall ({prof['wall_ms'] / 4:.3f} ms a frame "
        f"profiled), {prof['launches_per_frame']:.0f} device events a frame; largest (ms a "
        f"frame): {top} [{card}]")
    return counts


def build_mimi(seed: int):
    """Mimi 24 kHz (f32) on the card from ``seed``, with seeded normal
    codebooks (the default init leaves them at zero, all ties)."""
    from rstnet_tpu_torch.models.mimi import mimi_24k

    g = torch.Generator(device="cuda").manual_seed(seed + 2)
    mimi = mimi_24k(device="cuda", generator=g)
    for rvq in (mimi.quantizer.rvq_first, mimi.quantizer.rvq_rest):
        rvq.layers.embedding_sum.normal_(generator=g)
    return mimi


def speech_tick_expected(model, n_ticks: int) -> dict:
    """A batched speech tick's launches: K4 once a backbone layer (N = the
    sessions), K2 once a codecformer layer and micro-step where its gating
    is on K2's route, K3 twice (Mimi's two quantizers)."""
    cfg, cf = model.config, model.codecformer
    hidden = cf.layers.gating.linear_in[0].shape[-2] // 2
    on_k2 = cf.weights_per_step and hidden % 128 == 0 and cf.d_model % 128 == 0
    k2 = cfg.dep_q * cf.num_layers if on_k2 else 0
    return {**dict.fromkeys(_counters(), 0), "gating_ffn": cfg.n_layer * n_ticks,
            "gating_ffn_step": k2 * n_ticks, "rvq_encode": 2 * n_ticks}


def run_speech_batched_tick(mimi, model, seed: int, sessions: int, n_ticks: int, card: str,
                            path: str) -> dict:
    """``SessionBatcher.step_once`` over Mimi 24 kHz and the flagship (bf16
    weights and state, an int8 ring: ``bench.py``'s sessions leg) with
    ``sessions`` sessions, each fed its own seeded signal: 3 warm-up ticks,
    then ``n_ticks`` counted and timed ticks, in which every K4 call must
    take N = ``sessions`` rows, then 2 more under ``torch.profiler`` (device
    busy, K4's device time a tick)."""
    from rstnet_tpu_torch.inference.generate import LMGen
    from rstnet_tpu_torch.models import backbone
    from rstnet_tpu_torch.serving.batcher import SessionBatcher

    cfg = model.config
    gen = LMGen(model, delays=(0,) + (1,) * cfg.n_q, kv_int8=True, kv_unstacked=True)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    batcher = SessionBatcher(mimi, gen, max_sessions=sessions, seed=seed, cuda_graphs=False)
    active = [batcher.acquire() for _ in range(sessions)]
    frame, warm = batcher.frame_size, 3
    signals = np.stack([_signal(seed + i, (warm + n_ticks + 2) * frame, 110.0 + 20.0 * i)
                        for i in range(sessions)]).reshape(sessions, -1, frame)

    def tick(t):
        for i, sess in enumerate(active):
            sess.inputs.put_nowait(signals[i, t])
        batcher.step_once()

    for t in range(warm):
        tick(t)
    torch.cuda.synchronize()
    for sess in active:
        while not sess.outputs.empty():
            sess.outputs.get_nowait()
    real, k4_rows = backbone.gating_ffn, []  # each K4 call's N, as the CPU test records it
    backbone.gating_ffn = lambda *a, **k: k4_rows.append(a[0].shape[0]) or real(*a, **k)
    try:
        reset_counts()
        times = []
        for t in range(warm, warm + n_ticks):
            t0 = time.perf_counter()
            tick(t)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1000)
        counts = read_counts()
    finally:
        backbone.gating_ffn = real
    peak = torch.cuda.max_memory_allocated() / 2**30
    for i, sess in enumerate(active):
        got = [sess.outputs.get_nowait() for _ in range(sess.outputs.qsize())]
        if len(got) != n_ticks:
            raise AssertionError(f"{path} session {i}: {len(got)} frames, expected {n_ticks}")
        for audio, tok in got:
            if audio.shape != (frame,) or not np.isfinite(audio).all():
                raise AssertionError(f"{path} session {i}: audio {audio.shape}, finite "
                                     f"{np.isfinite(audio).all()}")
            if not 0 <= tok < cfg.padded_vocab_size:
                raise AssertionError(f"{path} session {i}: text token {tok} outside "
                                     f"[0, {cfg.padded_vocab_size})")
    expected = speech_tick_expected(model, n_ticks)
    log(f"{path}: {n_ticks} ticks x {sessions} sessions; launches {counts}")
    if counts != expected:
        raise AssertionError(f"{path}: launches {counts}, expected {expected}")
    if k4_rows != [sessions] * expected["gating_ffn"]:
        raise AssertionError(f"{path}: K4 calls took rows {sorted(set(k4_rows))} "
                             f"({len(k4_rows)} calls), expected N={sessions} on each of "
                             f"{expected['gating_ffn']}")
    log(f"{path}: every one of the {len(k4_rows)} K4 calls took N={sessions} rows")
    log(f"{path} tick time: {_percentiles(times)} over {n_ticks} ticks (host clock, "
        f"informational); peak memory {peak:.2f} GiB [{card}]")
    busy, k4_ms = device_kernel_ms(lambda: [tick(t) for t in range(warm + n_ticks,
                                                                    warm + n_ticks + 2)],
                                   K4_KERNEL_NAMES)
    log(f"{path} profiler over 2 ticks: device busy {busy / 2:.3f} ms a tick, K4 {k4_ms / 2:.3f} "
        f"ms a tick ({cfg.n_layer} calls at N={sessions}) [{card}]")
    return counts


def check_graph_launches(g, card: str) -> dict:
    """Each serving kernel at a main path's shape, its device time launched
    eagerly and as a replay of a CUDA graph that holds one call (K1 and K3
    are cooperative launches, K2's and K4's passes programmatic dependent
    launches): a launch that the capture kept as it is costs no more in a
    replay, and a programmatic pair that became a full dependency would cost
    more. Each replay's outputs equal the eager call's, bit for bit.
    Returns {kernel: (eager ms, replay ms)}."""
    from rstnet_tpu_torch.ops.cuda_depformer import depformer_step
    from rstnet_tpu_torch.ops.cuda_ffn import gating_ffn, gating_ffn_step
    from rstnet_tpu_torch.ops.cuda_rvq import rvq_encode
    from rstnet_tpu_torch.serving.graphs import CapturedStep

    ops, xs, d = _k1_operands(g)
    kc = torch.zeros((d["L"], d["S"], d["C"]), device="cuda")
    k1 = [ops[k] for k in ("norm1", "in_proj", "out_proj", "norm2", "gin", "gout", "head_w",
                           "head_b")]

    def uni(*shape):
        return (torch.rand(shape, device="cuda", generator=g) * 2 - 1) * shape[-1] ** -0.5

    cases = {
        "depformer_step": (lambda x, *a: depformer_step(x, 3, *a, heads=16)[0],
                           (xs[3], *k1, kc, kc.clone())),
        "gating_ffn_step": (lambda x, a, b: gating_ffn_step(x, a, b, 5),
                            (torch.randn((16, 1024), device="cuda", generator=g).bfloat16(),
                             uni(8, 2 * 2816, 1024).bfloat16(), uni(8, 1024, 2816).bfloat16())),
        "rvq_encode": (rvq_encode, (torch.randn((1, 256), device="cuda", generator=g),
                                    torch.randn((7, 2048, 256), device="cuda", generator=g))),
        "gating_ffn": (gating_ffn, (torch.randn((1, 2048), device="cuda", generator=g).bfloat16(),
                                    uni(8192, 2048).bfloat16(), uni(8192, 2048).bfloat16(),
                                    uni(2048, 8192).bfloat16())),
    }
    times = {}
    for name, (fn, inputs) in cases.items():
        want = fn(*inputs)
        step = CapturedStep(lambda st, *ins, fn=fn: (fn(*ins), st), {}, inputs, name=name)
        step()
        got = step()
        for a, b in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            if not torch.equal(a, b):
                raise AssertionError(f"{name}: a graph replay differs from the eager call")
        times[name] = (time_ms(lambda: fn(*inputs), 30), time_ms(step, 30))
    log("kernels in a CUDA graph (one call a graph; device ms a call, eager / replay): "
        + ", ".join(f"{k} {e:.4f} / {r:.4f}" for k, (e, r) in times.items()) + f" [{card}]")
    return times


# -- the serving steps as CUDA graphs ------------------------------------------

# the device kernel that each call of a wrapper launches exactly once (a
# wrapper's other kernels launch once or not at all), as a pattern of its
# demangled name, by the launch counter the call also counts in: how the
# launches of a graph replay, which no wrapper sees, are counted from the
# profiler's device events. The weight type (the template argument W; int8
# is ``signed char``) tells K1 from K1-int8 and K4 from K5 and K4 over
# float32 weights; K4/K5's CUDA-core route (``core_down``, widths off the
# tensor-core grid) has an entry of its own, which no graph path expects,
# so a replay that leaves the tensor-core route fails its check.
CALL_KERNELS = {"depformer_step": r"dep_step_kernel<[^,>]+, __nv_bfloat16>",
                "depformer_step_int8": r"dep_step_kernel<[^,>]+, signed char>",
                "rvq_encode": r"rvq_(split|tiled)_kernel",
                "gating_ffn_step": r"down_mma|down_kernel",
                "gating_ffn": r"down_tc<__nv_bfloat16,",
                "gating_ffn_int8": r"down_tc<signed char,",
                "gating_ffn_f32_weights": r"down_tc<float,",
                "gating_ffn core_down route": r"core_down<"}


def replay_launches(fn) -> dict:
    """Each wrapper's kernel calls in one ``fn()``, counted by name from
    ``torch.profiler``'s device events."""
    from rstnet_tpu_torch.tools.profile_frame import device_events

    names = device_events(fn)
    return {k: sum(bool(re.search(pat, n)) for n in names) for k, pat in CALL_KERNELS.items()}


def graph_launches(host: dict, per_replay: dict, replays: int, captures: int = 1) -> dict:
    """A graph path's device launches by counter: the host counters
    (``host``) count each wrapper call of the step's eager warm-up call and
    of its ``captures`` captures, each of which records one replay's
    kernels into the graph and launches none; each of the ``replays``
    replays, which no wrapper sees, launches ``per_replay`` (counted by the
    profiler)."""
    return {k: n + (replays - captures) * per_replay.get(k, 0) for k, n in host.items()}


@contextlib.contextmanager
def no_host_sync():
    """Fail on any operation that waits for the device on the host (a
    ``.item()``, a pageable copy, a synchronize) inside the block."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(0)


def _check_replays(path: str, got: dict, want: dict) -> None:
    if any(got[k] != n for k, n in want.items()) or any(
            got[k] for k in got if k not in want):
        raise AssertionError(f"{path}: one replay launched {got}, expected {want}")


def _graph_record(path, times, eager_times, busy_ms, wall_ms, peak, capture_ms, replays,
                  card, n_replays, unit="frame") -> dict:
    """A graph path's readings; ``replays``: one replay's launches (the
    profiler's), ``n_replays``: the replays of the path's run."""
    ts, es = sorted(times), sorted(eager_times)

    def p(xs, q):
        return xs[min(len(xs) - 1, int(q * len(xs)))]

    rec = {"p50_ms": p(ts, 0.5), "p99_ms": p(ts, 0.99), "eager_p50_ms": p(es, 0.5),
           "eager_p99_ms": p(es, 0.99), "device_busy_ms": busy_ms,
           "busy_share": busy_ms / wall_ms if wall_ms else None, "peak_gib": peak,
           "capture_ms": capture_ms, "replay_launches": replays, "replays": n_replays}
    log(f"{path}: graph {_percentiles(times)}, eager {_percentiles(eager_times)} a {unit} "
        f"(host clock, {len(times)} {unit}s each); device busy {busy_ms:.3f} ms a {unit}, "
        f"{100 * (rec['busy_share'] or 0):.1f} % of the wall; capture {capture_ms:.1f} ms; "
        f"peak memory {peak:.2f} GiB; one replay launches {replays} [{card}]")
    return rec


def run_graph_solo(mimi, lm_gen, seed: int, n_frames: int, n_scans: int, card: str,
                   graphs: dict, names=("solo_frame_graph", "solo_scan_4"),
                   dep: str = "depformer_step") -> tuple[dict, dict]:
    """Paths ``names`` (frame, scan; by default ``solo_frame_graph`` and
    ``solo_scan_4``): a ``ServerState`` (greedy, ``scan_frames`` 4) whose
    frame and scan are CUDA graph replays, against an eager one on the same
    frames: ``n_frames`` single frames, then ``n_scans`` scans of 4, text
    tokens equal and audio within ``SLICE_AUDIO_TOL``. ``dep``: K1's
    counter (``depformer_step_int8`` over int8 weights). The graph state's
    first frames and scans (each step's warm-up call, its capture and its
    first replays) run under ``no_host_sync``. The host counters count the
    warm-up call and the capture, and are checked; one replay's launches
    are counted by the profiler. Returns the two paths' device launches
    (``graph_launches``) over their runs; ``graphs`` gets each path's
    readings."""
    from rstnet_tpu_torch.serving.server import ServerState

    greedy = dataclasses.replace(lm_gen, use_sampling=False)
    sf, fs, max_delay = 4, mimi.frame_size, lm_gen.max_delay
    pcm = _signal(seed + 7, (n_frames + sf * n_scans) * fs).reshape(-1, fs)
    frames, blocks = pcm[:n_frames], pcm[n_frames:].reshape(n_scans, sf * fs)

    def drive(state):
        toks, audio, frame_ms, scan_ms = [], [], [], []
        torch.cuda.synchronize()
        for x in frames:
            t0 = time.perf_counter()
            a, tok = state.handle_frame_array(x)
            torch.cuda.synchronize()  # a warmup frame reads nothing back
            frame_ms.append((time.perf_counter() - t0) * 1000)
            toks.append(tok)
            audio.append(a)
        for x in blocks:
            t0 = time.perf_counter()
            a, tk = state.handle_frames_array(x)
            torch.cuda.synchronize()
            scan_ms.append((time.perf_counter() - t0) * 1000)
            toks.extend(tk)
            audio.append(a)
        return toks, audio, frame_ms, scan_ms

    eager = ServerState(mimi, greedy, seed=seed, scan_frames=sf, cuda_graphs=False)
    eager.warmup()
    e_toks, e_audio, e_frame_ms, e_scan_ms = drive(eager)
    del eager
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    state = ServerState(mimi, greedy, seed=seed, scan_frames=sf)
    with no_host_sync():
        for _ in range(max_delay + 2):  # warm-up, capture + replay, replays
            state._run(np.zeros(fs, np.float32), 0)
    frame_counts = read_counts()
    reset_counts()
    with no_host_sync():  # past the delay warmup: every frame of a scan is valid
        for _ in range(3):
            state._run(np.zeros(sf * fs, np.float32), sf)
    scan_counts = read_counts()
    state.reset()
    g_toks, g_audio, frame_ms, scan_ms = drive(state)
    peak = torch.cuda.max_memory_allocated() / 2**30
    steps = state.graphs()
    fstep, sstep = steps["frame"], steps[f"scan_{sf}"]
    replays = {"frame": fstep.replays, "scan": sstep.replays}  # the paths' runs
    if g_toks != e_toks:
        raise AssertionError(f"graph tokens differ from eager: {g_toks} vs {e_toks}")
    err = max(float(np.abs(a - b).max()) for a, b in zip(g_audio, e_audio) if a is not None)
    if not err <= SLICE_AUDIO_TOL:
        raise AssertionError(f"graph audio differs from eager by {err}")
    fname, sname = names
    log(f"{fname}: {len(g_toks)} text tokens equal to the eager frames' and scans'; audio "
        f"max |graph - eager| {err:.3g}")
    none = dict.fromkeys(_counters(), 0)
    for counts, want, what in (
            (frame_counts, {**none, dep: 16, "rvq_encode": 4}, fname),
            (scan_counts, {**none, dep: 16 * sf, "rvq_encode": 4}, sname)):
        if counts != want:  # the warm-up call and the capture, not the replays
            raise AssertionError(f"{what}: host launches {counts}, expected {want}")
    frame_rep = replay_launches(lambda: state._run(frames[-1], 0))
    _check_replays(fname, frame_rep, {dep: 8, "rvq_encode": 2})
    scan_rep = replay_launches(lambda: state._run(blocks[-1], sf))
    _check_replays(sname, scan_rep, {dep: 8 * sf, "rvq_encode": 2})
    from rstnet_tpu_torch.tools.profile_frame import device_profile

    nf, ns = len(frames[:4]), len(blocks[:2])
    fprof = device_profile(state.handle_frame_array, frames[:nf])
    sprof = device_profile(state.handle_frames_array, blocks[:ns])
    graphs[fname] = _graph_record(
        fname, frame_ms, e_frame_ms, fprof["device_ms"] / nf,
        fprof["wall_ms"] / nf, peak, fstep.capture_ms, frame_rep, card, replays["frame"])
    graphs[sname] = _graph_record(
        sname, scan_ms, e_scan_ms, sprof["device_ms"] / ns, sprof["wall_ms"] / ns,
        peak, sstep.capture_ms, scan_rep, card, replays["scan"], unit="scan")
    graphs[sname]["amortized_ms_a_frame"] = graphs[sname]["p50_ms"] / sf
    log(f"{sname}: {graphs[sname]['p50_ms'] / sf:.2f} ms a frame amortized (p50 "
        f"scan / {sf}), against {graphs[fname]['p50_ms']:.2f} ms a graph frame "
        f"[{card}]")
    launches = (graph_launches(frame_counts, frame_rep, replays["frame"], fstep.captures),
                graph_launches(scan_counts, scan_rep, replays["scan"], sstep.captures))
    del state, steps, fstep, sstep
    return launches


def run_graph_batched(mimi, gen, seed: int, sessions: int, n_ticks: int, card: str, path: str,
                      per_tick: dict, graphs: dict) -> dict:
    """Path ``path``: ``SessionBatcher`` ticks as CUDA graph replays
    against eager ticks of another batcher over the same weights and
    signals, one batcher at a time: 3 silent ticks before the sessions join
    (the graph batcher's warm-up call, capture and first replay, under
    ``no_host_sync``), then ``n_ticks`` ticks of ``sessions`` sessions whose
    text tokens must be equal and audio within ``SLICE_AUDIO_TOL``.
    ``per_tick``: each wrapper's calls in one tick. The graph batcher's host
    counts (its warm-up call and capture) are checked; returns its device
    launches (``graph_launches``) over the path's run."""
    from rstnet_tpu_torch.serving.batcher import SessionBatcher

    gen = dataclasses.replace(gen, use_sampling=False)
    fs = mimi.frame_size
    signals = np.stack([_signal(seed + i, n_ticks * fs, 110.0 + 20.0 * i)
                        for i in range(sessions)]).reshape(sessions, n_ticks, fs)
    zero = np.zeros((sessions, 1, fs), np.float32)
    runs = {}
    for graphed in (False, True):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        b = SessionBatcher(mimi, gen, max_sessions=sessions, seed=seed, cuda_graphs=graphed)
        with no_host_sync() if graphed else contextlib.nullcontext():
            for _ in range(3):
                b._tick(zero)
        counts = read_counts()
        active = [b.acquire() for _ in range(sessions)]
        times = []
        for t in range(n_ticks):
            for i, sess in enumerate(active):
                sess.inputs.put_nowait(signals[i, t])
            t0 = time.perf_counter()
            b.step_once()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1000)
        got = [[sess.outputs.get_nowait() for _ in range(sess.outputs.qsize())]
               for sess in active]
        peak = torch.cuda.max_memory_allocated() / 2**30
        runs[graphed] = (got, times)
        if not graphed:
            del b
            continue
        n_replays = b._graph.replays  # the path's run
        rep = replay_launches(lambda: b._tick(zero))
        _check_replays(path, rep, {k: v for k, v in per_tick.items() if v})

        def ticks(_):
            for i, sess in enumerate(active):
                sess.inputs.put_nowait(signals[i, -1])
            b.step_once()

        from rstnet_tpu_torch.tools.profile_frame import device_profile

        prof = device_profile(ticks, range(2))
        want = {k: 2 * v for k, v in per_tick.items()}
        if counts != {**dict.fromkeys(_counters(), 0), **want}:
            raise AssertionError(f"{path}: host launches {counts}, expected {want} (the warm-up "
                                 f"call and the capture)")
        graphs[path] = _graph_record(path, times, runs[False][1],
                                     prof["device_ms"] / 2, prof["wall_ms"] / 2, peak,
                                     b._graph.capture_ms, rep, card, n_replays, unit="tick")
        launches = graph_launches(counts, rep, n_replays, b._graph.captures)
        del b
    (e_got, _), (g_got, _) = runs[False], runs[True]
    err = 0.0
    for i, (e, g) in enumerate(zip(e_got, g_got)):
        if len(e) != len(g) or not e or [t for _, t in e] != [t for _, t in g]:
            raise AssertionError(f"{path} session {i}: graph tokens {[t for _, t in g]} vs "
                                 f"eager {[t for _, t in e]}")
        err = max(err, max(float(np.abs(a - c).max()) for (a, _), (c, _) in zip(e, g)))
    if not err <= SLICE_AUDIO_TOL:
        raise AssertionError(f"{path}: graph audio differs from eager by {err}")
    log(f"{path}: {sessions} sessions x {len(g_got[0])} frames, text tokens equal to the eager "
        f"ticks'; audio max |graph - eager| {err:.3g}")
    return launches


def run_speech_graph(model, seed: int, n_frames: int, card: str, graphs: dict) -> dict:
    """Path ``speech_frame_graph``: the flagship's ``LMGen.step`` at B=1
    (bf16, greedy) captured as a CUDA graph (``CapturedStep``) and replayed,
    against the eager step on the same state: 2 warm-up frames and
    ``n_frames`` more, tokens equal. The graph's warm-up call, capture and
    first two replays run under ``no_host_sync``. The host counts (the
    warm-up call and the capture) are checked; returns the device launches
    (``graph_launches``) over the path's run."""
    from rstnet_tpu_torch.inference.generate import LMGen
    from rstnet_tpu_torch.serving.graphs import CapturedStep
    from rstnet_tpu_torch.tools.profile_frame import device_profile

    gen = LMGen(model, delays=(0,) + (1,) * model.config.n_q, use_sampling=False,
                kv_unstacked=True)
    total = 2 + n_frames
    state = gen.init_state(1, device="cuda")
    e_toks, e_ms = [], []
    for t in range(total):
        t0 = time.perf_counter()
        out, _, state = gen.step(state, None)
        e_toks.append(out.cpu())
        if t >= 2:
            e_ms.append((time.perf_counter() - t0) * 1000)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()

    def frame(st):
        out, valid, st = gen.step(st, None)
        return (out, valid), st

    step = CapturedStep(frame, gen.init_state(1, device="cuda"), name="speech frame")
    outs = []
    with no_host_sync():
        for _ in range(4):  # warm-up, capture + replay, 2 replays
            outs.append(step()[0].clone())
    counts = read_counts()
    g_toks = [o.cpu() for o in outs]
    ms = []
    for _ in range(total - 4):
        t0 = time.perf_counter()
        g_toks.append(step()[0].cpu())
        ms.append((time.perf_counter() - t0) * 1000)
    peak = torch.cuda.max_memory_allocated() / 2**30
    n_replays = step.replays  # the path's run
    for t, (e, g) in enumerate(zip(e_toks, g_toks)):
        if not torch.equal(e, g):
            raise AssertionError(f"speech_frame_graph frame {t}: graph {g[0, :, 0].tolist()} vs "
                                 f"eager {e[0, :, 0].tolist()}")
    log(f"speech_frame_graph: {total} frames, tokens equal to the eager step's")
    L = model.config.n_layer
    want = {**dict.fromkeys(_counters(), 0), "gating_ffn": 2 * L, "depformer_step": 16}
    if counts != want:
        raise AssertionError(f"speech_frame_graph: host launches {counts}, expected {want}")
    rep = replay_launches(step)
    _check_replays("speech_frame_graph", rep, {"gating_ffn": L, "depformer_step": 8})
    prof = device_profile(lambda _: step()[0].cpu(), range(4))
    graphs["speech_frame_graph"] = _graph_record(
        "speech_frame_graph", ms, e_ms[-len(ms):], prof["device_ms"] / 4,
        prof["wall_ms"] / 4, peak, step.capture_ms, rep, card, n_replays)
    return graph_launches(counts, rep, n_replays, step.captures)


def run_cli_chain(root: Path, data: str, exp: Path, n_layer: int, card: str,
                  path: str = "speech_cli", kernel: str = "gating_ffn",
                  mimi_checkpoint: Path | None = None) -> dict:
    """``lm_eval`` and ``infer_cli`` (``--device cuda``) on a training
    slice's experiment, in the checkpoint's dtype: finite CE and perplexity,
    two generated grids of 1 + n_q rows, and ``kernel`` (K4 over the
    checkpoint's weights, by its counter's name) once a layer in every
    backbone step (counted from the run) with no other launch. With
    ``mimi_checkpoint``, ``infer_cli --mimi_checkpoint`` must also write a
    wav of finite samples beside each grid (decoding launches no kernel of
    ours). Logs each CLI's wall time, the rows N of the K4 calls, and the
    peak memory."""
    from rstnet_tpu_torch.evalsuite import lm_eval
    from rstnet_tpu_torch.inference import infer_cli
    from rstnet_tpu_torch.models import backbone
    from rstnet_tpu_torch.models.lm import SpeechTextLM

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    steps, k4_rows = [], []
    real, real_ffn = SpeechTextLM.step_global, backbone.gating_ffn

    def counted(self, *args, **kwargs):
        steps.append(1)
        return real(self, *args, **kwargs)

    SpeechTextLM.step_global = counted
    backbone.gating_ffn = lambda *a, **k: k4_rows.append(a[0].shape[0]) or real_ffn(*a, **k)
    try:
        reset_counts()
        t0 = time.perf_counter()
        report = lm_eval.main(["--checkpoint_dir", str(exp), "--data_jsons", data,
                               "--device", "cuda"])
        t_eval = time.perf_counter() - t0
        written = infer_cli.main(["--exp_dir", str(exp), "--data_jsons", data, "--output_dir",
                                  str(root / "gen"), "--prefix_frames", "8", "--max_new_frames",
                                  "8", "--max_examples", "2", "--device", "cuda",
                                  *(["--mimi_checkpoint", str(mimi_checkpoint)]
                                    if mimi_checkpoint else [])])
        torch.cuda.synchronize()
        t_infer = time.perf_counter() - t0 - t_eval
        counts = read_counts()
    finally:
        SpeechTextLM.step_global = real
        backbone.gating_ffn = real_ffn
    peak = torch.cuda.max_memory_allocated() / 2**30
    grids = [np.load(p) for p in written]
    by_rows = {n: k4_rows.count(n) for n in sorted(set(k4_rows))}
    log(f"{path}: lm_eval {t_eval:.1f} s (loss audio {report['loss_audio']:.4f}, text "
        f"{report['loss_text']:.4f}, ppl audio {report['ppl_audio']:.3f}, text "
        f"{report['ppl_text']:.3f} over {report['n_batches']} batches); infer_cli {t_infer:.1f} s, "
        f"{len(written)} grids {[g.shape for g in grids]}, {len(steps)} backbone steps, K4 "
        f"calls by rows N {by_rows}; launches {counts}; peak memory {peak:.2f} GiB (wall "
        f"times on the host clock) [{card}]")
    if not all(math.isfinite(report[k]) for k in ("loss_audio", "loss_text", "ppl_audio",
                                                  "ppl_text")) or report["n_batches"] < 1:
        raise AssertionError(f"lm_eval report {report}")
    if len(grids) != 2 or any(g.ndim != 2 or g.shape[0] != 9 for g in grids):
        raise AssertionError(f"infer_cli wrote {[g.shape for g in grids]}, expected two grids of "
                             "9 rows")
    if mimi_checkpoint:
        from rstnet_tpu_torch.utils.audio import read_wav

        wavs = [read_wav(str(p.with_suffix(".wav"))) for p in written]
        if any(sr != 24000 or w.shape != (1, g.shape[1] * 1920) or not np.isfinite(w).all()
               for (w, sr), g in zip(wavs, grids)):
            raise AssertionError(f"infer_cli --mimi_checkpoint wrote {[w.shape for w, _ in wavs]}")
        log(f"{path}: infer_cli --mimi_checkpoint wrote {len(wavs)} wavs of "
            f"{[w.shape[1] / 24000 for w, _ in wavs]} s")
    want = {**dict.fromkeys(_counters(), 0), kernel: n_layer * len(steps)}
    if not steps or counts != want:
        raise AssertionError(f"{path} launches {counts}, expected {want}")
    return counts


def _visible_pairs(T: int, window: int) -> int:
    """(query, key) pairs that a causal mask with this window leaves."""
    return sum(min(i + 1, window) for i in range(T))


def _k6_names(dtype, head_dim: int = 64) -> tuple[str, str]:
    """The kernels line's names of K6's forward and backward for a dtype
    and a head dim."""
    tag = ("_f32" if dtype == torch.float32 else "") + ("_d128" if head_dim == 128 else "")
    return f"flash_attention_fwd{tag}", f"flash_attention_bwd{tag}"


def _check_k6_route(q, k, v, do, context: int, scale: float, err: dict) -> None:
    """The differentiable route (pre-scale, the two kernels, K/V at their
    own head count) against autograd of the plain reference, O and
    dQ/dK/dV, the forward kernel's log-sum-exp against its plain version,
    each within the limits of q's dtype; and two backward calls bit for bit.
    Adds each kernel's max |kernel - plain| to ``err``."""
    from rstnet_tpu_torch.ops import cuda_flash as cf
    from rstnet_tpu_torch.ops.flash_attention import (
        attention_window,
        flash_attention,
        flash_attention_reference,
    )

    (B, H, T, D), dtype = q.shape, q.dtype
    window = attention_window(T, context)
    tol = K6_REL_TOL[dtype]
    fwd, bwd = _k6_names(dtype, D)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    got = flash_attention(*leaves, context, scale)
    got_grads = torch.autograd.grad(got, leaves, do)
    want = flash_attention_reference(*leaves, context, scale)
    want_grads = torch.autograd.grad(want, leaves, do)
    torch.cuda.synchronize()
    what = f"K6 B={B} H={H}/{k.shape[1]} D={D} context {context} {str(dtype).split('.')[-1]}"
    for name, a, b, kernel in (("o", got, want, fwd), ("dq", got_grads[0], want_grads[0], bwd),
                               ("dk", got_grads[1], want_grads[1], bwd),
                               ("dv", got_grads[2], want_grads[2], bwd)):
        whole, tile = cf.relative_error_by_tile(a, b)
        err[kernel] = max(err.get(kernel, 0.0), (a.float() - b.float()).abs().max().item())
        log(f"{what} {name}: ||kernel - plain|| / ||plain|| {whole:.3e}, worst 64-row tile "
            f"{tile:.3e} (limit {tol})")
        if not (whole <= tol and tile <= tol and torch.isfinite(a).all()):
            raise AssertionError(f"{what} {name} disagrees with the plain version")
    qs = (q * scale).to(dtype)
    o, lse = cf.flash_attention_fwd(qs, k, v, window)
    lse_err = (lse - cf.flash_attention_fwd_reference(qs, k, v, window)[1]).abs().max().item()
    log(f"{what} lse: max |kernel - plain| = {lse_err:.3e} (limit {K6_LSE_TOL[dtype]})")
    if not lse_err <= K6_LSE_TOL[dtype]:
        raise AssertionError(f"{what} lse disagrees with the plain version")
    first = cf.flash_attention_bwd(qs, k, v, o, do, lse, window)
    second = cf.flash_attention_bwd(qs, k, v, o, do, lse, window)
    same = [torch.equal(a, b) for a, b in zip(first, second)]
    log(f"{what} backward twice: dq, dk, dv, delta bit-identical {same}")
    if not all(same):
        raise AssertionError(f"{what}: two backward calls differ")


def _time_k6(q, k, v, do, context: int, scale: float, card: str) -> dict:
    """Device times of the two kernels and their plain versions, and,
    causal only, of SDPA on the same pre-scaled inputs with K/V repeated to
    the query heads (its forward; its backward alone, through autograd of
    one forward; and both); bounds of the GQA function (K and V read and dK,
    dV written at their own head count; the backward counts the five
    products it needs, 10 D FLOPs a visible pair, whatever it recomputes).
    Float32 inputs count the products the kernels run: three bf16 products
    (hi.hi + hi.lo + lo.hi) a product, at the bf16 tensor-core rate."""
    import torch.nn.functional as F

    from rstnet_tpu_torch.ops import cuda_flash as cf
    from rstnet_tpu_torch.ops.flash_attention import attention_window

    (B, H, T, D), Hkv, dtype = q.shape, k.shape[1], q.dtype
    window = attention_window(T, context)
    qs = (q * scale).to(dtype)
    o, lse = cf.flash_attention_fwd(qs, k, v, window)
    pairs = B * H * _visible_pairs(T, window)
    # bytes of one [B, H, T, D] / [B, Hkv, T, D] tensor, of one [B, H, T] f32 row vector
    size = q.element_size()
    row, kv, rows = B * H * T * D * size, B * Hkv * T * D * size, B * H * T * 4
    kind = "f32" if dtype == torch.float32 else "bf16"
    products = 3 if dtype == torch.float32 else 1
    fwd, bwd = _k6_names(dtype, D)
    runs = {
        fwd: (  # q, k, v -> o, lse
            lambda: cf.flash_attention_fwd(qs, k, v, window),
            lambda: cf.flash_attention_fwd_reference(qs, k, v, window),
            2 * row + 2 * kv + rows, 4 * D * pairs),
        bwd: (  # q, k, v, o, do, lse -> dq, dk, dv, delta
            lambda: cf.flash_attention_bwd(qs, k, v, o, do, lse, window),
            lambda: cf.flash_attention_bwd_reference(qs, k, v, o, do, lse, window),
            4 * row + 4 * kv + 2 * rows, 10 * D * pairs),
    }
    library = {}
    if window >= T:  # SDPA's causal route: the same pre-scaled inputs, K/V repeated
        kr, vr = (t.contiguous() for t in cf.repeat_kv(qs, k, v))
        library[fwd] = time_ms(functools.partial(
            F.scaled_dot_product_attention, qs, kr, vr, is_causal=True, scale=1.0), 20)
        leaves = [t.clone().requires_grad_() for t in (qs, kr, vr)]
        out = F.scaled_dot_product_attention(*leaves, is_causal=True, scale=1.0)
        library[bwd] = time_ms(
            lambda: torch.autograd.grad(out, leaves, do, retain_graph=True), 20)

        def sdpa_fwd_bwd():
            y = F.scaled_dot_product_attention(*leaves, is_causal=True, scale=1.0)
            torch.autograd.grad(y, leaves, do)

        library["fwd_bwd"] = time_ms(sdpa_fwd_bwd, 10)
        del out, leaves, kr, vr
    entries = {}
    for name, (kernel, plain, n_bytes, n_ops) in runs.items():
        ms = time_ms(kernel, 20)
        plain_ms = time_ms(plain, 5)
        bound_ms, bound_by = bound(n_bytes, products * n_ops, "bf16")
        lib = library.get(name)
        log(f"K6 {name} context {context} (B={B}, H={H} over {Hkv}, T={T}, D={D}, {kind}): kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
            f"SDPA {'none' if lib is None else f'{lib:.4f} ms'} [{card}]")
        entries[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                         "bound_by": bound_by, "library_ms": lib}
    total = entries[fwd]["ms"] + entries[bwd]["ms"]
    log(f"K6 B={B} H={H}/{Hkv} D={D} context {context} {kind} forward + backward: kernels "
        f"{total:.4f} ms, SDPA "
        + (f"{library['fwd_bwd']:.4f} ms" if library else "none (no windowed SDPA route)")
        + f" [{card}]")
    if library:
        entries[bwd]["sdpa_fwd_bwd_ms"] = library["fwd_bwd"]
    return entries


def check_k6(g, card: str) -> list[dict]:
    """K6 at the training shapes (Llama-3.2-1B: 32 heads over 8 KV heads,
    head dim 64, the T=1024 bucket), causal (context 3000 >= T) and local
    (context 256), at B=2 and at the main paths' B=4 (2 audio plus 2 text
    utterances a step), on bf16 and then on float32 inputs (the split-bf16
    route that float32 training runs): correctness of every kernel,
    determinism of the backward, and times. The kernels line carries the
    times of B=4 causal; the float32 entries add B=2's under ``B2``."""
    H, Hkv, T, D = 32, 8, 1024, 64
    scale = D**-0.5
    err: dict = {}
    entries = {}
    for B, dtype in ((2, torch.bfloat16), (4, torch.bfloat16), (2, torch.float32),
                     (4, torch.float32)):
        q, do = (torch.randn((B, H, T, D), device="cuda", generator=g).to(dtype)
                 for _ in range(2))
        k, v = (torch.randn((B, Hkv, T, D), device="cuda", generator=g).to(dtype)
                for _ in range(2))
        for context in (3000, 256):
            _check_k6_route(q, k, v, do, context, scale, err)
            if dtype == torch.bfloat16 or context >= T:
                times = _time_k6(q, k, v, do, context, scale, card)
                if context >= T and B == 4:
                    for name, t in times.items():
                        entries.setdefault(name, {}).update(t)
                elif context >= T and dtype == torch.float32:
                    for name, t in times.items():
                        entries.setdefault(name, {})["B2"] = t
        del q, k, v, do
        torch.cuda.empty_cache()
    check_k6_d128(g, card, err, entries)
    notes = {"flash_attention_fwd": "", "flash_attention_bwd": " (the splash VJP)",
             "flash_attention_fwd_f32": " (float32 only)",
             "flash_attention_bwd_f32": " (the splash VJP; float32 only)"}
    notes.update({f"{name}_d128": f"{note[:-1]}; head dim 128)" if note else " (head dim 128)"
                  for name, note in notes.items()})
    return [{"name": name, "route": "cuda", "source": "rstnet_tpu_torch/csrc/flash_attention.cu",
             "replaces": "rstnet_tpu/ops/flash_attention.py:46" + note,
             "max_abs_err": err[name], **entries[name]} for name, note in notes.items()]


# head dim 128 at B=4, T=1024: Qwen2.5-7B's 28 query heads over 4 KV heads
# (the flagship speech config, path train_qwen7b_peft) and Llama-3.1-8B's 32
# over 8 (the flagship-8B construction's backbone)
K6_D128_SHAPES = {"qwen7b": (28, 4), "llama8b": (32, 8)}


def check_k6_d128(g, card: str, err: dict, entries: dict) -> None:
    """K6 at head dim 128 (``K6_D128_SHAPES``), bf16 and float32, causal
    and local (context 256): each held to its plain version within the
    D = 64 limits, two backward calls bit for bit, and timed (causal; bf16
    also local at Qwen's shape). The kernels line carries Qwen's causal
    times, with Llama-8B's under ``llama8b``."""
    B, T, D = 4, 1024, 128
    scale = D**-0.5
    for dtype in (torch.bfloat16, torch.float32):
        for shape, (H, Hkv) in K6_D128_SHAPES.items():
            q, do = (torch.randn((B, H, T, D), device="cuda", generator=g).to(dtype)
                     for _ in range(2))
            k, v = (torch.randn((B, Hkv, T, D), device="cuda", generator=g).to(dtype)
                    for _ in range(2))
            for context in (3000, 256):
                _check_k6_route(q, k, v, do, context, scale, err)
                if context >= T or (dtype == torch.bfloat16 and shape == "qwen7b"):
                    times = _time_k6(q, k, v, do, context, scale, card)
                    if context >= T:
                        for name, t in times.items():
                            if shape == "qwen7b":
                                entries.setdefault(name, {}).update(t)
                            else:
                                entries.setdefault(name, {})[shape] = t
            del q, k, v, do
            torch.cuda.empty_cache()


def write_training_data(root, seed: int, long_frames: tuple[int, int], n_long: int,
                        short_frames: tuple[int, int], n_short: int,
                        text_frames: tuple[int, int], n_text: int, audio_card: int,
                        vocab: int, codebooks: int = 8) -> str:
    """Synthetic offline-tokenized ``audio_only`` and ``text_only`` manifests
    from ``seed`` (numpy .npz shards), ``codebooks`` audio rows; returns
    the manifests' glob."""
    rng = np.random.default_rng(seed)
    lengths = list(rng.integers(*long_frames, n_long, endpoint=True)) + list(
        rng.integers(*short_frames, n_short, endpoint=True))
    audio = {f"a{i}": rng.integers(0, audio_card, (codebooks, n)).astype(np.int16)
             for i, n in enumerate(lengths)}
    text = {f"t{i}": rng.integers(0, vocab, (int(n),)).astype(np.int32)
            for i, n in enumerate(rng.integers(*text_frames, n_text, endpoint=True))}
    np.savez(root / "audio.npz", **audio)
    np.savez(root / "text.npz", **text)
    for name, task, key, shard in (("a.json", "audio_only", "audio_seq", "audio.npz"),
                                   ("t.json", "text_only", "text_seq", "text.npz")):
        (root / name).write_text(json.dumps({"task": task, "keys": {key: str(root / shard)}}))
    return str(root / "*.json")


def expected_k6(steps: list, n_layer: int, dtype=torch.bfloat16, head_dim: int = 64) -> dict:
    """K6 launches of a training run under the trainer's default remat: on
    each step whose bucket length qualifies, the forward twice per layer
    (the backward recomputes each block) and the backward once."""
    from rstnet_tpu_torch.ops.flash_attention import flash_qualifies

    n = sum(flash_qualifies(s["seq_len"], None, None, True) for s in steps)
    fwd, bwd = _k6_names(dtype, head_dim)
    return {fwd: 2 * n_layer * n, bwd: n_layer * n}


SMALL_LM = dict(name="smoke-small", block_size=1024, vocab_size=512, padded_vocab_size=512,
                n_layer=2, n_head=2, n_embd=128, n_query_groups=1, rotary_percentage=1.0,
                parallel_residual=False, bias=False, norm_class_name="RMSNorm",
                mlp_class_name="LLaMAMLP", intermediate_size=256, rope_base=500000,
                rope_adjustments=[8.0, 1.0, 4.0, 256], context=256)


# the same at head dim 128 (2 heads of 128): K6's float32 kernels at D=128
SMALL_LM_D128 = dict(SMALL_LM, name="smoke-small-d128", n_embd=256, intermediate_size=512)


def check_small_training_slice(seed: int, lm: dict = SMALL_LM) -> dict:
    """A small SpeechTextLM (``lm``: 2 layers, a 256 window; head dim 64,
    or 128 for ``SMALL_LM_D128``) trained in float32 by the trainer on the
    card and on the CPU: one epoch, then a resumed second; bucket 512
    (``--max_length 511``) and smaller ones. Returns the card run's
    launches (the float32 kernels of K6 at the head dim)."""
    import tempfile

    from rstnet_tpu_torch.models.config import write_flat_yaml
    from rstnet_tpu_torch.training import trainer

    root = Path(tempfile.mkdtemp(prefix="smoke_small_train_"))
    try:
        write_flat_yaml(root / "model.yaml", lm)
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
        want = expected_k6(steps_g, lm["n_layer"], torch.float32, lm["n_embd"] // lm["n_head"])
        lengths = sorted({s["seq_len"] for s in steps_g})
        if not any(n % 512 == 0 for n in lengths) or all(n % 512 == 0 for n in lengths):
            raise AssertionError(f"small training slice buckets {lengths}: need both a 512 "
                                 "bucket and another")
        got = {k: counts_g[k] for k in want}
        if got != want or any(counts_c[k] for k in want) or any(
                v for k, v in counts_g.items() if k not in want):
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
        log(f"small training slice (head dim {lm['n_embd'] // lm['n_head']}, 2 epochs, 2nd "
            f"resumed), card vs CPU over {len(steps_g)} "
            f"steps, buckets {lengths}: losses max rel err {worst['loss']:.3e} (limit "
            f"{TRAIN_LOSS_RTOL}), accuracies max abs err {worst['acc']:.3e} (limit "
            f"{TRAIN_ACC_ATOL}); card K6 launches {got}, CPU none; losses "
            + ", ".join(f"{s['loss']:.4f}" for s in steps_g))
        if worst["loss"] > TRAIN_LOSS_RTOL or worst["acc"] > TRAIN_ACC_ATOL:
            raise AssertionError("the small training slice on the card disagrees with the CPU")
        return counts_g
    finally:
        shutil.rmtree(root, ignore_errors=True)


def write_full_training_data(root: Path, seed: int, n_steps: int) -> str:
    """The full training slices' synthetic data: long utterances on the
    1024 bucket and short ones on bucket 487 (``n_steps`` steps under
    ``FULL_TRAIN_FLAGS``)."""
    return write_training_data(root, seed, (951, 1023), 2 * n_steps, (430, 470), 6,
                               (300, 600), 2 * n_steps, audio_card=2048, vocab=128000)


def full_train_args(data: str, exp: Path, dtype: str, n_steps: int, seed: int) -> list[str]:
    """``trainer.main``'s flags for the full training slices."""
    return ["--train_data_jsons", data, "--model_config", "configs/llama_1b_speech.yaml",
            "--exp_dir", str(exp), "--max_length", "1023", "--batch_scale", "2500", "--dtype",
            dtype, "--n_epoch", "1", "--minibatch_debug", str(n_steps), "--print_freq", "1",
            "--seed", str(seed), "--device", "cuda"]


def _check_disk(root: Path, need: int, what: str) -> None:
    free = shutil.disk_usage(root).free
    log(f"{what}: {free / 2**30:.1f} GiB free under {root}")
    if free < need:
        raise RuntimeError(f"{what}'s checkpoint needs {need / 2**30:.0f} GiB free under "
                           f"{root}, {free / 2**30:.1f} GiB are")


def run_full_training_slice(seed: int, n_steps: int, card: str,
                            mimi_checkpoint: Path | None = None) -> tuple[dict, dict, list]:
    """``trainer.main`` on ``configs/llama_1b_speech.yaml`` (bf16, full width
    and depth) for ``n_steps`` steps of synthetic data: long utterances on
    the 1024 bucket (K6) and one batch of short ones (bucket 487, the masked
    path); then the epoch checkpoint, and the inference CLIs on it
    (``run_cli_chain``). Returns the launches of the training path and of
    the CLI path, and the steps' records."""
    import tempfile

    from rstnet_tpu_torch.models.config import Config
    from rstnet_tpu_torch.training import trainer

    cfg = Config.from_file("configs/llama_1b_speech.yaml")
    root = Path(tempfile.mkdtemp(prefix="smoke_full_train_"))
    # params + AdamW moments, bf16, 2.01 B parameters: ~12 GB on disk
    _check_disk(root, 16 * 2**30, "the full training slice")
    try:
        data = write_full_training_data(root, seed, n_steps)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        out = trainer.main(full_train_args(data, root / "exp", "bfloat16", n_steps, seed))
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
        del out
        return counts, run_cli_chain(root, data, root / "exp", cfg.n_layer, card,
                                     mimi_checkpoint=mimi_checkpoint), steps
    finally:
        shutil.rmtree(root, ignore_errors=True)


# the float32 training slice: the first 1024-bucket step after this many
# whose profiler window kept its records is the profiled one (step 3, or 4
# if 3's window lost records), and K6's float32 kernels by name
F32_PROFILED_STEP = 3
K6_F32_KERNEL_NAMES = ("flash_fwd_f32", "flash_bwd_f32", "flash_split_f32", "flash_bwd_prep_f32")


def run_f32_training_slice(seed: int, n_steps: int, card: str,
                           bf16_steps: list) -> tuple[dict, dict]:
    """The full training slice again in float32 (``--dtype float32``): the
    same config, flags, seed and synthetic data as ``run_full_training_slice``,
    so that every step sees the bf16 run's batch (the trainer's batch order
    depends on how many batches ``--minibatch_debug`` keeps, so the run
    keeps the same count). K6's float32 kernels on every 1024-bucket step
    and no bf16 launch; each step's loss within ``F32_LOSS_RTOL`` of the
    bf16 run's at that step. One 1024-bucket step runs under
    ``torch.profiler`` (K6's device time and the device's busy time a step);
    step time p50 and frames/s over the other 1024-bucket steps after the
    first. float32 matmuls stay in full float32 (no TF32, as the
    environment phase set). Then the inference CLIs on the float32
    checkpoint (``run_cli_chain``, path ``speech_cli_f32``: K4 over float32
    weights in every backbone step). Returns the launches of the training
    path and of the CLI path."""
    import tempfile

    from rstnet_tpu_torch.models.config import Config
    from rstnet_tpu_torch.tools.profile_frame import NoDeviceEvents
    from rstnet_tpu_torch.training import trainer

    cfg = Config.from_file("configs/llama_1b_speech.yaml")
    root = Path(tempfile.mkdtemp(prefix="smoke_f32_train_"))
    # params + AdamW moments, float32, 2.01 B parameters: ~22.5 GiB on disk
    _check_disk(root, 26 * 2**30, "the float32 training slice")
    make_train_step = trainer.make_train_step
    profiled = {}

    def make_profiled_train_step(*args, **kwargs):
        step = make_train_step(*args, **kwargs)
        calls = [0]

        def train_step(state, batch):
            calls[0] += 1
            if (calls[0] <= F32_PROFILED_STEP or "busy_ms" in profiled
                    or batch["tokens"].shape[2] != 1024):
                return step(state, batch)
            # a step runs once: a window that lost records is not repeated,
            # the next 1024-bucket step is profiled instead
            box = {}
            try:
                profiled["busy_ms"], profiled["k6_ms"] = device_kernel_ms(
                    lambda: box.update(out=step(state, batch)), K6_F32_KERNEL_NAMES, once=True)
            except NoDeviceEvents:
                return box["out"]
            profiled["step"], profiled["seq_len"] = calls[0] - 1, batch["tokens"].shape[2]
            return box["out"]

        return train_step

    try:
        data = write_full_training_data(root, seed, n_steps)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        trainer.make_train_step = make_profiled_train_step
        t0 = time.perf_counter()
        out = trainer.main(full_train_args(data, root / "exp", "float32", n_steps, seed))
        wall = time.perf_counter() - t0
        counts = read_counts()
        steps = out["steps"]
        peak = torch.cuda.max_memory_allocated() / 2**30
        want = expected_k6(steps, cfg.n_layer, torch.float32)
        log(f"float32 training slice: {len(steps)} steps, buckets "
            f"{[(s['batch_size'], s['seq_len']) for s in steps]}, launches {counts}")
        if len(steps) != len(bf16_steps):
            raise AssertionError(f"{len(steps)} float32 steps, {len(bf16_steps)} bf16 ones")
        if {k: counts[k] for k in want} != want or any(
                v for k, v in counts.items() if k not in want):
            raise AssertionError(f"float32 training slice launches {counts}, expected {want}")
        if profiled.get("seq_len") != 1024:
            raise AssertionError(f"the profiled float32 step was not a 1024-bucket step: "
                                 f"{profiled}")
        worst = 0.0
        for i, (sb, sf) in enumerate(zip(bf16_steps, steps)):
            if (sb["seq_len"], sb["batch_size"]) != (sf["seq_len"], sf["batch_size"]):
                raise AssertionError(f"step {i}: the float32 run saw B={sf['batch_size']} "
                                     f"T={sf['seq_len']}, the bf16 run B={sb['batch_size']} "
                                     f"T={sb['seq_len']}")
            rel = {k: abs(sf[k] - sb[k]) / max(abs(sb[k]), 1e-6)
                   for k in ("loss", "loss_audio", "loss_text")}
            worst = max(worst, rel["loss"])
            log(f"  step {i}: B={sf['batch_size']} T={sf['seq_len']} float32 loss "
                f"{sf['loss']:.5f} (audio {sf['loss_audio']:.5f}, text {sf['loss_text']:.5f}), "
                f"bf16 {sb['loss']:.5f}; rel diff loss {rel['loss']:.2e}, audio "
                f"{rel['loss_audio']:.2e}, text {rel['loss_text']:.2e}; "
                f"{sf['step_time'] * 1e3:.1f} ms" + (" (profiled)" if i == profiled["step"]
                                                      else ""))
            if not all(math.isfinite(sf[k]) for k in ("loss", "loss_audio", "loss_text")):
                raise AssertionError(f"non-finite float32 loss at step {i}")
        if worst > F32_LOSS_RTOL:
            raise AssertionError(f"float32 losses {worst:.2e} from the bf16 run's (limit "
                                 f"{F32_LOSS_RTOL})")
        steady = [s for i, s in enumerate(steps)
                  if 0 < i != profiled["step"] and s["seq_len"] == 1024]
        p50 = statistics.median(s["step_time"] for s in steady) * 1e3
        frames = steady[0]["batch_size"] * 1024 / p50 * 1e3
        ckpt = Path(out["checkpoints"][-1]["path"])
        size = sum(f.stat().st_size for f in ckpt.rglob("*") if f.is_file())
        log(f"float32 training slice: losses max rel diff from bf16 {worst:.2e} (limit "
            f"{F32_LOSS_RTOL}); 1024-bucket step p50 {p50:.1f} ms over {len(steady)} steps "
            f"(host clock), {frames:.0f} frames/s (padded); profiled step: device busy "
            f"{profiled['busy_ms']:.1f} ms, K6 float32 {profiled['k6_ms']:.3f} ms "
            f"({100 * profiled['k6_ms'] / profiled['busy_ms']:.2f} % of busy, "
            f"{100 * profiled['k6_ms'] / p50:.2f} % of the p50 step); peak memory {peak:.1f} GiB; "
            f"{wall:.1f} s wall (init included), epoch checkpoint {size / 2**30:.2f} GiB saved in "
            f"{out['checkpoints'][-1]['seconds']:.1f} s [{card}]")
        del out
        return counts, run_cli_chain(root, data, root / "exp", cfg.n_layer, card,
                                     "speech_cli_f32", "gating_ffn_f32_weights")
    finally:
        trainer.make_train_step = make_train_step
        shutil.rmtree(root, ignore_errors=True)


# -- loading public checkpoints (the converter, the tokenizers) -----------------

# the Moshi 7B file in bf16 (15.4 GB) and the room it needs on the disk
MOSHI_FILE_BYTES = 16 * 2**30
# path mimi_tokenize: this many seeded clips of this many seconds
TOKENIZE_CLIPS, TOKENIZE_SECONDS = 4, 10.0
# path train_from_litgpt: steps, and step 0's loss against the loss of the
# same model assembled from the source weights on the same batch (the same
# kernels on the same inputs; a load that missed or moved one weight moves
# the loss by orders more)
LITGPT_STEPS = 3
LITGPT_LOSS_RTOL = 1e-6


def host_peak_gib() -> float:
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


@contextlib.contextmanager
def timed_calls(module, name: str, seconds: list):
    """Record the wall time of each ``module.name(...)`` call in ``seconds``."""
    real = getattr(module, name)

    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return real(*args, **kwargs)
        finally:
            seconds.append(time.perf_counter() - t0)

    setattr(module, name, wrapper)
    try:
        yield
    finally:
        setattr(module, name, real)


def check_upstream_equal(what: str, upstream: dict, sd) -> int:
    """Every tensor of a loaded model under its upstream name (``upstream``,
    ``tools/upstream_layout.py``) against the file's tensor widened as the
    loader widens it, bit for bit; returns the elements compared."""
    if set(upstream) != set(sd):
        raise AssertionError(f"{what}: names differ from the file's: "
                             f"{sorted(set(upstream) ^ set(sd))[:8]}")
    n = 0
    for name, t in upstream.items():
        want = sd[name].to(t.device)
        if t.dtype != want.dtype or t.shape != want.shape or not torch.equal(t, want):
            raise AssertionError(f"{what}: {name} is not the file's {sd.raw(name).dtype} tensor "
                                 "widened to float32")
        n += t.numel()
    return n


def write_mimi_file(root: Path, seed: int) -> Path:
    """Mimi 24 kHz from ``seed`` (``build_mimi``) as a float32 kyutai-layout
    ``.safetensors`` file."""
    from rstnet_tpu_torch.tools.upstream_layout import upstream_mimi, write_upstream

    mimi = build_mimi(seed)
    t0 = time.perf_counter()
    path = write_upstream(root / "mimi.safetensors", upstream_mimi(mimi))
    log(f"checkpoints: Mimi 24 kHz written to {path.name}, {path.stat().st_size / 2**20:.0f} MiB "
        f"float32, in {time.perf_counter() - t0:.1f} s")
    return path


def run_checkpoint_solo_frame(root: Path, mimi_file: Path, seed: int, n_frames: int, card: str,
                              graphs: dict) -> tuple[dict, dict]:
    """Paths ``checkpoint_solo_frame`` and ``checkpoint_scan_4``: Moshi 7B
    from ``seed`` (bf16) written as a kyutai-layout ``.safetensors`` file,
    then the server built from the two files, ``build_server(parse_args(
    ["--mimi-checkpoint", ..., "--lm-checkpoint", ...]))``: Mimi and Moshi
    loaded and converted (Moshi float32, as the JAX server serves a converted
    checkpoint), and K1 over the bf16 rounding of the float32 depformer.
    Every loaded parameter is held, under its upstream name, to the file's
    tensor widened to float32, bit for bit. Then ``n_frames`` graph frames
    and one 4-frame scan against an eager server on the same frames
    (``run_graph_solo``). Where the disk cannot hold the Moshi file, the
    Moshi leg converts the in-memory upstream dict through the same
    ``convert_moshi_lm`` and says so."""
    from rstnet_tpu_torch.models import convert
    from rstnet_tpu_torch.models.moshi_lm import moshi_7b
    from rstnet_tpu_torch.serving.server import build_server, parse_args
    from rstnet_tpu_torch.tools.upstream_layout import (
        upstream_mimi,
        upstream_moshi,
        write_upstream,
    )

    g = torch.Generator(device="cuda").manual_seed(seed + 3)
    src = moshi_7b(device="cuda", dtype=torch.bfloat16, generator=g)
    upstream = upstream_moshi(src)
    free = shutil.disk_usage(root).free
    on_disk = free >= MOSHI_FILE_BYTES
    t0 = time.perf_counter()
    if on_disk:
        moshi_file = write_upstream(root / "model.safetensors", upstream)
        size = moshi_file.stat().st_size
        log(f"checkpoint_solo_frame: Moshi 7B written to {moshi_file.name}, {size / 2**30:.2f} GiB "
            f"bf16, in {time.perf_counter() - t0:.1f} s ({free / 2**30:.0f} GiB were free)")
        upstream = None
    else:
        moshi_file = root / "in-memory-moshi"
        upstream = {k: v.cpu() for k, v in upstream.items()}
        log(f"checkpoint_solo_frame: {free / 2**30:.1f} GiB free under {root}, less than the "
            f"{MOSHI_FILE_BYTES / 2**30:.0f} GiB the Moshi file needs: the Moshi leg converts the "
            "in-memory upstream dict through convert_moshi_lm instead of a file")
    del src
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    real_load = convert.load_torch_state_dict

    def load(path):
        if Path(path) == moshi_file and not on_disk:
            return convert.StateDictFile(upstream)
        return real_load(path)

    mimi_s, moshi_s = [], []
    convert.load_torch_state_dict = load
    try:
        with timed_calls(convert, "load_mimi", mimi_s), \
                timed_calls(convert, "load_moshi_lm", moshi_s):
            t0 = time.perf_counter()
            state = build_server(parse_args(["--mimi-checkpoint", str(mimi_file),
                                             "--lm-checkpoint", str(moshi_file),
                                             "--seed", str(seed)]))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        lm = state.lm_gen.model
        if any(p.dtype != torch.float32 for p in lm.parameters()):
            raise AssertionError("the converted Moshi is not float32")
        t0 = time.perf_counter()
        n = check_upstream_equal("Moshi 7B", upstream_moshi(lm), load(moshi_file))
        n += check_upstream_equal("Mimi 24 kHz", upstream_mimi(state.mimi),
                                  real_load(mimi_file))
        check_s = time.perf_counter() - t0
    finally:
        convert.load_torch_state_dict = real_load
    log(f"checkpoint_solo_frame: build_server from the files in {wall:.1f} s wall (Mimi load + "
        f"convert {mimi_s[0]:.1f} s, Moshi {moshi_s[0]:.1f} s, the rest building the models and "
        f"the warm-up with its graph captures); peak memory {peak:.2f} GiB on the card, "
        f"{host_peak_gib():.1f} GiB host RSS (process peak so far); {n / 1e9:.3f} B loaded "
        f"parameters equal to the files' tensors widened to float32 (checked in "
        f"{check_s:.1f} s) [{card}]")
    mimi, lm_gen = state.mimi, state.lm_gen
    del state, upstream
    gc.collect()
    torch.cuda.empty_cache()
    if moshi_file.exists():
        moshi_file.unlink()
    out = run_graph_solo(mimi, lm_gen, seed, n_frames, 1, card, graphs,
                         names=("checkpoint_solo_frame", "checkpoint_scan_4"))
    rec = graphs["checkpoint_solo_frame"]
    rec.update(load_s={"mimi": mimi_s[0], "moshi": moshi_s[0], "build_server": wall},
               load_peak_gib=peak, weights="float32 (converted)", moshi_from_file=on_disk)
    log(f"checkpoint_solo_frame: graph frame p50 {rec['p50_ms']:.2f} ms, device busy "
        f"{rec['device_busy_ms']:.2f} ms a frame, over float32 converted weights [{card}]")
    return out


def run_mimi_tokenize(root: Path, mimi_file: Path, seed: int, card: str) -> dict:
    """Path ``mimi_tokenize``: ``offline_tokenization --mode audio`` over an
    scp of ``TOKENIZE_CLIPS`` seeded clips of ``TOKENIZE_SECONDS`` s through
    the Mimi file (K3's tiled path: 128 frames a clip after the bucket).
    The shard's codes must equal ``MimiModel.encode`` of the same loaded
    model called directly on the bucket-padded clips, and
    ``MimiTokenizer.detokenize`` of them must equal ``MimiModel.decode``."""
    from rstnet_tpu_torch.data.tokenizers.mimi_tokenizer import MimiTokenizer
    from rstnet_tpu_torch.tools import offline_tokenization
    from rstnet_tpu_torch.tools.scp_tools import write_scp
    from rstnet_tpu_torch.utils.audio import read_wav, write_wav

    n = int(TOKENIZE_SECONDS * 24000)
    entries = []
    for i in range(TOKENIZE_CLIPS):
        path = root / f"clip{i}.wav"
        write_wav(str(path), _signal(seed + 20 + i, n, 130.0 * (i + 1)), 24000)
        entries.append((f"clip{i}", str(path)))
    write_scp(str(root / "wav.scp"), entries)
    argv = ["--scp", str(root / "wav.scp"), "--output", str(root / "codes.npz"), "--mode",
            "audio", "--mimi-checkpoint", str(mimi_file), "--device", "cuda"]
    offline_tokenization.main([*argv[:3], str(root / "warm.npz"), *argv[4:]])  # warm-up
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    offline_tokenization.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    shard = np.load(root / "codes.npz")
    tok = MimiTokenizer(checkpoint_path=str(mimi_file), device="cuda")
    frames = math.ceil(n / tok.model.frame_size)
    with torch.no_grad():
        for utt, path in entries:
            wav, _ = read_wav(path)
            padded, _ = tok._bucket_pad(wav)
            want = tok.model.encode(torch.from_numpy(padded[None]).cuda())[0, :, :frames]
            codes = shard[utt]
            if codes.shape != (8, frames) or codes.dtype != np.int16 or not np.array_equal(
                    codes, want.cpu().numpy()):
                raise AssertionError(f"mimi_tokenize: {utt}'s codes {codes.shape} differ from "
                                     "MimiModel.encode")
            audio = tok.detokenize(codes)
            direct = tok.model.decode(torch.from_numpy(codes[None].astype(np.int64)).cuda())
            if not np.array_equal(audio, direct[0].cpu().numpy()) or not np.isfinite(audio).all():
                raise AssertionError(f"mimi_tokenize: detokenize of {utt} differs from "
                                     "MimiModel.decode")
    want = {**dict.fromkeys(_counters(), 0), "rvq_encode": 2 * TOKENIZE_CLIPS}
    log(f"mimi_tokenize: offline_tokenization --mode audio of {TOKENIZE_CLIPS} x "
        f"{TOKENIZE_SECONDS:.0f} s in {wall:.2f} s wall (Mimi load included), "
        f"{TOKENIZE_CLIPS * TOKENIZE_SECONDS / wall:.1f} s of audio a second; codes equal to "
        f"MimiModel.encode, detokenize equal to MimiModel.decode; launches {counts} [{card}]")
    if counts != want:
        raise AssertionError(f"mimi_tokenize launches {counts}, expected {want}")
    return counts


def run_train_from_litgpt(seed: int, card: str) -> dict:
    """Path ``train_from_litgpt``: a seeded Llama-3.2-1B backbone (the
    flagship config's, bf16) written as litgpt's ``lit_model.pth``, then
    ``trainer --checkpoint_path`` for ``LITGPT_STEPS`` bf16 steps at
    ``--max_length 1023``. The loaded backbone must equal the file's tensors
    (widened, then cast to bf16) bit for bit; K6 on every 1024-bucket step;
    finite losses; step 0's loss within ``LITGPT_LOSS_RTOL`` of the loss of
    the same model assembled from the source weights (the trainer's seeded
    codecformer and embeddings, the source backbone) on step 0's batch."""
    import tempfile

    from rstnet_tpu_torch.models import convert
    from rstnet_tpu_torch.models.backbone import Backbone
    from rstnet_tpu_torch.models.config import Config
    from rstnet_tpu_torch.tools.upstream_layout import upstream_backbone, write_upstream
    from rstnet_tpu_torch.training import trainer
    from rstnet_tpu_torch.training.train_step import make_loss_fn
    from rstnet_tpu_torch.utils.arguments import get_args

    cfg = Config.from_file("configs/llama_1b_speech.yaml")
    root = Path(tempfile.mkdtemp(prefix="smoke_litgpt_"))
    _check_disk(root, 16 * 2**30, "train_from_litgpt")  # the 2.5 GB file and a 12 GB checkpoint
    real_build, real_batch, real_load = trainer.build_model, trainer.device_batch, \
        convert.load_backbone
    try:
        g = torch.Generator(device="cuda").manual_seed(seed + 4)
        src = Backbone(cfg, device="cuda", dtype=torch.bfloat16, generator=g)
        t0 = time.perf_counter()
        lit = write_upstream(root / "lit_model.pth", upstream_backbone(src))
        log(f"train_from_litgpt: Llama-3.2-1B backbone written to {lit.name}, "
            f"{lit.stat().st_size / 2**30:.2f} GiB bf16, in {time.perf_counter() - t0:.1f} s")
        data = write_full_training_data(root, seed, LITGPT_STEPS)
        held, load_s = {}, []

        def build_model(*args, **kwargs):
            held["model"] = real_build(*args, **kwargs)
            return held["model"]

        def load_backbone(path, backbone, dtype=None):
            held["init"] = {k: v.clone() for k, v in held["model"].state_dict().items()
                            if not k.startswith("backbone.")}
            t0 = time.perf_counter()
            out = real_load(path, backbone, dtype)
            load_s.append(time.perf_counter() - t0)
            sd = convert.load_torch_state_dict(path)
            for name, t in upstream_backbone(backbone).items():
                if not torch.equal(t, sd[name].to(t.device, t.dtype)):
                    raise AssertionError(f"train_from_litgpt: {name} is not the file's tensor "
                                         "after the cast")
            return out

        def device_batch(b, device, *mesh_args):
            out = real_batch(b, device, *mesh_args)
            held.setdefault("batch", {k: v.clone() for k, v in out.items()})
            return out

        trainer.build_model, trainer.device_batch = build_model, device_batch
        convert.load_backbone = load_backbone
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        argv = [*full_train_args(data, root / "exp", "bfloat16", LITGPT_STEPS, seed),
                "--checkpoint_path", str(lit)]
        reset_counts()
        t0 = time.perf_counter()
        out = trainer.main(argv)
        wall = time.perf_counter() - t0
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        steps = out["steps"]
        want = expected_k6(steps, cfg.n_layer)
        log(f"train_from_litgpt: {len(steps)} steps, buckets "
            f"{[(s['batch_size'], s['seq_len']) for s in steps]}, launches {counts}")
        if len(steps) != LITGPT_STEPS or not all(math.isfinite(s["loss"]) for s in steps):
            raise AssertionError(f"train_from_litgpt steps {[s['loss'] for s in steps]}")
        if not any(s["seq_len"] == 1024 for s in steps):
            raise AssertionError("train_from_litgpt: no step on the 1024 bucket, K6 never ran")
        if {k: counts[k] for k in want} != want or any(
                v for k, v in counts.items() if k not in want):
            raise AssertionError(f"train_from_litgpt launches {counts}, expected {want}")
        model = held["model"]
        args = get_args(argv)
        with torch.no_grad():
            model.load_state_dict({**held["init"], **{f"backbone.{k}": v for k, v in
                                                      src.state_dict().items()}})
            loss = float(make_loss_fn(model, audio_ignore_id=args.acoustic_pad_token,
                                      text_ignore_id=args.text_pad_token)(held["batch"])[0])
        rel = abs(loss - steps[0]["loss"]) / abs(loss)
        for s in steps:
            log(f"  step: B={s['batch_size']} T={s['seq_len']} loss {s['loss']:.4f}, "
                f"{s['step_time'] * 1e3:.1f} ms (host clock)")
        log(f"train_from_litgpt: litgpt load + convert + cast {load_s[0]:.1f} s; step 0 loss "
            f"{steps[0]['loss']:.6f} against {loss:.6f} from the source weights (rel diff "
            f"{rel:.2e}, limit {LITGPT_LOSS_RTOL}); {wall:.1f} s wall (init, load and the epoch "
            f"checkpoint included); peak memory {peak:.1f} GiB [{card}]")
        if not rel <= LITGPT_LOSS_RTOL:
            raise AssertionError(f"train_from_litgpt: step 0 loss {steps[0]['loss']} against "
                                 f"{loss} from the source weights")
        return counts
    finally:
        trainer.build_model, trainer.device_batch = real_build, real_batch
        convert.load_backbone = real_load
        shutil.rmtree(root, ignore_errors=True)


# -- LM fine-tuning: the flagship Qwen2.5-7B over an int8 base, Moshi 7B LoRA ----

PEFT_STEPS = 3  # train steps of each fine-tuning path (and of its resumed epoch)
QWEN_CONFIG = "configs/qwen_7b_speech.yaml"
MOSHI_MAX_LENGTH = 511  # Moshi's buckets: up to 512 (its attention holds [B, H, T, T])


@contextlib.contextmanager
def held_model(module):
    """The model that ``module.build_model`` builds, while inside: the
    trainer's own construction, read after a run."""
    real, held = module.build_model, {}

    def build(*args, **kwargs):
        held["model"] = real(*args, **kwargs)
        return held["model"]

    module.build_model = build
    try:
        yield held
    finally:
        module.build_model = real


def _peft_readings(path: str, model, steps: list, peak: float, wall: float, card: str) -> dict:
    """Log a fine-tuning run's steps, step time, device and host peaks and
    the frozen and trainable bytes (``bytes_table``); returns the bytes."""
    from rstnet_tpu_torch.training.flagship8b import bytes_table

    params = dict(model.named_parameters())
    frozen = bytes_table({n: p for n, p in params.items() if not p.requires_grad})
    trainable = bytes_table({n: p for n, p in params.items() if p.requires_grad})
    for st in steps:
        log(f"  {path} step: epoch {st['epoch']} B={st['batch_size']} T={st['seq_len']} loss "
            f"{st['loss']:.4f} (audio {st['loss_audio']:.4f}, text {st['loss_text']:.4f}), "
            f"{st['step_time'] * 1e3:.1f} ms (host clock)")
    steady = [st["step_time"] for st in steps[1:]]
    log(f"{path}: {len(steps)} steps, steady step time "
        f"{statistics.median(steady) * 1e3 if steady else float('nan'):.1f} ms median (host "
        f"clock, after the first step), {wall:.1f} s wall (builds included), device peak "
        f"{peak:.2f} GiB, host peak RSS {host_peak_gib():.2f} GiB; frozen {frozen}, trainable "
        f"{trainable} [{card}]")
    return {"frozen": frozen, "trainable": trainable}


def qwen_peft_argv(data: str, exp: Path, dtype: str, epochs: int, seed: int) -> list[str]:
    """The trainer's flags of the Qwen2.5-7B fine-tuning paths: LoRA r 16 on
    q/k/v over an int8 frozen backbone, the T=1024 bucket, ``PEFT_STEPS``
    steps an epoch, weights drawn on the card."""
    return ["--train_data_jsons", data, "--model_config", QWEN_CONFIG, "--exp_dir", str(exp),
            "--lora_r", "16", "--lora_alpha", "32", "--base_int8", "true", "--max_length",
            "1023", "--batch_scale", "2500", "--dtype", dtype, "--n_epoch", str(epochs),
            "--minibatch_debug", str(PEFT_STEPS), "--print_freq", "1", "--seed", str(seed),
            "--device", "cuda", "--init_on_device", "true"]


def _check_peft_launches(path: str, steps: list, counts: dict, n_layer: int, dtype,
                         head_dim: int) -> None:
    """Finite losses, a step on the 1024 bucket, and exactly K6's expected
    launches (``expected_k6``) with no other counted kernel."""
    if not all(math.isfinite(st[k]) for st in steps for k in ("loss", "loss_audio",
                                                              "loss_text")):
        raise AssertionError(f"{path}: non-finite loss: {[st['loss'] for st in steps]}")
    if not any(st["seq_len"] == 1024 for st in steps):
        raise AssertionError(f"{path}: no step on the 1024 bucket, K6 never ran")
    want = expected_k6(steps, n_layer, dtype, head_dim)
    log(f"{path} launches {counts}, expected {want} (head dim {head_dim})")
    if {k: counts[k] for k in want} != want or any(v for k, v in counts.items() if k not in want):
        raise AssertionError(f"{path} launches {counts}, expected {want}")


def run_train_qwen7b_peft(seed: int, card: str) -> dict:
    """Path ``train_qwen7b_peft``: the trainer CLI on the flagship speech
    config (``configs/qwen_7b_speech.yaml``: Qwen2.5-7B at full width and
    depth, head dim 128 over 4 KV heads, a 152064 vocab) with LoRA r 16 on
    q/k/v, the backbone frozen in int8 (``--base_int8``), bf16, the T=1024
    bucket, ``PEFT_STEPS`` steps of an epoch and as many of a second epoch
    resumed from the first one's checkpoint. Weights are drawn on the card
    (``--init_on_device``). Finite losses; K6 at head dim 128 on every
    1024-bucket step (``expected_k6``) and no other counted kernel; the
    checkpoint holds the trainable parameters only (LoRA factors and the
    codecformer side, no int8 leaf)."""
    import tempfile

    from rstnet_tpu_torch.models.config import Config
    from rstnet_tpu_torch.models.lora import is_lora_path
    from rstnet_tpu_torch.training import trainer

    cfg = Config.from_file(QWEN_CONFIG)
    root = Path(tempfile.mkdtemp(prefix="smoke_qwen_peft_"))
    _check_disk(root, 8 * 2**30, "train_qwen7b_peft")  # two ~1 GB trainable-only checkpoints
    try:
        data = write_full_training_data(root, seed, PEFT_STEPS)

        def argv(epochs: int) -> list[str]:
            return qwen_peft_argv(data, root / "exp", "bfloat16", epochs, seed)

        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        with held_model(trainer) as held:
            first = trainer.main(argv(1))
        _peft_readings("train_qwen7b_peft", held.pop("model"), first["steps"],
                       torch.cuda.max_memory_allocated() / 2**30, time.perf_counter() - t0, card)
        ckpt = Path(first["checkpoints"][-1]["path"])
        saved = torch.load(ckpt / "state.pt", map_location="cpu", weights_only=True, mmap=True)
        names = set(saved["params"])
        if (not names or any(t.dtype == torch.int8 for t in saved["params"].values())
                or not any(is_lora_path(n) for n in names)
                or not all(is_lora_path(n) or n.split(".")[0] in trainer.SPEECH_LORA_TRAINABLE
                           for n in names)):
            raise AssertionError(f"train_qwen7b_peft checkpoint holds {len(names)} tensors, "
                                 "not the trainable parameters alone")
        size = sum(f.stat().st_size for f in ckpt.rglob("*") if f.is_file())
        del saved
        gc.collect()
        torch.cuda.empty_cache()
        second = trainer.main(argv(2))  # resumes from ep1's trainable-only checkpoint
        wall = time.perf_counter() - t0
        counts = read_counts()
        steps = first["steps"] + second["steps"]
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(f"train_qwen7b_peft: epoch checkpoint {size / 2**30:.3f} GiB ({len(names)} trainable "
            f"tensors), saved in {first['checkpoints'][-1]['seconds']:.1f} s; resumed into "
            f"epoch 2 for {len(second['steps'])} steps; device peak over both runs {peak:.2f} "
            f"GiB, {wall:.1f} s wall [{card}]")
        if (len(first["steps"]) != PEFT_STEPS or {st["epoch"] for st in second["steps"]} != {2}
                or not (root / "exp" / "ep2.checkpoint").is_dir()):
            raise AssertionError("train_qwen7b_peft did not train, save and resume")
        _check_peft_launches("train_qwen7b_peft", steps, counts, cfg.n_layer, torch.bfloat16,
                             cfg.head_size)
        return counts
    finally:
        shutil.rmtree(root, ignore_errors=True)


def run_train_qwen7b_peft_f32(seed: int, card: str) -> dict:
    """Path ``train_qwen7b_peft_f32``: ``train_qwen7b_peft``'s fine-tune
    (Qwen2.5-7B at full width and depth, LoRA r 16 on q/k/v over an int8
    frozen backbone, the T=1024 bucket, weights drawn on the card) in
    float32 (``--dtype float32``: K6's float32 kernels at head dim 128, 28
    query heads over 4 KV heads), ``PEFT_STEPS`` steps of one epoch (the
    bf16 path proves the resume). Finite losses; K6 on every 1024-bucket
    step (``expected_k6``) and no other counted kernel."""
    import tempfile

    from rstnet_tpu_torch.models.config import Config
    from rstnet_tpu_torch.training import trainer

    cfg = Config.from_file(QWEN_CONFIG)
    root = Path(tempfile.mkdtemp(prefix="smoke_qwen_peft_f32_"))
    _check_disk(root, 8 * 2**30, "train_qwen7b_peft_f32")  # a ~2 GB trainable-only checkpoint
    try:
        data = write_full_training_data(root, seed, PEFT_STEPS)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        with held_model(trainer) as held:
            run = trainer.main(qwen_peft_argv(data, root / "exp", "float32", 1, seed))
        counts = read_counts()
        _peft_readings("train_qwen7b_peft_f32", held.pop("model"), run["steps"],
                       torch.cuda.max_memory_allocated() / 2**30, time.perf_counter() - t0, card)
        if len(run["steps"]) != PEFT_STEPS:
            raise AssertionError(f"train_qwen7b_peft_f32 ran {len(run['steps'])} steps, "
                                 f"not {PEFT_STEPS}")
        _check_peft_launches("train_qwen7b_peft_f32", run["steps"], counts, cfg.n_layer,
                             torch.float32, cfg.head_size)
        return counts
    finally:
        shutil.rmtree(root, ignore_errors=True)


def run_train_moshi7b_lora(seed: int, card: str) -> dict:
    """Path ``train_moshi7b_lora``: the trainer CLI with ``--model_family
    moshi`` at Moshi 7B's widths (dim 4096 x 32 layers, 32 heads, 16 audio
    codebooks, dep_q 8, card 2048, depformer 1024 x 6 with a 4224 FFN), LoRA
    r 16 on the temporal transformer (its base frozen, the depformer side
    trained whole), bf16, ``PEFT_STEPS`` steps on buckets up to 512, weights
    drawn on the card. Finite losses; no counted kernel (the Moshi forward
    takes the masked attention, as in JAX)."""
    import tempfile

    from rstnet_tpu_torch.training import trainer

    root = Path(tempfile.mkdtemp(prefix="smoke_moshi_lora_"))
    _check_disk(root, 24 * 2**30, "train_moshi7b_lora")  # a ~11 GB checkpoint
    try:
        data = write_training_data(root, seed, (400, 511), 2 * PEFT_STEPS, (200, 300), 4,
                                   (100, 300), 2 * PEFT_STEPS, audio_card=2048, vocab=32000,
                                   codebooks=16)
        argv = ["--model_family", "moshi", "--train_data_jsons", data, "--exp_dir",
                str(root / "exp"), "--moshi_dim", "4096", "--moshi_num_layers", "32",
                "--moshi_num_heads", "32", "--n_q", "16", "--dep_q", "8", "--audio_card", "2048",
                "--parallel_number", "17", "--codecformer_dim", "1024", "--codecformer_heads",
                "16", "--codecformer_layers", "6", "--codecformer_dim_feedforward", "4224",
                "--lora_r", "16", "--lora_alpha", "32", "--dtype", "bfloat16", "--max_length",
                str(MOSHI_MAX_LENGTH), "--batch_scale", "1024", "--n_epoch", "1",
                "--minibatch_debug", str(PEFT_STEPS), "--print_freq", "1", "--seed", str(seed),
                "--device", "cuda", "--init_on_device", "true"]
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        with held_model(trainer) as held:
            out = trainer.main(argv)
        wall = time.perf_counter() - t0
        counts = read_counts()
        steps = out["steps"]
        _peft_readings("train_moshi7b_lora", held.pop("model"), steps,
                       torch.cuda.max_memory_allocated() / 2**30, wall, card)
        if len(steps) != PEFT_STEPS or not all(
                math.isfinite(st[k]) for st in steps for k in ("loss", "loss_audio", "loss_text")):
            raise AssertionError(f"train_moshi7b_lora steps {[st['loss'] for st in steps]}")
        if any(counts.values()):
            raise AssertionError(f"train_moshi7b_lora launched {counts}: the Moshi training "
                                 "forward runs no counted kernel")
        return counts
    finally:
        shutil.rmtree(root, ignore_errors=True)


# phase moe_small: logits against the CPU to this fraction of their scale, and
# the gradients of the layer-0 router and experts to this fraction of each
# leaf's largest magnitude (float32 on both sides, matmuls in full float32:
# sums in another order)
MOE_LOGIT_TOL = 1e-4
MOE_GRAD_TOL = 1e-3


def check_moe_small(seed: int, card: str) -> dict:
    """Phase ``moe_small``: a Mixtral-8x7B-width backbone (dim 4096, 32 heads
    over 8, 8 experts of 14336, top 2), cut to 2 layers (the full model does
    not fit one card in bf16), float32, drawn on the card; a forward and a
    backward on 2 x 16 tokens against the same weights on the CPU."""
    import copy

    from rstnet_tpu_torch.models.backbone import Backbone
    from rstnet_tpu_torch.models.config import Config

    cfg = Config.from_name("Mixtral-8x7B-v0.1", n_layer=2)
    g = torch.Generator(device="cuda").manual_seed(seed + 14)
    reset_counts()
    t0 = time.perf_counter()
    model = Backbone(cfg, device="cuda", dtype=torch.float32, generator=g)
    cpu = copy.deepcopy(model).cpu()
    tokens = torch.from_numpy(np.random.default_rng(seed).integers(0, cfg.vocab_size, (2, 16)))
    outs = {}
    for name, m in (("cuda", model), ("cpu", cpu)):
        for p in m.parameters():
            p.requires_grad_(True)
        logits = m.forward_tokens(tokens.to(next(m.parameters()).device))
        torch.tanh(logits.float()).sum().backward()
        blk = m.blocks[0].mlp
        outs[name] = [t.detach().float().cpu() for t in (
            logits, blk.gate.weight.grad, blk.experts.fc_1.weight.grad,
            blk.experts.proj.weight.grad)]
    torch.cuda.synchronize()
    counts = read_counts()
    errs = []
    for i, (a, b) in enumerate(zip(outs["cuda"], outs["cpu"])):
        err = (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
        errs.append(err)
        if not (torch.isfinite(a).all() and err <= (MOE_LOGIT_TOL if i == 0 else MOE_GRAD_TOL)):
            raise AssertionError(f"moe_small output {i} disagrees with the CPU: {err:.3e}")
    n = sum(p.numel() for p in model.parameters())
    log(f"moe_small: Mixtral-8x7B width, 2 layers, {n / 1e9:.2f} B float32 params, forward + "
        f"backward on 2 x 16 tokens, card vs CPU: logits {errs[0]:.3e} of their scale (limit "
        f"{MOE_LOGIT_TOL}), router / expert fc_1 / expert proj gradients {errs[1]:.3e} / "
        f"{errs[2]:.3e} / {errs[3]:.3e} (limit {MOE_GRAD_TOL}); {time.perf_counter() - t0:.1f} "
        f"s [{card}]")
    if any(counts.values()):
        raise AssertionError(f"moe_small launched {counts}")
    del model, cpu, outs
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def compare_trees(trees: list[str], seed: int, out: str) -> int:
    """K4 over float32 weights (``check_k4_k5``'s ``gating_ffn_f32_weights``
    entry) in several checkouts of the port, one process each, in the order
    given and then reversed (A, B, B, A): each process runs this script with
    ``--k4-f32-out`` from the checkout's root, so it imports and builds that
    checkout's ``rstnet_tpu_torch``. Prints each case's times by turn and
    writes them as JSON to ``out``."""
    card = phase_environment()
    order = trees + trees[::-1]
    turns = []
    for i, tree in enumerate(order):
        root = Path(tree).resolve()
        dump = Path(out or "chiprun_out/trees.json").resolve().with_suffix(f".turn{i}.json")
        dump.parent.mkdir(parents=True, exist_ok=True)
        env = {**os.environ, "PYTHONPATH": os.pathsep.join(
            [str(root), *filter(None, [os.environ.get("PYTHONPATH")])])}
        subprocess.run([sys.executable, "-P", str(Path(__file__).resolve()), "--seed", str(seed),
                        "--k4-f32-out", str(dump)], cwd=root, env=env, check=True)
        turns.append(json.loads(dump.read_text()))
        dump.unlink()
    report = {"card": card, "order": order, "cases": {}}
    for N in map(str, K4_K5_ROWS):
        for prefix, x in (("f32_", "float32"), ("", "bfloat16")):
            rows = [t["by_rows"][N] for t in turns]
            case = {"kernel_ms": [r[prefix + "ms"] for r in rows],
                    "chain_ms": [r[prefix + "chain_ms"] for r in rows],
                    "chain_cast_ms": [r.get(prefix + "chain_cast_ms") for r in rows]}
            report["cases"][f"N={N} x {x}"] = case
            cast = case["chain_cast_ms"]
            log(f"K4 float32 weights N={N} x {x}: "
                + ", ".join(f"{t} {v:.4f}" for t, v in zip(order, case["kernel_ms"]))
                + " ms; chain " + " / ".join(f"{v:.4f}" for v in case["chain_ms"])
                + ("" if None in cast else ", with the cast " + " / ".join(f"{v:.4f}" for v in cast))
                + f" [{card}]")
    if out:
        Path(out).write_text(json.dumps(report, indent=1))
    return 0


def _codec_items(items: dict) -> dict:
    return {k: float(v) for k, v in items.items()}


def check_small_codec_training(seed: int, card: str) -> dict:
    """``CODEC_SMALL`` (Mimi's rates and losses at small widths, MFD over
    two scales) trained for 2 G/D steps through ``codec_trainer.make_steps``
    on the card and on the CPU from the same weights, batches (2 x 1 s of
    seeded pseudo-speech), seeded teacher features (so ``map_semantic`` and
    the distillation loss run) and draws (a CPU generator each, same seed):
    every loss item and the EMA buffers compared. Returns the card run's
    launches (K3: 2 a G step, D=16 over 26 rows, the split path)."""
    import copy

    from rstnet_tpu_torch.data.synth_speech import synth_corpus
    from rstnet_tpu_torch.training import codec_trainer as ct

    audio = torch.from_numpy(synth_corpus(seed, 4, seconds=1.0)).view(2, 2, 1, 24000)
    feats = torch.from_numpy(np.random.default_rng(seed).normal(
        size=(2, 2, 50, 32)).astype(np.float32))
    model, discs, loss_cfg = ct.build_from_config(CODEC_SMALL)
    runs = {}
    for device in ("cpu", "cuda"):
        g, d = copy.deepcopy(model).to(device), copy.deepcopy(discs).to(device)
        conf = CODEC_SMALL["optimizer"]["g"]["config"]
        g_tx, d_tx = ct.make_tx(conf, 0.999, 100), ct.make_tx(conf, 0.999, 100)
        g_step, d_step, evaluate = ct.make_steps(g, d, loss_cfg, g_tx, d_tx)
        state = {"opt_state": {"g": g_tx.init(dict(g.named_parameters())),
                               "d": d_tx.init(dict(d.named_parameters()))}}
        generator = torch.Generator().manual_seed(seed)
        reset_counts()
        steps, buffers = [], []
        for i in range(2):
            a = audio[i].to(device)
            rec, gi = g_step(state, a, feats[i].to(device), generator, use_adv=i > 0)
            buffers.append({n: b.to("cpu", copy=True) for n, b in g.named_buffers()})
            steps.append(_codec_items({**gi, **d_step(state, a, rec)}))
        evaluation = _codec_items(evaluate(audio[0].to(device)))
        runs[device] = (steps, buffers, read_counts(), evaluation)
    (steps_c, bufs_c, _, ev_c), (steps_g, bufs_g, counts_g, ev_g) = runs["cpu"], runs["cuda"]
    loss_err = max(abs(sg[k] - sc[k]) / max(abs(sc[k]), 1e-6)
                   for sc, sg in zip(steps_c, steps_g) for k in sc)
    loss_err = max(loss_err, max(abs(ev_g[k] - ev_c[k]) / max(abs(ev_c[k]), 1e-6) for k in ev_c))
    buf_err = [max((bg[n] - bc[n]).abs().max().item() / bc[n].abs().max().item() for n in bc)
               for bc, bg in zip(bufs_c, bufs_g)]
    none = dict.fromkeys(_counters(), 0)
    want = {**none, "rvq_encode": 2 * 2 + 2}  # 2 G steps and the evaluation
    log(f"small codec training (CODEC_SMALL, 2 G/D steps and an evaluation), card vs CPU: "
        f"loss items max rel err {loss_err:.3e} (limit {CODEC_LOSS_RTOL}), EMA buffers' max abs "
        f"err over the buffer's largest magnitude after each G step {buf_err[0]:.3e}, "
        f"{buf_err[1]:.3e} (limits {CODEC_BUFFER_RTOL}); distillation loss "
        f"{steps_g[0]['codec_loss']:.5f}, {steps_g[1]['codec_loss']:.5f}; card K3 launches "
        f"{counts_g['rvq_encode']} [{card}]")
    if any(not math.isfinite(v) for st in steps_g for v in st.values()):
        raise AssertionError("small codec training: a non-finite loss on the card")
    if steps_g[0]["codec_loss"] == 0.0:
        raise AssertionError("small codec training: the distillation loss did not run")
    if loss_err > CODEC_LOSS_RTOL or any(e > t for e, t in zip(buf_err, CODEC_BUFFER_RTOL)):
        raise AssertionError("small codec training on the card disagrees with the CPU")
    if counts_g != want:
        raise AssertionError(f"small codec training launched {counts_g}, expected {want}")
    return counts_g


def _top_kernels(events, n: int = 6) -> str:
    by_name: dict = {}
    for e in events:
        short = re.sub(r"<.*", "", e.name)[:60]
        by_name[short] = by_name.get(short, 0.0) + e.time_range.elapsed_us() / 1000
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
    return ", ".join(f"{k} {v:.2f} ms" for k, v in top)


def check_native_batches(scp: str, *runs: dict) -> str:
    """The codec trainer's batches came through the native loader
    (``WaveDataset.load_batch``) in each of ``runs`` (``codec_trainer.main``'s
    returns), and the first batch of an iterator set up as the trainer's
    equals the per-item path's bit for bit. Returns a summary."""
    from rstnet_tpu_torch import native
    from rstnet_tpu_torch.data.codec_dataset import WaveDataset, WaveIterator
    from rstnet_tpu_torch.utils import yaml_subset

    if not native.available():
        raise AssertionError("codec_train_mimi24k: the native C++ loader did not build (g++)")
    counts = [(r["train_iter"].fast_batches, r["train_iter"].item_batches) for r in runs]
    if any(fast == 0 or items for fast, items in counts):
        raise AssertionError(f"codec_train_mimi24k: (load_batch, per-item) batches {counts}: "
                             "the trainer did not read through the native fast path")
    cfg = yaml_subset.load(CODEC_CONFIG)
    kw = dict(segment_size=cfg.get("segment_size", 72000), sampling_rate=24000, split=True,
              audio_norm_scale=cfg.get("audio_norm_scale", 1.0))
    it = WaveIterator(WaveDataset(scp, **kw), cfg.get("batch_size", 4), shuffle=True)
    t0 = time.perf_counter()
    batches = iter(it)
    b24, b16 = next(batches)
    t_fast = time.perf_counter() - t0
    batches.close()  # the prefetch thread may have read the next batch too
    ref = WaveDataset(scp, **kw)
    t0 = time.perf_counter()
    items = [ref[i] for i in it._order()[: len(b24)]]
    t_items = time.perf_counter() - t0
    same = (np.array_equal(b24, np.stack([a for a, _ in items]))
            and np.array_equal(b16, np.stack([b for _, b in items])))
    if not it.fast_batches or it.item_batches or not same:
        raise AssertionError(f"codec_train_mimi24k: first batch through load_batch "
                             f"({it.fast_batches}, {it.item_batches}), equal to the per-item "
                             f"path: {same}")
    return (f"batches through load_batch {counts} (load_batch, per-item); first batch equal to "
            f"the per-item path bit for bit (load_batch {t_fast * 1e3:.1f} ms with the "
            f"iterator's start, per-item {t_items * 1e3:.1f} ms, host clock)")


def run_codec_train_mimi24k(seed: int, card: str) -> dict:
    """Path ``codec_train_mimi24k``: ``codec_trainer.main`` on
    ``CODEC_CONFIG`` at its full widths (batch 4 x 72000 samples) over
    ``CODEC_TRAIN_CLIPS`` seeded pseudo-speech clips of 4 s written as wavs
    under a temporary directory: ``CODEC_STEPS`` steps, then a rerun that
    resumes from its checkpoint for ``CODEC_RESUMED_STEPS`` more; the
    validation step on a batch; then ``codec_infer`` over
    ``CODEC_VALID_CLIPS`` clips (N=50 a K3 call: the split path) and
    ``compute_metrics`` on what it wrote. K3 launches asserted: 2 a G step,
    2 for the validation, 2 a clip. Then one more G+D step under
    ``torch.profiler``: device busy and the largest kernels. Prints the step
    times and the device peak."""
    import tempfile

    from rstnet_tpu_torch.data.synth_speech import synth_corpus
    from rstnet_tpu_torch.evalsuite import compute_metrics
    from rstnet_tpu_torch.inference import codec_infer
    from rstnet_tpu_torch.tools.profile_frame import _union_us, device_trace
    from rstnet_tpu_torch.training import codec_trainer as ct
    from rstnet_tpu_torch.utils import yaml_subset
    from rstnet_tpu_torch.utils.audio import write_wav

    root = Path(tempfile.mkdtemp(prefix="smoke_codec_train_"))
    try:
        _check_disk(root, 4 * 2**30, "codec_train_mimi24k")
        clips = synth_corpus(seed, CODEC_TRAIN_CLIPS + CODEC_VALID_CLIPS, CODEC_CLIP_SECONDS)
        paths = []
        for i, clip in enumerate(clips):
            paths.append(str(root / f"clip{i}.wav"))
            write_wav(paths[-1], clip, 24000)
        (root / "train.scp").write_text("\n".join(paths[:CODEC_TRAIN_CLIPS]))
        (root / "valid.scp").write_text("\n".join(paths[CODEC_TRAIN_CLIPS:]))
        args = ["--config", CODEC_CONFIG, "--exp_dir", str(root / "exp"), "--train_scp",
                str(root / "train.scp"), "--semantic_teacher", "none", "--device", "cuda"]
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        first = ct.main(args + ["--max_steps", str(CODEC_STEPS)])
        t_first = time.perf_counter() - t0
        t0 = time.perf_counter()
        second = ct.main(args + ["--max_steps", str(CODEC_STEPS + CODEC_RESUMED_STEPS)])
        t_second = time.perf_counter() - t0
        native_batches = check_native_batches(str(root / "train.scp"), first, second)
        steps = first["steps"] + second["steps"]
        if [s["step"] for s in steps] != list(range(1, CODEC_STEPS + CODEC_RESUMED_STEPS + 1)):
            raise AssertionError(f"codec_train_mimi24k: steps {[s['step'] for s in steps]}: the "
                                 "rerun did not resume at the first run's last step")
        if not all(math.isfinite(s["g_loss"]) and math.isfinite(s["d_loss"]) for s in steps):
            raise AssertionError("codec_train_mimi24k: a non-finite G or D loss")
        state = second["state"]
        g, d = state["model"]["g"], state["model"]["d"]
        valid = torch.from_numpy(np.stack([c[:72000] for c in clips[-CODEC_VALID_CLIPS:]]))
        ev = _codec_items(ct.evaluate(g, valid.view(CODEC_VALID_CLIPS, 1, -1).cuda()))
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2**30
        t0 = time.perf_counter()
        n_clips = codec_infer.main(["--config", CODEC_CONFIG, "--checkpoint_dir",
                                    str(root / "exp"), "--scp", str(root / "valid.scp"),
                                    "--out_dir", str(root / "recon"), "--device", "cuda"])
        t_infer = time.perf_counter() - t0
        counts = read_counts()
        t0 = time.perf_counter()
        report = compute_metrics.main(["--ref_dir", str(root / "recon/ref"), "--deg_dir",
                                       str(root / "recon/deg"), "--output",
                                       str(root / "metrics.json")])
        t_metrics = time.perf_counter() - t0
        n_steps = len(steps)
        want = {**dict.fromkeys(_counters(), 0), "rvq_encode": 2 * n_steps + 2 + 2 * n_clips}
        if counts != want:
            raise AssertionError(f"codec_train_mimi24k launched {counts}, expected {want}")
        if report["n"] != CODEC_VALID_CLIPS or not all(
                math.isfinite(report["mean"][k]) for k in ("si_snr", "mel_ssim", "mcd", "ms_stft")):
            raise AssertionError(f"codec_train_mimi24k: compute_metrics gave {report['mean']}")
        # one more G+D step, profiled (it trains on: the state is the run's)
        cfg = yaml_subset.load(CODEC_CONFIG)
        loss_cfg = ct.generator_loss_config(cfg)
        conf = cfg["optimizer"]["g"]["config"]
        tx = ct.make_tx(conf, 0.999, CODEC_TRAIN_CLIPS // 4)
        g_step, d_step, _ = ct.make_steps(g, d, loss_cfg, tx, tx)
        batch = torch.from_numpy(np.stack([c[:72000] for c in clips[:4]])).view(4, 1, -1).cuda()
        generator = torch.Generator().manual_seed(seed)

        def step():
            rec, _ = g_step(state, batch, None, generator, use_adv=True)
            d_step(state, batch, rec)

        step()
        torch.cuda.synchronize()
        events, wall_us = device_trace(step, attempts=4)
        busy = _union_us([(e.time_range.start, e.time_range.end) for e in events]) / 1000
        k3 = sum(e.time_range.elapsed_us() for e in events if "rvq_" in e.name
                 or "codeword_sq_norms" in e.name) / 1000
        times = [s["seconds"] * 1000 for s in steps]
        log(f"codec_train_mimi24k ({CODEC_CONFIG}: G {sum(p.numel() for p in g.parameters())} "
            f"and MFD {sum(p.numel() for p in d.parameters())} parameters, batch 4 x 72000): "
            f"{CODEC_STEPS} steps in {t_first:.1f} s, resumed for {CODEC_RESUMED_STEPS} in "
            f"{t_second:.1f} s; step times " + ", ".join(f"{t:.1f}" for t in times)
            + f" ms (host clock, data included); median after the first "
            f"{statistics.median(times[1:]):.1f} ms; device peak {peak:.2f} GiB; losses g "
            + ", ".join(f"{s['g_loss']:.4f}" for s in steps) + "; d "
            + ", ".join(f"{s['d_loss']:.4f}" for s in steps)
            + f"; validation {ev}; codec_infer {n_clips} clips in {t_infer:.1f} s; "
            f"compute_metrics in {t_metrics:.1f} s: {report['mean']}; K3 launches "
            f"{counts['rvq_encode']}; {native_batches} [{card}]")
        log(f"codec_train_mimi24k profiled G+D step: device busy {busy:.3f} ms of "
            f"{wall_us / 1000:.3f} ms wall ({100 * busy * 1000 / wall_us:.1f} %), "
            f"{len(events)} device events, K3 {k3:.4f} ms; largest: {_top_kernels(events)} "
            f"[{card}]")
        return counts
    finally:
        shutil.rmtree(root, ignore_errors=True)


# -- GLM-4-Voice SSL stack ------------------------------------------------------------

# ssl_tokenize_glm4v's clips (s): one with a full 30 s chunk and a partial
# one, the clip held to the CPU, one more; > 60 s in all
SSL_CLIP_SECONDS = (37.0, 5.0, 21.0)
# card vs CPU tokens: compared where the CPU's best and second-best codeword
# distances are further apart than this fraction of the best (the rest are
# near-ties that float32 sums in another order may flip, and are counted)
SSL_TIE_RTOL = 1e-4
# ssl_decode_glm4v: offline tokens (20 s: 1722 mel frames, 440832 samples)
# and streamed tokens (10 blocks of the conformer's grid width, 10)
SSL_DECODE_TOKENS, SSL_STREAM_TOKENS = 250, 100
# the stream's device busy is read over a traced run of its first 2 blocks,
# against that run's own wall: the 100 tokens' ~213 k device events lose
# their end marker in torch.profiler (4 windows in a row on the H100)
SSL_STREAM_TRACE_TOKENS = 20
# small_ssl, card vs CPU on the same weights and draws: the flow's mel and
# HiFT's wav and source (float32 throughout; sums in another order)
SSL_MEL_TOL, SSL_WAV_TOL = 1e-3, 1e-4
SMALL_SSL_HIFT_FRAMES = 40  # HiFT's short signal: 10240 samples
# HiFT's source of a voiced f0 over that short signal: its top harmonic's
# phase cumsum reaches ~500 cycles, where float32 steps by 2**-15, so two
# summation orders may sit a few steps apart (~1e-4 cycles): ~1e-4 in each
# harmonic's 0.1 sin, summed through the 9-input linear and tanh
SSL_SOURCE_TOL = 1e-3


def ssl_clips(seed: int) -> list:
    """Seeded pseudo-speech at 24 kHz (``data/synth_speech.py``), resampled
    to 16 kHz, one clip a ``SSL_CLIP_SECONDS`` entry."""
    from rstnet_tpu_torch.data.synth_speech import synth_pseudo_speech
    from rstnet_tpu_torch.utils.audio import resample_linear

    rng = np.random.RandomState(seed + 16)
    return [resample_linear(synth_pseudo_speech(rng, s)[None], 24000, 16000)[0]
            for s in SSL_CLIP_SECONDS]


def cpu_tokens_and_gaps(model, wav: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """``SSLTokenizer.tokenize``'s ids of one chunk (< 30 s) from ``model``
    on its device, and each token's gap: (second-best - best distance) /
    |best|."""
    from rstnet_tpu_torch.models.whisper_vq import codeword_distances, log_mel_spectrogram

    stride = 2 * model.config.pooling_kernel_size * 160
    device = model.codebook.device
    seg = np.pad(wav, (0, (-len(wav)) % stride))
    mel = log_mel_spectrogram(torch.from_numpy(seg).to(device), model.config.n_mels)
    mask = (torch.arange(mel.shape[1], device=device) < -(-len(wav) // 160)).float()[None]
    with torch.no_grad():
        h, tok_mask = model.hidden(mel[None], mask)
        d = codeword_distances(h[0], model.codebook)
        best2 = d.topk(2, dim=-1, largest=False).values
        valid = tok_mask[0] > 0.5
        ids = d.argmin(dim=-1)[valid]
        gap = ((best2[:, 1] - best2[:, 0]) / best2[:, 0].abs())[valid]
    return ids.cpu().numpy(), gap.cpu().numpy()


def _no_launches(path: str, counts: dict) -> None:
    """The SSL stack reaches no counted kernel (no TPU kernel is on its path)."""
    if any(counts.values()):
        raise AssertionError(f"{path} launched counted kernels: {counts}")


def run_cli_fp32(main, argv: list, name: str) -> None:
    """``main(argv)`` started with TF32 allowed for matmuls and convolutions
    (cuDNN's default); it must turn both off, as the reference runs float32."""
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        main(argv)
    finally:
        left_on = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    if any(left_on):
        raise AssertionError(f"{name} left TF32 on (matmul, cuDNN): {left_on}")


def _busy_ms(fn, confirm: bool = True) -> tuple[float, float, int]:
    """(device busy ms, wall ms, device events) of one ``fn()`` under
    ``tools/profile_frame.py::device_trace``. Windows of ~2 x 10^4 events
    and more lost their last ~40 records, end marker included, in most
    windows on the H100; without ``confirm``, the first window that holds
    both markers counts, out of up to 8."""
    from rstnet_tpu_torch.tools.profile_frame import _union_us, device_trace

    events, wall_us = device_trace(fn, attempts=4 if confirm else 8, confirm=confirm)
    busy = _union_us([(e.time_range.start, e.time_range.end) for e in events]) / 1000
    return busy, wall_us / 1000, len(events)


def check_small_ssl(seed: int, card: str) -> dict:
    """Path ``small_ssl``: the encoder, the flow (conformer, one U-Net call,
    the solver through ``GLM4VFlow.inference``) and HiFT at small widths, on
    the card and on the CPU from the same weights and draws (CPU
    generators, the same seed on each side): tokens equal where the CPU's
    gap exceeds ``SSL_TIE_RTOL``, mel within ``SSL_MEL_TOL``, HiFT's wav and
    source over a short signal (``SMALL_SSL_HIFT_FRAMES`` frames) within
    ``SSL_WAV_TOL``, and its source of a voiced f0 there within
    ``SSL_SOURCE_TOL`` (the float32 phase cumsum has barely drifted)."""
    import copy

    from rstnet_tpu_torch.models.glm4v_flow import (
        ConformerConfig,
        GLM4VFlow,
        GLM4VFlowConfig,
        UNetConfig,
        cfm_solve,
    )
    from rstnet_tpu_torch.models.hift import HiFTConfig, HiFTGenerator, generator_draws
    from rstnet_tpu_torch.models.whisper_vq import WhisperVQConfig, WhisperVQEncoder

    reset_counts()
    g = torch.Generator().manual_seed(seed)
    enc = WhisperVQEncoder(WhisperVQConfig(
        d_model=256, num_heads=4, ffn_dim=1024, num_layers=2, pooling_position=2,
        quantize_position=2, quantize_vocab_size=1024), generator=g)
    wav = ssl_clips(seed)[1]
    ids_c, gap = cpu_tokens_and_gaps(enc, wav)
    ids_g, _ = cpu_tokens_and_gaps(copy.deepcopy(enc).cuda(), wav)
    far = gap > SSL_TIE_RTOL
    tok_diff = int(((ids_c != ids_g) & far).sum())
    fcfg = GLM4VFlowConfig(
        vocab_size=512, input_size=128, spk_embed_dim=192,
        encoder=ConformerConfig(input_size=128, output_size=128, attention_heads=4,
                                linear_units=256, num_blocks=2),
        unet=UNetConfig(channels=(64, 64), attention_head_dim=16, n_blocks=1,
                        num_mid_blocks=2, num_heads=4))
    flow = GLM4VFlow(fcfg, generator=g)
    hcfg = HiFTConfig(base_channels=64, f0_cond_channels=64)
    hift = HiFTGenerator(hcfg, generator=g)
    rng = np.random.default_rng(seed)
    token = torch.from_numpy(rng.integers(0, 512, (1, 40)))
    T_mel = fcfg.mel_len(40)
    x = torch.from_numpy(rng.standard_normal((2, 40, 128)).astype(np.float32))
    pad = torch.ones(2, 40, dtype=torch.bool)
    unet_in = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((2, T_mel, 80), (2, T_mel, 80), (2, 80), (2, T_mel, 80))]
    mel_in = torch.from_numpy(2 * rng.standard_normal(
        (1, SMALL_SSL_HIFT_FRAMES, 80)).astype(np.float32))
    z = generator_draws(torch.Generator().manual_seed(seed), "cpu")("z", (1, T_mel, 80))
    out = {}
    for device in ("cpu", "cuda"):
        f, h = copy.deepcopy(flow).to(device), copy.deepcopy(hift).to(device)
        draw = generator_draws(torch.Generator().manual_seed(seed), device)
        with torch.no_grad():
            conf = f.encoder(x.to(device), pad.to(device))
            xu, mu, spk, cond = (t.to(device) for t in unet_in)
            v = f.unet(xu, torch.ones(2, T_mel, device=device), mu,
                       torch.tensor(0.4, device=device), spk, cond)
        mel = f.inference(token.to(device), z.to(device))
        wav_h, src = h.inference(mel_in.to(device), draw=draw)
        out[device] = [t.cpu() for t in (conf, v, mel, wav_h, src)]
    # the solve's estimator as a CUDA graph (the card's default) against eager
    xu, mu, spk, cond = (t.cuda() for t in unet_in)
    with torch.no_grad():
        solves = [cfm_solve(f.unet, xu, mu, torch.ones(2, T_mel, device="cuda"), spk, cond,
                            cuda_graph=graph) for graph in (True, False)]
    graph_err = (solves[0] - solves[1]).abs().max().item()
    errs = [(a - b).abs().max().item() for a, b in zip(out["cpu"], out["cuda"])]
    errs.append(source_drift(h, voiced_f0(SMALL_SSL_HIFT_FRAMES))[0])  # voiced, short
    counts = read_counts()
    log(f"small_ssl, card vs CPU: encoder (d 256, 2 layers, 1024 codes) {len(ids_c)} tokens, "
        f"{int((~far).sum())} within the {SSL_TIE_RTOL} gap, {tok_diff} differ beyond it; "
        f"conformer max abs err {errs[0]:.3e}, one U-Net call {errs[1]:.3e}, flow mel (10 "
        f"Euler steps, the U-Net as a CUDA graph) {errs[2]:.3e} (limit {SSL_MEL_TOL}); a solve "
        f"over the U-Net's inputs as a graph against eager on the card {graph_err:.3e}; HiFT over "
        f"{SMALL_SSL_HIFT_FRAMES} frames ({src.shape[1]} samples): wav {errs[3]:.3e}, source "
        f"{errs[4]:.3e} (limit {SSL_WAV_TOL}), the source of a voiced 80-200 Hz f0 "
        f"{errs[5]:.3e} (limit {SSL_SOURCE_TOL}) [{card}]")
    if (tok_diff or max(*errs[:3], graph_err) > SSL_MEL_TOL or max(errs[3:5]) > SSL_WAV_TOL
            or errs[5] > SSL_SOURCE_TOL):
        raise AssertionError("small_ssl: the card disagrees with the CPU")
    if not all(torch.isfinite(t).all() for t in out["cuda"]) or not out["cuda"][3].abs().max():
        raise AssertionError("small_ssl: a non-finite or silent output on the card")
    _no_launches("small_ssl", counts)
    return {"token_diff": tok_diff, "near_ties": int((~far).sum()), "max_abs_err": errs,
            "graph_vs_eager": graph_err}


def run_ssl_tokenize(root: Path, seed: int, card: str) -> dict:
    """Path ``ssl_tokenize_glm4v``: the GLM-4-Voice tokenizer at its widths
    (``WhisperVQConfig()``), seeded on the card, written as a
    ``glm-4-voice-tokenizer`` directory and loaded back by
    ``offline_tokenization --mode ssl --device cuda`` over an scp of
    ``SSL_CLIP_SECONDS`` clips, twice: the shards equal bit for bit, each
    clip's count ceil(samples / 1280) a 30 s chunk. Then ``tokenize`` alone
    on the loaded model: wall, device busy, peak, audio seconds a second.
    Then the 5 s clip on the CPU from the same directory: equal tokens
    wherever the CPU's gap exceeds ``SSL_TIE_RTOL``."""
    from rstnet_tpu_torch.data.tokenizers.ssl_tokenizer import SSLTokenizer
    from rstnet_tpu_torch.models.whisper_vq import (
        WhisperVQConfig,
        WhisperVQEncoder,
        load_glm4v_encoder,
    )
    from rstnet_tpu_torch.tools import offline_tokenization
    from rstnet_tpu_torch.tools.scp_tools import write_scp
    from rstnet_tpu_torch.tools.upstream_layout import write_glm4v_tokenizer
    from rstnet_tpu_torch.utils.audio import read_wav, write_wav

    _check_disk(root, 4 * 2**30, "ssl_tokenize_glm4v")
    model = WhisperVQEncoder(WhisperVQConfig(), device="cuda",
                             generator=torch.Generator(device="cuda").manual_seed(seed))
    n_params = sum(p.numel() for p in model.parameters())
    t0 = time.perf_counter()
    tok_dir = write_glm4v_tokenizer(root / "glm-4-voice-tokenizer", model)
    t_write = time.perf_counter() - t0
    del model
    entries = []
    for i, clip in enumerate(ssl_clips(seed)):
        entries.append((f"clip{i}", str(root / f"clip{i}.wav")))
        write_wav(entries[-1][1], clip, 16000)
    write_scp(str(root / "ssl.scp"), entries)
    clips = [read_wav(path)[0][0] for _, path in entries]  # as the tool reads them
    argv = ["--scp", str(root / "ssl.scp"), "--mode", "ssl", "--ssl-checkpoint", str(tok_dir),
            "--device", "cuda", "--output"]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    walls = []
    for run in (1, 2):
        t0 = time.perf_counter()
        run_cli_fp32(offline_tokenization.main, argv + [str(root / f"ssl{run}.npz")],
                     "offline_tokenization --mode ssl")
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    counts = read_counts()
    shards = [np.load(root / f"ssl{run}.npz") for run in (1, 2)]
    for (utt, _), clip in zip(entries, clips):
        n = len(clip)
        want = sum(-(-min(30 * 16000, n - off) // 1280) for off in range(0, n, 30 * 16000))
        a, b = shards[0][utt], shards[1][utt]
        if a.shape != (1, want) or a.dtype != np.int32 or not np.array_equal(a, b):
            raise AssertionError(f"ssl_tokenize_glm4v: {utt} gave {a.shape} {a.dtype} (want "
                                 f"(1, {want}) int32), equal across runs: {np.array_equal(a, b)}")
    tok = SSLTokenizer(checkpoint=str(tok_dir), device="cuda")
    audio_s = sum(len(c) for c in clips) / 16000

    def tokenize_all():
        return [tok.tokenize(c) for c in clips]

    tokenize_all()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again = tokenize_all()
    torch.cuda.synchronize()
    t_tok = time.perf_counter() - t0
    busy, wall_ms, n_events = _busy_ms(tokenize_all)
    peak = torch.cuda.max_memory_allocated() / 2**30
    if any(not np.array_equal(a, shards[1][u][0]) for a, (u, _) in zip(again, entries)):
        raise AssertionError("ssl_tokenize_glm4v: SSLTokenizer.tokenize differs from the shard")
    t0 = time.perf_counter()
    cpu = load_glm4v_encoder(str(tok_dir), device="cpu")
    ids_cpu, gap = cpu_tokens_and_gaps(cpu, clips[1])
    t_cpu = time.perf_counter() - t0
    del cpu
    card_ids = shards[1]["clip1"][0]
    far = gap > SSL_TIE_RTOL
    differ = int(((card_ids != ids_cpu) & far).sum())
    reading = {"params": n_params, "audio_s": audio_s, "cli_wall_s": walls,
               "tokenize_wall_s": t_tok, "audio_s_per_s": audio_s / t_tok,
               "busy_ms": busy, "trace_wall_ms": wall_ms, "device_events": n_events,
               "peak_gib": peak, "cpu_tokens": len(ids_cpu), "near_ties": int((~far).sum()),
               "differ_beyond_gap": differ, "min_gap": float(gap.min())}
    log(f"ssl_tokenize_glm4v (WhisperVQConfig(): {n_params} parameters; written in "
        f"{t_write:.1f} s): offline_tokenization --mode ssl over {len(clips)} clips "
        f"({'+'.join(f'{s:g}' for s in SSL_CLIP_SECONDS)} s) in {walls[0]:.2f} s and "
        f"{walls[1]:.2f} s wall (load included), shards equal bit for bit, counts "
        + ", ".join(f"{u} {shards[1][u].shape[1]}" for u, _ in entries)
        + f"; tokenize alone {t_tok:.3f} s, {audio_s / t_tok:.1f} s of audio a second; "
        f"device busy {busy:.2f} of {wall_ms:.2f} ms ({100 * busy / wall_ms:.1f} %, "
        f"{n_events} device events); device peak {peak:.2f} GiB [{card}]")
    log(f"ssl_tokenize_glm4v vs the CPU on the 5 s clip ({t_cpu:.1f} s on the CPU): "
        f"{len(ids_cpu)} tokens, {int((~far).sum())} within the {SSL_TIE_RTOL} gap (smallest "
        f"gap {gap.min():.2e}), {differ} differ beyond it; launches {counts}")
    if differ:
        raise AssertionError("ssl_tokenize_glm4v: the card's tokens differ from the CPU's")
    _no_launches("ssl_tokenize_glm4v", counts)
    return {**reading, "shard": str(root / "ssl2.npz"), "tokenizer": str(tok_dir),
            "scp": entries}


def run_ssl_decode(root: Path, seed: int, card: str) -> dict:
    """Path ``ssl_decode_glm4v``: the glm-4-voice-decoder at its widths
    (``GLM4VFlowConfig()``, ``ConformerConfig()``, ``UNetConfig()``,
    ``HiFTConfig()``), seeded on the card, written as ``config.yaml`` +
    ``flow.pt`` + ``hift.pt`` (HiFT weight-normed) and loaded back; then
    ``offline_inference`` of ``SSL_DECODE_TOKENS`` tokens (exactly
    mel_len x 256 samples) and ``stream_inference`` of ``SSL_STREAM_TOKENS``
    (within the per-seam source-cache trim), each finite, non-silent, within
    +-0.99 and equal bit for bit under the same seed; wall, device busy,
    peak and real-time factor. Then HiFT's source of a voiced f0 contour
    (:func:`voiced_f0`) over the full 440832 samples on the card and on the
    CPU: the float32 phase cumsum's drift, reported."""
    from rstnet_tpu_torch.models.glm4v_decoder import load_glm4v_decoder
    from rstnet_tpu_torch.models.glm4v_flow import GLM4VFlow
    from rstnet_tpu_torch.models.hift import HiFTGenerator
    from rstnet_tpu_torch.tools.upstream_layout import write_glm4v_decoder

    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    flow, hift = GLM4VFlow(device="cuda", generator=g), HiFTGenerator(device="cuda", generator=g)
    n_params = (sum(p.numel() for p in flow.parameters()),
                sum(p.numel() for p in hift.parameters()))
    dec_dir = write_glm4v_decoder(root / "glm-4-voice-decoder", flow, hift)
    del flow, hift
    t0 = time.perf_counter()
    dec = load_glm4v_decoder(str(dec_dir), device="cuda")
    t_load = time.perf_counter() - t0
    cfg, up, sr = dec.flow.config, dec.hift.config.total_upsample, dec.hift.config.sampling_rate
    tokens = torch.from_numpy(np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                                   (1, SSL_DECODE_TOKENS)))
    stream_tokens = tokens[:, :SSL_STREAM_TOKENS]
    gen = functools.partial(torch.Generator().manual_seed, seed)

    def offline():
        return dec.offline_inference(tokens, generator=gen())

    def stream(n_tok=SSL_STREAM_TOKENS):
        return dec.stream_inference(stream_tokens[:, :n_tok], generator=gen())

    dec.offline_inference(tokens[:, :20])  # warm-up at another length
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    readings = {}
    wavs = {}
    for name, fn, n_tok, traced in (
            ("offline", offline, SSL_DECODE_TOKENS, offline),
            ("stream", stream, SSL_STREAM_TOKENS,
             functools.partial(stream, SSL_STREAM_TRACE_TOKENS))):
        times = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            wavs.setdefault(name, []).append(fn())
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        busy, wall_ms, n_events = _busy_ms(traced, confirm=False)
        w = wavs[name][0]
        audio_s = w.shape[1] / sr
        n_traced = n_tok if traced is fn else SSL_STREAM_TRACE_TOKENS
        # busy is read against the traced run's own wall, never the timed runs'
        readings[name] = {"tokens": n_tok, "samples": w.shape[1], "wall_s": times,
                          "rtf": times[1] / audio_s,
                          "trace": {"tokens": n_traced, "busy_ms": busy, "wall_ms": wall_ms,
                                    "device_events": n_events}}
        expect = cfg.mel_len(n_tok) * up
        n_blocks = -(-n_tok // cfg.encoder.block_size)
        bad = []
        if name == "offline" and w.shape != (1, expect):
            bad.append(f"{tuple(w.shape)} samples, not (1, {expect})")
        if name == "stream" and abs(w.shape[1] - expect) > dec.source_cache_len * n_blocks:
            bad.append(f"{w.shape[1]} samples, not {expect} within "
                       f"{dec.source_cache_len * n_blocks}")
        peak_abs = w.abs().max().item()
        if not torch.isfinite(w).all() or not 0 < peak_abs <= 0.99:
            bad.append(f"finite {bool(torch.isfinite(w).all())}, max |wav| {peak_abs}")
        if not torch.equal(wavs[name][0], wavs[name][1]):
            bad.append("two runs under one seed differ")
        readings[name]["max_abs"] = peak_abs
        log(f"ssl_decode_glm4v {name}: {n_tok} tokens -> {w.shape[1]} samples "
            f"({audio_s:.2f} s) in {times[0]:.3f} s, then {times[1]:.3f} s wall; real-time "
            f"factor {times[1] / audio_s:.4f}; a traced run of {n_traced} tokens: device busy "
            f"{busy:.2f} of its {wall_ms:.2f} ms wall ({100 * busy / wall_ms:.1f} %, "
            f"{n_events} device events); max |wav| {peak_abs:.4f} [{card}]")
        if bad:
            raise AssertionError(f"ssl_decode_glm4v {name}: " + "; ".join(bad))
    peak = torch.cuda.max_memory_allocated() / 2**30
    counts = read_counts()
    frames = cfg.mel_len(SSL_DECODE_TOKENS)
    drift, phase_drift, where = source_drift(dec.hift, voiced_f0(frames))
    head = source_drift(dec.hift, voiced_f0(frames)[:, :SMALL_SSL_HIFT_FRAMES])[0]
    log(f"ssl_decode_glm4v ({n_params[0]} flow and {n_params[1]} HiFT parameters, loaded in "
        f"{t_load:.1f} s): device peak {peak:.2f} GiB; HiFT's source (no draws) of a voiced "
        f"80-200 Hz f0 over {frames * up} samples, card vs CPU: max abs diff {drift:.3e} (at "
        f"the sample {where}; the top harmonic's cumsum % 1 {phase_drift:.3e} cycles apart), "
        f"over its first {SMALL_SSL_HIFT_FRAMES * up} samples {head:.3e}: the float32 phase "
        f"cumsum in another order; launches {counts} [{card}]")
    _no_launches("ssl_decode_glm4v", counts)
    return {"params": n_params, "load_s": t_load, "peak_gib": peak, **readings,
            "source_drift_max": drift, "phase_drift_cycles": phase_drift,
            "source_drift_head": head, "decoder": str(dec_dir)}


def voiced_f0(frames: int) -> torch.Tensor:
    """``[1, frames]`` an f0 contour of 80-200 Hz (voiced throughout): the
    random weights' F0 predictor gives near 0 Hz, below the voiced
    threshold, where the phase never reaches the source."""
    t = torch.arange(frames, dtype=torch.float32) / frames
    return (140.0 + 60.0 * torch.sin(2 * math.pi * 3 * t))[None]


def source_drift(hift, f0: torch.Tensor) -> tuple[float, float, int]:
    """HiFT's deterministic source of ``f0`` on the card against the CPU:
    (max abs diff of the source, max abs diff of the top harmonic's phase
    ``cumsum % 1`` in cycles, the sample where the source differs most)."""
    import copy

    cpu = copy.deepcopy(hift).cpu()
    with torch.no_grad():
        src = [m.source(f0.to(dev))[0, :, 0].cpu() for m, dev in ((hift, "cuda"), (cpu, "cpu"))]
    rad = f0.repeat_interleave(hift.config.total_upsample, dim=-1) * (
        hift.config.nb_harmonics + 1) / hift.config.sampling_rate
    phase = [torch.remainder(torch.cumsum(rad.to(dev), dim=-1), 1.0).cpu()
             for dev in ("cuda", "cpu")]
    d = (phase[0] - phase[1]).abs()
    d = torch.minimum(d, 1.0 - d)  # across the wrap at 1
    diff = (src[0] - src[1]).abs()
    return diff.max().item(), d.max().item(), int(diff.argmax())


def run_ssl_resynth(root: Path, tok: dict, dec: dict, card: str) -> dict:
    """Path ``ssl_resynth``: the CLI on ``ssl_tokenize_glm4v``'s shard
    (``--tokens``, offline: each wav exactly mel_len(T) x 256 samples), then
    ``--scp --stream`` on the 5 s clip (tokenize + streaming decode: within
    the per-seam trim); every wav at 22.05 kHz."""
    import wave

    from rstnet_tpu_torch.models.glm4v_flow import GLM4VFlowConfig
    from rstnet_tpu_torch.tools import ssl_resynth
    from rstnet_tpu_torch.tools.scp_tools import write_scp

    cfg = GLM4VFlowConfig()
    shard = np.load(tok["shard"])
    reset_counts()
    t0 = time.perf_counter()
    run_cli_fp32(ssl_resynth.main, ["--tokens", tok["shard"], "--decoder-checkpoint",
                                    dec["decoder"], "--out_dir", str(root / "resynth"),
                                    "--device", "cuda"], "ssl_resynth --tokens")
    t_tokens = time.perf_counter() - t0
    write_scp(str(root / "one.scp"), [tok["scp"][1]])
    t0 = time.perf_counter()
    run_cli_fp32(ssl_resynth.main, ["--scp", str(root / "one.scp"), "--ssl-checkpoint",
                                    tok["tokenizer"], "--decoder-checkpoint", dec["decoder"],
                                    "--out_dir", str(root / "resynth_stream"), "--stream",
                                    "--device", "cuda"], "ssl_resynth --scp --stream")
    t_scp = time.perf_counter() - t0
    counts = read_counts()
    lengths, audio_s = {}, 0.0
    for utt in shard.files:
        with wave.open(str(root / "resynth" / f"{utt}.wav")) as f:
            rate, n = f.getframerate(), f.getnframes()
        want = cfg.mel_len(shard[utt].shape[1]) * 256
        lengths[utt] = n
        audio_s += n / 22050
        if rate != 22050 or n != want:
            raise AssertionError(f"ssl_resynth: {utt}.wav has {n} samples at {rate} Hz, not "
                                 f"{want} at 22050")
    utt = tok["scp"][1][0]
    n_tok = shard[utt].shape[1]
    with wave.open(str(root / "resynth_stream" / f"{utt}.wav")) as f:
        rate, n = f.getframerate(), f.getnframes()
    want, n_blocks = cfg.mel_len(n_tok) * 256, -(-n_tok // cfg.encoder.block_size)
    trim = 256 * n_blocks  # the source cache (1 mel frame) a seam
    if rate != 22050 or abs(n - want) > trim:
        raise AssertionError(f"ssl_resynth --stream: {utt}.wav has {n} samples at {rate} Hz, "
                             f"not {want} within {trim}")
    log(f"ssl_resynth: --tokens over {len(shard.files)} utterances ({audio_s:.1f} s of audio, "
        f"decoder load included) in {t_tokens:.2f} s wall, lengths {lengths}; --scp --stream "
        f"on {utt} ({n_tok} tokens -> {n} samples, {n_blocks} blocks; both loads included) in "
        f"{t_scp:.2f} s wall; launches {counts} [{card}]")
    _no_launches("ssl_resynth", counts)
    return {"tokens_wall_s": t_tokens, "audio_s": audio_s, "scp_stream_wall_s": t_scp}


def run_ssl_phases(args, card: str) -> dict:
    """The GLM-4-Voice paths; their checkpoints under a temporary directory
    removed at the end. Returns each path's readings."""
    out = {}
    with phase("small ssl"):
        out["small_ssl"] = check_small_ssl(args.seed, card)
    root = Path(tempfile.mkdtemp(prefix="smoke_ssl_"))
    try:
        with phase("ssl tokenize"):
            gc.collect()
            torch.cuda.empty_cache()
            tok = run_ssl_tokenize(root, args.seed, card)
        with phase("ssl decode"):
            gc.collect()
            torch.cuda.empty_cache()
            dec = run_ssl_decode(root, args.seed, card)
        with phase("ssl resynth"):
            out["ssl_resynth"] = run_ssl_resynth(root, tok, dec, card)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["ssl_tokenize_glm4v"] = {k: v for k, v in tok.items()
                                 if k not in ("shard", "tokenizer", "scp")}
    out["ssl_decode_glm4v"] = {k: v for k, v in dec.items() if k != "decoder"}
    return out


# -- the data-prep slice: the duplex client over a socket, the recipes ---------------

WS_SECONDS = 4.0  # the seeded wav of duplex_ws_solo and each load_test session
WS_SESSIONS = 16
PCM16_STEP = 1 / 32768
RECIPE_CLIPS, RECIPE_CLIP_SECONDS, RECIPE_SR = 4, 40.0, 44100  # raw recordings, stereo
RECIPE_LAYERS = 2  # the trainer's depth cut (configs/llama_1b_speech.yaml has 16)
RECIPE_STEPS = 2  # trainer steps: one batch an epoch (--minibatch_debug 1), 2 epochs


def _stats(url: str) -> dict:
    """``/api/stats`` of the server behind chat ``url`` (localhost)."""
    import urllib.request

    stats_url = url.replace("ws://", "http://").replace("/api/chat", "/api/stats")
    with urllib.request.urlopen(stats_url, timeout=30) as resp:
        return json.loads(resp.read())


def run_duplex_ws_solo(mimi, lm_gen, seed: int, card: str) -> tuple[dict, dict]:
    """Path ``duplex_ws_solo``: Mimi 24 kHz + Moshi 7B (greedy) in a
    ``ServerState`` served by ``serving.server.build_app`` on a localhost
    port (``serve_in_thread``), warmed (its frame and scan captured as CUDA
    graphs) before ``serving.client.main`` streams a seeded ``WS_SECONDS``
    wav over it with ``--codec pcm16``. Audio frames received must be the
    frames sent less ``max_delay``; the text and audio equal (audio within
    one PCM16 step) the same PCM16 frames through ``handle_frame_array``
    after a ``reset``; no catch-up scan may run (the client sends a frame a
    message, so none is due). Launches (``graph_launches``): the host
    counters over the client's run (the steps were captured before it) and
    the frame graph's replays in it times one replay's kernels (K1, K3).
    Returns (launches, readings)."""
    from rstnet_tpu_torch.serving import client
    from rstnet_tpu_torch.serving.server import (
        TEXT_SKIP_IDS,
        ServerState,
        build_app,
        serve_in_thread,
    )
    from rstnet_tpu_torch.utils.audio import float_to_pcm16, pcm16_to_float, write_wav

    greedy = dataclasses.replace(lm_gen, use_sampling=False)
    root = Path(tempfile.mkdtemp(prefix="smoke_ws_"))
    try:
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        state = ServerState(mimi, greedy, seed=seed)
        state.warmup()
        torch.cuda.synchronize()
        t_warm = time.perf_counter() - t0
        scans = []
        inner = state.handle_frames_array
        state.handle_frames_array = lambda pcm: scans.append(pcm.shape[-1]) or inner(pcm)
        wav = _signal(seed + 31, int(WS_SECONDS * 24000), 180.0)
        write_wav(str(root / "in.wav"), wav, 24000)
        fstep = state.graphs()["frame"]
        before = fstep.replays
        reset_counts()
        with serve_in_thread(build_app(state)) as url:
            t0 = time.perf_counter()
            audio, text = client.main(["--url", url, "--in-wav", str(root / "in.wav"), "--codec",
                                       "pcm16", "--out-wav", str(root / "out.wav")])
            t_client = time.perf_counter() - t0
            stats = _stats(url)
        host = read_counts()
        replays = fstep.replays - before
        peak = torch.cuda.max_memory_allocated() / 2**30
        # the same frames, as the server got them, after a reset
        state.handle_frames_array = inner
        fs = state.frame_size
        pcm = np.pad(wav, (0, (-len(wav)) % fs)).reshape(-1, fs)
        state.reset()
        want_audio, want_text = [], []
        for x in pcm:
            a, tok = state.handle_frame_array(pcm16_to_float(float_to_pcm16(x)))
            if a is not None:
                want_audio.append(pcm16_to_float(float_to_pcm16(a)))
                if tok not in TEXT_SKIP_IDS:
                    want_text.append(str(tok))
        per_replay = replay_launches(lambda: state._run(pcm[-1], 0))
        launches = graph_launches(host, per_replay, replays, captures=0)
        n_sent, max_delay = len(pcm), greedy.max_delay
        n_recv = len(audio) // fs
        err = (float(np.abs(audio - np.concatenate(want_audio)).max())
               if len(audio) == len(want_audio) * fs else float("inf"))
        log(f"duplex_ws_solo: client.main streamed {n_sent} frames over ws://127.0.0.1 "
            f"(pcm16) in {t_client:.2f} s wall and received {n_recv} audio frames "
            f"(max_delay {max_delay}), {len(text)} text characters; audio max |socket - "
            f"handle_frame_array| {err:.3g} (one PCM16 step {PCM16_STEP:.3g}); catch-up scans "
            f"{len(scans)}; frame graph replays {replays}, host launches "
            f"{ {k: v for k, v in host.items() if v} }, one replay {per_replay}; launches "
            f"{ {k: v for k, v in launches.items() if v} }; /api/stats p50 {stats.get('p50_ms')} "
            f"ms, p99 {stats.get('p99_ms')} ms over {stats.get('n_frames')} frames (server "
            f"host clock, the frame's handling); warmed up in {t_warm:.1f} s; peak memory "
            f"{peak:.1f} GiB [{card}]")
        if n_recv != n_sent - max_delay:
            raise AssertionError(f"duplex_ws_solo: {n_recv} audio frames received, expected "
                                 f"{n_sent} - {max_delay}")
        if text != "".join(want_text):
            raise AssertionError(f"duplex_ws_solo: text {text!r} over the socket, "
                                 f"{''.join(want_text)!r} from handle_frame_array")
        if not err <= PCM16_STEP:
            raise AssertionError(f"duplex_ws_solo: audio differs from handle_frame_array by "
                                 f"{err}, more than one PCM16 step")
        if scans:
            raise AssertionError(f"duplex_ws_solo: {len(scans)} catch-up scans ran; the "
                                 "comparison holds only for single frames")
        if not (launches["depformer_step"] > 0 and launches["rvq_encode"] > 0):
            raise AssertionError(f"duplex_ws_solo: launches {launches}: K1 and K3 must run")
        readings = {"frames_sent": n_sent, "frames_recv": n_recv, "max_delay": max_delay,
                    "client_wall_s": t_client, "p50_ms": stats.get("p50_ms"),
                    "p99_ms": stats.get("p99_ms"), "n_frames": stats.get("n_frames"),
                    "audio_max_err": err, "text_chars": len(text), "scans": len(scans),
                    "replays": replays, "peak_gib": peak, "card": card}
        del state, fstep
        return launches, readings
    finally:
        shutil.rmtree(root, ignore_errors=True)


def run_duplex_ws_batched(mimi, lm_gen, seed: int, sessions: int, card: str) -> tuple[dict, dict]:
    """Path ``duplex_ws_batched_16``: ``build_batched_app`` over a
    ``SessionBatcher`` of ``sessions`` slots (the same model, bf16 LM
    state, greedy; pipeline depth and wire as ``build_server`` picks them),
    warmed (its tick captured) before ``client.load_test(url, sessions,
    seconds=WS_SECONDS, real_time=True, codec="pcm16")`` drives it from as
    many concurrent sockets. Every session must receive at least
    ``n_frames - max_delay`` frames; K2 and K3 must run. Launches as in
    ``run_duplex_ws_solo``, over the tick graph's replays. Prints each session's first-frame time and frames, and the
    tick and delivery tails of ``/api/stats``. Returns (launches, readings)."""
    import asyncio

    from rstnet_tpu_torch.serving import client
    from rstnet_tpu_torch.serving.batcher import SessionBatcher, auto_pipeline_depth
    from rstnet_tpu_torch.serving.server import build_batched_app, serve_in_thread

    greedy = dataclasses.replace(lm_gen, use_sampling=False)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    depth = auto_pipeline_depth(device=torch.device("cuda"))
    batcher = SessionBatcher(mimi, greedy, max_sessions=sessions, dtype=torch.bfloat16,
                             pipeline_depth=depth, wire_dtype="int16" if depth > 1 else "float32",
                             seed=seed)
    batcher.warmup()
    t_warm = time.perf_counter() - t0
    before = batcher._graph.replays
    n_frames = int(WS_SECONDS / 0.08)
    reset_counts()
    with serve_in_thread(build_batched_app(batcher)) as url:
        t0 = time.perf_counter()
        stats = asyncio.run(client.load_test(url, sessions, seconds=WS_SECONDS, real_time=True,
                                             codec="pcm16"))
        t_client = time.perf_counter() - t0
        server = _stats(url)
    host = read_counts()
    replays = batcher._graph.replays - before
    peak = torch.cuda.max_memory_allocated() / 2**30
    zero = np.zeros((sessions, 1, batcher.frame_size), np.float32)
    per_replay = replay_launches(lambda: batcher._tick(zero))
    launches = graph_launches(host, per_replay, replays, captures=0)
    recv = [s["frames_recv"] for s in stats]
    first = [s["first_frame_ms"] for s in stats]
    log(f"duplex_ws_batched_{sessions}: client.load_test, {sessions} sockets x {n_frames} "
        f"frames at the 80 ms cadence (pcm16), {t_client:.2f} s wall; frames received "
        f"{recv} (max_delay {greedy.max_delay}); first frame ms {first} (client clock, from "
        f"the handshake); tick p50 {server.get('p50_ms')} ms, p99 {server.get('p99_ms')} ms "
        f"over {server.get('n_frames')} ticks, delivery p50 "
        f"{server.get('delivery', {}).get('p50_ms')} ms, p99 "
        f"{server.get('delivery', {}).get('p99_ms')} ms (server host clock); pipeline depth "
        f"{depth}; tick graph replays {replays}, one replay {per_replay}; launches "
        f"{ {k: v for k, v in launches.items() if v} }; warmed up in {t_warm:.1f} s; peak "
        f"memory {peak:.1f} GiB [{card}]")
    short = [i for i, n in enumerate(recv) if n < n_frames - greedy.max_delay]
    if len(stats) != sessions or short:
        raise AssertionError(f"duplex_ws_batched_{sessions}: sessions {short} received fewer "
                             f"than {n_frames} - {greedy.max_delay} frames: {recv}")
    if not (launches["gating_ffn_step"] > 0 and launches["rvq_encode"] > 0):
        raise AssertionError(f"duplex_ws_batched_{sessions}: launches {launches}: K2 and K3 "
                             "must run")
    readings = {"sessions": sessions, "frames_sent": n_frames, "frames_recv": recv,
                "first_frame_ms": first, "tick_p50_ms": server.get("p50_ms"),
                "tick_p99_ms": server.get("p99_ms"), "ticks": server.get("n_frames"),
                "delivery_p50_ms": server.get("delivery", {}).get("p50_ms"),
                "delivery_p99_ms": server.get("delivery", {}).get("p99_ms"),
                "pipeline_depth": depth, "client_wall_s": t_client, "replays": replays,
                "peak_gib": peak, "card": card}
    if batcher._pool is not None:
        batcher._pool.shutdown(wait=True)
    del batcher
    gc.collect()
    torch.cuda.empty_cache()
    return launches, readings


def _run_stage(name: str, argv: list, walls: dict, log_dir: Path) -> None:
    """One recipe stage as a subprocess from the checkout's root: it must
    exit 0; its output goes to ``log_dir``."""
    t0 = time.perf_counter()
    out = log_dir / f"{name}.log"
    with open(out, "w") as f:
        rc = subprocess.run([sys.executable, *argv], stdout=f, stderr=subprocess.STDOUT,
                            cwd=Path(__file__).resolve().parent, timeout=600).returncode
    walls[name] = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"stage {name} exited {rc}: {' '.join(argv)}\n"
                             + out.read_text()[-3000:])


def write_raw_recordings(root: Path, seed: int) -> str:
    """``RECIPE_CLIPS`` raw recordings of about ``RECIPE_CLIP_SECONDS`` s at
    ``RECIPE_SR`` Hz stereo: seeded pseudo-speech turns between pauses of
    0.5-1.5 s, the right channel a quieter copy with its own noise. Returns
    the wav.scp."""
    from rstnet_tpu_torch.data.synth_speech import synth_pseudo_speech
    from rstnet_tpu_torch.tools.scp_tools import write_scp
    from rstnet_tpu_torch.utils.audio import write_wav

    rng = np.random.RandomState(seed)
    entries = []
    for i in range(RECIPE_CLIPS):
        parts, total = [], 0.0
        while total < RECIPE_CLIP_SECONDS:
            turn = float(rng.uniform(4.0, 12.0))
            pause = float(rng.uniform(0.5, 1.5))
            parts += [synth_pseudo_speech(rng, turn, RECIPE_SR),
                      np.zeros(int(pause * RECIPE_SR), np.float32)]
            total += turn + pause
        left = np.concatenate(parts)
        right = 0.7 * left + 0.0005 * rng.standard_normal(len(left)).astype(np.float32)
        path = root / f"raw{i}.wav"
        write_wav(str(path), np.stack([left, right]), RECIPE_SR)
        entries.append((f"rec{i}", str(path)))
    write_scp(str(root / "raw_wav.scp"), entries)
    return str(root / "raw_wav.scp")


def _cut_config(root: Path, layers: int) -> str:
    """``configs/llama_1b_speech.yaml`` at its widths with ``n_layer``
    cut to ``layers``."""
    text = Path("configs/llama_1b_speech.yaml").read_text()
    cut = re.sub(r"(?m)^n_layer: \d+$", f"n_layer: {layers}", text)
    if cut == text:
        raise AssertionError("configs/llama_1b_speech.yaml has no n_layer line to cut")
    path = root / "llama_1b_speech_cut.yaml"
    path.write_text(cut)
    return str(path)


def _shard_equal(a: str, b: dict, what: str) -> int:
    got = np.load(a)
    if sorted(got.files) != sorted(b):
        raise AssertionError(f"{what}: keys {sorted(got.files)} vs {sorted(b)}")
    for k in got.files:
        if not np.array_equal(got[k], b[k]):
            raise AssertionError(f"{what}: codes of {k} differ from the in-process run")
    return len(got.files)


def run_recipe_pretraining(root: Path, raw_scp: str, seed: int, card: str) -> tuple[dict, dict]:
    """Path ``recipe_pretraining``: stages 1-5 of ``egs/pretraining/run.sh``
    through the port's entry points. Stages 1-3 as subprocesses (``python
    -m``): ``pipeline.main`` on the raw recordings; ``scp_tools split`` into
    2 and ``run_jobs --jobs 2`` of ``offline_tokenization --mode audio`` (the
    seeded Mimi 24 kHz at full width on the card, one process a job);
    ``create_data_json --task audio_only`` a shard. Stages 4-5 in this
    process, through the same ``main`` functions, so their launches are
    counted: the trainer on ``configs/llama_1b_speech.yaml`` at full width
    cut to ``RECIPE_LAYERS`` layers, ``RECIPE_STEPS`` steps, then
    ``lm_eval`` on its checkpoint. The shards' codes must equal an
    in-process ``tokenize_audio_scp`` of the same scps (K3 counted), and
    K6's launches what the trainer's buckets imply. Returns (launches,
    readings)."""
    from rstnet_tpu_torch.evalsuite import lm_eval
    from rstnet_tpu_torch.tools.offline_tokenization import tokenize_audio_scp
    from rstnet_tpu_torch.tools.scp_tools import read_scp
    from rstnet_tpu_torch.training import trainer

    data, exp, logs = root / "pretraining", root / "exp_pretraining", root / "logs_pretraining"
    logs.mkdir(parents=True)
    walls = {}
    m = "rstnet_tpu_torch"
    _run_stage("1_pipeline", ["-m", f"{m}.pipeline.main", "--scp", raw_scp, "--out_dir",
                              str(data / "segments")], walls, logs)
    _run_stage("2_split", ["-m", f"{m}.tools.scp_tools", "split", str(data / "segments/wav.scp"),
                           "2", str(data / "split/wav.JOB.scp")], walls, logs)
    _run_stage("2_tokenize", ["-m", f"{m}.tools.run_jobs", "--jobs", "2", "--log",
                              str(data / "log/tok.JOB.log"), "--", sys.executable, "-m",
                              f"{m}.tools.offline_tokenization", "--scp",
                              str(data / "split/wav.JOB.scp"), "--output",
                              str(data / "tokens/audio.JOB.npz"), "--mode", "audio"], walls, logs)
    for job in (1, 2):
        _run_stage(f"3_json_{job}", ["-m", f"{m}.tools.create_data_json", "--task", "audio_only",
                                     "--audio_seq", str(data / f"tokens/audio.{job}.npz"),
                                     "--output", str(data / f"jsons/audio_{job}.json")],
                   walls, logs)
    segments = json.loads((data / "segments/segments.json").read_text())
    seg_seconds = sum(s["duration"] for s in segments)
    # the shards against an in-process run of the same scps (K3 counted)
    reset_counts()
    t0 = time.perf_counter()
    n_utts = 0
    for job in (1, 2):
        tokenize_audio_scp(str(data / f"split/wav.{job}.scp"), str(root / f"ref.{job}.npz"),
                           device="cuda")
        ref = np.load(root / f"ref.{job}.npz")
        n_utts += _shard_equal(str(data / f"tokens/audio.{job}.npz"),
                               {k: ref[k] for k in ref.files}, f"recipe_pretraining shard {job}")
    torch.cuda.synchronize()
    t_ref = time.perf_counter() - t0
    tok_counts = read_counts()
    if n_utts != len(read_scp(str(data / "segments/wav.scp"))) or not tok_counts["rvq_encode"]:
        raise AssertionError(f"recipe_pretraining: {n_utts} utterances tokenized, K3 launches "
                             f"{tok_counts['rvq_encode']}")
    # stage 4: the trainer (recipe flags, 2 steps), then stage 5
    cfg = _cut_config(root, RECIPE_LAYERS)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    out = trainer.main(["--train_data_jsons", str(data / "jsons/*.json"), "--valid_data_jsons",
                        str(data / "jsons/audio_1.json"), "--model_config", cfg, "--exp_dir",
                        str(exp), "--batch_scale", "2500", "--n_epoch", str(RECIPE_STEPS),
                        "--minibatch_debug", "1", "--print_freq", "1",
                        "--seed", str(seed), "--device", "cuda", "--init_on_device", "true"])
    walls["4_train"] = time.perf_counter() - t0
    train_counts = read_counts()
    steps = out["steps"]
    want_k6 = expected_k6(steps, RECIPE_LAYERS)
    train_peak = torch.cuda.max_memory_allocated() / 2**30
    reset_counts()
    t0 = time.perf_counter()
    report = lm_eval.main(["--checkpoint_dir", str(exp), "--data_jsons",
                           str(data / "jsons/audio_1.json"), "--output", str(exp / "ppl.json"),
                           "--device", "cuda"])
    walls["5_lm_eval"] = time.perf_counter() - t0
    eval_counts = read_counts()
    buckets = [(s["batch_size"], s["seq_len"]) for s in steps]
    log(f"recipe_pretraining: {RECIPE_CLIPS} raw recordings of ~{RECIPE_CLIP_SECONDS:.0f} s at "
        f"{RECIPE_SR} Hz stereo -> {len(segments)} segments ({seg_seconds:.1f} s) -> 2 shards "
        f"of {n_utts} utterances, codes equal to the in-process tokenization ({t_ref:.1f} s, "
        f"K3 launches {tok_counts['rvq_encode']}); trainer ({RECIPE_LAYERS} of 16 layers, full "
        f"width) {len(steps)} steps, buckets {buckets}, losses "
        f"{[round(s['loss'], 4) for s in steps]}, launches "
        f"{ {k: v for k, v in train_counts.items() if v} } (K6 expected {want_k6}), peak "
        f"{train_peak:.1f} GiB; lm_eval ppl audio {report['ppl_audio']:.3f}, text "
        f"{report['ppl_text']:.3f} over {report['n_batches']} batches, launches "
        f"{ {k: v for k, v in eval_counts.items() if v} }; stage walls "
        + ", ".join(f"{k} {v:.1f} s" for k, v in walls.items()) + f" [{card}]")
    if len(steps) != RECIPE_STEPS or not all(math.isfinite(s["loss"]) for s in steps):
        raise AssertionError(f"recipe_pretraining: {len(steps)} trainer steps, losses "
                             f"{[s['loss'] for s in steps]}")
    if {k: train_counts[k] for k in want_k6} != want_k6 or any(
            v for k, v in train_counts.items() if k not in want_k6):
        raise AssertionError(f"recipe_pretraining: trainer launches {train_counts}, expected "
                             f"{want_k6}")
    if not all(math.isfinite(report[k]) for k in ("ppl_audio", "ppl_text")):
        raise AssertionError(f"recipe_pretraining: lm_eval report {report}")
    launches = {k: tok_counts[k] + train_counts[k] + eval_counts[k] for k in tok_counts}
    return launches, {"segments": len(segments), "segment_seconds": seg_seconds,
                      "utterances": n_utts, "steps": len(steps), "buckets": buckets,
                      "losses": [s["loss"] for s in steps], "ppl_audio": report["ppl_audio"],
                      "stage_walls_s": walls, "tokenize_in_process_s": t_ref,
                      "train_peak_gib": train_peak, "card": card}


def run_recipe_moshi_ft(root: Path, raw_scp: str, seed: int, card: str) -> tuple[dict, dict]:
    """Path ``recipe_moshi_ft``: stages 1-2 of ``egs/moshi_ft/run.sh`` as
    subprocesses, then its trainer in this process: ``pipeline.main`` with
    diarization, denoise and super-resolution on and ``merge_sessions``
    (without pyannote or DeepFilterNet, the JAX package's single-speaker
    and passthrough routes), ``offline_tokenization --sessions ... --mode
    duplex`` (the seeded Mimi on the card), ``create_data_json --task
    moshi_ft``, and ``RECIPE_STEPS`` trainer steps at ``--parallel_number
    17 --n_q 16`` on the cut config. The shard's codes must equal an
    in-process ``tokenize_duplex_sessions`` of the same sessions (K3
    counted). Returns (launches, readings)."""
    from rstnet_tpu_torch.tools.offline_tokenization import tokenize_duplex_sessions
    from rstnet_tpu_torch.training import trainer

    data, exp, logs = root / "moshi_ft", root / "exp_moshi_ft", root / "logs_moshi_ft"
    logs.mkdir(parents=True)
    data.mkdir(exist_ok=True)
    (data / "pipeline.json").write_text(json.dumps({
        "use_diarization": True, "use_denoise": True, "use_super_resolution": True,
        "use_asr": False, "merge_sessions": True, "session_chunk_s": 60.0}))
    walls = {}
    m = "rstnet_tpu_torch"
    _run_stage("1_pipeline", ["-m", f"{m}.pipeline.main", "--scp", raw_scp, "--out_dir",
                              str(data / "segments"), "--config", str(data / "pipeline.json")],
               walls, logs)
    routes = (logs / "1_pipeline.log").read_text()
    _run_stage("2_tokenize", ["-m", f"{m}.tools.offline_tokenization", "--sessions",
                              str(data / "segments/sessions.json"), "--output",
                              str(data / "tokens/audio.1.npz"), "--mode", "duplex"], walls, logs)
    _run_stage("2_json", ["-m", f"{m}.tools.create_data_json", "--task", "moshi_ft",
                          "--audio_seq", str(data / "tokens/audio.1.npz"), "--output",
                          str(data / "jsons/moshi_1.json")], walls, logs)
    sessions = json.loads((data / "segments/sessions.json").read_text())
    reset_counts()
    t0 = time.perf_counter()
    tokenize_duplex_sessions(str(data / "segments/sessions.json"), str(root / "ref_duplex.npz"),
                             device="cuda")
    ref = np.load(root / "ref_duplex.npz")
    n_grids = _shard_equal(str(data / "tokens/audio.1.npz"), {k: ref[k] for k in ref.files},
                           "recipe_moshi_ft shard")
    torch.cuda.synchronize()
    t_ref = time.perf_counter() - t0
    tok_counts = read_counts()
    shapes = sorted({ref[k].shape[0] for k in ref.files})
    if shapes != [17] or not tok_counts["rvq_encode"]:
        raise AssertionError(f"recipe_moshi_ft: grid rows {shapes}, K3 launches "
                             f"{tok_counts['rvq_encode']}")
    cfg = _cut_config(root, RECIPE_LAYERS)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    out = trainer.main(["--train_data_jsons", str(data / "jsons/*.json"), "--valid_data_jsons",
                        str(data / "jsons/moshi_1.json"), "--model_config", cfg,
                        "--parallel_number", "17", "--n_q", "16", "--exp_dir", str(exp),
                        "--n_epoch", str(RECIPE_STEPS), "--minibatch_debug", "1",
                        "--print_freq", "1", "--seed", str(seed), "--device", "cuda",
                        "--init_on_device", "true"])
    walls["3_train"] = time.perf_counter() - t0
    train_counts = read_counts()
    steps = out["steps"]
    want_k6 = expected_k6(steps, RECIPE_LAYERS)
    peak = torch.cuda.max_memory_allocated() / 2**30
    buckets = [(s["batch_size"], s["seq_len"]) for s in steps]
    single = "diarization skipped" in routes and "DeepFilterNet not available" in routes
    log(f"recipe_moshi_ft: pipeline with diarization, denoise and super-resolution on "
        f"(no pyannote, no DeepFilterNet here: the single-speaker track and the denoise "
        f"passthrough, super-resolution by the linear resampler; routes seen in the log: "
        f"{single}) -> {len(sessions)} sessions -> {n_grids} grids of 17 rows, codes equal to "
        f"the in-process tokenization ({t_ref:.1f} s, K3 launches {tok_counts['rvq_encode']}); "
        f"trainer (--parallel_number 17 --n_q 16, {RECIPE_LAYERS} of 16 layers) "
        f"{len(steps)} steps, buckets {buckets}, losses {[round(s['loss'], 4) for s in steps]}, "
        f"launches { {k: v for k, v in train_counts.items() if v} } (K6 expected {want_k6}), "
        f"peak {peak:.1f} GiB; stage walls "
        + ", ".join(f"{k} {v:.1f} s" for k, v in walls.items()) + f" [{card}]")
    if not single:
        raise AssertionError("recipe_moshi_ft: the pipeline log does not show the "
                             "single-speaker and passthrough routes")
    if len(steps) != RECIPE_STEPS or not all(math.isfinite(s["loss"]) for s in steps):
        raise AssertionError(f"recipe_moshi_ft: {len(steps)} trainer steps, losses "
                             f"{[s['loss'] for s in steps]}")
    if {k: train_counts[k] for k in want_k6} != want_k6 or any(
            v for k, v in train_counts.items() if k not in want_k6):
        raise AssertionError(f"recipe_moshi_ft: trainer launches {train_counts}, expected "
                             f"{want_k6}")
    launches = {k: tok_counts[k] + train_counts[k] for k in tok_counts}
    return launches, {"sessions": len(sessions), "grids": n_grids, "steps": len(steps),
                      "buckets": buckets, "losses": [s["loss"] for s in steps],
                      "stage_walls_s": walls, "tokenize_in_process_s": t_ref,
                      "train_peak_gib": peak, "routes": "single-speaker, denoise passthrough, "
                      "linear super-resolution", "card": card}


def run_recipe_paths(seed: int, card: str, paths: dict) -> dict:
    """Both recipes over one set of raw recordings under a temporary
    directory removed at the end; ``paths`` gets their launches. Returns
    their readings."""
    from rstnet_tpu_torch import native

    if not native.available():
        raise AssertionError("the native C++ loader did not build (g++)")
    root = Path(tempfile.mkdtemp(prefix="smoke_recipes_"))
    out = {}
    try:
        raw_scp = write_raw_recordings(root, seed)
        with phase("recipe pretraining"):
            paths["recipe_pretraining"], out["recipe_pretraining"] = run_recipe_pretraining(
                root, raw_scp, seed, card)
        with phase("recipe moshi_ft"):
            gc.collect()
            torch.cuda.empty_cache()
            paths["recipe_moshi_ft"], out["recipe_moshi_ft"] = run_recipe_moshi_ft(
                root, raw_scp, seed, card)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


def run_prep_phases(args, card: str, paths: dict) -> dict:
    """The recipes, then the socket paths on Mimi + Moshi 7B built again
    (in under a second on the card): served, the frames run on the
    server's thread and the ticks on an executor's, and cuBLAS keeps a
    workspace for each thread it ran on (64 MiB for the two), which would
    raise every later path's peak. ``paths`` gets their launches. Returns
    their readings."""
    out = run_recipe_paths(args.seed, card, paths)
    gc.collect()
    torch.cuda.empty_cache()
    with phase("full models (socket paths)"):
        mimi, lm_gen = build_full_models(args.seed)
    out.update(run_ws_paths(mimi, lm_gen, args.seed, card, paths))
    return out


def run_ws_paths(mimi, lm_gen, seed: int, card: str, paths: dict) -> dict:
    """The two socket paths on the built Mimi + Moshi 7B; ``paths`` gets
    their launches. Returns their readings."""
    out = {}
    with phase("duplex ws solo"):
        paths["duplex_ws_solo"], out["duplex_ws_solo"] = run_duplex_ws_solo(
            mimi, lm_gen, seed, card)
    with phase("duplex ws batched"):
        gc.collect()
        torch.cuda.empty_cache()
        name = f"duplex_ws_batched_{WS_SESSIONS}"
        paths[name], out[name] = run_duplex_ws_batched(mimi, lm_gen, seed, WS_SESSIONS, card)
    gc.collect()
    torch.cuda.empty_cache()
    return out


def run_codec_phases(args, card: str, paths: dict) -> None:
    with phase("small codec training"):
        paths["small_codec_train"] = check_small_codec_training(args.seed, card)
    with phase("codec training"):
        gc.collect()
        torch.cuda.empty_cache()
        paths["codec_train_mimi24k"] = run_codec_train_mimi24k(args.seed, card)
        gc.collect()
        torch.cuda.empty_cache()


# -- parallel training (two ranks on the one card) ---------------------------------

# the collectives probed on CUDA tensors over gloo, in this order; send/recv
# last (on the H100 host it aborts the sending process)
PROBED_COLLECTIVES = ("all_reduce", "all_reduce_max", "broadcast", "all_gather_into_tensor",
                      "all_gather", "reduce_scatter_tensor", "send_recv", "batch_isend_irecv")
# what each mesh axis needs beyond all-reduce and broadcast
AXIS_COLLECTIVES = {"data": ("all_reduce", "broadcast"),
                    "fsdp": ("all_gather_into_tensor", "reduce_scatter_tensor", "all_reduce"),
                    "tensor": ("all_reduce", "all_gather"),
                    "expert": ("all_reduce", "all_gather_into_tensor"),
                    "seq": ("batch_isend_irecv", "all_reduce"),
                    "pipe": ("send_recv", "all_reduce")}
RANK_TIMEOUT_S = 420  # a rank that runs longer fails the path (and every rank is killed)
# train_dp2_llama1b: the full training slice's model, data and bucket, global
# batch B=4 x T=1024 (2 rows a rank), 3 steps at a learning rate that moves
# bf16 weights (1e-3 peak at the first step, Noam decay after)
DP2_STEPS = 3
DP2_LR_FLAGS = ["--global_learning_rate", "1e-3", "--warmup_steps", "1",
                "--init_on_device", "true"]  # the card draws the 2.01 B weights in a second
# train_dp2_llama1b against one process on the same global batches, bf16:
# the losses are float32 sums of the same tokens; the two ranks' GEMMs run at
# 2048 rows where one process runs 4096, so their bf16 outputs may round to
# neighbouring values (~2**-8 relative of a logit) - each step's loss within
# 1e-2 relative. The parameters after the steps: each rank's bf16 gradient
# of its rows, summed in bf16 by the all-reduce, against one bf16 gradient of
# all rows - a relative difference of ~2**-8 that Adam's g / sqrt(v) keeps
# (the first step's update is exactly lr x sign(g)); an element whose
# gradient is near 0 may take another sign (up to 2 lr a step), and the
# final bf16 rounding of the weight may land on the neighbouring value. So:
# every element within 2 x the sum of the lrs plus one bf16 ulp of it, and
# 99 % of them within one ulp plus 5 % of that sum
DP2_LOSS_RTOL = 1e-2
DP2_PARAM_SHARE = 0.99
# codec_train_dp2: codec_train_mimi24k's config and clips, batch 4 (2 a
# rank), 2 steps, float32 with TF32 off, against --dp 1 on the same batches
# and draws. Each step's G and D loss within CODEC_DP2_LOSS_RTOL: the same
# float32 sums over the batch taken in two halves (cuDNN may also pick
# another algorithm at batch 2); the second step's loss is taken after an
# update. The G and D optimizers' first moments, a decayed sum of both
# steps' all-reduced gradients: over all of G (and of D) the norm of the
# difference within CODEC_DP2_MU_RTOL of the norm (a rank that kept its
# own half of the gradient is off by a share of the whole). Not per tensor:
# a sum over 4 x 72000 samples that cancels to a small gradient keeps the
# rounding of its terms (the first encoder conv's largest moment, 4.7e-6,
# took a 1.6e-8 difference on the card, 3.3e-3 of it; its CPU counterpart
# 3.5e-5), so each tensor's worst is reported only. The parameters: an AdamW step moves an element by about lr
# whatever its gradient, and turns rounding noise on a near-zero gradient
# into up to a whole lr, so a bound on every element cannot tell a right
# update from none; instead CODEC_DP2_PARAM_SHARE of the elements within
# 1e-6 of their size plus 5 % of the lr sum (the rest agree to rounding),
# every element within 2 x the lr sum plus that, and the same test of the
# initial weights against the --dp 1 run's final ones must fail (the
# no-update control). Each EMA buffer over its largest magnitude within
# 1e-3 (CODEC_BUFFER_RTOL's after a second step)
CODEC_DP2_STEPS = 2
CODEC_DP2_LOSS_RTOL = 1e-4
CODEC_DP2_MU_RTOL = 1e-3
CODEC_DP2_PARAM_SHARE = 0.99
CODEC_DP2_PARAM_RTOL = 1e-6
CODEC_DP2_BUFFER_RTOL = 1e-3


def start_ranks(job: dict, world: int = 2) -> tuple:
    """Start ``job`` on ``world`` ranks of this card: each a process of
    this script (``--rank-job``) that joins a gloo group through a
    ``file://`` store in a temporary directory. Returns a handle for
    :func:`join_ranks`."""
    root = Path(tempfile.mkdtemp(prefix="smoke_ranks_"))
    (root / "job.json").write_text(json.dumps(job))
    procs = []
    for r in range(world):
        out = open(root / f"rank{r}.log", "wb")
        procs.append((subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--rank-job", str(root),
             "--rank", str(r), "--world", str(world)],
            cwd=Path(__file__).resolve().parent, stdout=out, stderr=subprocess.STDOUT), out))
    return job, root, procs


def join_ranks(handle: tuple, timeout: float = RANK_TIMEOUT_S, must_pass: bool = True) -> list:
    """Join the ranks of :func:`start_ranks` within ``timeout``; a rank
    that fails or hangs fails the run (``must_pass``) and every rank is
    killed. Returns (exit code, result or None, output tail) by rank."""
    job, root, procs = handle
    try:
        deadline = time.monotonic() + timeout
        for p, _ in procs:
            try:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                break
        for p, out in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            out.close()
        got = []
        for r, (p, _) in enumerate(procs):
            res = root / f"result{r}.json"
            tail = (root / f"rank{r}.log").read_text(errors="replace")[-4000:]
            got.append((p.returncode, json.loads(res.read_text()) if res.exists() else None,
                        tail))
        if must_pass and any(rc != 0 for rc, _, _ in got):
            raise AssertionError(f"{job['kind']}: ranks exited {[rc for rc, _, _ in got]} "
                                 f"({timeout:.0f} s limit):\n" + "\n".join(
                                     f"--- rank {r}:\n{tail}" for r, (_, _, tail) in
                                     enumerate(got)))
        return got
    finally:
        shutil.rmtree(root, ignore_errors=True)


def spawn_ranks(job: dict, world: int = 2, timeout: float = RANK_TIMEOUT_S,
                must_pass: bool = True) -> list:
    """:func:`start_ranks` then :func:`join_ranks`."""
    return join_ranks(start_ranks(job, world), timeout, must_pass)


def run_rank_job(root: str, rank: int, world: int) -> int:
    """One rank of ``spawn_ranks``: join the group and run the job."""
    import faulthandler

    faulthandler.enable()  # a rank that crashes prints where
    job = json.loads((Path(root) / "job.json").read_text())
    result_path = Path(root) / f"result{rank}.json"
    if job["kind"] == "probe_nccl":
        return rank_probe_nccl(root, rank, world, result_path)
    from rstnet_tpu_torch.parallel.mesh import initialize_distributed

    torch.backends.cuda.matmul.allow_tf32 = False  # as phase_environment sets it
    torch.backends.cudnn.allow_tf32 = False
    initialize_distributed(f"file://{root}/store", rank=rank, world_size=world,
                           device_type="cuda", timeout_s=RANK_TIMEOUT_S)
    import torch.distributed as dist

    log(f"rank {rank}: backend {dist.get_backend()}, device {torch.cuda.current_device()}")
    fn = {"probe_gloo": rank_probe_gloo, "train_dp2": rank_train_dp2,
          "codec_dp2": rank_codec_dp2, "tp2_frame": rank_tp2_frame}[job["kind"]]
    fn(job, rank, world, result_path)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def rank_probe_gloo(job: dict, rank: int, world: int, result_path: Path) -> None:
    """Each collective once on CUDA tensors; the results are written after
    each, so a collective that aborts the process leaves the earlier ones."""
    import torch.distributed as dist

    dev = torch.device("cuda", 0)
    out = {}

    def p2p():
        if rank == 0:
            dist.send(torch.ones(4, device=dev), 1)
        else:
            dist.recv(torch.empty(4, device=dev), 0)

    def batch_p2p():
        ops = [dist.P2POp(dist.isend, torch.ones(4, device=dev), (rank + 1) % world),
               dist.P2POp(dist.irecv, torch.empty(4, device=dev), (rank - 1) % world)]
        for w in dist.batch_isend_irecv(ops):
            w.wait()

    calls = {
        "all_reduce": lambda: dist.all_reduce(torch.full((4,), rank + 1.0, device=dev)),
        "all_reduce_max": lambda: dist.all_reduce(torch.ones(4, device=dev),
                                                  op=dist.ReduceOp.MAX),
        "broadcast": lambda: dist.broadcast(torch.ones(4, device=dev), 0),
        "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
            torch.empty(4 * world, device=dev), torch.ones(4, device=dev)),
        "all_gather": lambda: dist.all_gather(
            [torch.empty(4, device=dev) for _ in range(world)], torch.ones(4, device=dev)),
        "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
            torch.empty(4, device=dev), torch.ones(4 * world, device=dev)),
        "send_recv": p2p, "batch_isend_irecv": batch_p2p,
    }
    for name in PROBED_COLLECTIVES:
        try:
            calls[name]()
            torch.cuda.synchronize()
            out[name] = "ok"
        except Exception as e:  # noqa: BLE001 - a probe reports what the backend says
            out[name] = f"{type(e).__name__}: {e}"
        result_path.write_text(json.dumps(out))


def rank_probe_nccl(root: str, rank: int, world: int, result_path: Path) -> int:
    """Whether NCCL takes two ranks on one device: its answer, word for word."""
    import datetime

    import torch.distributed as dist

    try:
        torch.cuda.set_device(0)
        dist.init_process_group("nccl", init_method=f"file://{root}/store_nccl", rank=rank,
                                world_size=world, timeout=datetime.timedelta(seconds=60),
                                device_id=torch.device("cuda", 0))
        x = torch.ones(4, device="cuda")
        dist.all_reduce(x)
        torch.cuda.synchronize()
        answer = f"ok: all_reduce gave {x.tolist()}"
        dist.destroy_process_group()
    except Exception as e:  # noqa: BLE001 - a probe reports what the backend says
        answer = f"{type(e).__name__}: {e}"
    result_path.write_text(json.dumps({"nccl_all_reduce": answer}))
    return 0


def probe_collectives(card: str) -> dict:
    """Which collectives gloo runs on CUDA tensors of the one card, and
    whether NCCL takes two ranks on it; printed on a line of its own, any
    error word for word, with the axes each answer leaves to this card."""
    handles = start_ranks({"kind": "probe_gloo"}), start_ranks({"kind": "probe_nccl"})
    gloo, nccl = (join_ranks(h, timeout=120, must_pass=False) for h in handles)
    answers = {}
    for name in PROBED_COLLECTIVES:
        per_rank = [(res or {}).get(name) for _, res, _ in gloo]
        answers[name] = (per_rank[0] if len(set(per_rank)) == 1 and per_rank[0] else
                         {f"rank{r}": a or "not reached (the rank exited before it)"
                          for r, a in enumerate(per_rank)})
    exits = [rc for rc, _, _ in gloo]
    if any(exits):
        answers["exit_codes"] = exits
        answers["last_output"] = {f"rank{r}": tail.strip().splitlines()[-3:]
                                  for r, (rc, _, tail) in enumerate(gloo) if rc}
    ok = {n for n, a in answers.items() if a == "ok"}
    axes = {ax: "runs" if all(c in ok for c in need) else
            "not on this card (" + ", ".join(c for c in need if c not in ok) + " refused)"
            for ax, need in AXIS_COLLECTIVES.items()}
    probe = {"gloo_cuda": answers,
             "nccl_two_ranks_one_card": [(res or {}).get("nccl_all_reduce", "no answer")
                                         for _, res, _ in nccl],
             "axes": axes, "card": card}
    log(json.dumps({"parallel_probe": probe}))
    if axes["data"] != "runs":
        raise AssertionError(f"gloo refuses the data axis' collectives on CUDA tensors: {probe}")
    return probe


def _rss_gib() -> float:
    """This process's resident host memory now."""
    return int(Path("/proc/self/statm").read_text().split()[1]) * os.sysconf("SC_PAGE_SIZE") / 2**30


def _param_sums(model) -> list:
    """Per parameter, its float64 sum and sum of squares: equal on two ranks
    only if the ranks' parameters are."""
    with torch.no_grad():
        return [[float(p.double().sum()), float(p.double().square().sum())]
                for p in model.parameters()]


def rank_train_dp2(job: dict, rank: int, world: int, result_path: Path) -> None:
    """``trainer.main`` at ``--dp 2``: K6 launches, step times, the gradient
    all-reduce's time a step (host clock around it, the device synced), one
    step of rank 0 under ``device_trace``, the peak and the parameters'
    sums."""
    from rstnet_tpu_torch.tools.profile_frame import NoDeviceEvents, _union_us, device_trace
    from rstnet_tpu_torch.training import train_step as ts
    from rstnet_tpu_torch.training import trainer

    reduce_s, traced, models = [], {}, []
    real_reduce = ts.MeshSync.reduce

    def timed_reduce(self, grads):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        real_reduce(self, grads)
        torch.cuda.synchronize()
        reduce_s.append(time.perf_counter() - t0)

    real_make = trainer.make_train_step

    def make(loss_fn, tx, **kw):
        step = real_make(loss_fn, tx, **kw)
        n = [0]

        def run(state, batch):
            n[0] += 1
            models[:] = [state["model"]]
            if rank != 0 or n[0] != job["profiled_step"]:
                return step(state, batch)
            holder = {}

            def once():
                holder["out"] = step(state, batch)

            try:
                events, wall_us = device_trace(once, attempts=1, confirm=False)
                copies = [e for e in events if "Memcpy" in e.name or "memcpy" in e.name]
                traced.update(
                    wall_ms=wall_us / 1e3, events=len(events),
                    busy_ms=_union_us([(e.time_range.start, e.time_range.end)
                                       for e in events]) / 1e3,
                    copies=len(copies),
                    copy_ms=sum(e.time_range.elapsed_us() for e in copies) / 1e3)
            except NoDeviceEvents as e:
                traced["not_measured"] = f"the profiler window lost its markers: {e}"
                if "out" not in holder:
                    raise
            return holder["out"]

        return run

    ts.MeshSync.reduce = timed_reduce
    trainer.make_train_step = make
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = trainer.main(job["argv"])
    wall = time.perf_counter() - t0
    result_path.write_text(json.dumps({
        "steps": out["steps"], "counts": read_counts(), "reduce_s": reduce_s, "wall_s": wall,
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30, "traced": traced,
        "checkpoint": out["checkpoints"][-1]["path"], "sums": _param_sums(models[0])}))


def rank_codec_dp2(job: dict, rank: int, world: int, result_path: Path) -> None:
    """``codec_trainer.main`` at ``--dp 2``: K3 launches, step times, the
    peak and the G/D parameters' and buffers' sums."""
    from rstnet_tpu_torch.training import codec_trainer as ct

    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    out = ct.main(job["argv"])
    gan = out["state"]["model"]
    with torch.no_grad():
        sums = _param_sums(gan) + [[float(b.double().sum())] for b in gan.buffers()]
    result_path.write_text(json.dumps({
        "steps": out["steps"], "counts": read_counts(), "sums": sums,
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
        "checkpoint": out["checkpoints"][-1]}))


def _compare_bf16_params(got: dict, want: dict, lr_sum: float) -> dict:
    """Element statistics of two parameter dicts (bf16) on the card, against
    ``DP2``'s bound: every element within 2 x ``lr_sum`` + one bf16 ulp of
    it, ``DP2_PARAM_SHARE`` of them within one ulp + 5 % of ``lr_sum``."""
    n = close = over = 0
    worst = 0.0
    for name, w in want.items():
        a, b = got[name].cuda().float(), w.cuda().float()
        ulp = torch.clamp(b.abs(), min=2.0**-126) * 2.0**-7
        d = (a - b).abs()
        n += d.numel()
        close += int((d <= ulp + 0.05 * lr_sum).sum())
        over += int((d > ulp + 2 * lr_sum).sum())
        worst = max(worst, float(d.max()))
    return {"elements": n, "share_close": close / n, "over_bound": over, "max_abs": worst}


def run_train_dp2(seed: int, card: str) -> tuple[dict, dict]:
    """Path ``train_dp2_llama1b``: ``trainer.main`` as two processes on the
    card, ``--dp 2``, ``configs/llama_1b_speech.yaml`` at full width (bf16,
    remat), global batch B=4 x T=1024, ``DP2_STEPS`` steps; each rank's K6
    launches asserted; the losses and every parameter after the steps held
    to one process on the same global batches (``DP2_*``), and the two
    ranks' parameters to each other. Returns (both ranks' launches summed,
    the readings)."""
    from rstnet_tpu_torch.models.config import Config
    from rstnet_tpu_torch.training import trainer
    from rstnet_tpu_torch.training.schedulers import warmup_lr

    cfg = Config.from_file("configs/llama_1b_speech.yaml")
    root = Path(tempfile.mkdtemp(prefix="smoke_dp2_"))
    try:
        _check_disk(root, 16 * 2**30, "train_dp2_llama1b")
        # two long utterances and two texts of ~575 fill each batch of 2500
        # tokens (+ the mixing slack); the last utterance's batch is left out
        data = write_training_data(root, seed, (951, 1023), 2 * DP2_STEPS + 1, (430, 470), 0,
                                   (570, 580), 2 * DP2_STEPS, audio_card=2048, vocab=128000)

        def argv(tag):
            return full_train_args(data, root / tag, "bfloat16", DP2_STEPS, seed) + DP2_LR_FLAGS

        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        one = trainer.main(argv("one"))
        one_wall = time.perf_counter() - t0
        ckpt = Path(one["checkpoints"][-1]["path"])
        saved = torch.load(ckpt / "state.pt", map_location="cpu", weights_only=True, mmap=True)
        want = {k: v.clone() for k, v in saved["params"].items()}
        del saved
        shutil.rmtree(root / "one", ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ranks = spawn_ranks({"kind": "train_dp2", "argv": argv("dp2") + ["--dp", "2"],
                             "profiled_step": DP2_STEPS})
        dp2_wall = time.perf_counter() - t0
        res = [r for _, r, _ in ranks]
        for r, got in enumerate(res):
            steps = got["steps"]
            if [(s["batch_size"], s["seq_len"]) for s in steps] != [
                    (s["batch_size"], s["seq_len"]) for s in one["steps"]]:
                raise AssertionError(f"rank {r} batches {steps} differ from one process's")
            shapes = [(s["batch_size"], s["seq_len"]) for s in steps]
            if shapes != [(4, 1024)] * DP2_STEPS:
                raise AssertionError(f"train_dp2_llama1b batches {shapes}: expected B=4 x T=1024")
            expected = expected_k6(steps, cfg.n_layer)
            counts = {k: v for k, v in got["counts"].items() if v}
            if counts != expected:
                raise AssertionError(f"rank {r} launched {counts}, expected {expected}")
            for a, b in zip(steps, one["steps"]):
                if abs(a["loss"] - b["loss"]) > DP2_LOSS_RTOL * abs(b["loss"]):
                    raise AssertionError(f"rank {r} step losses {[s['loss'] for s in steps]}, "
                                         f"one process {[s['loss'] for s in one['steps']]}")
        if res[0]["sums"] != res[1]["sums"]:
            raise AssertionError("the two ranks' parameters differ after the steps")
        got_params = torch.load(Path(res[0]["checkpoint"]) / "state.pt", map_location="cpu",
                                weights_only=True, mmap=True)["params"]
        schedule = warmup_lr(1e-3, 1)
        lr_sum = float(sum(schedule(i) for i in range(DP2_STEPS)))
        stats = _compare_bf16_params(got_params, want, lr_sum)
        del got_params, want
        if stats["over_bound"] or stats["share_close"] < DP2_PARAM_SHARE:
            raise AssertionError(f"train_dp2_llama1b parameters against one process: {stats}")
        counts = {k: res[0]["counts"][k] + res[1]["counts"][k] for k in res[0]["counts"]}
        step_ms = [[round(s["step_time"] * 1e3, 1) for s in g["steps"]] for g in res]
        share = [sum(g["reduce_s"][1:]) / sum(s["step_time"] for s in g["steps"][1:])
                 for g in res]
        reading = {
            "one_process_step_ms": [round(s["step_time"] * 1e3, 1) for s in one["steps"]],
            "dp2_step_ms_by_rank": step_ms, "allreduce_ms_by_rank":
                [[round(t * 1e3, 1) for t in g["reduce_s"]] for g in res],
            "allreduce_share_after_first": share, "peak_gib_by_rank":
                [round(g["peak_gib"], 2) for g in res], "rank0_traced_step": res[0]["traced"],
            "losses_dp2": [s["loss"] for s in res[0]["steps"]],
            "losses_one": [s["loss"] for s in one["steps"]], "params": stats,
            "lr_sum": lr_sum, "one_process_wall_s": round(one_wall, 1),
            "dp2_wall_s": round(dp2_wall, 1), "card": card}
        log(f"train_dp2_llama1b: 2 ranks x B=2 x T=1024 (global B=4) on one card over gloo; "
            f"step ms by rank {step_ms} against one process "
            f"{reading['one_process_step_ms']} (host clock, first step included); gradient "
            f"all-reduce {reading['allreduce_ms_by_rank']} ms, "
            f"{[round(100 * x, 1) for x in share]} % of the steps after the first; peaks "
            f"{reading['peak_gib_by_rank']} GiB; losses {reading['losses_dp2']} vs "
            f"{reading['losses_one']}; parameters {stats}; rank 0's traced step "
            f"{res[0]['traced']}; K6 {counts} [{card}]")
        return counts, reading
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _compare_f32_params(got: dict, want: dict, lr_sums: dict) -> dict:
    """Element statistics of two float32 parameter dicts against
    ``CODEC_DP2``'s test (``lr_sums``: the lr sum by name)."""
    n = close = over = 0
    worst = 0.0
    for name, w in want.items():
        a, b = got[name].double(), w.double()
        d = (a - b).abs()
        near = CODEC_DP2_PARAM_RTOL * b.abs() + 0.05 * lr_sums[name]
        n += d.numel()
        close += int((d <= near).sum())
        over += int((d > near + 2 * lr_sums[name]).sum())
        worst = max(worst, float(d.max()) if d.numel() else 0.0)
    return {"elements": n, "share_close": close / n, "over_bound": over, "max_abs": worst}


def run_codec_dp2(seed: int, card: str) -> tuple[dict, dict]:
    """Path ``codec_train_dp2``: ``codec_trainer.main`` on ``CODEC_CONFIG``
    at full width, ``--dp 2`` as two processes on the card, batch 4 (2 a
    rank), ``CODEC_DP2_STEPS`` steps, against ``--dp 1`` in this process on
    the same clips, teacher features (none) and draws: K3 launches asserted
    (2 a G step a rank), the steps' G and D losses, the optimizers' first
    moments, the G/D parameters and the EMA buffers held to ``--dp 1``
    (``CODEC_DP2_*``), with the initial weights as the no-update control.
    Returns (both ranks' launches summed, the readings)."""
    from rstnet_tpu_torch.data.synth_speech import synth_corpus
    from rstnet_tpu_torch.training import codec_trainer as ct
    from rstnet_tpu_torch.utils import yaml_subset
    from rstnet_tpu_torch.utils.audio import write_wav

    root = Path(tempfile.mkdtemp(prefix="smoke_codec_dp2_"))
    try:
        paths = []
        for i, clip in enumerate(synth_corpus(seed, CODEC_TRAIN_CLIPS, CODEC_CLIP_SECONDS)):
            paths.append(str(root / f"clip{i}.wav"))
            write_wav(paths[-1], clip, 24000)
        (root / "train.scp").write_text("\n".join(paths))

        def argv(tag, dp):
            return ["--config", CODEC_CONFIG, "--exp_dir", str(root / tag), "--train_scp",
                    str(root / "train.scp"), "--semantic_teacher", "none", "--device", "cuda",
                    "--max_steps", str(CODEC_DP2_STEPS), "--dp", str(dp)]

        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        one = ct.main(argv("one", 1))
        one_wall = time.perf_counter() - t0
        gan = one["state"]["model"]
        want = {k: v.detach().cpu() for k, v in gan.state_dict().items()}
        buffers = {n for n, _ in gan.named_buffers()}
        want_mu = {w: {k: v.detach().cpu() for k, v in one["state"]["opt_state"][w]["mu"].items()}
                   for w in ("g", "d")}
        del one["state"], gan
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ranks = spawn_ranks({"kind": "codec_dp2", "argv": argv("dp2", 2)})
        dp2_wall = time.perf_counter() - t0
        res = [r for _, r, _ in ranks]
        for r, got in enumerate(res):
            counts = {k: v for k, v in got["counts"].items() if v}
            if counts != {"rvq_encode": 2 * CODEC_DP2_STEPS}:
                raise AssertionError(f"codec_train_dp2 rank {r} launched {counts}")
            for key in ("g_loss", "d_loss"):
                a, b = [s[key] for s in got["steps"]], [s[key] for s in one["steps"]]
                if len(a) != CODEC_DP2_STEPS or len(b) != CODEC_DP2_STEPS or any(
                        abs(x - y) > CODEC_DP2_LOSS_RTOL * abs(y) for x, y in zip(a, b)):
                    raise AssertionError(f"codec_train_dp2 rank {r} {key} {a}, --dp 1 {b}")
        if res[0]["sums"] != res[1]["sums"]:
            raise AssertionError("codec_train_dp2: the two ranks' states differ")
        saved = torch.load(Path(res[0]["checkpoint"]) / "state.pt", map_location="cpu",
                           weights_only=True)
        cfg = yaml_subset.load(CODEC_CONFIG)
        lrs = {w: float(cfg["optimizer"][w]["config"]["lr"]) for w in ("g", "d")}
        mu_rel, worst_mu = {}, {}
        for w in ("g", "d"):
            got_mu = saved["opt_state"][w]["mu"]
            if set(got_mu) != set(want_mu[w]):
                raise AssertionError(f"codec_train_dp2 {w} moments: keys differ")
            diff_sq = ref_sq = 0.0
            for name, m in want_mu[w].items():
                d = got_mu[name].double() - m.double()
                diff_sq += float((d * d).sum())
                ref_sq += float((m.double() ** 2).sum())
                if m.numel():
                    worst_mu[f"{w}.{name}"] = d.abs().max().item() / max(m.abs().max().item(),
                                                                          1e-30)
            mu_rel[w] = math.sqrt(diff_sq / max(ref_sq, 1e-300))
        worst_buf = {}
        for name in buffers:
            w = want[name]
            d = (saved["params"][name].double() - w.double()).abs().max().item() if w.numel() \
                else 0.0
            worst_buf[name] = d / (max(w.abs().max().item(), 1e-30) if w.numel() else 1e-30)
        params = {k: v for k, v in want.items() if k not in buffers}
        lr_sums = {k: lrs["g" if k.startswith("g.") else "d"] * CODEC_DP2_STEPS for k in params}
        stats = _compare_f32_params(saved["params"], params, lr_sums)
        model, discs, _ = ct.build_from_config(cfg)  # the initial weights, drawn on the CPU
        initial = {f"g.{k}": v for k, v in model.state_dict().items()}
        initial.update({f"d.{k}": v for k, v in discs.state_dict().items()})
        control = _compare_f32_params(initial, params, lr_sums)
        del model, discs, initial
        worst_t = max(worst_mu, key=worst_mu.get)
        log(f"codec_train_dp2 against --dp 1: first moments' difference over their norm "
            f"{mu_rel} (limit {CODEC_DP2_MU_RTOL}), worst tensor {worst_t} "
            f"{worst_mu[worst_t]:.3g} of its largest; parameters {stats}; initial weights "
            f"(no-update control) {control}; worst buffer {max(worst_buf.values()):.3g} of its "
            f"size (limit {CODEC_DP2_BUFFER_RTOL})")
        if any(v > CODEC_DP2_MU_RTOL for v in mu_rel.values()):
            raise AssertionError(f"codec_train_dp2 first moments against --dp 1: {mu_rel}")
        bad = {k: v for k, v in worst_buf.items() if v > CODEC_DP2_BUFFER_RTOL}
        if bad:
            raise AssertionError(f"codec_train_dp2 buffers against --dp 1: {bad}")
        if stats["over_bound"] or stats["share_close"] < CODEC_DP2_PARAM_SHARE:
            raise AssertionError(f"codec_train_dp2 parameters against --dp 1: {stats}")
        if control["share_close"] >= CODEC_DP2_PARAM_SHARE:
            raise AssertionError(f"codec_train_dp2: the initial weights pass the parameter test "
                                 f"against the trained ones ({control}): it cannot see an update")
        counts = {k: res[0]["counts"][k] + res[1]["counts"][k] for k in res[0]["counts"]}
        reading = {
            "one_process_step_ms": [round(s["seconds"] * 1e3, 1) for s in one["steps"]],
            "dp2_step_ms_by_rank": [[round(s["seconds"] * 1e3, 1) for s in g["steps"]]
                                    for g in res],
            "peak_gib_by_rank": [round(g["peak_gib"], 2) for g in res],
            **{f"{k}_{tag}": [s[k] for s in steps] for k in ("g_loss", "d_loss")
               for tag, steps in (("dp2", res[0]["steps"]), ("one", one["steps"]))},
            "params": stats, "no_update_control": control, "mu_norm_rel_diff": mu_rel,
            "max_mu_tensor_rel_diff": worst_mu[worst_t],
            "max_buffer_rel_diff": max(worst_buf.values()),
            "one_process_wall_s": round(one_wall, 1), "dp2_wall_s": round(dp2_wall, 1),
            "card": card}
        log(f"codec_train_dp2 ({CODEC_CONFIG}, batch 4 = 2 ranks x 2): step ms by rank "
            f"{reading['dp2_step_ms_by_rank']} against one process "
            f"{reading['one_process_step_ms']} (host clock, data included); peaks "
            f"{reading['peak_gib_by_rank']} GiB; g losses {reading['g_loss_dp2']} vs "
            f"{reading['g_loss_one']}, d losses {reading['d_loss_dp2']} vs "
            f"{reading['d_loss_one']}; first moments {mu_rel} of their norm; parameters "
            f"{stats}, the initial weights (no-update control) {control}; buffers "
            f"{reading['max_buffer_rel_diff']:.3g} of their size; K3 "
            f"{counts['rvq_encode']} launches [{card}]")
        return counts, reading
    finally:
        shutil.rmtree(root, ignore_errors=True)


# K4 at a tensor-parallel rank's shard of the flagship's MLP (H = 8192 / 2)
K4_SHARD_C, K4_SHARD_H, K4_SHARD_ROWS = 2048, 4096, (1, 2)
# tp2_speech_frame: frames of each run, warm-up frames before a timed run
# (from a state of their own), frames of the run that times the
# collectives, and frames after the first under CollectiveLog
TP2_FRAMES = 16
TP2_WARMUP = 2
TP2_SHARE_FRAMES = 8
TP2_LOGGED_FRAMES = 2
# float32 B=1: K1 reads its micro-step input in bf16 (its envelope), so the
# ranks' backbone output, one process's to float32 rounding in another
# summation order (within TP2_HIDDEN_RTOL of its largest magnitude), may
# round an input element to the neighbouring bf16 value and flip an audio
# token where one process's two best logits nearly tie: a flip passes only
# at such a tie (its top-2 gap within TP2_TIE_RTOL of its best logit, the
# rank's token the second), with every token before it equal; the frames
# after it follow another history and are not compared
TP2_HIDDEN_RTOL = 1e-5
TP2_TIE_RTOL = 1e-3


def check_k4_shard(seed: int, card: str) -> dict:
    """K4 at a tensor-parallel rank's MLP shard of the flagship (``C =
    K4_SHARD_C``, ``H = K4_SHARD_H``): ``fc_1``/``fc_2`` ``[H, C]`` and
    ``proj`` ``[C, H]``, N in ``K4_SHARD_ROWS``, over bf16 weights with a
    bf16 x (the bf16 frames) and float32 weights with a float32 x (the
    float32 frames), the output a float32 partial (``out_dtype``, as
    ``Backbone._fused_mlp`` takes it before the sum over ``tensor``);
    against its plain version (``K2_TOL`` of float32), two calls compared
    bit for bit, timed over three weight sets in turn beside its plain
    version and the eager three-GEMM chain in x's dtype. By the kernels
    line's entry name: every N's times and bound."""
    import torch.nn.functional as F

    from rstnet_tpu_torch.ops.cuda_ffn import gating_ffn, gating_ffn_reference

    g = torch.Generator(device="cuda").manual_seed(seed)
    C, H, f32 = K4_SHARD_C, K4_SHARD_H, torch.float32
    out = {}
    for name, wtype in (("gating_ffn", torch.bfloat16), ("gating_ffn_f32_weights", f32)):
        sets = [[((torch.rand(shape, device="cuda", generator=g) * 2 - 1)
                  * shape[1]**-0.5).to(wtype) for shape in ((H, C), (H, C), (C, H))]
                for _ in range(3)]
        err, by_rows = 0.0, {}
        for N in K4_SHARD_ROWS:
            x = torch.randn((N, C), device="cuda", generator=g).to(wtype)
            got = gating_ffn(x, *sets[0], out_dtype=f32)
            again = gating_ffn(x, *sets[0], out_dtype=f32)
            want = gating_ffn_reference(x, *sets[0], out_dtype=f32)
            torch.cuda.synchronize()
            rtol, atol = K2_TOL[f32]
            diff = (got - want).abs()
            bad = int((diff > atol + rtol * want.abs()).sum())
            err = max(err, diff.max().item())
            if bad or got.dtype != f32 or not torch.equal(got, again):
                raise AssertionError(f"K4 shard {name} N={N}: {bad} elements outside rtol={rtol} "
                                     f"atol={atol} (max err {diff.max().item():.3e}), dtype "
                                     f"{got.dtype}, two calls equal: {torch.equal(got, again)}")
            turn = iter(range(1 << 30))
            ms = time_ms(lambda: gating_ffn(x, *sets[next(turn) % 3], out_dtype=f32), 60)
            plain_ms = time_ms(lambda: gating_ffn_reference(x, *sets[next(turn) % 3], f32), 10)

            def chain():
                wg, wv, wo = sets[next(turn) % 3]
                return (F.silu(x @ wg.T) * (x @ wv.T)) @ wo.T

            chain_ms = time_ms(chain, 30)
            wb, xb = sets[0][0].element_size(), x.element_size()
            n_bytes = 3 * wb * H * C + N * C * xb + 4 * N * C
            parts = 1 if wtype == torch.bfloat16 else 2
            lo = int(wtype == f32)
            bound_ms, bound_by = bound(
                n_bytes, 2 * N * (2 * H * C * (parts + lo) + C * H * (2 + lo)), "bf16")
            by_rows[str(N)] = {"ms": ms, "plain_ms": plain_ms, "three_gemm_ms": chain_ms,
                               "bound_ms": bound_ms, "bound_by": bound_by,
                               "weight_mb": 3 * wb * H * C / 1e6}
            log(f"K4 shard shape {name} N={N} x {str(wtype)[6:]} (C={C}, H={H}, float32 "
                f"partial out): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                f"{bound_ms:.4f} ms ({bound_by}, {n_bytes / 1e6:.1f} MB), eager three-GEMM "
                f"chain {chain_ms:.4f} ms; two calls bit-identical [{card}]")
        out[name] = {"C": C, "H": H, "out_dtype": "float32", "max_abs_err": err,
                     "by_rows": by_rows}
        del sets
    torch.cuda.empty_cache()
    return out


def tp2_frames(gen, batch: int, n: int, ring_dtype, warmup: int = TP2_WARMUP) -> tuple:
    """``n`` greedy frames of ``gen`` at ``batch`` from a fresh state, after
    ``warmup`` frames from another: (each frame's tokens, its host ms with
    a synchronize)."""
    if warmup:
        st = gen.init_state(batch, ring_dtype, device="cuda")
        for _ in range(warmup):
            gen.step(st, None)
        del st
    state = gen.init_state(batch, ring_dtype, device="cuda")
    torch.cuda.synchronize()
    tokens, times = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        out, _, state = gen.step(state, None)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1000)
        tokens.append(out[:, :, 0].cpu().tolist())
    return tokens, times


@contextlib.contextmanager
def recorded_steps(model, k1: bool = False):
    """Each ``step_global`` call's (hidden, text logits) inside, float32 on
    the CPU, under ``"steps"`` of the yielded dict; with ``k1``, each K1
    micro-step's two best logits and their ids under ``"k1_top2"``. Every
    record reads back: keep it off timed frames."""
    import rstnet_tpu_torch.inference.generate as gmod

    got, real, real_k1 = {"steps": [], "k1_top2": []}, model.step_global, gmod.depformer_step

    def step_global(*a, **k):
        hidden, logits, state = real(*a, **k)
        got["steps"].append((hidden.float().cpu(), logits.float().cpu()))
        return hidden, logits, state

    def depformer_step(*a, **k):
        logits, kc, vc = real_k1(*a, **k)
        v, i = logits.float().topk(2, dim=-1)
        got["k1_top2"].append((v[0].tolist(), i[0].tolist()))
        return logits, kc, vc

    model.step_global = step_global
    if k1:
        gmod.depformer_step = depformer_step
    try:
        yield got
    finally:
        del model.step_global
        gmod.depformer_step = real_k1


def tp2_b1_agreement(got: list, one: list, hidden: list, one_hidden: list, top2: list,
                     rank: int) -> dict:
    """A rank's float32 B=1 frames against one process's (``TP2_TIE_RTOL``
    above): the frames equal before the first difference, and that
    difference's step, codebook, gap and hidden-state error. Raises unless
    the difference is a K1 near-tie."""
    dep_q = FLAGSHIP["dep_q"]
    for t, (a, b) in enumerate(zip(got, one)):
        if a == b:
            continue
        (row, want), = zip(a, b)  # B=1
        if row[0] != want[0]:
            raise AssertionError(f"tp2_speech_frame rank {rank} float32 B=1 frame {t}: text "
                                 f"token {row[0]}, one process {want[0]}")
        k = next(j for j in range(1, len(row)) if row[j] != want[j]) - 1
        s = t  # frame t holds step t's audio and step t - 1's text (the delays)
        (v1, v2), (i1, i2) = top2[s * dep_q + k]
        h, h1 = hidden[s], one_hidden[s]
        h_err = float((h - h1).abs().max() / h1.abs().max())
        flip = {"frame": t, "step": s, "codebook": k, "tokens": [row[k + 1], want[k + 1]],
                "one_process_top2": [[v1, v2], [i1, i2]], "gap_rel": (v1 - v2) / abs(v1),
                "hidden_rel_err": h_err}
        if (h_err > TP2_HIDDEN_RTOL or (v1 - v2) > TP2_TIE_RTOL * abs(v1)
                or [row[k + 1], want[k + 1]] != [i2, i1]):
            raise AssertionError(f"tp2_speech_frame rank {rank} float32 B=1: tokens part at "
                                 f"frame {t}, not at a K1 near-tie: {flip}")
        return {"equal_frames": t, "flip": flip}
    return {"equal_frames": len(one), "flip": None}


def tp2_expected(n_layer: int, frames: dict) -> dict:
    """A rank's launches of ``tp2_speech_frame`` from the frames each run
    took (warm-ups included): K4 once a layer a frame (float32 weights in
    the float32 runs), K1 once a codebook a frame at B=1, K2 once a
    codebook a codecformer layer a frame at B=2."""
    cf_layers, dep_q = FLAGSHIP["codecformer_layers"], FLAGSHIP["dep_q"]
    none = dict.fromkeys(_counters(), 0)
    return {**none, "gating_ffn_f32_weights": n_layer * (frames["f32_b1"] + frames["f32_b2"]),
            "gating_ffn": n_layer * frames["bf16_b1"],
            "depformer_step": dep_q * (frames["f32_b1"] + frames["bf16_b1"]),
            "gating_ffn_step": dep_q * cf_layers * frames["f32_b2"]}


def tp2_frame_budget(batch: int) -> int:
    """Bytes a flagship frame may move over ``tensor`` = 2 after the first:
    float32 sums of [B, C] (the embedding, and attention's and the MLP's
    row-parallel outputs in every layer) and the gathered [B, V] logits (8
    KV groups divide over 2 ranks: no QKV gather)."""
    C, L, V = FLAGSHIP["n_embd"], FLAGSHIP["n_layer"], FLAGSHIP["padded_vocab_size"]
    return 4 * batch * (C + 2 * L * C + V)


def rank_tp2_frame(job: dict, rank: int, world: int, result_path: Path) -> None:
    """One rank of ``tp2_speech_frame``: the flagship drawn on the card
    from the seed (as one process draws it), placed by ``shard_params`` on
    ``{"tensor": world}``, served by ``LMGen.step`` under ``set_mesh``:
    float32 frames at B=1 (timed; then a run with every collective timed
    between synchronizes, and frames after the first under
    ``CollectiveLog``) and at B=2, then bf16 frames at B=1 (the first
    frame's text logits against one process's)."""
    import torch.distributed as dist

    from rstnet_tpu_torch.inference.generate import LMGen
    from rstnet_tpu_torch.parallel.comm import CollectiveLog
    from rstnet_tpu_torch.parallel.mesh import make_mesh, set_mesh
    from rstnet_tpu_torch.parallel.sharding import shard_params

    # a CUDA device mesh: gloo's default would be the CPU, and DTensor.from_local
    # moves a local shard to its mesh's device
    mesh = make_mesh({"tensor": world}, device_type="cuda")
    delays = (0,) + (1,) * FLAGSHIP["n_q"]
    budget = {b: tp2_frame_budget(b) for b in (1, 2)}
    out, frames = {}, {}
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    model = shard_params(mesh, build_flagship(job["seed"], torch.float32))
    gen = LMGen(model, delays=delays, use_sampling=False)
    log(f"rank {rank}: the float32 flagship placed on {mesh}")
    with set_mesh(mesh):
        out["f32_b1"] = tp2_frames(gen, 1, TP2_FRAMES, torch.float32)
        with recorded_steps(model) as rec:
            tokens, _ = tp2_frames(gen, 1, TP2_FRAMES, torch.float32, warmup=0)
        if tokens != out["f32_b1"][0]:
            raise AssertionError(f"rank {rank}: two float32 B=1 runs gave other tokens")
        torch.save([h for h, _ in rec["steps"]], Path(job["root"]) / f"hidden{rank}.pt")
        log(f"rank {rank}: float32 B=1 frames done")
        # every collective between synchronizes, after a barrier: its own
        # share of the frame, and the barrier's (the wait for the other rank)
        coll_s, wait_s = [], []
        real = {n: getattr(dist, n) for n in ("all_reduce", "all_gather")}

        def timed(fn):
            def run(*a, **k):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                dist.barrier()
                t1 = time.perf_counter()
                r = fn(*a, **k)
                torch.cuda.synchronize()
                wait_s.append(t1 - t0)
                coll_s.append(time.perf_counter() - t1)
                return r
            return run

        for n, fn in real.items():
            setattr(dist, n, timed(fn))
        try:
            _, share_ms = tp2_frames(gen, 1, TP2_SHARE_FRAMES, torch.float32, warmup=0)
        finally:
            for n, fn in real.items():
                setattr(dist, n, fn)
        out["collective_ms"] = sum(coll_s) * 1e3
        out["barrier_ms"] = sum(wait_s) * 1e3
        out["collectives"] = len(coll_s)
        out["share_frames_ms"] = sum(share_ms)
        # what a frame after the first moves
        state = gen.init_state(1, torch.float32, device="cuda")
        gen.step(state, None)
        logged = []
        for _ in range(TP2_LOGGED_FRAMES):
            with CollectiveLog() as clog:
                gen.step(state, None)
            logged.append(clog.calls)
        del state
        moved = [sum(b for _, b in calls) for calls in logged]
        ops = sorted({op for calls in logged for op, _ in calls})
        out["frame_bytes"], out["frame_ops"] = moved, ops
        if max(moved) > budget[1] or not set(ops) <= {"allreduce_", "allgather_"}:
            raise AssertionError(f"rank {rank}: a frame after the first moved {moved} bytes "
                                 f"by {ops}, over its sums and logits gather ({budget[1]})")
        frames["f32_b1"] = (TP2_WARMUP + 2 * TP2_FRAMES + TP2_SHARE_FRAMES + 1
                            + TP2_LOGGED_FRAMES)
        out["f32_b2"] = tp2_frames(gen, 2, TP2_FRAMES, torch.float32)
        frames["f32_b2"] = TP2_WARMUP + TP2_FRAMES
        out["f32_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        del gen, model
        gc.collect()
        torch.cuda.empty_cache()
        model = shard_params(mesh, build_flagship(job["seed"]))
        gen = LMGen(model, delays=delays, use_sampling=False)
        with recorded_steps(model) as rec:
            out["bf16_b1"] = tp2_frames(gen, 1, TP2_FRAMES, torch.bfloat16, warmup=0)
        frames["bf16_b1"] = TP2_FRAMES
        want = torch.load(Path(job["root"]) / "bf16_logits.pt")
        got = rec["steps"][0][1]
        out["bf16_logit_rel_err"] = float(torch.linalg.vector_norm(got - want)
                                          / torch.linalg.vector_norm(want))
        out["bf16_warm"] = tp2_frames(gen, 1, TP2_FRAMES, torch.bfloat16)
        frames["bf16_b1"] += TP2_WARMUP + TP2_FRAMES
    out["counts"], out["expected"] = read_counts(), tp2_expected(FLAGSHIP["n_layer"], frames)
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    result_path.write_text(json.dumps(out))


def run_tp2_speech_frame(seed: int, card: str) -> tuple[dict, dict]:
    """Path ``tp2_speech_frame``: one process's frames of the flagship
    (float32 at B=1 and B=2, bf16 at B=1, greedy, timed), then the same as
    two ranks over ``{"tensor": 2}`` (``rank_tp2_frame``), held to them.
    Returns (both ranks' launches summed, the readings)."""
    from rstnet_tpu_torch.inference.generate import LMGen

    root = Path(tempfile.mkdtemp(prefix="smoke_tp2_"))
    try:
        delays = (0,) + (1,) * FLAGSHIP["n_q"]
        one = {}
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        model = build_flagship(seed, torch.float32)
        gen = LMGen(model, delays=delays, use_sampling=False)
        one["f32_b1"] = tp2_frames(gen, 1, TP2_FRAMES, torch.float32)
        with recorded_steps(model, k1=True) as rec:
            tokens, _ = tp2_frames(gen, 1, TP2_FRAMES, torch.float32, warmup=0)
        if tokens != one["f32_b1"][0]:
            raise AssertionError("tp2_speech_frame: two one-process float32 runs differ")
        one_hidden, top2 = [h for h, _ in rec["steps"]], rec["k1_top2"]
        one["f32_b2"] = tp2_frames(gen, 2, TP2_FRAMES, torch.float32)
        one["f32_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        del gen, model
        gc.collect()
        torch.cuda.empty_cache()
        model = build_flagship(seed)
        gen = LMGen(model, delays=delays, use_sampling=False)
        with recorded_steps(model) as rec:
            one["bf16_b1"] = tp2_frames(gen, 1, TP2_FRAMES, torch.bfloat16, warmup=0)
        one["bf16_warm"] = tp2_frames(gen, 1, TP2_FRAMES, torch.bfloat16)
        torch.save(rec["steps"][0][1], root / "bf16_logits.pt")
        del gen, model
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ranks = spawn_ranks({"kind": "tp2_frame", "seed": seed, "root": str(root)})
        wall = time.perf_counter() - t0
        res = [r for _, r, _ in ranks]
        agree, b1 = [], []
        for r, got in enumerate(res):
            for t, (a, b) in enumerate(zip(got["f32_b2"][0], one["f32_b2"][0])):
                if a != b:
                    raise AssertionError(f"tp2_speech_frame rank {r} float32 B=2 frame {t}: "
                                         f"tokens {a}, one process {b}")
            b1.append(tp2_b1_agreement(got["f32_b1"][0], one["f32_b1"][0],
                                       torch.load(root / f"hidden{r}.pt"), one_hidden, top2, r))
            if got["bf16_logit_rel_err"] > SLICE_LOGIT_TOL:
                raise AssertionError(f"tp2_speech_frame rank {r}: bf16 first-frame logits "
                                     f"{got['bf16_logit_rel_err']:.3e} of their norm from one "
                                     f"process's (> {SLICE_LOGIT_TOL})")
            counts = {k: v for k, v in got["counts"].items() if v}
            expected = {k: v for k, v in got["expected"].items() if v}
            if counts != expected:
                raise AssertionError(f"tp2_speech_frame rank {r}: launches {counts}, expected "
                                     f"{expected}")
            agree.append(sum(a == b for a, b in zip(got["bf16_b1"][0], one["bf16_b1"][0])))
        counts = {k: res[0]["counts"][k] + res[1]["counts"][k] for k in res[0]["counts"]}

        def pct(times):
            ts = sorted(times)
            return {"p50": ts[len(ts) // 2], "p99": ts[min(len(ts) - 1, int(0.99 * len(ts)))]}

        reading = {
            "one_process_ms": {run: pct(one[run][1]) for run in ("f32_b1", "f32_b2", "bf16_warm")},
            "tp2_ms_by_rank": [{run: pct(g[run][1]) for run in ("f32_b1", "f32_b2", "bf16_warm")}
                               for g in res],
            "collective_share_by_rank": [g["collective_ms"] / g["share_frames_ms"] for g in res],
            "barrier_share_by_rank": [g["barrier_ms"] / g["share_frames_ms"] for g in res],
            "instrumented_frame_ms_by_rank": [g["share_frames_ms"] / TP2_SHARE_FRAMES
                                              for g in res],
            "collectives_a_frame": [g["collectives"] / TP2_SHARE_FRAMES for g in res],
            "f32_b1_by_rank": b1,
            "frame_bytes_by_rank": [g["frame_bytes"] for g in res],
            "frame_budget_bytes": tp2_frame_budget(1),
            "bf16_logit_rel_err_by_rank": [g["bf16_logit_rel_err"] for g in res],
            "bf16_tokens_agree_frames": agree, "bf16_frames": TP2_FRAMES,
            "peak_gib_by_rank": [round(g["peak_gib"], 2) for g in res],
            "f32_peak_gib_by_rank": [round(g["f32_peak_gib"], 2) for g in res],
            "one_process_f32_peak_gib": round(one["f32_peak_gib"], 2),
            "ranks_wall_s": round(wall, 1), "card": card}
        log(f"tp2_speech_frame: the flagship (full width) as 2 ranks over tensor=2 on one card "
            f"(gloo); float32 tokens equal to one process's over {TP2_FRAMES} frames at B=2 "
            f"on both ranks, at B=1 {b1}; frame ms (host clock, synchronized) one process "
            f"{reading['one_process_ms']}, by rank {reading['tp2_ms_by_rank']}; collectives "
            f"{reading['collectives_a_frame']} a frame, "
            f"{[round(100 * x, 1) for x in reading['collective_share_by_rank']]} % of an "
            f"instrumented float32 B=1 frame ({reading['instrumented_frame_ms_by_rank']} ms; "
            f"each collective timed between synchronizes after a barrier, the barriers "
            f"{[round(100 * x, 1) for x in reading['barrier_share_by_rank']]} %); bytes a "
            f"frame after the "
            f"first {reading['frame_bytes_by_rank']} (budget {reading['frame_budget_bytes']}); "
            f"bf16 first-frame logits {reading['bf16_logit_rel_err_by_rank']} of their norm, "
            f"tokens agree on {agree} of {TP2_FRAMES} frames; peaks "
            f"{reading['peak_gib_by_rank']} GiB (float32 part {reading['f32_peak_gib_by_rank']}, "
            f"one process {reading['one_process_f32_peak_gib']}); launches {counts} [{card}]")
        return counts, reading
    finally:
        shutil.rmtree(root, ignore_errors=True)


def run_parallel_phases(args, card: str, paths: dict) -> dict:
    """The probe, the two data-parallel paths, K4 at the tensor-parallel
    shard shape and the tensor-parallel frame; ``paths`` gets the paths'
    launches (both ranks'). Returns the readings."""
    out = {}
    gc.collect()
    # the earlier paths leave tens of GiB of freed host heap in this
    # process (checkpoint_solo_frame's peak RSS is ~54 GiB): hand it back
    # before the ranks stage their gradients and checkpoints in host memory
    import ctypes

    ctypes.CDLL("libc.so.6").malloc_trim(0)
    log(f"parallel: host RSS {_rss_gib():.1f} GiB before the ranks start")
    with phase("parallel probe"):
        out["probe"] = probe_collectives(card)
    with phase("train dp2 llama1b"):
        gc.collect()
        torch.cuda.empty_cache()
        paths["train_dp2_llama1b"], out["train_dp2_llama1b"] = run_train_dp2(args.seed, card)
    with phase("codec train dp2"):
        gc.collect()
        torch.cuda.empty_cache()
        paths["codec_train_dp2"], out["codec_train_dp2"] = run_codec_dp2(args.seed, card)
    with phase("k4 shard shape"):
        out["k4_shard_shape"] = check_k4_shard(args.seed, card)
    with phase("tp2 speech frame"):
        gc.collect()
        torch.cuda.empty_cache()
        paths["tp2_speech_frame"], out["tp2_speech_frame"] = run_tp2_speech_frame(args.seed,
                                                                                   card)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--frames", type=int, default=16,
                        help="frames of the solo slices and ticks of the batched ones")
    parser.add_argument("--sessions", type=int, default=16)
    parser.add_argument("--trees", default="",
                        help="checkout roots, comma-separated: time K4 over float32 weights in "
                        "each in turn (compare_trees) instead of the smoke run")
    parser.add_argument("--out", default="", help="with --trees: the times as JSON")
    parser.add_argument("--k4-f32-out", default="",
                        help="run only K4 over float32 weights and write its entry here as JSON")
    parser.add_argument("--codec-only", action="store_true",
                        help="run only K3's checks and the codec training phases, and print "
                        "their findings (no result line)")
    parser.add_argument("--ssl-only", action="store_true",
                        help="run only the GLM-4-Voice SSL paths, and print their findings "
                        "(no result line)")
    parser.add_argument("--prep-only", action="store_true",
                        help="run only the data-prep paths (the duplex client over a socket, "
                        "solo and batched, and the pretraining and moshi_ft recipes), and print "
                        "their findings (no result line)")
    parser.add_argument("--parallel-only", action="store_true",
                        help="run only the parallel phase (the probe of gloo and NCCL on the "
                        "card, paths train_dp2_llama1b and codec_train_dp2), and print their "
                        "findings (no result line)")
    parser.add_argument("--k6-only", action="store_true",
                        help="run only K6's checks and times (every head dim and dtype), and "
                        "print their kernels entries (no result line)")
    parser.add_argument("--rank-job", default="", help=argparse.SUPPRESS)
    parser.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    parser.add_argument("--world", type=int, default=1, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.rank_job:
        return run_rank_job(args.rank_job, args.rank, args.world)
    if args.trees:
        return compare_trees(args.trees.split(","), args.seed, args.out)
    if args.k4_f32_out:
        card = phase_environment()
        phase_build()
        g = torch.Generator(device="cuda").manual_seed(args.seed)
        (entry,) = check_k4_k5(g, card, only=("gating_ffn_f32_weights",))
        Path(args.k4_f32_out).write_text(json.dumps(entry))
        return 0
    t_start = time.perf_counter()
    if args.k6_only:
        card = phase_environment()
        phase_build()
        g = torch.Generator(device="cuda").manual_seed(args.seed)
        log(json.dumps({"kernels": check_k6(g, card)}))
        log(f"chip_smoke --k6-only: {time.perf_counter() - t_start:.1f} s wall")
        return 0
    if args.ssl_only:
        card = phase_environment()
        log(json.dumps({"ssl_paths": run_ssl_phases(args, card)}))
        log(f"chip_smoke --ssl-only: {time.perf_counter() - t_start:.1f} s wall")
        return 0
    if args.prep_only:
        card = phase_environment()
        phase_build()
        paths = {}
        log(json.dumps({"prep_paths": run_prep_phases(args, card, paths)}))
        log(json.dumps({"launches_by_path": {p: {k: v for k, v in c.items() if v}
                                             for p, c in paths.items()}}))
        log(f"chip_smoke --prep-only: {time.perf_counter() - t_start:.1f} s wall")
        return 0
    if args.parallel_only:
        card = phase_environment()
        phase_build()
        paths = {}
        log(json.dumps({"parallel_paths": run_parallel_phases(args, card, paths)}))
        log(json.dumps({"launches_by_path": {p: {k: v for k, v in c.items() if v}
                                             for p, c in paths.items()}}))
        log(f"chip_smoke --parallel-only: {time.perf_counter() - t_start:.1f} s wall")
        return 0
    if args.codec_only:
        card = phase_environment()
        phase_build()
        g = torch.Generator(device="cuda").manual_seed(args.seed)
        k3 = check_k3(g, card, args.sessions)
        paths = {}
        run_codec_phases(args, card, paths)
        k3["launches_by_path"] = {p: counts["rvq_encode"] for p, counts in paths.items()}
        log(json.dumps({"kernels": [k3]}))
        log(f"chip_smoke --codec-only: {time.perf_counter() - t_start:.1f} s wall")
        return 0

    with phase("environment"):
        card = phase_environment()
    with phase("build"):
        phase_build()
    g = torch.Generator(device="cuda").manual_seed(args.seed)
    with phase("kernels"):
        kernels = [check_k1(g, card), check_k1(g, card, int8=True),
                   check_k2(g, card, args.sessions), check_k3(g, card, args.sessions),
                   *check_k6(g, card), *check_k4_k5(g, card)]
        check_graph_launches(g, card)
    with phase("small slices"):
        check_small_slice(args.seed)
        check_small_slice(args.seed, int8=True)
        check_small_batched_slice(args.seed)
        check_small_speech_slice(args.seed)
    paths = {}
    with phase("codec"):
        mimi = build_mimi(args.seed)
        check_codec_centroids(mimi, args.seed, card)
        none = dict.fromkeys(_counters(), 0)
        paths["codec_encode"] = run_codec_encode(mimi, args.seed, card,
                                                 {**none, "rvq_encode": 2})
        del mimi
        gc.collect()
        torch.cuda.empty_cache()
    run_codec_phases(args, card, paths)
    with phase("small training slice"):
        paths["small_train_step_f32"] = check_small_training_slice(args.seed)
        paths["small_train_step_f32_d128"] = check_small_training_slice(args.seed, SMALL_LM_D128)
    with phase("full models"):
        mimi, lm_gen = build_full_models(args.seed)
    n, ticks = args.frames, args.frames
    layers = lm_gen.model.depformer.num_layers
    none = dict.fromkeys(_counters(), 0)
    with phase("full solo slice"):
        paths["solo_frame"] = run_full_slice(
            mimi, lm_gen, args.seed, n, card, "full solo slice",
            {**none, "depformer_step": 8 * n, "rvq_encode": 2 * n})
    with phase("full batched slice"):
        paths["batched_tick"] = run_full_batched_slice(
            mimi, lm_gen, args.seed, args.sessions, ticks, card, "full batched slice",
            {**none, "gating_ffn_step": 8 * layers * ticks, "rvq_encode": 2 * ticks})
    graphs = {}
    with phase("full solo graph"):
        paths["solo_frame_graph"], paths["solo_scan_4"] = run_graph_solo(
            mimi, lm_gen, args.seed, n, 4, card, graphs)
    with phase("full batched graph"):
        paths["batched_tick_graph"] = run_graph_batched(
            mimi, lm_gen, args.seed, args.sessions, ticks, card, "batched_tick_graph",
            {"gating_ffn_step": 8 * layers, "rvq_encode": 2}, graphs)
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
    with phase("full int8 solo graph"):
        paths["solo_frame_int8_graph"], paths["solo_scan_4_int8"] = run_graph_solo(
            mimi, lm_int8, args.seed, n, 4, card, graphs,
            names=("solo_frame_int8_graph", "solo_scan_4_int8"), dep="depformer_step_int8")
    with phase("full int8 batched graph"):
        paths["batched_tick_int8_graph"] = run_graph_batched(
            mimi, lm_int8, args.seed, args.sessions, ticks, card, "batched_tick_int8_graph",
            {"rvq_encode": 2}, graphs)
    del mimi, lm_gen, lm_int8  # free the card for the checkpoint paths and the speech LM
    ckpt_root = Path(tempfile.mkdtemp(prefix="smoke_checkpoints_"))
    try:
        return run_from_checkpoints(args, card, kernels, paths, graphs, ckpt_root, n, t_start)
    finally:
        shutil.rmtree(ckpt_root, ignore_errors=True)


def run_from_checkpoints(args, card: str, kernels: list, paths: dict, graphs: dict,
                         ckpt_root: Path, n: int, t_start: float) -> int:
    """The rest of ``main`` from the checkpoint paths on; the Mimi file
    under ``ckpt_root`` serves ``checkpoint_solo_frame``, ``mimi_tokenize``
    and the ``speech_cli`` path's wavs."""
    none = dict.fromkeys(_counters(), 0)
    with phase("checkpoint solo frame"):
        gc.collect()
        torch.cuda.empty_cache()
        mimi_file = write_mimi_file(ckpt_root, args.seed)
        gc.collect()
        torch.cuda.empty_cache()
        paths["checkpoint_solo_frame"], paths["checkpoint_scan_4"] = run_checkpoint_solo_frame(
            ckpt_root, mimi_file, args.seed, n, card, graphs)
    with phase("mimi tokenize"):
        gc.collect()
        torch.cuda.empty_cache()
        paths["mimi_tokenize"] = run_mimi_tokenize(ckpt_root, mimi_file, args.seed, card)
    with phase("flagship"):
        from rstnet_tpu_torch.models.lm import (
            quantize_dep_for_serving,
            quantize_for_serving as quantize_speech_lm,
            quantize_head_for_serving,
        )

        gc.collect()
        torch.cuda.empty_cache()
        flagship = build_flagship(args.seed)
        L = flagship.config.n_layer
    with phase("flagship bf16 frames"):
        paths["speech_frame"] = run_speech_slice(
            flagship, args.seed, n, card, "speech_frame (bf16)",
            {**none, "gating_ffn": L * n, "depformer_step": 8 * n})
    with phase("flagship graph frames"):
        paths["speech_frame_graph"] = run_speech_graph(flagship, args.seed, n, card, graphs)
    with phase("speech batched tick"):
        mimi24 = build_mimi(args.seed)
        for sessions in (16, 64):
            paths[f"speech_batched_tick_{sessions}"] = run_speech_batched_tick(
                mimi24, flagship, args.seed, sessions, 8, card,
                f"speech_batched_tick_{sessions} (bf16, --kv-int8)")
    with phase("speech batched tick graph"):
        from rstnet_tpu_torch.inference.generate import LMGen

        speech_gen = LMGen(flagship, delays=(0,) + (1,) * flagship.config.n_q, kv_int8=True,
                           kv_unstacked=True)
        paths["speech_batched_tick_16_graph"] = run_graph_batched(
            mimi24, speech_gen, args.seed, 16, 8, card, "speech_batched_tick_16_graph",
            {k: v for k, v in speech_tick_expected(flagship, 1).items() if v}, graphs)
        del mimi24, speech_gen
    with phase("flagship head-int8 frames"):
        quantize_head_for_serving(flagship)
        paths["speech_frame_head_int8"] = run_speech_slice(
            flagship, args.seed, n, card, "speech_frame_head_int8",
            {**none, "gating_ffn": L * n, "depformer_step": 8 * n})
    with phase("flagship mixed-int8 frames"):
        quantize_dep_for_serving(flagship)
        paths["speech_frame_mixed_int8"] = run_speech_slice(
            flagship, args.seed, n, card, "speech_frame_mixed_int8 (int8 head and depformer)",
            {**none, "gating_ffn": L * n, "depformer_step_int8": 8 * n})
    with phase("flagship int8 frames"):
        quantize_speech_lm(flagship)
        paths["speech_frame_int8"] = run_speech_slice(
            flagship, args.seed, n, card, "speech_frame_int8 (quantize_for_serving, int8 ring)",
            {**none, "gating_ffn_int8": L * n, "depformer_step_int8": 8 * n}, kv_int8=True)
    del flagship  # free the card for training
    with phase("full training slice"):
        paths["train_step"], paths["speech_cli"], bf16_steps = run_full_training_slice(
            args.seed, TRAIN_STEPS, card, mimi_checkpoint=mimi_file)
    with phase("float32 training slice"):
        gc.collect()
        torch.cuda.empty_cache()
        paths["train_step_f32"], paths["speech_cli_f32"] = run_f32_training_slice(
            args.seed, TRAIN_STEPS, card, bf16_steps)
    with phase("train from litgpt"):
        gc.collect()
        torch.cuda.empty_cache()
        paths["train_from_litgpt"] = run_train_from_litgpt(args.seed, card)
    with phase("qwen7b peft"):
        gc.collect()
        torch.cuda.empty_cache()
        paths["train_qwen7b_peft"] = run_train_qwen7b_peft(args.seed, card)
    with phase("qwen7b peft float32"):
        gc.collect()
        torch.cuda.empty_cache()
        paths["train_qwen7b_peft_f32"] = run_train_qwen7b_peft_f32(args.seed, card)
    with phase("moshi7b lora"):
        gc.collect()
        torch.cuda.empty_cache()
        paths["train_moshi7b_lora"] = run_train_moshi7b_lora(args.seed, card)
    with phase("moe small"):
        paths["moe_small"] = check_moe_small(args.seed, card)
    # last, so that every earlier path runs as it did before the SSL paths
    log(json.dumps({"ssl_paths": run_ssl_phases(args, card)}))
    # after every earlier path, so that each runs as it did before them
    log(json.dumps({"prep_paths": run_prep_phases(args, card, paths)}))
    # last: two ranks on the card, after every earlier path's peak
    parallel = run_parallel_phases(args, card, paths)
    log(json.dumps({"parallel_paths": parallel}))
    for k in kernels:
        if k["name"] in parallel["k4_shard_shape"]:
            k["shard_shape"] = parallel["k4_shard_shape"][k["name"]]
        # a graph path's are its device launches: its eager warm-up call's
        # and its replays' (graph_launches)
        k["launches_by_path"] = {p: counts[k["name"]] for p, counts in paths.items()}
        k["launches"] = sum(k["launches_by_path"].values())
        # a graph path's launches of one replay, counted by the profiler
        k["replay_launches_by_path"] = {
            p: rec["replay_launches"].get(k["name"], 0) for p, rec in graphs.items()
            if rec["replay_launches"].get(k["name"], 0)}
    log(json.dumps({"graph_paths": graphs}))
    from rstnet_tpu_torch.tools.profile_frame import window_stats

    log(f"device_trace: {window_stats()}")
    log(f"chip_smoke total: {time.perf_counter() - t_start:.1f} s wall")
    log(json.dumps({"kernels": kernels}))
    log(card_line())
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
