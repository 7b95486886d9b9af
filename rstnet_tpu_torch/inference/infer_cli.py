"""Flagship LM inference CLI: prefix-conditioned generation over a data
manifest (counterpart of ``rstnet_tpu/inference/infer_cli.py``):

    python -m rstnet_tpu_torch.inference.infer_cli --exp_dir EXP --data_jsons 'data/*.json' \\
        --output_dir OUT [--task continuation|tts|asr] [--device cpu]

It loads the trainer's experiment (``config.yaml`` and the newest
checkpoint's params, in their saved dtype), runs task-conditioned generation
(continuation, TTS with the text row forced, ASR with the audio rows forced)
through the ring-KV streaming step, undoes the delay pattern and saves each
example's [1 + n_q, T] grid as ``<example id>.npy``. With
``--mimi_checkpoint`` (a kyutai Mimi file) it also decodes each grid's audio
rows, clamped to real codec codes, through ``MimiTokenizer`` and writes
``<example id>.wav``. It takes the JAX CLI's flags plus ``--device``
(``cuda`` unless ``cpu`` is given), which Mimi runs on too.
"""

from __future__ import annotations

import argparse
import logging
import os
from pathlib import Path

import numpy as np
import torch

from rstnet_tpu_torch.data.dataloader import build_data_iterator, find_data_jsons
from rstnet_tpu_torch.data.task_definition import load_data_for_all_tasks
from rstnet_tpu_torch.inference.offline import OfflineInference
from rstnet_tpu_torch.models.config import Config
from rstnet_tpu_torch.models.lm import SpeechTextLM
from rstnet_tpu_torch.training.checkpoint import latest_checkpoint, restore_checkpoint
from rstnet_tpu_torch.training.trainer import StoredTokens, resolve_device
from rstnet_tpu_torch.utils.audio import write_wav


def load_model(config_path: str, exp_dir: str, device: torch.device) -> SpeechTextLM:
    """The model of ``config_path`` with the newest checkpoint's params of
    ``exp_dir`` (params only, in their saved dtype); float32 random weights
    from seed 0 where the experiment has no checkpoint, as in JAX."""
    cfg = Config.from_file(config_path)
    model = SpeechTextLM(cfg, device=device,
                         generator=torch.Generator(device=device).manual_seed(0))
    ckpt = latest_checkpoint(exp_dir)
    if ckpt is not None:
        restore_checkpoint(ckpt, {"model": model}, partial=True)
        logging.info(f"loaded {ckpt}")
    return model


def main(argv=None) -> list[Path]:
    parser = argparse.ArgumentParser()
    parser.add_argument("--exp_dir", required=True, help="trainer experiment dir")
    parser.add_argument("--model_config", default="", help="override config path")
    parser.add_argument("--data_jsons", required=True)
    parser.add_argument("--output_dir", required=True)
    parser.add_argument("--task", default="continuation", choices=["continuation", "tts", "asr"])
    parser.add_argument("--prefix_frames", type=int, default=25)
    parser.add_argument("--max_new_frames", type=int, default=125, help="~10s at 12.5Hz")
    parser.add_argument("--mimi_checkpoint", default="", help="for detokenization")
    parser.add_argument("--max_examples", type=int, default=8)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on: cuda (default), cuda:N or cpu")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, force=True)
    device = resolve_device(args.device)

    model = load_model(args.model_config or f"{args.exp_dir}/config.yaml", args.exp_dir, device)
    cfg = model.config
    data_dict, text_dict = load_data_for_all_tasks(find_data_jsons(args.data_jsons))
    # no length filtering: the prefix is sliced from each grid below
    it = build_data_iterator(data_dict, text_dict, {"audio": StoredTokens(),
                                                    "text": StoredTokens()},
                             batch_scale=10_000, max_length=-1, parallel_number=cfg.n_q + 1,
                             is_train=False)
    inf = OfflineInference(model)
    detok = None
    if args.mimi_checkpoint:
        from rstnet_tpu_torch.data.tokenizers.mimi_tokenizer import MimiTokenizer

        detok = MimiTokenizer(checkpoint_path=args.mimi_checkpoint, device=device)
    os.makedirs(args.output_dir, exist_ok=True)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    written = []
    for batch in it:
        tokens = batch["tokens"]
        for b in range(tokens.shape[0]):
            if len(written) >= args.max_examples:
                break
            grid = tokens[b:b + 1]
            true_len = int(batch["lengths"][b])
            T0 = min(args.prefix_frames, grid.shape[-1])
            forced = None
            if args.task != "continuation":
                forced = np.full(grid.shape, -1, np.int64)
                rows = slice(0, 1) if args.task == "tts" else slice(1, None)
                forced[:, rows] = grid[:, rows]  # tts: the text row; asr: the audio rows
                forced[:, :, true_len:] = -1  # never force the bucket's padding frames
            out = inf.generate(grid[:, :, :T0], args.max_new_frames, generator, forced=forced)
            utt = batch["example_ids"][b]
            result = it.collator.reverse_delay(out[0])
            path = Path(args.output_dir) / f"{utt}.npy"
            np.save(path, result)
            written.append(path)
            if detok is not None:
                # clamp to real codec codes: the empty/pad specials (the top
                # two ids of the audio vocab) are not codebook entries
                codes = np.clip(result[1:], 0, detok.model.quantizer.bins - 1)
                write_wav(str(Path(args.output_dir) / f"{utt}.wav"),
                          detok.detokenize(codes.astype(np.int32)), detok.sr)
        if len(written) >= args.max_examples:
            break
    logging.info(f"generated {len(written)} examples into {args.output_dir}")
    return written


if __name__ == "__main__":
    main()
