"""Codec round trip CLI (counterpart of ``rstnet_tpu/inference/codec_infer.py``):
read the wavs of an scp, encode each clip to codes with the trained codec,
decode, and write paired ``ref/`` and ``deg/`` wavs for the metric suite.

    python -m rstnet_tpu_torch.inference.codec_infer --config egs/codec/mimi24k.yaml \\
        --checkpoint_dir exp/codec --scp data/codec/val.scp --out_dir exp/codec/recon

The codec loads from the newest checkpoint in ``--checkpoint_dir`` (its
parameters and EMA buffers, mapped from the file), or keeps the seeded
weights when there is none. Each clip is one batch of one, padded to a whole
frame: a 4 s clip at 12.5 Hz is one K3 call of 50 rows a quantizer (K3's
split path). ``--device`` is ``cuda`` unless ``cpu`` is given; on the card
TF32 is off, as in training. ``main`` returns the number of clips.
"""

from __future__ import annotations

import argparse
import logging
import os
from pathlib import Path

import numpy as np
import torch

from rstnet_tpu_torch.utils.audio import read_wav, resample_linear, write_wav


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", required=True, help="codec yaml config")
    parser.add_argument("--checkpoint_dir", required=True)
    parser.add_argument("--scp", required=True)
    parser.add_argument("--out_dir", required=True)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, force=True)

    from rstnet_tpu_torch.tools.offline_tokenization import _wav_entries
    from rstnet_tpu_torch.training.checkpoint import latest_checkpoint
    from rstnet_tpu_torch.training.codec_trainer import build_from_config, resolve_device
    from rstnet_tpu_torch.utils import yaml_subset

    device = resolve_device(args.device)
    cfg = yaml_subset.load(args.config)
    model, _, _ = build_from_config(cfg, device)
    ckpt = latest_checkpoint(args.checkpoint_dir)
    if ckpt is not None:
        holder = torch.nn.ModuleDict({"g": model})
        saved = torch.load(Path(ckpt) / "state.pt", map_location="cpu", weights_only=True,
                           mmap=True)["params"]
        own = holder.state_dict()
        holder.load_state_dict({k: v.to(own[k].device) for k, v in saved.items()
                                if k.startswith("g.")})
        logging.info(f"loaded {ckpt}")
    model.eval()

    ref_dir, deg_dir = Path(args.out_dir) / "ref", Path(args.out_dir) / "deg"
    os.makedirs(ref_dir, exist_ok=True)
    os.makedirs(deg_dir, exist_ok=True)
    hop = model.hop_length * model.resample_stride
    n = 0
    for utt, path in _wav_entries(args.scp):
        wav, sr = read_wav(path)
        wav = resample_linear(wav[:1], sr, model.sample_rate)
        T = wav.shape[-1]
        padded = np.pad(wav, ((0, 0), (0, (-T) % hop)))
        audio = torch.from_numpy(padded[None]).to(device)
        codes = model.encode(audio)
        rec = model.decode(codes)[0, 0, :T].float().cpu().numpy()
        write_wav(str(ref_dir / f"{utt}.wav"), wav[0], model.sample_rate)
        write_wav(str(deg_dir / f"{utt}.wav"), rec, model.sample_rate)
        n += 1
    logging.info(f"round-tripped {n} utterances into {args.out_dir}")
    return n


if __name__ == "__main__":
    main()
