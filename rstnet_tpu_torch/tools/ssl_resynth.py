"""SSL token resynthesis CLI: semantic tokens -> 22.05 kHz wavs (counterpart
of ``rstnet_tpu/tools/ssl_resynth.py``).

Reads a token shard written by ``offline_tokenization --mode ssl``
(``--tokens``), or a wav scp to round-trip tokenize -> detokenize
(``--scp`` with ``--ssl-checkpoint``), and writes one wav per utterance
through the GLM-4-Voice flow + HiFT decoder (``models/glm4v_decoder.py``):

    python -m rstnet_tpu_torch.tools.ssl_resynth --tokens ssl.npz \\
        --decoder-checkpoint glm-4-voice-decoder --out_dir wavs [--stream] [--device cpu]

Both models run on ``--device`` (``cuda`` unless ``cpu`` is given), in
float32 with TF32 off, as the reference runs.
"""

from __future__ import annotations

import argparse
import logging
import os
from pathlib import Path

import numpy as np
import torch


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--tokens", default="", help=".npz token shard (utt -> [T] int ids)")
    parser.add_argument("--scp", default="",
                        help="wav scp to round-trip tokenize -> detokenize (needs "
                             "--ssl-checkpoint)")
    parser.add_argument("--ssl-checkpoint", default="",
                        help="GLM-4-Voice tokenizer checkpoint dir (only for --scp)")
    parser.add_argument("--decoder-checkpoint", required=True,
                        help="glm-4-voice-decoder dir (config.yaml + flow.pt + hift.pt)")
    parser.add_argument("--out_dir", required=True)
    parser.add_argument("--stream", action="store_true",
                        help="block-streaming synthesis (mel-overlap fades + source cache) "
                             "instead of offline")
    parser.add_argument("--device", default="cuda",
                        help="torch device: cuda (default), cuda:N or cpu")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, force=True)
    if not args.tokens and not args.scp:
        parser.error("one of --tokens / --scp is required")
    if torch.device(args.device).type == "cuda":
        # the reference precision: true fp32 matmuls and convolutions
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    from rstnet_tpu_torch.models import glm4v_decoder
    from rstnet_tpu_torch.utils.audio import write_wav

    decoder = glm4v_decoder.load_glm4v_decoder(args.decoder_checkpoint, device=args.device)
    sr = decoder.hift.config.sampling_rate
    os.makedirs(args.out_dir, exist_ok=True)

    def items():
        if args.tokens:
            shard = np.load(args.tokens)
            for utt in shard.files:
                yield utt, np.asarray(shard[utt], np.int64).reshape(-1)
        else:
            from rstnet_tpu_torch.data.tokenizers.ssl_tokenizer import SSLTokenizer
            from rstnet_tpu_torch.utils.audio import read_wav

            tok = SSLTokenizer(checkpoint=args.ssl_checkpoint, device=args.device)
            with open(args.scp) as fh:
                for line in fh:
                    utt, path = line.strip().split(None, 1)
                    wav, in_sr = read_wav(path)
                    yield utt, tok.tokenize(wav.mean(0), in_sr).astype(np.int64)

    n = 0
    for utt, ids in items():
        if ids.size == 0:
            logging.warning("%s: empty token stream, skipped", utt)
            continue
        token = torch.from_numpy(ids[None])
        wav = (decoder.stream_inference(token) if args.stream
               else decoder.offline_inference(token))
        out = Path(args.out_dir) / f"{utt}.wav"
        write_wav(str(out), wav[0].cpu().numpy(), sr)
        n += 1
        logging.info("%s -> %s (%.2f s)", utt, out, wav.shape[1] / sr)
    logging.info("resynthesized %d utterances", n)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
