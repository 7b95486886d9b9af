"""LM evaluation CLI: teacher-forced perplexity over a data manifest
(counterpart of ``rstnet_tpu/evalsuite/lm_eval.py``):

    python -m rstnet_tpu_torch.evalsuite.lm_eval --checkpoint_dir EXP --data_jsons 'data/*.json' \\
        [--output ppl.json] [--device cpu]

It rebuilds the trained model from the experiment's ``train_args.yaml``
through the trainer's ``build_model`` (or from ``--model_config``), loads the
newest checkpoint's params, and reports audio and text CE, perplexity and
accuracy, each batch weighted by its valid-token count. It takes the JAX
CLI's flags plus ``--device`` (``cuda`` unless ``cpu`` is given).
"""

from __future__ import annotations

import argparse
import json
import logging
import math
import os

import torch

from rstnet_tpu_torch.data.dataloader import build_data_iterator, find_data_jsons
from rstnet_tpu_torch.data.task_definition import load_data_for_all_tasks
from rstnet_tpu_torch.inference.offline import OfflineInference
from rstnet_tpu_torch.models.config import Config, read_flat_yaml
from rstnet_tpu_torch.models.lm import SpeechTextLM
from rstnet_tpu_torch.training import trainer
from rstnet_tpu_torch.training.checkpoint import latest_checkpoint, restore_checkpoint


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--model_config", default="",
                        help="optional; defaults to the exp dir's saved config")
    parser.add_argument("--checkpoint_dir", default="", help="trainer exp dir")
    parser.add_argument("--data_jsons", required=True)
    parser.add_argument("--batch_scale", type=int, default=1000)
    parser.add_argument("--max_length", type=int, default=1000)
    parser.add_argument("--parallel_number", type=int, default=9)
    parser.add_argument("--output", default="")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on: cuda (default), cuda:N or cpu")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, force=True)
    device = trainer.resolve_device(args.device)

    train_args = os.path.join(args.checkpoint_dir, "train_args.yaml")
    if args.checkpoint_dir and os.path.isfile(train_args):
        # rebuild exactly the trained model (its config and CLI overrides)
        saved = read_flat_yaml(train_args)
        if args.model_config:
            saved["model_config"] = args.model_config
        dtype = torch.bfloat16 if saved["dtype"] == "bfloat16" else torch.float32
        model = trainer.build_model(argparse.Namespace(**saved), device, dtype)
    else:
        model = SpeechTextLM(Config.from_file(args.model_config), device=device,
                             generator=torch.Generator(device=device).manual_seed(0))
    if args.checkpoint_dir:
        ckpt = latest_checkpoint(args.checkpoint_dir)
        if ckpt is None:
            raise SystemExit(f"no checkpoint in {args.checkpoint_dir}")
        restore_checkpoint(ckpt, {"model": model}, partial=True)  # the params only

    data_dict, text_dict = load_data_for_all_tasks(find_data_jsons(args.data_jsons))
    it = build_data_iterator(data_dict, text_dict, {"audio": trainer.StoredTokens(),
                                                    "text": trainer.StoredTokens()},
                             batch_scale=args.batch_scale, max_length=args.max_length,
                             parallel_number=args.parallel_number, is_train=False)
    inf = OfflineInference(model)
    # corpus-level aggregation: every batch weighted by its valid-token count,
    # and the perplexities the exp of the aggregated CE
    wsum: dict[str, float] = {}
    n_audio = n_text = 0.0
    n = 0
    for batch in it:
        m = inf.teacher_forced_metrics(batch["tokens"], batch["masks"])
        na, nt = m["n_audio_tokens"], m["n_text_tokens"]
        for k, w in (("loss_audio", na), ("acc_audio", na), ("loss_text", nt),
                     ("acc_text", nt)):
            wsum[k] = wsum.get(k, 0.0) + m[k] * w
        n_audio += na
        n_text += nt
        n += 1
    report = {
        "loss_audio": wsum.get("loss_audio", 0.0) / max(n_audio, 1.0),
        "acc_audio": wsum.get("acc_audio", 0.0) / max(n_audio, 1.0),
        "loss_text": wsum.get("loss_text", 0.0) / max(n_text, 1.0),
        "acc_text": wsum.get("acc_text", 0.0) / max(n_text, 1.0),
    }
    report["ppl_audio"] = math.exp(report["loss_audio"] / model.config.dep_q)
    report["ppl_text"] = math.exp(report["loss_text"])
    report["n_batches"] = n
    report["n_audio_tokens"] = n_audio
    report["n_text_tokens"] = n_text
    print(json.dumps(report, indent=2))
    if args.output:
        with open(args.output, "w") as f:
            json.dump(report, f, indent=2)
    return report


if __name__ == "__main__":
    main()
