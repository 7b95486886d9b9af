"""Trainer CLI arguments (counterpart of ``rstnet_tpu/utils/arguments.py``,
copied with the same flags and defaults, plus ``--device``)."""

from __future__ import annotations

import argparse


def str2bool(v) -> bool:
    if isinstance(v, bool):
        return v
    return str(v).lower() in ("yes", "true", "t", "1")


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="rstnet_tpu_torch trainer")
    # data
    p.add_argument("--train_data_jsons", type=str, default="", help="comma-separated globs")
    p.add_argument("--valid_data_jsons", type=str, default="")
    p.add_argument("--batch_scale", type=int, default=2500, help="summed tokens per batch")
    p.add_argument("--max_length", type=int, default=1000)
    p.add_argument("--min_length", type=int, default=-1)
    p.add_argument("--parallel_number", type=int, default=9, choices=[9, 17])
    p.add_argument("--minibatch_debug", type=int, default=-1)
    p.add_argument("--rebalance_alpha", type=float, default=0.0,
                   help="temperature for per-task hour re-weighting "
                        "(0 disables; reference rebalance_data)")
    p.add_argument("--n_worker", type=int, default=4)
    p.add_argument("--audio_tokenizer", type=str, default="mimi")
    p.add_argument("--text_tokenizer", type=str, default="llama3-8B")
    # special token ids (llama3 defaults; pre_training_full.py:113-118)
    p.add_argument("--text_empty_token", type=int, default=128002)
    p.add_argument("--text_pad_token", type=int, default=128003)
    p.add_argument("--semantic_empty_token", type=int, default=2048)
    p.add_argument("--acoustic_empty_token", type=int, default=2048)
    p.add_argument("--semantic_pad_token", type=int, default=2049)
    p.add_argument("--acoustic_pad_token", type=int, default=2049)
    # optimization
    p.add_argument("--global_learning_rate", type=float, default=5e-5)
    p.add_argument("--local_learning_rate", type=float, default=5e-5)
    p.add_argument("--warmup_steps", type=int, default=5000)
    p.add_argument("--grad_accum", type=int, default=1)
    p.add_argument("--grad_clip", type=float, default=-1.0)
    p.add_argument("--skip_nan_updates", type=int, default=0,
                   help=">0: drop up to N consecutive non-finite-grad updates")
    p.add_argument("--weight_decay", type=float, default=1e-3)
    p.add_argument("--n_epoch", type=int, default=10)
    p.add_argument("--seed", type=int, default=999)
    p.add_argument("--dtype", type=str, default="bfloat16")
    # model
    p.add_argument("--model_config", type=str, default="", help="model_config.yaml path")
    p.add_argument("--model_name", type=str, default="", help="registry name alternative")
    p.add_argument("--model_family", type=str, default="flagship",
                   choices=["flagship", "moshi"],
                   help="flagship = pretrained-LLM backbone + codecformer; "
                        "moshi = pure Moshi RQ-Transformer (v1 fine-tuning)")
    p.add_argument("--moshi_dim", type=int, default=4096)
    p.add_argument("--moshi_num_layers", type=int, default=32)
    p.add_argument("--moshi_num_heads", type=int, default=32)
    p.add_argument("--moshi_text_card", type=int, default=32000)
    p.add_argument("--checkpoint_path", type=str, default="", help="litgpt lit_model.pth")
    p.add_argument("--audio_card", type=int, default=2050,
                   help="audio vocab incl. empty/pad specials (2048 codes + 2)")
    p.add_argument("--n_q", type=int, default=8)
    p.add_argument("--dep_q", type=int, default=8)
    p.add_argument("--codecformer_dim", type=int, default=1024)
    p.add_argument("--codecformer_heads", type=int, default=16)
    p.add_argument("--codecformer_layers", type=int, default=6)
    p.add_argument("--codecformer_dim_feedforward", type=int, default=1024)
    # lora
    p.add_argument("--lora_r", type=int, default=0)
    p.add_argument("--lora_alpha", type=int, default=16)
    p.add_argument("--lora_dropout", type=float, default=0.0)
    p.add_argument("--lora_query", type=str2bool, default=True)
    p.add_argument("--lora_key", type=str2bool, default=True)
    p.add_argument("--lora_value", type=str2bool, default=True)
    p.add_argument("--lora_projection", type=str2bool, default=False)
    p.add_argument("--lora_mlp", type=str2bool, default=False)
    p.add_argument("--lora_head", type=str2bool, default=False)
    p.add_argument("--base_int8", type=str2bool, default=False,
                   help="LoRA mode only: store the frozen backbone weights "
                        "as int8 (halves their HBM footprint; the fit-8B-"
                        "LoRA-on-one-16GB-chip switch). Uses the partitioned "
                        "PEFT train step, so checkpoints hold only the "
                        "trainable tree (the reference's lora_filter)")
    p.add_argument("--flash_attention", type=str2bool, default=True,
                   help="flash-attention kernel (K6) in training forwards on a CUDA device")
    p.add_argument("--remat", type=str2bool, default=True,
                   help="rematerialize backbone blocks in training forwards")
    # parallelism (framework extension: explicit mesh shape)
    p.add_argument("--dp", type=int, default=-1, help="data axis size (-1 = infer)")
    p.add_argument("--fsdp", type=int, default=1)
    p.add_argument("--tensor", type=int, default=1)
    p.add_argument("--pipe", type=int, default=1,
                   help="pipeline parallel axis size (layer-stacked blocks "
                        "shard over stages; microbatches flow via ppermute)")
    p.add_argument("--pipeline_microbatches", type=int, default=0,
                   help="microbatch count for the pipeline schedule "
                        "(0 = one per stage)")
    p.add_argument("--seq", type=int, default=1,
                   help="sequence/context parallel axis size (shards long "
                        "sequences over devices; windowed attention exchanges "
                        "boundary KV blocks over ICI)")
    p.add_argument("--expert", type=int, default=1,
                   help="expert parallel axis size (shards MoE expert stacks)")
    # device (the port's own flag): a CUDA device unless the CPU is asked for
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to train on: cuda (default), cuda:N or cpu")
    p.add_argument("--init_on_device", type=str2bool, default=False,
                   help="draw the initial weights on --device instead of the CPU (a 7B "
                        "model in seconds; other values than the CPU's draw from the seed)")
    # experiment
    p.add_argument("--exp_dir", type=str, default="exp/run")
    p.add_argument("--print_freq", type=int, default=100)
    p.add_argument("--save_interval", type=int, default=-1)
    p.add_argument("--keep_last_ckpt", type=int, default=5)
    return p


def get_args(argv=None) -> argparse.Namespace:
    return get_parser().parse_args(argv)
