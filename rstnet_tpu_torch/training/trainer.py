"""Speech-text LM trainer CLI (counterpart of
``rstnet_tpu/training/trainer.py``):

    python -m rstnet_tpu_torch.training.trainer --model_config configs/llama_1b_speech.yaml \\
        --train_data_jsons 'data/*.json' --max_length 1023 [--device cpu] ...
    python -m rstnet_tpu_torch.training.trainer --model_config configs/qwen_7b_speech.yaml \\
        --lora_r 16 --lora_alpha 32 --base_int8 true --max_length 1023 ...
    python -m rstnet_tpu_torch.training.trainer --model_family moshi --lora_r 16 ...

It takes the JAX CLI's flags and defaults (``utils/arguments.py``) plus
``--device`` (``cuda`` unless ``cpu`` is given). Per epoch, as in JAX: train
with metric reporting, refresh the sampler, validate, save the epoch
checkpoint (and intra-epoch ones every ``--save_interval`` steps); a rerun
resumes from the newest checkpoint in ``--exp_dir``.

Weights are drawn from ``1337 + --seed`` on the CPU, in the training dtype,
and then moved to the device, so every device starts from the same weights;
``--init_on_device`` draws them on the device instead (other values, for
the 7B models, whose CPU draw takes minutes).
Training forwards take the flash kernel K6 when ``--flash_attention`` (the
default) and the device is CUDA, and a batch's bucket length qualifies
(a multiple of 512: ``--max_length 1023`` gives a top bucket of 1024; the
default ``--max_length 1000`` gives none).

``--checkpoint_path`` loads a litgpt checkpoint (``lit_model.pth`` or
``.safetensors``, ``models/convert.py``) into the backbone, cast to the run's
dtype, as the JAX trainer does; the codecformer and the embeddings keep
their seeded weights. With ``--model_family moshi`` it loads a Moshi
checkpoint into the whole model (``convert_moshi_lm``), cast to the run's
dtype.

``--model_family moshi`` trains the pure Moshi RQ-Transformer
(``models/moshi_lm.py``), full parameters or, with ``--lora_r > 0``, LoRA
on the temporal transformer with the depformer side trained whole;
``--remat`` checkpoints its temporal layers (the JAX trainer does not: the
values are the same, the memory is what lets Moshi 7B train on one card).
``--lora_r > 0`` on the speech LM attaches LoRA to the backbone
(``models/lora.py``, factors from seed 7 as in JAX) and trains the factors
and the codecformer side; ``--base_int8`` then quantizes the frozen backbone
to int8 (``quantize_backbone_int8``) and trains through the partitioned
step, whose checkpoints hold only the trainable parameters.
``--lora_dropout`` drops the LoRA branches' inputs, seeded from ``--seed``
and the step.

Refused as the JAX trainer refuses: ``--base_int8`` without LoRA, with the
Moshi family, or with ``--grad_accum > 1``; ``--seq``/``--pipe`` > 1 with the
Moshi family.

Parallel training (``parallel/``): one process a device, started by
``torchrun`` (``RANK``/``WORLD_SIZE``/``MASTER_ADDR``) or by a caller that
joined the default process group first (``initialize_distributed``). The
mesh flags are the JAX trainer's: ``--dp/--fsdp/--tensor/--seq/--pipe/
--expert`` (``--dp -1`` absorbs the ranks the other axes leave), their
product the rank count (JAX's ``make_mesh`` error otherwise); ``--seq`` and
``--pipe`` turn on the config's ``sequence_parallel``/``pipeline_parallel``
and ``--pipeline_microbatches`` sets the schedule's microbatches. Every rank
draws the same weights, ``shard_params`` places them, and each step every
rank of a host reads the host's batch from the data iterator (its ``rank`` is
the host's index, as JAX passes ``jax.process_index()``; the hosts read their
shards of the manifests), pads its rows to a power-of-two multiple of the
host's share of ``data x fsdp`` and its time axis to a multiple of ``seq``
(zero loss mask), and takes its part (``batch_slice``). Rank 0
writes the configs and the checkpoints (gathered whole) and logs to
``logs/rank0.log``; rank r logs to ``logs/rank{r}.log``.

``main`` returns the train steps' records (one dict a step: epoch, batch
shape, metrics, lr, step time) and the saved checkpoints with their save
times.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import sys
import time
from typing import Optional

import numpy as np
import torch
from torch import nn

from rstnet_tpu_torch.data.collate import SpecialTokens
from rstnet_tpu_torch.data.dataloader import build_data_iterator, find_data_jsons
from rstnet_tpu_torch.data.task_definition import load_data_for_all_tasks
from rstnet_tpu_torch.data.tokenizers.abs_tokenizer import AbsTokenizer
from rstnet_tpu_torch.models.backbone import quantize_backbone_int8
from rstnet_tpu_torch.models.config import Config, write_flat_yaml
from rstnet_tpu_torch.models.lm import SpeechTextLM
from rstnet_tpu_torch.models.lora import (
    attach_lora,
    init_lora,
    init_lora_streaming_transformer,
    lora_trainable_mask,
)
from rstnet_tpu_torch.models.moshi_lm import MoshiLMModel
from rstnet_tpu_torch.parallel.mesh import (
    Mesh,
    host_index,
    initialize_distributed,
    local_device,
    make_mesh,
    set_mesh,
    world_rank,
    world_size,
)
from rstnet_tpu_torch.parallel.sharding import batch_slice, shard_params
from rstnet_tpu_torch.training.checkpoint import maybe_resume, save_checkpoint
from rstnet_tpu_torch.training.schedulers import warmup_lr
from rstnet_tpu_torch.training.train_step import (
    init_train_state,
    make_eval_step,
    make_grad_accum_steps,
    make_loss_fn,
    make_optimizer,
    make_peft_train_step,
    make_train_step,
    partition_params,
)
from rstnet_tpu_torch.utils.arguments import get_args
from rstnet_tpu_torch.utils.reporter import Reporter


def setup_logging(exp_dir: str, rank: int = 0) -> None:
    os.makedirs(f"{exp_dir}/logs", exist_ok=True)
    handlers: list = [logging.FileHandler(f"{exp_dir}/logs/rank{rank}.log")]
    if rank == 0:
        handlers.append(logging.StreamHandler(sys.stdout))
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s [%(filename)s:%(lineno)d] %(message)s",
        handlers=handlers, force=True,
    )


# the trees that train whole beside the LoRA factors, as in the JAX trainer:
# the speech LM's codecformer side, and the Moshi depformer side
SPEECH_LORA_TRAINABLE = ("codecformer", "input_emb", "codecformer_text_emb", "codecformer_emb",
                         "codecformer_in", "audio_linears")
MOSHI_LORA_TRAINABLE = ("depformer", "depformer_in", "depformer_emb", "depformer_text_emb",
                        "linears", "emb", "text_emb", "text_linear", "out_norm")


def refuse_invalid(args) -> None:
    """SystemExit for the flag combinations the JAX trainer refuses."""
    if not 0.0 <= args.lora_dropout < 1.0:
        raise SystemExit(f"--lora_dropout must be in [0, 1), got {args.lora_dropout}")
    if args.base_int8 and args.lora_r <= 0:
        raise SystemExit("--base_int8 requires --lora_r > 0 (it freezes the backbone; "
                         "something must remain trainable)")
    if args.base_int8 and args.model_family == "moshi":
        raise SystemExit("--base_int8 is wired for the backbone model family")
    if args.base_int8 and args.grad_accum > 1:
        raise SystemExit("--base_int8 does not support --grad_accum yet (the cross-batch "
                         "accumulator is unpartitioned)")


def build_mesh(args, device: torch.device) -> Mesh:
    """The JAX trainer's mesh over the ranks, on ``device``'s type: ``--dp
    -1`` (or 0) absorbs the ranks the other axes leave."""
    denom = args.fsdp * args.tensor * args.seq * args.expert * args.pipe
    dp = args.dp if args.dp > 0 else max(1, world_size() // denom)
    return make_mesh({"data": dp, "pipe": args.pipe, "seq": args.seq, "fsdp": args.fsdp,
                      "expert": args.expert, "tensor": args.tensor}, device_type=device.type)


def apply_mesh_flags(args, model: nn.Module) -> None:
    """The config's parallel behaviour flags from ``--seq``/``--pipe``/
    ``--pipeline_microbatches``, as the JAX trainer sets them (the parameters
    are unchanged)."""
    if args.seq <= 1 and args.pipe <= 1:
        return
    if args.model_family == "moshi":
        raise SystemExit("--seq/--pipe > 1 require a backbone model family (context/pipeline "
                         "parallelism is wired into the litgpt backbone)")
    cfg = model.config
    cfg = dataclasses.replace(
        cfg, sequence_parallel=cfg.sequence_parallel or args.seq > 1,
        pipeline_parallel=cfg.pipeline_parallel or args.pipe > 1,
        pipeline_microbatches=args.pipeline_microbatches or cfg.pipeline_microbatches)
    model.config = model.backbone.config = cfg


def resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {name}: torch sees no CUDA device "
                         "(pass --device cpu to train on the CPU)")
    if device.type == "cuda" and device.index is None and world_size() > 1:
        device = local_device("cuda")
    return device


def build_model(args, device: torch.device, dtype: torch.dtype) -> nn.Module:
    """The model of ``--model_family``, drawn from ``1337 + --seed`` in
    ``dtype`` on the CPU and moved to ``device``, or drawn on ``device``
    itself under ``--init_on_device``."""
    at = device if args.init_on_device else torch.device("cpu")
    g = torch.Generator(device=at).manual_seed(1337 + args.seed)
    if args.model_family == "moshi":
        # the pure Moshi RQ-Transformer; kyutai weights load via convert_moshi_lm
        return MoshiLMModel(
            delays=(0,) * (args.n_q + 1), n_q=args.n_q, dep_q=args.dep_q, card=args.audio_card,
            text_card=args.moshi_text_card, dim=args.moshi_dim,
            num_heads=args.moshi_num_heads, num_layers=args.moshi_num_layers,
            depformer_dim=args.codecformer_dim, depformer_num_heads=args.codecformer_heads,
            depformer_num_layers=args.codecformer_layers,
            depformer_dim_feedforward=args.codecformer_dim_feedforward,
            lora_dropout=args.lora_dropout if args.lora_r > 0 else 0.0, remat=args.remat,
            device=at, dtype=dtype, generator=g).to(device)
    overrides = dict(
        audio_card=args.audio_card, n_q=args.n_q, dep_q=args.dep_q,
        codecformer_dim=args.codecformer_dim, codecformer_heads=args.codecformer_heads,
        codecformer_layers=args.codecformer_layers,
        codecformer_dim_feedforward=args.codecformer_dim_feedforward,
        lora_r=args.lora_r, lora_alpha=args.lora_alpha, lora_dropout=args.lora_dropout,
        lora_query=args.lora_query, lora_key=args.lora_key, lora_value=args.lora_value,
        lora_projection=args.lora_projection, lora_mlp=args.lora_mlp,
        lora_head=args.lora_head,
        use_flash_attention=args.flash_attention and device.type == "cuda",
        remat=args.remat,
    )
    if args.model_config:
        cfg = Config.from_file(args.model_config, **overrides)
    elif args.model_name:
        cfg = Config.from_name(args.model_name, **overrides)
    else:
        raise ValueError("need --model_config or --model_name")
    return SpeechTextLM(cfg, device=at, dtype=dtype, generator=g).to(device)


def load_pretrained(args, model: nn.Module, dtype: torch.dtype) -> None:
    """``--checkpoint_path`` into the model in place, cast to ``dtype``: a
    Moshi checkpoint into the whole Moshi model, a litgpt one into the
    speech LM's backbone."""
    from rstnet_tpu_torch.models.convert import (
        convert_moshi_lm,
        load_backbone,
        load_converted,
        load_torch_state_dict,
    )

    if args.model_family == "moshi":
        load_converted(convert_moshi_lm(load_torch_state_dict(args.checkpoint_path), model),
                       model, dtype=dtype)
    else:
        load_backbone(args.checkpoint_path, model.backbone, dtype=dtype)


def attach_adapters(args, model: nn.Module, dtype: torch.dtype) -> dict[str, bool]:
    """LoRA factors (from seed 7, as in JAX) on the Moshi temporal
    transformer or the speech LM's backbone, the backbone quantized to int8
    under ``--base_int8``; returns the trainable mask: the factors and the
    trees that train whole (``*_LORA_TRAINABLE``)."""
    device = next(model.parameters()).device
    g = torch.Generator().manual_seed(7)
    if args.model_family == "moshi":
        overlay = init_lora_streaming_transformer(model.transformer, g, args.lora_r,
                                                  args.lora_alpha, dtype)
        target, whole = model.transformer, MOSHI_LORA_TRAINABLE
    else:
        overlay = init_lora(model.config, g, dtype)
        target, whole = model.backbone, SPEECH_LORA_TRAINABLE
    attach_lora(target, {k: v.to(device) for k, v in overlay.items()})
    if args.base_int8:
        # the LoRA factors stay float: the walk swaps only each linear's weight
        quantize_backbone_int8(model.backbone)
    mask = lora_trainable_mask(model)
    return {name: train or name.split(".")[0] in whole for name, train in mask.items()}


class StoredTokens(AbsTokenizer):
    """Offline-tokenized data: tokens as stored, length = the last axis."""

    def find_length(self, x) -> int:
        return int(np.shape(x)[-1])


def build_tokenizers(args) -> dict:
    if args.audio_tokenizer and args.audio_tokenizer != "none":
        return {"audio": StoredTokens(), "text": StoredTokens()}
    return {}


def device_batch(b: dict, device: torch.device, mesh: Optional[Mesh] = None,
                 hosts: int = 1) -> dict:
    """This rank's part of its host's batch, on ``device``: the rows padded
    (zero loss mask) to a power-of-two multiple of the host's share of
    ``data x fsdp``, as the JAX trainer pads, and the time axis to a
    multiple of ``seq`` (causal: steps after the last change nothing before
    them)."""
    tokens, masks = b["tokens"], b["masks"]
    B = tokens.shape[0]
    target = 1 if mesh is None else mesh.size("data") * mesh.size("fsdp") // hosts
    while target < B:
        target *= 2
    if target > B:
        rem = target - B
        tokens = np.concatenate([tokens, np.repeat(tokens[-1:], rem, 0)], 0)
        masks = np.concatenate([masks, np.zeros((rem,) + masks.shape[1:], masks.dtype)], 0)
    n_seq = 1 if mesh is None else mesh.size("seq")
    if tokens.shape[-1] % n_seq:
        rem = n_seq - tokens.shape[-1] % n_seq
        tokens = np.concatenate([tokens, np.repeat(tokens[..., -1:], rem, -1)], -1)
        masks = np.concatenate([masks, np.zeros(masks.shape[:-1] + (rem,), masks.dtype)], -1)
    part = batch_slice(mesh, {"tokens": tokens, "masks": masks}, hosts=hosts)
    return {"tokens": torch.from_numpy(np.ascontiguousarray(part["tokens"])).to(device),
            "masks": torch.from_numpy(np.ascontiguousarray(part["masks"])).to(
                device, torch.float32)}


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
    args = get_args(argv)
    refuse_invalid(args)
    initialize_distributed(device_type=torch.device(args.device).type)
    device = resolve_device(args.device)
    rank = world_rank()
    os.makedirs(args.exp_dir, exist_ok=True)
    setup_logging(args.exp_dir, rank)
    np.random.seed(args.seed)
    torch.manual_seed(args.seed)
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    mesh = build_mesh(args, device)
    model = build_model(args, device, dtype)
    moshi = args.model_family == "moshi"
    if args.checkpoint_path:
        load_pretrained(args, model, dtype)
        logging.info(f"loaded pretrained weights from {args.checkpoint_path}")
    # the resolved model config (CLI overrides included) for later reuse
    if rank == 0:
        if not moshi:
            write_flat_yaml(f"{args.exp_dir}/config.yaml", dataclasses.asdict(model.config))
        write_flat_yaml(f"{args.exp_dir}/train_args.yaml", vars(args))
    apply_mesh_flags(args, model)
    trainable_mask = attach_adapters(args, model, dtype) if args.lora_r > 0 else None
    n_params = sum(p.numel() for p in model.parameters())
    logging.info(f"{type(model).__name__} {'moshi' if moshi else model.config.name}: "
                 f"{n_params / 1e9:.3f} B params, {dtype}, on {device}, LoRA r {args.lora_r}, "
                 f"int8 base {args.base_int8}, flash attention "
                 f"{not moshi and model.config.use_flash_attention}")
    logging.info(f"mesh: {mesh.shape} over {mesh.world} ranks")
    shard_params(mesh, model)
    if trainable_mask is not None:
        # a pipeline stage holds its own blocks only
        own = dict(model.named_parameters())
        trainable_mask = {n: v for n, v in trainable_mask.items() if n in own}

    special = SpecialTokens(
        text_empty=args.text_empty_token, text_pad=args.text_pad_token,
        text_empty_pad=args.text_pad_token + 1, text_eos=args.text_pad_token + 2,
        semantic_empty=args.semantic_empty_token, acoustic_empty=args.acoustic_empty_token,
        semantic_pad=args.semantic_pad_token, acoustic_pad=args.acoustic_pad_token,
    )
    tokenizers = build_tokenizers(args)
    # the ranks of a host read one stream (the JAX package's process); each
    # takes its part of every batch
    host, n_hosts = host_index()
    iters = {}
    for name, jsons in (("train", args.train_data_jsons), ("valid", args.valid_data_jsons)):
        if not jsons:
            continue
        data, text = load_data_for_all_tasks(find_data_jsons(jsons, host, n_hosts))
        iters[name] = build_data_iterator(
            data, text, tokenizers, batch_scale=args.batch_scale, max_length=args.max_length,
            min_length=args.min_length, parallel_number=args.parallel_number, seed=args.seed,
            minibatch_debug=args.minibatch_debug, is_train=name == "train", rank=host,
            special=special, rebalance_alpha=args.rebalance_alpha if name == "train" else 0.0,
        )
    train_iter, valid_iter = iters.get("train"), iters.get("valid")

    schedule = warmup_lr(args.global_learning_rate, args.warmup_steps)
    tx = make_optimizer(schedule, weight_decay=args.weight_decay,
                        grad_clip=args.grad_clip if args.grad_clip > 0 else None,
                        skip_nonfinite=args.skip_nan_updates)
    loss_fn = make_loss_fn(model, audio_ignore_id=args.acoustic_pad_token,
                           text_ignore_id=args.text_pad_token)
    reporter = Reporter()
    state = init_train_state(model, tx, trainable_mask)
    if args.base_int8:
        # the partitioned PEFT state: checkpoints hold only the trainable
        # parameters (the reference's lora_filter shape)
        _, frozen = partition_params(model, trainable_mask)
        state["trainable_only"] = True
    state, extras, resumed = maybe_resume(args.exp_dir, state)
    if resumed is not None and "reporter" in extras:
        reporter.load_state_dict(extras["reporter"])
        logging.info(f"resumed from {resumed} at epoch {reporter.get_epoch()}")
    dropout_seed = args.seed if args.lora_r > 0 and args.lora_dropout > 0.0 else None
    accum_step = apply_step = None
    if args.grad_accum > 1:
        accum_step, apply_step = make_grad_accum_steps(loss_fn, tx, dropout_seed=dropout_seed)
        state["micro"] = 0
    if args.base_int8:
        peft_step = make_peft_train_step(loss_fn, tx, dropout_seed=dropout_seed)

        def train_step(s, b):
            return peft_step(s, frozen, b)
    else:
        train_step = make_train_step(loss_fn, tx, dropout_seed=dropout_seed)
    eval_step = make_eval_step(loss_fn)

    steps, saved = [], []

    def save(path):
        t0 = time.perf_counter()
        save_checkpoint(path, state, {"reporter": reporter.state_dict()},
                        keep_last=args.keep_last_ckpt)
        saved.append({"path": path, "seconds": time.perf_counter() - t0})

    with set_mesh(mesh):
        for ep in range(reporter.get_epoch() + 1, args.n_epoch + 1):
            reporter.set_epoch(ep)
            with reporter.observe("train") as sub:
                if train_iter is not None:
                    batches = sub.measure_iter_time(train_iter, "iter_time")
                    for b_idx, batch in enumerate(batches, 1):
                        shape = {"batch_size": batch["tokens"].shape[0],
                                 "seq_len": batch["tokens"].shape[2]}
                        sub.register(shape)
                        t0 = time.perf_counter()
                        with sub.measure_time("step_time"):
                            part = device_batch(batch, device, mesh, n_hosts)
                            if accum_step is not None:
                                state, metrics = accum_step(state, part)
                                if b_idx % args.grad_accum == 0:
                                    state = apply_step(state)
                            else:
                                state, metrics = train_step(state, part)
                            synchronize(device)
                        step_time = time.perf_counter() - t0
                        metrics = {k: float(v) for k, v in metrics.items()}
                        lr = float(schedule(int(state["step"]) - 1))
                        sub.register({**metrics, "lr": lr})
                        sub.next()
                        steps.append({"epoch": ep, **shape, **metrics, "lr": lr,
                                      "step_time": step_time})
                        if b_idx % args.print_freq == 0:
                            logging.info(sub.log_message(-args.print_freq))
                        if args.save_interval > 0 and b_idx % args.save_interval == 0:
                            save(f"{args.exp_dir}/ep{ep}-iter{b_idx}.checkpoint")
            if train_iter is not None:
                train_iter.sampler.refresh()
            with reporter.observe("valid") as sub:
                if valid_iter is not None:
                    for batch in sub.measure_iter_time(valid_iter, "iter_time"):
                        metrics = eval_step(device_batch(batch, device, mesh, n_hosts))
                        sub.register({k: float(v) for k, v in metrics.items()})
                        sub.next()
            logging.info(reporter.log_message())
            save(f"{args.exp_dir}/ep{ep}.checkpoint")

    return {"steps": steps, "checkpoints": saved}


if __name__ == "__main__":
    main()
