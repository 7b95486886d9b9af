"""Codec GAN trainer CLI (counterpart of
``rstnet_tpu/training/codec_trainer.py``):

    python -m rstnet_tpu_torch.training.codec_trainer --config egs/codec/mimi24k.yaml \\
        --exp_dir exp/codec --train_scp data/codec/train.scp [--device cpu] ...

It takes the JAX CLI's flags plus ``--device`` (``cuda`` unless ``cpu`` is
given) and reads the same yaml (``utils/yaml_subset.py``, no YAML package).
Each step is a generator update and then a discriminator update, with two
AdamW optimizers (optax's ``adamw``: weight decay 1e-4 on every parameter,
the yaml's betas and eps, no clip) on the continuous exponential schedule
``lr * gamma ** (step / steps_per_epoch)``. As in JAX, the G step sees the
discriminators' parameters from before the D step; the D step reuses the G
step's detached reconstruction; the adversarial and feature-match terms
join once ``global_steps > discriminator_iter_start`` (so not at step 0);
and only the distillation loss (weight 1) and, with
``use_commit_loss_weight``, the commitment loss are added to the STFT/GAN
objective. The EMA codebook buffers are written by the G step's forward.

Random draws (the bypass mask and the dead codes) come from a CPU
``torch.Generator`` seeded from the yaml's ``seed``, the weights from
``torch.Generator``s seeded from it as well, drawn on the CPU and moved to
the device: every device starts from the same weights and draws the same.
On the card, TF32 is off in matmuls and cuDNN convolutions (the reference
is float32), and the quantizer's nearest-codeword sweep is K3.

Checkpoints (``training/checkpoint.py``) hold ``{"g": ..., "d": ...}``:
the codec's parameters and EMA buffers and the discriminators' parameters,
both optimizer states and the step; they rotate (``num_ckpt_keep``) and a
rerun resumes from the newest.

``--dp N`` trains data-parallel over N ranks (``--dp -1``: all of them),
as the JAX CLI does: one process a rank (``torchrun``, or a caller that
joined the default process group first), the G and D states replicated
(every rank draws the same weights), each global batch split on its rows
(``batch_size`` divisible by N, JAX's error otherwise). Every loss is the
whole batch's on every rank (``parallel/comm.py::batch_mean``), the
gradients are summed over the ranks (bucketed all-reduce), the EMA
codebook statistics are summed before each update, and the draws (bypass
mask, dead-code rows) are taken over the whole batch on every rank alike:
a step equals the ``--dp 1`` step on the same batch. Rank 0 writes the
checkpoints.

``main`` returns ``{"state", "steps", "checkpoints", "train_iter"}``: the
train state, one record a step (the losses, lr, step time), the saved
checkpoints and the training ``WaveIterator`` (None without
``--train_scp``), whose counters say how its batches were read.
"""

from __future__ import annotations

import argparse
import functools
import logging
import os
import time
from typing import Optional

import torch
from torch import nn

from rstnet_tpu_torch.data.codec_dataset import WaveDataset, WaveIterator
from rstnet_tpu_torch.data.semantic_features import build_teacher
from rstnet_tpu_torch.losses.gan import (
    GeneratorLossConfig,
    discriminator_loss,
    generator_loss,
    multi_resolution_stft_loss,
)
from rstnet_tpu_torch.models.discriminators import DISCRIMINATORS
from rstnet_tpu_torch.models.mimi_train import TrainableMimiCodec
from rstnet_tpu_torch.parallel.comm import batch_mean
from rstnet_tpu_torch.parallel.mesh import (
    Mesh,
    initialize_distributed,
    local_device,
    make_mesh,
    set_mesh,
    world_size,
)
from rstnet_tpu_torch.parallel.sharding import batch_slice
from rstnet_tpu_torch.training.checkpoint import maybe_resume, save_checkpoint
from rstnet_tpu_torch.training.schedulers import exponential_decay_lr
from rstnet_tpu_torch.training.train_step import OptaxAdamW, mesh_sync
from rstnet_tpu_torch.utils import yaml_subset
from rstnet_tpu_torch.utils.reporter import Reporter

GENERATOR_KEYS = ("sample_rate", "n_filters", "encoder_rates", "compress", "latent_dim",
                  "codebook_size", "codebook_dim", "rvq_layers", "num_heads", "num_layers",
                  "layer_scale", "context", "dim_feedforward", "semantic_feature_dim",
                  "target_frame_rate")


def build_from_config(cfg: dict, device=None, seed: int | None = None):
    """-> (codec, discriminators as an ``nn.ModuleDict`` by ``d_list``
    name, generator loss config). Weights are drawn on the CPU from ``seed``
    (the yaml's ``seed`` by default) and moved to ``device``."""
    seed = cfg.get("seed", 2333) if seed is None else seed
    gen_cfg = dict(cfg["generator"]["config"])
    kwargs = {k: gen_cfg[k] for k in GENERATOR_KEYS if k in gen_cfg}
    if "encoder_rates" in kwargs:
        kwargs["encoder_rates"] = tuple(kwargs["encoder_rates"])
    model = TrainableMimiCodec(**kwargs, generator=torch.Generator().manual_seed(seed))
    discs = nn.ModuleDict()
    for i, name in enumerate(cfg.get("d_list", ["mfd"])):
        dconf = dict((cfg.get(name) or {}).get("config") or {})
        kwargs = {}
        for k, v in dconf.items():
            if k in ("hop_lengths", "hidden_channels", "period_sizes"):
                kwargs[k] = tuple(v)
            elif k == "domain":
                kwargs[k] = v
            elif k == "mel_scale":
                kwargs[k] = bool(v)
            elif k in ("sample_rate", "period_kernel_size", "num_scales", "pool_kernel_size",
                       "pool_stride"):
                kwargs[k] = int(v)
        discs[name] = DISCRIMINATORS[name](
            **kwargs, generator=torch.Generator().manual_seed(seed + 1 + i))
    g_loss_cfg = generator_loss_config(cfg)
    if device is not None:
        model, discs = model.to(device), discs.to(device)
    return model, discs, g_loss_cfg


def generator_loss_config(cfg: dict) -> GeneratorLossConfig:
    """The yaml's ``criterion.g_criterion.config`` as a
    :class:`GeneratorLossConfig`."""
    crit = ((cfg.get("criterion") or {}).get("g_criterion") or {}).get("config") or {}
    full = crit.get("full_multi_scale_stft_loss", {})
    sub = crit.get("sub_multi_scale_stft_loss", {})
    return GeneratorLossConfig(
        adv_criterion="mse" if crit.get("adv_criterion", "MSEGLoss") == "MSEGLoss" else "hinge",
        use_feature_match=crit.get("use_feature_match", True),
        feat_match_loss_weight=crit.get("feat_match_loss_weight", 20),
        use_mel_loss=crit.get("use_mel_loss", False),
        mel_loss_weight=crit.get("mel_loss_weight", 45),
        mel_kwargs=tuple(crit.get("mel_scale_loss", {}).items()),
        use_full_stft_loss=crit.get("use_full_stft_loss", True),
        full_stft_loss_weight=crit.get("full_stft_loss_weight", 1),
        full_fft_sizes=tuple(full.get("fft_sizes", (512, 1024, 2048))),
        full_win_sizes=tuple(full.get("win_sizes", (480, 960, 1200))),
        full_hop_sizes=tuple(full.get("hop_sizes", (120, 240, 300))),
        use_sub_stft_loss=crit.get("use_sub_stft_loss", True),
        sub_stft_loss_weight=crit.get("sub_stft_loss_weight", 1),
        sub_num_bands=sub.get("num_bands", 6),
        sub_fft_sizes=tuple(sub.get("fft_sizes", (128, 256, 256))),
        sub_win_sizes=tuple(sub.get("win_sizes", (80, 120, 200))),
        sub_hop_sizes=tuple(sub.get("hop_sizes", (20, 40, 50))),
        use_wav_loss=crit.get("use_wav_loss", False),
        wav_loss_weight=crit.get("wav_loss_weight", 0.0),
    )


def make_tx(conf: dict, gamma: float, steps_per_epoch: int) -> OptaxAdamW:
    """optax's ``adamw`` at the yaml's lr, betas and eps (weight decay
    1e-4, no clip) over the codec schedule."""
    betas = conf.get("betas", (0.8, 0.99))
    return OptaxAdamW(exponential_decay_lr(float(conf.get("lr", 2e-4)), gamma,
                                           max(1, steps_per_epoch)),
                      betas=(betas[0], betas[1]), weight_decay=1e-4,
                      eps=float(conf.get("eps", 1e-6)))


def _run_discs(discs: nn.ModuleDict, audio, rec):
    out = {"real": {}, "fake": {}, "fmap_real": {}, "fmap_fake": {}}
    for name, disc in discs.items():
        ro, fo, rf, ff = disc(audio, rec)
        out["real"][name], out["fake"][name] = ro, fo
        out["fmap_real"][name], out["fmap_fake"][name] = rf, ff
    return out


def _update(tx: OptaxAdamW, loss: torch.Tensor, params: dict, opt_state: dict) -> None:
    grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    grads = {n: g if g is not None else torch.zeros_like(p)
             for (n, p), g in zip(params.items(), grads)}
    sync = mesh_sync()
    if sync is not None:
        sync.reduce(grads)
    tx.update(grads, opt_state, params, sync)


def make_steps(model: TrainableMimiCodec, discs: nn.ModuleDict, g_loss_cfg: GeneratorLossConfig,
               g_tx: OptaxAdamW, d_tx: OptaxAdamW, sim_loss_weight: float = 1.0,
               commit_loss_weight: float = 0.0):
    """-> (g_step, d_step, eval_step).

    ``g_step(state, audio, features, generator, use_adv, draws=None) ->
    (detached reconstruction, items)`` updates the codec's parameters (and
    its EMA buffers, in the forward) with ``state["opt_state"]["g"]``;
    ``d_step(state, audio, rec) -> items`` the discriminators' with
    ``state["opt_state"]["d"]``; ``eval_step(audio) -> items``. Every
    parameter of both trains."""
    g_params = dict(model.named_parameters())
    d_params = dict(discs.named_parameters())
    for p in (*g_params.values(), *d_params.values()):
        p.requires_grad_(True)

    def g_step(state, audio, features, generator, use_adv: bool, draws=None):
        for p in d_params.values():  # the discriminators are held in the G step
            p.requires_grad_(False)
        try:
            rec, _, commit, sim_loss = model(audio, features, generator, draws=draws)
            d = _run_discs(discs, audio, rec)
            loss, items = generator_loss(g_loss_cfg, audio, rec, d["fake"], d["fmap_real"],
                                         d["fmap_fake"], use_adv_loss=use_adv)
            loss = loss + sim_loss_weight * sim_loss + commit_loss_weight * commit
            items.update(codec_loss=sim_loss, commit_loss=commit, g_loss=loss)
            _update(g_tx, loss, g_params, state["opt_state"]["g"])
        finally:
            for p in d_params.values():
                p.requires_grad_(True)
        return rec.detach(), {k: v.detach() for k, v in items.items()}

    def d_step(state, audio, rec):
        d = _run_discs(discs, audio, rec)
        loss, items = discriminator_loss(d["real"], d["fake"])
        _update(d_tx, loss, d_params, state["opt_state"]["d"])
        items["d_loss"] = loss
        return {k: v.detach() for k, v in items.items()}

    return g_step, d_step, functools.partial(evaluate, model)


@torch.no_grad()
def evaluate(model: TrainableMimiCodec, audio: torch.Tensor) -> dict:
    """The validation step: quantized reconstruction (no bypass, no EMA
    update) and its multi-resolution STFT and L1 distances."""
    z = model.encode_to_latent(audio)
    zq = model.quantizer(z, update=False)[0]
    rec = model.decode_from_latent(zq)[..., : audio.shape[-1]]
    sc, mag = multi_resolution_stft_loss(rec[:, 0], audio[:, 0])
    return {"valid_sc": sc, "valid_mag": mag, "valid_l1": batch_mean(torch.abs(rec - audio))}


def resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit(f"--device {name}: torch sees no CUDA device "
                             "(pass --device cpu to train on the CPU)")
        if device.index is None and world_size() > 1:
            device = local_device("cuda")
        # the reference trains in float32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device


def data_mesh(args, cfg: dict, device: torch.device) -> Optional[Mesh]:
    """The ``--dp`` mesh on ``device``'s type (None for one rank), with the
    JAX CLI's checks."""
    if args.dp == -1:
        args.dp = world_size()
    if args.dp <= 1:
        return None
    if cfg.get("batch_size", 4) % args.dp:
        raise ValueError(f"batch_size {cfg.get('batch_size', 4)} not divisible by --dp {args.dp}")
    mesh = make_mesh({"data": args.dp}, device_type=device.type)
    logging.info(f"codec trainer mesh: {mesh.shape}")
    return mesh


def _rows(x, mesh: Optional[Mesh]):
    """This rank's rows of a global batch (numpy)."""
    return x if mesh is None else batch_slice(mesh, {"x": x})["x"]


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="rstnet_tpu_torch codec GAN trainer")
    parser.add_argument("--config", required=True, help="mimi24k.yaml-style config")
    parser.add_argument("--exp_dir", default="exp/codec")
    parser.add_argument("--train_scp", default="")
    parser.add_argument("--valid_scp", default="")
    parser.add_argument("--semantic_teacher", default="none",
                        choices=["wavlm", "hubert", "whisper", "w2v-bert", "none"])
    parser.add_argument("--semantic_checkpoint", default="")
    parser.add_argument("--max_steps", type=int, default=-1)
    parser.add_argument("--dp", type=int, default=1,
                        help="data-parallel ranks (-1 = all of them)")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return parser


def main(argv=None) -> dict:
    args = get_parser().parse_args(argv)
    initialize_distributed(device_type=torch.device(args.device).type)
    device = resolve_device(args.device)
    cfg = yaml_subset.load(args.config)
    os.makedirs(args.exp_dir, exist_ok=True)
    logging.basicConfig(level=logging.INFO, force=True)
    mesh = data_mesh(args, cfg, device)
    with set_mesh(mesh):
        return train(args, cfg, device, mesh)


def train(args, cfg: dict, device: torch.device, mesh: Optional[Mesh]) -> dict:
    """The training run of :func:`main` (under the ambient ``mesh``)."""
    model, discs, g_loss_cfg = build_from_config(cfg, device)
    seed = cfg.get("seed", 2333)
    generator = torch.Generator().manual_seed(seed + 100)

    train_iter, steps_per_epoch = None, 1
    if args.train_scp:
        dataset = WaveDataset(args.train_scp, segment_size=cfg.get("segment_size", 72000),
                              sampling_rate=model.sample_rate, split=True,
                              audio_norm_scale=cfg.get("audio_norm_scale", 1.0))
        train_iter = WaveIterator(dataset, cfg.get("batch_size", 4), shuffle=True)
        steps_per_epoch = max(1, len(train_iter))
    opt_cfg = cfg.get("optimizer") or {}
    sched = cfg.get("lr_scheduler") or {}

    def tx(which):
        conf = (opt_cfg.get(which) or {}).get("config") or {}
        gamma = ((sched.get(which) or {}).get("config") or {}).get("gamma", 0.999)
        return make_tx(conf, gamma, steps_per_epoch)

    g_tx, d_tx = tx("g"), tx("d")
    g_step, d_step, eval_step = make_steps(
        model, discs, g_loss_cfg, g_tx, d_tx,
        commit_loss_weight=float(cfg.get("use_commit_loss_weight", 0.0)))
    gan = nn.ModuleDict({"g": model, "d": discs})
    state = {"model": gan,
             "opt_state": {"g": g_tx.init(dict(model.named_parameters())),
                           "d": d_tx.init(dict(discs.named_parameters()))},
             "step": 0}
    state, extras, ckpt = maybe_resume(args.exp_dir, state)
    global_steps = extras.get("global_steps", state["step"])
    if ckpt is not None:
        generator.set_state(torch.tensor(extras["generator"], dtype=torch.uint8))
        logging.info(f"resumed from {ckpt} at step {global_steps}")

    teacher = build_teacher(args.semantic_teacher, args.semantic_checkpoint or None,
                            feature_dim=model.semantic_feature_dim)
    reporter = Reporter()
    disc_start = cfg.get("discriminator_iter_start", 0)
    valid_iter = None
    if args.valid_scp:
        vset = WaveDataset(args.valid_scp, segment_size=cfg.get("segment_size", 72000),
                           sampling_rate=model.sample_rate, split=True)
        valid_iter = WaveIterator(vset, cfg.get("batch_size", 4), shuffle=False)
    steps, saved = [], []
    if train_iter is None:
        logging.warning("no --train_scp given; initialized model only")
        return {"state": state, "steps": steps, "checkpoints": saved, "train_iter": train_iter}

    def save(epoch):
        path = f"{args.exp_dir}/ep{epoch}-iter{global_steps}.checkpoint"
        state["step"] = global_steps
        save_checkpoint(path, state, {"global_steps": global_steps,
                                      "generator": generator.get_state().tolist()},
                        keep_last=cfg.get("num_ckpt_keep", 10))
        saved.append(path)

    print_freq = cfg.get("print_freq", 10)
    # as in JAX, a resumed run counts its epochs from 0 again (global_steps
    # carries on)
    for epoch in range(cfg.get("num_epoches", 500)):
        reporter.set_epoch(epoch)
        train_iter.set_epoch(epoch)
        with reporter.observe("train") as sub:
            for audio_24k, audio_16k in train_iter:
                t0 = time.perf_counter()
                audio_24k, audio_16k = _rows(audio_24k, mesh), _rows(audio_16k, mesh)
                features = (None if args.semantic_teacher == "none"
                            else torch.from_numpy(teacher.extract(audio_16k)).to(device))
                audio = torch.from_numpy(audio_24k).to(device)
                rec, g_items = g_step(state, audio, features, generator,
                                      use_adv=global_steps > disc_start)
                d_items = d_step(state, audio, rec)
                global_steps += 1
                items = {k: float(v) for k, v in {**g_items, **d_items}.items()}
                steps.append({"epoch": epoch, "step": global_steps, **items,
                              "lr": float(g_tx.schedule(state["opt_state"]["g"]["count"] - 1)),
                              "seconds": time.perf_counter() - t0})
                sub.register(items)
                sub.next()
                if global_steps % print_freq == 0:
                    logging.info(sub.log_message(-print_freq))
                if global_steps % cfg.get("checkpoint_interval", 5000) == 0:
                    save(epoch)
                if (valid_iter is not None
                        and global_steps % cfg.get("validation_interval", 5000) == 0):
                    with reporter.observe("valid") as vsub:
                        for v24, _ in valid_iter:
                            m = eval_step(torch.from_numpy(_rows(v24, mesh)).to(device))
                            vsub.register({k: float(v) for k, v in m.items()})
                            vsub.next()
                    logging.info(reporter.log_message())
                if 0 < args.max_steps <= global_steps:
                    logging.info("max_steps reached")
                    if not saved or not saved[-1].endswith(f"-iter{global_steps}.checkpoint"):
                        save(epoch)
                    return {"state": state, "steps": steps, "checkpoints": saved,
                            "train_iter": train_iter}
        logging.info(reporter.log_message())
    return {"state": state, "steps": steps, "checkpoints": saved, "train_iter": train_iter}


if __name__ == "__main__":
    main()
