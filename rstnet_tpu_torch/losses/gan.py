"""GAN and spectral losses for codec training (counterpart of
``rstnet_tpu/losses/gan.py``): feature matching, least-squares and hinge G
and D losses, single- and multi-resolution STFT losses, and the
GeneratorSTFTLoss composition (adversarial, feature match, mel, full-band
and PQMF sub-band multi-resolution STFT, time-domain L1).

Every mean and norm over the batch is ``parallel/comm.py``'s
``batch_mean``/``batch_norm``: ``torch.mean``/``vector_norm`` in one
process, the whole batch's value on every rank under data parallelism.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from rstnet_tpu_torch.ops.pqmf import pqmf_analysis
from rstnet_tpu_torch.ops.stft import magnitude, mel_spectrogram
from rstnet_tpu_torch.parallel.comm import batch_mean, batch_norm


def feature_match_loss(real_fmaps, fake_fmaps) -> torch.Tensor:
    """Mean L1 over all feature maps (real detached)."""
    loss, n = 0.0, 0
    for rf, ff in zip(real_fmaps, fake_fmaps):
        pairs = zip(rf, ff) if isinstance(rf, (list, tuple)) else ((rf, ff),)
        for r, f in pairs:
            loss = loss + batch_mean(torch.abs(f.float() - r.float().detach()))
            n += 1
    return loss / max(n, 1)


def mse_g_loss(fake_scores) -> torch.Tensor:
    """Least-squares generator loss, summed over heads."""
    loss = 0.0
    for s in fake_scores:
        loss = loss + batch_mean(torch.square(1.0 - s.float()))
    return loss


def hinge_g_loss(fake_scores) -> torch.Tensor:
    loss = 0.0
    for s in fake_scores:
        loss = loss - batch_mean(s.float())
    return loss


def mse_d_loss(real_scores, fake_scores) -> torch.Tensor:
    """Least-squares discriminator loss summed over heads."""
    loss = 0.0
    for r, f in zip(real_scores, fake_scores):
        loss = loss + batch_mean(torch.square(r.float() - 1.0)) + batch_mean(torch.square(f.float()))
    return loss


def hinge_d_loss(real_scores, fake_scores) -> torch.Tensor:
    loss = 0.0
    for r, f in zip(real_scores, fake_scores):
        loss = loss + batch_mean(torch.relu(1.0 - r)) + batch_mean(torch.relu(1.0 + f))
    return loss


def stft_loss(x: torch.Tensor, y: torch.Tensor, fft_size: int, hop_size: int, win_size: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """(spectral convergence, log-STFT magnitude L1) at one resolution."""
    mx = magnitude(x, fft_size, hop_size, win_size)
    my = magnitude(y, fft_size, hop_size, win_size)
    sc = batch_norm(my - mx) / torch.clamp(batch_norm(my), min=1e-8)
    mag = batch_mean(torch.abs(torch.log(my) - torch.log(mx)))
    return sc, mag


def multi_resolution_stft_loss(x: torch.Tensor, y: torch.Tensor,
                               fft_sizes=(512, 1024, 2048), win_sizes=(480, 960, 1200),
                               hop_sizes=(120, 240, 300)) -> tuple[torch.Tensor, torch.Tensor]:
    sc_total, mag_total = 0.0, 0.0
    for f, w, h in zip(fft_sizes, win_sizes, hop_sizes):
        sc, mag = stft_loss(x, y, f, h, w)
        sc_total = sc_total + sc
        mag_total = mag_total + mag
    n = len(fft_sizes)
    return sc_total / n, mag_total / n


@dataclasses.dataclass(frozen=True)
class GeneratorLossConfig:
    """The criterion stanza of ``egs/codec/mimi24k.yaml``."""

    adv_criterion: str = "mse"  # {"mse", "hinge"}
    use_feature_match: bool = True
    feat_match_loss_weight: float = 20.0
    use_mel_loss: bool = False
    mel_loss_weight: float = 45.0
    mel_kwargs: tuple = ()  # dict items for mel_spectrogram
    use_full_stft_loss: bool = True
    full_stft_loss_weight: float = 1.0
    full_fft_sizes: tuple = (512, 1024, 2048)
    full_win_sizes: tuple = (480, 960, 1200)
    full_hop_sizes: tuple = (120, 240, 300)
    use_sub_stft_loss: bool = True
    sub_stft_loss_weight: float = 1.0
    sub_num_bands: int = 6
    sub_fft_sizes: tuple = (128, 256, 256)
    sub_win_sizes: tuple = (80, 120, 200)
    sub_hop_sizes: tuple = (20, 40, 50)
    #: Encodec-style time-domain L1, off by default (Mimi trains spectral and
    #: adversarial terms only)
    use_wav_loss: bool = False
    wav_loss_weight: float = 0.0


def generator_loss(cfg: GeneratorLossConfig, targets: torch.Tensor, outputs: torch.Tensor,
                   output_fake: dict[str, list], fmap_real: Optional[dict[str, list]] = None,
                   fmap_fake: Optional[dict[str, list]] = None, use_adv_loss: bool = True
                   ) -> tuple[torch.Tensor, dict]:
    """GeneratorSTFTLoss over ``targets``/``outputs`` [B, 1, T]."""
    adv_fn = mse_g_loss if cfg.adv_criterion == "mse" else hinge_g_loss
    g_loss = torch.zeros((), device=outputs.device)
    items: dict = {}
    if use_adv_loss:
        for name, fake in output_fake.items():
            adv = adv_fn(fake)
            g_loss = g_loss + adv
            items[f"G_adv_{name}"] = adv
            if cfg.use_feature_match:
                fm = feature_match_loss(fmap_real[name], fmap_fake[name])
                g_loss = g_loss + fm * cfg.feat_match_loss_weight
                items[f"G_fm_{name}"] = fm
    if cfg.use_wav_loss:
        wav = batch_mean(torch.abs(outputs - targets.detach()))
        g_loss = g_loss + wav * cfg.wav_loss_weight
        items["G_wav_loss"] = wav
    if cfg.use_mel_loss:
        mel_kw = dict(cfg.mel_kwargs)
        mel_out = mel_spectrogram(outputs[:, 0], **mel_kw)
        mel_tgt = mel_spectrogram(targets[:, 0], **mel_kw)
        mel = batch_mean(torch.abs(mel_out - mel_tgt.detach()))
        g_loss = g_loss + mel * cfg.mel_loss_weight
        items["G_mel_loss"] = mel
    if cfg.use_full_stft_loss:
        sc, mag = multi_resolution_stft_loss(outputs[:, 0], targets[:, 0], cfg.full_fft_sizes,
                                             cfg.full_win_sizes, cfg.full_hop_sizes)
        g_loss = g_loss + cfg.full_stft_loss_weight * (sc + mag)
        items["G_sc_full"], items["G_mg_full"] = sc, mag
    if cfg.use_sub_stft_loss:
        tgt_sub = pqmf_analysis(targets, cfg.sub_num_bands)
        out_sub = pqmf_analysis(outputs, cfg.sub_num_bands)
        B, N, T = out_sub.shape
        sc, mag = multi_resolution_stft_loss(out_sub.reshape(B * N, T), tgt_sub.reshape(B * N, T),
                                             cfg.sub_fft_sizes, cfg.sub_win_sizes,
                                             cfg.sub_hop_sizes)
        g_loss = g_loss + cfg.sub_stft_loss_weight * (sc + mag)
        items["G_sc_sub"], items["G_mg_sub"] = sc, mag
    return g_loss, items


def discriminator_loss(output_real: dict[str, list], output_fake: dict[str, list],
                       kind: str = "mse") -> tuple[torch.Tensor, dict]:
    fn = mse_d_loss if kind == "mse" else hinge_d_loss
    total, items = 0.0, {}
    for name in output_real:
        d = fn(output_real[name], output_fake[name])
        total = total + d
        items[f"D_{name}"] = d
    return total, items
