"""Codec losses, evaluation and data in the PyTorch port against the JAX
package: the STFT, mel and spectral transforms, the PQMF filterbank, the
enhancement losses, the six discriminators and the generator loss, the
codec metrics and ``compute_metrics``, the codec dataset, the semantic
teachers, ``codec_infer``, the pseudo-speech corpus, ``DummyQuantizer`` and
the YAML reader.

Inputs come from seeded numpy generators; module weights are drawn by the
port and carried to the JAX trees (``tests/test_torch_codec_train.py``'s
helpers). Tolerances (float32 FFTs on both sides; the largest errors
observed when written, in brackets): spectra, losses and discriminator
outputs 1e-4 relative and absolute (7.2e-6 absolute); metrics 1e-4
relative (3.0e-6); the filterbanks and the pseudo-speech corpus equal; the
codec round trip's wav within 16-bit rounding (2 / 32768).
"""

import tests.test_torch_threads  # noqa: F401 - first: one torch CPU thread a process

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from tests.test_torch_codec_train import TINY, TOL, _np, jax_state, tiny_config

SR = 2400


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


# -- STFT, mel and spectral transforms ---------------------------------------------


@pytest.mark.parametrize("fft,hop,win,normalized,center", [
    (64, 16, 64, False, True), (128, 32, 80, True, True), (64, 10, 40, False, False),
    (256, 64, 256, True, True),  # a centre pad longer than the signal reflects again
])
def test_stft_matches_jax(fft, hop, win, normalized, center):
    from rstnet_tpu.ops import stft as js
    from rstnet_tpu_torch.ops import stft as ts

    x = np.random.default_rng(0).normal(size=(2, 3, 200 if fft < 256 else 100)).astype(np.float32)
    spec_j = np.asarray(jax.jit(js.stft, static_argnums=(1, 2, 3, 4, 5))(
        jnp.asarray(x), fft, hop, win, normalized, center))
    spec_t = ts.stft(_t(x), fft, hop, win, normalized, center).numpy()
    assert spec_t.shape == spec_j.shape and spec_t.dtype == np.complex64
    np.testing.assert_allclose(spec_t, spec_j, **TOL)
    np.testing.assert_allclose(ts.magnitude(_t(x), fft, hop, win, normalized).numpy(),
                               np.asarray(jax.jit(js.magnitude, static_argnums=(1, 2, 3, 4))(
                                   jnp.asarray(x), fft, hop, win, normalized)),
                               **TOL)
    if center:
        back_j = jax.jit(js.istft, static_argnums=(1, 2, 3), static_argnames=("length",))(
            jnp.asarray(spec_j), fft, hop, win, length=x.shape[-1])
        back_t = ts.istft(torch.from_numpy(spec_j), fft, hop, win, length=x.shape[-1])
        np.testing.assert_allclose(back_t.numpy(), np.asarray(back_j), **TOL)


@pytest.mark.parametrize("htk,slaney_norm", [(True, False), (False, True)])
def test_mel_filterbank_equals_jax(htk, slaney_norm):
    from rstnet_tpu.ops.stft import mel_filterbank as jf
    from rstnet_tpu_torch.ops.stft import mel_filterbank as tf

    for args in ((65, 0.0, 1200.0, 16, 2400), (513, 0.0, 12000.0, 128, 24000)):
        np.testing.assert_array_equal(tf(*args, htk=htk, slaney_norm=slaney_norm).numpy(),
                                      np.asarray(jf(*args, htk=htk, slaney_norm=slaney_norm)))


def test_mel_spectrogram_matches_jax():
    from rstnet_tpu.ops.stft import mel_spectrogram as jm
    from rstnet_tpu_torch.ops.stft import mel_spectrogram as tm

    x = np.random.default_rng(1).normal(size=(2, 2400)).astype(np.float32)
    kw = dict(n_fft=256, num_mels=20, sampling_rate=2400, hop_size=60, win_size=200)
    want = jax.jit(lambda a: jm(a, **kw))(jnp.asarray(x))
    np.testing.assert_allclose(tm(_t(x), **kw).numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("domain,mel_scale", [("linear", False), ("log", False),
                                              ("double", False), ("double", True)])
def test_spectral_transform_matches_jax(domain, mel_scale):
    from rstnet_tpu.ops.stft import spectral_transform as jst
    from rstnet_tpu_torch.ops.stft import spectral_transform as tst

    x = np.random.default_rng(2).normal(size=(2, 512)).astype(np.float32)
    kw = dict(fft_size=64, hop_size=16, win_size=64, normalized=True, domain=domain,
              mel_scale=mel_scale, sample_rate=2400)
    got, want = tst(_t(x), **kw).numpy(), np.asarray(jax.jit(lambda a: jst(a, **kw))(jnp.asarray(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


# -- PQMF and the enhancement losses ---------------------------------------------------


def _sig(seed, n=4096):
    t = np.arange(n) / 24000.0
    tone = np.sin(2 * np.pi * 440 * t) + 0.3 * np.sin(2 * np.pi * 1330 * t)
    return (tone + 0.05 * np.random.default_rng(seed).normal(size=n)).astype(np.float32)[None]


def test_pqmf_near_perfect_reconstruction_and_jax_parity():
    from rstnet_tpu.ops import pqmf as jp
    from rstnet_tpu_torch.ops import pqmf as tp

    x = _sig(2)[:, None, :]  # [B, 1, T]
    for bands in (2, 4):
        for a, b in zip(tp.pqmf_filters(bands), jp.pqmf_filters(bands)):
            np.testing.assert_array_equal(a, b)
        sub = tp.pqmf_analysis(_t(x), num_bands=bands)
        assert sub.shape == (1, bands, x.shape[-1] // bands)
        want = jax.jit(jp.pqmf_analysis, static_argnums=1)(jnp.asarray(x), bands)
        np.testing.assert_allclose(sub.numpy(), np.asarray(want), **TOL)
        y = tp.pqmf_synthesis(sub, num_bands=bands)
        want = jax.jit(jp.pqmf_synthesis, static_argnums=1)(jnp.asarray(sub.numpy()), bands)
        np.testing.assert_allclose(y.numpy(), np.asarray(want), **TOL)
        # filterbank delay: align by cross-correlation, then compare
        a, b = x[0, 0], y.numpy()[0, 0][: x.shape[-1]]
        lag = int(np.argmax(np.correlate(b, a, mode="full"))) - (a.size - 1)
        a2, b2 = (a[: a.size - lag], b[lag:]) if lag > 0 else (a[-lag:], b[: b.size + lag])
        n = min(a2.size, b2.size) - 256
        a2, b2 = a2[128: 128 + n], b2[128: 128 + n]
        snr = 10 * np.log10(np.sum(a2**2) / (np.sum((a2 - b2) ** 2) + 1e-12))
        assert snr > 25.0, f"{bands}-band PQMF reconstruction SNR {snr:.1f} dB"


def test_enhancement_losses_zero_on_identity_ordered_and_match_jax():
    from rstnet_tpu.losses import enh as je
    from rstnet_tpu_torch.losses import enh as te

    x = _t(_sig(0))
    assert float(te.wav_mae(x, x)) == 0.0 and float(te.freq_mae(x, x)) == 0.0
    noisy = x + 0.1 * _t(np.random.default_rng(1).normal(size=x.shape))
    assert float(te.si_snr_loss(x, x)) < float(te.si_snr_loss(noisy, x))
    total, items = te.enhancement_loss(noisy, x)
    total_j, items_j = jax.jit(je.enhancement_loss)(jnp.asarray(noisy.numpy()),
                                                    jnp.asarray(x.numpy()))
    assert set(items) == {"enh_freq_mae", "enh_wav_mae", "enh_sisnr"}
    np.testing.assert_allclose(float(total), float(total_j), **TOL)
    for k in items:
        np.testing.assert_allclose(float(items[k]), float(items_j[k]), **TOL)
    total2, _ = te.enhancement_loss(noisy, x, freq_weight=0.0, wav_weight=0.0)
    np.testing.assert_allclose(float(total2), float(items["enh_sisnr"]), rtol=1e-6)


def test_si_snr_scale_invariance():
    from rstnet_tpu_torch.losses.enh import si_snr_loss

    x = _t(_sig(0))
    est = x + 0.05 * _t(np.random.default_rng(1).normal(size=x.shape))
    np.testing.assert_allclose(float(si_snr_loss(est, x)), float(si_snr_loss(est, 3.7 * x)),
                               atol=1e-3)


# -- discriminators and losses -------------------------------------------------------

DISCS = {
    "mfd": (dict(hop_lengths=(8, 16), hidden_channels=(32, 32), sample_rate=2400), 512),
    "mpd": (dict(period_sizes=(2, 3)), 512),
    "msd": (dict(num_scales=2), 512),
    "mrd": (dict(resolutions=((256, 32, 128), (128, 16, 64))), 512),
    "combd": ({}, 512),
    "sbd": ({}, 512),
}


@pytest.mark.parametrize("name", list(DISCS))
def test_discriminators_match_jax(name):
    from rstnet_tpu.losses.gan import discriminator_loss as jloss
    from rstnet_tpu.models.discriminators import DISCRIMINATORS as JD
    from rstnet_tpu_torch.losses.gan import discriminator_loss
    from rstnet_tpu_torch.models.discriminators import DISCRIMINATORS as TD

    kw, T = DISCS[name]
    jd = JD[name](**kw)
    td = TD[name](**kw, generator=torch.Generator().manual_seed(1))
    params = jax_state(jd, td)
    rng = np.random.default_rng(5)
    y, y_hat = (rng.normal(size=(2, 1, T)).astype(np.float32) for _ in range(2))
    out_j = jax.jit(jd.__call__)(params, jnp.asarray(y), jnp.asarray(y_hat))
    out_t = td(torch.from_numpy(y), torch.from_numpy(y_hat))
    assert len(out_t[0]) == len(out_t[1]) == len(out_t[2]) == len(out_t[3]) == len(out_j[0])
    for got, want in zip(jax.tree.leaves([list(o) for o in out_t]), jax.tree.leaves(out_j)):
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    d_t, _ = discriminator_loss({"d": out_t[0]}, {"d": out_t[1]})
    d_j, _ = jloss({"d": out_j[0]}, {"d": out_j[1]})
    assert np.isfinite(float(d_t))
    np.testing.assert_allclose(float(d_t), float(d_j), **TOL)


def test_generator_loss_composition():
    from rstnet_tpu.losses import gan as jg
    from rstnet_tpu_torch.losses import gan as tg

    kw = dict(full_fft_sizes=(64, 128), full_win_sizes=(40, 80), full_hop_sizes=(10, 20),
              sub_num_bands=2, sub_fft_sizes=(32,), sub_win_sizes=(20,), sub_hop_sizes=(8,),
              use_mel_loss=True, mel_kwargs=(("sampling_rate", 2400), ("n_fft", 64),
                                             ("num_mels", 8), ("hop_size", 16),
                                             ("win_size", 48)))
    rng = np.random.default_rng(0)
    y = rng.normal(size=(2, 1, 512)).astype(np.float32)
    y_hat = (y + 0.01 * rng.normal(size=y.shape)).astype(np.float32)
    fake = [rng.normal(size=(2, 1, 4, 4)).astype(np.float32)]
    fmaps = [[rng.normal(size=(2, 4, 8, 8)).astype(np.float32)]]
    loss_j, items_j = jax.jit(lambda *a: jg.generator_loss(jg.GeneratorLossConfig(**kw), *a))(
        jnp.asarray(y), jnp.asarray(y_hat), {"d": [jnp.asarray(fake[0])]}, {"d": fmaps},
        {"d": fmaps})
    t = torch.from_numpy
    tf = [[t(fmaps[0][0])]]
    loss_t, items_t = tg.generator_loss(tg.GeneratorLossConfig(**kw), t(y), t(y_hat),
                                        {"d": [t(fake[0])]}, {"d": tf}, {"d": tf})
    assert "G_sc_full" in items_t and "G_sc_sub" in items_t and "G_mel_loss" in items_t
    assert set(items_t) == set(items_j)
    np.testing.assert_allclose(float(loss_t), float(loss_j), **TOL)
    for k in items_j:
        np.testing.assert_allclose(float(items_t[k]), float(items_j[k]), **TOL)
    # a closer reconstruction gives a smaller STFT loss
    sc_close, _ = tg.multi_resolution_stft_loss(t(y_hat[:, 0]), t(y[:, 0]), (64,), (40,), (10,))
    sc_far, _ = tg.multi_resolution_stft_loss(t(rng.normal(size=(2, 512)).astype(np.float32)),
                                              t(y[:, 0]), (64,), (40,), (10,))
    assert float(sc_close) < float(sc_far)
    assert float(tg.hinge_g_loss([t(fake[0])])) == pytest.approx(
        float(jg.hinge_g_loss([jnp.asarray(fake[0])])), rel=1e-5)
    assert float(tg.hinge_d_loss([t(fake[0])], [t(fake[0])])) == pytest.approx(
        float(jg.hinge_d_loss([jnp.asarray(fake[0])], [jnp.asarray(fake[0])])), rel=1e-5)


def test_generator_wav_loss_term():
    """The time-domain L1 contributes, scales with its weight, is zero for
    a perfect reconstruction; build_from_config forwards the keys."""
    from rstnet_tpu_torch.losses.gan import GeneratorLossConfig, generator_loss
    from rstnet_tpu_torch.training.codec_trainer import build_from_config

    cfg = GeneratorLossConfig(use_full_stft_loss=False, use_sub_stft_loss=False,
                              use_feature_match=False, use_wav_loss=True, wav_loss_weight=10.0)
    y = torch.from_numpy(np.random.default_rng(0).normal(size=(2, 1, 256)).astype(np.float32))
    loss, items = generator_loss(cfg, y, y + 0.1, {}, use_adv_loss=False)
    np.testing.assert_allclose(float(items["G_wav_loss"]), 0.1, rtol=1e-5)
    np.testing.assert_allclose(float(loss), 1.0, rtol=1e-5)
    assert float(generator_loss(cfg, y, y, {}, use_adv_loss=False)[0]) == 0.0
    _, _, parsed = build_from_config({
        "generator": {"config": {**TINY, "rvq_layers": 2}},
        "d_list": ["mfd"],
        "mfd": {"config": {"hop_lengths": [8], "hidden_channels": [16], "sample_rate": 2400}},
        "criterion": {"g_criterion": {"config": {"use_wav_loss": True, "wav_loss_weight": 55.0}}},
    })
    assert parsed.use_wav_loss and parsed.wav_loss_weight == 55.0


# -- metrics --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def signals():
    rng = np.random.default_rng(0)
    t = np.arange(24000 * 2) / 24000
    clean = (0.5 * np.sin(2 * np.pi * 220 * t) + 0.2 * np.sin(2 * np.pi * 880 * t)).astype(
        np.float32)
    noisy = clean + 0.05 * rng.normal(0, 1, clean.shape).astype(np.float32)
    very_noisy = clean + 0.5 * rng.normal(0, 1, clean.shape).astype(np.float32)
    return clean, noisy, very_noisy


def _same_as_jax(name, *args):
    from rstnet_tpu.evalsuite import metrics as JM
    from rstnet_tpu_torch.evalsuite import metrics as TM

    got, want = getattr(TM, name)(*args), getattr(JM, name)(*args)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6, err_msg=name)
    return got


def test_si_snr(signals):
    clean, noisy, very_noisy = signals
    assert _same_as_jax("si_snr", clean, clean) > 50
    assert _same_as_jax("si_snr", clean, noisy) > _same_as_jax("si_snr", clean, very_noisy)
    assert abs(_same_as_jax("si_snr", clean, noisy * 0.3) - _same_as_jax("si_snr", clean, noisy)) < 0.1


def test_mel_ssim(signals):
    clean, noisy, very_noisy = signals
    assert _same_as_jax("mel_ssim", clean, clean) > 0.999
    assert _same_as_jax("mel_ssim", clean, noisy) > _same_as_jax("mel_ssim", clean, very_noisy)


def test_stoi():
    # broadband speech-like signal: pure tones leave most 1/3-octave bands empty
    rng = np.random.default_rng(1)
    clean = np.convolve(rng.normal(0, 0.3, 48000).astype(np.float32), np.ones(8) / 8, mode="same")
    noisy = clean + 0.1 * rng.normal(0, 1, clean.shape).astype(np.float32)
    very_noisy = clean + 0.8 * rng.normal(0, 1, clean.shape).astype(np.float32)
    assert _same_as_jax("stoi", clean, clean) > 0.99
    assert _same_as_jax("stoi", clean, noisy) > _same_as_jax("stoi", clean, very_noisy)


def test_mcd(signals):
    clean, noisy, very_noisy = signals
    assert _same_as_jax("mcd", clean, clean) < 1e-4
    assert _same_as_jax("mcd", clean, noisy) < _same_as_jax("mcd", clean, very_noisy)


def test_ms_stft(signals):
    clean, noisy, very_noisy = signals
    assert _same_as_jax("ms_stft_distance", clean, clean) < 1e-4
    assert (_same_as_jax("ms_stft_distance", clean, noisy)
            < _same_as_jax("ms_stft_distance", clean, very_noisy))


def test_optional_metrics_are_none_without_their_backends(signals, monkeypatch):
    from rstnet_tpu_torch.evalsuite import metrics as M

    clean, noisy, _ = signals
    monkeypatch.setitem(__import__("sys").modules, "pesq", None)
    assert M.pesq_score(clean, noisy) is None
    assert M.visqol_score("a.wav", "b.wav", binary="no-such-visqol-binary") is None
    assert M.dnsmos_score(noisy) is None
    assert M.dnsmos_score(noisy, model_path="no-such-dnsmos.onnx") is None  # no onnxruntime

    class Session:  # an injected DNSMOS session: a fixed raw (sig, bak, ovr)
        def run(self, _outputs, feeds):
            return [np.asarray([[3.0, 3.5, 2.8]], np.float32)]

    from rstnet_tpu.evalsuite.metrics import dnsmos_score

    assert M.dnsmos_score(noisy, session=Session()) == dnsmos_score(noisy, session=Session())


def test_compute_metrics_cli(tmp_path, signals):
    from rstnet_tpu.evalsuite.compute_metrics import main as jax_main
    from rstnet_tpu_torch.evalsuite.compute_metrics import main
    from rstnet_tpu_torch.utils.audio import write_wav

    clean, noisy, _ = signals
    (tmp_path / "ref").mkdir()
    (tmp_path / "deg").mkdir()
    for i in range(2):
        write_wav(str(tmp_path / "ref" / f"u{i}.wav"), clean, 24000)
        write_wav(str(tmp_path / "deg" / f"u{i}.wav"), noisy, 24000)
    argv = ["--ref_dir", str(tmp_path / "ref"), "--deg_dir", str(tmp_path / "deg")]
    report = main(argv + ["--output", str(tmp_path / "report.json")])
    assert report["n"] == 2 and report["mean"]["si_snr"] > 10
    assert (tmp_path / "report.json").exists()
    want = jax_main(argv)["mean"]
    assert set(report["mean"]) == set(want)
    for k in want:
        np.testing.assert_allclose(report["mean"][k], want[k], rtol=1e-4, err_msg=k)


# -- data, teachers and the round trip ---------------------------------------------------


@pytest.fixture()
def wav_scp(tmp_path):
    from rstnet_tpu_torch.utils.audio import write_wav

    rng = np.random.default_rng(0)
    paths = []
    for i, n in enumerate((SR, SR // 2, 3 * SR)):  # the short file is padded
        p = tmp_path / f"w{i}.wav"
        write_wav(str(p), (0.2 * rng.normal(0, 1, n)).astype(np.float32), SR)
        paths.append(str(p))
    scp = tmp_path / "train.scp"
    scp.write_text("\n".join(paths))
    return scp


def test_wave_dataset_segments_and_16k_view(wav_scp):
    from rstnet_tpu.data.codec_dataset import WaveDataset as JW
    from rstnet_tpu_torch.data.codec_dataset import WaveDataset, WaveIterator

    seg = 1200
    ds = WaveDataset(str(wav_scp), segment_size=seg, sampling_rate=SR, audio_norm_scale=0.95)
    jds = JW(str(wav_scp), segment_size=seg, sampling_rate=SR, audio_norm_scale=0.95)
    assert len(ds) == 3 and hasattr(ds, "load_batch")
    for i in (0, 1, 2, 2):  # the same crops from the same seed
        a24, a16 = ds[i]
        assert a24.shape == (1, seg) and a16.shape == (1, int(seg / SR * 16000))
        j24, j16 = jds[i]  # both read the wav through their copies of the C++ loader
        np.testing.assert_array_equal(a24, j24)
        np.testing.assert_array_equal(a16, j16)
    batches = list(WaveIterator(ds, 2, shuffle=True))
    assert len(batches) == 1 and batches[0][0].shape == (2, 1, seg)
    it = iter(WaveIterator(ds, 1, shuffle=False))
    next(it)
    it.close()  # stopping early releases the prefetch thread


def test_semantic_teacher_variants():
    from rstnet_tpu_torch.data.semantic_features import build_teacher

    audio = np.zeros((2, 1, 16000), np.float32)
    null = build_teacher("none")
    assert null.extract(audio).shape == (2, 16000 // 320, null.feature_dim)  # 50 Hz
    pre = build_teacher("precomputed", feature_dim=32)
    assert pre.feature_dim == 32
    with pytest.raises(RuntimeError, match="precomputed"):
        pre.extract(audio)
    with pytest.raises(AssertionError, match="checkpoint"):
        build_teacher("wavlm")
    with pytest.raises(ValueError, match="unknown"):
        build_teacher("nonsense")


def test_codec_infer_roundtrip_cli(tmp_path, wav_scp):
    """The CLI writes paired wavs; the first deg wav is the JAX codec's
    decode of its encode, from the same (seeded, no checkpoint) weights."""
    from rstnet_tpu.models.mimi_train import TrainableMimiCodec as JM
    from rstnet_tpu_torch.inference import codec_infer
    from rstnet_tpu_torch.training.codec_trainer import build_from_config
    from rstnet_tpu_torch.utils.audio import read_wav, resample_linear

    config = {"generator": {"name": "MimiCodec", "config": {**TINY, "encoder_rates": [4, 3]}}}
    cfg = tmp_path / "config.yaml"
    cfg.write_text(yaml.safe_dump(config))
    out = tmp_path / "rt"
    n = codec_infer.main(["--config", str(cfg), "--checkpoint_dir", str(tmp_path / "no_exp"),
                          "--scp", str(wav_scp), "--out_dir", str(out), "--device", "cpu"])
    assert n == 3
    refs, degs = sorted((out / "ref").glob("*.wav")), sorted((out / "deg").glob("*.wav"))
    assert len(refs) == len(degs) == 3
    model, _, _ = build_from_config(config)
    jm = JM(**TINY)
    params, buffers = jax_state(jm, model, with_buffers=True)
    for r, d in zip(refs, degs):
        ref, sr_r = read_wav(str(r))
        deg, sr_d = read_wav(str(d))
        assert sr_r == sr_d == SR and deg.shape == ref.shape and np.isfinite(deg).all()
    wav = resample_linear(read_wav(wav_scp.read_text().split()[0])[0][:1], SR, SR)
    padded = np.pad(wav, ((0, 0), (0, (-wav.shape[-1]) % 24)))[None]
    rec = jax.jit(lambda a: jm.decode(params, buffers, jm.encode(params, buffers, a)))(
        jnp.asarray(padded))
    want = np.clip(np.asarray(rec)[0, 0, : wav.shape[-1]], -1, 1)
    np.testing.assert_allclose(read_wav(str(degs[0]))[0][0], want, atol=2 / 32768)


def test_synth_pseudo_speech_statistics():
    """The port's copy gives the JAX module's clips, bit for bit, with
    speech-like statistics (energy under 1 kHz, a falling tilt, silences)."""
    from rstnet_tpu.data.synth_speech import synth_corpus as jax_corpus
    from rstnet_tpu_torch.data.synth_speech import synth_corpus

    bank = synth_corpus(0, 4, seconds=1.0)
    np.testing.assert_array_equal(bank, jax_corpus(0, 4, seconds=1.0))
    assert bank.shape == (4, 24000) and np.isfinite(bank).all()
    np.testing.assert_allclose(np.sqrt((bank**2).mean(axis=1)), 0.06, rtol=1e-3)
    assert not np.array_equal(bank, synth_corpus(1, 4, seconds=1.0))
    los, his = [], []
    f = np.fft.rfftfreq(24000, 1 / 24000)
    for clip in bank:
        S = np.abs(np.fft.rfft(clip))
        los.append(S[(f > 80) & (f < 1000)].mean())
        his.append(S[(f > 6000) & (f < 10000)].mean())
        frms = np.sqrt((clip[: 24000 // 50 * 50].reshape(50, -1) ** 2).mean(axis=1))
        assert frms.min() < 0.35 * frms.max()
    assert np.mean(los) > 2.0 * np.mean(his)


def test_dummy_quantizer_round_trip():
    from rstnet_tpu_torch.quantization.base import DummyQuantizer, QuantizedResult

    q = DummyQuantizer(dimension=8, frame_rate=12.5)
    x = _t(np.random.default_rng(1).normal(size=(2, 8, 5)))
    res = q(x)
    assert isinstance(res, QuantizedResult) and list(q.parameters()) == []
    np.testing.assert_array_equal(res.x.numpy(), x.numpy())
    codes = q.encode(x)
    assert codes.shape == (2, 1, 8, 5)
    np.testing.assert_array_equal(q.decode(codes).numpy(), x.numpy())
    assert q.total_codebooks == q.num_codebooks == q.cardinality == 1
    assert abs(float(res.bandwidth) - 8 * 32 * 12.5 / 1000.0) < 1e-5
    assert float(res.penalty) == 0.0


# -- the YAML reader ------------------------------------------------------------------


def test_yaml_subset_reads_the_codec_configs_as_safe_load():
    from rstnet_tpu_torch.utils import yaml_subset

    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "egs/codec/mimi24k.yaml"
    assert yaml_subset.load(path) == yaml.safe_load(path.read_text())
    cfg = {**tiny_config(), "x": None, "s": "a: b", "q": "yes", "f": 1e-9, "e": [], "m": {}}
    for text in (yaml.safe_dump(cfg), yaml.safe_dump(cfg, default_flow_style=True)):
        assert yaml_subset.loads(text) == yaml.safe_load(text) == cfg
    for text in ("a: 1e-4", "a: yes", "a: .5", "a: 1_000", "a: 'it''s'", 'a: "x # y"'):
        assert yaml_subset.loads(text) == yaml.safe_load(text), text
    for bad in ("a: &x 1", "a: *x", "a: !!str 1", "a: |\n  x", "- a: 1", "---\na: 1",
                "a: 012", "a: 0x1f"):
        with pytest.raises(ValueError):
            yaml_subset.loads(bad)
