"""The port's GLM-4-Voice decoder (flow + HiFT) against the JAX package's,
on the CPU.

Mirrors ``tests/test_glm4v_decoder.py`` with random weights (jittered, so a
misplaced bias or norm shows) and JAX's own draws passed in: the conformer
(both relative-position tables, with and without the convolution module and
macaron FFNs, one fully masked row), the regulator and the U-Net (odd and
even lengths, a padding mask), ``cfm_solve`` given JAX's z,
``GLM4VFlow.inference`` with and without a prompt, HiFT (no draws, JAX's
phase and noise, a source cache), the decoder directory
(``config.yaml`` + ``flow.pt`` + ``hift.pt``, plain and weight-normed convs)
through both loaders, offline and streaming synthesis over
``test_stream_inference_sweep``'s cases, ``detokenize`` and the
``ssl_resynth`` CLI. Mel within ``MEL_TOL`` and waveforms within
``WAV_TOL`` (absolute; float32 sums in another order on each side). The
config text and the YAML reader's hyperpyyaml tags are held to the JAX
loader (PyYAML) on the same text.
"""

import tests.test_torch_threads  # noqa: F401 - first: one torch CPU thread a process

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rstnet_tpu.models import glm4v_decoder as jgd
from rstnet_tpu.models import glm4v_flow as jgf
from rstnet_tpu.models import hift as jh
from rstnet_tpu_torch.models import glm4v_decoder as pgd
from rstnet_tpu_torch.models import glm4v_flow as pgf
from rstnet_tpu_torch.models import hift as ph
from rstnet_tpu_torch.models.glm4v_flow import load_jax_tree
from tests.test_torch_whisper_vq import _recorded

MEL_TOL = 1e-4
WAV_TOL = 1e-5


def _jitter(tree, rng, scale=0.1):
    tree = jax.tree.map(
        lambda a: np.asarray(a) + scale * rng.standard_normal(np.shape(a)).astype(np.float32),
        tree)
    for layer in tree.get("encoder", tree).get("layers", []):
        if "bn" in layer:  # a variance stays positive
            layer["bn"]["var"] = np.abs(layer["bn"]["var"]) + 0.5
    return tree


def _same(cfg, cls):
    """A JAX config dataclass as the port's (nested ones too)."""
    kw = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if dataclasses.is_dataclass(v):
            v = _same(v, {"ConformerConfig": pgf.ConformerConfig,
                          "UNetConfig": pgf.UNetConfig}[type(v).__name__])
        kw[f.name] = v
    return cls(**kw)


UNET_CFG = jgf.UNetConfig(in_channels=24, out_channels=6, channels=(8, 8), attention_head_dim=4,
                          n_blocks=1, num_mid_blocks=1, num_heads=2)


def _flow_cfg(full: bool):
    """The files' flow (``full``: the convolution module, macaron FFNs, two
    U-Net levels) or the synthesis tests' one (``_tiny_decoder``'s shapes,
    which keep JAX's lowering of the sweep short)."""
    return jgf.GLM4VFlowConfig(
        vocab_size=40, input_size=16, output_size=6, spk_embed_dim=8,
        regulator_stages=2 if full else 1,
        encoder=jgf.ConformerConfig(input_size=16, output_size=16, attention_heads=2,
                                    linear_units=24, num_blocks=1, block_size=3, cnn_kernel=5,
                                    use_cnn_module=full, macaron_style=full),
        unet=UNET_CFG if full else dataclasses.replace(UNET_CFG, channels=(8,)),
        n_timesteps=2)


HIFT_CFG = jh.HiFTConfig(
    in_channels=6, base_channels=8, nb_harmonics=1, upsample_rates=(2, 2),
    upsample_kernel_sizes=(4, 4), resblock_kernel_sizes=(3,), resblock_dilations=((1,),),
    source_resblock_kernel_sizes=(3, 3), source_resblock_dilations=((1,), (1,)),
    f0_cond_channels=8)


@pytest.fixture(scope="module")
def pair():
    """A JAX decoder and the port's on the same jittered weights."""
    rng = np.random.default_rng(0)
    fcfg = _flow_cfg(full=False)
    jflow, jhift = jgf.GLM4VFlow(fcfg), jh.HiFTGenerator(HIFT_CFG)
    fp = _jitter(jflow.init(jax.random.PRNGKey(0)), rng)
    hp = _jitter(jhift.init(jax.random.PRNGKey(1)), rng)
    flow = load_jax_tree(pgf.GLM4VFlow(_same(fcfg, pgf.GLM4VFlowConfig)), fp)
    hift = load_jax_tree(ph.HiFTGenerator(_same(HIFT_CFG, ph.HiFTConfig)), hp)
    return (jgd.GLM4VAudioDecoder(jflow, fp, jhift, hp), pgd.GLM4VAudioDecoder(flow, hift))


class JaxDraws:
    """The port's ``draw(kind, shape)`` answered with the JAX decoder's
    draws: its key split as ``offline_inference`` (``stream=False``) or
    ``stream_inference`` splits it, the shapes the port asks for."""

    def __init__(self, key, stream: bool):
        self.key, self.stream, self.kinds = key, stream, []

    def __call__(self, kind, shape):
        self.kinds.append(kind)
        if kind == "z":
            if self.stream:
                self.key, kz, self.kh = jax.random.split(self.key, 3)
            else:
                kz, self.kh = jax.random.split(self.key)
            return torch.from_numpy(np.array(jax.random.normal(kz, shape)))
        k1, k2 = jax.random.split(self.kh)
        if kind == "phase":
            out = jax.random.uniform(k1, shape, minval=-jnp.pi, maxval=jnp.pi)
        else:
            out = jax.random.normal(k2, shape)
        return torch.from_numpy(np.array(out))


@pytest.mark.parametrize("pos_enc", ["rel_pos", "rel_pos_espnet"])
@pytest.mark.parametrize("cnn", [True, False])
def test_conformer_matches_jax(pos_enc, cnn):
    """Rows 0-2 of the second item see only padded keys (its first grid
    block is padded): they must come out finite on both sides."""
    rng = np.random.default_rng(1)
    cfg = jgf.ConformerConfig(input_size=12, output_size=16, attention_heads=2,
                              linear_units=24, num_blocks=2, block_size=3, pos_enc=pos_enc,
                              macaron_style=cnn, use_cnn_module=cnn, cnn_kernel=5)
    params = _jitter(jgf.init_conformer(jax.random.PRNGKey(0), cfg), rng)
    x = rng.standard_normal((2, 7, 12)).astype(np.float32)
    pad = np.ones((2, 7), bool)
    pad[1, :3] = False
    pad[0, 6] = False
    want = np.asarray(jax.jit(lambda p, x, m: jgf.apply_conformer(cfg, p, x, m))(params, x, pad))
    port = load_jax_tree(pgf.Conformer(_same(cfg, pgf.ConformerConfig)), params)
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(pad)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=MEL_TOL, rtol=0)


@pytest.fixture(scope="module")
def unet_pair():
    """The two-level U-Net (a stride-2 down, a transposed-conv up) on the
    same jittered weights, and the regulator's."""
    rng = np.random.default_rng(7)
    up = _jitter(jgf.init_unet(jax.random.PRNGKey(2), UNET_CFG), rng)
    rp = _jitter(jgf.init_regulator(jax.random.PRNGKey(3), 6, 2, 6), rng)
    unet = load_jax_tree(pgf.UNet(_same(UNET_CFG, pgf.UNetConfig)), up)
    return up, unet, rp, load_jax_tree(pgf.Regulator(6, 2, 6), rp)


def test_regulator_and_unet_match_jax(unet_pair):
    up, unet, rp, regulator = unet_pair
    rng = np.random.default_rng(2)
    h = rng.standard_normal((2, 5, 6)).astype(np.float32)
    want = jax.jit(jgf.apply_regulator, static_argnums=2)(rp, h, 17)
    with torch.no_grad():
        got = regulator(torch.from_numpy(h), 17)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=MEL_TOL, rtol=0)
    apply = jax.jit(lambda p, *a: jgf.apply_unet(UNET_CFG, p, *a))
    for T in (9, 10):  # the up path cuts an odd length's extra frame
        x, mu, cond = (rng.standard_normal((2, T, 6)).astype(np.float32) for _ in range(3))
        spk = rng.standard_normal((2, 6)).astype(np.float32)
        mask = np.ones((2, T), np.float32)
        mask[1, 7:] = 0.0
        want = apply(up, x, mask, mu, np.float32(0.3), spk, cond)
        with torch.no_grad():
            got = unet(*map(torch.from_numpy, (x, mask, mu)), torch.tensor(0.3),
                       torch.from_numpy(spk), torch.from_numpy(cond))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=MEL_TOL, rtol=0)


def test_cfm_solve_matches_jax(unet_pair):
    up, unet = unet_pair[:2]
    rng = np.random.default_rng(3)
    z, mu, cond = (rng.standard_normal((1, 12, 6)).astype(np.float32) for _ in range(3))
    spk = rng.standard_normal((1, 6)).astype(np.float32)
    mask = np.ones((1, 12), np.float32)
    want = jax.jit(lambda p, *a: jgf.cfm_solve(UNET_CFG, p, *a, n_timesteps=3))(
        up, z, mu, mask, spk, cond)
    got = pgf.cfm_solve(unet, *map(torch.from_numpy, (z, mu, mask, spk, cond)), n_timesteps=3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=MEL_TOL, rtol=0)


@pytest.mark.parametrize("prompt", [False, True])
def test_flow_inference_matches_jax(pair, prompt):
    jdec, dec = pair
    rng = np.random.default_rng(4)
    token = rng.integers(-2, 40, (1, 9)).astype(np.int32)  # negative ids clip to 0
    z = rng.standard_normal((1, dec.flow.config.mel_len(9), 6)).astype(np.float32)
    feat = rng.standard_normal((1, 4, 6)).astype(np.float32) if prompt else None
    want = jax.jit(jdec.flow.inference)(jdec.flow_params, token, z, prompt_feat=feat)
    got = dec.flow.inference(torch.from_numpy(token).long(), torch.from_numpy(z),
                             prompt_feat=None if feat is None else torch.from_numpy(feat))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=MEL_TOL, rtol=0)


def test_hift_matches_jax(pair):
    """No draws; then JAX's phase and noise with a source cache."""
    jdec, dec = pair
    rng = np.random.default_rng(5)
    mel = (2 * rng.standard_normal((2, 11, 6))).astype(np.float32)
    hift = jax.jit(jdec.hift.inference)
    wav, src = hift(jdec.hift_params, mel)
    got_wav, got_src = dec.hift.inference(torch.from_numpy(mel))
    np.testing.assert_allclose(got_wav.numpy(), np.asarray(wav), atol=WAV_TOL, rtol=0)
    np.testing.assert_allclose(got_src.numpy(), np.asarray(src), atol=WAV_TOL, rtol=0)
    assert float(np.abs(np.asarray(wav)).max()) > 0
    key = jax.random.PRNGKey(5)
    cache = (0.1 * rng.standard_normal((2, 8, 1))).astype(np.float32)
    wav, src = hift(jdec.hift_params, mel, key=key, cache_source=cache)
    draws = JaxDraws(key, stream=False)
    draws.kh = key  # HiFT alone: its key splits into the phase's and the noise's
    got_wav, got_src = dec.hift.inference(torch.from_numpy(mel), draw=draws,
                                          cache_source=torch.from_numpy(cache))
    assert draws.kinds == ["phase", "noise"]
    np.testing.assert_array_equal(got_src[:, :8].numpy(), cache)
    np.testing.assert_allclose(got_wav.numpy(), np.asarray(wav), atol=WAV_TOL, rtol=0)
    np.testing.assert_allclose(got_src.numpy(), np.asarray(src), atol=WAV_TOL, rtol=0)


def test_offline_and_stream_match_jax(pair):
    """``test_stream_inference_sweep``'s cases with JAX's draws: equal
    within ``WAV_TOL``, of the expected lengths; the same generator gives
    the same wav bit for bit, another seed another one."""
    jdec, dec = pair
    cfg, up = dec.flow.config, dec.hift.config.total_upsample
    token = jax.random.randint(jax.random.PRNGKey(2), (1, 30), 0, 40)
    want = jdec.offline_inference(token, key=jax.random.PRNGKey(7))
    got = dec.offline_inference(torch.from_numpy(np.array(token)),
                                draw=JaxDraws(jax.random.PRNGKey(7), stream=False))
    assert got.shape == (1, cfg.mel_len(30) * up)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=WAV_TOL, rtol=0)
    grid = cfg.encoder.block_size
    for block, T in [(None, 7), (2, 7), (5, 8), (grid, 2), (grid, 12)]:
        token = jax.random.randint(jax.random.PRNGKey(100 * T + (block or 0)), (1, T), 0, 40)
        want = np.asarray(jdec.stream_inference(token, block_size=block,
                                                key=jax.random.PRNGKey(9)))
        got = dec.stream_inference(torch.from_numpy(np.array(token)), block_size=block,
                                   draw=JaxDraws(jax.random.PRNGKey(9), stream=True)).numpy()
        n_blocks = -(-T // (block or grid))
        assert got.shape == want.shape, (block, T)
        assert abs(got.shape[1] - cfg.mel_len(T) * up) <= dec.source_cache_len * n_blocks
        assert np.isfinite(got).all() and np.abs(got).max() > 0, (block, T)
        np.testing.assert_allclose(got, want, atol=WAV_TOL, rtol=0, err_msg=str((block, T)))
    token = torch.from_numpy(np.array(token))
    w1 = dec.stream_inference(token, generator=torch.Generator().manual_seed(5))
    w2 = dec.stream_inference(token, generator=torch.Generator().manual_seed(5))
    w3 = dec.stream_inference(token, generator=torch.Generator().manual_seed(6))
    assert torch.equal(w1, w2) and not torch.equal(w1, w3)
    assert torch.equal(dec.offline_inference(token), dec.offline_inference(token))


def _seeded_decoder():
    fcfg = _same(_flow_cfg(full=True), pgf.GLM4VFlowConfig)
    g = torch.Generator().manual_seed(11)
    flow = pgf.GLM4VFlow(fcfg, generator=g)
    hift = ph.HiFTGenerator(_same(HIFT_CFG, ph.HiFTConfig), generator=g)
    with torch.no_grad():  # nonzero biases, norms and alphas
        for p in [*flow.parameters(), *hift.parameters()]:
            p.add_(0.05 * torch.randn(p.shape, generator=g))
        for layer in flow.encoder.layers:
            layer.bn.var.abs_().add_(0.5)
    return flow, hift


@pytest.mark.parametrize("weight_norm", [False, True])
def test_decoder_writer_names_are_the_converters(weight_norm):
    """Every name the decoder writers emit is one the JAX converters read,
    and every one they read is emitted; the config text gives both readers
    the same configs."""
    from rstnet_tpu_torch.tools.upstream_layout import (
        glm4v_decoder_yaml,
        upstream_glm4v_flow,
        upstream_hift,
    )

    flow, hift = _seeded_decoder()
    flow_sd, hift_sd = _recorded(upstream_glm4v_flow(flow)), _recorded(
        upstream_hift(hift, weight_norm))
    text = glm4v_decoder_yaml(flow.config, hift.config)
    jf, jhc = jgd.configs_from_yaml(text)
    jgd.convert_glm4v_flow(flow_sd, jgf.GLM4VFlow(jf))
    jgd.convert_hift(hift_sd, jh.HiFTGenerator(jhc))
    assert flow_sd.read == set(flow_sd) and hift_sd.read == set(hift_sd)
    assert any(k.endswith("weight_g") for k in hift_sd) == weight_norm
    pf, phc = pgd.configs_from_yaml(text)
    # the file cannot say the solver's steps: a loaded flow takes 10
    assert pf == dataclasses.replace(flow.config, n_timesteps=10) and phc == hift.config
    # JAX reads no f0_cond_channels (it takes the arrays' widths)
    assert dataclasses.asdict(jf) == dataclasses.asdict(pf)
    assert dataclasses.asdict(jhc) == {**dataclasses.asdict(phc), "f0_cond_channels": 512}


@pytest.mark.parametrize("weight_norm", [False, True])
def test_decoder_files_match_jax(tmp_path, weight_norm):
    """The seeded decoder written as a glm-4-voice-decoder directory: the
    port's loader gives back its weights (weight-normed convs folded in
    float64, within 1e-6), and the same weights as the JAX loader's trees
    carried into the port (``load_jax_tree``, the flipped transposed convs
    among them) within 1e-7 relative."""
    from rstnet_tpu_torch.tools.upstream_layout import write_glm4v_decoder

    flow, hift = _seeded_decoder()
    root = write_glm4v_decoder(tmp_path / "dec", flow, hift, weight_norm=weight_norm)
    assert sorted(p.name for p in root.iterdir()) == ["config.yaml", "flow.pt", "hift.pt"]
    dec = pgd.load_glm4v_decoder(str(root), device="cpu")
    jdec = jgd.load_glm4v_decoder(str(root))
    from_jax = (load_jax_tree(pgf.GLM4VFlow(dec.flow.config), jdec.flow_params),
                load_jax_tree(ph.HiFTGenerator(dec.hift.config), jdec.hift_params))
    for mine, seeded, theirs in zip((dec.flow, dec.hift), (flow, hift), from_jax):
        for name, t in mine.state_dict().items():
            np.testing.assert_allclose(t.numpy(), seeded.state_dict()[name].numpy(), atol=1e-6,
                                       rtol=0, err_msg=name)
            np.testing.assert_allclose(t.numpy(), theirs.state_dict()[name].numpy(), atol=0,
                                       rtol=1e-7, err_msg=name)


def test_detokenize_and_resynth_cli(tmp_path, pair):
    """``SSLTokenizer.detokenize`` (JAX's draws: JAX's audio) and the
    ``ssl_resynth`` CLI: ``--tokens`` offline and ``--stream``, and ``--scp``
    through a tokenizer directory, each wav at 22.05 kHz of the expected
    length and equal to the decoder's own call."""
    import wave

    from rstnet_tpu.data.tokenizers.ssl_tokenizer import SSLTokenizer as JaxSSL
    from rstnet_tpu_torch.data.tokenizers.ssl_tokenizer import SSLTokenizer
    from rstnet_tpu_torch.models import whisper_vq as pwv
    from rstnet_tpu_torch.tools import ssl_resynth
    from rstnet_tpu_torch.tools.scp_tools import write_scp
    from rstnet_tpu_torch.tools.upstream_layout import write_glm4v_decoder, write_glm4v_tokenizer
    from rstnet_tpu_torch.utils.audio import read_wav, write_wav

    jdec, dec = pair
    from rstnet_tpu.models.whisper_vq import WhisperVQConfig, WhisperVQEncoder

    enc = WhisperVQEncoder(WhisperVQConfig(
        n_mels=8, d_model=16, num_heads=2, ffn_dim=24, num_layers=1, pooling_kernel_size=4,
        pooling_position=1, quantize_position=1, quantize_vocab_size=40,
        max_source_positions=400))
    ids = np.arange(20, dtype=np.int32) % 40
    want = JaxSSL(model=enc, params=enc.init(jax.random.PRNGKey(0)), decoder=jdec).detokenize(ids)
    tok = SSLTokenizer(model=pwv.WhisperVQEncoder(pwv.WhisperVQConfig(
        **dataclasses.asdict(enc.config))), decoder=dec, device="cpu")
    got = tok.detokenize(ids, draw=JaxDraws(jax.random.PRNGKey(42), stream=False))
    assert got.shape == want.shape == (dec.flow.config.mel_len(20) * 16,)
    np.testing.assert_allclose(got, want, atol=WAV_TOL, rtol=0)

    root = write_glm4v_decoder(tmp_path / "dec", dec.flow, dec.hift)
    loaded = pgd.load_glm4v_decoder(str(root), device="cpu")
    np.savez(tmp_path / "tok.npz", utt1=np.arange(12, dtype=np.int32)[None] % 40,
             utt2=np.arange(25, dtype=np.int32) % 40)
    for stream in (False, True):
        out = tmp_path / f"wavs{int(stream)}"
        argv = ["--tokens", str(tmp_path / "tok.npz"), "--decoder-checkpoint", str(root),
                "--out_dir", str(out), "--device", "cpu"]
        assert ssl_resynth.main(argv + ["--stream"] * stream) == 0
        for utt, n_tok in (("utt1", 12), ("utt2", 25)):
            with wave.open(str(out / f"{utt}.wav")) as f:
                assert f.getframerate() == 22050
                n = f.getnframes()
            token = torch.from_numpy(np.arange(n_tok)[None] % 40)
            ref = (loaded.stream_inference(token) if stream
                   else loaded.offline_inference(token))[0].numpy()
            assert n == len(ref)
            if not stream:
                assert n == dec.flow.config.mel_len(n_tok) * 16
            # 16-bit PCM: truncated to a step of 1/32767, read back over 32768
            np.testing.assert_allclose(read_wav(str(out / f"{utt}.wav"))[0][0], ref,
                                       atol=2 / 32767)

    seeded = pwv.WhisperVQEncoder(pwv.WhisperVQConfig(**dataclasses.asdict(enc.config)))
    ckpt = write_glm4v_tokenizer(tmp_path / "tok", seeded)
    rng = np.random.default_rng(6)
    write_wav(str(tmp_path / "a.wav"), (0.1 * rng.standard_normal(16000)).astype(np.float32),
              16000)
    write_scp(str(tmp_path / "wav.scp"), [("utt0", str(tmp_path / "a.wav"))])
    assert ssl_resynth.main(["--scp", str(tmp_path / "wav.scp"), "--ssl-checkpoint", str(ckpt),
                             "--decoder-checkpoint", str(root), "--out_dir",
                             str(tmp_path / "rt"), "--stream", "--device", "cpu"]) == 0
    wav, sr = read_wav(str(tmp_path / "rt" / "utt0.wav"))
    assert sr == 22050 and wav.shape[1] > 0


CONFIG_TEXT = """
flow: !new:cosyvoice.flow.flow.MaskedDiffWithXvec
    input_size: 512
    vocab_size: 16384
    input_frame_rate: 12.5
    encoder: !new:cosyvoice.transformer.encoder.BlockConformerEncoder
        output_size: 512
        attention_heads: 8
        num_blocks: 6
        block_size: 10
        selfattention_layer_type: block_rel_selfattn
        pos_enc_layer_type: rel_pos_espnet
    decoder: !new:cosyvoice.flow.flow_matching.ConditionalCFM
        in_channels: 240
        cfm_params: !new:omegaconf.DictConfig
            inference_cfg_rate: 0.7
        estimator: !new:cosyvoice.flow.decoder.ConditionalDecoder
            in_channels: 320
            out_channels: 80
            channels: [256, 256]
            num_mid_blocks: 12
hift: !new:cosyvoice.hifigan.generator.HiFTGenerator
    in_channels: 80
    base_channels: 512
    upsample_rates: [8, 8]
    istft_params:
        n_fft: 16
        hop_len: 4
"""


def test_config_yaml_matches_jax():
    """``test_config_yaml_parsing``'s text: the same configs as JAX's."""
    jf, jhc = jgd.configs_from_yaml(CONFIG_TEXT)
    pf, phc = pgd.configs_from_yaml(CONFIG_TEXT)
    assert dataclasses.asdict(pf) == dataclasses.asdict(jf)
    assert dataclasses.asdict(phc) == dataclasses.asdict(jhc)
    assert pf.encoder.block_size == 10 and pf.encoder.pos_enc == "rel_pos_espnet"
    assert pf.unet.channels == (256, 256) and phc.total_upsample == 256


@pytest.mark.parametrize("text", [
    "a: !new:pkg.A\n    x: 1\n    y: [1, 2]\n",
    "a: !new:pkg.A\nb: 2\n",
    "a: !new:pkg.A {x: 1, y: two}\n",
    "a: !new:pkg.A\n    - 1\n    - 2\n",
    "a: !name:pkg.fn\n",
    "a: !name:pkg.fn\n    n_fft: 1024\nb: 1\n",
    "a: !ref <sample_rate>\n",
    "a: !ref <x> * 2\n",
    "a: !ref '<x>'\n",
    "a:\n    - !ref <x>\n    - !name:y\n",
    # three deep, with a !ref and a !name inside
    "f: !new:a.F\n    k: 1\n    e: !new:b.E\n        d: !new:c.D\n"
    "            r: !ref <k>\n            n: !name:m.fn\n            l: [1, 2]\n    m: 3\n",
], ids=["new", "new-empty", "new-flow", "new-seq", "name", "name-block", "ref", "ref-expr",
        "ref-quoted", "seq-items", "nested-3"])
def test_yaml_subset_hyperpyyaml_tags(text):
    from rstnet_tpu_torch.utils import yaml_subset

    assert yaml_subset.loads(text) == jgd.parse_hyperpyyaml(text)


@pytest.mark.parametrize("text", ["a: !apply:random.seed [1986]\n", "a: !!python/name:os.system\n",
                                  "a: !ref\n    b: 1\n", "a: [!ref <x>]\n"])
def test_yaml_subset_refuses_other_tags(text):
    from rstnet_tpu_torch.utils import yaml_subset

    with pytest.raises(ValueError):
        yaml_subset.loads(text)


def test_decoder_entry_points_default_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the cuda default does not raise")
    from rstnet_tpu_torch.tools import ssl_resynth

    with pytest.raises(RuntimeError, match="CUDA"):
        pgd.load_glm4v_decoder(str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA"):
        ssl_resynth.main(["--tokens", "t.npz", "--decoder-checkpoint", str(tmp_path),
                          "--out_dir", str(tmp_path / "o")])
