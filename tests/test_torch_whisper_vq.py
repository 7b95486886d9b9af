"""The port's WhisperVQ tokenizer against the JAX package's, on the CPU.

Mirrors ``tests/test_whisper_vq.py`` with random weights: the log-mel
frontend within 1e-4 of the JAX (float64 numpy) function; the codeword
search, the encoder over a padded batch (average and max pooling, with and
without a block-causal mask), ``SSLTokenizer`` (a full 30 s chunk and a
partial one, 8 kHz input) and the checkpoint directory through both loaders
and both ``offline_tokenization --mode ssl`` tools: token ids exactly equal.
JAX's weights are jittered (zero biases and unit norms would hide a
misplaced one) and its codebook rows drawn at one norm, so the ids vary.
"""

import tests.test_torch_threads  # noqa: F401 - first: one torch CPU thread a process

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from rstnet_tpu.models import whisper_vq as jwv
from rstnet_tpu_torch.models import whisper_vq as pwv
from rstnet_tpu_torch.models.glm4v_flow import load_jax_tree

MEL_ATOL = 1e-4  # float32 rfft and mel on the port's side, float64 in JAX's numpy

TINY = dict(n_mels=8, d_model=32, num_heads=4, ffn_dim=64, num_layers=2,
            pooling_kernel_size=2, pooling_position=1, quantize_position=2,
            quantize_vocab_size=32, max_source_positions=100)


def _jax_model(rng, **kw):
    """A JAX encoder and its params: jittered, the codebook at one norm."""
    cfg = jwv.WhisperVQConfig(**{**TINY, **kw})
    params = jwv.WhisperVQEncoder(cfg).init(jax.random.PRNGKey(0))
    params = jax.tree.map(
        lambda a: np.asarray(a) + 0.1 * rng.standard_normal(np.shape(a)).astype(np.float32),
        params)
    cb = rng.standard_normal((cfg.quantize_vocab_size, cfg.d_model)).astype(np.float32)
    params["codebook"] = 3.0 * cb / np.linalg.norm(cb, axis=1, keepdims=True)
    return jwv.WhisperVQEncoder(cfg), params


def _port(model, params) -> pwv.WhisperVQEncoder:
    port = pwv.WhisperVQEncoder(pwv.WhisperVQConfig(**dataclasses.asdict(model.config)))
    return load_jax_tree(port, params)


@pytest.mark.parametrize("n", [16000, 16000 * 3 + 123])
def test_log_mel_matches_jax(n):
    rng = np.random.default_rng(n)
    t = np.arange(n)
    wav = (0.1 * rng.standard_normal(n) + 0.3 * np.sin(0.05 * t)).astype(np.float32)
    want = jwv.log_mel_spectrogram(wav, 128)
    got = pwv.log_mel_spectrogram(torch.from_numpy(wav), 128).numpy()
    assert got.shape == want.shape == (128, n // 160)
    np.testing.assert_allclose(got, want, atol=MEL_ATOL, rtol=0)
    np.testing.assert_array_equal(pwv.mel_filter_bank(80), jwv.mel_filter_bank(80))


def test_vector_quantize_matches_jax_ties_included():
    import jax.numpy as jnp

    eye = np.eye(4, dtype=np.float32) * 2
    h = np.asarray([[0.1, 1.9, 0.0, 0.0], [2.1, 0.0, 0.0, 0.1]], np.float32)
    assert pwv.vector_quantize(torch.from_numpy(h), torch.from_numpy(eye)).tolist() == [1, 0]
    rng = np.random.default_rng(0)
    cb = rng.integers(-2, 3, (24, 6)).astype(np.float32)
    cb[10], cb[17] = cb[3], cb[3]  # exact duplicates: the first index wins
    h = np.concatenate([cb[[3, 10, 5]], rng.integers(-2, 3, (40, 6)).astype(np.float32)])
    got = pwv.vector_quantize(torch.from_numpy(h), torch.from_numpy(cb)).numpy()
    want = np.asarray(jwv.vector_quantize(jnp.asarray(h), jnp.asarray(cb)))
    np.testing.assert_array_equal(got, want)
    assert got[0] == got[1] == 3


@pytest.mark.parametrize("pooling,block", [("avg", None), ("max", None), ("avg", 3),
                                           ("max", 3)])
def test_encoder_tokens_match_jax(pooling, block):
    rng = np.random.default_rng(1)
    model, params = _jax_model(rng, pooling_type=pooling, causal_block_size=block)
    B, T_mel = 2, 40
    mel = rng.standard_normal((B, 8, T_mel)).astype(np.float32)
    mask = np.ones((B, T_mel), np.float32)
    mask[1, 22:] = 0.0
    ids, tok_mask = jax.jit(model.encode)(params, mel, mask)
    got, got_mask = _port(model, params).encode(torch.from_numpy(mel), torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ids))
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(tok_mask))
    assert int(got_mask[1].sum()) == 6 and len(set(got[0].tolist())) > 1


def test_ssl_tokenizer_matches_jax():
    """A 31.3 s input: one full 30 s chunk (1500 positions) and a partial one
    (not a multiple of the stride); then an 8 kHz input."""
    from rstnet_tpu.data.tokenizers.ssl_tokenizer import SSLTokenizer as JaxSSL
    from rstnet_tpu_torch.data.tokenizers.ssl_tokenizer import SSLTokenizer

    rng = np.random.default_rng(2)
    model, params = _jax_model(rng, max_source_positions=1500)
    theirs = JaxSSL(model=model, params=params)
    mine = SSLTokenizer(model=_port(model, params), device="cpu")
    assert mine.stride == theirs.stride == 640 and mine.is_discrete
    n = 16000 * 31 + 4870
    wav = (0.1 * rng.standard_normal(n)).astype(np.float32)
    got = mine.tokenize(wav)
    assert got.dtype == np.int32
    assert len(got) == 16000 * 30 // 640 + -(-(n - 16000 * 30) // 640)
    np.testing.assert_array_equal(got, theirs.tokenize(wav))
    wav8 = (0.1 * rng.standard_normal(8000)).astype(np.float32)
    got8 = mine.tokenize(wav8, sample_rate=8000)
    assert len(got8) == 25
    np.testing.assert_array_equal(got8, theirs.tokenize(wav8, sample_rate=8000))
    assert mine.find_length(wav) == n


def _recorded(state: dict):
    """``state`` (tensors as numpy) as a mapping that records the names read
    from it."""

    class Recorded(dict):
        def __getitem__(self, k):
            self.read.add(k)
            return dict.__getitem__(self, k)

    rec = Recorded({k: v.detach().numpy() for k, v in state.items()})
    rec.read = set()
    return rec


@pytest.mark.parametrize("prefix", ["", "encoder."])
def test_tokenizer_writer_names_are_the_converters(prefix):
    """Every name ``upstream_whisper_vq`` writes is one the JAX converter
    reads, and every one it reads is written."""
    from rstnet_tpu_torch.tools.upstream_layout import upstream_whisper_vq

    cfg = pwv.WhisperVQConfig(**{**TINY, "pooling_position": 2})
    rec = _recorded(upstream_whisper_vq(pwv.WhisperVQEncoder(cfg), prefix))
    jwv.convert_whisper_vq(rec, jwv.WhisperVQConfig(**dataclasses.asdict(cfg)))
    assert rec.read == set(rec)


def test_load_glm4v_tokenizer_dir_and_cli(tmp_path):
    """A seeded port model written as a GLM-4-Voice tokenizer directory
    (config.json + model.safetensors) -> both loaders give equal ids; then
    both ``offline_tokenization --mode ssl`` tools write equal shards."""
    from rstnet_tpu.tools.offline_tokenization import main as jax_main
    from rstnet_tpu_torch.tools.offline_tokenization import main as port_main
    from rstnet_tpu_torch.tools.scp_tools import write_scp
    from rstnet_tpu_torch.tools.upstream_layout import write_glm4v_tokenizer
    from rstnet_tpu_torch.utils.audio import write_wav

    cfg = pwv.WhisperVQConfig(**{**TINY, "pooling_position": 2, "max_source_positions": 200})
    seeded = pwv.WhisperVQEncoder(cfg, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        seeded.codebook.mul_(100.0)
    ckpt = write_glm4v_tokenizer(tmp_path / "glm4v", seeded, prefix="model.encoder.")
    assert json.loads((ckpt / "config.json").read_text())["d_model"] == 32
    model, params = jwv.load_glm4v_encoder(str(ckpt))
    port = pwv.load_glm4v_encoder(str(ckpt), device="cpu")
    for name, t in seeded.state_dict().items():
        assert torch.equal(port.state_dict()[name], t), name
    rng = np.random.default_rng(4)
    mel = rng.standard_normal((1, 8, 64)).astype(np.float32)
    mask = np.ones((1, 64), np.float32)
    ids, _ = jax.jit(model.encode)(params, mel, mask)
    got, _ = port.encode(torch.from_numpy(mel), torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ids))

    entries = []
    for i, n in enumerate((16000, 12345)):
        path = tmp_path / f"a{i}.wav"
        write_wav(str(path), (0.1 * rng.standard_normal(n)).astype(np.float32), 16000)
        entries.append((f"utt{i}", str(path)))
    write_scp(str(tmp_path / "wav.scp"), entries)
    argv = ["--scp", str(tmp_path / "wav.scp"), "--mode", "ssl", "--ssl-checkpoint", str(ckpt)]
    port_main([*argv, "--output", str(tmp_path / "port.npz"), "--device", "cpu"])
    jax_main([*argv, "--output", str(tmp_path / "jax.npz")])
    mine, theirs = np.load(tmp_path / "port.npz"), np.load(tmp_path / "jax.npz")
    assert sorted(mine.files) == sorted(theirs.files) == ["utt0", "utt1"]
    for utt, n in (("utt0", 16000), ("utt1", 12345)):
        assert mine[utt].shape == (1, -(-n // 640)) and mine[utt].dtype == np.int32
        np.testing.assert_array_equal(mine[utt], theirs[utt])


def test_tokenizer_entry_points_default_to_cuda(tmp_path):
    """Without a card, every entry point that defaults to cuda raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the cuda default does not raise")
    from rstnet_tpu_torch.data.tokenizers.ssl_tokenizer import SSLTokenizer
    from rstnet_tpu_torch.tools.offline_tokenization import main

    with pytest.raises(RuntimeError, match="CUDA"):
        SSLTokenizer(model=pwv.WhisperVQEncoder(pwv.WhisperVQConfig(**TINY)))
    with pytest.raises(RuntimeError, match="CUDA"):
        pwv.load_glm4v_encoder(str(tmp_path))
    (tmp_path / "wav.scp").write_text("")
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--scp", str(tmp_path / "wav.scp"), "--output", str(tmp_path / "o.npz"),
              "--mode", "ssl", "--ssl-checkpoint", str(tmp_path)])
