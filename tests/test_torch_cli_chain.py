"""The port's CLI chain on the CPU: trainer -> ``lm_eval`` -> ``infer_cli``
on one tiny experiment (the config of ``tests/test_cli_smoke.py``), and the
params-only checkpoint restore the two inference CLIs use.

What the chain locks in, as the JAX smoke test does: the trainer writes the
resolved ``config.yaml`` and ``train_args.yaml``; ``lm_eval`` rebuilds the
trained model from them and reports finite CE and perplexity; ``infer_cli``
slices each prefix (no length filter) and writes one [1 + n_q, T] grid per
example."""

import tests.test_torch_threads  # noqa: F401 - first: one torch CPU thread a process

import json

import numpy as np
import pytest
import torch

from tests.test_cli_smoke import COMMON, _write_synthetic


def _train(tmp_path, dtype="float32"):
    from rstnet_tpu_torch.training import trainer

    _write_synthetic(tmp_path)
    exp = tmp_path / "exp"
    args = ["--train_data_jsons", str(tmp_path / "a.json"),
            "--model_config", str(tmp_path / "model.yaml"), "--exp_dir", str(exp),
            "--n_epoch", "1", "--minibatch_debug", "2", "--print_freq", "1",
            "--device", "cpu", *COMMON]
    dt = args.index("--dtype") + 1
    args[dt] = dtype
    out = trainer.main(args)
    return exp, out


def test_train_eval_generate_chain(tmp_path):
    from rstnet_tpu_torch.evalsuite import lm_eval
    from rstnet_tpu_torch.inference import infer_cli

    exp, _ = _train(tmp_path)
    assert (exp / "config.yaml").is_file() and (exp / "train_args.yaml").is_file()
    metrics = lm_eval.main(["--checkpoint_dir", str(exp), "--data_jsons",
                            str(tmp_path / "a.json"), "--output", str(tmp_path / "ppl.json"),
                            "--device", "cpu"])
    saved = json.loads((tmp_path / "ppl.json").read_text())
    for k in ("ppl_audio", "ppl_text", "loss_audio", "loss_text"):
        assert k in saved and np.isfinite(saved[k]), (k, saved)
    assert saved["ppl_audio"] == pytest.approx(metrics["ppl_audio"])
    assert metrics["n_audio_tokens"] > 0

    out_dir = tmp_path / "gen"
    written = infer_cli.main(["--exp_dir", str(exp), "--data_jsons", str(tmp_path / "a.json"),
                              "--output_dir", str(out_dir), "--task", "continuation",
                              "--prefix_frames", "8", "--max_new_frames", "4",
                              "--max_examples", "2", "--device", "cpu"])
    outs = sorted(out_dir.glob("*.npy"))
    assert len(outs) == 2 and sorted(written) == outs
    grid = np.load(outs[0])
    assert grid.ndim == 2 and grid.shape[0] == 9 and grid.shape[1] >= 4
    for task in ("tts", "asr"):
        assert len(infer_cli.main(["--exp_dir", str(exp), "--data_jsons",
                                   str(tmp_path / "a.json"), "--output_dir",
                                   str(tmp_path / task), "--task", task, "--prefix_frames", "4",
                                   "--max_new_frames", "2", "--max_examples", "1",
                                   "--device", "cpu"])) == 1


def test_infer_cli_refuses_wav_decoding(tmp_path):
    """``--mimi_checkpoint`` (a Mimi 24 kHz file in kyutai's layout):
    ``infer_cli`` writes one wav per example beside its grid, the grid's
    audio rows clamped to real codes and decoded through ``MimiTokenizer``
    as a direct decode gives them."""
    from rstnet_tpu_torch.data.tokenizers.mimi_tokenizer import MimiTokenizer
    from rstnet_tpu_torch.inference import infer_cli
    from rstnet_tpu_torch.models.mimi import mimi_24k
    from rstnet_tpu_torch.tools.upstream_layout import upstream_mimi, write_upstream
    from rstnet_tpu_torch.utils.audio import read_wav

    exp, _ = _train(tmp_path)
    mimi = write_upstream(tmp_path / "mimi.safetensors", upstream_mimi(
        mimi_24k(generator=torch.Generator().manual_seed(3))))
    out_dir = tmp_path / "gen"
    written = infer_cli.main(["--exp_dir", str(exp), "--data_jsons", str(tmp_path / "a.json"),
                              "--output_dir", str(out_dir), "--prefix_frames", "4",
                              "--max_new_frames", "2", "--max_examples", "2",
                              "--mimi_checkpoint", str(mimi), "--device", "cpu"])
    wavs = sorted(out_dir.glob("*.wav"))
    assert len(written) == 2 and [p.with_suffix(".wav") for p in sorted(written)] == wavs
    detok = MimiTokenizer(checkpoint_path=str(mimi), device="cpu")
    grid = np.load(sorted(written)[0])
    want = detok.detokenize(np.clip(grid[1:], 0, 2047))
    audio, sr = read_wav(str(wavs[0]))
    assert sr == 24000 and audio.shape == want.shape == (1, grid.shape[1] * 1920)
    np.testing.assert_allclose(audio, np.clip(want, -1, 1), rtol=0, atol=1 / 32767 + 1e-6)


def test_partial_restore_loads_params_only(tmp_path, monkeypatch):
    """``restore_checkpoint(..., partial=True)`` into a fresh float32 model:
    the trainer's bf16 params arrive bit for bit in their saved dtype, the
    file is mapped (``mmap``) and only ``{"model"}`` comes back, so the AdamW
    moments are never copied out of it. The trainer's resume path (the full
    restore) still needs and checks every key."""
    from rstnet_tpu_torch.models.config import Config
    from rstnet_tpu_torch.models.lm import SpeechTextLM
    from rstnet_tpu_torch.training import checkpoint

    exp, out = _train(tmp_path, "bfloat16")
    ckpt = checkpoint.latest_checkpoint(exp)
    saved = torch.load(ckpt / "state.pt", weights_only=True)
    assert saved["opt_state"] and saved["params"]["backbone.wte"].dtype == torch.bfloat16

    loads = []
    real_load = torch.load
    monkeypatch.setattr(checkpoint.torch, "load",
                        lambda *a, **k: loads.append(k) or real_load(*a, **k))
    model = SpeechTextLM(Config.from_file(exp / "config.yaml"),
                         generator=torch.Generator().manual_seed(5))
    state, extras = checkpoint.restore_checkpoint(ckpt, {"model": model}, partial=True)
    assert loads[-1]["mmap"] is True and set(state) == {"model"} and "reporter" in extras
    got = model.state_dict()
    assert set(got) == set(saved["params"])
    for k, v in saved["params"].items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    assert not any(p.requires_grad for p in model.parameters())
    with pytest.raises(KeyError):  # the full restore wants the optimizer state too
        checkpoint.restore_checkpoint(ckpt, {"model": model, "opt_state": {}})
