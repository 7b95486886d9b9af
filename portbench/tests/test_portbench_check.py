"""The check that decides ``correct``, at the tiny configuration on the CPU
(and on the card where there is one):

* the plain reference agrees with the port's offline Mimi and LM;
* a whole run of each tiny cell comes out correct;
* the control (the reference one precision step down) reads above a limit;
* runs with the timed path broken underneath come out not correct: a token
  altered where it is produced, a step that leaves the attention state
  unwritten, half of the batch's audio left out;
* the harness and the reference load no module of JAX or of the JAX
  package, and the reference none of the port.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from portbench.lib.bench import run_cell
from portbench.lib.manifest import load_cell
from portbench.lib.weights import draw, load
from portbench.reference import layout
from portbench.reference.mimi import MimiReference
from portbench.reference.moshi import MoshiReference

ROOT = Path(__file__).resolve().parents[2]
DATA = Path(__file__).resolve().parent / "data"
SEED = 2**31 + 11  # larger than 32 signed bits hold, as a run's seed may be


@pytest.fixture(params=["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def device(request):
    if request.param == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return request.param


def test_reference_matches_the_port_offline():
    from rstnet_tpu_torch.models.mimi import mimi_24k
    from rstnet_tpu_torch.models.moshi_lm import MoshiLMModel

    cfg = json.loads((DATA / "tiny.json").read_text())
    cfg["lm_dtype"] = "float32"
    z = layout.derived(cfg)
    W = draw(layout.spec(cfg), 7, "cpu")
    lm = MoshiLMModel(**cfg["lm"], device="meta").to_empty(device="cpu")
    mimi = mimi_24k(**cfg["mimi"], device="meta").to_empty(device="cpu")
    load(lm, W, "lm.")
    load(mimi, W, "mimi.")
    g = torch.Generator().manual_seed(0)
    pcm = torch.randn(2, 1, 1920 * 12, generator=g) * 0.1
    ref_mimi, ref_lm = MimiReference(W, z), MoshiReference(W, z)
    codes = mimi.encode(pcm).long()
    assert torch.equal(codes, ref_mimi.encode(pcm))
    audio, ref_audio = mimi.decode(codes), ref_mimi.decode(codes)
    assert float((audio - ref_audio).abs().max() / ref_audio.std()) < 1e-5
    seq = torch.randint(0, 64, (2, 17, 20), generator=g)
    seq[:, 0] = torch.randint(0, 256, (2, 20), generator=g)
    hidden, text = lm.forward_text(seq)
    ref_hidden, ref_text = ref_lm.backbone(seq)
    torch.testing.assert_close(text, ref_text, rtol=1e-5, atol=1e-5)
    gen = seq[:, :9]
    audio_logits = lm.forward_local(gen[:, 0], gen[:, 1:9], hidden)
    torch.testing.assert_close(audio_logits, ref_lm.depformer(ref_hidden, gen), rtol=1e-5,
                               atol=1e-5)


def _run(root, cell, device, control=False, seconds=1.0):
    return run_cell(load_cell(root, cell), SEED, seconds, False, device, time.perf_counter(),
                    control=control)


@pytest.mark.parametrize("cell", ["tiny.tiny_batch", "tiny.tiny_solo"])
def test_run_is_correct_and_the_control_is_not(tiny_root, device, cell):
    result = _run(tiny_root, cell, device, control=True)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
    assert list(result)[-1] == "checks"
    limits = load_cell(tiny_root, cell).limits
    assert any(result["control"]["control"][k] > limits[k] for k in limits), result["control"]


def _altered_token(monkeypatch):
    from rstnet_tpu_torch.inference import generate

    real = generate.sample_token

    def altered(logits, *args, **kwargs):
        return (real(logits, *args, **kwargs) + 1) % logits.shape[-1]

    monkeypatch.setattr(generate, "sample_token", altered)


def _state_unwritten(monkeypatch):
    from rstnet_tpu_torch.modules import transformer
    from rstnet_tpu_torch.ops.attention import ring_positions

    def unwritten(cache, end, k_new, v_new):
        capacity = cache["k"].shape[2]
        new_end = end + k_new.shape[2]
        return cache, ring_positions(capacity, new_end, k_new.device), new_end

    monkeypatch.setattr(transformer, "ring_kv_update", unwritten)


def _half_batch_left_out(monkeypatch):
    from rstnet_tpu_torch.serving import batcher

    real = batcher.SessionBatcher._fused_step

    def half(self, state, pcm):
        pcm = pcm.clone()
        pcm[pcm.shape[0] // 2 :] = 0.0
        return real(self, state, pcm)

    monkeypatch.setattr(batcher.SessionBatcher, "_fused_step", half)


@pytest.mark.parametrize("cell,fault", [
    ("tiny.tiny_solo", _altered_token), ("tiny.tiny_batch", _altered_token),
    ("tiny.tiny_solo", _state_unwritten), ("tiny.tiny_batch", _state_unwritten),
    ("tiny.tiny_batch", _half_batch_left_out)])
def test_broken_step_is_not_correct(tiny_root, monkeypatch, cell, fault):
    fault(monkeypatch)
    result = _run(tiny_root, cell, "cpu", seconds=0.5)
    assert not result["correct"], result["checks"]


def test_no_forbidden_modules():
    code = (
        "import sys\n"
        "import portbench.reference.mimi, portbench.reference.moshi, portbench.lib.judge\n"
        "assert not any(m.split('.')[0] == 'rstnet_tpu_torch' for m in sys.modules), "
        "'the reference loaded the port'\n"
        "import portbench.lib.bench, portbench.lib.serve\n"
        "from rstnet_tpu_torch.serving import server, batcher\n"
        "from portbench.lib.guard import forbidden_loaded\n"
        "assert forbidden_loaded() == [], forbidden_loaded()\n")
    done = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert done.returncode == 0, done.stderr
