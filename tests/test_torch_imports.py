"""The port stands alone: no module of ``rstnet_tpu_torch`` and not
``chip_smoke.py`` imports JAX or the JAX package ``rstnet_tpu``, not even a
module of it that imports no JAX. Checked on the source (AST), so a lazy
import inside a function counts too."""

import tests.test_torch_threads  # noqa: F401 - first: one torch CPU thread a process

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "rstnet_tpu")
SOURCES = sorted((ROOT / "rstnet_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    assert not _imported_roots(path) & set(FORBIDDEN)


def test_scan_sees_a_forbidden_import(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("def f():\n    from rstnet_tpu.serving import opus\n    import jax.numpy\n")
    assert _imported_roots(bad) >= {"rstnet_tpu", "jax"}


def test_scan_covers_the_training_slice():
    """The scan reaches every module of the LM training slice."""
    scanned = {str(p.relative_to(ROOT)) for p in SOURCES}
    for module in ("models/config.py", "models/backbone.py", "models/lm.py",
                   "ops/flash_attention.py", "ops/cuda_flash.py", "losses/ce.py",
                   "training/schedulers.py", "training/train_step.py", "training/checkpoint.py",
                   "training/trainer.py", "utils/reporter.py", "utils/arguments.py",
                   "data/task_definition.py", "data/collate.py", "data/dataloader.py"):
        assert f"rstnet_tpu_torch/{module}" in scanned, module


def test_scan_covers_the_speech_inference_slice():
    """The scan reaches every module of the SpeechTextLM streaming-inference
    slice."""
    scanned = {str(p.relative_to(ROOT)) for p in SOURCES}
    for module in ("ops/cuda_ffn.py", "models/backbone.py", "models/lm.py",
                   "ops/cuda_depformer.py", "inference/generate.py", "inference/offline.py",
                   "inference/infer_cli.py", "evalsuite/lm_eval.py", "evalsuite/quant_quality.py",
                   "training/checkpoint.py", "data/tokenizers/abs_tokenizer.py"):
        assert f"rstnet_tpu_torch/{module}" in scanned, module


def test_scan_covers_the_checkpoint_slice():
    """The scan reaches every module of checkpoint loading, the tokenizers
    and offline tokenization."""
    scanned = {str(p.relative_to(ROOT)) for p in SOURCES}
    for module in ("models/convert.py", "tools/convert_checkpoint.py",
                   "tools/upstream_layout.py", "data/tokenizers/text_tokenizer.py",
                   "data/tokenizers/mimi_tokenizer.py", "tools/offline_tokenization.py",
                   "tools/scp_tools.py", "utils/audio.py"):
        assert f"rstnet_tpu_torch/{module}" in scanned, module


def test_scan_covers_the_fine_tuning_slice():
    """The scan reaches every module of LM fine-tuning: LoRA, the PEFT
    step, the Moshi training forwards, flagship8b."""
    scanned = {str(p.relative_to(ROOT)) for p in SOURCES}
    for module in ("models/lora.py", "training/flagship8b.py", "models/moshi_lm.py",
                   "modules/transformer.py", "ops/attention.py", "core.py"):
        assert f"rstnet_tpu_torch/{module}" in scanned, module


def test_scan_covers_the_codec_training_slice():
    """The scan reaches every module of codec training, its round trip and
    its metrics."""
    scanned = {str(p.relative_to(ROOT)) for p in SOURCES}
    for module in ("ops/stft.py", "ops/pqmf.py", "losses/gan.py", "losses/enh.py",
                   "quantization/base.py", "quantization/codebook.py",
                   "quantization/trainable.py", "models/mimi_train.py",
                   "models/discriminators.py", "data/synth_speech.py", "data/codec_dataset.py",
                   "data/semantic_features.py", "training/codec_trainer.py",
                   "inference/codec_infer.py", "evalsuite/metrics.py",
                   "evalsuite/compute_metrics.py", "utils/yaml_subset.py"):
        assert f"rstnet_tpu_torch/{module}" in scanned, module


def test_scan_covers_the_ssl_slice():
    """The scan reaches every module of the GLM-4-Voice SSL stack: the
    WhisperVQ tokenizer, the flow + HiFT decoder and their tools."""
    scanned = {str(p.relative_to(ROOT)) for p in SOURCES}
    for module in ("models/whisper_vq.py", "models/glm4v_flow.py", "models/hift.py",
                   "models/glm4v_decoder.py", "data/tokenizers/ssl_tokenizer.py",
                   "tools/ssl_resynth.py", "tools/offline_tokenization.py",
                   "tools/upstream_layout.py", "utils/yaml_subset.py", "ops/stft.py"):
        assert f"rstnet_tpu_torch/{module}" in scanned, module


def test_scan_covers_the_data_prep_slice():
    """The scan reaches every module of the data-prep slice: the pipeline,
    the native loader's wrapper, the duplex client and the recipe tools."""
    scanned = {str(p.relative_to(ROOT)) for p in SOURCES}
    for module in ("pipeline/__init__.py", "pipeline/vad.py", "pipeline/filters.py",
                   "pipeline/diarize.py", "pipeline/onnx_models.py", "pipeline/adapters.py",
                   "pipeline/main.py", "native/__init__.py", "serving/client.py",
                   "tools/run_jobs.py", "tools/create_data_json.py", "utils/audio.py",
                   "data/codec_dataset.py", "evalsuite/metrics.py"):
        assert f"rstnet_tpu_torch/{module}" in scanned, module
    assert (ROOT / "rstnet_tpu_torch/native/rstnet_native.cpp").exists()


def test_scan_covers_the_parallel_slice():
    """The scan reaches every module of the parallel-training slice, and the
    test ranks' module (which the parallel tests start as processes) imports
    no JAX either."""
    scanned = {str(p.relative_to(ROOT)) for p in SOURCES}
    for module in ("parallel/__init__.py", "parallel/mesh.py", "parallel/sharding.py",
                   "parallel/pipeline.py", "parallel/comm.py", "ops/context_parallel.py",
                   "training/train_step.py", "training/trainer.py", "training/codec_trainer.py",
                   "training/checkpoint.py", "training/flagship8b.py", "data/dataloader.py",
                   "quantization/codebook.py", "quantization/trainable.py"):
        assert f"rstnet_tpu_torch/{module}" in scanned, module
    assert not _imported_roots(ROOT / "tests" / "torch_parallel_ranks.py") & set(FORBIDDEN)
