"""The port's data layer (``rstnet_tpu_torch/data/{collate,dataloader,
task_definition}.py``, copies of the JAX package's), mirroring the eight
tests of ``tests/test_data.py`` that ``tests/test_torch_tokenizers.py`` does
not: each result is held to the JAX function's on the same input, exactly
(integer grids, orders and batches equal; masks equal as float32).
``test_collate_golden_vs_reference`` needs the PyTorch reference tree and
skips without it, as its JAX twin does."""

import tests.test_torch_threads  # noqa: F401 - first: one torch CPU thread a process

import json

import numpy as np

from rstnet_tpu.data import collate as jax_collate
from rstnet_tpu.data import dataloader as jax_loader
from rstnet_tpu_torch.data.collate import Collator, bucket_length, default_buckets
from rstnet_tpu_torch.data.dataloader import (
    SyncSampler,
    batchfy,
    build_data_iterator,
    find_data_jsons,
)


class StubTokenizer:
    def tokenize2(self, x):
        return np.asarray(x, np.int64)

    def find_length(self, x):
        return int(np.shape(x)[-1])


TOKENIZERS = {"text": StubTokenizer(), "audio": StubTokenizer()}


def _mk_collator(cls=Collator, **kw):
    return cls(TOKENIZERS, max_length=64, delay_step=1, parallel_number=9, **kw)


def _same(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            np.testing.assert_array_equal(a[k], np.asarray(b[k]))
        else:
            assert a[k] == b[k], k


def test_delay_shapes_and_pattern():
    c, j = _mk_collator(), _mk_collator(jax_collate.Collator)
    grid = np.arange(9 * 5).reshape(9, 5)
    weight = np.ones((9, 5), np.float32)
    out, w = c.delay(grid, weight)
    jout, jw = j.delay(grid, weight)
    np.testing.assert_array_equal(out, jout)
    np.testing.assert_array_equal(w, jw)
    assert out.shape == (9, 6)
    np.testing.assert_array_equal(out[0, :5], grid[0])
    assert out[0, 5] == c.sp.text_empty
    np.testing.assert_array_equal(out[1, :5], grid[1])
    assert out[1, 5] == c.sp.semantic_empty
    for r in range(2, 9):
        assert out[r, 0] == c.sp.acoustic_empty
        np.testing.assert_array_equal(out[r, 1:], grid[r])
    # reverse round-trips
    rec = c.reverse_delay(out)
    np.testing.assert_array_equal(rec, grid)
    np.testing.assert_array_equal(rec, j.reverse_delay(jout))


def test_collate_golden_vs_reference(torch_reference):
    """Full batch collation matches the reference ``Collate_Fn_Factory``."""
    torch = torch_reference
    from tests.refpath import MLLM_V2_ROOT, ensure_reference_root, stub_module

    stub_module("omegaconf", OmegaConf=object)
    stub_module("torchaudio")
    ensure_reference_root(MLLM_V2_ROOT)
    from utils.dataloader import Collate_Fn_Factory

    class TorchStub:
        def tokenize2(self, x):
            return torch.as_tensor(np.asarray(x)).long()

        def find_length(self, x):
            return int(np.shape(x)[-1])

    rng = np.random.default_rng(0)
    items = []
    for i in range(3):
        T = int(rng.integers(4, 10))
        if i == 0:
            d = {"task": "text_only", "text_seq": rng.integers(0, 1000, (T,))}
        elif i == 1:
            d = {"task": "audio_only", "audio_seq": rng.integers(0, 2048, (8, T))}
        else:
            d = {"task": "word_level_audio_text_alignment",
                 "text_seq": rng.integers(0, 1000, (1, T)),
                 "audio_seq": rng.integers(0, 2048, (8, T))}
        items.append((f"utt{i}", d))
    ref_collate = Collate_Fn_Factory(tokenizers={"text": TorchStub(), "audio": TorchStub()},
                                     max_length=64, delay_step=1, parallel_number=9)
    seq_ref, mask_ref, lengths_ref, ids_ref = ref_collate([items])
    mine = _mk_collator()
    out = mine(items)
    Tref = seq_ref.shape[-1]
    np.testing.assert_array_equal(out["tokens"][:, :, :Tref], seq_ref.numpy())
    np.testing.assert_allclose(out["masks"][:, :, :Tref], mask_ref.numpy(), atol=1e-6)
    np.testing.assert_array_equal(out["lengths"], lengths_ref.numpy())
    assert out["example_ids"] == ids_ref


def test_interleaved_task_collate():
    c, j = _mk_collator(), _mk_collator(jax_collate.Collator)
    rng = np.random.default_rng(1)
    d = {"task": "setence_level_text_audio_interleaved",
         "text_seq": rng.integers(0, 100, (4,)),
         "audio_seq": rng.integers(0, 2048, (8, 6))}
    grid, weight = c.splice(d)
    jgrid, jweight = j.splice(d)
    np.testing.assert_array_equal(grid, jgrid)
    np.testing.assert_array_equal(weight, jweight)
    assert grid.shape == (9, 10)
    # text block first: audio rows empty with down-weighted mask
    assert (grid[1, :4] == c.sp.semantic_empty).all()
    np.testing.assert_allclose(weight[1:, :4], 1.0 / (4 * 8))
    # audio block: text row empty, weight 1/T_audio
    assert (grid[0, 4:] == c.sp.text_empty).all()
    np.testing.assert_allclose(weight[0, 4:], 1.0 / 6)
    # the whole batch, three tasks, as JAX collates it
    items = [("t", {"task": "text_only", "text_seq": rng.integers(0, 1000, (7,))}),
             ("a", {"task": "audio_only", "audio_seq": rng.integers(0, 2048, (8, 5))}),
             ("i", d)]
    _same(c(items), j(items))


def test_buckets():
    buckets = default_buckets(1000)
    assert buckets == jax_collate.default_buckets(1000)
    assert bucket_length(1, buckets) == 64
    assert bucket_length(65, buckets) == 96
    assert bucket_length(10**6, buckets) == buckets[-1]
    assert all(b2 > b1 for b1, b2 in zip(buckets, buckets[1:]))
    for max_length in (100, 511, 1023, 4095):
        b = default_buckets(max_length)
        assert b == jax_collate.default_buckets(max_length)
        for n in (1, 63, 64, 65, 300, 10**6):
            assert bucket_length(n, b) == jax_collate.bucket_length(n, b)


def test_batchfy_budget_and_text_mixing():
    data = {f"a{i}": {"length": 10 + i, "task": "audio_only"} for i in range(20)}
    text = {f"t{i}": {"length": 5, "task": "text_only"} for i in range(10)}
    batches = batchfy(data, list(data), text, list(text), batch_scale=50)
    assert batches == jax_loader.batchfy(data, list(data), text, list(text), batch_scale=50)
    assert sum(len(b) for b in batches) >= 20
    # every completed batch (all but possibly the last) mixes in text
    for b in batches[:-1]:
        assert any(u.startswith("t") for u in b), b


def test_sampler_determinism_and_epochs():
    s1 = SyncSampler(17, seed=3)
    s2 = SyncSampler(17, seed=3)
    j = jax_loader.SyncSampler(17, seed=3)
    assert list(s1) == list(s2) == list(j)
    first = list(s1)
    s1.refresh()
    j.refresh()
    assert list(s1) != first  # new epoch, new order
    assert list(s1) == list(j)
    assert sorted(first) == list(range(17))


def test_end_to_end_iterator(tmp_path):
    rng = np.random.default_rng(0)
    audio = {f"u{i}": rng.integers(0, 2048, (8, int(rng.integers(6, 14)))) for i in range(8)}
    text = {f"u{i}": rng.integers(0, 1000, (int(rng.integers(4, 9)),)) for i in range(4)}
    np.savez(tmp_path / "audio.npz", **audio)
    np.savez(tmp_path / "text.npz", **text)
    audio_json = tmp_path / "audio.json"
    text_json = tmp_path / "text.json"
    audio_json.write_text(json.dumps(
        {"task": "audio_only", "keys": {"audio_seq": str(tmp_path / "audio.npz")}}))
    text_json.write_text(json.dumps(
        {"task": "text_only", "keys": {"text_seq": str(tmp_path / "text.npz")}}))
    from rstnet_tpu.data.task_definition import load_data_for_all_tasks as jax_load
    from rstnet_tpu_torch.data.task_definition import load_data_for_all_tasks

    runs = []
    for load, build in ((load_data_for_all_tasks, build_data_iterator),
                        (jax_load, jax_loader.build_data_iterator)):
        data_dict, text_dict = load([str(audio_json), str(text_json)])
        assert len(data_dict) == 8 and len(text_dict) == 4
        it = build(data_dict, text_dict, TOKENIZERS, batch_scale=40, max_length=64,
                   parallel_number=9)
        runs.append(list(it))
    batches = runs[0]
    assert batches and len(batches) == len(runs[1])
    for b, jb in zip(batches, runs[1]):
        assert b["tokens"].shape[1] == 9
        assert b["tokens"].shape == b["masks"].shape
        assert (b["masks"] >= 0).all()
        _same(b, jb)


def test_find_data_jsons(tmp_path):
    for i in range(4):
        (tmp_path / f"d{i}.json").write_text("{}")
    files = find_data_jsons(str(tmp_path / "*.json"), rank=1, world_size=2)
    assert len(files) == 2
    assert all("d1" in f or "d3" in f for f in files)
    assert files == jax_loader.find_data_jsons(str(tmp_path / "*.json"), rank=1, world_size=2)
