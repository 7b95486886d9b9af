"""The port's native C++ audio runtime (``rstnet_tpu_torch/native``) and the
codec dataset's batch path over it, against the numpy paths and the JAX
package's native runtime, on the CPU.

Mirrors ``tests/test_native.py`` with its tolerances (wav reads within 1e-3
of the written float signal, the native resampler within 1e-4 of
``np.interp``, the stdlib timing margin of 3x). The port builds its own copy
of the C++ source, so its outputs must EQUAL the JAX package's native
outputs, and ``WaveDataset.load_batch`` must equal the per-item path and the
JAX package's ``load_batch`` bit for bit on the same list and seed."""

import tests.test_torch_threads  # noqa: F401 - first: one torch CPU thread a process

import time
import wave

import numpy as np
import pytest

from rstnet_tpu_torch import native


@pytest.fixture(scope="module")
def built():
    if not native.available():
        pytest.skip("native toolchain unavailable")
    return True


def _write_wav_py(path, audio, sr):
    pcm = np.clip(audio * 32767.0, -32768, 32767).astype(np.int16)
    with wave.open(str(path), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sr)
        f.writeframes(pcm.tobytes())


def test_wav_read_parity(built, tmp_path):
    sr = 24000
    audio = (0.5 * np.sin(2 * np.pi * 440 * np.arange(sr) / sr)).astype(np.float32)
    _write_wav_py(tmp_path / "a.wav", audio, sr)
    out = native.read_wav(str(tmp_path / "a.wav"))
    assert out is not None
    data, sr2 = out
    assert sr2 == sr and data.shape[0] == 1
    np.testing.assert_allclose(data[0], audio, atol=1e-3)


def test_wav_read_rejects_garbage(built, tmp_path):
    (tmp_path / "junk.wav").write_bytes(b"this is not a wav file at all")
    assert native.read_wav(str(tmp_path / "junk.wav")) is None
    assert native.read_wav(str(tmp_path / "missing.wav")) is None


def test_resample_parity(built):
    rng = np.random.default_rng(0)
    wav = rng.normal(0, 0.3, (1, 24000)).astype(np.float32)
    nat = native.resample_linear(wav, 24000, 16000)
    x_old = np.linspace(0, 1, wav.shape[-1], endpoint=False)
    x_new = np.linspace(0, 1, 16000, endpoint=False)
    ref = np.interp(x_new, x_old, wav[0]).astype(np.float32)
    assert nat.shape == (1, 16000)
    np.testing.assert_allclose(nat[0], ref, atol=1e-4)


def test_pcm_conversion(built):
    audio = np.asarray([0.0, 0.5, -0.5, 1.5, -1.5], np.float32)
    raw = native.float_to_pcm16(audio)
    vals = np.frombuffer(raw, np.int16)
    assert vals[0] == 0
    assert abs(int(vals[1]) - 16383) <= 1
    assert vals[3] == 32767 and vals[4] == -32768  # clipped


def test_native_faster_than_stdlib(built, tmp_path):
    sr = 24000
    audio = np.random.default_rng(0).normal(0, 0.2, sr * 30).astype(np.float32)
    _write_wav_py(tmp_path / "long.wav", audio, sr)
    path = str(tmp_path / "long.wav")

    def stdlib_read():
        with wave.open(path, "rb") as f:
            raw = f.readframes(f.getnframes())
        return np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0

    def best_of(fn, n=7):
        # min-of-N measures capability, immune to transient load
        best = float("inf")
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - t0)
        return best

    t_native = best_of(lambda: native.read_wav(path))
    t_py = best_of(stdlib_read)
    # the JAX test's margin: the native path is not drastically slower
    assert t_native < t_py * 3


def test_builds_into_the_build_dir_under_a_hashed_name(built):
    path = native.library_path()
    assert path.parent == native.BUILD_DIR and path.exists()
    assert path.name.startswith("librstnet_native_") and path.suffix == ".so"
    assert not list(native.BUILD_DIR.glob("librstnet_native_*.tmp"))


def _signals(tmp_path):
    from rstnet_tpu_torch.utils.audio import write_wav

    rng = np.random.default_rng(11)
    paths = []
    for i, (sr, seconds, ch) in enumerate([(48000, 0.5, 1), (44100, 0.3, 2), (16000, 0.2, 1)]):
        p = str(tmp_path / f"s{i}.wav")
        write_wav(p, rng.uniform(-0.9, 0.9, (ch, int(sr * seconds))).astype(np.float32), sr)
        paths.append(p)
    return paths


def test_native_outputs_equal_jax_native(built, tmp_path):
    """The port's copy of the C++ runtime gives the JAX package's native
    outputs exactly: reads, headers, resamples and PCM conversions."""
    from rstnet_tpu import native as jax_native

    if not jax_native.available():
        pytest.skip("the JAX package's native toolchain is unavailable")
    for p in _signals(tmp_path):
        (mine, sr), (theirs, sr2) = native.read_wav(p), jax_native.read_wav(p)
        assert sr == sr2
        np.testing.assert_array_equal(mine, theirs)
        assert native.wav_info(p) == jax_native.wav_info(p)
        for sr_out in (24000, 16000, 44100):
            np.testing.assert_array_equal(native.resample_linear(mine, sr, sr_out),
                                          jax_native.resample_linear(theirs, sr, sr_out))
        assert native.float_to_pcm16(mine) == jax_native.float_to_pcm16(theirs)
        raw = native.float_to_pcm16(mine)
        np.testing.assert_array_equal(native.pcm16_to_float(raw), jax_native.pcm16_to_float(raw))


def test_audio_helpers_take_the_native_path(built, tmp_path, monkeypatch):
    """``utils/audio.py`` answers through the native loader where it builds,
    so the port's reads and resamples equal the JAX package's (which takes
    its native path here too), and falls back to numpy where it does not."""
    from rstnet_tpu.utils import audio as jax_audio
    from rstnet_tpu_torch.utils import audio

    for p in _signals(tmp_path):
        (mine, sr), (theirs, _) = audio.read_wav(p), jax_audio.read_wav(p)
        np.testing.assert_array_equal(mine, theirs)
        np.testing.assert_array_equal(audio.resample_linear(mine, sr, 24000),
                                      jax_audio.resample_linear(theirs, sr, 24000))
    monkeypatch.setattr(native, "read_wav", lambda path: None)
    monkeypatch.setattr(native, "resample_linear", lambda wav, a, b: None)
    p = _signals(tmp_path)[0]
    wav, sr = audio.read_wav(p)
    np.testing.assert_allclose(wav, jax_audio.read_wav(p)[0], atol=0)
    # the numpy resampler is within the JAX test's 1e-4 of the native one
    np.testing.assert_allclose(audio.resample_linear(wav, sr, 24000),
                               jax_audio.resample_linear(wav, sr, 24000), atol=1e-4)


class TestCodecBatchLoader:
    """The C++ thread-pool segment loader reproduces the per-item path
    exactly (same RNG stream, same resample formula)."""

    def _make_files(self, tmp_path):
        from rstnet_tpu_torch.utils.audio import write_wav

        rng = np.random.default_rng(7)
        paths = []
        for i, (sr, seconds, ch) in enumerate(
                [(48000, 1.1, 1), (24000, 0.9, 2), (16000, 0.1, 1), (22050, 0.7, 1)]):
            wav = rng.uniform(-0.8, 0.8, (ch, int(sr * seconds))).astype(np.float32)
            p = str(tmp_path / f"b{i}.wav")
            write_wav(p, wav, sr)
            paths.append(p)
        flist = tmp_path / "flist.txt"
        flist.write_text("\n".join(paths))
        return str(flist)

    def test_batch_matches_per_item(self, tmp_path):
        from rstnet_tpu_torch.data.codec_dataset import WaveDataset

        if not native.available():
            pytest.skip("native toolchain unavailable")
        flist = self._make_files(tmp_path)
        seg = 9600  # 0.4 s at 24 kHz
        ref_ds = WaveDataset(flist, segment_size=seg, split=True, seed=3)
        fast_ds = WaveDataset(flist, segment_size=seg, split=True, seed=3)
        want = [ref_ds[i] for i in range(4)]
        got = fast_ds.load_batch([0, 1, 2, 3])
        assert got is not None, "native fast path unexpectedly unavailable"
        b24, b16 = got
        assert b24.shape == (4, 1, seg) and b16.shape == (4, 1, ref_ds.segment_16k)
        for i, (a24, a16) in enumerate(want):
            np.testing.assert_allclose(b24[i], a24, atol=2e-5, err_msg=f"24k item {i}")
            np.testing.assert_allclose(b16[i], a16, atol=2e-5, err_msg=f"16k item {i}")

    def test_wav_info_matches_read(self, tmp_path):
        from rstnet_tpu_torch.utils.audio import read_wav, write_wav

        if not native.available():
            pytest.skip("native toolchain unavailable")
        p = str(tmp_path / "info.wav")
        write_wav(p, np.zeros((2, 1234), np.float32), 22050)
        info = native.wav_info(p)
        assert info is not None
        n, sr, ch = info
        wav, sr2 = read_wav(p)
        assert (n, sr, ch) == (wav.shape[1], sr2, wav.shape[0])

    def test_iterator_uses_fast_path(self, tmp_path):
        from rstnet_tpu_torch.data.codec_dataset import WaveDataset, WaveIterator

        flist = self._make_files(tmp_path)
        ds = WaveDataset(flist, segment_size=4800, split=True, seed=1)
        it = WaveIterator(ds, batch_size=2, shuffle=False)
        batches = list(it)
        assert len(batches) == 2
        for b24, b16 in batches:
            assert b24.shape == (2, 1, 4800)
            assert b16.shape == (2, 1, 3200)
            assert np.isfinite(b24).all() and np.isfinite(b16).all()
        assert (it.fast_batches, it.item_batches) == ((2, 0) if native.available() else (0, 2))

    @pytest.mark.parametrize("norm", [1.0, 0.95])
    def test_load_batch_bit_identical_to_per_item_and_jax(self, tmp_path, norm):
        """``load_batch`` equals the per-item path bit for bit, short files
        (zero-padded) and a rate that rounds half away from zero included,
        and leaves the RNG where the per-item path does; the per-item paths
        of both packages are equal. Without amplitude scaling it also equals
        the JAX package's ``load_batch`` bit for bit. With scaling, JAX's
        batch path scales the 16 kHz view after its resample, where its
        per-item path resamples the scaled audio: its 16 kHz view is then
        within ``tests/test_native.py``'s 2e-5 of the port's, which resamples
        the scaled segments and so equals the per-item path."""
        from rstnet_tpu.data.codec_dataset import WaveDataset as JaxWaveDataset
        from rstnet_tpu_torch.data.codec_dataset import WaveDataset

        if not native.available():
            pytest.skip("native toolchain unavailable")
        flist = self._make_files(tmp_path)
        kw = dict(segment_size=9600, split=True, seed=5, audio_norm_scale=norm)
        ref, fast = WaveDataset(flist, **kw), WaveDataset(flist, **kw)
        jax_ref, jax_fast = JaxWaveDataset(flist, **kw), JaxWaveDataset(flist, **kw)
        order = [3, 0, 2, 1]
        want = [ref[i] for i in order]
        got = fast.load_batch(order)
        theirs = jax_fast.load_batch(order)
        assert got is not None and theirs is not None
        for k, (a24, a16) in enumerate(want):
            np.testing.assert_array_equal(got[0][k], a24)
            np.testing.assert_array_equal(got[1][k], a16)
            j24, j16 = jax_ref[order[k]]
            np.testing.assert_array_equal(a24, j24)
            np.testing.assert_array_equal(a16, j16)
        assert fast._rng.getstate() == ref._rng.getstate()
        np.testing.assert_array_equal(got[0], theirs[0])
        if norm == 1.0:
            np.testing.assert_array_equal(got[1], theirs[1])
        else:
            np.testing.assert_allclose(got[1], theirs[1], rtol=0, atol=2e-5)

    def test_fallback_restores_the_rng(self, tmp_path):
        """A file the native loader cannot read makes ``load_batch`` return
        None before any draw, and the iterator reads that group item by item
        (skipping the bad file) with the crops the per-item path draws."""
        from rstnet_tpu_torch.data.codec_dataset import WaveDataset, WaveIterator

        if not native.available():
            pytest.skip("native toolchain unavailable")
        flist = self._make_files(tmp_path)
        (tmp_path / "junk.wav").write_bytes(b"not a wav")
        bad = tmp_path / "bad.txt"
        bad.write_text(str(tmp_path / "junk.wav") + "\n" + open(flist).read())
        ds = WaveDataset(str(bad), segment_size=4800, split=True, seed=2)
        state = ds._rng.getstate()
        assert ds.load_batch([0, 1]) is None
        assert ds._rng.getstate() == state
        it = WaveIterator(ds, batch_size=2, shuffle=False)
        batches = list(it)
        assert (it.fast_batches, it.item_batches) == (2, 1)
        ref = WaveDataset(flist, segment_size=4800, split=True, seed=2)
        want = [ref[i] for i in range(4)]
        np.testing.assert_array_equal(np.concatenate([b[0] for b in batches]),
                                      np.stack([w[0] for w in want]))
        np.testing.assert_array_equal(np.concatenate([b[1] for b in batches]),
                                      np.stack([w[1] for w in want]))
