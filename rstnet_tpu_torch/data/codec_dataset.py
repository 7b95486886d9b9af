"""Codec training dataset: a wav list -> fixed segments at the codec rate
plus their 16 kHz view (counterpart of ``rstnet_tpu/data/codec_dataset.py``).

Each item is a random ``segment_size``-sample crop (short files are
zero-padded) with optional amplitude scaling, and the matching 16 kHz view
for the semantic teacher. ``WaveIterator`` stacks shuffled batches, read by
a prefetch thread. Where the native C++ loader builds
(``rstnet_tpu_torch/native``), a batch is read by ``load_batch`` in one call
(header probe, windowed channel-0 read and both resamples in C++ threads),
bit for bit what the per-item path reads; else item by item.
"""

from __future__ import annotations

import math
import queue
import random
import threading
from typing import Iterator

import numpy as np

from rstnet_tpu_torch.utils.audio import read_wav, resample_linear


class WaveDataset:
    def __init__(self, flist_file: str, segment_size: int = 72000, sampling_rate: int = 24000,
                 split: bool = True, shuffle: bool = False, audio_norm_scale: float = 1.0,
                 seed: int = 0):
        with open(flist_file) as f:
            self.file_list = [line.strip() for line in f if line.strip()]
        if shuffle:
            random.Random(seed).shuffle(self.file_list)
        self.segment_size, self.sampling_rate = segment_size, sampling_rate
        self.semantic_sample_rate = 16000
        self.split, self.audio_norm_scale = split, audio_norm_scale
        self.segment_16k = int(segment_size / sampling_rate * self.semantic_sample_rate)
        self._rng = random.Random(seed + 1)

    def __len__(self) -> int:
        return len(self.file_list)

    def __getitem__(self, index: int) -> tuple[np.ndarray, np.ndarray]:
        wav, sr = read_wav(self.file_list[index])
        wav = wav[:1]  # mono
        if sr != self.sampling_rate:
            wav = resample_linear(wav, sr, self.sampling_rate)
        if self.audio_norm_scale < 1.0:
            wav = wav * self.audio_norm_scale
        audio = wav[0]
        if self.split:
            if audio.shape[0] >= self.segment_size:
                start = self._rng.randint(0, audio.shape[0] - self.segment_size)
                audio = audio[start: start + self.segment_size]
            else:
                audio = np.pad(audio, (0, self.segment_size - audio.shape[0]))
        audio_16k = resample_linear(audio[None], self.sampling_rate, 16000)[0]
        if self.split:
            if audio_16k.shape[0] >= self.segment_16k:
                audio_16k = audio_16k[: self.segment_16k]
            else:
                audio_16k = np.pad(audio_16k, (0, self.segment_16k - audio_16k.shape[0]))
        return audio[None].astype(np.float32), audio_16k[None].astype(np.float32)

    def load_batch(self, indices: list[int]) -> tuple[np.ndarray, np.ndarray] | None:
        """The native fast path: a whole batch of segments through the C++
        thread-pool loader. Returns (batch24 [N, 1, S], batch16 [N, 1, S16]),
        numerically identical to the per-item path, or None to fall back."""
        if not self.split:
            return None
        try:
            from rstnet_tpu_torch import native

            if not native.available():
                return None
        except Exception:  # noqa: BLE001
            return None
        # Probe every header BEFORE drawing from the RNG, and restore the RNG
        # state on any fallback: the per-item path then draws the same crops
        paths, lens = [], []
        for i in indices:
            path = self.file_list[i]
            info = native.wav_info(path)
            if info is None:
                return None
            n, sr, _ = info
            # the length after the resample; llround (half away from zero), as
            # the C++ loader computes its window
            len_main = (n if sr == self.sampling_rate
                        else int(math.floor(n * self.sampling_rate / sr + 0.5)))
            paths.append(path)
            lens.append(len_main)
        rng_state = self._rng.getstate()
        starts = [self._rng.randint(0, ln - self.segment_size) if ln >= self.segment_size else -1
                  for ln in lens]
        res = native.load_codec_batch(paths, starts, self.segment_size, self.segment_16k,
                                      self.sampling_rate, self.semantic_sample_rate)
        if res is None:
            self._rng.setstate(rng_state)
            return None
        b24, b16, status = res
        if (status != 0).any():
            self._rng.setstate(rng_state)
            return None
        if self.audio_norm_scale < 1.0:
            # the per-item path scales before its 16 kHz resample: resample
            # the scaled segments again, so the rounding is the same (JAX's
            # load_batch scales the resampled view, a last bit apart)
            b24 = b24 * self.audio_norm_scale
            b16 = native.resample_linear(b24, self.sampling_rate, self.semantic_sample_rate)
            short = self.segment_16k - b16.shape[-1]
            b16 = (np.pad(b16, ((0, 0), (0, short))) if short > 0
                   else b16[:, : self.segment_16k])
        return b24[:, None, :], b16[:, None, :]


class WaveIterator:
    """Shuffled batches through a prefetch thread; each host reads a
    disjoint shard (``rank::world_size``). ``fast_batches`` and
    ``item_batches`` count the groups of ``batch_size`` indices read through
    ``load_batch`` and item by item."""

    def __init__(self, dataset: WaveDataset, batch_size: int, shuffle: bool = True,
                 seed: int = 0, rank: int = 0, world_size: int = 1, prefetch: int = 2):
        self.dataset, self.batch_size, self.shuffle = dataset, batch_size, shuffle
        self.seed, self.rank, self.world_size = seed, rank, world_size
        self.prefetch, self.epoch = prefetch, 0
        self.fast_batches = self.item_batches = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        n = len(self.dataset) // self.world_size
        return max(1, n // self.batch_size)

    def _order(self) -> list[int]:
        idx = list(range(len(self.dataset)))
        if self.shuffle:
            random.Random(self.seed + self.epoch).shuffle(idx)
        return idx[self.rank:: self.world_size]

    def __iter__(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        order = self._order()
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                batch24, batch16 = [], []
                for pos in range(0, len(order), self.batch_size):
                    idx = order[pos: pos + self.batch_size]
                    fast = self.dataset.load_batch(idx) if hasattr(self.dataset,
                                                                   "load_batch") else None
                    if fast is not None:
                        self.fast_batches += 1
                        items = list(zip(fast[0], fast[1]))
                    else:
                        self.item_batches += 1
                        items = []
                        for i in idx:
                            try:
                                items.append(self.dataset[i])
                            except Exception:  # noqa: BLE001 - skip a bad utterance
                                continue
                    for a24, a16 in items:
                        batch24.append(a24)
                        batch16.append(a16)
                        if len(batch24) == self.batch_size:
                            if not put((np.stack(batch24), np.stack(batch16))):
                                return
                            batch24, batch16 = [], []
            except BaseException as e:  # noqa: BLE001 - re-raised in the consumer
                # a loader failure fails the epoch rather than ending it quietly
                put(e)
            finally:
                put(None)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()  # a consumer that stops early releases the producer
            t.join()
