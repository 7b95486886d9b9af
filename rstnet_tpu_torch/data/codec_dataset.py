"""Codec training dataset: a wav list -> fixed segments at the codec rate
plus their 16 kHz view (counterpart of ``rstnet_tpu/data/codec_dataset.py``).

Each item is a random ``segment_size``-sample crop (short files are
zero-padded) with optional amplitude scaling, and the matching 16 kHz view
for the semantic teacher. ``WaveIterator`` stacks shuffled batches, read by
a prefetch thread. Items are read one by one; the JAX package's batch fast
path over its C++ loader (``load_batch``) comes with ``native/``
(``ROADMAP.md`` item 13), and until then this dataset has no such method.
"""

from __future__ import annotations

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


class WaveIterator:
    """Shuffled batches through a prefetch thread; each host reads a
    disjoint shard (``rank::world_size``)."""

    def __init__(self, dataset: WaveDataset, batch_size: int, shuffle: bool = True,
                 seed: int = 0, rank: int = 0, world_size: int = 1, prefetch: int = 2):
        self.dataset, self.batch_size, self.shuffle = dataset, batch_size, shuffle
        self.seed, self.rank, self.world_size = seed, rank, world_size
        self.prefetch, self.epoch = prefetch, 0

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
                for i in order:
                    try:
                        a24, a16 = self.dataset[i]
                    except Exception:  # noqa: BLE001 - skip a bad utterance
                        continue
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
