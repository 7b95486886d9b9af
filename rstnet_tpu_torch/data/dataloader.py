"""Token-budget batching, the epoch sampler and the data iterator
(counterpart of ``rstnet_tpu/data/dataloader.py``, copied for one process).

Length pre-scan, length filtering, token-budget batching with text-only
examples mixed into every batch, hour-weighted task rebalancing, and a
sampler that chunk-shuffles the length-sorted batches locally and shuffles
them globally with a per-epoch seed. Across processes every one is padded
to the largest batch count (``_allreduce_max_hosts``, a MAX all-reduce over
the default process group), so all of them step the same number of
batches; the JAX package pads its hosts the same way.
"""

from __future__ import annotations

import glob
import logging
import queue
import random
import threading
from typing import Iterator, Optional

import torch
import torch.distributed as dist

from rstnet_tpu_torch.data.collate import Collator, SpecialTokens, find_length_of
from rstnet_tpu_torch.data.task_definition import load_data_for_all_tasks


def find_data_jsons(paths: str, rank: Optional[int] = None, world_size: Optional[int] = None):
    """Expand comma-separated globs and slice ``[rank::world_size]`` so every
    host reads a disjoint shard of manifests."""
    files: list[str] = []
    for p in paths.split(","):
        found = sorted(glob.glob(p))
        if not found and p:
            raise FileNotFoundError(f"no data json matches {p}")
        files.extend(found)
    if rank is None or world_size is None:
        rank, world_size = 0, 1
    if world_size > 1 and len(files) >= world_size:
        files = files[rank::world_size]
    return files


def find_all_length(data_dict: dict, tokenizers: dict) -> None:
    for d in data_dict.values():
        d["length"] = find_length_of(d, tokenizers)


def filter_data(data_dict: dict, max_length: int, min_length: int) -> list[str]:
    keys = list(data_dict.keys())
    if max_length <= 0 and min_length <= 0:
        return keys
    valid = [
        k
        for k in keys
        if (max_length <= 0 or data_dict[k]["length"] <= max_length)
        and (min_length <= 0 or data_dict[k]["length"] >= min_length)
    ]
    logging.info(f"length filter [{min_length}, {max_length}]: kept {len(valid)}/{len(keys)}")
    return valid


def batchfy(
    data_dict: dict,
    batch_utts: list[str],
    text_dict: dict,
    batch_text_utts: list[str],
    batch_scale: int,
    text_budget_slack: int = 700,
) -> list[list[str]]:
    """Length-sorted token-budget batching; when a batch fills up, text-only
    examples are appended until the budget (+slack) is reached so every batch
    mixes text (``dataloader.py:171-210``)."""
    batch_utts = sorted(batch_utts, key=lambda x: data_dict[x]["length"])
    # zero-length text would never consume budget and spin the mixing loop
    batch_text_utts = sorted(
        (u for u in batch_text_utts if text_dict[u]["length"] > 0),
        key=lambda x: text_dict[x]["length"],
    )
    text_lengths = [text_dict[k]["length"] for k in batch_text_utts]
    n_text = len(text_lengths)

    batches: list[list[str]] = []
    batch: list[str] = []
    summed = 0
    idx = 0
    for utt in batch_utts:
        length = data_dict[utt]["length"]
        if length + summed > batch_scale:
            while n_text > 0 and summed + text_lengths[idx % n_text] < batch_scale + text_budget_slack:
                idx = idx % n_text
                batch.append(batch_text_utts[idx])
                summed += text_lengths[idx]
                idx += 1
            assert batch, f"batch_scale {batch_scale} too small for example of length {length}"
            batches.append(batch)
            batch, summed = [], 0
        summed += length
        batch.append(utt)
    if batch:
        batches.append(batch)
    logging.info(f"batchfy: {len(batches)} batches")
    return batches


def rebalance_data(
    data_dict: dict,
    valid_utts: list[str],
    alpha: float,
    data_hours: Optional[dict[str, float]] = None,
    max_samples: int = 1_000_000,
    seed: int = 0,
) -> list[str]:
    """Temperature-resample utts by per-task hour weights
    (``dataloader.py:90-143``)."""
    default_hours = {
        "text_only": 50, "audio_only": 30,
        "setence_level_text_audio_interleaved": 10,
        "segment_level_audio_text_interleaved": 10,
        "word_level_audio_text_interleaved": 10,
        "word_level_audio_text_alignment": 10,
    }
    hours = data_hours or default_hours
    per_task: dict[str, list[str]] = {}
    for utt in valid_utts:
        per_task.setdefault(data_dict[utt]["task"], []).append(utt)
    # tasks without a configured hour count get a neutral default weight
    weights = {k: hours.get(k, 10) ** alpha for k in per_task}
    total = sum(weights.values())
    weights = {k: v / total for k, v in weights.items()}
    rng = random.Random(seed)
    tasks = list(weights.keys())
    probs = [weights[t] for t in tasks]
    out = []
    for _ in range(min(len(valid_utts), max_samples)):
        task = rng.choices(tasks, probs)[0]
        out.append(rng.choice(per_task[task]))
    return out


def _allreduce_max_hosts(value: int, group=None) -> int:
    """The largest batch count over the processes of ``group`` (the default
    process group); one process: its own."""
    if not dist.is_available() or not dist.is_initialized() or dist.get_world_size(group) == 1:
        return value
    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend(group) == "nccl" else torch.device("cpu"))
    t = torch.tensor([value], dtype=torch.int64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return int(t.item())


class SyncSampler:
    """Per-epoch batch-order sampler, synchronized across hosts.

    Local chunk-shuffle (size 10) keeps similar lengths together while
    de-correlating epochs; a global shuffle with a shared per-epoch seed
    follows; hosts with fewer batches repeat their first ones so every host
    steps the same count (reference DDPSyncSampler semantics)."""

    def __init__(self, size: int, seed: int, is_train: bool = True, rank: int = 0):
        self.size = size
        self.seed = seed
        self.is_train = is_train
        self.rank = rank
        self.epoch = 0
        self.pad_number = _allreduce_max_hosts(size) - size
        self.refresh()

    def refresh(self) -> None:
        seq = list(range(self.size))
        if self.is_train:
            rng = random.Random(self.rank + self.seed + self.epoch)
            chunk = 10
            for start in range(0, self.size, chunk):
                seg = seq[start : start + chunk]
                rng.shuffle(seg)
                seq[start : start + chunk] = seg
            random.Random(self.seed + self.epoch).shuffle(seq)
        if self.pad_number > 0:
            if self.size == 0:
                raise RuntimeError(
                    "this host has 0 batches while another host has "
                    f"{self.pad_number}: collective train steps would hang — "
                    "rebalance the per-host manifest shards"
                )
            # repeat own batches cyclically up to the global MAX count so
            # every host steps the same number of batches (reference
            # DDPSyncSampler, utils/dataloader.py:262-288)
            seq = [seq[i % self.size] for i in range(self.pad_number)] + seq
        self.seq = seq
        self.epoch += 1

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __iter__(self):
        return iter(self.seq)

    def __len__(self):
        return len(self.seq)

    def state_dict(self) -> dict:
        return {"epoch": self.epoch, "seed": self.seed}

    def load_state_dict(self, d: dict) -> None:
        for k, v in d.items():
            setattr(self, k, v)


class DataIterator:
    """Batches-of-batches iterator with a background prefetch thread
    (replaces torch DataLoader workers)."""

    def __init__(
        self,
        batches: list[list[str]],
        data_dict: dict,
        collator: Collator,
        sampler: SyncSampler,
        prefetch: int = 4,
    ):
        self.batches = batches
        self.data_dict = data_dict
        self.collator = collator
        self.sampler = sampler
        self.prefetch = prefetch

    def __len__(self):
        return len(self.sampler)

    def _produce(self, q: "queue.Queue", order: list[int]):
        try:
            for idx in order:
                uttids = self.batches[idx]
                batch = [(u, self.data_dict[u]) for u in uttids]
                q.put(self.collator(batch))
        except BaseException as e:  # noqa: BLE001 - re-raised in the consumer
            # a malformed example must FAIL the epoch, not silently end it
            q.put(e)
        finally:
            q.put(None)

    def __iter__(self) -> Iterator[dict]:
        order = list(self.sampler)
        if self.prefetch <= 0:
            for idx in order:
                uttids = self.batches[idx]
                yield self.collator([(u, self.data_dict[u]) for u in uttids])
            return
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        t = threading.Thread(target=self._produce, args=(q, order), daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is None:
                break
            if isinstance(item, BaseException):
                raise item
            yield item


def build_data_iterator(
    data_dict: dict,
    text_dict: dict,
    tokenizers: dict,
    delay_step: int = 1,
    max_length: int = -1,
    min_length: int = -1,
    batch_scale: int = 1000,
    is_train: bool = True,
    seed: int = 999,
    minibatch_debug: int = -1,
    parallel_number: int = 9,
    special=None,
    rank: int = 0,
    rebalance_alpha: float = 0.0,
    data_hours: Optional[dict] = None,
) -> DataIterator:
    find_all_length(data_dict, tokenizers)
    find_all_length(text_dict, tokenizers)
    valid = filter_data(data_dict, max_length, min_length)
    valid_text = filter_data(text_dict, max_length, min_length)
    if is_train and rebalance_alpha > 0.0:
        # temperature-resample by per-task hour weights (reference
        # rebalance_data, dataloader.py:90-143)
        valid = rebalance_data(
            data_dict, valid, rebalance_alpha, data_hours, seed=seed
        )
    batches = batchfy(data_dict, valid, text_dict, valid_text, batch_scale)
    if minibatch_debug > 0:
        batches = batches[: min(minibatch_debug, len(batches))]
    all_data = {}
    all_data.update(data_dict)
    all_data.update(text_dict)
    collator = Collator(
        tokenizers,
        max_length=max_length if max_length > 0 else 15000,
        delay_step=delay_step,
        parallel_number=parallel_number,
        special=special or SpecialTokens(),
    )
    sampler = SyncSampler(len(batches), seed=seed, is_train=is_train, rank=rank)
    return DataIterator(batches, all_data, collator, sampler)


def get_data_iterator_tokenizer_vocabulary(
    tokenizers: dict,
    train_jsons,
    valid_jsons,
    **kwargs,
) -> tuple[DataIterator, DataIterator]:
    """Top-level data entry (``dataloader.py:480-574``): manifests in, a
    (train, valid) iterator pair out."""
    train_data, train_text = load_data_for_all_tasks(train_jsons)
    valid_data, valid_text = load_data_for_all_tasks(valid_jsons)
    train_iter = build_data_iterator(
        train_data, train_text, tokenizers, is_train=True, **kwargs
    )
    valid_iter = build_data_iterator(
        valid_data, valid_text, tokenizers, is_train=False, **kwargs
    )
    return train_iter, valid_iter
