"""Delay-pattern collation: [B, 9|17, T] token grids and loss masks
(counterpart of ``rstnet_tpu/data/collate.py``, copied, buckets unchanged).

Row 0 text, rows 1..8 audio codebooks (9..16 the second stream for duplex);
acoustic rows shift right by ``delay_step`` with empty tokens in the gap;
per-task padding inserts modality-empty tokens with down-weighted loss
masks; rows past an example's length are pad tokens of weight 0. Batches are
padded to a bucketed length (``default_buckets``), not the batch maximum.
Note: with ``--max_length 1000`` no bucket is a multiple of 512, so the
training forward never takes the flash kernel; ``--max_length 1023`` gives
a top bucket of 1024.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from rstnet_tpu_torch.data.task_definition import task_formats


@dataclasses.dataclass(frozen=True)
class SpecialTokens:
    """Special ids (llama3 defaults, ``dataloader.py:310-338``)."""

    text_empty: int = 128002
    text_pad: int = 128003
    text_empty_pad: int = 128004  # <epad> word-boundary marker
    text_eos: int = 128005
    semantic_empty: int = 2048
    acoustic_empty: int = 2048
    semantic_pad: int = 2049
    acoustic_pad: int = 2049


def default_buckets(max_length: int) -> tuple[int, ...]:
    """Pad-target lengths: 1.25x geometric steps from 64 to max_length."""
    buckets = [64]
    while buckets[-1] < max_length:
        buckets.append(min(max_length, max(buckets[-1] + 32, int(buckets[-1] * 1.25))))
    return tuple(buckets)


def bucket_length(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


class Collator:
    """Collate a list of (example_id, data) into a padded token grid."""

    def __init__(
        self,
        tokenizers: dict,
        max_length: int = 15000,
        delay_step: int = 1,
        parallel_number: int = 9,
        special: SpecialTokens = SpecialTokens(),
        buckets: Optional[Sequence[int]] = None,
    ):
        assert parallel_number in (9, 17)
        self.tokenizers = tokenizers
        self.max_length = max_length
        self.delay_step = delay_step
        self.parallel = parallel_number
        self.sp = special
        self.buckets = tuple(buckets) if buckets is not None else default_buckets(
            max_length + delay_step
        )

    # -- per-example grid construction (splice_sequence:394-445) -------------

    def text_pad(self, x: np.ndarray) -> np.ndarray:
        """Text tokens + modality-empty audio rows."""
        grid = np.ones((self.parallel, len(x)), np.int64)
        grid[0] = x
        grid[1] = self.sp.semantic_empty
        grid[2:] = self.sp.acoustic_empty
        return grid

    def audio_pad(self, x: np.ndarray) -> np.ndarray:
        """Audio codebooks + text-empty row."""
        grid = np.full((self.parallel, x.shape[1]), self.sp.text_empty, np.int64)
        grid[1:] = x
        return grid

    def splice(self, d: dict) -> tuple[np.ndarray, np.ndarray]:
        """-> (grid [P, T], loss weights [P, T]) per task semantics."""
        task = d["task"]
        P = self.parallel
        if task == "text_only":
            data = _as_tokens(self.tokenizers["text"], d["text_seq"])
            grid = self.text_pad(data)
            weight = np.ones((P, grid.shape[1]), np.float32)
            weight[1:] = 1.0 / (grid.shape[1] * 8)
        elif task in ("audio_only", "moshi_ft"):
            audio = _as_tokens(self.tokenizers["audio"], d["audio_seq"])
            if task == "moshi_ft":
                # pre-stacked [17, T] grid (text + both streams)
                grid = audio.astype(np.int64)
                weight = np.ones((P, grid.shape[1]), np.float32)
            else:
                grid = self.audio_pad(audio)
                weight = np.ones((P, grid.shape[1]), np.float32)
                weight[0] = 1.0 / grid.shape[1]
        elif task == "word_level_audio_text_alignment":
            text = _as_tokens(self.tokenizers["text"], d["text_seq"])
            audio = _as_tokens(self.tokenizers["audio"], d["audio_seq"])
            T = text.shape[-1]
            if audio.shape[-1] < T:
                # the 12.5 Hz frame counts of the word-aligned text row and
                # the codec tokens can differ by a rounding frame — pad the
                # audio with acoustic pads rather than crash
                audio = np.pad(
                    audio, ((0, 0), (0, T - audio.shape[-1])),
                    constant_values=self.sp.acoustic_pad,
                )
            grid = np.ones((P, T), np.int64)
            grid[0] = text.reshape(-1)[:T]
            grid[1:] = audio[:, :T]
            weight = np.ones((P, T), np.float32)
            count = int((grid[0] == self.sp.text_empty_pad).sum())
            if count > 0:
                weight[0] = np.where(grid[0] == self.sp.text_empty_pad, 1.0 / count, 1.0)
        else:
            # sentence/segment/word-level interleaving: text block then audio
            # block along time, each padded on the other modality
            text = _as_tokens(self.tokenizers["text"], d["text_seq"])
            audio = _as_tokens(self.tokenizers["audio"], d["audio_seq"])
            tgrid = self.text_pad(text)
            tweight = np.ones((P, tgrid.shape[1]), np.float32)
            tweight[1:] = 1.0 / (tgrid.shape[1] * 8)
            agrid = self.audio_pad(audio)
            aweight = np.ones((P, agrid.shape[1]), np.float32)
            aweight[0] = 1.0 / agrid.shape[1]
            if task == "setence_level_text_audio_interleaved":
                grid = np.concatenate([tgrid, agrid], axis=1)
                weight = np.concatenate([tweight, aweight], axis=1)
            else:
                grid = np.concatenate([agrid, tgrid], axis=1)
                weight = np.concatenate([aweight, tweight], axis=1)
        return grid, weight

    # -- delay pattern (delay:340-376) ----------------------------------------

    def delay(self, grid: np.ndarray, weight: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Shift acoustic rows right by delay_step; text/semantic rows keep
        their position and get empty-token right padding."""
        P, T = grid.shape
        ds = self.delay_step
        out = np.ones((P, T + ds), np.int64)
        sem_rows = (1,) if P == 9 else (1, 9)
        # text & semantic: unshifted, empty-token tail
        out[0, :T] = grid[0]
        out[0, T:] = self.sp.text_empty
        for r in sem_rows:
            out[r, :T] = grid[r]
            out[r, T:] = self.sp.semantic_empty
        # acoustic rows: shifted right, empty-token head
        ac_rows = [r for r in range(1, P) if r not in sem_rows]
        for r in ac_rows:
            out[r, :ds] = self.sp.acoustic_empty
            out[r, ds:] = grid[r]
        new_weight = np.ones((P, T + ds), np.float32)
        new_weight[:, :T] = weight
        return out, new_weight

    def reverse_delay(self, grid: np.ndarray) -> np.ndarray:
        """Undo the delay pattern on a generated [P, T] grid
        (``infer_no_streaming.py:311`` equivalent)."""
        P, T = grid.shape
        ds = self.delay_step
        sem_rows = (1,) if P == 9 else (1, 9)
        out = np.empty((P, T - ds), grid.dtype)
        for r in range(P):
            if r == 0 or r in sem_rows:
                out[r] = grid[r, : T - ds]
            else:
                out[r] = grid[r, ds:]
        return out

    # -- batch assembly (decoder_only_collate_fn:454-473) ---------------------

    def init_grid(self, batch_size: int, length: int) -> np.ndarray:
        grid = np.empty((batch_size, self.parallel, length), np.int64)
        grid[:, 0, :] = self.sp.text_pad
        grid[:, 1:2, :] = self.sp.semantic_pad
        grid[:, 2:, :] = self.sp.acoustic_pad
        if self.parallel == 17:
            grid[:, 9:10, :] = self.sp.semantic_pad
        return grid

    def __call__(self, batch: list) -> dict:
        B = len(batch)
        items = []
        for example_id, d in batch:
            grid, weight = self.splice(d)
            grid, weight = self.delay(grid, weight)
            items.append((example_id, grid, weight))
        lengths = np.asarray([g.shape[1] for _, g, _ in items], np.int64)
        T = bucket_length(int(lengths.max()), self.buckets)
        tokens = self.init_grid(B, T)
        masks = np.zeros((B, self.parallel, T), np.float32)
        ids = []
        for i, (example_id, grid, weight) in enumerate(items):
            L = min(grid.shape[1], T)
            tokens[i, :, :L] = grid[:, :L]
            masks[i, :, :L] = weight[:, :L]
            ids.append(example_id)
        return {
            "tokens": tokens,
            "masks": masks,
            "lengths": lengths,
            "example_ids": ids,
        }


def _as_tokens(tokenizer, x) -> np.ndarray:
    """Stored data -> int64 numpy tokens (tokenize2 semantics)."""
    if tokenizer is not None and hasattr(tokenizer, "tokenize2"):
        x = tokenizer.tokenize2(x)
    return np.asarray(x).astype(np.int64)


def find_length_of(d: dict, tokenizers: dict) -> int:
    fmt = task_formats[d["task"]]
    # fmt["type"] is ordered per fmt["keys"], NOT per fmt["loss_key"] (the
    # interleaved tasks list keys=[audio, text] but loss_key=[text, audio]):
    # map each loss key to its own tokenizer type
    key_type = dict(zip(fmt["keys"], fmt["type"]))
    return sum(tokenizers[key_type[k]].find_length(d[k]) for k in fmt["loss_key"])
