"""Text tokenizer with word-aligned frame padding (a copy of
``rstnet_tpu/data/tokenizers/text_tokenizer.py``).

Capability parity with ``MLLM_v2/tools/tokenizer/Text2ID/text_tokenizer.py``:
HF tokenizers or sentencepiece backends with BOS/EOS resolution from
checkpoint configs; word-aligned padding places subword ids at word-start
frames of the 12.5 Hz grid, inserting ``<epad>`` before each word and
``<pad>`` elsewhere (pad_tokens:116-142); ``tokenize_segment`` consumes
whisperX-style word timestamps.

The backends are imported only when a tokenizer is built: ``tokenizers`` for
a ``tokenizer.json``, ``sentencepiece`` for a ``tokenizer*.model``. Where
the one a directory needs is missing, the constructor raises an
``ImportError`` that names the package.
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Optional, Union

import numpy as np

from rstnet_tpu_torch.data.tokenizers.abs_tokenizer import AbsTokenizer


def _backend(package: str, name: str, vocab: Path):
    """``package.name``, or an ImportError naming the package ``vocab``
    needs."""
    import importlib

    try:
        module = importlib.import_module(package)
    except ImportError as e:
        raise ImportError(f"{vocab} needs the {package!r} package, which is not "
                          f"installed") from e
    return getattr(module, name)


class TextTokenizer(AbsTokenizer):
    def __init__(
        self,
        checkpoint_dir: Union[str, Path],
        max_length: int = 500,
        pad_id: int = 128004,
        epad_id: int = 128005,
    ):
        checkpoint_dir = Path(checkpoint_dir)
        if not checkpoint_dir.exists():
            raise NotADirectoryError(str(checkpoint_dir))
        self.bos_id: Optional[int] = None
        self.eos_id: Optional[int] = None
        if (vocab := checkpoint_dir / "tokenizer.json").is_file():
            HFTokenizer = _backend("tokenizers", "Tokenizer", vocab)

            self.model = HFTokenizer.from_file(str(vocab))
            self.backend = "huggingface"
            if (cfg_path := checkpoint_dir / "tokenizer_config.json").is_file():
                with open(cfg_path, encoding="utf-8") as fp:
                    cfg = json.load(fp)
                for attr, name in (("bos_id", "bos_token"), ("eos_id", "eos_token")):
                    tok = cfg.get(name)
                    if isinstance(tok, dict):
                        tok = tok.get("content")
                    if tok is not None:
                        setattr(self, attr, self.token_to_id(tok))
            if (gen_path := checkpoint_dir / "generation_config.json").is_file():
                try:
                    with open(gen_path, encoding="utf-8") as fp:
                        cfg = json.load(fp)
                    if self.bos_id is None:
                        self.bos_id = cfg.get("bos_token_id")
                    if self.eos_id is None:
                        self.eos_id = cfg.get("eos_token_id")
                except json.JSONDecodeError:
                    pass
        else:
            vocab = next(checkpoint_dir.glob("tokenizer*.model"), None)
            assert vocab is not None, f"no tokenizer file in {checkpoint_dir}"
            SentencePieceProcessor = _backend("sentencepiece", "SentencePieceProcessor", vocab)

            self.model = SentencePieceProcessor(model_file=str(vocab))
            self.backend = "sentencepiece"
            self.bos_id = self.model.bos_id()
            self.eos_id = self.model.eos_id()
        self.pad_id = pad_id
        self.epad_id = epad_id
        self.use_bos = True
        self.use_eos = True
        self.max_length = max_length

    @property
    def is_discrete(self) -> bool:
        return True

    def find_length(self, x) -> int:
        return int(np.shape(np.asarray(x))[-1])

    def token_to_id(self, token: str) -> int:
        if self.backend == "huggingface":
            id_ = self.model.token_to_id(token)
        else:
            id_ = self.model.piece_to_id(token)
        if id_ is None:
            raise ValueError(f"token {token!r} not in vocabulary")
        return id_

    def _encode(self, text: str) -> tuple[list[str], list[int]]:
        if self.backend == "huggingface":
            enc = self.model.encode(text)
            return enc.tokens, enc.ids
        tokens = self.model.encode_as_pieces(text)
        return tokens, [self.model.piece_to_id(t) for t in tokens]

    def tokenize_text(self, text: str) -> list[int]:
        tokens, ids = self._encode(text)
        if self.use_bos and self.bos_id is not None and (not ids or ids[0] != self.bos_id):
            ids = [self.bos_id] + ids
        if self.use_eos and self.eos_id is not None and ids[-1] != self.eos_id:
            ids = ids + [self.eos_id]
        if self.max_length > 0:
            ids = ids[: self.max_length]
        return ids

    def tokenize(self, text: str) -> np.ndarray:
        return np.asarray(self.tokenize_text(text), np.int64)

    def decode(self, ids) -> str:
        ids = list(np.asarray(ids).reshape(-1))
        return self.model.decode([int(i) for i in ids])

    # -- word alignment -------------------------------------------------------

    def get_word_to_subword_mapping(self, tokens: list[str], ids: list[int]) -> list[dict]:
        """Group subwords by word boundary (sentencepiece '▁' / BPE 'Ġ')."""
        out: list[dict] = []
        word, subwords = "", []
        for tok, id_ in zip(tokens, ids):
            if tok.startswith("▁") or tok.startswith("Ġ"):
                if word:
                    out.append({"word": word, "tokens": subwords})
                word, subwords = tok[1:], [id_]
            else:
                word += tok
                subwords.append(id_)
        if word:
            out.append({"word": word, "tokens": subwords})
        return out

    def tokenize_segment(self, segments: list[dict]) -> list[dict]:
        """whisperX segments -> word list with attached subword ids."""
        word_list: list[dict] = []
        for segment in segments:
            tokens, ids = self._encode(segment["text"])
            if ids and self.bos_id is not None and ids[0] == self.bos_id:
                tokens, ids = tokens[1:], ids[1:]
            mapping = self.get_word_to_subword_mapping(tokens, ids)
            for word, tok in zip(segment["words"], mapping):
                word = dict(word)
                word["tokens"] = tok["tokens"]
                word_list.append(word)
        return word_list

    def pad_tokens(
        self, word_list: list[dict], duration: float, frame_rate: float = 12.5
    ) -> np.ndarray:
        """Place each word's subword ids at its start frame; ``<epad>`` marks
        the frame before each word; ``<pad>`` fills the rest."""
        length = math.ceil(duration * frame_rate)
        out = np.full((length,), self.pad_id, np.int64)
        for word in word_list:
            if "start" not in word:
                continue
            start = round(word["start"] * frame_rate)
            if start == 0:
                start += 1
            if out[start - 1] == self.pad_id:
                out[start - 1] = self.epad_id
            for i, token in enumerate(word.get("tokens", [])):
                if start + i >= length:
                    break
                out[start + i] = token
        return out
