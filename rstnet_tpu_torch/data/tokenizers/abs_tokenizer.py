"""Tokenizer interface (a copy of ``rstnet_tpu/data/tokenizers/abs_tokenizer.py``;
parity: ``MLLM_v2/tools/tokenizer/abs_tokenizer.py``).

Plain-Python ABC over numpy arrays: tokenizers run host-side in the offline
data-prep stage. The inference CLIs subclass it for offline-tokenized data.
"""

from __future__ import annotations

import abc


class AbsTokenizer(abc.ABC):
    @property
    def is_discrete(self) -> bool:
        raise NotImplementedError

    @property
    def codebook_length(self) -> int:
        raise NotImplementedError

    def find_length(self, x) -> int:
        """Fast sequence-length estimate used by the token-budget batcher."""
        raise NotImplementedError

    def tokenize(self, x):
        raise NotImplementedError

    def tokenize2(self, x):
        """Convert stored (offline-tokenized) data into int64 tokens."""
        import numpy as np

        return np.asarray(x).astype("int64")

    def tokenize_batch(self, xs, lengths=None):
        raise NotImplementedError

    def detokenize(self, x):
        raise NotImplementedError
