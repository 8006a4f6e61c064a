"""Byte-level tokenizer of the tiny LMs (the reference's
`data/corpus.py:ByteTokenizer`)."""
from __future__ import annotations

import numpy as np


class ByteTokenizer:
    """Raw bytes + BOS/EOS. vocab_size 258 (matches tiny-lm configs)."""
    vocab_size = 258
    bos = 256
    eos = 257

    def encode(self, text: str) -> np.ndarray:
        return np.frombuffer(text.encode("utf-8"), np.uint8).astype(np.int32)

    def decode(self, ids) -> str:
        ids = [i for i in np.asarray(ids).tolist() if i < 256]
        return bytes(ids).decode("utf-8", errors="replace")
