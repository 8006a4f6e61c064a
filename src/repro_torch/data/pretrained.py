"""Corpus splits of the tiny LMs (the reference's `data/pretrained.py`,
so far only `corpus_tokens`).

The reference's `get_trained_lm` trains a tiny LM on these corpora and
caches it; it arrives with the training slice (ROADMAP Queue 1 item 7).
The quantizer's calibration reads the train split from here.
"""
from __future__ import annotations

from repro_torch.data.corpus import token_stream


def corpus_tokens(corpus: str = "wiki", n_chars: int = 400_000,
                  split: str = "eval"):
    """Train/eval split of a corpus token stream (eval = disjoint tail)."""
    toks = token_stream(corpus, n_chars + 60_000, seed=0)
    return toks[:n_chars] if split == "train" else toks[n_chars:]
