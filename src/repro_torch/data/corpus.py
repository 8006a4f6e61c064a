"""Synthetic PCFG corpora and the byte tokenizer of the tiny LMs (the
port's copy of the reference's `data/corpus.py`).

The "wiki" and "ptb" corpora are drawn from two probabilistic grammars
by a numpy `default_rng`, so for one name, length and seed the port's
text is byte-equal to the reference's. `calibration_slices` cuts the
random fixed-length windows that calibrate the quantizer's Hessians,
`batches` the training batches and `eval_batches` the perplexity
windows, with the reference's draws (equal arrays).
"""
from __future__ import annotations

import numpy as np

_GRAMMARS = {
    "wiki": {
        "det": ["the", "a", "this", "each", "another"],
        "adj": ["ancient", "large", "notable", "famous", "small", "early",
                "modern", "regional", "central", "former"],
        "noun": ["city", "river", "empire", "treaty", "archive", "museum",
                 "region", "dynasty", "railway", "harbour", "council",
                 "province", "cathedral", "festival", "network"],
        "verb": ["established", "described", "contained", "bordered",
                 "governed", "recorded", "restored", "connected",
                 "commissioned", "preserved"],
        "adv": ["formally", "later", "originally", "briefly", "partly"],
        "conj": ["and", "while", "although", "because"],
        "punct": [".", ".", ".", ";"],
    },
    "ptb": {
        "det": ["the", "its", "that", "some", "no"],
        "adj": ["quarterly", "corporate", "pretax", "volatile", "junk",
                "fiscal", "preferred", "composite", "industrial", "net"],
        "noun": ["profit", "market", "index", "bond", "share", "trader",
                 "merger", "rate", "dollar", "earnings", "portfolio",
                 "contract", "exchange", "analyst", "broker"],
        "verb": ["rose", "fell", "reported", "traded", "acquired",
                 "slipped", "gained", "projected", "offset", "climbed"],
        "adv": ["sharply", "modestly", "unexpectedly", "slightly", "again"],
        "conj": ["but", "and", "as", "though"],
        "punct": [".", ".", ",", "."],
    },
}


_CONS = list("bcdfghklmnprstvz")
_VOW = list("aeiou")


def _name(rng):
    """Random pronounceable proper noun — irreducible entropy so a tiny
    LM cannot memorize the corpus to ~1.0 ppl (quantization effects
    would otherwise be invisible)."""
    n = rng.integers(2, 4)
    return "".join(rng.choice(_CONS) + rng.choice(_VOW)
                   for _ in range(n)).capitalize()


def _sentence(rng, g):
    words = []

    def np_():
        if rng.random() < 0.25:          # proper noun / numeral slots
            return [_name(rng)] if rng.random() < 0.7 else \
                [str(rng.integers(1000, 2100))]
        w = [rng.choice(g["det"])]
        if rng.random() < 0.6:
            w.append(rng.choice(g["adj"]))
        w.append(rng.choice(g["noun"]))
        return w

    words += np_()
    if rng.random() < 0.35:
        words.append(rng.choice(g["adv"]))
    words.append(rng.choice(g["verb"]))
    words += np_()
    if rng.random() < 0.3:
        words.append(rng.choice(g["conj"]))
        words += np_()
        words.append(rng.choice(g["verb"]))
        words += np_()
    return " ".join(words) + rng.choice(g["punct"]) + " "


def generate_corpus(name: str = "wiki", n_chars: int = 400_000,
                    seed: int = 0) -> str:
    rng = np.random.default_rng(seed + (0 if name == "wiki" else 7919))
    g = _GRAMMARS[name]
    parts, total = [], 0
    while total < n_chars:
        s = _sentence(rng, g)
        parts.append(s)
        total += len(s)
    return "".join(parts)[:n_chars]


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


def token_stream(name: str = "wiki", n_chars: int = 400_000, seed: int = 0):
    return ByteTokenizer().encode(generate_corpus(name, n_chars, seed))


def calibration_slices(tokens: np.ndarray, n_slices: int, slice_len: int,
                       seed: int = 0) -> np.ndarray:
    """Paper setup: random fixed-length slices (128 x 2048 at full scale;
    scaled down for the tiny models)."""
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, len(tokens) - slice_len, n_slices)
    return np.stack([tokens[s:s + slice_len] for s in starts]).astype(np.int32)


def batches(tokens: np.ndarray, batch: int, seq: int, *, seed: int = 0,
            n_batches: int | None = None):
    """Next-token LM batches: inputs/labels shifted by one."""
    rng = np.random.default_rng(seed)
    i = 0
    while n_batches is None or i < n_batches:
        starts = rng.integers(0, len(tokens) - seq - 1, batch)
        x = np.stack([tokens[s:s + seq] for s in starts])
        y = np.stack([tokens[s + 1:s + seq + 1] for s in starts])
        yield {"inputs": x.astype(np.int32), "labels": y.astype(np.int32)}
        i += 1


def eval_batches(tokens: np.ndarray, batch: int, seq: int):
    """Deterministic non-overlapping windows for perplexity."""
    n = (len(tokens) - 1) // seq
    xs, ys = [], []
    for w in range(n):
        s = w * seq
        xs.append(tokens[s:s + seq])
        ys.append(tokens[s + 1:s + seq + 1])
        if len(xs) == batch:
            yield {"inputs": np.stack(xs).astype(np.int32),
                   "labels": np.stack(ys).astype(np.int32)}
            xs, ys = [], []
    if xs:
        yield {"inputs": np.stack(xs).astype(np.int32),
               "labels": np.stack(ys).astype(np.int32)}
