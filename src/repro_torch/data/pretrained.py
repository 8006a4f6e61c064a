"""Train-once cache of the tiny LMs and the corpus splits (the
reference's `data/pretrained.py`).

The paper quantizes pretrained OPT/Llama2/Bloom checkpoints; offline
the repo trains small LMs on its synthetic corpora and caches them
under artifacts/models/<name>-<corpus>-s<steps>/, the reference's path
scheme and checkpoint format (ckpt/checkpoint.py), so a model either
package trained is restored by the other.
"""
from __future__ import annotations

from pathlib import Path

from repro_torch.ckpt.packed import unstack_blocks
from repro_torch.configs import get_config
from repro_torch.data.corpus import batches, token_stream
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.trainer import Trainer, TrainerConfig

ROOT = Path(__file__).resolve().parents[3]
MODELS_DIR = ROOT / "artifacts" / "models"


def get_trained_lm(name: str = "tiny-lm", *, corpus: str = "wiki",
                   steps: int = 300, batch: int = 12, seq: int = 192,
                   lr: float = 1.5e-3, force: bool = False, device=None):
    """Returns (cfg, params in the port's per-layer layout) on `device`
    (default cuda). Trains and caches on first call."""
    cfg = get_config(name).replace(dtype="float32", remat="none")
    ckpt_dir = MODELS_DIR / f"{name}-{corpus}-s{steps}"
    toks = token_stream(corpus, 400_000)
    data = batches(toks, batch, seq, seed=0)
    tr = Trainer(
        cfg,
        TrainerConfig(steps=steps, ckpt_every=max(steps // 3, 50),
                      ckpt_dir=str(ckpt_dir), log_every=50, warmup=30,
                      opt=AdamWConfig(lr=lr, weight_decay=0.01,
                                      master_fp32=False)),
        data, dtype="float32", device=device)
    if not force and tr.ckpt.latest_step() == steps:
        tr.try_resume()
        return cfg, unstack_blocks(tr.params)
    print(f"[pretrained] training {name} on {corpus} for {steps} steps ...")
    tr.run()
    return cfg, unstack_blocks(tr.params)


def corpus_tokens(corpus: str = "wiki", n_chars: int = 400_000,
                  split: str = "eval"):
    """Train/eval split of a corpus token stream (eval = disjoint tail)."""
    toks = token_stream(corpus, n_chars + 60_000, seed=0)
    return toks[:n_chars] if split == "train" else toks[n_chars:]
