"""Perplexity evaluation (the reference's `data/evaluate.py`), the
paper's metric for every results table.

The logits-only forward is borrowed from the process-wide step cache
(serve/compile_cache.py, kind "eval_forward"), as the reference borrows
its jitted forward, so repeated evaluations of one config share one
wrapper and its accounting. It runs eagerly under
torch.inference_mode (each batch's shape is its own); on a packed model
every quantized linear goes through kernels/ops.py:bcq_apply (on the
card the BCQ GEMM at M = B*S, and the batched-expert kernel in MoE
layers).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.hw import resolve_device
from repro_torch.serve import compile_cache


def perplexity(cfg, params, batch_iter, *, max_batches=None,
               device=None) -> float:
    """Token-level perplexity over deterministic eval windows: exp of
    the mean of logsumexp - gold logit, each in fp32, summed in a Python
    float. Runs on `device` (default cuda), where the params must live."""
    dev = resolve_device(device)
    if params["embed"].device.type != dev.type:
        raise ValueError(f"the params live on {params['embed'].device} and "
                         f"the evaluation runs on {dev}: pass device= or "
                         f"move the params")
    fwd = compile_cache.get("eval_forward", cfg)
    total_nll, total_tok = 0.0, 0
    with torch.inference_mode():
        for bi, batch in enumerate(batch_iter):
            if max_batches is not None and bi >= max_batches:
                break
            inputs = torch.from_numpy(np.asarray(batch["inputs"])).to(dev)
            labels = torch.from_numpy(np.asarray(batch["labels"])).to(dev)
            logits = fwd(params, inputs).float()
            lse = torch.logsumexp(logits, dim=-1)
            gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
            total_nll += float(torch.sum(lse - gold))
            total_tok += labels.numel()
    return math.exp(total_nll / max(total_tok, 1))
