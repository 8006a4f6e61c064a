"""Evaluation and its data (repro_torch/data/evaluate.py, corpus.py's
batches and eval_batches) against the reference, and the packed RTN
baseline (core/rtn.py:rtn_binary_coding).

- batches / eval_batches: arrays equal to the reference's (the same
  numpy draws).
- perplexity: a uniform model's is the vocabulary size; on the
  committed fixture artifacts (tests/data/torch_port: tiny-lm w3
  per-channel, w3 g64 with bf16 scales, tiny-moe w3) it equals the
  reference's on the same eval windows within 1e-5 relative (fp32
  logits in other summation orders; the packed linears run the BCQ
  kernels' plain versions here), and the packed model's equals its
  dequantized fp32 weights' within 1e-5 relative.
- packed RTN: its dequantized weight equals quantize_rtn's within
  2 fp32 ulps of max|w| (levels summed from powers of two of the scale
  instead of one product), and a whole model quantized with it is
  evaluated through the same packed path.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.ckpt.packed import load_packed as jax_load_packed
from repro.configs import get_config as jax_get_config
from repro.data import corpus as jcorpus
from repro.data.evaluate import perplexity as jax_perplexity
from repro_torch.ckpt import load_packed
from repro_torch.configs import get_config
from repro_torch.core import quantize_model
from repro_torch.core.quantizers import RTNPackedQuantizer
from repro_torch.core.rtn import quantize_rtn, rtn_binary_coding
from repro_torch.data import (batches, calibration_slices, corpus_tokens,
                              eval_batches, token_stream)
from repro_torch.data.evaluate import perplexity
from repro_torch.models import init_params
from repro_torch.quant import (QuantizedTensor, QuantSpec,
                               available_quantizers, dequantize_params,
                               register_quantizer)
from repro_torch.quant import registry
from torch_threads import one_torch_thread  # noqa: F401

FIXTURE = Path(__file__).resolve().parent / "data" / "torch_port"
EVAL_BATCH, EVAL_SEQ, MAX_BATCHES = 4, 64, 3


def test_batches_and_eval_batches_equal_the_reference():
    toks = token_stream("wiki", 20_000)
    assert np.array_equal(toks, jcorpus.token_stream("wiki", 20_000))
    for seed in (0, 5):
        mine = batches(toks, 4, 32, seed=seed, n_batches=3)
        ref = jcorpus.batches(toks, 4, 32, seed=seed, n_batches=3)
        for a, b in zip(mine, ref):
            for k in ("inputs", "labels"):
                assert a[k].dtype == b[k].dtype == np.int32
                assert np.array_equal(a[k], b[k])
    mine = list(eval_batches(toks[:3000], 4, 64))
    ref = list(jcorpus.eval_batches(toks[:3000], 4, 64))
    assert len(mine) == len(ref) == 12      # the last batch is short
    for a, b in zip(mine, ref):
        assert all(np.array_equal(a[k], b[k]) for k in ("inputs", "labels"))


def test_uniform_model_perplexity_is_the_vocab_size():
    cfg = get_config("tiny-lm").replace(n_layers=1, dtype="float32")
    p = init_params(cfg, device="cpu")
    p["embed"] = torch.zeros_like(p["embed"])     # tied head: logits 0
    ppl = perplexity(cfg, p, eval_batches(corpus_tokens(), 2, 32),
                     max_batches=2, device="cpu")
    assert abs(ppl - cfg.vocab_size) <= 1e-5 * cfg.vocab_size
    with pytest.raises(ValueError, match="live on cpu"):
        perplexity(cfg, p, [], device="meta")


def _windows():
    return eval_batches(corpus_tokens(split="eval"), EVAL_BATCH, EVAL_SEQ)


@pytest.mark.parametrize("artifact", ["w3_pc", "w3_g64_bf16", "w3_moe"])
def test_fixture_perplexity_matches_the_reference(artifact):
    d = FIXTURE / artifact
    jp, _, jmeta = jax_load_packed(d)
    jcfg = jax_get_config(jmeta["arch"]).replace(
        dtype="float32", remat="none", n_layers=jmeta["n_layers"])
    want = jax_perplexity(jcfg, jp, _windows(), max_batches=MAX_BATCHES)
    params, _, meta = load_packed(d, device="cpu")
    cfg = get_config(meta["arch"]).replace(dtype="float32",
                                           n_layers=len(params["layers"]))
    got = perplexity(cfg, params, _windows(), max_batches=MAX_BATCHES,
                     device="cpu")
    assert abs(got - want) <= 1e-5 * want, (got, want)
    fp = perplexity(cfg, dequantize_params(params), _windows(),
                    max_batches=MAX_BATCHES, device="cpu")
    assert abs(got - fp) <= 1e-5 * fp, (got, fp)


@pytest.mark.parametrize("gs", [0, 32])
def test_rtn_binary_coding_is_the_rtn_grid(gs):
    rng = np.random.default_rng(gs)
    W = torch.from_numpy((rng.standard_normal((48, 128)) * 0.05)
                         .astype(np.float32))
    wq, qt = rtn_binary_coding(W, 3, gs)
    assert torch.equal(wq, quantize_rtn(W, 3, group_size=gs)[0])
    assert isinstance(qt, QuantizedTensor) and qt.bits == 3
    assert qt.n_groups == (1 if gs == 0 else 128 // gs)
    err = float((qt.dequant("float32").T - wq).abs().max())
    assert err <= 2 * 2 ** -23 * float(W.abs().max())
    # plane 0 is the most significant bit: alphas halve plane by plane
    a = qt.alphas
    assert torch.allclose(a[..., 0], 2 * a[..., 1]) and \
        torch.allclose(a[..., 1], 2 * a[..., 2])


def test_packed_rtn_model_evaluates_through_the_packed_path():
    """RTNPackedQuantizer, installed under a name of its own for the
    run (the registry's names stay the reference's), quantizes a whole
    model; its perplexity equals its dequantized weights'."""
    cfg = get_config("tiny-lm").replace(n_layers=2, dtype="float32")
    params = init_params(cfg, seed=1, device="cpu")
    calib = calibration_slices(corpus_tokens(split="train"), 4, 32, seed=1)
    names = available_quantizers()
    register_quantizer("rtn_packed")(RTNPackedQuantizer)
    try:
        q, report = quantize_model(
            cfg, params, [calib], device="cpu",
            spec=QuantSpec(method="rtn_packed", mode="packed", bits=3))
    finally:
        registry._REGISTRY.pop("rtn_packed")
    assert available_quantizers() == names
    assert isinstance(q["layers"][0]["mlp"]["wd"], QuantizedTensor)
    got = perplexity(cfg, q, _windows(), max_batches=2, device="cpu")
    fp = perplexity(cfg, dequantize_params(q), _windows(), max_batches=2,
                    device="cpu")
    assert abs(got - fp) <= 1e-5 * fp
    assert all(v["method"] == "rtn_packed" for v in report.values())
