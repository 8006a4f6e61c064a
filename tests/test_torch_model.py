"""The port's model (repro_torch/models/) against the reference's on
2-layer tiny-lm and tiny-lm-wide, fp32 and w3-packed: prefill
last-position logits and caches, a few paged and dense decode steps,
and the building blocks (rmsnorm, rope, chunked attention). Weights are
the reference's own, carried across with ckpt.params_from_tree or read
from the committed fixture artifacts.

Tolerance: logits atol 1e-4 * max|logit| (fp32 end to end, different
summation orders); building blocks rtol/atol 1e-5.
"""
import dataclasses
import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt.packed import load_packed as jax_load_packed
from repro.configs import get_config as jax_get_config
from repro.models import attention as jattn
from repro.models import init_params as jax_init_params
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.quant import QuantizedTensor as JaxQT
from repro_torch.ckpt import params_from_tree
from repro_torch.configs import LayerSpec, ModelConfig, MoEConfig, get_config
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tmodel
from repro_torch.quant import pack_signs

FIXTURE = Path(__file__).resolve().parent / "data" / "torch_port"


def port_cfg(jcfg):
    """The port's ModelConfig with the reference config's fields (its
    MoE config included)."""
    kw = {f.name: getattr(jcfg, f.name)
          for f in dataclasses.fields(ModelConfig)
          if f.name not in ("pattern", "quant", "moe")}
    kw["pattern"] = tuple(LayerSpec(s.kind, s.mlp, s.window)
                          for s in jcfg.pattern)
    if jcfg.moe is not None:
        kw["moe"] = MoEConfig(**moe_fields(jcfg.moe))
    return ModelConfig(**kw)


def moe_fields(jmoe_cfg):
    """The reference MoE config's values of the fields the port keeps."""
    return {f.name: getattr(jmoe_cfg, f.name)
            for f in dataclasses.fields(MoEConfig)}


def random_packed(tree, seed, bits=3, group_size=0):
    """Replace every quantizable 2-D leaf of a reference tree by a random
    w`bits` JaxQT (uniform sign words, alphas giving std ~ K^-0.5)."""
    rng = np.random.default_rng(seed)

    def one(path, leaf):
        name = getattr(path[-1], "key", None)
        if name not in ("wq", "wk", "wv", "wo", "wg", "wu", "wd"):
            return leaf
        G_, K, N = leaf.shape
        G = 1 if group_size == 0 else K // group_size
        signs = rng.integers(0, 2, (G_, bits, K, N)).astype(bool)
        codes = np.asarray(jnp.asarray(
            pack_signs(torch.from_numpy(signs)).numpy().view(np.uint32)))
        base = np.array([4.0, 2.0, 1.0][:bits]) / np.sqrt(21.0) * K ** -0.5
        alphas = (base * (1 + 0.1 * rng.random((G_, G, N, bits)))).astype(
            np.float32)
        betas = (rng.standard_normal((G_, G, N)) * 0.1 * K ** -0.5).astype(
            np.float32)
        return JaxQT(jnp.asarray(codes), jnp.asarray(alphas),
                     jnp.asarray(betas), K, "float32")
    return jax.tree_util.tree_map_with_path(one, tree)


MODEL_IDS = ["tiny-lm-fp32", "tiny-lm-wide-fp32", "tiny-lm-w3_pc",
             "tiny-lm-w3_g64_bf16", "tiny-lm-wide-w3", "tiny-lm-wide-w3-g64"]


@functools.lru_cache(maxsize=None)
def model(mid):
    """(reference cfg, reference params) for one parity case, built on
    first use (not at collection: every test worker imports this file)."""
    arch = "tiny-lm-wide" if mid.startswith("tiny-lm-wide") else "tiny-lm"
    jcfg = jax_get_config(arch).replace(dtype="float32", n_layers=2)
    if mid.endswith("fp32"):
        return jcfg, jax_init_params(jcfg, jax.random.PRNGKey(7))
    if mid.startswith("tiny-lm-w3"):
        return jcfg, jax_load_packed(FIXTURE / mid[len("tiny-lm-"):])[0]
    p = jax_init_params(jcfg, jax.random.PRNGKey(8))
    return jcfg, random_packed(p, 9, group_size=64 if "g64" in mid else 0)


def close_logits(got, want):
    got = got.detach().double().numpy()
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("mid", MODEL_IDS)
def test_prefill_and_paged_decode_match_reference(mid):
    jcfg, jp = model(mid)
    cfg = port_cfg(jcfg)
    params = params_from_tree(jp, device="cpu")
    rng = np.random.default_rng(11)
    L, page, steps = 13, 8, 4
    prompt = rng.integers(0, cfg.vocab_size, (1, L)).astype(np.int32)
    feed = rng.integers(0, cfg.vocab_size, steps).astype(np.int32)

    j_logits, j_cache = jmodel.prefill(jcfg, jp, jnp.asarray(prompt), L)
    t_logits, t_cache = tmodel.prefill(cfg, params, torch.from_numpy(prompt),
                                       L)
    close_logits(t_logits, j_logits)
    for layer, tc in enumerate(t_cache):
        for side in ("k", "v"):
            np.testing.assert_allclose(
                tc[side].numpy(), np.asarray(j_cache["L0"][side][layer]),
                rtol=1e-5, atol=1e-5)

    n_pages, ids = 6, [3, 1]         # pages out of order on purpose
    bt = np.zeros((1, 4), np.int32)
    bt[0, :2] = ids
    j_pool = jmodel.init_paged_cache(jcfg, n_pages, page, 1, "float32")
    j_pool = jmodel.scatter_prefill_cache(
        jcfg, j_pool, j_cache, 0, jnp.asarray(ids[:2], jnp.int32), L)
    t_pool = tmodel.init_paged_cache(cfg, n_pages, page, 1, "float32",
                                     device="cpu")
    tmodel.scatter_prefill_cache(cfg, t_pool, t_cache, 0, ids[:2], L)
    for t in range(steps):
        tok = feed[t:t + 1][None]
        pos = np.array([L + t], np.int32)
        jl, j_pool = jmodel.decode_step_paged(
            jcfg, jp, j_pool, jnp.asarray(tok), jnp.asarray(pos),
            jnp.asarray(bt))
        tl, t_pool = tmodel.decode_step_paged(
            cfg, params, t_pool, torch.from_numpy(tok),
            torch.from_numpy(pos), torch.from_numpy(bt))
        close_logits(tl, jl)
    for layer, tp in enumerate(t_pool):
        np.testing.assert_allclose(
            tp["k_pages"].numpy(), np.asarray(j_pool["L0"]["k_pages"][layer]),
            rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mid", ["tiny-lm-wide-fp32", "tiny-lm-w3_pc"])
def test_dense_decode_and_padded_prefill_match_reference(mid):
    jcfg, jp = model(mid)
    cfg = port_cfg(jcfg)
    params = params_from_tree(jp, device="cpu")
    rng = np.random.default_rng(5)
    B, S, max_len = 2, 16, 24
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    last = np.array([9, 15], np.int32)            # bucket-padded prompts
    jl, jc = jmodel.prefill(jcfg, jp, jnp.asarray(tokens), max_len,
                            last_pos=jnp.asarray(last))
    tl, tc = tmodel.prefill(cfg, params, torch.from_numpy(tokens), max_len,
                            last_pos=torch.from_numpy(last))
    close_logits(tl, jl)
    pos = last + 1
    for t in range(3):
        tok = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
        jl, jc = jmodel.decode_step(jcfg, jp, jc, jnp.asarray(tok),
                                    jnp.asarray(pos + t))
        tl, tc = tmodel.decode_step(cfg, params, tc, torch.from_numpy(tok),
                                    torch.from_numpy(pos + t))
        close_logits(tl, jl)


def test_window_prefill_and_dense_decode_match_reference():
    jcfg = jax_get_config("tiny-lm").replace(dtype="float32", n_layers=2)
    jcfg = jcfg.replace(pattern=(dataclasses.replace(jcfg.pattern[0],
                                                     window=6),),
                        attn_softcap=20.0)
    jp = jax_init_params(jcfg, jax.random.PRNGKey(2))
    cfg = port_cfg(jcfg)
    params = params_from_tree(jp, device="cpu")
    tokens = np.arange(11, dtype=np.int32)[None] * 7 % cfg.vocab_size
    jl, jc = jmodel.prefill(jcfg, jp, jnp.asarray(tokens), 32)
    tl, tc = tmodel.prefill(cfg, params, torch.from_numpy(tokens), 32)
    close_logits(tl, jl)
    for t in range(3):
        tok = np.array([[t + 3]], np.int32)
        pos = np.array([11 + t], np.int32)
        jl, jc = jmodel.decode_step(jcfg, jp, jc, jnp.asarray(tok),
                                    jnp.asarray(pos))
        tl, tc = tmodel.decode_step(cfg, params, tc, torch.from_numpy(tok),
                                    torch.from_numpy(pos))
        close_logits(tl, jl)


@pytest.mark.parametrize("causal,window,cap", [
    (True, None, None), (True, 5, 30.0), (False, None, None)])
def test_chunked_attention_matches_reference(monkeypatch, causal, window,
                                             cap):
    monkeypatch.setattr(jattn, "KV_CHUNK", 8)
    monkeypatch.setattr(tattn, "KV_CHUNK", 8)
    rng = np.random.default_rng(1)
    q = rng.standard_normal((2, 21, 6, 16)).astype(np.float32)
    k = rng.standard_normal((2, 21, 3, 16)).astype(np.float32)
    v = rng.standard_normal((2, 21, 3, 16)).astype(np.float32)
    kw = dict(causal=causal, window=window, cap=cap, scale=0.25)
    want = jattn._attend_chunked(*(jnp.asarray(a) for a in (q, k, v)), **kw)
    got = tattn._attend_chunked(*(torch.from_numpy(a) for a in (q, k, v)),
                                **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    dense = tattn._attend_dense(*(torch.from_numpy(a) for a in (q, k, v)),
                                **kw)
    np.testing.assert_allclose(dense.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(
        tattn._mask_bias(5, 7, causal=causal, window=window).numpy(),
        np.asarray(jattn._mask_bias(5, 7, causal=causal, window=window)))


def test_rmsnorm_and_rope_match_reference():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, 3, 8)).astype(np.float32)
    w = rng.standard_normal(8).astype(np.float32) * 0.1
    np.testing.assert_allclose(
        tlayers.rmsnorm(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        np.asarray(jlayers.rmsnorm(jnp.asarray(x), jnp.asarray(w))),
        rtol=1e-6, atol=1e-6)
    for pos in (np.arange(5, dtype=np.int32),
                np.array([[3, 4, 5, 6, 7], [90, 91, 92, 93, 94]], np.int32)):
        np.testing.assert_allclose(
            tlayers.rope(torch.from_numpy(x), torch.from_numpy(pos),
                         10000.0).numpy(),
            np.asarray(jlayers.rope(jnp.asarray(x), jnp.asarray(pos),
                                    10000.0)), rtol=1e-5, atol=1e-5)


def test_init_params_layout_matches_reference_shapes():
    jcfg = jax_get_config("tiny-lm-wide").replace(n_layers=4)
    cfg = get_config("tiny-lm-wide").replace(n_layers=4)
    ref = params_from_tree(
        jax.tree.map(lambda a: np.zeros(a.shape, np.float32),
                     jax.eval_shape(lambda: jax_init_params(
                         jcfg, jax.random.PRNGKey(0)))), device="cpu")
    mine = tmodel.init_params(cfg, seed=1, dtype="float32", device="cpu")
    shapes = lambda t: jax.tree.map(lambda a: tuple(a.shape), t)
    assert shapes(mine) == shapes(ref)
    again = tmodel.init_params(cfg, seed=1, dtype="float32", device="cpu")
    assert torch.equal(mine["layers"][3]["mlp"]["wd"],
                       again["layers"][3]["mlp"]["wd"])
    w = mine["layers"][0]["attn"]["wq"]
    assert abs(float(w.std()) - cfg.d_model ** -0.5) < 0.1 * cfg.d_model ** -0.5


def test_attention_only_and_fp_pages_in_this_slice():
    """Binary-coded pages and MoE layers are served now (their parity
    tests are tests/test_torch_kv_quant.py and test_torch_moe.py); Mamba
    and MLA layers still raise, and a MoE pattern needs its config."""
    cfg = get_config("tiny-lm").replace(n_layers=1)
    pool = tmodel.init_paged_cache(cfg, 4, 8, 1, kv_bits=4, device="cpu")
    assert pool[0]["k_codes"].shape == (4, 8, 4, 4, 2)
    assert "k_pages" not in pool[0]
    with pytest.raises(NotImplementedError, match="Mamba"):
        tmodel.init_params(cfg.replace(pattern=(LayerSpec(kind="mamba"),)),
                           device="cpu")
    with pytest.raises(NotImplementedError, match="MLA"):
        tmodel.init_params(cfg.replace(mla=object()), device="cpu")
    with pytest.raises(ValueError, match="MoE"):
        tmodel.init_params(cfg.replace(pattern=(LayerSpec(mlp="moe"),)),
                           device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tmodel.init_params(cfg)


def test_params_must_have_the_config_depth():
    cfg = get_config("tiny-lm").replace(n_layers=2, dtype="float32")
    params = tmodel.init_params(cfg, device="cpu")
    with pytest.raises(ValueError, match="2 layers, the config 4"):
        tmodel.prefill(cfg.replace(n_layers=4), params,
                       torch.zeros((1, 3), dtype=torch.long), 3)
