"""The port's Multi-head Latent Attention (repro_torch/models/mla.py and
its model paths) against the reference's, at tiny-mla and the
minicpm3-4b smoke config, fp32, on the reference's own init_params
carried across: the layer forward, whole-model prefill logits and
latents, dense decode, paged decode over latent pages, the extend path
and the latent pages' bytes and layout.

Tolerance: 1e-4 x max|reference| for logits and layer outputs (fp32
sums in another order); latents 1e-5 x max|latent|.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro.models import mla as jmla
from repro.models import model as jmodel
from repro_torch.models import attention as tattn
from repro_torch.models import mla as tmla
from repro_torch.models import model as tmodel
from torch_threads import one_torch_thread  # noqa: F401
from torch_zoo import zoo

ARCHS = ["tiny-mla", "minicpm3-4b"]
TOL = 1e-4
PAGE = 8


def close(got, want, tol=TOL):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-30))


def prompt(cfg, L, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (1, L)).astype(np.int32)


def layer_leaf(jtree, cfg, j, name):
    """Layer j's leaf `name` of a reference (n_groups-stacked) cache."""
    P = len(cfg.pattern)
    return np.asarray(jtree[f"L{j % P}"][name][j // P])


@pytest.mark.parametrize("arch", ARCHS)
def test_mla_layer_forward(arch):
    st = zoo(arch)
    jcfg, cfg = st["jcfg"], st["cfg"]
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 11, cfg.d_model)).astype(np.float32)
    pos = np.arange(11)
    jp = jax.tree.map(lambda a: a[0], st["jfp"]["blocks"]["L0"]["attn"])
    want = jmla.mla_forward(jcfg, jcfg.pattern[0], jp, jnp.asarray(x),
                            jnp.asarray(pos))
    got = tmla.mla_forward(cfg, cfg.pattern[0], st["fp"]["layers"][0]["attn"],
                           torch.from_numpy(x), torch.from_numpy(pos))
    close(got, want)
    # the chunked path (long sequences) gives the same layer output
    old = tattn.CHUNKED_THRESHOLD
    tattn.CHUNKED_THRESHOLD = 4
    try:
        close(tmla.mla_forward(cfg, cfg.pattern[0],
                               st["fp"]["layers"][0]["attn"],
                               torch.from_numpy(x), torch.from_numpy(pos)),
              want)
    finally:
        tattn.CHUNKED_THRESHOLD = old


@pytest.mark.parametrize("arch", ARCHS)
def test_mla_prefill_and_dense_decode(arch):
    st = zoo(arch)
    jcfg, cfg = st["jcfg"], st["cfg"]
    toks = prompt(cfg, 9)
    max_len = 16
    jl, jc = jmodel.prefill(jcfg, st["jfp"], jnp.asarray(toks), max_len)
    tl, tc = tmodel.prefill(cfg, st["fp"], torch.from_numpy(toks), max_len)
    close(tl, jl)
    for j in range(cfg.n_layers):
        for name in ("c_kv", "k_pe"):
            close(tc[j][name], layer_leaf(jc, cfg, j, name), 1e-5)
    # three dense decode steps on the prefilled cache
    nxt = np.array([[5]], np.int32)
    for t in range(3):
        pos = np.array([9 + t], np.int32)
        jl, jc = jmodel.decode_step(jcfg, st["jfp"], jc, jnp.asarray(nxt),
                                    jnp.asarray(pos))
        tl, tc = tmodel.decode_step(cfg, st["fp"], tc, torch.from_numpy(nxt),
                                    torch.from_numpy(pos))
        close(tl, jl)
        nxt = np.asarray(jnp.argmax(jl, -1), np.int32)[:, None]


def _paged_pair(st, toks, n_pages=6, pages=(2, 4)):
    """Both packages' latent pools with `toks` prefilled and scattered
    into pages `pages` of slot 0."""
    jcfg, cfg = st["jcfg"], st["cfg"]
    L = toks.shape[1]
    _, jrow = jmodel.prefill(jcfg, st["jfp"], jnp.asarray(toks), L)
    _, trow = tmodel.prefill(cfg, st["fp"], torch.from_numpy(toks), L)
    jpool = jmodel.init_paged_cache(jcfg, n_pages, PAGE, 1, jnp.float32)
    jpool = jmodel.scatter_prefill_cache(jcfg, jpool, jrow, 0,
                                         jnp.asarray(pages[:-(-L // PAGE)],
                                                     jnp.int32), L)
    tpool = tmodel.init_paged_cache(cfg, n_pages, PAGE, 1, "float32",
                                    device="cpu")
    tmodel.scatter_prefill_cache(cfg, tpool, trow, 0,
                                 list(pages[:-(-L // PAGE)]), L)
    return jpool, tpool


def _pools_close(cfg, tpool, jpool):
    for j in range(cfg.n_layers):
        for name in ("ckv_pages", "kpe_pages"):
            close(tpool[j][name], layer_leaf(jpool, cfg, j, name), 1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_mla_paged_decode_over_latent_pages(arch):
    st = zoo(arch)
    jcfg, cfg = st["jcfg"], st["cfg"]
    toks = prompt(cfg, 7, seed=2)
    jpool, tpool = _paged_pair(st, toks)
    _pools_close(cfg, tpool, jpool)
    bt = np.array([[2, 4]], np.int32)
    nxt = np.array([[3]], np.int32)
    for t in range(4):          # crosses from page 2 into page 4
        pos = np.array([7 + t], np.int32)
        jl, jpool = jmodel.decode_step_paged(jcfg, st["jfp"], jpool,
                                             jnp.asarray(nxt),
                                             jnp.asarray(pos),
                                             jnp.asarray(bt))
        tl, tpool = tmodel.decode_step_paged(cfg, st["fp"], tpool,
                                             torch.from_numpy(nxt),
                                             torch.from_numpy(pos),
                                             torch.from_numpy(bt))
        close(tl, jl)
        nxt = np.asarray(jnp.argmax(jl, -1), np.int32)[:, None]
    _pools_close(cfg, tpool, jpool)


@pytest.mark.parametrize("arch", ARCHS)
def test_mla_extend_over_latent_pages(arch):
    """A chunk of 6 tokens (4 real, 2 padding) after a 5-token prefix:
    logits at every chunk position and the pages match; padding writes
    only the null page's slot 0 with its own content."""
    st = zoo(arch)
    jcfg, cfg = st["jcfg"], st["cfg"]
    jpool, tpool = _paged_pair(st, prompt(cfg, 5, seed=3))
    chunk = prompt(cfg, 6, seed=4)
    args = [np.array([5], np.int32), np.array([[2, 4]], np.int32),
            np.array([4], np.int32)]
    jl, jpool = jmodel._extend_scan(jcfg, st["jfp"], jpool, jnp.asarray(chunk),
                                    *map(jnp.asarray, args))
    null_before = [l["ckv_pages"][0, 0].clone() for l in tpool]
    tl, tpool = tmodel._extend_scan(cfg, st["fp"], tpool,
                                    torch.from_numpy(chunk),
                                    *map(torch.from_numpy, args))
    close(tl[:, :4], np.asarray(jl)[:, :4])
    _pools_close(cfg, tpool, jpool)
    for l, before in zip(tpool, null_before):
        assert torch.equal(l["ckv_pages"][0, 0], before)
    # extend_paged reduces to the last valid position's logits
    jl2, _ = jmodel.extend_paged(jcfg, st["jfp"], jpool, jnp.asarray(chunk),
                                 *map(jnp.asarray, args))
    tl2, _ = tmodel.extend_paged(cfg, st["fp"], tpool,
                                 torch.from_numpy(chunk),
                                 *map(torch.from_numpy, args))
    close(tl2, jl2)


@pytest.mark.parametrize("arch", ARCHS)
def test_latent_page_layout_and_bytes(arch):
    st = zoo(arch)
    jcfg, cfg = st["jcfg"], st["cfg"]
    m = cfg.mla
    for dtype in ("float32", "bfloat16"):
        assert tattn.paged_kv_page_bytes(cfg, 64, dtype) == \
            jattn.paged_kv_page_bytes(jcfg, 64, dtype) == \
            64 * (m.kv_lora_rank + m.qk_rope_head_dim) * cfg.n_layers * (
                4 if dtype == "float32" else 2)
    # the singleton head axis: page leaves like K/V pools, so forks and
    # compaction treat them alike; n_pages == max_seqs changes nothing
    pool = tmodel.init_paged_cache(cfg, 4, PAGE, 4, "float32", device="cpu")
    assert pool[0]["ckv_pages"].shape == (4, PAGE, 1, m.kv_lora_rank)
    assert pool[0]["kpe_pages"].shape == (4, PAGE, 1, m.qk_rope_head_dim)
    assert all(tmodel.is_page_leaf(v, 4) for v in pool[0].values())
    pool[0]["ckv_pages"][1] = 1.0
    tmodel.copy_pages(pool, [1], [3], 4)
    assert bool((pool[0]["ckv_pages"][3] == 1.0).all())
    with pytest.raises(NotImplementedError, match="already compressed"):
        tmodel.init_paged_cache(cfg, 4, PAGE, 1, kv_bits=4, device="cpu")
