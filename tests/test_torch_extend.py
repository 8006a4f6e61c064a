"""The port's extend path against the reference's on the same inputs:
models/model.py `_extend_scan` and `extend_paged` (a chunk of prompt
tokens over a batch's pages: models/attention.py `attn_extend_paged`,
the masked `_quant_scatter` and `_gather_dequant`), and `copy_pages`.

Two or three chunks per case, B=2 rows with different starts, chunks
with padding (n_valid < C), later chunks over pages earlier ones wrote,
on
fp pages (tiny-lm w3 per-channel), 4-bit pages with one group per head
vector (w3 per-channel) and with groups of 32 (w3 g64 bf16 scales), a
sliding-window layer (tiny-lm with window=16 over three chunks, 23
tokens; fp32 reference init) and MoE MLPs (tiny-moe w3, the same three
chunks). Weights are the committed fixture's or the
reference's own, carried across with ckpt.params_from_tree.

Quantize-on-write is chaotic at near-ties (a refit round that flips
one entry moves that group's alphas by 0.1 % and more, in the reference
as in the port, ROADMAP Queue 3), so the 4-bit cases run on token draws
whose reference quantize-on-write clears the fixture's margin filter
(tests/data/torch_port/make_fixture.py, KV_TIE_MARGIN), as every 4-bit
comparison with the reference does.

Tolerances: logits atol 1e-4 x max|logit| (at every chunk position of
the first chunk, at the last valid one of the second); fp pools and
alphas/betas rtol 1e-5, atol 1e-5 x max|leaf|; code words equal;
copy_pages exact.
"""
import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt.packed import load_packed as jax_load_packed
from repro.configs import get_config as jax_get_config
from repro.models import init_params as jax_init_params
from repro.models import model as jmodel
from repro.quant import kv as jkv
from repro_torch.ckpt import params_from_tree
from repro_torch.models import model as tmodel
from repro_torch.quant import codes_from_numpy, codes_to_numpy
from test_torch_model import close_logits, port_cfg
from torch_threads import one_torch_thread  # noqa: F401

FIXTURE = Path(__file__).resolve().parent / "data" / "torch_port"
PAGE, N_PAGES = 4, 13
# block tables and chunks, (start positions, valid counts) per row, C = 8
# tokens each. "short": the second chunk crosses a page in row 1, and
# padding positions run past the table (8 tokens), so they are clamped
# and sent to the null page. "long": contexts of 21 and 23 tokens, past
# a 16-token window.
GEOMETRY = {
    "short": (np.array([[3, 1], [2, 4]], np.int32),
              [([0, 0], [4, 3]), ([4, 3], [3, 4])]),
    "long": (np.array([[3, 1, 5, 7, 9, 11], [2, 4, 6, 8, 10, 12]], np.int32),
             [([0, 0], [8, 8]), ([8, 8], [8, 8]), ([16, 16], [5, 7])]),
}
C = 8
# the chunks' tokens are seeded draws (KV_SEED); 4-bit cases take the
# first of N_DRAWS that clears the quantizer-margin filter
KV_SEED, N_DRAWS = 5, 64

CASES = {
    # id: (reference arch, params, kv_bits, group size, window, geometry)
    "fp-w3_pc": ("tiny-lm", "w3_pc", 0, 0, None, "short"),
    "kv4-G1-w3_pc": ("tiny-lm", "w3_pc", 4, 0, None, "short"),
    "kv4-gs32-w3_g64_bf16": ("tiny-lm", "w3_g64_bf16", 4, 32, None, "short"),
    "fp-window16": ("tiny-lm", "init", 0, 0, 16, "long"),
    "fp-w3_moe": ("tiny-moe", "w3_moe", 0, 0, None, "long"),
}


def _case(cid):
    arch, src, kv_bits, gs, window, _ = CASES[cid]
    jcfg = jax_get_config(arch).replace(dtype="float32", n_layers=2)
    if window:
        jcfg = jcfg.replace(pattern=tuple(
            dataclasses.replace(s, window=window) for s in jcfg.pattern))
    if src == "init":
        jp = jax_init_params(jcfg, jax.random.PRNGKey(3))
    else:
        jp = jax_load_packed(FIXTURE / src)[0]
    return jcfg, jp, kv_bits, gs


def _pool_numpy(tpool, name):
    """A port pool leaf as the reference lays it out: (layers, P, ...),
    code words as uint32."""
    a = np.stack([layer[name].numpy() for layer in tpool])
    return a.view(np.uint32) if a.dtype == np.int32 else a


def _check_pools(tpool, jpool, kv_bits):
    for name, leaf in jpool["L0"].items():
        want, got = np.asarray(leaf), _pool_numpy(tpool, name)
        if want.dtype == np.uint32:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5,
                                       atol=1e-5 * np.abs(want).max())


def _fixture_module():
    spec = importlib.util.spec_from_file_location(
        "make_fixture", FIXTURE / "make_fixture.py")
    mf = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mf)
    return mf


def _chunks(jcfg, jp, jpool, kv_bits, gs, geometry, monkeypatch):
    """The reference's two extend passes, jitted, and the chunks' tokens:
    the first seeded draw whose every quantize-on-write in the
    reference clears the fixture's quantizer-margin filter (4-bit cases;
    make_fixture.py, KV_TIE_MARGIN: no entry of a valid row within
    2e-6 x max|x| of flipping in a greedy sign step or a refit round),
    so that fp32 rounding cannot flip a code; fp cases take the first
    draw."""
    mf = _fixture_module()
    monkeypatch.setattr(jkv, "kv_quantize", mf._recording_kv_quantize)
    scan = jax.jit(lambda p, c, *a: jmodel._extend_scan(jcfg, p, c, *a))
    last = jax.jit(lambda p, c, *a: jmodel.extend_paged(jcfg, p, c, *a))
    bt, chunks = GEOMETRY[geometry]
    rng = np.random.default_rng(KV_SEED)
    for _ in range(N_DRAWS):
        draws = [rng.integers(0, jcfg.vocab_size, (2, C)).astype(np.int32)
                 for _ in chunks]
        if not kv_bits:
            break
        margin, pool = np.inf, jpool
        for tokens, (start, n_valid) in zip(draws, chunks):
            mf._KV_WRITES.clear()
            _, pool = scan(jp, pool, *_args(tokens, start, bt, n_valid,
                                            jnp))
            valid = np.arange(C)[None] < np.asarray(n_valid)[:, None]
            for x, g in mf._KV_WRITES:
                x = x[valid]
                m = mf._margins(jnp.asarray(x), kv_bits, g)
                margin = min(margin, float(m.min()) / float(np.abs(x).max()))
        if margin >= mf.KV_TIE_MARGIN:
            break
    else:
        raise AssertionError(f"no draw of {N_DRAWS} clears the margin filter")
    return draws, scan, last


def _args(tokens, start, bt, n_valid, xp):
    return tuple(xp.asarray(a) for a in (
        tokens, np.asarray(start, np.int32), bt, np.asarray(n_valid, np.int32)))


@pytest.mark.parametrize("cid", sorted(CASES))
def test_extend_matches_reference(cid, monkeypatch):
    jcfg, jp, kv_bits, gs = _case(cid)
    cfg = port_cfg(jcfg)
    params = params_from_tree(jp, device="cpu")
    jpool = jmodel.init_paged_cache(jcfg, N_PAGES, PAGE, 2, "float32",
                                    kv_bits=kv_bits, kv_group_size=gs)
    tpool = tmodel.init_paged_cache(cfg, N_PAGES, PAGE, 2, "float32",
                                    kv_bits=kv_bits, kv_group_size=gs,
                                    device="cpu")
    geometry = CASES[cid][-1]
    draws, scan, last = _chunks(jcfg, jp, jpool, kv_bits, gs, geometry,
                                monkeypatch)
    bt, chunks = GEOMETRY[geometry]
    for i, (tokens, (start, n_valid)) in enumerate(zip(draws, chunks)):
        args = (tokens, start, bt, n_valid)
        if i == 0:            # the logits of every chunk position
            j_out, jpool = scan(jp, jpool, *_args(*args, jnp))
            t_out, tpool = tmodel._extend_scan(cfg, params, tpool,
                                               *_args(*args, torch))
        else:                 # a prefill's last valid position
            j_out, jpool = last(jp, jpool, *_args(*args, jnp))
            t_out, tpool = tmodel.extend_paged(cfg, params, tpool,
                                               *_args(*args, torch))
            assert tuple(t_out.shape) == (2, cfg.vocab_size)
        close_logits(t_out, j_out)
        _check_pools(tpool, jpool, kv_bits)


def test_padding_rows_leave_the_null_page_as_it_was():
    """A chunk's padding rows write page 0, slot 0 with its own content,
    several of them into one slot in one write: whatever the pool held
    there stays, on fp and binary-coded pages."""
    jcfg, jp, _, _ = _case("fp-w3_pc")
    cfg = port_cfg(jcfg)
    params = params_from_tree(jp, device="cpu")
    for kv_bits in (0, 4):
        pool = tmodel.init_paged_cache(cfg, 4, PAGE, 1, "float32",
                                       kv_bits=kv_bits, device="cpu")
        gen = torch.Generator().manual_seed(kv_bits)
        for layer in pool:
            for name, leaf in layer.items():
                leaf.copy_(torch.randint(-5, 5, leaf.shape, generator=gen)
                           .to(leaf.dtype))
        null = [{k: v[0].clone() for k, v in layer.items()} for layer in pool]
        tmodel.extend_paged(cfg, params, pool,
                            torch.arange(8)[None].to(torch.int32),
                            torch.tensor([3], dtype=torch.int32),
                            torch.tensor([[1, 2]], dtype=torch.int32),
                            torch.tensor([2], dtype=torch.int32))
        for layer, before in zip(pool, null):
            for name, leaf in layer.items():
                assert torch.equal(leaf[0], before[name]), name


@pytest.mark.parametrize("kv_bits,gs", [(0, 0), (4, 0), (3, 32)])
def test_copy_pages_matches_reference_on_every_leaf(kv_bits, gs):
    """Forks as the engine applies them, a chained pair (one copy's
    destination is another's source) and a (0, 0) no-op among them:
    every leaf of the port's pool equals the reference's."""
    jcfg = jax_get_config("tiny-lm").replace(dtype="float32", n_layers=2)
    cfg = port_cfg(jcfg)
    n_pages = 12
    jpool = jmodel.init_paged_cache(jcfg, n_pages, PAGE, 2, "float32",
                                    kv_bits=kv_bits, kv_group_size=gs)
    rng = np.random.default_rng(kv_bits + gs)
    tpool = [{} for _ in range(cfg.n_layers)]
    for name, leaf in jpool["L0"].items():
        if leaf.dtype == jnp.uint32:
            a = rng.integers(0, 2 ** 32, leaf.shape, dtype=np.uint64) \
                .astype(np.uint32)
        else:
            a = rng.standard_normal(leaf.shape).astype(np.float32)
        jpool["L0"][name] = jnp.asarray(a)
        for layer in range(cfg.n_layers):
            tpool[layer][name] = codes_from_numpy(a[layer]) \
                if a.dtype == np.uint32 else torch.from_numpy(a[layer].copy())
    src, dst = [3, 5, 0, 7], [5, 9, 0, 2]
    jpool = jmodel.copy_pages(jpool, jnp.asarray(src, jnp.int32),
                              jnp.asarray(dst, jnp.int32), n_pages)
    tmodel.copy_pages(tpool, src, dst, n_pages)
    for name, leaf in jpool["L0"].items():
        want = np.asarray(leaf)
        for layer, t in enumerate(tpool):
            got = codes_to_numpy(t[name]) if want.dtype == np.uint32 \
                else t[name].numpy()
            np.testing.assert_array_equal(got, want[layer])
