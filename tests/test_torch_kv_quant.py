"""The port's binary-coded KV pages against the reference's on the same
numpy inputs: `quant/kv.py` (kv_quantize, kv_dequantize, kv_layout,
kv_bytes_per_token_head), the plain `paged_attention_quant` against the
reference's Pallas `paged_attention_quant` in interpret mode, the pool
layout and its byte count, and tiny-lm with kv_bits=4 through prefill,
scatter_prefill_cache and paged decode.

On the CPU the wrapper runs its plain version; the CUDA kernel is held
against it in tests/test_torch_cuda.py.

Tolerances:
  kv_quantize: codes equal except at near-ties, entries whose distances
    to their two nearest levels differ by less than 1e-5 * max|x|
    (a 1e-7 difference in the solved alphas may flip such an entry;
    they are counted and must be rare); alphas and betas within 1e-5
    relative; dequantized values within 1e-5 * max|x|.
  paged attention: fp32 rtol 1e-5, atol 1e-5 * max|out| (online vs
    one-pass softmax, another summation order).
  logits: atol 1e-4 * max|logit| (fp32 end to end).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.binary_coding import sign_combos as jax_sign_combos
from repro.kernels.paged_attention import \
    paged_attention_quant as jax_paged_quant
from repro.models import attention as jattn
from repro.models import init_params as jax_init_params
from repro.models import model as jmodel
from repro.quant import kv as jkv
from repro_torch.ckpt import params_from_tree
from repro_torch.configs import get_config
from repro_torch.kernels import paged_attention as tpa
from repro_torch.models import attention as tattn
from repro_torch.models import model as tmodel
from repro_torch.quant import codes_from_numpy, codes_to_numpy
from repro_torch.quant import kv as tkv
from test_torch_model import close_logits, port_cfg, random_packed

NEAR_TIE = 1e-5


def near_ties(x, alphas, betas, bits, gs):
    """Entries of x (..., hd) whose distances to their two nearest
    levels (under the given scales) differ by less than NEAR_TIE *
    max|x|."""
    hd = x.shape[-1]
    G = hd // gs
    xg = x.reshape(*x.shape[:-1], G, gs) - betas[..., None]
    levels = alphas @ jax_sign_combos(bits).T                # (..., G, L)
    d = np.sort(np.abs(xg[..., None, :] - levels[..., None]), axis=-2)
    return (d[..., 1, :] - d[..., 0, :]) < NEAR_TIE * np.abs(x).max()


@pytest.mark.parametrize("bits", [2, 3, 4])
@pytest.mark.parametrize("gs", [0, 32])           # G = 1 and G = hd / 32
def test_kv_quantize_matches_reference(bits, gs):
    hd = 128
    rng = np.random.default_rng(bits * 1000 + gs)
    x = (rng.standard_normal((40, 3, hd)) * 2.0).astype(np.float32)
    jc, ja, jb = (np.asarray(a) for a in jkv.kv_quantize(jnp.asarray(x),
                                                         bits, gs))
    tc, ta, tb = tkv.kv_quantize(torch.from_numpy(x), bits, gs)
    assert tc.dtype == torch.int32 and ta.dtype == tb.dtype == torch.float32
    assert tuple(tc.shape) == jc.shape and tuple(ta.shape) == ja.shape
    tol = NEAR_TIE * np.abs(x).max()
    np.testing.assert_allclose(ta.numpy(), ja, rtol=1e-5, atol=tol)
    np.testing.assert_allclose(tb.numpy(), jb, rtol=1e-5, atol=tol)
    # codes: equal except at near-ties of the final levels
    ties = near_ties(x, ja, jb, bits, gs or hd).reshape(x.shape)
    got = np.unpackbits(codes_to_numpy(tc).view(np.uint8),
                        bitorder="little").reshape(*x.shape[:-1], bits, hd)
    want = np.unpackbits(jc.view(np.uint8),
                         bitorder="little").reshape(*x.shape[:-1], bits, hd)
    differ = (got != want).any(axis=-2)
    assert not (differ & ~ties).any()
    assert ties.mean() < 1e-3
    np.testing.assert_allclose(
        tkv.kv_dequantize(tc, ta, tb).numpy(),
        np.asarray(jkv.kv_dequantize(jnp.asarray(jc), jnp.asarray(ja),
                                     jnp.asarray(jb))), rtol=0, atol=tol)


def test_sign_combos_match_reference():
    for bits in (1, 2, 3, 4):
        np.testing.assert_array_equal(tkv.sign_combos(bits).numpy(),
                                      jax_sign_combos(bits))


@pytest.mark.parametrize("hd", [32, 48, 64, 96, 128, 256])
@pytest.mark.parametrize("bits", [0, 1, 2, 4, 8])
@pytest.mark.parametrize("gs", [0, 8, 16, 24, 32, 64, 128])
def test_kv_layout_and_bytes_match_reference(hd, bits, gs):
    def outcome(mod):
        try:
            return ("ok", mod.kv_layout(hd, bits, gs),
                    mod.kv_bytes_per_token_head(hd, bits, gs))
        except ValueError as e:
            return ("error", str(e))
    assert outcome(tkv) == outcome(jkv)
    for itemsize in (2, 4):
        if bits == 0:
            assert tkv.kv_bytes_per_token_head(hd, 0, gs, itemsize) == \
                jkv.kv_bytes_per_token_head(hd, 0, gs, itemsize)


# ---------------------------------------------------------------------------
# paged attention over binary-coded pages
# ---------------------------------------------------------------------------

def make_quant_pages(seed, page, ctx, Hkv, rep, hd, bits, gs, inactive=()):
    """A binary-coded pool (written by the reference's kv_quantize) with
    distinct pages per sequence and tables padded with the null page."""
    rng = np.random.default_rng(seed)
    B = len(ctx)
    need = [0 if b in inactive else -(-c // page) for b, c in enumerate(ctx)]
    T = max(-(-c // page) for c in ctx) + 1
    P = sum(need) + 1
    ids = rng.permutation(np.arange(1, P))
    bt = np.zeros((B, T), np.int32)
    used = 0
    for b, n in enumerate(need):
        bt[b, :n] = ids[used:used + n]
        used += n
    q = rng.standard_normal((B, Hkv, rep, hd)).astype(np.float32)
    kv = rng.standard_normal((2, P, page, Hkv, hd)).astype(np.float32)
    codes, alphas, betas = (np.asarray(a) for a in
                            jkv.kv_quantize(jnp.asarray(kv), bits, gs))
    pool = [codes[0], alphas[0], betas[0], codes[1], alphas[1], betas[1]]
    return q, pool, bt, np.asarray(ctx, np.int32)


def _to_torch(a):
    a = np.asarray(a)
    return codes_from_numpy(a) if a.dtype == np.uint32 \
        else torch.from_numpy(a.copy())


QUANT_CASES = [
    # (page, ctx, Hkv, rep, hd, bits, gs, window, cap, inactive)
    (16, [16, 33, 5], 2, 1, 64, 4, 0, 12, None, ()),          # window
    (8, [30, 17], 1, 16, 128, 4, 32, None, 5.0, ()),          # rep 16, cap
    (8, [20, 9, 14], 2, 16, 64, 3, 16, 10, 30.0, (1,)),       # inactive row
]


@pytest.mark.parametrize(
    "page,ctx,Hkv,rep,hd,bits,gs,window,cap,inactive", QUANT_CASES)
def test_paged_attention_quant_matches_reference_kernel(
        page, ctx, Hkv, rep, hd, bits, gs, window, cap, inactive):
    q, pool, bt, cl = make_quant_pages(page + sum(ctx) + rep, page, ctx, Hkv,
                                       rep, hd, bits, gs, inactive)
    want = jax_paged_quant(*(jnp.asarray(a) for a in (q, *pool, bt, cl)),
                           window=window, cap=cap, interpret=True)
    before = dict(tpa.LAUNCHES)
    got = tpa.paged_attention_quant(*(_to_torch(a) for a in
                                      (q, *pool, bt, cl)),
                                    window=window, cap=cap)
    assert tpa.LAUNCHES == before
    assert got.dtype == torch.float32 and tuple(got.shape) == q.shape
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


# ---------------------------------------------------------------------------
# pools and the model path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["tiny-lm", "tiny-lm-wide"])
@pytest.mark.parametrize("kv_bits,gs", [(0, 0), (4, 0), (3, 32), (2, 16)])
def test_pool_layout_and_page_bytes_match_reference(arch, kv_bits, gs):
    jcfg = jax_get_config(arch).replace(n_layers=3)
    cfg = get_config(arch).replace(n_layers=3)
    jpool = jattn.init_paged_kv(jcfg, 5, 8, jnp.float32, kv_bits=kv_bits,
                                kv_group_size=gs)
    tpool = tattn.init_paged_kv(cfg, 5, 8, "float32", "cpu",
                                kv_bits=kv_bits, kv_group_size=gs)
    assert {k: tuple(v.shape) for k, v in tpool.items()} == \
        {k: v.shape for k, v in jpool.items()}
    assert all(tmodel.is_page_leaf(v, 5) for v in tpool.values())
    assert tattn.paged_kv_bits(tpool) == jattn.paged_kv_bits(jpool)
    for dt in ("float32", "bfloat16"):
        assert tattn.paged_kv_page_bytes(cfg, 16, dt, kv_bits, gs) == \
            jattn.paged_kv_page_bytes(jcfg, 16, dt, kv_bits, gs)


def test_llama2_7b_kv4_bytes_per_token():
    """2 sides x 32 KV heads x 84 B x 32 layers, against 1 MiB at fp32."""
    cfg = get_config("llama2-7b")
    assert tattn.paged_kv_page_bytes(cfg, 1, "float32", 4) == 172_032
    assert tattn.paged_kv_page_bytes(cfg, 1, "float32", 0) == 1_048_576


@pytest.mark.parametrize("mid,gs", [("tiny-lm-fp32", 0), ("tiny-lm-w3", 32)])
def test_kv4_prefill_scatter_and_paged_decode_match_reference(mid, gs):
    jcfg = jax_get_config("tiny-lm").replace(dtype="float32", n_layers=2)
    jp = jax_init_params(jcfg, jax.random.PRNGKey(7))
    if mid.endswith("w3"):
        jp = random_packed(jp, 3)
    cfg = port_cfg(jcfg)
    params = params_from_tree(jp, device="cpu")
    rng = np.random.default_rng(21)
    L, page, steps, kv_bits = 13, 8, 3, 4
    prompt = rng.integers(0, cfg.vocab_size, (1, L)).astype(np.int32)
    feed = rng.integers(0, cfg.vocab_size, steps).astype(np.int32)
    jl, jc = jmodel.prefill(jcfg, jp, jnp.asarray(prompt), L)
    tl, tc = tmodel.prefill(cfg, params, torch.from_numpy(prompt), L)
    close_logits(tl, jl)
    ids = [3, 1]
    bt = np.zeros((1, 4), np.int32)
    bt[0, :2] = ids
    j_pool = jmodel.init_paged_cache(jcfg, 6, page, 1, "float32",
                                     kv_bits=kv_bits, kv_group_size=gs)
    j_pool = jmodel.scatter_prefill_cache(jcfg, j_pool, jc, 0,
                                          jnp.asarray(ids, jnp.int32), L)
    t_pool = tmodel.init_paged_cache(cfg, 6, page, 1, "float32",
                                     kv_bits=kv_bits, kv_group_size=gs,
                                     device="cpu")
    tmodel.scatter_prefill_cache(cfg, t_pool, tc, 0, ids, L)
    for layer, tp in enumerate(t_pool):
        np.testing.assert_allclose(
            tp["k_alphas"].numpy(),
            np.asarray(j_pool["L0"]["k_alphas"][layer]), rtol=1e-5,
            atol=1e-6)
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


def test_reference_kv_quantize_amplifies_rounding(monkeypatch):
    """Why the KV fixture drops prompts with a quantize-on-write near-tie
    (tests/data/torch_port/make_fixture.py, KV_TIE_MARGIN): on the 9-token
    w3_pc prompt it dropped, layer 1's V from a prefill whose GEMM sums
    in fp64 differs from the fp32 prefill's by rounding only, yet the
    reference's own kv_quantize turns that into alphas 0.1 % or more
    apart (a near-tie in a refit round), so an implementation with
    another summation order meets the reference's logits there only by
    chance."""
    import json
    from pathlib import Path
    from repro_torch.ckpt import load_packed
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import dequant_ref

    fixture = Path(__file__).resolve().parent / "data" / "torch_port"
    art = json.loads((fixture / "reference.json").read_text())
    prompt = art["kv_bits"]["artifacts"]["w3_pc"]["near_tie"]["prompt"]
    assert len(prompt) == 9
    params, _, meta = load_packed(fixture / "w3_pc", device="cpu")
    cfg = get_config(meta["arch"]).replace(dtype="float32",
                                           n_layers=len(params["layers"]))

    def fp64(x, codes, alphas, betas):
        w = dequant_ref(codes[:alphas.shape[-1]], alphas, betas, x.shape[1])
        return (x.double() @ w.double()).float()

    vs = []
    for gemm in (ops.bcq_matmul, fp64):
        monkeypatch.setattr(ops, "bcq_matmul", gemm)
        _, rows = tmodel.prefill(cfg, params, torch.tensor([prompt]), 9)
        vs.append(rows[1]["v"][0].numpy())               # (Hkv, 9, hd)
    v32, v64 = vs
    assert 0 < np.abs(v32 - v64).max() < 1e-5 * np.abs(v32).max()
    a32, a64 = (np.asarray(jkv.kv_quantize(jnp.asarray(v), 4)[1])
                for v in (v32, v64))
    assert np.max(np.abs(a32 - a64) / np.abs(a32)) > 1e-3


# a 32-entry vector (float32 bit patterns) on which kv_quantize fails at 7
# bits: one of random normal K/V rows
NAN_AT_7_BITS = np.array([int(w, 16) for w in (
    "bf859de2 3fef7dcf be06cabc bf9a36fa 3fbf2caa bf5cde87 bf872ac9 "
    "3f83a02c bf819c61 3ed16353 3f74cd2d 3eaede55 3f27484e bf815579 "
    "bf93ce89 3fa402db 3fa76865 be9b659e be99584b bebe9c87 3d9abebf "
    "3eceacbe bf32900c 3f237661 c05db36d 3ee604ec bf6bb8f5 3fa2767e "
    "3f842485 bfa5849f 3f6a413b 3f9ff87b").split()],
    np.uint32).view(np.float32)


def test_kv_quantize_nan_at_seven_bits_is_the_reference_s():
    """A defect both packages share, kept visible until the quantizer is
    fixed (then this test changes with it): at 7 bits on one 32-entry
    group, a refit round's Gram matrix S S^T is singular (rank 6); its
    1e-6 ridge is lost to fp32 rounding beside a diagonal of 32, so the
    solve divides by zero and every alpha is NaN, in the reference's
    kv_quantize as in the port's. After 2 of the 6 refit rounds the
    port's alphas are not finite already (NaN and inf) and the
    reference's still are."""
    x = NAN_AT_7_BITS[None]
    ja = np.asarray(jkv.kv_quantize(jnp.asarray(x), 7, 32)[1])
    ta = tkv.kv_quantize(torch.from_numpy(x), 7, 32)[1].numpy()
    assert ja.shape == ta.shape == (1, 1, 7)
    assert np.isnan(ja).all() and np.isnan(ta).all()
    assert not np.isfinite(tkv.kv_quantize(torch.from_numpy(x), 7, 32,
                                           iters=2)[1].numpy()).all()
    assert np.isfinite(np.asarray(
        jkv.kv_quantize(jnp.asarray(x), 7, 32, iters=2)[1])).all()
    # six bits on the same vector are finite in both
    assert np.isfinite(np.asarray(jkv.kv_quantize(jnp.asarray(x), 6, 32)[1])
                       ).all()
    assert np.isfinite(tkv.kv_quantize(torch.from_numpy(x), 6, 32)[1]
                       .numpy()).all()
