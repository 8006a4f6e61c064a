"""The port's MoE path against the reference's on the same numpy
inputs: the plain batched-expert BCQ GEMM against the reference's Pallas
`bcq_expert_matmul` in interpret mode, the expert branch of
`ops.bcq_apply`, `moe_forward` at training capacity (with drops), decode
capacity and dropless, the MoE config copies, and the committed tiny-moe
w3 artifact (written by the reference quantizer) through prefill and
paged decode.

On the CPU the wrapper runs its plain version; the CUDA kernel is held
against it, and against the single-matrix kernels expert by expert, in
tests/test_torch_cuda.py.

Tolerances: expert GEMM 2e-5 * max|y| (fp32 sums in another order; bf16
scales are expanded in fp32 by both); moe_forward rtol/atol 1e-5 of
max|out|; logits atol 1e-4 * max|logit| (fp32 end to end). The router
runs in fp32 on both sides; torch.topk and jax.lax.top_k break exact
ties differently, which random fp32 router logits do not produce.
"""
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt.packed import load_packed as jax_load_packed
from repro.configs import get_config as jax_get_config
from repro.kernels import ops as jops
from repro.kernels.bcq_matmul import bcq_expert_matmul as jax_expert
from repro.kernels.ref import bcq_expert_matmul_ref as jax_expert_ref
from repro.models import model as jmodel
from repro.models import moe as jmoe
from repro.quant import QuantizedTensor as JaxQT
from repro_torch.ckpt import load_packed, params_from_tree
from repro_torch.configs import get_config
from repro_torch.kernels import bcq_matmul as tbm
from repro_torch.kernels import ops
from repro_torch.kernels.ref import bcq_expert_matmul_ref
from repro_torch.models import model as tmodel
from repro_torch.models import moe as tmoe
from repro_torch.quant import QuantizedTensor, codes_from_numpy
from test_torch_model import close_logits, moe_fields, port_cfg

FIXTURE = Path(__file__).resolve().parent / "data" / "torch_port"


def test_moe_configs_match_reference():
    for name in ("tiny-moe", "qwen3-moe-235b-a22b"):
        jcfg, cfg = jax_get_config(name), get_config(name)
        assert port_cfg(jcfg) == cfg.replace(quant=port_cfg(jcfg).quant)
        assert dataclasses.asdict(cfg.moe) == moe_fields(jcfg.moe)
    assert get_config("tiny-moe").moe.capacity_factor == 1.25
    assert get_config("tiny-moe").moe.inference_capacity_factor == 2.0


# ---------------------------------------------------------------------------
# the batched-expert GEMM
# ---------------------------------------------------------------------------

def make_experts(seed, E, M, K, N, G, bits=3, scale_dtype=jnp.float32):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 2 ** 32, (E, bits, K // 32, N), dtype=np.uint32)
    alphas = np.asarray(jnp.asarray(
        rng.random((E, G, N, bits)) * 0.2 + 0.01, scale_dtype))
    betas = np.asarray(jnp.asarray(
        rng.standard_normal((E, G, N)) * 0.05, scale_dtype))
    x = rng.standard_normal((E, M, K)).astype(np.float32)
    return x, codes, alphas, betas


def to_torch(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    if a.dtype == np.uint32:
        return codes_from_numpy(a)
    return torch.from_numpy(a.copy())


@pytest.mark.parametrize("E", [2, 4])
@pytest.mark.parametrize("M", [1, 5, 16])
@pytest.mark.parametrize("G", [1, 4])                     # G = 4: gs 64
@pytest.mark.parametrize("scale_dtype", [jnp.float32, jnp.bfloat16])
def test_expert_matmul_matches_reference_kernel(E, M, G, scale_dtype):
    K, N = 256, 96
    x, codes, alphas, betas = make_experts(E * 100 + M * 10 + G, E, M, K, N,
                                           G, scale_dtype=scale_dtype)
    want = np.asarray(jax_expert(*(jnp.asarray(a) for a in
                                   (x, codes, alphas, betas)),
                                 interpret=True))
    before = dict(tbm.LAUNCHES)
    got = tbm.bcq_expert_matmul(*(to_torch(a) for a in
                                  (x, codes, alphas, betas)))
    assert tbm.LAUNCHES == before
    assert got.dtype == torch.float32 and tuple(got.shape) == (E, M, N)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=2e-5 * np.abs(want).max())
    oracle = bcq_expert_matmul_ref(*(to_torch(a) for a in
                                     (x, codes, alphas, betas)), K)
    np.testing.assert_allclose(
        oracle.numpy(),
        np.asarray(jax_expert_ref(*(jnp.asarray(a) for a in
                                    (x, codes, alphas, betas)), K)),
        rtol=0, atol=2e-5 * np.abs(want).max())


@pytest.mark.parametrize("k_in,G,lead", [
    (250, 1, (3,)),          # pad bits: x zero-padded to the packed K
    (128, 2, (3,)),          # gs 64: the expert kernel
    (96, 6, (3,)),           # gs 16: ragged grouping, counted plain path
    (64, 1, (2, 3)),         # a deeper stack: counted plain path
])
def test_bcq_apply_expert_branch_matches_reference(k_in, G, lead):
    rng = np.random.default_rng(k_in + G)
    N, bits, C = 40, 3, 5
    KW = -(-k_in // 32)
    codes = rng.integers(0, 2 ** 32, (*lead, bits, KW, N), dtype=np.uint32)
    alphas = (rng.random((*lead, G, N, bits)) * 0.2).astype(np.float32)
    betas = (rng.standard_normal((*lead, G, N)) * 0.05).astype(np.float32)
    rows = (C,) if len(lead) == 1 else ()      # one row per deeper element
    x = rng.standard_normal((*lead, *rows, k_in)).astype(np.float32)
    jqt = JaxQT(jnp.asarray(codes), jnp.asarray(alphas), jnp.asarray(betas),
                k_in, "float32")
    want = np.asarray(jops.bcq_apply(jnp.asarray(x), jqt))
    qt = QuantizedTensor(codes_from_numpy(codes), torch.from_numpy(alphas),
                         torch.from_numpy(betas), k_in, "float32")
    plain = ops.PLAIN_CALLS["bcq_plain"]
    got = ops.bcq_apply(torch.from_numpy(x), qt)
    kernel_ok = len(lead) == 1 and (G == 1 or (k_in // G) % 32 == 0)
    assert ops.PLAIN_CALLS["bcq_plain"] == plain + (not kernel_ok)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=2e-5 * np.abs(want).max())


# ---------------------------------------------------------------------------
# moe_forward
# ---------------------------------------------------------------------------

def moe_case(seed, quantized):
    """tiny-moe's reference MoE params (optionally with random w3 expert
    stacks) and the same on the port side."""
    jcfg = jax_get_config("tiny-moe").replace(dtype="float32")
    p = jmoe.init_moe(jcfg, jax.random.PRNGKey(seed), jnp.float32)
    if quantized:
        rng = np.random.default_rng(seed)
        for name in ("wg", "wu", "wd"):
            E, K, N = p[name].shape
            codes = rng.integers(0, 2 ** 32, (E, 3, K // 32, N),
                                 dtype=np.uint32)
            alphas = (np.array([4.0, 2.0, 1.0]) / np.sqrt(21.0) * K ** -0.5
                      * (1 + 0.1 * rng.random((E, 1, N, 3)))
                      ).astype(np.float32)
            betas = np.zeros((E, 1, N), np.float32)
            p[name] = JaxQT(jnp.asarray(codes), jnp.asarray(alphas),
                            jnp.asarray(betas), K, "float32")
    return jcfg, p, params_from_tree(p, device="cpu")


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("cf,dropless", [(1.25, False), (4.0, False),
                                         (None, True)])
def test_moe_forward_matches_reference(quantized, cf, dropless):
    jcfg, jp, tp = moe_case(3, quantized)
    cfg = port_cfg(jcfg)
    rng = np.random.default_rng(4)
    B, S = 3, 16
    # a shared component makes tokens prefer the same experts, so the
    # training capacity overflows and drops tokens
    x = (rng.standard_normal((B, S, cfg.d_model))
         + rng.standard_normal(cfg.d_model)).astype(np.float32)
    want, waux = jmoe.moe_forward(jcfg, jp, jnp.asarray(x),
                                  capacity_factor=cf, dropless=dropless)
    if dropless:         # the port has no flag: a factor of E gives C = T
        cf = float(cfg.moe.n_experts)
        assert tmoe.capacity(cfg, B * S, cf) == B * S
    got, aux = tmoe.moe_forward(cfg, tp, torch.from_numpy(x),
                                capacity_factor=cf)
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(float(aux), float(waux), rtol=1e-5)
    if cf == 1.25:       # this case drops tokens, as the reference does
        C = tmoe.capacity(cfg, B * S, cf)
        topi = torch.topk(torch.from_numpy(x.reshape(B * S, -1))
                          @ tp["router"], cfg.moe.top_k).indices
        assert int(torch.bincount(topi.reshape(-1)).max()) > C


@pytest.mark.parametrize("cf", [1.25, 4.0])
def test_moe_forward_passes_filled_slot_counts(monkeypatch, cf):
    """moe_forward tells each expert matmul how many of its C slots hold
    a token: the per-expert routed counts of the reference's own
    dispatch, clamped at C, one int32 tensor for wg, wu and wd alike
    (an empty slot's h is silu(0) * 0 = 0)."""
    jcfg, jp, tp = moe_case(5, True)
    cfg = port_cfg(jcfg)
    rng = np.random.default_rng(6)
    B, S = 2, 16
    x = (rng.standard_normal((B, S, cfg.d_model))
         + rng.standard_normal(cfg.d_model)).astype(np.float32)
    T, E, K = B * S, cfg.moe.n_experts, cfg.moe.top_k
    C = tmoe.capacity(cfg, T, cf)
    # the reference's dispatch: its router, top-k and slot assignment
    probs = jax.nn.softmax(jnp.asarray(x.reshape(T, -1))
                           @ jnp.asarray(jp["router"], jnp.float32), -1)
    e_flat = np.asarray(jax.lax.top_k(probs, K)[1]).reshape(-1)
    order = np.argsort(e_flat, kind="stable")
    se = e_flat[order]
    pos = np.arange(T * K) - np.searchsorted(se, se, side="left")
    kept = np.bincount(se[pos < C], minlength=E)
    seen = []
    real = tmoe._expert_matmul

    def record(v, w, rows=None):
        seen.append(rows)
        return real(v, w, rows)

    monkeypatch.setattr(tmoe, "_expert_matmul", record)
    got, _ = tmoe.moe_forward(cfg, tp, torch.from_numpy(x),
                              capacity_factor=cf)
    want, _ = jmoe.moe_forward(jcfg, jp, jnp.asarray(x), capacity_factor=cf)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(want)).max())
    assert len(seen) == 3 and seen[0] is seen[1] is seen[2]
    assert seen[0].dtype == torch.int32
    np.testing.assert_array_equal(seen[0].numpy(), kept)
    routed = np.bincount(e_flat, minlength=E)
    assert (kept == np.minimum(routed, C)).all()
    assert (routed > C).any() == (cf == 1.25)      # clamped when it drops


def test_init_moe_layout_matches_reference():
    jcfg = jax_get_config("tiny-moe")
    cfg = get_config("tiny-moe")
    gen = torch.Generator().manual_seed(0)
    mine = tmoe.init_moe(cfg, gen, "float32", "cpu")
    ref = jax.eval_shape(lambda: jmoe.init_moe(jcfg, jax.random.PRNGKey(0),
                                               jnp.float32))
    assert {k: tuple(v.shape) for k, v in mine.items()} == \
        {k: v.shape for k, v in ref.items()}
    assert mine["router"].dtype == torch.float32
    full = tmodel.init_params(cfg, seed=1, dtype="float32", device="cpu")
    assert set(full["layers"][0]) == {"ln", "attn", "ln2", "moe"}


# ---------------------------------------------------------------------------
# the tiny-moe w3 artifact through the model
# ---------------------------------------------------------------------------

def test_tiny_moe_w3_prefill_and_paged_decode_match_reference():
    jp = jax_load_packed(FIXTURE / "w3_moe")[0]
    params, _, meta = load_packed(FIXTURE / "w3_moe", device="cpu")
    jcfg = jax_get_config(meta["arch"]).replace(dtype="float32",
                                                n_layers=meta["n_layers"])
    cfg = port_cfg(jcfg)
    assert cfg == get_config("tiny-moe").replace(dtype="float32")
    wg = params["layers"][1]["moe"]["wg"]
    assert isinstance(wg, QuantizedTensor) and wg.codes.dim() == 4
    np.testing.assert_array_equal(
        wg.codes.numpy().view(np.uint32),
        np.asarray(jp["blocks"]["L0"]["moe"]["wg"].codes)[1])
    rng = np.random.default_rng(9)
    L, page, steps, S = 13, 8, 3, 16
    tokens = np.zeros((1, S), np.int32)             # a bucket-padded prompt
    tokens[0, :L] = rng.integers(0, cfg.vocab_size, L)
    last = np.array([L - 1], np.int32)
    jl, jc = jmodel.prefill(jcfg, jp, jnp.asarray(tokens), S,
                            last_pos=jnp.asarray(last))
    tl, tc = tmodel.prefill(cfg, params, torch.from_numpy(tokens), S,
                            last_pos=torch.from_numpy(last))
    close_logits(tl, jl)
    ids = [2, 4]
    bt = np.array([[2, 4, 0]], np.int32)
    j_pool = jmodel.init_paged_cache(jcfg, 5, page, 1, "float32")
    j_pool = jmodel.scatter_prefill_cache(jcfg, j_pool, jc, 0,
                                          jnp.asarray(ids, jnp.int32), L)
    t_pool = tmodel.init_paged_cache(cfg, 5, page, 1, "float32",
                                     device="cpu")
    tmodel.scatter_prefill_cache(cfg, t_pool, tc, 0, ids, L)
    plain = ops.PLAIN_CALLS["bcq_plain"]
    for t in range(steps):
        tok = np.array([[7 + t]], np.int32)
        pos = np.array([L + t], np.int32)
        jl, j_pool = jmodel.decode_step_paged(
            jcfg, jp, j_pool, jnp.asarray(tok), jnp.asarray(pos),
            jnp.asarray(bt))
        tl, t_pool = tmodel.decode_step_paged(
            cfg, params, t_pool, torch.from_numpy(tok),
            torch.from_numpy(pos), torch.from_numpy(bt))
        close_logits(tl, jl)
    assert ops.PLAIN_CALLS["bcq_plain"] == plain


def test_decode_and_prefill_capacities_match_reference():
    """Qwen3-MoE at batch 4: C = 4 rows per expert at decode and C = 16
    in a 128-token prefill bucket (the reference's formula)."""
    cfg = get_config("qwen3-moe-235b-a22b")
    assert tmoe.capacity(cfg, 4, tmodel.DECODE_CAPACITY_FACTOR) == 4
    assert tmoe.capacity(cfg, 128, cfg.moe.inference_capacity_factor) == 16
    jcfg = jax_get_config("tiny-moe")
    for T in (1, 4, 13, 64):
        for cf in (1.25, 2.0, 4.0):
            C = min(T, max(1, int(-(-T * jcfg.moe.top_k
                                    // jcfg.moe.n_experts) * cf)))
            assert tmoe.capacity(port_cfg(jcfg), T, cf) == C
