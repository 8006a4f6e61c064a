"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs a CUDA device: it skips with that reason
without one (the kernels have no CPU mode) and fails instead under
REQUIRE_CUDA=1. The file imports no JAX, so it runs where the card is:

    REQUIRE_CUDA=1 PYTHONPATH=src python -m pytest --noconftest -m cuda \\
        tests/test_torch_cuda.py

(--noconftest because tests/conftest.py configures JAX.)

Tolerances: fp32 outputs rtol 1e-5 with atol 1e-5 * max|y| (fp32 sums in
another order; for the tensor-core GEMM at K = 4096 and 11008, sums of
three TF32 passes, 2e-5 * max|y|, the gate chip_smoke.py holds it to);
bf16 outputs atol 2^-7 * max|y| (both sides round W to
bf16 and multiply exactly in fp32, so they differ by the final bf16
rounding of the output, one ulp = 2^-8 relative). The batched-expert
kernel's slice of each expert equals the single-matrix kernel on that
expert exactly (both run the same code with the same split).
"""
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import bcq_matmul as tbm
from repro_torch.kernels import build, ops
from repro_torch.kernels import paged_attention as tpa
from repro_torch.kernels.ref import (paged_attention_quant_ref,
                                     paged_attention_ref)
from repro_torch.quant import QuantizedTensor, codes_from_numpy
from repro_torch.quant.kv import kv_quantize

FIXTURE = Path(__file__).resolve().parent / "data" / "torch_port"

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    """The CUDA device, or a skip (a failure under REQUIRE_CUDA=1)."""
    if torch.cuda.is_available():
        torch.backends.cuda.matmul.allow_tf32 = False
        return torch.device("cuda")
    if os.environ.get("REQUIRE_CUDA") == "1":
        pytest.fail("REQUIRE_CUDA=1 but no CUDA device is available")
    pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")


def close(got, want, bf16=False):
    got = got.float().cpu().numpy()
    want = want.float().cpu().numpy()
    scale = float(np.abs(want).max())
    if bf16:
        np.testing.assert_allclose(got, want, rtol=0, atol=2.0 ** -7 * scale)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale)


def test_kernels_build_from_the_sources(cuda):
    out = build.build_all()
    assert {p.name for p in out.glob("lib*.so")} == {
        f"lib{n}.so" for n in build.SOURCES}


# ---------------------------------------------------------------------------
# BCQ GEMV / GEMM
# ---------------------------------------------------------------------------

def make_qt(seed, M, k_in, N, G, bits, stored, scale_dtype):
    rng = np.random.default_rng(seed)
    KW = -(-k_in // 32)
    codes = rng.integers(0, 2 ** 32, (stored, KW, N), dtype=np.uint32)
    alphas = torch.from_numpy(
        (rng.random((G, N, bits)) * 0.2 + 0.01).astype(np.float32))
    betas = torch.from_numpy(
        (rng.standard_normal((G, N)) * 0.05).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((M, k_in)).astype(np.float32))
    qt = QuantizedTensor(codes_from_numpy(codes), alphas.to(scale_dtype),
                         betas.to(scale_dtype), k_in, "float32")
    return x, qt


BCQ_CASES = [
    # (M, k_in, N, G, bits, stored)
    (1, 256, 96, 1, 3, 3), (3, 250, 130, 1, 3, 3),     # pad bits, ragged N
    (8, 256, 130, 4, 2, 4),                            # active < stored
    (9, 256, 96, 2, 3, 3), (100, 512, 200, 4, 3, 3),
    (64, 4096, 256, 32, 3, 3),                         # gs 128
    (5, 11008, 72, 86, 3, 3),                          # gs 128 at K=11008
    (2, 256, 64, 1, 5, 5),                             # generic bit count
]


@pytest.mark.parametrize("M,k_in,N,G,bits,stored", BCQ_CASES)
@pytest.mark.parametrize("scale_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_bcq_kernels_match_plain(cuda, M, k_in, N, G, bits, stored,
                                 scale_dtype, x_dtype):
    x, qt = make_qt(M + k_in + N, M, k_in, N, G, bits, stored, scale_dtype)
    x = x.to(x_dtype)
    want = ops.bcq_apply(x, qt)                       # plain, on the CPU
    name = "bcq_gemv" if M <= 8 else "bcq_matmul"
    before = tbm.LAUNCHES[name]
    got = ops.bcq_apply(x.to(cuda), qt.to(cuda))
    torch.cuda.synchronize()
    assert tbm.LAUNCHES[name] == before + 1
    assert got.is_cuda and got.dtype == x_dtype
    close(got, want, bf16=x_dtype == torch.bfloat16)


# the tensor-core GEMM at the main paths' widths: ragged and multi-tile
# token counts, N = 512 and 11008, K = 4096 and 11008, group size 128
GEMM_CASES = [(16, 4096, 512), (17, 4096, 11008), (64, 11008, 512),
              (128, 4096, 11008), (129, 11008, 512), (300, 4096, 512)]


@pytest.mark.parametrize("M,k_in,N", GEMM_CASES)
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_tensor_core_gemm_at_main_path_widths(cuda, M, k_in, N, x_dtype):
    x, qt = make_qt(M + k_in + N, M, k_in, N, k_in // 128, 3, 3,
                    torch.bfloat16)
    x = x.to(x_dtype)
    want = ops.bcq_apply(x, qt).float()               # plain, on the CPU
    before = tbm.LAUNCHES["bcq_matmul"]
    got = ops.bcq_apply(x.to(cuda), qt.to(cuda))
    torch.cuda.synchronize()
    assert tbm.LAUNCHES["bcq_matmul"] == before + 1
    assert got.dtype == x_dtype and got.shape == (M, N)
    if x_dtype == torch.bfloat16:
        close(got, want, bf16=True)
    else:
        err = float((got.float().cpu() - want).abs().max())
        assert err <= 2e-5 * float(want.abs().max()), err


# the one-launch GEMV: (k_in, N, G, bits) at every row count 1..8 — K of
# 11008 (groups of 4 words across split boundaries, N ragged for a block
# but a multiple of 4) and of 1536 (N not a multiple of 4: scalar code
# loads; groups of 3 words across split boundaries), 4-bit tables with
# gs 128, the per-plane path at 6 bits with one group a word
GEMV_CASES = [(11008, 260, 86, 3), (1536, 1030, 1, 2), (1536, 200, 16, 3),
              (4096, 512, 32, 4), (2048, 96, 64, 6)]


@pytest.mark.parametrize("k_in,N,G,bits", GEMV_CASES)
@pytest.mark.parametrize("M", range(1, 9))
@pytest.mark.parametrize("scale_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_gemv_every_row_count_bit_width_and_group(cuda, k_in, N, G, bits, M,
                                                  scale_dtype, x_dtype):
    x, qt = make_qt(M * 100 + k_in + N + bits, M, k_in, N, G, bits, bits,
                    scale_dtype)
    x = x.to(x_dtype)
    want = ops.bcq_apply(x, qt)                       # plain, on the CPU
    before = tbm.LAUNCHES["bcq_gemv"]
    got = ops.bcq_apply(x.to(cuda), qt.to(cuda))
    torch.cuda.synchronize()
    assert tbm.LAUNCHES["bcq_gemv"] == before + 1
    assert got.dtype == x_dtype and got.shape == (M, N)
    close(got, want, bf16=x_dtype == torch.bfloat16)


@pytest.mark.parametrize("M", range(1, 9))
@pytest.mark.parametrize("k_in,N,G", [(1536, 4096, 1), (4096, 1536, 32)])
def test_expert_gemv_rows_at_every_row_count(cuda, M, k_in, N, G):
    """The expert decode at every capacity 1..8 with rows holding 0,
    some and all of an expert's rows: each expert bit-equal to the
    single-matrix GEMV on it, exact zeros past its rows, and within the
    fp32 tolerance of the plain version."""
    E = 6
    x, qt = make_expert_qt(M + k_in, E, M, k_in, N, G, 3, torch.bfloat16)
    rows = torch.tensor([0, M, 1, M // 2, 0, max(M - 1, 0)],
                        dtype=torch.int32)
    want = tbm._bcq_expert_plain(x, qt.codes, qt.alphas, qt.betas, rows)
    xd, qd, rd = x.to(cuda), qt.to(cuda), rows.to(cuda)
    got = tbm.bcq_expert_matmul(xd, qd.codes, qd.alphas, qd.betas, rd)
    torch.cuda.synchronize()
    close(got, want)
    for e, live in enumerate(rows.tolist()):
        assert not got[e, live:].any(), f"expert {e}"
        alone = tbm.bcq_gemv(xd[e], qd.codes[e], qd.alphas[e], qd.betas[e])
        assert torch.equal(got[e, :live], alone[:live]), f"expert {e}"


def test_bcq_wrappers_refuse_what_the_kernel_does_not_take(cuda):
    x, qt = make_qt(0, 9, 256, 64, 1, 3, 3, torch.float32)
    x, qt = x.to(cuda), qt.to(cuda)
    c, a, b = qt.codes, qt.alphas, qt.betas
    with pytest.raises(ValueError, match="rows"):
        tbm.bcq_gemv(x, c, a, b)
    with pytest.raises(ValueError, match="contiguous"):
        tbm.bcq_matmul(x.t().contiguous().t(), c, a, b)
    with pytest.raises(TypeError, match="one dtype"):
        tbm.bcq_matmul(x, c, a, b.bfloat16())
    with pytest.raises(ValueError, match="on cpu"):
        tbm.bcq_matmul(x, c.cpu(), a, b)


def make_expert_qt(seed, E, M, k_in, N, G, bits, scale_dtype):
    rng = np.random.default_rng(seed)
    KW = -(-k_in // 32)
    codes = rng.integers(0, 2 ** 32, (E, bits, KW, N), dtype=np.uint32)
    alphas = torch.from_numpy(
        (rng.random((E, G, N, bits)) * 0.2 + 0.01).astype(np.float32))
    betas = torch.from_numpy(
        (rng.standard_normal((E, G, N)) * 0.05).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((E, M, k_in)).astype(np.float32))
    qt = QuantizedTensor(codes_from_numpy(codes), alphas.to(scale_dtype),
                         betas.to(scale_dtype), k_in, "float32")
    return x, qt


EXPERT_CASES = [
    # (E, M, k_in, N, G, bits)
    (4, 1, 256, 96, 1, 3), (3, 5, 250, 130, 1, 3),      # pad bits, ragged N
    (4, 8, 512, 64, 4, 3), (5, 9, 256, 96, 2, 4),
    (6, 16, 4096, 192, 32, 3),                           # gs 128
    (128, 4, 1536, 64, 1, 3),                            # 128 experts
]


@pytest.mark.parametrize("E,M,k_in,N,G,bits", EXPERT_CASES)
@pytest.mark.parametrize("scale_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_expert_kernel_matches_plain_and_dense_kernels(
        cuda, E, M, k_in, N, G, bits, scale_dtype, x_dtype):
    x, qt = make_expert_qt(E + M + k_in + N, E, M, k_in, N, G, bits,
                           scale_dtype)
    x = x.to(x_dtype)
    want = ops.bcq_apply(x, qt)                       # plain, on the CPU
    xd, qd = x.to(cuda), qt.to(cuda)
    before = dict(tbm.LAUNCHES)
    got = ops.bcq_apply(xd, qd)
    torch.cuda.synchronize()
    assert tbm.LAUNCHES["bcq_expert_matmul"] == \
        before["bcq_expert_matmul"] + 1
    assert got.is_cuda and got.dtype == x_dtype and got.shape == (E, M, N)
    close(got, want, bf16=x_dtype == torch.bfloat16)
    # each expert's slice equals the single-matrix kernel, bit for bit
    for e in range(E):
        alone = ops.bcq_apply(xd[e], QuantizedTensor(
            qd.codes[e], qd.alphas[e], qd.betas[e], k_in, "float32"))
        assert torch.equal(got[e], alone), f"expert {e}"


@pytest.mark.parametrize("M", [4, 16])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_expert_kernel_skips_empty_experts(cuda, M, x_dtype):
    """rows: experts with 0 live rows give exact zeros; the live rows of
    the others equal the single-matrix kernel on that expert, bit for
    bit; the rest of each expert's rows are exact zeros."""
    E, k_in, N = 10, 4096, 192
    x, qt = make_expert_qt(M, E, M, k_in, N, 32, 3, torch.bfloat16)
    x = x.to(x_dtype)
    rows = torch.tensor([0, M, 1, 0, M // 2, 0, 0, 3, M, 0],
                        dtype=torch.int32)
    want = tbm._bcq_expert_plain(x, qt.codes, qt.alphas, qt.betas, rows)
    xd, qd, rd = x.to(cuda), qt.to(cuda), rows.to(cuda)
    before = tbm.LAUNCHES["bcq_expert_matmul"]
    got = tbm.bcq_expert_matmul(xd, qd.codes, qd.alphas, qd.betas, rd)
    torch.cuda.synchronize()
    assert tbm.LAUNCHES["bcq_expert_matmul"] == before + 1
    close(got, want, bf16=x_dtype == torch.bfloat16)
    single = tbm.bcq_gemv if M <= 8 else tbm.bcq_matmul
    for e, live in enumerate(rows.tolist()):
        assert not got[e, live:].any(), f"expert {e}"
        alone = single(xd[e], qd.codes[e], qd.alphas[e], qd.betas[e])
        assert torch.equal(got[e, :live], alone[:live]), f"expert {e}"


def test_expert_stack_with_ragged_groups_takes_the_counted_plain_path(cuda):
    x, qt = make_expert_qt(1, 2, 3, 96, 40, 6, 3, torch.float32)  # gs 16
    before = ops.PLAIN_CALLS["bcq_plain"]
    got = ops.bcq_apply(x.to(cuda), qt.to(cuda))
    assert ops.PLAIN_CALLS["bcq_plain"] == before + 1
    close(got, ops.bcq_apply(x, qt))


# ---------------------------------------------------------------------------
# paged attention
# ---------------------------------------------------------------------------

def make_pages(seed, page, ctx, Hkv, rep, hd, inactive):
    rng = np.random.default_rng(seed)
    B = len(ctx)
    need = [0 if b in inactive else -(-c // page) for b, c in enumerate(ctx)]
    T = max(-(-c // page) for c in ctx) + 2
    P = sum(need) + 1
    ids = rng.permutation(np.arange(1, P))
    bt = np.zeros((B, T), np.int32)
    used = 0
    for b, n in enumerate(need):
        bt[b, :n] = ids[used:used + n]
        used += n
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    return (f(B, Hkv, rep, hd), f(P, page, Hkv, hd), f(P, page, Hkv, hd),
            torch.from_numpy(bt), torch.tensor(ctx, dtype=torch.int32))


PAGED_CASES = [
    # (page, ctx, Hkv, rep, hd, window, cap, inactive)
    (4, [1, 7, 16, 13], 2, 1, 64, None, None, ()),
    (16, [16, 32, 5, 48], 2, 1, 64, None, None, ()),
    (64, [17, 64, 100, 160], 32, 1, 128, None, None, ()),   # llama2-7b
    (16, [40, 23, 9], 3, 2, 64, 8, None, ()),              # GQA + window
    (4, [40, 23, 9], 3, 2, 64, None, 5.0, ()),             # cap
    (16, [50, 17, 33], 2, 4, 32, 20, 30.0, ()),
    (16, [30, 40, 12], 2, 2, 64, None, None, (1,)),         # inactive row
    (4, [9, 77], 1, 8, 256, 16, None, (0,)),
    (64, [50, 80, 110, 131], 4, 16, 128, None, None, ()),  # Qwen3-MoE
    (16, [40, 23, 9], 2, 16, 256, 8, 30.0, ()),      # rep 16 over 2 blocks
    (16, [40, 23, 9], 1, 24, 64, None, None, (1,)),  # rep 24: 16 + 8
    # contexts over several partitions a block (8 blocks a cluster, two
    # K/V stages), ctx 1, windows that start mid-partition, rep 1, 2 and
    # 16, cap, inactive rows on the null page
    (16, [700, 1, 333], 2, 1, 128, None, None, ()),
    (16, [700, 45, 333], 2, 2, 64, 301, None, ()),
    (64, [1000, 1, 130], 4, 16, 128, 200, 30.0, (1,)),
    (16, [257, 31, 64], 1, 1, 32, 40, 5.0, (1,)),
]
# head_dim 16 (every smoke config of the zoo), fp pages only: rep 1 (half
# the P . V threads idle), 2 (the smoke configs' 4 over 2), 4, 8 and 16;
# windows, caps, several partitions a block, inactive rows
HD16_CASES = [
    (16, [17, 40, 5], 2, 1, 16, None, None, ()),
    (8, [30, 9, 64], 2, 2, 16, 32, None, ()),
    (16, [700, 1, 333], 2, 2, 16, None, 30.0, (1,)),
    (4, [40, 23, 9], 3, 4, 16, 8, 5.0, ()),
    (16, [257, 31, 64], 1, 8, 16, 40, None, (1,)),
    (64, [50, 80, 110, 131], 2, 16, 16, None, None, ()),
]


@pytest.mark.parametrize("page,ctx,Hkv,rep,hd,window,cap,inactive",
                         PAGED_CASES + HD16_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_matches_plain(cuda, page, ctx, Hkv, rep, hd,
                                       window, cap, inactive, dtype):
    q, kp, vp, bt, cl = make_pages(page + sum(ctx), page, ctx, Hkv, rep,
                                   hd, inactive)
    q, kp, vp = q.to(dtype), kp.to(dtype), vp.to(dtype)
    want = paged_attention_ref(q, kp, vp, bt, cl, window=window, cap=cap)
    before = tpa.LAUNCHES["paged_attention"]
    got = tpa.paged_attention(*(t.to(cuda) for t in (q, kp, vp, bt, cl)),
                              window=window, cap=cap)
    torch.cuda.synchronize()
    assert tpa.LAUNCHES["paged_attention"] == before + 1
    assert got.dtype == dtype
    close(got, want, bf16=dtype == torch.bfloat16)


def quant_pool(kp, vp, bits, gs):
    """Binary-coded K/V pools of fp pools (quant/kv.py layout)."""
    return (*kv_quantize(kp, bits, gs), *kv_quantize(vp, bits, gs))


def random_pool(seed, like, bits, G):
    """Binary-coded K/V pools of random code words and scales in the
    quant/kv.py layout, shaped as the fp pool `like` (P, page, Hkv, hd):
    every sign pattern, alphas in [0.1, 1.1) / sqrt(bits), small betas."""
    rng = np.random.default_rng(seed)
    P, page, Hkv, hd = like.shape
    out = []
    for _ in range(2):
        out += [torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (
                    P, page, Hkv, bits, hd // 32), dtype=np.int32)),
                torch.from_numpy(((0.1 + rng.random((P, page, Hkv, G, bits)))
                                  / bits ** 0.5).astype(np.float32)),
                torch.from_numpy(0.1 * rng.standard_normal(
                    (P, page, Hkv, G)).astype(np.float32))]
    return out


# the binary-coded reader's grid: bits 1..8 x hd {32, 64, 128, 256} x G in
# {1, 2, hd/32}, then layouts that take its other paths (groups narrower
# than the 32-entry runs it expands, a scale row of exactly
# ATTN_QUANT_SCALES_MAX bytes, scale rows too wide to stage), each over
# geometries with windows, caps, GQA, contexts that end mid-partition and
# null-page rows, on random pools (kv_quantize yields NaN alphas for some
# vectors at many bits a 32-entry group, the reference's as well)
QUANT_GRID = [(bits, hd, G) for hd in (32, 64, 128, 256)
              for bits in range(1, 9) for G in sorted({1, 2, hd // 32})] + [
    (5, 128, 8), (2, 32, 8), (7, 256, 16), (3, 64, 64), (8, 256, 256)]
QUANT_GEOMETRIES = [
    # (page, ctx, Hkv, rep, window, cap, inactive)
    (16, [45, 1, 77], 4, 1, None, None, (1,)),
    (64, [131, 33], 2, 4, 40, 30.0, ()),
    (16, [100, 250], 2, 16, None, 5.0, ()),
    (32, [70, 95, 3], 3, 2, 50, None, (2,)),
]
QUANT_CASES = [(*c, bits, gs, "quantized") for c in PAGED_CASES
               for bits, gs in ((2, 0), (3, 32), (4, 0), (4, 16))] + [
    (page, ctx, Hkv, rep, hd, window, cap, inactive, bits, hd // G, "random")
    for bits, hd, G in QUANT_GRID
    for page, ctx, Hkv, rep, window, cap, inactive in QUANT_GEOMETRIES]


@pytest.mark.parametrize(
    "page,ctx,Hkv,rep,hd,window,cap,inactive,bits,gs,pool_kind", QUANT_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_quant_matches_plain(cuda, page, ctx, Hkv, rep, hd,
                                             window, cap, inactive, bits, gs,
                                             pool_kind, dtype):
    """The kernel against its plain version on the same card: pools
    quantized there by kv_quantize, or random pools."""
    seed = page + sum(ctx) + bits
    q, kp, vp, bt, cl = (t.to(cuda) for t in make_pages(
        seed, page, ctx, Hkv, rep, hd, inactive))
    q = q.to(dtype)
    pool = (quant_pool(kp, vp, bits, gs) if pool_kind == "quantized" else
            [t.to(cuda) for t in random_pool(seed, kp, bits, hd // gs)])
    want = paged_attention_quant_ref(q, *pool, bt, cl, window=window,
                                     cap=cap)
    before = tpa.LAUNCHES["paged_attention_quant"]
    got = tpa.paged_attention_quant(q, *pool, bt, cl, window=window, cap=cap)
    torch.cuda.synchronize()
    assert tpa.LAUNCHES["paged_attention_quant"] == before + 1
    assert got.dtype == dtype
    close(got, want, bf16=dtype == torch.bfloat16)


# a rank's KV heads of a pool the model axis replicates: Qwen3-MoE's (one
# head of a 4-head pool, rep 8, hd 128) at the first, second and last
# offset, then two heads of three; windowed and capped
OFFSET_CASES = [
    # (page, ctx, pool heads, q's heads, rep, hd, window, cap)
    (64, [50, 80, 110, 131], 4, 1, 8, 128, None, None),
    (16, [700, 45, 333], 4, 1, 8, 128, 301, 30.0),
    (16, [40, 23, 9], 3, 2, 2, 64, 8, 5.0),
]


@pytest.mark.parametrize("page,ctx,pool,heads,rep,hd,window,cap",
                         OFFSET_CASES)
@pytest.mark.parametrize("where", ["first", "second", "last"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_kernels_read_a_kv_head_offset(
        cuda, page, ctx, pool, heads, rep, hd, window, cap, where, dtype):
    """Both kernels with q's KV heads at kv0 of a wider pool against
    their plain versions: fp pages in q's dtype, and 4-bit pages (G 1)
    quantized on the card."""
    kv0 = {"first": 0, "second": 1, "last": pool - heads}[where]
    q, kp, vp, bt, cl = (t.to(cuda) for t in make_pages(
        page + sum(ctx) + kv0, page, ctx, pool, rep, hd, ()))
    q = q[:, :heads].contiguous().to(dtype)
    kw = dict(window=window, cap=cap, kv0=kv0)
    fp = (kp.to(dtype), vp.to(dtype))
    want = paged_attention_ref(q.cpu(), *(t.cpu() for t in fp), bt.cpu(),
                               cl.cpu(), **kw)
    before = dict(tpa.LAUNCHES)
    got = tpa.paged_attention(q, *fp, bt, cl, **kw)
    pool_q = quant_pool(kp, vp, 4, 0)
    want_q = paged_attention_quant_ref(q, *pool_q, bt, cl, **kw)
    got_q = tpa.paged_attention_quant(q, *pool_q, bt, cl, **kw)
    torch.cuda.synchronize()
    assert tpa.LAUNCHES["paged_attention"] == before["paged_attention"] + 1
    assert tpa.LAUNCHES["paged_attention_quant"] \
        == before["paged_attention_quant"] + 1
    bf16 = dtype == torch.bfloat16
    close(got, want, bf16)
    close(got_q, want_q, bf16)


def test_paged_attention_quant_refuses_what_the_kernel_does_not_take(cuda):
    q, kp, vp, bt, cl = make_pages(0, 16, [5], 1, 1, 64, ())
    pool = [t.to(cuda) for t in quant_pool(kp, vp, 3, 0)]
    q, bt, cl = q.to(cuda), bt.to(cuda), cl.to(cuda)
    with pytest.raises(TypeError, match="fp32"):
        tpa.paged_attention_quant(q, pool[0], pool[1].double(), *pool[2:],
                                  bt, cl)
    with pytest.raises(ValueError, match="do not match"):
        tpa.paged_attention_quant(q, pool[0][..., :1].contiguous(), *pool[1:],
                                  bt, cl)


def test_paged_attention_refuses_unsupported_geometry(cuda):
    q, kp, vp, bt, cl = make_pages(0, 16, [5], 1, 1, 48, ())
    with pytest.raises(ValueError, match="head_dim"):
        tpa.paged_attention(*(t.to(cuda) for t in (q, kp, vp, bt, cl)))
    q, kp, vp, bt, cl = make_pages(0, 16, [5], 1, 1, 64, ())
    with pytest.raises(TypeError, match="int32"):
        tpa.paged_attention(*(t.to(cuda) for t in (q, kp, vp)),
                            bt.long().to(cuda), cl.to(cuda))
    with pytest.raises(ValueError, match="kv0=1"):
        tpa.paged_attention(*(t.to(cuda) for t in (q, kp, vp, bt, cl)),
                            kv0=1)


# ---------------------------------------------------------------------------
# the fixture served on the card
# ---------------------------------------------------------------------------

def test_fixture_serves_on_the_card_like_the_reference(cuda):
    from repro_torch.ckpt import load_packed
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve import Request, ServeEngine
    ref = json.loads((FIXTURE / "reference.json").read_text())
    for name, art in ref["artifacts"].items():
        params, _, meta = load_packed(FIXTURE / name)
        cfg = get_config(meta["arch"]).replace(
            dtype="float32", n_layers=len(params["layers"]))
        eng = ServeEngine(cfg, params, batch_size=2, max_len=64,
                          dtype="float32", cache_kind="paged", page_size=16)
        reqs = [Request(prompt=np.asarray(p, np.int32),
                        max_new_tokens=ref["max_new"])
                for p in art["prompts"]]
        reset_launch_counts()
        eng.run(reqs)
        counts = launch_counts()
        assert [r.out for r in reqs] == art["tokens"]
        assert counts["bcq_gemv"] and counts["bcq_matmul"]
        assert counts["paged_attention"] and not counts["bcq_plain"]


def test_fixture_with_binary_coded_kv_and_moe_serves_like_the_reference(
        cuda):
    """tiny-lm with 4-bit KV pages and the tiny-moe artifact, through the
    paged engine on the card: the reference's recorded greedy tokens, and
    the new kernels on the path."""
    from repro_torch.ckpt import load_packed
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve import Request, ServeEngine
    ref = json.loads((FIXTURE / "reference.json").read_text())
    kvb = ref["kv_bits"]
    runs = [(name, art, kvb["bits"], "paged_attention_quant")
            for name, art in kvb["artifacts"].items()]
    runs.append(("w3_moe", ref["artifacts"]["w3_moe"], 0,
                 "bcq_expert_matmul"))
    for name, art, bits, kernel in runs:
        params, _, meta = load_packed(FIXTURE / name)
        cfg = get_config(meta["arch"]).replace(
            dtype="float32", n_layers=len(params["layers"]))
        eng = ServeEngine(cfg, params, batch_size=2, max_len=64,
                          dtype="float32", cache_kind="paged",
                          page_size=kvb["page_size"], kv_bits=bits)
        reqs = [Request(prompt=np.asarray(p, np.int32),
                        max_new_tokens=ref["max_new"])
                for p in art["prompts"]]
        reset_launch_counts()
        eng.run(reqs)
        counts = launch_counts()
        assert [r.out for r in reqs] == art["tokens"], name
        assert counts[kernel] and not counts["bcq_plain"], counts
