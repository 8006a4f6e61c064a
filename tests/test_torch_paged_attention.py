"""The port's paged-attention decode (repro_torch/kernels/
paged_attention.py) against the reference's Pallas `paged_attention`
in interpret mode and its `paged_attention_ref` oracle, on the same
numpy inputs: page sizes 4/16/64, ragged contexts and contexts on a
page boundary, GQA (the tiny-lm-wide geometry), window and cap, tables
padded with the null page 0, and an inactive row that names only the
null page; and a rank's KV-head offset into a pool of more heads (fp
and binary-coded pages) against the reference's oracle on the rank's
head slice of the pool.

On the CPU the wrapper runs its plain version; the CUDA kernel is held
against it in tests/test_torch_cuda.py. Tolerance: fp32 rtol 1e-5 and
atol 1e-5 * max|out| (online vs one-pass softmax and another summation
order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention import paged_attention as jax_paged
from repro.kernels.ref import paged_attention_quant_ref as jax_quant_ref
from repro.kernels.ref import paged_attention_ref as jax_paged_ref
from repro.quant import kv as jkv
from repro_torch.kernels import paged_attention as tpa
from repro_torch.kernels.ref import paged_attention_ref
from repro_torch.quant import codes_from_numpy


def make(seed, page, ctx, Hkv=2, rep=1, hd=64, inactive=(), spare=2):
    """Pool with distinct pages per sequence (shuffled ids 1..), tables
    padded with 0, and `inactive` rows pointing at the null page only
    (their ctx is an arbitrary pos + 1, as the engine leaves it)."""
    rng = np.random.default_rng(seed)
    B = len(ctx)
    need = [0 if b in inactive else -(-c // page) for b, c in enumerate(ctx)]
    T = max(max(-(-c // page) for c in ctx), 1) + spare
    P = sum(need) + 1
    ids = rng.permutation(np.arange(1, P))
    bt = np.zeros((B, T), np.int32)
    used = 0
    for b, n in enumerate(need):
        bt[b, :n] = ids[used:used + n]
        used += n
    q = rng.standard_normal((B, Hkv, rep, hd)).astype(np.float32)
    kp = rng.standard_normal((P, page, Hkv, hd)).astype(np.float32)
    vp = rng.standard_normal((P, page, Hkv, hd)).astype(np.float32)
    return q, kp, vp, bt, np.asarray(ctx, np.int32)


CASES = [
    # (page, ctx, Hkv, rep, hd, window, cap, inactive)
    (4, [1, 7, 16, 13], 2, 1, 64, None, None, ()),
    (16, [16, 32, 5, 48], 2, 1, 64, None, None, ()),     # page boundaries
    (64, [1, 64, 65, 130], 2, 1, 128, None, None, ()),
    (16, [40, 23, 9], 3, 2, 64, None, None, ()),         # tiny-lm-wide GQA
    (16, [40, 23, 9], 3, 2, 64, 8, None, ()),
    (4, [40, 23, 9], 3, 2, 64, None, 5.0, ()),
    (16, [50, 17, 33], 2, 4, 32, 20, 30.0, ()),
    (16, [30, 40, 12], 2, 2, 64, None, None, (1,)),       # inactive row
    (4, [9, 77], 1, 8, 64, 16, None, (0,)),
]


def _torch(*arrays):
    return [torch.from_numpy(a.copy()) for a in arrays]


def close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.parametrize("page,ctx,Hkv,rep,hd,window,cap,inactive", CASES)
def test_matches_reference_kernel(page, ctx, Hkv, rep, hd, window, cap,
                                  inactive):
    q, kp, vp, bt, cl = make(page + sum(ctx), page, ctx, Hkv, rep, hd,
                             inactive)
    want = jax_paged(*(jnp.asarray(a) for a in (q, kp, vp, bt, cl)),
                     window=window, cap=cap, interpret=True)
    oracle = jax_paged_ref(*(jnp.asarray(a) for a in (q, kp, vp, bt, cl)),
                           window=window, cap=cap)
    before = dict(tpa.LAUNCHES)
    got = tpa.paged_attention(*_torch(q, kp, vp, bt, cl), window=window,
                              cap=cap)
    assert tpa.LAUNCHES == before
    assert got.dtype == torch.float32 and tuple(got.shape) == q.shape
    close(got.numpy(), np.asarray(want))
    close(paged_attention_ref(*_torch(q, kp, vp, bt, cl), window=window,
                              cap=cap).numpy(), np.asarray(oracle))


def test_repeated_null_page_rows():
    """A row whose table names page 0 everywhere, with a context spanning
    several copies of it (inactive rows in the engine), reads the same
    page repeatedly and still matches the reference."""
    q, kp, vp, bt, _ = make(3, 4, [10, 6], inactive=(0, 1), spare=4)
    cl = np.array([17, 6], np.int32)
    want = jax_paged(*(jnp.asarray(a) for a in (q, kp, vp, bt, cl)),
                     interpret=True)
    got = tpa.paged_attention(*_torch(q, kp, vp, bt, cl))
    close(got.numpy(), np.asarray(want))


def test_rejects_bad_window_and_cap():
    q, kp, vp, bt, cl = make(0, 16, [5])
    with pytest.raises(ValueError, match="window"):
        tpa.paged_attention(*_torch(q, kp, vp, bt, cl), window=0)


# (the pool's KV heads, q's, kv0, window, cap): Qwen3-MoE's rank geometry
# on a model axis wider than its KV heads (one head of a 4-head pool at
# the first, a middle and the last offset), and two heads from the middle
OFFSETS = [(4, 1, 0, None, None), (4, 1, 1, 12, None), (4, 1, 3, None, 30.0),
           (4, 2, 1, 20, 5.0)]


@pytest.mark.parametrize("pool,heads,kv0,window,cap", OFFSETS)
def test_kv_head_offset_reads_the_rank_s_heads(pool, heads, kv0, window, cap):
    """q's KV head h reads the pool's kv0 + h: the plain versions equal
    the reference's oracles on the pool's head slice, over fp pages and
    4-bit pages (G 1)."""
    q, kp, vp, bt, cl = make(kv0 + 7 * pool, 8, [20, 9, 33], pool, 8, 32)
    q = np.ascontiguousarray(q[:, :heads])
    mine = slice(kv0, kv0 + heads)
    want = jax_paged_ref(*(jnp.asarray(a) for a in (
        q, kp[:, :, mine], vp[:, :, mine], bt, cl)), window=window, cap=cap)
    got = tpa.paged_attention(*_torch(q, kp, vp, bt, cl), window=window,
                              cap=cap, kv0=kv0)
    close(got.numpy(), np.asarray(want))
    codes, alphas, betas = (np.asarray(a) for a in jkv.kv_quantize(
        jnp.asarray(np.stack([kp, vp])), 4, 0))
    pool_q = [codes[0], alphas[0], betas[0], codes[1], alphas[1], betas[1]]
    want = jax_quant_ref(*(jnp.asarray(a) for a in (
        q, *(t[:, :, mine] for t in pool_q), bt, cl)), window=window,
        cap=cap)
    got = tpa.paged_attention_quant(
        torch.from_numpy(q), *(codes_from_numpy(t) if t.dtype == np.uint32
                               else torch.from_numpy(t.copy())
                               for t in pool_q),
        *_torch(bt, cl), window=window, cap=cap, kv0=kv0)
    close(got.numpy(), np.asarray(want))


def test_rejects_a_kv_head_offset_past_the_pool():
    q, kp, vp, bt, cl = make(0, 16, [5], Hkv=4)
    with pytest.raises(ValueError, match="kv0=3"):
        tpa.paged_attention(*_torch(q[:, :2], kp, vp, bt, cl), kv0=3)
    with pytest.raises(ValueError, match="kv0=-1"):
        tpa.paged_attention(*_torch(q[:, :1], kp, vp, bt, cl), kv0=-1)


def kernel_partitions(rank, clusters, ctx_raw, window, capacity):
    """The partitions block `rank` of a cluster visits, as the kernel
    computes them: the live ones [t_lo, t_hi) of the context, taken
    t_lo + rank, t_lo + rank + clusters, ..."""
    ctx = min(ctx_raw, capacity)
    j0 = max(0, ctx_raw - window) if window else 0
    t_lo, t_hi = j0 // tpa.ATTN_TILE, -(-ctx // tpa.ATTN_TILE)
    return list(range(t_lo + rank, t_hi, clusters))


# (n_table, page, units, stage bytes): llama2-7b's and Qwen3-MoE's decode
# (128 and 16 units, fp32 hd 128 tiles, then their 4-bit G=1 binary-coded
# stages: quant_stage_bytes(128, 4, 1)), short and long tables, hd 256
LAUNCHES = [(3, 64, 128, 33792), (3, 64, 16, 33792), (3, 64, 128, 7168),
            (3, 64, 16, 7168), (1, 4, 6, 8704), (2, 16, 6, 16896),
            (16, 64, 4, 33792), (63, 16, 2, 33792), (5, 48, 3, 66560)]


@pytest.mark.parametrize("n_table,page,units,stage_bytes", LAUNCHES)
def test_partitions_cover_the_live_context_once(n_table, page, units,
                                                stage_bytes):
    """The cluster's blocks visit each partition that meets [j0, ctx)
    exactly once, and none other, for every context length up to the
    table's capacity and several windows. A block holds at most
    ATTN_MAX_STAGES tile pairs within ATTN_STAGE_BUDGET, as many as the
    busiest block can use; the clusters reach one block an SM unless the
    partitions run out, and fewer would leave a block more partitions
    than it can hold."""
    clusters, stages = tpa.attention_launch_shape(n_table, page, units,
                                                  stage_bytes, sms=132)
    assert 1 <= clusters <= tpa.ATTN_MAX_CLUSTER
    assert 1 <= stages <= tpa.ATTN_MAX_STAGES
    assert stages == 1 or stages * stage_bytes <= tpa.ATTN_STAGE_BUDGET
    cap = n_table * page
    T = tpa.ATTN_TILE
    parts = -(-cap // T)
    most = 0
    for ctx in range(0, cap + 3):
        for window in (None, 1, 7, 31, 32, 45, 300):
            seen = [t for r in range(clusters)
                    for t in kernel_partitions(r, clusters, ctx, window, cap)]
            lo = max(0, ctx - window) if window else 0
            want = [t for t in range(parts)
                    if t * T < min(ctx, cap) and t * T + T > lo]
            assert sorted(seen) == want, (ctx, window)
            most = max(most, max((len(kernel_partitions(
                r, clusters, ctx, window, cap)) for r in range(clusters))))
    assert stages <= most or most == 0
    hold = max(1, min(tpa.ATTN_MAX_STAGES,
                      tpa.ATTN_STAGE_BUDGET // stage_bytes))
    assert stages == min(most, hold)
    assert clusters * units >= 132 or clusters == min(parts,
                                                      tpa.ATTN_MAX_CLUSTER)
    if clusters > 1:
        assert -(-parts // (clusters - 1)) > hold or \
            (clusters - 1) * units < 132


def copy_width(nbytes):
    """Bytes of one cp.async copy of a piece of `nbytes` a row, as the
    kernel's launcher (csrc `copy_width`) picks it for pools at 16-byte
    aligned addresses (the allocator's): the widest of 16, 8 and 4 that
    divides the piece."""
    return 16 if nbytes % 16 == 0 else 8 if nbytes % 8 == 0 else 4


def quant_pieces(hd, bits, G):
    """Bytes of one (token, KV head) row of a binary-coded pool's code
    words, alphas and betas."""
    return bits * hd // 8, 4 * G * bits, 4 * G


# (hd, bits, G): bytes of a partition's staged rows (K and V, 32 tokens,
# each piece at an odd number of 16-byte units) and the copy widths of
# codes, alphas, betas, counted by hand
QUANT_STAGES = [
    (128, 4, 1, 64 * (80 + 16 + 16), (16, 16, 4)),   # codes 64 B -> 80
    (32, 3, 1, 64 * (16 + 16 + 16), (4, 4, 4)),      # 12-byte codes, alphas
    (64, 1, 2, 64 * (16 + 16 + 16), (8, 8, 8)),
    (256, 8, 8, 64 * (272 + 272 + 48), (16, 16, 16)),
    (64, 3, 64, 64 * 48, (8, 16, 16)),               # scales not staged
]


@pytest.mark.parametrize("hd,bits,G,stage,widths", QUANT_STAGES)
def test_quant_stage_bytes_by_hand(hd, bits, G, stage, widths):
    assert tpa.quant_stage_bytes(hd, bits, G) == stage
    assert tuple(map(copy_width, quant_pieces(hd, bits, G))) == widths


def odd_units(nbytes):
    """16-byte units of a staged row: enough for nbytes, and odd."""
    units = -(-nbytes // 16)
    return units if units % 2 else units + 1


@pytest.mark.parametrize("hd", [32, 64, 128, 256])
@pytest.mark.parametrize("bits", range(1, 9))
def test_quant_stage_bytes_and_copy_widths(hd, bits):
    """The binary-coded reader's stage over the grid bits 1..8, hd
    32..256, G in {1, 2, hd/32}: code rows of bits * hd / 8 bytes, alpha
    rows of 4 G bits, beta rows of 4 G, each copied in the widest of 16,
    8 and 4 bytes that divides it, and staged at an odd number of
    16-byte units (scales only up to ATTN_QUANT_SCALES_MAX bytes a
    row)."""
    for G in sorted({1, 2, hd // 32}):
        pieces = quant_pieces(hd, bits, G)
        for nbytes in pieces:
            w = copy_width(nbytes)
            assert w in (4, 8, 16) and nbytes % w == 0
            assert w == 16 or nbytes % (2 * w), (nbytes, w)
        staged = [pieces[0]] + (list(pieces[1:]) if sum(pieces[1:])
                                <= tpa.ATTN_QUANT_SCALES_MAX else [])
        want = 2 * 32 * 16 * sum(odd_units(n) for n in staged)
        assert tpa.quant_stage_bytes(hd, bits, G) == want


def test_quant_launch_fits_shared_memory():
    """Every binary-coded layout the wrapper takes (hd 32..256, bits
    1..8, every power-of-two G dividing hd) launches within the 232,448
    bytes of shared memory a block may have, at the largest table and
    every query-head bucket: the table row, the ring of stages, the
    expanded fp32 tile pair, and the kernel's own floats (q, score
    parts, P, softmax state, the merged state)."""
    for hd in tpa.QUANT_HEAD_DIMS:
        pair = tpa.tile_pair_bytes(hd, 4)
        for bits in range(1, 9):
            for G in (1 << i for i in range(hd.bit_length())):
                stage = tpa.quant_stage_bytes(hd, bits, G)
                _, stages = tpa.attention_launch_shape(
                    tpa.MAX_TABLE, 64, 1, stage, sms=132,
                    budget=tpa.ATTN_STAGE_BUDGET - pair)
                for rep in (1, 2, 4, 8, 16):
                    dp = 8 // min(rep, 8)
                    floats = 2 * rep * hd + dp * rep * 32 + 32 * rep + 4 * rep
                    total = (4 * tpa.MAX_TABLE + stages * stage + pair
                             + 4 * floats)
                    assert total <= 232448, (hd, bits, G, rep, total)
