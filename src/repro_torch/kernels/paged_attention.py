"""Wrappers of the paged-attention decode kernels
(csrc/paged_attention.cu), replacing the reference's Pallas
`kernels/paged_attention.py:paged_attention` and
`paged_attention_quant`.

q (B, Hkv, rep, hd); block_tables (B, T) int32 page ids; ctx_lens (B,)
int32 live tokens per sequence (including the token just written).
Returns (B, Hkv, rep, hd) in q.dtype. The pool may hold more KV heads
than q: with `kv0`, q's KV head h reads the pool's head kv0 + h (a rank
of a model axis that does not divide the KV heads keeps the whole pool,
replicated, and reads its own heads; models/attention.py). Unused table
slots must hold a
valid page id (the allocator keeps them 0, the null page); tokens are
masked by index. `paged_attention` reads fp pages k/v (P, page, Hkv,
hd) in q's dtype; `paged_attention_quant` reads binary-coded pages
(quant/kv.py layout: codes (P, page, Hkv, bits, hd/32) int32 words,
alphas (P, page, Hkv, G, bits) and betas (P, page, Hkv, G) fp32) and
expands them inside the kernel. Any GQA width rep is taken.

The kernels split each context into partitions of ATTN_TILE tokens
over the blocks of a thread-block cluster, which merge their softmax
states in rank order through distributed shared memory: one launch per
call, no scratch. Each block copies its partitions' rows into a ring of
`stages` shared-memory slots by cp.async, all in flight at once: fp
pages as the K/V tiles themselves; binary-coded pages as their raw rows
(code words, alphas and betas, each in copies of 16, 8 or 4 bytes,
the widest that the piece's size and the pool's address allow), which
the block expands into one fp32 tile pair
once they have arrived, freeing the slot for the next partition.
`attention_launch_shape` sizes the cluster and the ring from the
table's capacity, the number of (sequence, KV head, query-head group)
units, the bytes of one stage (`quant_stage_bytes` for binary-coded
pages) and the card's SM count.

A CUDA tensor launches the kernel (or raises); a CPU tensor runs the
plain version, `ref.paged_attention_ref` / `ref.paged_attention_quant_ref`;
a meta tensor launches nothing and returns an empty output of q's shape,
reporting the kernel's own bytes and operations over every page its
table names (kernels/work.py). `LAUNCHES` counts kernel launches only.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.hw import (ATTN_MAX_CLUSTER, ATTN_MAX_REP, ATTN_MAX_STAGES,
                           ATTN_QUANT_SCALES_MAX, ATTN_TILE, H100_SMS,
                           sm_count)
from repro_torch.kernels import build, work
from repro_torch.kernels.ref import (paged_attention_quant_ref,
                                     paged_attention_ref)
from repro_torch.roofline.analysis import paged_attention_work

LAUNCHES = {"paged_attention": 0, "paged_attention_quant": 0}
# head_dims of the fp kernel; binary-coded pages pack hd in 32-bit words
HEAD_DIMS = (16, 32, 64, 128, 256)
QUANT_HEAD_DIMS = (32, 64, 128, 256)
MAX_KV_BITS = 8
# block-table entries a block keeps in shared memory at most (32 KB)
MAX_TABLE = 8192
# shared memory for a block's ring of stages (binary-coded pages: less
# their expanded fp32 tile pair)
ATTN_STAGE_BUDGET = 150 * 1024

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# paged_attention_launch(q, k_pages, v_pages, block_tables, ctx_lens, out,
#                        B, Hkv, Hkv_pool, kv0, rep, hd, page, n_table,
#                        clusters, stages, scale, window, cap, bf16, stream)
_ARGS = [_P] * 6 + [_I] * 10 + [_F, _I, _F, _I, _P]
# paged_attention_quant_launch(q, k_codes, k_alphas, k_betas, v_codes,
#                              v_alphas, v_betas, block_tables, ctx_lens,
#                              out, B, Hkv, Hkv_pool, kv0, rep, hd, page,
#                              n_table, clusters, stages, bits, G, scale,
#                              window, cap, bf16, stream)
_QUANT_ARGS = [_P] * 10 + [_I] * 12 + [_F, _I, _F, _I, _P]


def attention_launch_shape(n_table, page, units, stage_bytes,
                           sms=H100_SMS, budget=ATTN_STAGE_BUDGET):
    """(clusters, stages) of one launch: the table's capacity n_table *
    page in partitions of ATTN_TILE tokens; `units` (sequence, KV head,
    query-head group) triples, each served by a cluster of `clusters`
    blocks (block p takes live partitions p, p + clusters, ...); each
    block stages `stages` partitions of `stage_bytes` (at most
    ATTN_MAX_STAGES, within `budget` bytes), whose loads are in flight
    at once. Clusters: the fewest that let every block keep all its
    partitions in flight, and at least one block an SM; stages: what the
    busiest block takes."""
    parts = -(-n_table * page // ATTN_TILE)
    most = max(1, min(ATTN_MAX_STAGES, budget // stage_bytes))
    clusters = max(1, min(ATTN_MAX_CLUSTER, parts,
                          max(-(-parts // most), -(-sms // units))))
    return clusters, min(most, -(-parts // clusters))


def tile_pair_bytes(hd, elem_bytes):
    """Bytes of one K/V tile pair of ATTN_TILE rows (padded by 16
    bytes): an fp stage, and the fp32 pair binary-coded pages expand
    into."""
    return 2 * ATTN_TILE * (hd * elem_bytes + 16)


def _staged_row(nbytes):
    """Shared-memory stride of a staged piece of `nbytes` a row, as the
    kernel lays it out (csrc `staged_row`): an odd number of 16-byte
    units."""
    units = -(-nbytes // 16)
    return (units + (units + 1) % 2) * 16


def quant_stage_bytes(hd, bits, G):
    """Bytes of one partition's staged binary-coded rows, K and V, as
    the kernel lays them out (csrc `quant_pages`): ATTN_TILE rows of each
    piece of a (token, KV head) row (code words, alphas, betas) at its
    `_staged_row` stride; the scales only when a row's alphas and betas
    take at most ATTN_QUANT_SCALES_MAX bytes."""
    codes, alphas, betas = bits * hd // 8, 4 * G * bits, 4 * G
    row = _staged_row(codes)
    if alphas + betas <= ATTN_QUANT_SCALES_MAX:
        row += _staged_row(alphas) + _staged_row(betas)
    return 2 * ATTN_TILE * row


def _launch_shape(q, block_tables, page, stage_bytes,
                  budget=ATTN_STAGE_BUDGET):
    """attention_launch_shape for this call: its units (the kernel's
    query-head groups hold the power of two >= rep, at most ATTN_MAX_REP
    heads) and the bytes of one stage."""
    B, Hkv, rep, hd = q.shape
    rep_block = min(ATTN_MAX_REP, 1 << (rep - 1).bit_length())
    return attention_launch_shape(
        block_tables.shape[1], page, B * Hkv * -(-rep // rep_block),
        stage_bytes, sm_count(q.device), budget)


def quant_launch_shape(q, block_tables, page, bits, G):
    """The binary-coded launch: stages of the raw rows, within the
    budget less the expanded fp32 tile pair."""
    hd = q.shape[-1]
    return _launch_shape(q, block_tables, page,
                         quant_stage_bytes(hd, bits, G),
                         ATTN_STAGE_BUDGET - tile_pair_bytes(hd, 4))


def _check_options(window, cap, q, pool_heads, kv0):
    if (window is not None and window < 1) or (cap is not None and cap <= 0):
        raise ValueError(f"window={window} / cap={cap}: want window >= 1 "
                         f"and cap > 0 (or None)")
    if kv0 < 0 or kv0 + q.shape[1] > pool_heads:
        raise ValueError(f"kv0={kv0}: q's {q.shape[1]} KV heads must lie "
                         f"within the pool's {pool_heads}")


def _meta_call(name, q, block_tables, page, row_bytes):
    """A call on meta tensors: the kernel's work over every token its
    tables name (a meta tensor holds no context length), `row_bytes` a
    (token, KV head) vector of K or of V; q's shape out empty, nothing
    launched."""
    if block_tables.device != q.device:
        raise ValueError(f"q on meta, block tables on "
                         f"{block_tables.device}: all operands on one "
                         f"device")
    B, Hkv, rep, hd = q.shape
    T = block_tables.shape[1]
    work.report(name, paged_attention_work(
        B * T * page, B, Hkv, rep, hd, T, kv_bytes_per_token_head=row_bytes,
        q_itemsize=q.element_size()))
    return torch.empty_like(q)


def _check_launch(q, block_tables, ctx_lens, tensors,
                  head_dims=HEAD_DIMS):
    """Checks shared by both kernels on the CUDA side; returns
    (B, Hkv, rep, hd)."""
    if q.device.type != "cuda":
        raise ValueError(f"q on {q.device}: the kernel runs on CUDA tensors")
    B, Hkv, rep, hd = q.shape
    if block_tables.dim() != 2 or block_tables.shape[0] != B \
            or tuple(ctx_lens.shape) != (B,):
        raise ValueError(f"block_tables {tuple(block_tables.shape)} / "
                         f"ctx_lens {tuple(ctx_lens.shape)} for batch {B}")
    if hd not in head_dims or rep < 1:
        raise ValueError(f"head_dim {hd} / rep {rep}: the kernel takes "
                         f"head_dim in {head_dims} and rep >= 1")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q dtype {q.dtype}: the kernel takes fp32 or bf16")
    if block_tables.dtype != torch.int32 or ctx_lens.dtype != torch.int32:
        raise TypeError("block_tables and ctx_lens must be int32")
    if not 1 <= block_tables.shape[1] <= MAX_TABLE:
        raise ValueError(f"block tables of {block_tables.shape[1]} pages: "
                         f"the kernel takes 1..{MAX_TABLE}")
    ts = (q, block_tables, ctx_lens, *tensors)
    if any(t.device != q.device for t in ts):
        raise ValueError("all operands must be on q's device")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("all operands must be contiguous")
    return B, Hkv, rep, hd


def _options(hd, window, cap):
    return (hd ** -0.5, -1 if window is None else int(window),
            -1.0 if cap is None else float(cap))


def paged_attention(q, k_pages, v_pages, block_tables, ctx_lens, *,
                    window=None, cap=None, kv0=0):
    _check_options(window, cap, q, k_pages.shape[2], kv0)
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pages, v_pages, block_tables,
                                   ctx_lens, window=window, cap=cap, kv0=kv0)
    if q.device.type == "meta":
        P, page, Hkv, hd = k_pages.shape
        return _meta_call("paged_attention", q, block_tables, page,
                          hd * k_pages.element_size())
    B, Hkv, rep, hd = _check_launch(q, block_tables, ctx_lens,
                                    (k_pages, v_pages))
    P, page, hk, hdk = k_pages.shape
    if hdk != hd or tuple(v_pages.shape) != tuple(k_pages.shape):
        raise ValueError(f"pages {tuple(k_pages.shape)}/"
                         f"{tuple(v_pages.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError(f"q/k/v dtypes {q.dtype}/{k_pages.dtype}/"
                        f"{v_pages.dtype}: one of fp32 or bf16 for all")
    out = torch.empty_like(q)
    fn = build.function("paged_attention", "paged_attention_launch", _ARGS)
    status = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                block_tables.data_ptr(), ctx_lens.data_ptr(), out.data_ptr(),
                B, Hkv, hk, kv0, rep, hd, page, block_tables.shape[1],
                *_launch_shape(q, block_tables, page,
                               tile_pair_bytes(hd, q.element_size())),
                *_options(hd, window, cap), int(q.dtype == torch.bfloat16),
                torch.cuda.current_stream(q.device).cuda_stream)
    build.check(status, "paged_attention")
    LAUNCHES["paged_attention"] += 1
    work.note_launch("paged_attention", (*q.shape, k_pages.shape[0]))
    return out


def paged_attention_quant(q, k_codes, k_alphas, k_betas, v_codes, v_alphas,
                          v_betas, block_tables, ctx_lens, *, window=None,
                          cap=None, kv0=0):
    _check_options(window, cap, q, k_codes.shape[2], kv0)
    if q.device.type == "cpu":
        return paged_attention_quant_ref(
            q, k_codes, k_alphas, k_betas, v_codes, v_alphas, v_betas,
            block_tables, ctx_lens, window=window, cap=cap, kv0=kv0)
    pool = (k_codes, k_alphas, k_betas, v_codes, v_alphas, v_betas)
    if q.device.type == "meta":
        row = sum(t[0, 0, 0].numel() * t.element_size()
                  for t in (k_codes, k_alphas, k_betas))
        return _meta_call("paged_attention_quant", q, block_tables,
                          k_codes.shape[1], row)
    B, Hkv, rep, hd = _check_launch(q, block_tables, ctx_lens, pool,
                                    QUANT_HEAD_DIMS)
    P, page, hk, bits, hdw = k_codes.shape
    G = k_betas.shape[-1]
    if hdw * 32 != hd or hd % G \
            or tuple(k_alphas.shape) != (P, page, hk, G, bits) \
            or tuple(k_betas.shape) != (P, page, hk, G) \
            or any(tuple(v.shape) != tuple(k.shape) for k, v in
                   zip(pool[:3], pool[3:])):
        raise ValueError(
            f"binary-coded pages codes {tuple(k_codes.shape)}, alphas "
            f"{tuple(k_alphas.shape)}, betas {tuple(k_betas.shape)} (and "
            f"the V side's) do not match q {tuple(q.shape)}")
    if not 1 <= bits <= MAX_KV_BITS:
        raise ValueError(f"kv bits {bits}: the kernel takes 1..{MAX_KV_BITS}")
    if k_codes.dtype != torch.int32 or v_codes.dtype != torch.int32 \
            or any(t.dtype != torch.float32 for t in
                   (k_alphas, k_betas, v_alphas, v_betas)):
        raise TypeError("codes must be int32 words and alphas/betas fp32")
    out = torch.empty_like(q)
    fn = build.function("paged_attention", "paged_attention_quant_launch",
                        _QUANT_ARGS)
    status = fn(q.data_ptr(), *(t.data_ptr() for t in pool),
                block_tables.data_ptr(), ctx_lens.data_ptr(), out.data_ptr(),
                B, Hkv, hk, kv0, rep, hd, page, block_tables.shape[1],
                *quant_launch_shape(q, block_tables, page, bits, G), bits, G,
                *_options(hd, window, cap), int(q.dtype == torch.bfloat16),
                torch.cuda.current_stream(q.device).cuda_stream)
    build.check(status, "paged_attention_quant")
    LAUNCHES["paged_attention_quant"] += 1
    work.note_launch("paged_attention_quant", (*q.shape, k_codes.shape[0]))
    return out
