"""Multi-head Latent Attention (MiniCPM3 / DeepSeek-V2 style; the
reference's `models/mla.py`).

K/V are compressed to a per-position latent c_kv (kv_lora_rank) plus a
rotary key k_pe (qk_rope_head_dim) shared by all heads; the caches hold
only (latent, k_pe). Every attention step expands the context's latents
through `wkv_b` into per-head K_nope and V, as the reference writes it
(a packed `wkv_b` runs the BCQ GEMM over every context row).

Shapes: activations (B, S, D); dense cache {"c_kv": (B, S, r),
"k_pe": (B, S, dr)}; latent page pool {"ckv_pages": (P, page, 1, r),
"kpe_pages": (P, page, 1, dr)}. The singleton axis keeps the leaves
shaped like attention pools ((pages, page, heads, vec)), so
`is_page_leaf`, `copy_pages` and `compact` treat them identically.
Caches are written in place.

On a model axis a rank holds its heads' wq_b, wkv_b and wo rows and the
whole latent. A dense engine's latent cache is split along the sequence
(the rule's `c_kv`/`k_pe` placement, models/attention.py:seq_block):
decode then all-gathers every head's query, expands the rank's own
positions through every head's wkv_b ("wkv_b_all", which the engine
gathers once), and merges the heads' partial softmax states over the
model group (attention.py:merge_partials), each rank keeping its heads.
"""
from __future__ import annotations

import torch

from repro_torch.dist.context import gather_model, model_coords
from repro_torch.hw import torch_dtype
from repro_torch.models import attention as attn_mod
from repro_torch.models.layers import init_linear, linear, rmsnorm, rope, softcap

NEG_INF = -1e30


def init_mla(cfg, gen, dtype, device):
    m = cfg.mla
    d, H = cfg.d_model, cfg.n_heads
    qk_hd = m.qk_nope_head_dim + m.qk_rope_head_dim
    dt = torch_dtype(dtype)
    return {
        "wq_a": init_linear(gen, d, m.q_lora_rank, dtype, device),
        "q_a_norm": torch.zeros((m.q_lora_rank,), dtype=dt, device=device),
        "wq_b": init_linear(gen, m.q_lora_rank, H * qk_hd, dtype, device),
        "wkv_a": init_linear(gen, d, m.kv_lora_rank + m.qk_rope_head_dim,
                             dtype, device),
        "kv_a_norm": torch.zeros((m.kv_lora_rank,), dtype=dt, device=device),
        "wkv_b": init_linear(gen, m.kv_lora_rank,
                             H * (m.qk_nope_head_dim + m.v_head_dim), dtype,
                             device),
        "wo": init_linear(gen, H * m.v_head_dim, d, dtype, device),
    }


def _queries(cfg, p, x, positions):
    """x (B, S, D) -> q_nope (B, S, H, dn), q_pe (B, S, H, dr) roped."""
    m = cfg.mla
    B, S, _ = x.shape
    qa = rmsnorm(linear(x, p["wq_a"]), p["q_a_norm"], cfg.norm_eps)
    q = linear(qa, p["wq_b"]).reshape(
        B, S, cfg.n_heads, m.qk_nope_head_dim + m.qk_rope_head_dim)
    q_nope, q_pe = torch.split(q, [m.qk_nope_head_dim, m.qk_rope_head_dim],
                               dim=-1)
    return q_nope, rope(q_pe, positions, cfg.rope_theta)


def _latent(cfg, p, x, positions):
    """x (B, S, D) -> c_kv (B, S, r) normed, k_pe (B, S, dr) roped."""
    m = cfg.mla
    kv = linear(x, p["wkv_a"])
    c_kv, k_pe = torch.split(kv, [m.kv_lora_rank, m.qk_rope_head_dim],
                             dim=-1)
    c_kv = rmsnorm(c_kv, p["kv_a_norm"], cfg.norm_eps)
    return c_kv, rope(k_pe, positions, cfg.rope_theta)


def _expand_kv(cfg, p, c_kv):
    """Latents (B, S, r) -> k_nope (B, S, H, dn), v (B, S, H, dv)."""
    m = cfg.mla
    B, S, _ = c_kv.shape
    kvb = linear(c_kv, p["wkv_b"]).reshape(
        B, S, cfg.n_heads, m.qk_nope_head_dim + m.v_head_dim)
    return torch.split(kvb, [m.qk_nope_head_dim, m.v_head_dim], dim=-1)


def _scale(cfg) -> float:
    m = cfg.mla
    return (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5


def mla_prefill(cfg, spec, p, x, positions):
    """Full-sequence MLA: (y, c_kv, k_pe), the latents a prefill caches.
    Scores go through the shared dense or chunked attention with the
    concatenation identity [q_nope||q_pe].[k_nope||k_pe] = q_nope.k_nope
    + q_pe.k_pe (k_pe broadcast across heads)."""
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.n_heads
    q_nope, q_pe = _queries(cfg, p, x, positions)
    c_kv, k_pe = _latent(cfg, p, x, positions)
    k_nope, v = _expand_kv(cfg, p, c_kv)
    q_cat = torch.cat([q_nope, q_pe], dim=-1)            # (B,S,H,dn+dr)
    k_cat = torch.cat([k_nope, k_pe[:, :, None, :].expand(
        B, S, H, m.qk_rope_head_dim)], dim=-1)
    fn = (attn_mod._attend_chunked if S > attn_mod.CHUNKED_THRESHOLD
          else attn_mod._attend_dense)
    out = fn(q_cat, k_cat, v, causal=cfg.causal, window=spec.window,
             cap=cfg.attn_softcap, scale=_scale(cfg))    # (B,S,H,dv)
    y = linear(out.reshape(B, S, H * m.v_head_dim), p["wo"])
    return y, c_kv, k_pe


def mla_forward(cfg, spec, p, x, positions):
    """Full-sequence MLA layer core (no residual or norm)."""
    return mla_prefill(cfg, spec, p, x, positions)[0]


def init_mla_cache(cfg, batch, max_len, dtype, device, spec=None):
    """The dense latent cache of one layer: this rank's block of max_len
    positions (attention.py:seq_block)."""
    m = cfg.mla
    dt = torch_dtype(dtype)
    S = (attn_mod.seq_block(cfg, spec, max_len)[1] if spec is not None
         else max_len)
    return {"c_kv": torch.zeros((batch, S, m.kv_lora_rank), dtype=dt,
                                device=device),
            "k_pe": torch.zeros((batch, S, m.qk_rope_head_dim),
                                dtype=dt, device=device)}


def init_mla_paged(cfg, n_pages, page_size, dtype, device):
    """Latent page pool of one MLA layer: page_size * (kv_lora_rank +
    qk_rope_head_dim) elements a page, not 2 * page_size * Hkv * hd."""
    m = cfg.mla
    dt = torch_dtype(dtype)
    return {"ckv_pages": torch.zeros((n_pages, page_size, 1,
                                      m.kv_lora_rank), dtype=dt,
                                     device=device),
            "kpe_pages": torch.zeros((n_pages, page_size, 1,
                                      m.qk_rope_head_dim), dtype=dt,
                                     device=device)}


def _paged_latent_views(cache, block_tables):
    """Gather a sequence's latent pages into dense (B, T*page, .) views."""
    bt = block_tables.long()
    B, T = bt.shape
    page = cache["ckv_pages"].shape[1]
    c_kv = cache["ckv_pages"][bt].reshape(B, T * page, -1)
    k_pe = cache["kpe_pages"][bt].reshape(B, T * page, -1)
    return c_kv, k_pe


def _mla_attend(cfg, p, q_nope, q_pe, c_kv, k_pe, ok):
    """Masked-softmax MLA attention over a dense latent view: expand the
    latents to K/V, score the nope and rope parts, mask with `ok`
    (broadcastable to (B, 1, Sq, Skv)). Returns (B, Sq, D)."""
    m = cfg.mla
    B, Sq = q_nope.shape[:2]
    k_nope, v = _expand_kv(cfg, p, c_kv.to(q_nope.dtype))
    logits = (torch.einsum("bqhd,bkhd->bhqk", q_nope, k_nope)
              + torch.einsum("bqhd,bkd->bhqk", q_pe,
                             k_pe.to(q_nope.dtype)))
    logits = softcap(logits.float() * _scale(cfg), cfg.attn_softcap)
    logits = torch.where(ok, logits, torch.full_like(logits, NEG_INF))
    w = torch.softmax(logits, dim=-1).to(q_nope.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", w, v)
    return linear(out.reshape(B, Sq, cfg.n_heads * m.v_head_dim), p["wo"])


def mla_decode(cfg, spec, p, x, cache, pos):
    """Single-token decode against the dense latent cache: the new
    (c_kv, k_pe) land at row pos, then the token attends over rows
    0..pos. x (B, 1, D); pos (B,). Returns (y, cache)."""
    B = x.shape[0]
    posl = pos.long()
    q_nope, q_pe = _queries(cfg, p, x, posl[:, None])    # (B,1,H,.)
    c_new, kpe_new = _latent(cfg, p, x, posl[:, None])   # (B,1,.)
    b_idx = torch.arange(B, device=x.device)
    start, S, split = attn_mod.seq_block(
        cfg, spec, getattr(cfg, "dense_len", 0) or cache["c_kv"].shape[1])
    row = posl - start
    held = ((row >= 0) & (row < S))[:, None]
    row = row.clamp(0, S - 1)
    for name, new in (("c_kv", c_new), ("k_pe", kpe_new)):
        c = cache[name]
        # on a split cache the row's rank writes, the others rewrite
        c[b_idx, row] = torch.where(held, new[:, 0].to(c.dtype),
                                    c[b_idx, row])
    ok = (start + torch.arange(S, device=x.device)[None, :]
          <= posl[:, None])[:, None, None, :]
    if split:
        y = _mla_attend_split(cfg, p, q_nope, q_pe, cache["c_kv"],
                              cache["k_pe"], ok[:, :, 0])
    else:
        y = _mla_attend(cfg, p, q_nope, q_pe, cache["c_kv"], cache["k_pe"],
                        ok)
    return y, cache


def _mla_attend_split(cfg, p, q_nope, q_pe, c_kv, k_pe, ok):
    """One token's MLA attention over a latent cache split along the
    sequence: every head's query (gathered over the model group) scores
    this rank's positions, expanded through every head's wkv_b
    (p["wkv_b_all"]); the partial softmax states merge over the model
    group and this rank keeps its heads. q_nope/q_pe (B, 1, H, .) this
    rank's heads; c_kv/k_pe (B, S, .) its positions; ok (B, 1, S).
    Returns (B, 1, D)."""
    m = cfg.mla
    B, _, H, dn = q_nope.shape
    qa = gather_model(torch.cat([q_nope, q_pe], dim=-1)[:, 0].contiguous(),
                      dim=1)                             # (B, M*H, dn+dr)
    qa_nope, qa_pe = torch.split(qa, [dn, m.qk_rope_head_dim], dim=-1)
    S = c_kv.shape[1]
    kvb = linear(c_kv.to(q_nope.dtype), p["wkv_b_all"]).reshape(
        B, S, qa.shape[1], dn + m.v_head_dim)
    k_nope, v = torch.split(kvb, [dn, m.v_head_dim], dim=-1)
    logits = (torch.einsum("bhd,bkhd->bhk", qa_nope, k_nope)
              + torch.einsum("bhd,bkd->bhk", qa_pe, k_pe.to(q_nope.dtype)))
    logits = softcap(logits.float() * _scale(cfg), cfg.attn_softcap)
    logits = torch.where(ok, logits, torch.full_like(logits, NEG_INF))
    mx, w, total = attn_mod.local_softmax(logits)
    acc = torch.einsum("bhk,bkhd->bhd", w, v.float())
    out = attn_mod.merge_partials(mx, total, acc)        # (B, M*H, dv)
    h0 = model_coords()[0] * H
    out = out[:, h0:h0 + H].to(q_nope.dtype)
    return linear(out.reshape(B, 1, H * m.v_head_dim), p["wo"])


def mla_decode_paged(cfg, spec, p, x, cache, block_tables, pos):
    """Single-token decode against a latent page pool: the new (c_kv,
    k_pe) are written into page block_tables[b, pos // page] at offset
    pos % page, then the token attends over its gathered latent pages.
    The block-table, copy-on-write and null-page contract is
    attn_decode_paged's. Returns (y, cache)."""
    B = x.shape[0]
    posl = pos.long()
    q_nope, q_pe = _queries(cfg, p, x, posl[:, None])
    c_new, kpe_new = _latent(cfg, p, x, posl[:, None])
    ckv, kpe = cache["ckv_pages"], cache["kpe_pages"]
    page = ckv.shape[1]
    pid = block_tables.long()[torch.arange(B, device=x.device), posl // page]
    off = posl % page
    ckv[pid, off, 0] = c_new[:, 0].to(ckv.dtype)
    kpe[pid, off, 0] = kpe_new[:, 0].to(kpe.dtype)
    c_kv, k_pe = _paged_latent_views(cache, block_tables)
    S = c_kv.shape[1]
    ok = (torch.arange(S, device=x.device)[None, :]
          <= posl[:, None])[:, None, None, :]
    y = _mla_attend(cfg, p, q_nope, q_pe, c_kv, k_pe, ok)
    return y, cache


def mla_extend_paged(cfg, spec, p, h, cache, block_tables, start_pos,
                     chunk_mask):
    """Chunked-prefill / verify step: C tokens at start_pos + [0..C)
    write their latents into the sequence's pages (padding rows rewrite
    the null page's slot 0 with its own content) and attend causally
    over pages + chunk. Mirrors attn_extend_paged. Returns (y, cache)."""
    B, C, _ = h.shape
    positions = start_pos.long()[:, None] + torch.arange(C, device=h.device)
    q_nope, q_pe = _queries(cfg, p, h, positions)        # (B,C,H,.)
    c_new, kpe_new = _latent(cfg, p, h, positions)       # (B,C,.)
    ckv, kpe = cache["ckv_pages"], cache["kpe_pages"]
    page = ckv.shape[1]
    bt = block_tables.long()
    T = bt.shape[1]
    # padding positions may lie past the table: clamp, then send to page 0
    pid = torch.gather(bt, 1, (positions // page).clamp(max=T - 1))
    pid = torch.where(chunk_mask, pid, 0)
    off = torch.where(chunk_mask, positions % page, 0)
    m3 = chunk_mask[:, :, None]
    ckv[pid, off, 0] = torch.where(m3, c_new.to(ckv.dtype), ckv[0, 0, 0])
    kpe[pid, off, 0] = torch.where(m3, kpe_new.to(kpe.dtype), kpe[0, 0, 0])
    c_kv, k_pe = _paged_latent_views(cache, block_tables)
    S = c_kv.shape[1]
    ok = (torch.arange(S, device=h.device)[None, None, :]
          <= positions[:, :, None])[:, None]
    y = _mla_attend(cfg, p, q_nope, q_pe, c_kv, k_pe, ok)
    return y, cache
