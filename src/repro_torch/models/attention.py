"""Attention (the reference's `models/attention.py`): GQA with optional
qk-norm / sliding window / softcap, a dense and a chunked
("flash-style") full-sequence path for prefill, and single-token decode
against a dense KV cache or a paged KV pool of fp or binary-coded pages.

Shapes: activations (B, S, D); q/k/v (B, S, H, hd); dense caches
(B, Hkv, S, hd); fp page pools (P, page, Hkv, hd); binary-coded pools
(quant/kv.py) codes (P, page, Hkv, bits, hd/32), alphas (P, page, Hkv,
G, bits), betas (P, page, Hkv, G) per side. Caches are updated in place
(the reference's functional update plus donation becomes a direct
write, which keeps one copy of the pool in memory).

On a model axis (models/model.py:shard_config) a rank holds its query
heads. Where the axis divides the KV heads it holds theirs too; where
it does not, its wk and wv are whole, it computes and caches every KV
head (the rule replicates the pool), and its query heads, which lie in
one GQA group, read that group's KV head (`kv_heads`). A training rank's
query heads may straddle groups (shard_config(train=True)): the
full-sequence path then reads one KV head a query head (`_rank_kv`). A dense cache of
such a rank (and MLA's latent cache on any model axis) is split along
the sequence instead when the axis divides its length (`seq_block`):
decode then all-gathers every head's query over the model group, each
rank attends every head over its own positions, and the partial
softmax states are merged with a log-sum-exp rescale
(`merge_partials`), each rank keeping its heads.
"""
from __future__ import annotations

import torch

from repro_torch.dist.context import gather_model, model_coords
from repro_torch.hw import torch_dtype
from repro_torch.kernels.paged_attention import (paged_attention,
                                                 paged_attention_quant)
from repro_torch.models.layers import init_linear, linear, rmsnorm, rope, softcap
from repro_torch.quant.kv import (kv_bytes_per_token_head, kv_dequantize,
                                  kv_layout, kv_quantize)

NEG_INF = -1e30
# full-sequence attention switches to the chunked path above this length
CHUNKED_THRESHOLD = 2048
KV_CHUNK = 1024


def init_attn(cfg, gen, dtype, device):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    p = {
        "wq": init_linear(gen, d, cfg.n_heads * hd, dtype, device),
        "wk": init_linear(gen, d, cfg.n_kv_heads * hd, dtype, device),
        "wv": init_linear(gen, d, cfg.n_kv_heads * hd, dtype, device),
        "wo": init_linear(gen, cfg.n_heads * hd, d, dtype, device),
    }
    if cfg.qk_norm:
        p["qn"] = torch.zeros((hd,), dtype=torch_dtype(dtype), device=device)
        p["kn"] = torch.zeros((hd,), dtype=torch_dtype(dtype), device=device)
    return p


def kv_heads(cfg) -> tuple:
    """(first, count) of the cfg.n_kv_heads KV heads (those wk and wv
    compute and the cache holds) that this rank's query heads read: all
    of them, or on a rank whose wk and wv are whole (cfg.kv_whole) those
    of its query heads' GQA groups (one, but where a training rank's
    heads straddle groups)."""
    if not getattr(cfg, "kv_whole", False):
        return 0, cfg.n_kv_heads
    m, H = model_coords()[0], cfg.n_heads
    rep = H * cfg.model_axis // cfg.n_kv_heads
    first = m * H // rep
    return first, ((m + 1) * H - 1) // rep - first + 1


def _rank_kv(cfg, k, v):
    """The K/V heads (B, S, Hkv, hd) that this rank's query heads read, in
    the grouped form of `_group_q`: kv_heads' block, or, where a rank's
    query heads straddle GQA groups, one KV head a query head (rep 1)."""
    lo, n = kv_heads(cfg)
    k, v = k[:, :, lo:lo + n], v[:, :, lo:lo + n]
    if n == 1 or not getattr(cfg, "kv_whole", False):
        return k, v
    H = cfg.n_heads
    rep = H * cfg.model_axis // cfg.n_kv_heads
    idx = (model_coords()[0] * H + torch.arange(H, device=k.device)) // rep
    return k[:, :, idx - lo], v[:, :, idx - lo]


def seq_block(cfg, spec, max_len) -> tuple:
    """(first position, positions, split) of the block of a layer's dense
    cache (max_len positions, a window's fewer) that this rank holds:
    the whole, or where the rule splits the sequence over the model axis
    (MLA's latents; k/v of a rank with whole wk/wv) and the axis divides
    the length, its 1/M. Only a dense engine's config (cfg.dense_len)
    splits."""
    S = max_len if spec.window is None else min(max_len, spec.window)
    M = getattr(cfg, "model_axis", 1)
    if (M == 1 or not getattr(cfg, "dense_len", 0) or S % M
            or (cfg.mla is None and not cfg.kv_whole)):
        return 0, S, False
    return model_coords()[0] * (S // M), S // M, True


def merge_partials(mx, l, acc):
    """The softmax states of this rank's block of positions, max and sum
    (...) and the fp32 accumulator (..., dv), merged with every model
    rank's (all-gathered over the model group, then rescaled to the
    largest max): the attention output (..., dv) fp32. A rank whose
    positions are all masked adds nothing."""
    packed = torch.cat([mx[..., None], l[..., None], acc], dim=-1)
    parts = gather_model(packed[None].contiguous(), dim=0)
    top = parts[..., 0].amax(dim=0)
    w = torch.exp(parts[..., 0] - top)
    total = (parts[..., 1] * w).sum(dim=0)
    out = (parts[..., 2:] * w[..., None]).sum(dim=0)
    return out / torch.clamp(total, min=1e-30)[..., None]


def local_softmax(logits):
    """Masked fp32 logits (..., S) -> (max, the unnormalised weights,
    their sum): a block's share of a softmax, for merge_partials."""
    mx = torch.amax(logits, dim=-1)
    p = torch.exp(logits - mx[..., None])
    return mx, p, torch.sum(p, dim=-1)


def _project_qkv(cfg, p, x):
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    q = linear(x, p["wq"]).reshape(B, S, cfg.n_heads, hd)
    k = linear(x, p["wk"]).reshape(B, S, cfg.n_kv_heads, hd)
    v = linear(x, p["wv"]).reshape(B, S, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p["qn"], cfg.norm_eps)
        k = rmsnorm(k, p["kn"], cfg.norm_eps)
    return q, k, v


def _group_q(q, n_kv):
    """(B, S, H, d) -> (B, S, Hkv, rep, d): GQA in grouped form, K/V are
    never repeated to H heads."""
    B, S, H, d = q.shape
    return q.reshape(B, S, n_kv, H // n_kv, d)


def _mask_bias(sq, skv, *, causal, window, q_offset=0, device=None):
    """(sq, skv) additive fp32 bias. q position i attends kv position j
    iff (not causal or j <= i+q_offset) and (window is None or
    i+q_offset-j < window)."""
    qi = torch.arange(sq, device=device)[:, None] + q_offset
    kj = torch.arange(skv, device=device)[None, :]
    ok = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        ok &= kj <= qi
    if window is not None:
        ok &= (qi - kj) < window
    return torch.where(ok, 0.0, NEG_INF).to(torch.float32)


def _attend_dense(q, k, v, *, causal, window, cap, scale):
    """Direct S x S attention (prefill / oracle), grouped GQA."""
    B, Sq, H, hd = q.shape
    dv = v.shape[-1]
    qg = _group_q(q, k.shape[2])                         # (B,Sq,Hkv,r,d)
    logits = torch.einsum("bqhrd,bkhd->bhrqk", qg, k).float() * scale
    logits = softcap(logits, cap)
    logits = logits + _mask_bias(Sq, k.shape[1], causal=causal,
                                 window=window, device=q.device)
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bhrqk,bkhd->bqhrd", w, v)
    return out.reshape(B, Sq, H, dv)


def _attend_chunked(q, k, v, *, causal, window, cap, scale):
    """Flash-style streaming over KV chunks: O(S * KV_CHUNK) live memory
    instead of O(S^2), with a running (max, denom, acc)."""
    B, Sq, H, hd = q.shape
    Skv, hkv = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    rep = H // hkv
    qg = _group_q(q, hkv)                                # (B,Sq,Hkv,r,d)
    qi = torch.arange(Sq, device=q.device)[:, None]
    m = torch.full((B, hkv, rep, Sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, hkv, rep, Sq, dv), dtype=torch.float32,
                      device=q.device)
    for c0 in range(0, Skv, KV_CHUNK):
        kb, vb = k[:, c0:c0 + KV_CHUNK], v[:, c0:c0 + KV_CHUNK]
        logits = torch.einsum("bqhrd,bkhd->bhrqk", qg, kb).float() * scale
        logits = softcap(logits, cap)
        kj = c0 + torch.arange(kb.shape[1], device=q.device)[None, :]
        ok = torch.ones((Sq, kb.shape[1]), dtype=torch.bool, device=q.device)
        if causal:
            ok &= kj <= qi
        if window is not None:
            ok &= (qi - kj) < window
        logits = torch.where(ok, logits, torch.full_like(logits, NEG_INF))
        bm = torch.maximum(m, torch.amax(logits, dim=-1))
        r = torch.exp(m - bm)
        p = torch.exp(logits - bm[..., None])
        l = l * r + torch.sum(p, dim=-1)
        acc = acc * r[..., None] + torch.einsum(
            "bhrqk,bkhd->bhrqd", p.to(q.dtype), vb).float()
        m = bm
    out = acc / torch.clamp(l, min=1e-30)[..., None]     # (B,hkv,r,Sq,dv)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, dv).to(q.dtype)


def _attend_sequence(cfg, spec, p, x, positions):
    """Full-sequence attention layer core: (y, k, v) with k roped, so a
    prefill keeps the K/V it already projected (the reference projects
    twice and leaves the duplicate to XLA; eager PyTorch would pay it)."""
    q, k, v = _project_qkv(cfg, p, x)
    hd = cfg.resolved_head_dim
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    fn = _attend_chunked if x.shape[1] > CHUNKED_THRESHOLD else _attend_dense
    kr, vr = _rank_kv(cfg, k, v)
    out = fn(q, kr, vr, causal=cfg.causal, window=spec.window,
             cap=cfg.attn_softcap, scale=hd ** -0.5)
    y = linear(out.reshape(*x.shape[:2], cfg.n_heads * hd), p["wo"])
    return y, k, v


def attn_forward(cfg, spec, p, x, positions):
    """Full-sequence attention layer core (no residual/norm)."""
    return _attend_sequence(cfg, spec, p, x, positions)[0]


# --------------------------------------------------------------------------
# decode (single new token)
# --------------------------------------------------------------------------

def init_kv_cache(cfg, spec, batch, max_len, dtype, device):
    """Dense K/V of one layer: (batch, Hkv, S, hd), S this rank's block
    of max_len positions (or of the window's rolling buffer)."""
    hd = cfg.resolved_head_dim
    S = seq_block(cfg, spec, max_len)[1]
    shape = (batch, cfg.n_kv_heads, S, hd)
    dt = torch_dtype(dtype)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def init_paged_kv(cfg, n_pages, page_size, dtype, device, kv_bits=0,
                  kv_group_size=0):
    """Global page pool for one attention layer; page 0 is the
    allocator's null page. With `kv_bits > 0` pages store binary-coded
    K/V (quant/kv.py): sign words packed along head_dim plus per-(token,
    head, group) alphas and betas, quantized on write and expanded
    inside the attention kernel. The "k_codes" leaf selects that path
    downstream."""
    hd = cfg.resolved_head_dim
    lead = (n_pages, page_size, cfg.n_kv_heads)
    if not kv_bits:
        dt = torch_dtype(dtype)
        return {"k_pages": torch.zeros(lead + (hd,), dtype=dt, device=device),
                "v_pages": torch.zeros(lead + (hd,), dtype=dt, device=device)}
    G, hdw = kv_layout(hd, kv_bits, kv_group_size)
    pool = {}
    for side in ("k", "v"):
        pool[f"{side}_codes"] = torch.zeros(lead + (kv_bits, hdw),
                                            dtype=torch.int32, device=device)
        pool[f"{side}_alphas"] = torch.zeros(lead + (G, kv_bits),
                                             dtype=torch.float32,
                                             device=device)
        pool[f"{side}_betas"] = torch.zeros(lead + (G,), dtype=torch.float32,
                                            device=device)
    return pool


def paged_kv_page_bytes(cfg, page_size, dtype, kv_bits=0,
                        kv_group_size=0) -> int:
    """Device bytes one page id costs across the whole model: every
    attention layer holds a K and a V page of `page_size` tokens per KV
    head (codes and scales when binary-coded); an MLA layer one latent
    page, kv_lora_rank + qk_rope_head_dim values a token with no head
    factor and no separate V."""
    itemsize = torch_dtype(dtype or cfg.dtype).itemsize
    n_attn = sum(1 for s in cfg.layer_specs() if s.kind == "attn")
    if cfg.mla is not None:
        m = cfg.mla
        return (page_size * (m.kv_lora_rank + m.qk_rope_head_dim)
                * itemsize * n_attn)
    per_vec = kv_bytes_per_token_head(cfg.resolved_head_dim, kv_bits,
                                      kv_group_size, itemsize)
    return 2 * page_size * cfg.n_kv_heads * per_vec * n_attn


def paged_kv_bits(cache) -> int:
    """kv_bits of a paged layer cache (0 = fp pages); the layout
    describes itself through its leaves' shapes."""
    return cache["k_codes"].shape[-2] if "k_codes" in cache else 0


def _quant_scatter(cache, new, pid, off, mask=None):
    """Quantize-on-write: binary-code the new K and V vectors `new`
    (2, ..., hd) — both sides in one call — and write codes and scales
    into the pool at (pid, off), in place. With `mask` (new's dims
    between the side axis and the vector), False rows write the null
    page's slot-0 content instead (the extend path's padding: they land
    on page 0, slot 0, so the write is a no-op however many hit it)."""
    bits = cache["k_codes"].shape[-2]
    G = cache["k_betas"].shape[-1]
    vals = kv_quantize(new, bits, new.shape[-1] // G)
    for side, i in (("k", 0), ("v", 1)):
        for suffix, val in zip(("codes", "alphas", "betas"), vals):
            pool = cache[f"{side}_{suffix}"]
            val = val[i]
            if mask is not None:
                m = mask.reshape(mask.shape + (1,) * (val.dim() - mask.dim()))
                val = torch.where(m, val, pool[0, 0])
            pool[pid, off] = val
    return cache


def _gather_dequant(cache, side, block_tables, hd, heads):
    """Gather and expand the KV heads `heads` (a slice) of a sequence's
    binary-coded pages: (B, T*page, heads, hd) fp32, the extend path's
    dense view."""
    bt = block_tables.long()
    B, T = bt.shape
    codes, alphas, betas = (cache[f"{side}_{f}"][:, :, heads]
                            for f in ("codes", "alphas", "betas"))
    x = kv_dequantize(codes[bt], alphas[bt], betas[bt])
    return x.reshape(B, T * codes.shape[1], codes.shape[2], hd)


def attn_decode_paged(cfg, spec, p, x, cache, block_tables, pos):
    """Single-token decode against a paged KV pool.

    x: (B, 1, D); cache {"k_pages","v_pages"} (P, page, Hkv, hd) — or
    the binary-coded layout {"k_codes","k_alphas","k_betas","v_..."}
    (init_paged_kv(kv_bits=...)), where the new token's K/V is quantized
    before the scatter and the kernel expands the pages inside its
    loop; block_tables (B, T) int32; pos (B,) absolute positions. The
    new token's K/V is written into page block_tables[b, pos // page]
    at offset pos % page BEFORE attention reads it, and the sequence
    then attends over ctx = pos + 1 tokens. Returns (y, cache)."""
    B = x.shape[0]
    hd = cfg.resolved_head_dim
    q, k, v = _project_qkv(cfg, p, x)                    # (B,1,H,hd)
    q = rope(q, pos[:, None], cfg.rope_theta)
    k = rope(k, pos[:, None], cfg.rope_theta)

    quant = paged_kv_bits(cache) > 0
    page = (cache["k_codes"] if quant else cache["k_pages"]).shape[1]
    posl = pos.long()
    pid = block_tables.long()[torch.arange(B, device=x.device), posl // page]
    off = posl % page
    if quant:
        _quant_scatter(cache, torch.stack([k[:, 0], v[:, 0]]), pid, off)
    else:
        kp, vp = cache["k_pages"], cache["v_pages"]
        kp[pid, off] = k[:, 0].to(kp.dtype)
        vp[pid, off] = v[:, 0].to(vp.dtype)

    lo, n = kv_heads(cfg)
    qg = q[:, 0].reshape(B, n, cfg.n_heads // n, hd).contiguous()
    ctx = (pos + 1).to(torch.int32)
    bt = block_tables.to(torch.int32).contiguous()
    if quant:
        out = paged_attention_quant(
            qg, cache["k_codes"], cache["k_alphas"], cache["k_betas"],
            cache["v_codes"], cache["v_alphas"], cache["v_betas"], bt, ctx,
            window=spec.window, cap=cfg.attn_softcap, kv0=lo)
    else:
        out = paged_attention(qg, cache["k_pages"], cache["v_pages"], bt,
                              ctx, window=spec.window, cap=cfg.attn_softcap,
                              kv0=lo)
    y = linear(out.reshape(B, 1, cfg.n_heads * hd), p["wo"])
    return y, cache


def attn_extend_paged(cfg, spec, p, h, cache, block_tables, start_pos,
                      chunk_mask):
    """Chunked-prefill step: C prompt tokens at absolute positions
    start_pos + [0..C) attend causally over everything already in the
    sequence's pages plus themselves. h (B, C, D); block_tables (B, T);
    start_pos (B,); chunk_mask (B, C) bool, False for padding tokens,
    whose K/V must not land in a page: they re-write the null page's
    slot 0 with its own content. The chunk's K/V is written first (on a
    binary-coded pool, quantized), then every query attends over the
    gathered pages (expanded from their codes), with window and cap, in
    plain PyTorch as the reference writes it in jnp. Returns (y, cache)."""
    B, C, _ = h.shape
    hd = cfg.resolved_head_dim
    q, k, v = _project_qkv(cfg, p, h)                    # (B,C,H,hd)
    positions = start_pos.long()[:, None] + torch.arange(C, device=h.device)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)

    quant = paged_kv_bits(cache) > 0
    page = (cache["k_codes"] if quant else cache["k_pages"]).shape[1]
    bt = block_tables.long()
    T = bt.shape[1]
    # padding positions may lie past the table: clamp, then send to page 0
    pid = torch.gather(bt, 1, (positions // page).clamp(max=T - 1))
    pid = torch.where(chunk_mask, pid, 0)
    off = torch.where(chunk_mask, positions % page, 0)
    lo, n = kv_heads(cfg)
    heads = slice(lo, lo + n)
    if quant:
        _quant_scatter(cache, torch.stack([k, v]), pid, off, mask=chunk_mask)
        ck = _gather_dequant(cache, "k", bt, hd, heads)
        cv = _gather_dequant(cache, "v", bt, hd, heads)
    else:
        m4 = chunk_mask[:, :, None, None]
        kp, vp = cache["k_pages"], cache["v_pages"]
        kp[pid, off] = torch.where(m4, k.to(kp.dtype), kp[0, 0])
        vp[pid, off] = torch.where(m4, v.to(vp.dtype), vp[0, 0])
        ck = kp[:, :, heads][bt].reshape(B, T * page, n, hd)
        cv = vp[:, :, heads][bt].reshape(B, T * page, n, hd)
    qg = _group_q(q, n)                                  # (B,C,Hkv,r,hd)
    logits = torch.einsum("bqhrd,bkhd->bhrqk", qg,
                          ck.to(q.dtype)).float() * hd ** -0.5
    logits = softcap(logits, cfg.attn_softcap)
    j = torch.arange(T * page, device=h.device)[None, None, :]
    qi = positions[:, :, None]                           # (B, C, 1)
    ok = j <= qi
    if spec.window is not None:
        ok &= (qi - j) < spec.window
    logits = torch.where(ok[:, None, None], logits,
                         torch.full_like(logits, NEG_INF))
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bhrqk,bkhd->bqhrd", w, cv.to(q.dtype))
    y = linear(out.reshape(B, C, cfg.n_heads * hd), p["wo"])
    return y, cache


def attn_decode(cfg, spec, p, x, cache, pos):
    """x: (B, 1, D); pos: (B,) absolute positions; dense cache
    {"k","v"} (B, Hkv, S, hd) updated in place. Sliding-window layers use
    a rolling buffer indexed by pos % window. A cache split along the
    sequence (seq_block) takes the new K/V on the rank whose block holds
    its slot, and the token attends over every rank's block
    (merge_partials). Returns (y, cache)."""
    B = x.shape[0]
    hd = cfg.resolved_head_dim
    q, k, v = _project_qkv(cfg, p, x)                    # (B,1,H,hd)
    q = rope(q, pos[:, None], cfg.rope_theta)
    k = rope(k, pos[:, None], cfg.rope_theta)

    ck, cv = cache["k"], cache["v"]
    start, S, split = seq_block(cfg, spec, getattr(cfg, "dense_len", 0)
                                or ck.shape[2])
    posl = pos.long()
    slot = (posl if spec.window is None else posl % spec.window) - start
    b_idx = torch.arange(B, device=x.device)
    if split:
        # the slot's rank writes; the others rewrite what they hold
        held = ((slot >= 0) & (slot < S))[:, None, None]
        slot = slot.clamp(0, S - 1)
        k_new = torch.where(held, k[:, 0].to(ck.dtype), ck[b_idx, :, slot])
        v_new = torch.where(held, v[:, 0].to(cv.dtype), cv[b_idx, :, slot])
    else:
        k_new, v_new = k[:, 0].to(ck.dtype), v[:, 0].to(cv.dtype)
    ck[b_idx, :, slot] = k_new
    cv[b_idx, :, slot] = v_new

    j = start + torch.arange(S, device=x.device)[None, :]
    if spec.window is None:
        ok = j <= posl[:, None]
    else:
        ok = j < torch.clamp(posl[:, None] + 1, max=spec.window)
    if split:
        # every head's query over this rank's positions, then the merge
        H = cfg.n_heads
        qa = gather_model(q[:, 0].contiguous(), dim=1)   # (B, M*H, hd)
        qg = qa.reshape(B, cfg.n_kv_heads, -1, hd)
        logits = torch.einsum("bhrd,bhkd->bhrk", qg,
                              ck.to(q.dtype)).float() * hd ** -0.5
        logits = softcap(logits, cfg.attn_softcap)
        logits = torch.where(ok[:, None, None, :], logits,
                             torch.full_like(logits, NEG_INF))
        mx, w, total = local_softmax(logits)
        acc = torch.einsum("bhrk,bhkd->bhrd", w, cv.float())
        out = merge_partials(mx, total, acc).reshape(B, -1, hd)
        h0 = model_coords()[0] * H
        out = out[:, h0:h0 + H].to(q.dtype)
        y = linear(out.reshape(B, 1, H * hd), p["wo"])
        return y, cache

    lo, n = kv_heads(cfg)
    qg = q[:, 0].reshape(B, n, cfg.n_heads // n, hd)
    logits = torch.einsum("bhrd,bhkd->bhrk", qg,
                          ck[:, lo:lo + n].to(q.dtype)).float() * hd ** -0.5
    logits = softcap(logits, cfg.attn_softcap)
    logits = torch.where(ok[:, None, None, :], logits,
                         torch.full_like(logits, NEG_INF))
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bhrk,bhkd->bhrd", w, cv[:, lo:lo + n].to(q.dtype))
    y = linear(out.reshape(B, 1, cfg.n_heads * hd), p["wo"])
    return y, cache
