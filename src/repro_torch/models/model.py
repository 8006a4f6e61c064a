"""Model assembly for attention-only decoders with dense or MoE MLPs
(the reference's `models/model.py`, serving entry points).

Parameters are plain dicts of tensors with one weight dict per layer
(the reference stacks each pattern position along an (n_groups, ...)
axis and scans it; the port loops over the layers):

    {"embed": (V, D), "final_ln": (D,), ["lm_head": (D, V)],
     "layers": [{"ln", "attn": {"wq","wk","wv","wo"}, "ln2",
                 "mlp": {"wg","wu","wd"}                    (dense), or
                 "moe": {"router","wg","wu","wd"}}, ...]}   (MoE stacks)

Any weight may be a QuantizedTensor; `layers.linear` dispatches on it.
Caches are lists with one dict per layer, updated in place.

Entry points:
  init_params(cfg, seed, dtype, device)              -> params
  prefill(cfg, params, tokens, max_len, last_pos=)   -> (last logits, cache)
  init_cache / decode_step                            dense KV cache
  init_paged_cache / decode_step_paged                paged KV pool (fp
                                                      or binary-coded)
  scatter_prefill_cache                               dense prefill -> pages

MoE layers use the reference's capacities: the inference capacity
factor in prefill (pad tokens of a bucket route and take capacity like
real ones, as in the reference) and 4.0 in decode.
"""
from __future__ import annotations

import torch

from repro_torch.hw import resolve_device, torch_dtype
from repro_torch.models import attention as attn
from repro_torch.models.layers import (init_linear, init_swiglu, linear,
                                       rmsnorm, softcap, swiglu)
from repro_torch.models.moe import init_moe, moe_forward

# decode dispatch capacity of MoE layers (the reference's 4x slack
# instead of fully dropless; exactly dropless at tiny batch)
DECODE_CAPACITY_FACTOR = 4.0


def require_attention_only(cfg) -> None:
    """The port serves attention-only decoders (dense or MoE MLPs) so
    far."""
    if cfg.mla is not None:
        raise NotImplementedError(f"{cfg.name}: MLA comes with a later slice "
                                  f"(ROADMAP Queue 1 item 5)")
    if any(s.kind != "attn" for s in cfg.pattern):
        raise NotImplementedError(f"{cfg.name}: Mamba layers come with a "
                                  f"later slice (ROADMAP Queue 1 item 5)")
    if any(s.mlp == "moe" for s in cfg.pattern) and cfg.moe is None:
        raise ValueError(f"{cfg.name}: MoE layers without a MoE config")
    if cfg.post_block_norms or cfg.embed_input != "tokens":
        raise NotImplementedError(f"{cfg.name}: post-block norms and frame "
                                  f"inputs are not ported yet")


def _layers(cfg, params):
    """(spec, layer weights) for every layer; the weights must have the
    config's depth."""
    if len(params["layers"]) != cfg.n_layers:
        raise ValueError(f"{cfg.name}: params hold {len(params['layers'])} "
                         f"layers, the config {cfg.n_layers}")
    return zip(cfg.layer_specs(), params["layers"])


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def _init_layer(cfg, spec, gen, dtype, device):
    d = cfg.d_model
    dt = torch_dtype(dtype)
    p = {"ln": torch.zeros((d,), dtype=dt, device=device),
         "attn": attn.init_attn(cfg, gen, dtype, device)}
    if spec.mlp != "none":
        p["ln2"] = torch.zeros((d,), dtype=dt, device=device)
        if spec.mlp == "moe":
            p["moe"] = init_moe(cfg, gen, dtype, device)
        else:
            p["mlp"] = init_swiglu(gen, d, cfg.d_ff, dtype, device)
    return p


def init_params(cfg, seed: int = 0, dtype=None, device=None):
    """Random init from a `torch.Generator` seeded with `seed` on the
    target device (the same distributions as the reference's init; the
    numbers differ, so parity tests carry the reference's weights across
    with ckpt.params_from_tree instead)."""
    require_attention_only(cfg)
    dev = resolve_device(device)
    dtype = dtype or cfg.dtype
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    d = cfg.d_model
    params = {"final_ln": torch.zeros((d,), dtype=torch_dtype(dtype),
                                      device=dev)}
    params["embed"] = (torch.randn((cfg.vocab_size, d), generator=gen,
                                   dtype=torch.float32, device=dev)
                       * 0.02).to(torch_dtype(dtype))
    if not cfg.tie_embeddings:
        params["lm_head"] = init_linear(gen, d, cfg.vocab_size, dtype, dev)
    params["layers"] = [_init_layer(cfg, spec, gen, dtype, dev)
                        for spec in cfg.layer_specs()]
    return params


# --------------------------------------------------------------------------
# embedding / unembedding
# --------------------------------------------------------------------------

def embed_inputs(cfg, params, tokens):
    return params["embed"][tokens.long()]


def unembed(cfg, params, x):
    """Logits in the activation dtype."""
    if cfg.tie_embeddings:
        logits = torch.einsum("bsd,vd->bsv", x, params["embed"].to(x.dtype))
    else:
        logits = linear(x, params["lm_head"])
    return softcap(logits, cfg.final_softcap)


# --------------------------------------------------------------------------
# prefill
# --------------------------------------------------------------------------

def _attn_prefill(cfg, spec, p, h, positions, max_len):
    y, k, v = attn._attend_sequence(cfg, spec, p, h, positions)
    S = h.shape[1]
    ck = k.transpose(1, 2)          # (B, Hkv, S, hd)
    cv = v.transpose(1, 2)
    if spec.window is None:
        pad = max_len - S
        ck = torch.nn.functional.pad(ck, (0, 0, 0, pad))
        cv = torch.nn.functional.pad(cv, (0, 0, 0, pad))
    else:
        w = min(spec.window, max_len)
        lo = max(0, S - w)
        slots = torch.arange(lo, S, device=h.device) % w
        buf_k = torch.zeros((ck.shape[0], ck.shape[1], w, ck.shape[3]),
                            dtype=ck.dtype, device=h.device)
        buf_v = torch.zeros_like(buf_k)
        buf_k[:, :, slots] = ck[:, :, lo:]
        buf_v[:, :, slots] = cv[:, :, lo:]
        ck, cv = buf_k, buf_v
    return y, {"k": ck.contiguous(), "v": cv.contiguous()}


def _mlp(cfg, spec, lp, x, moe_capacity_factor):
    """x + the layer's MLP (dense SwiGLU or MoE at the given capacity
    factor; the aux loss is not used in serving)."""
    if spec.mlp == "none":
        return x
    h = rmsnorm(x, lp["ln2"], cfg.norm_eps)
    if spec.mlp == "moe":
        y, _ = moe_forward(cfg, lp["moe"], h,
                           capacity_factor=moe_capacity_factor)
        return x + y
    return x + swiglu(lp["mlp"], h)


def _last_positions(x, last_pos):
    """x (B, S, D) -> (B, 1, D) at per-row index `last_pos` ((B,)), or
    the final position when last_pos is None."""
    if last_pos is None:
        return x[:, -1:]
    b = torch.arange(x.shape[0], device=x.device)
    return x[b, last_pos.long()][:, None]


def prefill(cfg, params, tokens, max_len, *, last_pos=None):
    """Run the prompt, return (last-position logits (B, V), dense cache
    with every layer's K/V padded to max_len). `last_pos` ((B,)) picks
    the logits row of bucket-padded prompts."""
    require_attention_only(cfg)
    x = embed_inputs(cfg, params, tokens)
    positions = torch.arange(x.shape[1], device=x.device)
    cache = []
    for spec, lp in _layers(cfg, params):
        h = rmsnorm(x, lp["ln"], cfg.norm_eps)
        y, c = _attn_prefill(cfg, spec, lp["attn"], h, positions, max_len)
        cache.append(c)
        x = _mlp(cfg, spec, lp, x + y,
                 cfg.moe.inference_capacity_factor if cfg.moe else None)
    x = rmsnorm(_last_positions(x, last_pos), params["final_ln"], cfg.norm_eps)
    return unembed(cfg, params, x)[:, 0], cache


# --------------------------------------------------------------------------
# caches
# --------------------------------------------------------------------------

def init_cache(cfg, batch, max_len, dtype=None, device=None):
    """Dense KV cache: one {"k","v"} (batch, Hkv, max_len, hd) per layer."""
    require_attention_only(cfg)
    dev = resolve_device(device)
    return [attn.init_kv_cache(cfg, spec, batch, max_len, dtype or cfg.dtype,
                               dev) for spec in cfg.layer_specs()]


def init_paged_cache(cfg, n_pages, page_size, max_seqs, dtype=None,
                     kv_bits=0, kv_group_size=0, device=None):
    """Paged cache: one pool per layer, shared by all sequences —
    {"k_pages","v_pages"} (n_pages, page_size, Hkv, hd), or with
    `kv_bits > 0` the binary-coded {"k_codes","k_alphas","k_betas",
    "v_..."} (attention.init_paged_kv). max_seqs is the reference's
    argument for per-slot recurrent state, unused by attention-only
    patterns."""
    require_attention_only(cfg)
    dev = resolve_device(device)
    return [attn.init_paged_kv(cfg, n_pages, page_size, dtype or cfg.dtype,
                               dev, kv_bits=kv_bits,
                               kv_group_size=kv_group_size)
            for _ in cfg.layer_specs()]


def is_page_leaf(leaf, n_pages) -> bool:
    """A page-pool leaf: page axis at dim 0 of the per-layer pool. Both
    fp pages (ndim 4) and the binary-coded code/alpha/beta leaves
    (ndim 4-5) match."""
    return leaf.dim() >= 4 and leaf.shape[0] == n_pages


# --------------------------------------------------------------------------
# decode
# --------------------------------------------------------------------------

def _decode_layers(cfg, params, cache, x, attn_step):
    """Shared single-step decode: every layer with the attention flavour
    injected (dense cache / paged pool)."""
    for (spec, lp), lc in zip(_layers(cfg, params), cache):
        h = rmsnorm(x, lp["ln"], cfg.norm_eps)
        y, _ = attn_step(spec, lp["attn"], h, lc)
        x = _mlp(cfg, spec, lp, x + y, DECODE_CAPACITY_FACTOR)
    x = rmsnorm(x, params["final_ln"], cfg.norm_eps)
    return unembed(cfg, params, x), cache


def decode_step(cfg, params, cache, tokens, pos):
    """One decode step. tokens: (B, 1); pos: (B,) absolute positions.
    Returns (logits (B, V), cache) with the cache written in place."""
    require_attention_only(cfg)
    x = embed_inputs(cfg, params, tokens)
    logits, cache = _decode_layers(
        cfg, params, cache, x,
        lambda spec, p, h, c: attn.attn_decode(cfg, spec, p, h, c, pos))
    return logits[:, 0], cache


def decode_step_paged(cfg, params, cache, tokens, pos, block_tables):
    """One decode step against a paged cache (init_paged_cache layout).
    block_tables: (B, T) int32 page ids, row b = sequence in slot b."""
    require_attention_only(cfg)
    x = embed_inputs(cfg, params, tokens)
    logits, cache = _decode_layers(
        cfg, params, cache, x,
        lambda spec, p, h, c: attn.attn_decode_paged(cfg, spec, p, h, c,
                                                     block_tables, pos))
    return logits[:, 0], cache


def scatter_prefill_cache(cfg, paged_cache, row_cache, slot, page_ids,
                          n_valid):
    """Write one sequence's dense prefill cache (prefill() on a single
    padded row: {"k","v"} (1, Hkv, S_pad, hd) per layer) into its pages:
    token t lands in page page_ids[t // page] at offset t % page, for
    the n_valid real tokens only (padding never reaches a page). On a
    binary-coded pool each token's K/V is quantized here (quantize on
    write), so pages never hold raw values. `slot` is the reference's
    argument for per-slot recurrent state, unused by attention-only
    patterns. Writes in place; returns the cache."""
    ids = torch.as_tensor(page_ids, dtype=torch.long)
    n = int(n_valid)
    for pooled, row in zip(paged_cache, row_cache):
        quant = attn.paged_kv_bits(pooled) > 0
        lead = pooled["k_codes" if quant else "k_pages"]
        page = lead.shape[1]
        t = torch.arange(n)
        pid = ids[t // page].to(lead.device)
        off = (t % page).to(lead.device)
        rows = [row[side][0, :, :n].transpose(0, 1) for side in ("k", "v")]
        if quant:
            attn._quant_scatter(pooled, torch.stack(rows), pid, off)
            continue
        for side, r in zip(("k", "v"), rows):
            pool = pooled[f"{side}_pages"]
            pool[pid, off] = r.to(pool.dtype)
    return paged_cache
