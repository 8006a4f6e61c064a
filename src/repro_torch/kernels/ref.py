"""Plain PyTorch oracles for the port's kernels (the reference's
`kernels/ref.py`, same arguments and layouts).

`bcq_matmul_ref` dequantizes, then multiplies (`bcq_expert_matmul_ref`
the same per expert of a stack); `paged_attention_ref` gathers each
sequence's pages through its block table and runs the masked softmax of
dense decode (`paged_attention_quant_ref` the same over binary-coded
pages, expanded first). They are the ground truth the CUDA kernels are
held against on the card and the CPU path of the kernel wrappers'
tests.
"""
from __future__ import annotations

import torch

from repro_torch.quant.kv import kv_dequantize
from repro_torch.quant.packing import unpack_signs

NEG_INF = -1e30


def dequant_ref(codes, alphas, betas, k_in: int, dtype=torch.float32):
    """codes (bits, K/32, N) int32 words; alphas (G, N, bits); betas
    (G, N) -> W (k_in, N). Group g's scales cover K rows
    [g*ceil(k_in/G), ...): exact contiguous groups when G divides k_in,
    ragged-tail semantics otherwise."""
    signs = unpack_signs(codes, k_in)                    # (bits, K, N)
    G = alphas.shape[0]
    glen = -(-k_in // G)
    # scales may be bf16 in memory (packed artifacts); expand in fp32
    a = torch.repeat_interleave(alphas.float(), glen, dim=0)[:k_in]
    b = torch.repeat_interleave(betas.float(), glen, dim=0)[:k_in]
    w = torch.einsum("ikn,kni->kn", signs, a) + b
    return w.to(dtype)


def bcq_matmul_ref(x, codes, alphas, betas, k_in: int):
    """x (..., k_in) -> (..., N)."""
    w = dequant_ref(codes, alphas, betas, k_in, dtype=torch.float32)
    return torch.einsum("...k,kn->...n", x.float(), w).to(x.dtype)


def bcq_gemv_ref(x, codes, alphas, betas, k_in: int):
    """Oracle for the decode-shaped kernel: the same math as the GEMM."""
    return bcq_matmul_ref(x, codes, alphas, betas, k_in)


def bcq_expert_matmul_ref(x, codes, alphas, betas, k_in: int):
    """Oracle for the batched-expert kernel: x (E, M, k_in); codes
    (E, bits, K/32, N); alphas (E, G, N, bits); betas (E, G, N)
    -> (E, M, N). Dequantize every expert, then one batched matmul."""
    w = torch.stack([dequant_ref(c, a, b, k_in)
                     for c, a, b in zip(codes, alphas, betas)])
    return torch.einsum("emk,ekn->emn", x.float(), w).to(x.dtype)


def _paged_attend(q, k, v, ctx_lens, *, window, cap):
    """Decode-time masked softmax over already-gathered K/V:
    q (B, Hkv, rep, hd); k/v (B, Hkv, K, hd); ctx_lens (B,)."""
    hd = q.shape[-1]
    logits = torch.einsum("bhrd,bhkd->bhrk", q.float(), k.float()) * hd ** -0.5
    if cap is not None:
        logits = cap * torch.tanh(logits / cap)
    j = torch.arange(k.shape[2], device=q.device)[None, :]
    ctx = ctx_lens.to(torch.int64)[:, None]
    ok = j < ctx
    if window is not None:
        ok &= (ctx - 1 - j) < window
    logits = torch.where(ok[:, None, None, :], logits,
                         torch.full_like(logits, NEG_INF))
    w = torch.exp(logits - torch.amax(logits, dim=-1, keepdim=True))
    w = w / torch.sum(w, dim=-1, keepdim=True)
    out = torch.einsum("bhrk,bhkd->bhrd", w, v.float())
    return out.to(q.dtype)


def paged_attention_ref(q, k_pages, v_pages, block_tables, ctx_lens, *,
                        window=None, cap=None, kv0=0):
    """q (B, Hkv, rep, hd); k_pages/v_pages (P, page, Hkv_pool, hd), q's
    KV head h reading the pool's kv0 + h; block_tables (B, T); ctx_lens
    (B,). Returns (B, Hkv, rep, hd)."""
    B, Hkv, rep, hd = q.shape
    page = k_pages.shape[1]
    T = block_tables.shape[1]
    bt = block_tables.long()
    k_pages, v_pages = (t[:, :, kv0:kv0 + Hkv] for t in (k_pages, v_pages))
    # gather: (B, T, page, Hkv, hd) -> (B, Hkv, T*page, hd)
    k = k_pages[bt].reshape(B, T * page, Hkv, hd)
    v = v_pages[bt].reshape(B, T * page, Hkv, hd)
    return _paged_attend(q, k.transpose(1, 2), v.transpose(1, 2), ctx_lens,
                         window=window, cap=cap)


def paged_attention_quant_ref(q, k_codes, k_alphas, k_betas, v_codes,
                              v_alphas, v_betas, block_tables, ctx_lens,
                              *, window=None, cap=None, kv0=0):
    """Oracle for the fused-dequant kernel: gather each sequence's
    binary-coded pages through the block table (quant/kv.py layout:
    codes (P, page, Hkv, bits, hd/32), alphas (P, page, Hkv, G, bits),
    betas (P, page, Hkv, G)), expand them to fp32 K/V, then the masked
    softmax of paged_attention_ref (q's KV head h reads the pool's kv0 +
    h)."""
    B, Hkv, rep, hd = q.shape
    page = k_codes.shape[1]
    T = block_tables.shape[1]
    bt = block_tables.long()
    heads = slice(kv0, kv0 + Hkv)
    k = kv_dequantize(*(t[:, :, heads][bt] for t in (k_codes, k_alphas,
                                                     k_betas)))
    v = kv_dequantize(*(t[:, :, heads][bt] for t in (v_codes, v_alphas,
                                                     v_betas)))
    k = k.reshape(B, T * page, Hkv, hd).transpose(1, 2)
    v = v.reshape(B, T * page, Hkv, hd).transpose(1, 2)
    return _paged_attend(q, k, v, ctx_lens, window=window, cap=cap)
