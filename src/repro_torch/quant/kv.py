"""Binary-coded KV cache quantization: the storage format of quantized
page pools (the reference's `quant/kv.py`, same layout and math).

Each K/V vector of head_dim entries is stored in GPTQT's binary-coding
form, fitted per token, per KV head, per contiguous head_dim group:

    x[g*gs:(g+1)*gs] ~= beta_g + sum_i alpha_{g,i} * s_{g,i}

with s in {-1,+1} packed 32 signs per word along head_dim
(quant/packing.py:pack_signs_last, int32 words holding the uint32
bits). Greedy residual coding plus a mean offset, then KV_REFINE_ITERS
rounds of per-group least-squares refit and nearest-level reassignment.
Quantization happens on write (models/attention.py:_quant_scatter and
models/model.py:scatter_prefill_cache, plain PyTorch, as the reference
writes it in jnp); dequantization happens inside the paged-attention
kernel (kernels/paged_attention.py:paged_attention_quant) or its plain
version (kernels/ref.py:paged_attention_quant_ref).

Layout per (token, head), head_dim = hd, G = hd / group_size:
    codes  (..., bits, hd/32)  int32    sign bitplanes
    alphas (..., G, bits)      float32  per-group magnitudes
    betas  (..., G)            float32  per-group offsets

Bytes per (token, head): 4*bits*hd/32 + 4*G*bits + 4*G
(`kv_bytes_per_token_head`), against 4*hd for an fp32 page.
"""
from __future__ import annotations

import torch

from repro_torch.hw import WORD
from repro_torch.quant.packing import pack_signs_last, unpack_signs_last

# LS-refit + nearest-level-reassign rounds inside kv_quantize (the
# reference's value; greedy residual coding alone saturates around 10 %
# relative error whatever the bit count)
KV_REFINE_ITERS = 6


def kv_layout(head_dim: int, kv_bits: int, kv_group_size: int = 0):
    """Validate a quantized-KV layout; returns (G, words_per_head).
    head_dim must be a multiple of 32 (signs pack with no padding) and
    kv_group_size (0 = one group spanning head_dim) must divide it."""
    if kv_bits < 1:
        raise ValueError(f"kv_bits must be >= 1, got {kv_bits}")
    if head_dim % WORD:
        raise ValueError(
            f"quantized KV needs head_dim % {WORD} == 0 (sign words pack "
            f"along head_dim), got head_dim={head_dim}")
    gs = kv_group_size or head_dim
    if head_dim % gs:
        raise ValueError(
            f"kv_group_size={gs} must divide head_dim={head_dim}")
    return head_dim // gs, head_dim // WORD


def sign_combos(bits: int, device=None) -> torch.Tensor:
    """(2^bits, bits) fp32 of {-1,+1}: combo c takes the sign of bit i
    of c (the reference's `core/binary_coding.py:sign_combos`)."""
    c = torch.arange(2 ** bits, device=device)[:, None]
    i = torch.arange(bits, device=device)[None, :]
    return (2 * ((c >> i) & 1) - 1).to(torch.float32)


def kv_quantize(x, kv_bits: int, kv_group_size: int = 0,
                iters: int | None = None):
    """Binary-code vectors along the last axis. x (..., hd) float ->
    (codes (..., bits, hd/32) int32 words, alphas (..., G, bits) fp32,
    betas (..., G) fp32). Greedy residual coding per contiguous group,
    then `iters` (default KV_REFINE_ITERS) rounds: refit alphas by
    per-group least squares, reassign each entry to the nearest of the
    2^bits representable levels (the first one on a tie)."""
    if iters is None:
        iters = KV_REFINE_ITERS
    hd = x.shape[-1]
    G, _ = kv_layout(hd, kv_bits, kv_group_size)
    gs = hd // G
    xg = x.float().reshape(*x.shape[:-1], G, gs)
    beta = torch.mean(xg, dim=-1)                        # (..., G)
    r0 = xg - beta[..., None]
    r = r0
    alphas, signs = [], []
    for _ in range(kv_bits):
        s = torch.where(r >= 0, 1.0, -1.0)
        a = torch.mean(torch.abs(r), dim=-1)             # (..., G)
        alphas.append(a)
        signs.append(s)
        r = r - a[..., None] * s
    S = torch.stack(signs, dim=-2)                       # (..., G, bits, gs)
    a = torch.stack(alphas, dim=-1)                      # (..., G, bits)
    if iters:
        combos = sign_combos(kv_bits, x.device)          # (L, bits)
        eye = torch.eye(kv_bits, dtype=torch.float32, device=x.device)
        for _ in range(iters):
            # refit: per-group LS (S S^T) a = S r0; solve_ex leaves the
            # singularity flag on the device (no host sync per token)
            Gm = torch.einsum("...ik,...jk->...ij", S, S) + 1e-6 * eye
            rhs = torch.einsum("...ik,...k->...i", S, r0)
            a = torch.abs(torch.linalg.solve_ex(Gm, rhs[..., None])[0][..., 0])
            # reassign: nearest of the 2^bits levels
            levels = torch.einsum("...b,lb->...l", a, combos)  # (..., G, L)
            idx = torch.argmin(
                torch.abs(r0[..., None, :] - levels[..., None]), dim=-2)
            S = combos[idx].movedim(-1, -2)              # (..., G, bits, gs)
    sg = S.movedim(-2, -3)                               # (..., bits, G, gs)
    sg = sg.reshape(*x.shape[:-1], kv_bits, hd)
    return pack_signs_last(sg), a, beta


def kv_dequantize(codes, alphas, betas, dtype=torch.float32):
    """Inverse of kv_quantize: codes (..., bits, hd/32), alphas
    (..., G, bits), betas (..., G) -> (..., hd) in `dtype`."""
    signs = unpack_signs_last(codes)                     # (..., bits, hd)
    *lead, bits, hd = signs.shape
    G = betas.shape[-1]
    sg = signs.reshape(*lead, bits, G, hd // G)
    w = torch.einsum("...bgk,...gb->...gk", sg,
                     alphas.float()) + betas.float()[..., None]
    return w.reshape(*lead, hd).to(dtype)


def kv_bytes_per_token_head(head_dim: int, kv_bits: int,
                            kv_group_size: int = 0,
                            dtype_itemsize: int = 4) -> int:
    """Device bytes one (token, KV head) vector occupies. kv_bits=0 is
    the unquantized layout (head_dim raw entries of the pool dtype)."""
    if not kv_bits:
        return head_dim * dtype_itemsize
    G, hdw = kv_layout(head_dim, kv_bits, kv_group_size)
    # codes (32-bit words) + alphas fp32 + betas fp32
    return 4 * kv_bits * hdw + 4 * G * kv_bits + 4 * G
