"""Round-to-nearest (RTN) linear quantization and the min-MSE clip search
(the reference's `core/rtn.py`).

Grid convention (shared across the project): per output channel r,
    level(c) = S_r * (c - off) + center_r,  c in {0 .. 2^n - 1},
    off = (2^n - 1) / 2,  center_r = (Wmax_r + Wmin_r) / 2,
    S_r = (Wmax_r - Wmin_r) / (2^n - 1),
the paper's asymmetric grid in centred form, so that re-exploring S
(Eq. 7) stretches the axis symmetrically about the row's centre.

All functions take W_t of shape (N_rows=out, K_cols=in). `group_rows`
folds contiguous K-groups of length `group_size` into extra rows, so
every per-row routine becomes per-(row, group); `group_size=0` keeps
one group per row. A group size that does not divide K raises.
"""
from __future__ import annotations

import torch


def linspace_f32(start, stop, num: int, device=None):
    """`jnp.linspace(start, stop, num)`'s formula in fp32: step i is
    fp32(i) / fp32(num - 1), the value start * (1 - step) + stop * step,
    and the last entry stop itself. XLA rounds a few entries an ulp
    apart from this (torch.linspace's own formula is further off)."""
    start = torch.as_tensor(start, dtype=torch.float32, device=device)
    stop = torch.as_tensor(stop, dtype=torch.float32, device=device)
    if num == 1:
        return start.reshape(1)
    div = num - 1
    step = (torch.arange(div, dtype=torch.float32, device=device)
            / torch.tensor(float(div), dtype=torch.float32, device=device))
    out = start * (1 - step) + stop * step
    return torch.cat([out, stop.reshape(1)])


def n_k_groups(k: int, group_size: int) -> int:
    """Number of contiguous K-groups; validates divisibility."""
    if group_size == 0:
        return 1
    if group_size < 0:
        raise ValueError(f"group_size must be >= 0, got {group_size}")
    if k % group_size:
        raise ValueError(
            f"group_size={group_size} does not divide K={k}; pick a "
            f"divisor of K (or 0 for per-channel scales) — padding is "
            f"not applied implicitly")
    return k // group_size


def group_rows(Wt, group_size: int):
    """(N, K) -> ((N*G, K/G) view with groups as rows, G). Row order is
    (n, g) -> n*G + g, a plain row-major reshape, so
    `X.reshape(N, G, ...)` inverts it."""
    N, K = Wt.shape
    G = n_k_groups(K, group_size)
    return Wt.reshape(N * G, K // G), G


def row_grid(Wt, bits: int, clip: float = 1.0):
    """Per-row (scale, center). clip < 1 shrinks the covered range."""
    wmax = torch.amax(Wt, dim=1)
    wmin = torch.amin(Wt, dim=1)
    center = (wmax + wmin) / 2.0
    S = clip * (wmax - wmin) / (2.0 ** bits - 1.0)
    S = torch.clamp(S, min=1e-12)
    return S.float(), center.float()


def linear_levels(S, center, bits: int):
    """(N,) grids -> (N, 2^n) float level values."""
    n_levels = int(2 ** bits)
    off = (n_levels - 1) / 2.0
    c = torch.arange(n_levels, dtype=torch.float32, device=S.device) - off
    return S[:, None] * c[None, :] + center[:, None]


def quantize_rtn(Wt, bits: int, clip: float = 1.0, group_size: int = 0):
    """-> (Wq, int codes) on the row grid above; `group_size > 0` fits
    one grid per contiguous K-group instead of per row."""
    if group_size:
        Wg, _ = group_rows(Wt, group_size)
        wq, q = quantize_rtn(Wg, bits, clip)
        return wq.reshape(Wt.shape), q.reshape(Wt.shape)
    S, center = row_grid(Wt, bits, clip)
    off = (2.0 ** bits - 1.0) / 2.0
    q = torch.round((Wt - center[:, None]) / S[:, None] + off)
    q = torch.clamp(q, 0, 2 ** bits - 1)
    wq = S[:, None] * (q - off) + center[:, None]
    return wq.float(), q.to(torch.int32)


def minmse_grid(Wt, bits: int, n_grid: int = 32, lo: float = 0.4):
    """GPTQ(min MSE) baseline (Tab. V): per-row clip ratio minimizing the
    plain weight MSE. Returns (S, center) of the winning clipped grid."""
    ratios = linspace_f32(lo, 1.0, n_grid, device=Wt.device)
    errs = torch.stack([
        torch.sum((quantize_rtn(Wt, bits, clip=float(r))[0] - Wt) ** 2,
                  dim=1)
        for r in ratios.tolist()])                       # (n_grid, N)
    best = torch.argmin(errs, dim=0)                     # (N,)
    S, center = row_grid(Wt, bits)
    return (S * ratios[best]).float(), center


def rtn_binary_coding(Wt, bits: int, group_size: int = 0,
                      orig_dtype="float32"):
    """RTN's linear grid as its exact binary coding: a code c in
    {0 .. 2^n - 1} with bits b_j has c - off = sum_j 2^(j-1) (2 b_j - 1),
    so level(c) = center + sum_j S 2^(j-1) s_j. Plane 0 holds the most
    significant bit (alpha 2^(n-2) S, the leading plane a draft view
    keeps), beta = center. -> (wq (N, K) as quantize_rtn gives it, the
    QuantizedTensor of layer layout (K, N))."""
    from repro_torch.quant.packing import pack_signs
    from repro_torch.quant.qlinear import QuantizedTensor
    N, K = Wt.shape
    wq, q = quantize_rtn(Wt, bits, group_size=group_size)
    Wg, G = group_rows(Wt, group_size)
    S, center = row_grid(Wg, bits)                       # (N * G,)
    shifts = torch.arange(bits - 1, -1, -1, device=Wt.device)
    alphas = S[:, None] * torch.exp2(shifts.float() - 1.0)[None, :]
    alphas = alphas.reshape(N, G, bits).transpose(0, 1).contiguous()
    betas = center.reshape(N, G).T.contiguous()
    signs = ((q[None] >> shifts[:, None, None]) & 1).bool()  # (n, N, K)
    codes = pack_signs(signs.transpose(1, 2))            # (n, K/32, N)
    return wq, QuantizedTensor(codes, alphas, betas, k_in=K,
                               orig_dtype=orig_dtype)
