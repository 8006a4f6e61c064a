"""GPTQ solver (Frantar et al., paper Eqs. 1-2), generic over the level
grid (the reference's `core/gptq.py`): quantize column by column,
compensating the not-yet-quantized columns through the Cholesky factor
of H^-1. The grid is an argument (per-row arbitrary level sets), so
one solver backs GPTQ (linear grid), GPTQ+BCQ, GPTQ(min-MSE) and GPTQT
(BCchoice grid), the comparison of Tab. V.

Group-wise grids: `levels` of shape (N, G, L) switch grids as the sweep
crosses each group boundary (`col_group` maps a column to its group;
with actorder the map is permuted with the columns, so a column always
quantizes against its ORIGINAL group's grid, the static-groups
convention). `gptq_solve_refresh` re-fits a linear grid's scale from
the current (compensated) residual block at every group boundary.

The column sweep is the reference's rank-1 form, one column a step,
on the device of W: the step's update of the later columns
(`W[c+1:] -= u * err`) gives the reference's masked full-row update
value for value (subtracting err * 0 leaves a float as it is). It
makes no host sync per column. `margins=True` also records, for every
(row, column), the gap between the two nearest level distances of the
level pick (the near-tie record of the parity checks).
"""
from __future__ import annotations

import torch

from repro_torch.core.hessian import damp


def _chol_inv_upper(H):
    """Upper Cholesky factor U of H^-1 (GPTQ convention: row U[c, c:]
    drives the compensation of the columns after c). A matrix that is
    not positive definite gives NaNs, as jnp.linalg.cholesky does, and
    raises nothing."""
    L, info = torch.linalg.cholesky_ex(H)
    L = torch.where(info > 0, torch.nan, L)
    eye = torch.eye(H.shape[0], dtype=H.dtype, device=H.device)
    Linv = torch.linalg.solve_triangular(L, eye, upper=False)
    Hinv = Linv.T @ Linv
    U, info = torch.linalg.cholesky_ex(Hinv)
    return torch.where(info > 0, torch.nan, U).T


def _level_margin(dist):
    """(N, L) distances -> (N,) gap between the two smallest."""
    two = torch.topk(dist, 2, dim=1, largest=False).values
    return two[:, 1] - two[:, 0]


def _solve_loop(Wt, U, levels, col_group, margins=False):
    """Wt (N, K); U (K, K) upper; levels (N, G, L); col_group: K host
    ints mapping solve-order column -> grid index along G. Returns
    (Q, idx[, margin (N, K)])."""
    N, K = Wt.shape
    W = Wt.T.contiguous()                    # (K, N): column c is row c
    idx = torch.empty((K, N), dtype=torch.int64, device=Wt.device)
    mg = (torch.empty((K, N), dtype=torch.float32, device=Wt.device)
          if margins else None)
    grids = [levels[:, g] for g in range(levels.shape[1])]      # (N, L)
    for c in range(K):
        w = W[c]
        lv = grids[col_group[c]]
        dist = torch.abs(w[:, None] - lv)
        torch.argmin(dist, dim=1, out=idx[c])
        if margins:
            mg[c] = _level_margin(dist)
        q = torch.gather(lv, 1, idx[c][:, None])[:, 0]
        err = (w - q) / U[c, c]
        W[c + 1:] -= U[c, c + 1:, None] * err[None, :]
    I = idx.T
    L = levels.shape[2]
    flat = I + L * torch.as_tensor(col_group, device=I.device)[None, :]
    Q = torch.gather(levels.reshape(N, -1), 1, flat)
    out = (Q, I.to(torch.int32))
    return out + (mg.T,) if margins else out


def gptq_solve(Wt, H, levels, *, percdamp: float = 0.01, actorder: bool = True,
               col_group=None, margins: bool = False):
    """Quantize Wt (N_out, K_in) against level sets `levels` using
    Hessian H (K, K). Returns (Wq (N,K) fp32, idx (N,K) int32), and with
    `margins=True` also the (N, K) level-pick margins.

    levels: (N, L) per-row grids, or (N, G, L) per-(row, K-group) grids
    with contiguous groups of length K/G (override the group of each
    column via `col_group` (K,) if the grouping is not contiguous).
    """
    Wt = Wt.float()
    H, dead_cols = damp(H.float(), percdamp)
    Wt = torch.where(dead_cols[None, :], 0.0, Wt)

    K = Wt.shape[1]
    levels = levels.float()
    if levels.dim() == 2:
        levels = levels[:, None, :]                      # (N, 1, L)
    G = levels.shape[1]
    if col_group is None:
        if K % G:
            raise ValueError(
                f"grouped levels (G={G}) need G to divide K={K} (or an "
                f"explicit col_group map)")
        col_group = torch.arange(K) // (K // G)
    col_group = torch.as_tensor(col_group).cpu().long()

    if actorder:
        perm = torch.argsort(-torch.diagonal(H), stable=True)
        inv_perm = torch.argsort(perm, stable=True)
        Wt_p = Wt[:, perm]
        H_p = H[perm][:, perm]
        col_group = col_group[perm.cpu()]
    else:
        inv_perm = None
        Wt_p, H_p = Wt, H

    U = _chol_inv_upper(H_p)
    out = _solve_loop(Wt_p, U, levels, col_group.tolist(), margins)
    if actorder:
        out = tuple(t[:, inv_perm] for t in out)
    return out


def _solve_loop_refresh(Wt, U, *, bits: int, group_size: int):
    """Linear-grid sweep that re-fits (S, center) per row from the
    CURRENT residual block each time the column index enters a new
    group. Natural column order (no actorder)."""
    N, K = Wt.shape
    n_levels = 2.0 ** bits
    off = (n_levels - 1.0) / 2.0
    W = Wt.T.contiguous()                    # (K, N)
    Q = torch.empty_like(W)
    I = torch.empty((K, N), dtype=torch.int32, device=Wt.device)
    for c in range(K):
        if c % group_size == 0:
            blk = W[c:c + group_size]
            wmax = torch.amax(blk, dim=0)
            wmin = torch.amin(blk, dim=0)
            S = torch.clamp((wmax - wmin) / (n_levels - 1.0), min=1e-12)
            Cen = (wmax + wmin) / 2.0
        w = W[c]
        idx = torch.clamp(torch.round((w - Cen) / S + off), 0, n_levels - 1)
        q = S * (idx - off) + Cen
        err = (w - q) / U[c, c]
        W[c + 1:] -= U[c, c + 1:, None] * err[None, :]
        Q[c] = q
        I[c] = idx.to(torch.int32)
    return Q.T, I.T


def gptq_solve_refresh(Wt, H, *, bits: int, group_size: int,
                       percdamp: float = 0.01):
    """GPTQ with a linear grid whose per-group scale is refreshed from
    the compensated residual at every group boundary (the reference
    GPTQ `groupsize` schedule; incompatible with actorder, which
    scatters a group's columns across the sweep)."""
    Wt = Wt.float()
    K = Wt.shape[1]
    if group_size <= 0 or K % group_size:
        raise ValueError(
            f"group_size={group_size} must be positive and divide K={K}")
    H, dead_cols = damp(H.float(), percdamp)
    Wt = torch.where(dead_cols[None, :], 0.0, Wt)
    U = _chol_inv_upper(H)
    return _solve_loop_refresh(Wt, U, bits=bits, group_size=group_size)


def output_error(Wt, Wq, H):
    """tr((W-Wq) H (W-Wq)^T): the layer output MSE proxy (Eq. 1
    objective, summed over rows)."""
    D = (Wt - Wq).float()
    return float(torch.einsum("nk,nk->", D @ H.float(), D))
