"""GPTQT: quantize twice (paper §II-B/C/D; the reference's
`core/gptqt.py`).

Per weight matrix, in GPTQ orientation Wt = W^T (rows = output
channels):

  step 1   per-row linear grid at `intermediate_bits` n (centred form,
           core/rtn.py).
  step 2   pick a BCchoice — a binary-coding-expressible subset of the
           2^n integer levels — per row, minimizing the diag(H)-weighted
           weight error.
  re-expl  grid-search the scale multiplier over the Eq. 7 range
           [ (2^n-1)/(2^{n+r}-1), (2^n-1)/(2^{n-r}-1) ] with the chosen
           BCchoice fixed.
  solve    the GPTQ solver against the final per-row float levels.
  fuse     collapse both steps into pure binary coding (Eq. 11):
           alpha_i = S'*e_i/2, beta = S'*(m - off) + center; pack the
           sign bitplanes into a QuantizedTensor.

`group_size > 0` gives every contiguous K-group of a row its own grid,
BCchoice and re-explored scale: groups fold into rows (core/rtn.
group_rows), so steps 1-3 run batched over all (row, group) pairs and
only the GPTQ solve sees whole rows, switching grids at group
boundaries.

Scoring uses per-row histograms of the int-domain weights (weighted
s0/s1/s2 per bin, summed by `index_add_`), which turns the candidate
search into two (rows, bins) @ (bins, candidates) products, taken in
row chunks of bounded size; `exact=True` scores elementwise instead.
Every argmin takes the first of equal values, as the reference's does.
With `margins=True` the result also records each pick's margin: the
gap between the best and the second-best candidate score and
multiplier error (relative to the row's weighted energy) and the
solver's level-pick gaps.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.core.binary_coding import (_combos, choice_levels_int,
                                            enumerate_bc_choices)
from repro_torch.core.gptq import gptq_solve
from repro_torch.core.rtn import group_rows, linspace_f32, row_grid
from repro_torch.core.stages import stage
from repro_torch.quant.packing import pack_signs
from repro_torch.quant.qlinear import QuantizedTensor

HIST_BINS_PER_LEVEL = 8
# most (rows x candidates) scores held at once by the histogram search
SCORE_CHUNK = 1 << 26


@dataclass
class GPTQTResult:
    qt: QuantizedTensor          # packed representation (layer layout K,N)
    wq_t: torch.Tensor           # dequantized (N, K) fp32 (GPTQ orientation)
    levels: torch.Tensor         # (N[, G], 2^k) final float levels
    choice_e: torch.Tensor       # (N[, G], k) chosen e_i
    choice_j: torch.Tensor       # (N[, G]) chosen offset j
    scale: torch.Tensor          # (N[, G]) re-explored scale S'
    center: torch.Tensor         # (N[, G]) row/group centers
    mult: torch.Tensor           # (N[, G]) selected scale multiplier
    group_size: int = 0          # K-group length (0 = per-channel)
    # near-tie record (margins=True): candidate and multiplier margins
    # (N[, G]), relative to the row's weighted energy; level-pick
    # margins (N, K) of the solve
    choice_margin: Optional[torch.Tensor] = None
    mult_margin: Optional[torch.Tensor] = None
    level_margin: Optional[torch.Tensor] = None


def _row_hist_stats(Wn, hd, n_levels, bins):
    """Wn (N, K) int-domain weights; hd (K,) or (N, K) diag-H weights.
    -> s0, s1, s2 (N, bins), bin centers (bins,)."""
    N, K = Wn.shape
    lo, hi = -0.5, n_levels - 0.5
    width = (hi - lo) / bins
    idx = torch.clamp(((Wn - lo) / width).to(torch.int32), 0, bins - 1)
    flat = (torch.arange(N, device=Wn.device)[:, None] * bins
            + idx).reshape(-1)
    w = torch.broadcast_to(hd, (N, K)).reshape(-1)
    x = Wn.reshape(-1)

    def seg(v):
        return torch.zeros(N * bins, dtype=torch.float32,
                           device=Wn.device).index_add_(0, flat, v) \
            .reshape(N, bins)
    s0, s1, s2 = seg(w), seg(w * x), seg(w * x * x)
    centers = lo + (torch.arange(bins, device=Wn.device) + 0.5) * width
    return s0, s1, s2, centers.float()


def _score_candidates_hist(s0, s1, s2, centers, cand_levels):
    """cand_levels (C, L) int-domain (any order). Returns scores (N, C):
    err = sum_b s2 - 2 V s1 + V^2 s0."""
    sorted_lv = torch.sort(cand_levels, dim=1).values    # (C, L)
    mids = (sorted_lv[:, 1:] + sorted_lv[:, :-1]) / 2.0  # (C, L-1)
    # nearest level value per (candidate, bin)
    idx = torch.sum(centers[None, :, None] > mids[:, None, :], dim=-1)
    V = torch.gather(sorted_lv, 1, idx)                  # (C, B)
    const = torch.sum(s2, dim=1, keepdim=True)           # (N, 1)
    return const - 2.0 * (s1 @ V.T) + (s0 @ (V * V).T)


def _score_candidates_exact(Wn, hd, cand_levels):
    """Elementwise scoring. Wn (N,K); hd (K,) or (N,K);
    cand_levels (C,L) -> (N, C)."""
    hd2 = torch.broadcast_to(hd, Wn.shape)
    cols = []
    for lv in cand_levels:
        d = torch.amin(torch.abs(Wn[..., None] - lv[None, None, :]), dim=-1)
        cols.append(torch.sum(d * d * hd2, dim=1))
    return torch.stack(cols, 1)                          # (N, C)


def _mult_grid(reexplore_range: int, n: int, points: int, device=None):
    """The Eq. 7 multipliers: fp32 exp(linspace(log lo, log hi))."""
    if reexplore_range <= 0:
        return torch.ones((1,), dtype=torch.float32, device=device)
    top = 2.0 ** n - 1.0
    lo = top / (2.0 ** (n + reexplore_range) - 1.0)
    hi = top / (2.0 ** (n - reexplore_range) - 1.0)
    logs = torch.log(torch.tensor([lo, hi], dtype=torch.float32,
                                  device=device))
    return torch.exp(linspace_f32(logs[0], logs[1], points, device=device))


def _first_two(scores):
    """(R, C) -> (argmin (R,), second-best minus best (R,))."""
    two = torch.topk(scores, 2, dim=1, largest=False).values
    return torch.argmin(scores, dim=1), two[:, 1] - two[:, 0]


def _choose(Wn, hdr, n_levels, cand_levels, exact, margins):
    """BCchoice per row: (best (R,), margin (R,) or None), the margin
    relative to the row's weighted energy sum hd * Wn^2."""
    R = Wn.shape[0]
    if exact:
        scores = _score_candidates_exact(Wn, hdr, cand_levels)
        best, gap = _first_two(scores)
        energy = torch.sum(torch.broadcast_to(hdr, Wn.shape) * Wn * Wn, 1)
        return best, (gap / energy if margins else None)
    bins = HIST_BINS_PER_LEVEL * n_levels
    s0, s1, s2, centers = _row_hist_stats(Wn, hdr, n_levels, bins)
    step = max(1, SCORE_CHUNK // len(cand_levels))
    best, gap = [], []
    for r in range(0, R, step):
        sl = slice(r, r + step)
        scores = _score_candidates_hist(s0[sl], s1[sl], s2[sl], centers,
                                        cand_levels)
        if margins:
            b, g = _first_two(scores)
            gap.append(g)
        else:
            b = torch.argmin(scores, dim=1)
        best.append(b)
    best = torch.cat(best)
    return best, (torch.cat(gap) / s2.sum(1) if margins else None)


def gptqt_quantize(Wt, H, *, bits=3, intermediate_bits=5,
                   reexplore_range=1, reexplore_points=33,
                   max_candidates=4096, exact=False, percdamp=0.01,
                   actorder=True, group_size=0,
                   orig_dtype="bfloat16", margins=False) -> GPTQTResult:
    """Wt (N_out, K_in) fp32; H (K, K), on one device. Full GPTQT
    pipeline. `group_size > 0` fits an independent (grid, BCchoice,
    re-explored scale) per contiguous K-group; it must divide K."""
    dev = Wt.device
    Wt = Wt.float()
    N, K = Wt.shape
    n, k = intermediate_bits, bits
    n_levels = 2 ** n
    hd = torch.clamp(torch.diagonal(H.float()), min=1e-12)

    # fold groups into rows: R = N*G rows, one per (row, group) pair
    Wr, G = group_rows(Wt, group_size)                   # (R, Kg)
    R, Kg = Wr.shape
    # per-(row,group) diag-H weights: group g sees hd columns [g*Kg, ...)
    hdr = hd.reshape(G, Kg).repeat(N, 1) if G > 1 else hd

    with stage("bc_choice"):
        # ---- step 1: linear grid ----
        S0, center = row_grid(Wr, n)

        # ---- step 2: BCchoice search at S0 ----
        E, J = enumerate_bc_choices(n, k, max_candidates=max_candidates)
        E, J = E.to(dev), J.to(dev)
        cand_levels = choice_levels_int(E, J, k)             # (C, 2^k)
        Wn = (Wr - center[:, None]) / S0[:, None] + (n_levels - 1) / 2.0
        best, choice_margin = _choose(Wn, hdr, n_levels, cand_levels, exact,
                                      margins)
        ce, cj = E[best], J[best]                            # (R,k), (R,)

    with stage("reexplore"):
        # ---- re-explore scale (Eq. 7), choice fixed, per (row, group) ----
        mults = _mult_grid(reexplore_range, n, reexplore_points, dev)
        combos = _combos(k, dev)                             # (L, k)
        off = (n_levels - 1) / 2.0
        row_levels_int = cj[:, None] + (torch.sum(ce, 1)[:, None]
                                        + ce @ combos.T) / 2.0
        sorted_rl = torch.sort(row_levels_int, dim=1).values
        mids = (sorted_rl[:, 1:] + sorted_rl[:, :-1]) / 2.0
        hdr2 = torch.broadcast_to(hdr, Wr.shape)

        def mult_err(m):
            Wm = (Wr - center[:, None]) / (S0 * m)[:, None] + off
            # count of mids strictly below each weight
            idx = torch.searchsorted(mids, Wm.contiguous(), side="left")
            q = torch.gather(sorted_rl, 1, idx)
            d = (Wm - q) * (S0 * m)[:, None]                 # back to float domain
            return torch.sum(d * d * hdr2, dim=1)            # (R,)

        errs = torch.stack([mult_err(m) for m in mults])     # (M, R)
        mi = torch.argmin(errs, dim=0)                       # (R,)
        mult_margin = None
        if margins:
            energy = torch.sum(hdr2 * Wr * Wr, dim=1)
            mult_margin = (_first_two(errs.T)[1] / energy if len(mults) > 1
                           else torch.full_like(energy, torch.inf))
        mult = mults[mi]
        S = S0 * mult                                        # (R,)

        # ---- final float levels, computed EXACTLY as fused dequant does ----
        alphas = (ce / 2.0) * S[:, None]                     # (R, k)
        beta = (cj + torch.sum(ce, 1) / 2.0 - off) * S + center  # (R,)
        levels = beta[:, None] + alphas @ combos.T           # (R, 2^k)

    with stage("solve"):
        # ---- GPTQ solve against the fused grid(s) ----
        solved = gptq_solve(Wt, H, levels.reshape(N, G, -1), percdamp=percdamp,
                            actorder=actorder, margins=margins)
        wq_t, idx = solved[0], solved[1]

    with stage("pack"):
        # ---- pack: combo index IS the sign pattern ----
        shifts = torch.arange(k, dtype=torch.int32, device=dev)
        signs = ((idx[:, :, None] >> shifts) & 1) > 0        # (N, K, k)
        codes = pack_signs(signs.permute(2, 1, 0))           # (k, K/32, N)
        qt = QuantizedTensor(
            codes=codes,
            alphas=alphas.reshape(N, G, k).transpose(0, 1).contiguous(),
            betas=beta.reshape(N, G).T.contiguous(),
            k_in=K, orig_dtype=orig_dtype)

    def shaped(x):
        """(R, ...) -> (N, ...) for G=1, (N, G, ...) for grouped runs."""
        return x.reshape(N, G, *x.shape[1:]) if G > 1 else x
    return GPTQTResult(
        qt=qt, wq_t=wq_t, levels=shaped(levels), choice_e=shaped(ce),
        choice_j=shaped(cj), scale=shaped(S), center=shaped(center),
        mult=shaped(mult), group_size=int(group_size),
        choice_margin=shaped(choice_margin) if margins else None,
        mult_margin=shaped(mult_margin) if margins else None,
        level_margin=solved[2] if margins else None)
