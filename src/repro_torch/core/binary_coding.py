"""Binary-coding quantization (BCQ, paper Eq. 3-4) and the BCchoice
candidate enumeration of GPTQT's second step (the reference's
`core/binary_coding.py`).

A k-bit binary coding of a row w is w ~ sum_i alpha_i b_i with
b_i in {-1,+1}: 2^k representable values m +/- d_1 +/- ... +/- d_k.

`enumerate_bc_choices(n, k)` enumerates every subset of the step-1
integer axis {0..2^n-1} expressible as such a tree: with e_i = 2*d_i
(positive integers, e_1 >= ... >= e_k) and m = (sum e_i)/2 + j, all 2^k
leaves are integers in range. The paper's example [0,1,6,7] is
(e=(5,1), j=0). The enumeration stays in numpy, line for line the
reference's: its dedupe (`np.unique(..., return_index=True)`) and
stride-sampling (`np.linspace`) decide the candidate order, and the
candidate search takes the first of equal scores.
"""
from __future__ import annotations

import itertools

import numpy as np
import torch

from repro_torch.core.rtn import group_rows


def sign_combos(bits: int) -> np.ndarray:
    """(2^k, k) array of {-1,+1}: combo c uses sign of bit i of c."""
    c = np.arange(2 ** bits)[:, None]
    return (2 * ((c >> np.arange(bits)[None, :]) & 1) - 1).astype(np.float32)


def _combos(bits: int, device) -> torch.Tensor:
    return torch.from_numpy(sign_combos(bits)).to(device)


def enumerate_bc_choices(intermediate_bits: int, bits: int,
                         max_candidates: int | None = None):
    """Returns (E (C, k) float32 of e_i values, J (C,) float32 offsets)
    as CPU tensors. Candidate level sets in the int domain:
    j + (t + combos @ e) / 2."""
    top = 2 ** intermediate_bits - 1
    es, js = [], []
    # e_1 >= e_2 >= ... >= e_k >= 1, sum <= top
    for e in itertools.combinations_with_replacement(range(1, top + 1), bits):
        e = tuple(sorted(e, reverse=True))
        t = sum(e)
        if t > top:
            continue
        for j in range(top - t + 1):
            es.append(e)
            js.append(j)
    E = np.asarray(es, np.float32)
    J = np.asarray(js, np.float32)
    # dedupe identical level sets (degenerate e's can coincide)
    combos = sign_combos(bits)
    levels = J[:, None] + (E.sum(1)[:, None] + E @ combos.T) / 2.0
    key = np.unique(np.sort(levels, axis=1), axis=0, return_index=True)[1]
    E, J = E[np.sort(key)], J[np.sort(key)]
    if max_candidates is not None and len(E) > max_candidates:
        # keep a spread: sort by (span, offset) and stride-sample
        idx = np.linspace(0, len(E) - 1, max_candidates).astype(int)
        E, J = E[idx], J[idx]
    return torch.from_numpy(np.ascontiguousarray(E)), \
        torch.from_numpy(np.ascontiguousarray(J))


def choice_levels_int(E, J, bits: int):
    """(C, k), (C,) -> (C, 2^k) int-domain level values (combo order)."""
    combos = _combos(bits, E.device)                     # (2^k, k)
    return J[:, None] + (torch.sum(E, dim=1)[:, None] + E @ combos.T) / 2.0


# --------------------------------------------------------------------------
# BCQ baseline (Kwon et al.): greedy + alternating least squares.
# `group_size > 0` fits an independent coding per contiguous K-group;
# groups fold into rows (core/rtn.group_rows), so the per-row solvers
# batch over (row, group) pairs; alphas then carry the group axis
# (N, G, bits).
# --------------------------------------------------------------------------

def bcq_greedy(Wt, bits: int):
    """Eq. 3: residual sign coding. Wt (N, K) -> alphas (N, bits),
    signs (bits, N, K)."""
    r = Wt.float()
    alphas, signs = [], []
    for _ in range(bits):
        b = torch.where(r >= 0, 1.0, -1.0)
        a = torch.mean(torch.abs(r), dim=1)              # = r.b / K
        signs.append(b)
        alphas.append(a)
        r = r - a[:, None] * b
    return torch.stack(alphas, 1), torch.stack(signs, 0)


def bcq_alternating(Wt, bits: int, iters: int = 15, group_size: int = 0):
    """Eq. 4: alternately refit alphas by least squares and reassign signs
    by nearest representable level. Returns (Wq, alphas, signs) with
    Wq (N, K), signs (bits, N, K) and alphas (N, bits) — or, with
    `group_size > 0`, one coding per contiguous K-group and alphas
    carrying the group axis (N, G, bits)."""
    if group_size:
        Wg, G = group_rows(Wt, group_size)
        wq, alphas, signs = bcq_alternating(Wg, bits, iters)
        N, K = Wt.shape
        return (wq.reshape(N, K), alphas.reshape(N, G, bits),
                signs.reshape(bits, N, K))
    alphas, signs = bcq_greedy(Wt, bits)
    combos = _combos(bits, Wt.device)                    # (L, k)
    eye = torch.eye(bits, dtype=torch.float32, device=Wt.device)
    for _ in range(iters):
        # refit alphas: per-row LS  (B^T B) a = B^T w
        G = torch.einsum("ink,jnk->nij", signs, signs)   # (N, k, k)
        rhs = torch.einsum("ink,nk->ni", signs, Wt)      # (N, k)
        G = G + 1e-6 * eye
        alphas = torch.linalg.solve(G, rhs[..., None])[..., 0]
        alphas = torch.abs(alphas)                       # canonical sign
        # reassign: nearest of the 2^k levels
        levels = combos @ alphas.T                       # (L, N)
        idx = torch.argmin(
            torch.abs(Wt[None] - levels[:, :, None]), dim=0)   # (N, K)
        signs = combos[idx].permute(2, 0, 1)             # (k, N, K)
    wq = torch.einsum("ink,ni->nk", signs, alphas)
    return wq, alphas, signs


def bcq_levels(Wt, bits: int, iters: int = 15, group_size: int = 0):
    """Level values of the BCQ-fit grid (for GPTQ+BCQ, Tab. V):
    (N, 2^k), or (N, G, 2^k) with `group_size > 0`."""
    _, alphas, _ = bcq_alternating(Wt, bits, iters, group_size=group_size)
    return alphas @ _combos(bits, Wt.device).T           # (N[, G], 2^k)
