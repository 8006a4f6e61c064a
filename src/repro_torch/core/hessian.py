"""Calibration Hessian accumulation, H = 2 X X^T (the reference's
`core/hessian.py`).

X is a layer's *input* matrix; the rows of W quantize independently, so
one (K, K) Hessian serves every output channel. `HessianAccumulator`
folds each activation batch into a running fp32 (K, K) sum as it is
captured, so calibration holds O(K^2) per tracked weight whatever the
number of batches; `hessian_from_inputs` is the one-shot wrapper.
Everything runs on the device of the activations it is given.
"""
from __future__ import annotations

import torch


class HessianAccumulator:
    """Streaming H = (2/n) * sum_i x_i x_i^T over activation batches.

    update() folds one (..., K) activation tensor into the running fp32
    (K, K) sum; finalize() returns (H, n). The sum lives on the device
    of the first batch; n counts every row given, zero rows included.
    """

    def __init__(self, k: int):
        self.k = int(k)
        self._H = None
        self.n = 0

    def update(self, x) -> None:
        x = x.reshape(-1, self.k).float()
        if self._H is None:
            self._H = torch.zeros((self.k, self.k), dtype=torch.float32,
                                  device=x.device)
        self._H += 2.0 * (x.T @ x)
        self.n += x.shape[0]

    def finalize(self):
        """-> (H (K, K) fp32 averaged over samples, n rows seen)."""
        if self._H is None:
            return torch.zeros((self.k, self.k), dtype=torch.float32), 0
        return self._H / max(self.n, 1), self.n


def hessian_from_inputs(xs):
    """xs: iterable of (T_i, K) activation matrices -> (H (K,K) fp32, n)."""
    acc = None
    for x in xs:
        if acc is None:
            acc = HessianAccumulator(x.shape[-1])
        acc.update(x)
    if acc is None:
        raise ValueError("hessian_from_inputs: no activation batches")
    return acc.finalize()


def damp(H, percdamp: float = 0.01):
    """GPTQ-style damping and dead-column handling. Returns (H, dead
    mask): a dead column (diagonal <= 0) gets a unit diagonal, then
    every diagonal gains percdamp x the mean diagonal, the mean taken
    over all K entries with the dead ones counted as 0."""
    diag = torch.diagonal(H)
    dead = diag <= 0.0
    H = H + torch.diag(dead.to(H.dtype))
    lam = percdamp * torch.mean(torch.where(dead, 0.0, diag))
    H = H + lam * torch.eye(H.shape[0], dtype=H.dtype, device=H.device)
    return H, dead
