"""Bitplane packing for binary-coded weights (bit-exact with the
reference's `quant/packing.py`).

Sign tensors s in {-1,+1} of shape (..., bits, K, N) are stored as
32-bit words packed along K (the contraction dim): bit j of word w
covers K index w*32 + j, and a 1 bit means +1. K is padded to a
multiple of 32 with zeros (-1 signs); `k_in` on QuantizedTensor masks
the pad out of dequantization.

PyTorch has no shift or mask arithmetic on uint32, so the port holds
code words as int32 tensors with the identical bit pattern
(`codes_from_numpy` / `codes_to_numpy` convert at the numpy boundary).
`(w >> j) & 1` is bit j for every j in 0..31 under the arithmetic shift
of int32, so nothing else changes.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.hw import WORD


def padded_k(k: int) -> int:
    return -(-k // WORD) * WORD


def codes_from_numpy(arr) -> torch.Tensor:
    """uint32 (or int32) numpy code words -> int32 tensor, same bits."""
    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:          # e.g. a view of a jax array
        arr = arr.copy()
    if arr.dtype not in (np.uint32, np.int32):
        raise TypeError(f"code words must be uint32, got {arr.dtype}")
    return torch.from_numpy(arr.view(np.int32))


def codes_to_numpy(codes: torch.Tensor) -> np.ndarray:
    """int32 code tensor -> uint32 numpy words, same bits."""
    return codes.detach().cpu().numpy().view(np.uint32)


def _words(bits01: torch.Tensor) -> torch.Tensor:
    """(..., 32) 0/1 along the last axis -> int32 words (bit j = index j)."""
    shifts = torch.arange(WORD, dtype=torch.int64, device=bits01.device)
    w = torch.sum(bits01.to(torch.int64) << shifts, dim=-1)
    w = torch.where(w >= 2 ** 31, w - 2 ** 32, w)     # wrap to int32
    return w.to(torch.int32)


def _bits(words: torch.Tensor) -> torch.Tensor:
    """int32 words (...,) -> 0/1 int32 (..., 32), bit j at index j."""
    shifts = torch.arange(WORD, dtype=torch.int32, device=words.device)
    return (words[..., None] >> shifts) & 1


def pack_signs(signs: torch.Tensor) -> torch.Tensor:
    """signs: (..., bits, K, N) bool/int (truthy = +1) -> int32 words
    (..., bits, ceil(K/32), N)."""
    s = signs if signs.dtype == torch.bool else signs > 0
    *lead, bits, K, N = s.shape
    Kp = padded_k(K)
    if Kp != K:
        pad = torch.zeros((*lead, bits, Kp - K, N), dtype=torch.bool,
                          device=s.device)
        s = torch.cat([s, pad], dim=-2)
    s = s.reshape(*lead, bits, Kp // WORD, WORD, N).transpose(-1, -2)
    return _words(s)


def unpack_signs(codes: torch.Tensor, k_in: int) -> torch.Tensor:
    """codes: (..., bits, K/32, N) int32 words -> float32 signs
    (..., bits, k_in, N)."""
    *lead, bits, KW, N = codes.shape
    b = _bits(codes.transpose(-1, -2))               # (..., bits, N, KW, 32)
    b = b.reshape(*lead, bits, N, KW * WORD).transpose(-1, -2)[..., :k_in, :]
    return (2.0 * b - 1.0).to(torch.float32)


def pack_signs_last(signs: torch.Tensor) -> torch.Tensor:
    """Pack along the LAST axis: signs (..., K) bool/int (truthy = +1)
    -> int32 words (..., K/32). K must be a multiple of 32."""
    s = signs if signs.dtype == torch.bool else signs > 0
    *lead, K = s.shape
    if K % WORD:
        raise ValueError(f"pack_signs_last needs K % {WORD} == 0, got {K}")
    return _words(s.reshape(*lead, K // WORD, WORD))


def unpack_signs_last(codes: torch.Tensor) -> torch.Tensor:
    """codes (..., K/32) int32 words -> float32 signs (..., K)."""
    *lead, KW = codes.shape
    b = _bits(codes).reshape(*lead, KW * WORD)
    return (2.0 * b - 1.0).to(torch.float32)
