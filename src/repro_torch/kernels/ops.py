"""Dispatch for the binary-coded matmul (the reference's
`kernels/ops.py:bcq_apply`).

`bcq_apply(x, qt)` is what `layers.linear` calls for QuantizedTensor
weights. It zero-pads x to the packed K (the pad bits are -1 signs and
cancel only against zeros), then sends at most `GEMV_ROWS` rows to the
decode-shaped kernel and more rows to the GEMM — on a CUDA tensor the
hand-written kernels, on a CPU tensor their plain versions. A
single-axis expert stack (codes (E, bits, K/32, N)) with a matching
batched activation (E, C, k_in) goes to the batched-expert kernel, one
launch for the whole stack; its optional `rows` (E,) int32 names the
live leading rows of each expert (the rest count as zero). Groupings
the kernels do not take (a group size that is not a multiple of the
32-bit word, the reference's `_kernel_groups_ok`) and deeper or
mismatched stacks go through the plain dequantize-then-matmul path on
any device, as the reference sends them to its jnp path; `PLAIN_CALLS`
counts them.
"""
from __future__ import annotations

import torch

from repro_torch.hw import GEMV_ROWS, WORD
from repro_torch.kernels import ref
from repro_torch.kernels.bcq_matmul import (bcq_expert_matmul, bcq_gemv,
                                            bcq_matmul, mask_rows)

PLAIN_CALLS = {"bcq_plain": 0}


def _kernel_groups_ok(qt) -> bool:
    """G > 1 runs the fused kernel iff groups tile the packed K axis:
    group_size divides k_in AND is a multiple of the 32-bit pack word,
    which together mean k_in is already word-aligned."""
    G = qt.alphas.shape[-3]
    if G == 1:
        return True
    return qt.k_in % G == 0 and (qt.k_in // G) % WORD == 0


def _active_codes(qt):
    """Code planes the tensor's scales actually weight (a leading-plane
    view when fewer alphas than stored planes; no copy)."""
    if qt.bits == qt.stored_bits:
        return qt.codes
    return qt.codes[..., : qt.bits, :, :]


def _pad_k(x, qt, codes):
    """x zero-padded along its last axis to the packed K."""
    kp = codes.shape[-2] * WORD
    if kp != qt.k_in:
        x = torch.nn.functional.pad(x, (0, kp - qt.k_in))
    return x.contiguous()


def bcq_apply(x, qt, rows=None):
    """x (..., k_in) @ QuantizedTensor -> (..., n_out). `rows` (E,)
    int32, for a batched expert stack only: live leading rows of each
    x[e]."""
    codes = _active_codes(qt)
    lead = codes.shape[:-3]
    batched = len(lead) == 1 and x.dim() == 3 and x.shape[0] == lead[0]
    if rows is not None and not batched:
        raise ValueError("rows is given for a batched expert stack only")
    if lead:                      # expert stacks
        if batched and _kernel_groups_ok(qt):
            return bcq_expert_matmul(_pad_k(x, qt, codes), codes, qt.alphas,
                                     qt.betas, rows)
        PLAIN_CALLS["bcq_plain"] += 1
        eq = "eck,ekn->ecn" if batched else "...k,...kn->...n"
        return torch.einsum(eq, mask_rows(x, rows) if batched else x,
                            qt.dequant(x.dtype))
    if not _kernel_groups_ok(qt):
        PLAIN_CALLS["bcq_plain"] += 1
        w = ref.dequant_ref(codes, qt.alphas, qt.betas, qt.k_in,
                            dtype=x.dtype)
        return x @ w
    xm = _pad_k(x.reshape(-1, qt.k_in), qt, codes)
    fn = bcq_gemv if xm.shape[0] <= GEMV_ROWS else bcq_matmul
    y = fn(xm, codes, qt.alphas, qt.betas)
    return y.reshape(*x.shape[:-1], qt.n_out)
