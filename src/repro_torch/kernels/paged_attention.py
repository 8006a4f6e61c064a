"""Wrapper of the paged-attention decode kernel
(csrc/paged_attention.cu), replacing the reference's Pallas
`kernels/paged_attention.py:paged_attention`.

q (B, Hkv, rep, hd); k_pages/v_pages (P, page, Hkv, hd) in q's dtype;
block_tables (B, T) int32 page ids; ctx_lens (B,) int32 live tokens per
sequence (including the token just written). Returns (B, Hkv, rep, hd)
in q.dtype. Unused table slots must hold a valid page id (the allocator
keeps them 0, the null page); tokens are masked by index.

A CUDA tensor launches the kernel (or raises); a CPU tensor runs the
plain version, `ref.paged_attention_ref`. `LAUNCHES` counts kernel
launches only.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import paged_attention_ref

LAUNCHES = {"paged_attention": 0}
HEAD_DIMS = (32, 64, 128, 256)
MAX_REP = 8

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# paged_attention_launch(q, k_pages, v_pages, block_tables, ctx_lens, out,
#                        B, Hkv, rep, hd, page, n_table, scale, window, cap,
#                        bf16, stream)
_ARGS = [_P] * 6 + [_I] * 6 + [_F, _I, _F, _I, _P]


def paged_attention(q, k_pages, v_pages, block_tables, ctx_lens, *,
                    window=None, cap=None):
    if (window is not None and window < 1) or (cap is not None and cap <= 0):
        raise ValueError(f"window={window} / cap={cap}: want window >= 1 "
                         f"and cap > 0 (or None)")
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pages, v_pages, block_tables,
                                   ctx_lens, window=window, cap=cap)
    if q.device.type != "cuda":
        raise ValueError(f"q on {q.device}: the kernel runs on CUDA tensors")
    B, Hkv, rep, hd = q.shape
    P, page, hk, hdk = k_pages.shape
    if (hk, hdk) != (Hkv, hd) or tuple(v_pages.shape) != tuple(k_pages.shape):
        raise ValueError(f"pages {tuple(k_pages.shape)}/"
                         f"{tuple(v_pages.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if block_tables.dim() != 2 or block_tables.shape[0] != B \
            or tuple(ctx_lens.shape) != (B,):
        raise ValueError(f"block_tables {tuple(block_tables.shape)} / "
                         f"ctx_lens {tuple(ctx_lens.shape)} for batch {B}")
    if hd not in HEAD_DIMS or not 1 <= rep <= MAX_REP:
        raise ValueError(f"head_dim {hd} / rep {rep}: the kernel takes "
                         f"head_dim in {HEAD_DIMS} and rep <= {MAX_REP}")
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError(f"q/k/v dtypes {q.dtype}/{k_pages.dtype}/"
                        f"{v_pages.dtype}: one of fp32 or bf16 for all")
    if block_tables.dtype != torch.int32 or ctx_lens.dtype != torch.int32:
        raise TypeError("block_tables and ctx_lens must be int32")
    ts = (q, k_pages, v_pages, block_tables, ctx_lens)
    if any(t.device != q.device for t in ts):
        raise ValueError("all operands must be on q's device")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("all operands must be contiguous")
    out = torch.empty_like(q)
    fn = build.function("paged_attention", "paged_attention_launch", _ARGS)
    status = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                block_tables.data_ptr(), ctx_lens.data_ptr(), out.data_ptr(),
                B, Hkv, rep, hd, page, block_tables.shape[1], hd ** -0.5,
                -1 if window is None else int(window),
                -1.0 if cap is None else float(cap),
                int(q.dtype == torch.bfloat16),
                torch.cuda.current_stream(q.device).cuda_stream)
    build.check(status, "paged_attention")
    LAUNCHES["paged_attention"] += 1
    return out
