"""Format and Hopper constants, and the device rule every entry point
follows.

  WORD        sign bits packed per uint32 word along K. A format
              constant of the packed artifacts (bit j of word w is K
              index w*32 + j), so it carries over from the reference.
  WARP        threads per warp on NVIDIA GPUs.
  GEMV_ROWS   largest activation row count served by the decode-shaped
              BCQ kernel (the reference's 8-row gemv tile).
  GEMM_BM/BN  output tile of the BCQ GEMM kernel (csrc/bcq_matmul.cu);
  GEMM_BK     its K step, one packed word.
  ATTN_WARPS  warps per (sequence, KV head, query-head group) block of
              the paged-attention kernels (csrc/paged_attention.cu).

The kernels' own copies of the tile sizes live in the .cu sources; the
Python side uses these only for launch arithmetic and documentation, so
the two must agree (the build keys on the sources).
"""
from __future__ import annotations

import torch

WORD = 32
WARP = 32
GEMV_ROWS = 8
GEMM_BM = 64
GEMM_BN = 64
GEMM_BK = WORD
ATTN_WARPS = 8


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `cuda` unless the caller asks
    for something else. Asking for CUDA on a machine without a usable
    GPU raises — nothing falls back to the CPU silently."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the port's "
            "plain PyTorch path on the host")
    return dev


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(dtype) -> torch.dtype:
    """A config/manifest dtype name (or a torch dtype) -> torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if str(dtype) not in _DTYPES:
        raise ValueError(f"unsupported dtype {dtype!r}; expected one of "
                         f"{sorted(_DTYPES)}")
    return _DTYPES[str(dtype)]


def dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")
