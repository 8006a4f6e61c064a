"""Format and Hopper constants, and the device rule every entry point
follows.

  WORD        sign bits packed per uint32 word along K. A format
              constant of the packed artifacts (bit j of word w is K
              index w*32 + j), so it carries over from the reference.
  WARP        threads per warp on NVIDIA GPUs.
  GEMV_ROWS   largest activation row count served by the decode-shaped
              BCQ kernel (the reference's 8-row gemv tile).
  GEMM_COLS   weight columns per block of the tensor-core BCQ GEMM
              (csrc/bcq_matmul.cu): two warpgroups, each the 64-row M
              side of a wgmma.
  GEMM_TILE_MAX  widest token tile of that GEMM (the N side of its
              wgmmas); more tokens split over blocks along M.
  GEMM_PAIRED_TILE  widest token tile that runs two GEMM blocks an SM.
  ATTN_WARPS  warps per (sequence, KV head, query-head group) block of
              the paged-attention kernels (csrc/paged_attention.cu).

The GEMM_* constants are the GEMM kernel's own: the build passes them to
nvcc (kernels/build.py), and the launch arithmetic reads them here.
ATTN_WARPS documents the paged-attention kernels' block size, which
their source fixes.
"""
from __future__ import annotations

import torch

WORD = 32
WARP = 32
GEMV_ROWS = 8
GEMM_COLS = 128
GEMM_TILE_MAX = 128
GEMM_PAIRED_TILE = 32
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
