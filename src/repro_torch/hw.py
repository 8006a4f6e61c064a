"""Format and Hopper constants, and the device rule every entry point
follows.

  WORD        sign bits packed per uint32 word along K. A format
              constant of the packed artifacts (bit j of word w is K
              index w*32 + j), so it carries over from the reference.
  WARP        threads per warp on NVIDIA GPUs.
  GEMV_ROWS   largest activation row count served by the decode-shaped
              BCQ kernel (the reference's 8-row gemv tile).
  GEMV_COLS   output columns per block of that GEMV (csrc/bcq_matmul.cu):
              32 lanes of 4 adjacent columns, one 16-byte code load a
              plane.
  GEMV_WARPS  warps of a GEMV block, which take the block's K words in
              turn.
  GEMV_MAX_SPLITS  most K splits of one GEMV launch: the blocks of a
              thread-block cluster (8, the portable cluster size), which
              add their partial sums through distributed shared memory.
  GEMM_COLS   weight columns per block of the tensor-core BCQ GEMM
              (csrc/bcq_matmul.cu): two warpgroups, each the 64-row M
              side of a wgmma.
  GEMM_TILE_MAX  widest token tile of that GEMM (the N side of its
              wgmmas); more tokens split over blocks along M.
  GEMM_PAIRED_TILE  widest token tile that runs two GEMM blocks an SM.
  ATTN_TILE   tokens of one context partition of the paged-attention
              kernels (csrc/paged_attention.cu): one token a lane.
  ATTN_MAX_CLUSTER  most blocks that split one (sequence, KV head,
              query-head group) over its context: a thread-block cluster
              whose blocks merge their softmax states through
              distributed shared memory.
  ATTN_MAX_REP  most query heads of one block (wider GQA groups take
              several blocks).
  ATTN_MAX_STAGES  most partitions whose K/V a block holds (and loads)
              at once.
  ATTN_QUANT_SCALES_MAX  most bytes of one binary-coded row's alphas and
              betas that the quant reader stages in shared memory; wider
              scale rows (groups of a few entries at many bits) are read
              from the pool during the expansion.

The GEMM_*, GEMV_COLS, GEMV_WARPS and ATTN_* constants are the kernels'
own: the build passes them to nvcc (kernels/build.py), and the launch
arithmetic reads them here, with the card's SM count (`sm_count`; H100_SMS
where no card is at hand).
"""
from __future__ import annotations

import torch

WORD = 32
WARP = 32
GEMV_ROWS = 8
GEMV_COLS = 128
GEMV_WARPS = 8
GEMV_MAX_SPLITS = 8
GEMM_COLS = 128
GEMM_TILE_MAX = 128
GEMM_PAIRED_TILE = 32
ATTN_TILE = 32
ATTN_MAX_CLUSTER = 8
ATTN_MAX_REP = 16
ATTN_MAX_STAGES = 4
ATTN_QUANT_SCALES_MAX = 512


H100_SMS = 132
_SMS: dict = {}


def sm_count(device) -> int:
    """Streaming multiprocessors of a CUDA device (queried once)."""
    sms = _SMS.get(device)
    if sms is None:
        sms = _SMS[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return sms


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
