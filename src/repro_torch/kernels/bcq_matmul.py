"""Wrappers of the dequant-fused binary-coded GEMM/GEMV kernels
(csrc/bcq_matmul.cu), replacing the reference's Pallas
`kernels/bcq_matmul.py:bcq_matmul`, `bcq_gemv` and `bcq_expert_matmul`.

Same interface as the reference: x (M, K) with K = 32 * codes.shape[1]
(the caller zero-pads x to the packed K); codes (bits, K/32, N) words;
alphas (G, N, bits) and betas (G, N), fp32 or bf16, with G == 1 or G
dividing K into groups whose size is a multiple of 32. Returns (M, N)
in x.dtype, accumulated in fp32, with W rounded to x.dtype before the
product as the reference kernel rounds its expanded tile.
`bcq_expert_matmul` takes the same operands with a leading expert axis
(x (E, M, K), codes (E, bits, K/32, N), alphas (E, G, N, bits), betas
(E, G, N)) and runs the whole stack in one launch of the same kernels:
each expert's slice of its output equals `bcq_gemv` / `bcq_matmul` on
that expert alone, bit for bit. Its optional `rows` (E,) int32, on x's
device, gives the number of leading rows of each x[e] that hold tokens:
rows past it are treated as zero and come out exactly zero, and the
kernels load nothing for an expert with 0 rows (None: every row, the
reference's behaviour).

The GEMV (M <= GEMV_ROWS, every decode step) is one launch with no
scratch: each block owns GEMV_COLS output columns, a lane 4 adjacent
ones; x of the block's K range is staged in shared memory and read as
16-byte broadcasts; a weight of 2-4 bits is one read of a per-column
table of its scale group's 2^bits levels (5-8 bits, and 1, expand plane
by plane); K splits over the blocks of a thread-block cluster
(`gemv_splits`, a function of (K, N) alone), whose partial sums are
added in rank order through distributed shared memory. It is bound by
instruction issue on the card (about 9 instructions a weight and lane at
4 rows), not by the code bytes; an expert holding one token computes one
row.

The GEMM (M > GEMV_ROWS) runs on tensor cores, three TF32 passes for
fp32 x and one for bf16 x, with x split into its TF32 parts once per
call (fp32 scratch the wrapper allocates). Its token tile is M rounded
up to 8 (`gemm_launch_shape`), and a K split chosen from (M, K, N)
alone fills the SMs, so an expert of a stack tiles and splits exactly as
it would alone.

A CUDA tensor launches the kernel (or raises); a CPU tensor runs the
plain version (`_bcq_matmul_plain`, `_bcq_expert_plain` below), which
is the same math in PyTorch ops; a meta tensor launches nothing and
returns an empty output of the kernel's shape, reporting the kernel's
own bytes and operations (`_meta_call`, kernels/work.py). `LAUNCHES`
counts kernel launches only.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.hw import (GEMM_COLS, GEMM_PAIRED_TILE, GEMM_TILE_MAX,
                           GEMV_COLS, GEMV_MAX_SPLITS, GEMV_ROWS,
                           GEMV_WARPS, H100_SMS, WORD, sm_count)
from repro_torch.kernels import build, work
from repro_torch.kernels.ref import dequant_ref
from repro_torch.roofline.analysis import bcq_work

LAUNCHES = {"bcq_gemv": 0, "bcq_matmul": 0, "bcq_expert_matmul": 0}
MAX_BITS = 8
# K split of the GEMV: about this many blocks per SM, and at least this
# many K words a split (two a warp)
GEMV_BLOCKS_PER_SM = 2
GEMV_MIN_WORDS_PER_SPLIT = 16
# fewest K words a split of the GEMM takes (1024 K rows)
GEMM_MIN_WORDS_PER_SPLIT = 32

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# bcq_gemv_launch(x, codes, alphas, betas, y, rows, M, KW, N, bits,
#                 plane_stride, words_per_group, splits, vec, x_bf16,
#                 scale_bf16, E, x_es, codes_es, alphas_es, betas_es, stream)
_GEMV_ARGS = [_P] * 6 + [_I] * 4 + [_L] + [_I] * 6 + [_L] * 4 + [_P]
# bcq_gemm_launch(x, xsplit, codes, alphas, betas, y, partial, rows, M,
#                 KW, N, bits, plane_stride, words_per_group, tile, ntiles,
#                 splits, x_bf16, scale_bf16, E, x_es, codes_es,
#                 alphas_es, betas_es, stream)
_GEMM_ARGS = [_P] * 8 + [_I] * 4 + [_L] + [_I] * 7 + [_L] * 4 + [_P]


def _check(x, codes, alphas, betas):
    if x.dim() != 2 or codes.dim() != 3:
        raise ValueError(f"x {tuple(x.shape)} must be (M, K) and codes "
                         f"{tuple(codes.shape)} (bits, K/32, N)")
    M, K = x.shape
    bits, KW, N = codes.shape
    if KW * WORD != K:
        raise ValueError(f"x has K={K} but codes pack {KW * WORD} rows; "
                         f"zero-pad x to the packed K")
    G = alphas.shape[0]
    nb = alphas.shape[-1]
    if tuple(alphas.shape) != (G, N, nb) or not 1 <= nb <= bits:
        raise ValueError(f"alphas {tuple(alphas.shape)} do not match codes "
                         f"{tuple(codes.shape)}")
    if tuple(betas.shape) != (G, N):
        raise ValueError(f"betas {tuple(betas.shape)} != ({G}, {N})")
    if G > 1 and (K % G or (K // G) % WORD):
        raise ValueError(f"G={G} groups of K={K}: the kernel needs G == 1 "
                         f"or a group size that is a multiple of {WORD}")
    if codes.dtype != torch.int32:
        raise TypeError(f"codes must be int32 words, got {codes.dtype}")
    return M, K, nb, KW, N, G


def _bcq_matmul_plain(x, codes, alphas, betas):
    """The kernels' plain version: dequantize the active planes over the
    packed K in fp32, round W to x.dtype, multiply in fp32."""
    K = x.shape[1]
    nb = alphas.shape[-1]
    w = dequant_ref(codes[:nb], alphas, betas, K).to(x.dtype)
    return (x.float() @ w.float()).to(x.dtype)


def _check_expert(x, codes, alphas, betas):
    if x.dim() != 3 or codes.dim() != 4 or alphas.dim() != 4 \
            or betas.dim() != 3:
        raise ValueError(f"x {tuple(x.shape)}, codes {tuple(codes.shape)}, "
                         f"alphas {tuple(alphas.shape)}, betas "
                         f"{tuple(betas.shape)}: want (E, M, K), "
                         f"(E, bits, K/32, N), (E, G, N, bits), (E, G, N)")
    E = x.shape[0]
    if not (codes.shape[0] == alphas.shape[0] == betas.shape[0] == E):
        raise ValueError(f"expert counts differ: x {E}, codes "
                         f"{codes.shape[0]}, alphas {alphas.shape[0]}, "
                         f"betas {betas.shape[0]}")
    return _check(x[0], codes[0], alphas[0], betas[0])


def mask_rows(x, rows):
    """x (E, M, K) with the rows of each expert past rows[e] zeroed
    (x itself when rows is None)."""
    if rows is None:
        return x
    live = torch.arange(x.shape[1], device=x.device) < rows[:, None]
    return torch.where(live[..., None], x, torch.zeros((), dtype=x.dtype,
                                                       device=x.device))


def _bcq_expert_plain(x, codes, alphas, betas, rows=None):
    """The expert kernel's plain version: rows past rows[e] zeroed, then
    each expert through `_bcq_matmul_plain` (one expert's W in memory at
    a time)."""
    return torch.stack([_bcq_matmul_plain(*t) for t in
                        zip(mask_rows(x, rows), codes, alphas, betas)])


def _launch_args(x, codes, alphas, betas, rows=None):
    """Checks of a launch on the (E, ...) stacked operands; returns
    (E, M, nb, KW, N, words_per_group, plane stride, per-expert
    strides of x, codes, alphas, betas)."""
    E = x.shape[0]
    M, K, nb, KW, N, G = _check(x[0], codes[0], alphas[0], betas[0])
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"x on {dev}: the kernel runs on CUDA tensors")
    if M < 1 or E < 1:
        raise ValueError("x has no rows")
    for name, t in (("codes", codes), ("alphas", alphas), ("betas", betas)):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, x on {dev}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x dtype {x.dtype}: the kernel takes fp32 or bf16")
    if alphas.dtype != betas.dtype or alphas.dtype not in (torch.float32,
                                                           torch.bfloat16):
        raise TypeError(f"scales {alphas.dtype}/{betas.dtype}: the kernel "
                        f"takes fp32 or bf16, one dtype for both")
    if nb > MAX_BITS:
        raise ValueError(f"{nb} active bits > {MAX_BITS}")
    if not (x.is_contiguous() and alphas.is_contiguous()
            and betas.is_contiguous() and codes.stride(-1) == 1
            and codes.stride(-2) == N):
        raise ValueError("x, alphas, betas and each code plane must be "
                         "contiguous")
    if E > 65535:
        raise ValueError(f"{E} experts > 65535 (the grid's z extent)")
    if rows is not None and (rows.dtype != torch.int32
                             or tuple(rows.shape) != (E,)
                             or rows.device != dev
                             or not rows.is_contiguous()):
        raise ValueError(f"rows must be a contiguous ({E},) int32 tensor "
                         f"on {dev}, got {tuple(rows.shape)} {rows.dtype} "
                         f"on {rows.device}")
    wpg = 0 if G == 1 else (K // G) // WORD
    es = (x.stride(0), codes.stride(0), alphas.stride(0), betas.stride(0))
    return E, M, nb, KW, N, wpg, codes.stride(1), es


@functools.lru_cache(maxsize=None)
def gemv_splits(KW, N, sms=H100_SMS) -> int:
    """K splits of the GEMV for one (K/32 = KW, N) matrix: the blocks of
    one thread-block cluster (at most GEMV_MAX_SPLITS), each taking at
    least GEMV_MIN_WORDS_PER_SPLIT words. Of those, the split whose
    busiest block slot (GEMV_BLOCKS_PER_SM an SM over ceil(N / GEMV_COLS)
    column blocks) runs the fewest rounds of a word per warp (waves x
    rounds a block), the fewest blocks on a tie; no split is left without
    words. A function of the matrix alone, never of the expert count, so
    every expert of a stack splits (and sums) as it would alone."""
    col_blocks = -(-N // GEMV_COLS)
    slots = GEMV_BLOCKS_PER_SM * sms
    most = max(1, min(GEMV_MAX_SPLITS, KW // GEMV_MIN_WORDS_PER_SPLIT))
    splits = min(range(1, most + 1),
                 key=lambda s: (-(-col_blocks * s // slots)
                                * -(-(-(-KW // s)) // GEMV_WARPS), s))
    return -(-KW // -(-KW // splits))


def gemm_launch_shape(M, KW, N, sms=H100_SMS):
    """(tile, ntiles, splits) of the tensor-core GEMM for one (M, K, N)
    matrix: M rows in ntiles token tiles of `tile` rows (a multiple of
    8, at most GEMM_TILE_MAX, so each tile wastes fewer than 8 rows),
    and a K split of at least GEMM_MIN_WORDS_PER_SPLIT words each. An
    SM holds two blocks of a tile of up to GEMM_PAIRED_TILE rows, else
    one. The split is the smallest that fills those slots (or the most
    the words allow), raised while that shortens the busiest slot's K
    loop (waves x words per split). A function of (M, K, N) alone,
    never of the expert count, so an expert of a stack runs exactly as
    it would alone."""
    ntiles = -(-M // GEMM_TILE_MAX)
    tile = -(-(-(-M // ntiles)) // 8) * 8
    slots = sms * (2 if tile <= GEMM_PAIRED_TILE else 1)
    blocks = -(-N // GEMM_COLS) * ntiles
    most = max(1, KW // GEMM_MIN_WORDS_PER_SPLIT)
    least = min(most, -(-slots // blocks))
    splits = min(range(least, most + 1),
                 key=lambda s: (-(-blocks * s // slots) * -(-KW // s), s))
    splits = -(-KW // -(-KW // splits))  # no split left without words
    return tile, ntiles, splits


def _stream(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def _gemv(x, codes, alphas, betas, rows=None):
    """Launch the GEMV body on (E, M <= GEMV_ROWS, K) stacked operands:
    one launch, no scratch."""
    E, M, nb, KW, N, wpg, ps, es = _launch_args(x, codes, alphas, betas,
                                                rows)
    if not 1 <= M <= GEMV_ROWS:
        raise ValueError(f"bcq_gemv takes 1..{GEMV_ROWS} rows, got {M}")
    splits = gemv_splits(KW, N, sm_count(x.device))
    # 16-byte code loads: 4 columns a lane, every plane and expert aligned
    vec = int(N % 4 == 0 and codes.data_ptr() % 16 == 0 and ps % 4 == 0
              and es[1] % 4 == 0)
    y = torch.empty((E, M, N), dtype=x.dtype, device=x.device)
    fn = build.function("bcq_matmul", "bcq_gemv_launch", _GEMV_ARGS)
    status = fn(x.data_ptr(), codes.data_ptr(), alphas.data_ptr(),
                betas.data_ptr(), y.data_ptr(), _ptr(rows), M, KW, N, nb, ps,
                wpg, splits, vec, int(x.dtype == torch.bfloat16),
                int(alphas.dtype == torch.bfloat16), E, *es, _stream(x))
    build.check(status, "bcq_gemv")
    return y


def _gemm(x, codes, alphas, betas, rows=None):
    """Launch the tensor-core GEMM body on (E, M, K) stacked operands."""
    E, M, nb, KW, N, wpg, ps, es = _launch_args(x, codes, alphas, betas,
                                                rows)
    tile, ntiles, splits = gemm_launch_shape(M, KW, N, sm_count(x.device))
    y = torch.empty((E, M, N), dtype=x.dtype, device=x.device)
    partial = (torch.empty((E, splits, M, N), dtype=torch.float32,
                           device=x.device) if splits > 1 else y)
    # the TF32 parts of x: hi and lo (hi alone for bf16 x)
    parts = 1 if x.dtype == torch.bfloat16 else 2
    xsplit = torch.empty(parts * x.numel(), dtype=torch.float32,
                         device=x.device)
    fn = build.function("bcq_matmul", "bcq_gemm_launch", _GEMM_ARGS)
    status = fn(x.data_ptr(), xsplit.data_ptr(), codes.data_ptr(),
                alphas.data_ptr(), betas.data_ptr(), y.data_ptr(),
                partial.data_ptr(), _ptr(rows), M, KW, N, nb, ps, wpg, tile,
                ntiles, splits,
                int(x.dtype == torch.bfloat16),
                int(alphas.dtype == torch.bfloat16), E, *es, _stream(x))
    build.check(status, "bcq_matmul")
    return y


def _meta_call(name, x, codes, alphas):
    """A call on meta tensors: the kernel's work reported (every row of
    every expert: a meta tensor holds no routing), its output (E, M, N)
    or (M, N) empty in x.dtype, nothing launched."""
    if any(t.device != x.device for t in (codes, alphas)):
        raise ValueError(f"x on meta, codes on {codes.device}, alphas on "
                         f"{alphas.device}: all operands on one device")
    *lead, M, K = x.shape
    G, N, nb = alphas.shape[-3:]
    E = lead[0] if lead else 1
    work.report(name, bcq_work(M, K, N, nb, G, E=E,
                               x_itemsize=x.element_size(),
                               scale_itemsize=alphas.element_size()))
    return torch.empty((*lead, M, N), dtype=x.dtype, device=x.device)


def bcq_gemv(x, codes, alphas, betas):
    """Decode-shaped entry: M <= GEMV_ROWS rows."""
    _check(x, codes, alphas, betas)
    if x.device.type == "cpu":
        return _bcq_matmul_plain(x, codes, alphas, betas)
    if x.device.type == "meta":
        return _meta_call("bcq_gemv", x, codes, alphas)
    y = _gemv(x[None], codes[None], alphas[None], betas[None])[0]
    LAUNCHES["bcq_gemv"] += 1
    work.note_launch("bcq_gemv", (*x.shape, codes.shape[-1]))
    return y


def bcq_matmul(x, codes, alphas, betas):
    """GEMM entry (any M; the dispatcher sends M > GEMV_ROWS here), on
    tensor cores: 3xTF32 passes for fp32 x, one TF32 pass for bf16 x."""
    _check(x, codes, alphas, betas)
    if x.device.type == "cpu":
        return _bcq_matmul_plain(x, codes, alphas, betas)
    if x.device.type == "meta":
        return _meta_call("bcq_matmul", x, codes, alphas)
    y = _gemm(x[None], codes[None], alphas[None], betas[None])[0]
    LAUNCHES["bcq_matmul"] += 1
    work.note_launch("bcq_matmul", (*x.shape, codes.shape[-1]))
    return y


def bcq_expert_matmul(x, codes, alphas, betas, rows=None):
    """Batched-expert entry: x (E, M, K) through each expert's packed
    weight -> (E, M, N), one launch for the stack (the GEMV body for
    M <= GEMV_ROWS, the GEMM body otherwise). `rows` (E,) int32 on x's
    device, or None: the live leading rows of each expert; the rest are
    treated as zero, give exact zeros, and an expert with 0 rows loads
    nothing."""
    _check_expert(x, codes, alphas, betas)
    if x.device.type == "cpu":
        return _bcq_expert_plain(x, codes, alphas, betas, rows)
    if x.device.type == "meta":
        return _meta_call("bcq_expert_matmul", x, codes, alphas)
    fn = _gemv if x.shape[1] <= GEMV_ROWS else _gemm
    y = fn(x, codes, alphas, betas, rows)
    LAUNCHES["bcq_expert_matmul"] += 1
    work.note_launch("bcq_expert_matmul", (*x.shape, codes.shape[-1]))
    return y
