#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA
GPU, from the root of a checkout:

    python3 chip_smoke.py [--phases 1,2,3,4,5] [--seed 0]

It builds the port's CUDA kernels from `src/repro_torch/csrc/` and runs
five phases; any failure is a non-zero exit.

  1. kernels: each kernel against its plain PyTorch version on the same
     card at the main-path shapes (BCQ GEMV every M in 1..8 and the
     tensor-core GEMM M in {9,16,64,128} on 4096x4096, 4096x11008,
     11008x4096, the GEMV also on Qwen3-MoE's 4096x8192 and 4096x512,
     w3 per-channel and group 128, fp32 and bf16 scales;
     the batched-expert GEMM at E=128, M in {4,16}, 4096x1536 and
     1536x4096, also bit for bit against the single-matrix kernels
     expert by expert, with and without the rows of a routing; paged
     attention over fp and 2/3/4-bit binary-coded pages at the
     llama2-7b (Hkv 32, rep 1) and Qwen3-MoE (Hkv 4, rep 16)
     geometries, page 64, ragged contexts, window and cap, and the
     binary-coded reader over bits 1..8 x hd {32, 64, 128, 256} x G in
     {1, 2, hd/32} and its edge layouts, with windows, caps, bf16 q and
     contexts ending mid-partition), with times; after the build, the
     GEMM must hold wgmma (HGMMA in its SASS) and ptxas must report no
     spill in it, and every binary-coded attention instance must copy
     by cp.async (LDGSTS in its SASS).
  2. reference fixture: the committed artifacts (tests/data/torch_port/:
     tiny-lm w3, tiny-moe w3, and tiny-lm with 4-bit KV pages) served on
     the card through the launcher and the paged ServeEngine; logits and
     greedy tokens are held against those the JAX reference recorded;
     with 4-bit KV also the card's kv_quantize against the CPU's on the
     same K/V, and a witness line on the first prompt the fixture
     dropped for a quantize-on-write near-tie.
  3. main path at full width: seeded synthetic w3 per-channel packed
     llama2-7b (32 layers) served by the paged engine, 4 requests with
     16-100 token prompts and 32 new tokens each, with per-kernel launch
     counts.
  4. binary-coded KV at full width: phase 3's model and requests with
     4-bit KV pages (one group per head vector).
  5. MoE at full width: seeded synthetic w3 per-channel qwen3-moe-235b-a22b
     (128 experts top-8), cut to 16 of its 94 layers, 4 requests, 32 new
     tokens each, fp KV pages.

Each path (phases 3-5) is driven with every launch count set to 0 just
before it and read just after. The line before the last is
{"kernels": [...]} (one entry per ported kernel: launches on the paths,
error against the plain version, time, bound, plain and library
times); the last line is {"ok": true, "device": {...}}. It exits
non-zero without a result when no CUDA device is available or the
port's sources are missing.
"""
from __future__ import annotations

import argparse
import gc
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
FIXTURE = ROOT / "tests" / "data" / "torch_port"

# H100 SXM peaks (NVIDIA data sheet; dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12        # CUDA cores: the GEMV, attention
TF32_FLOPS = 495e12       # tensor cores: the GEMM's TF32 passes

# tolerances, relative to max|reference| of each output
TOL_FP32 = 2e-5       # fp32 sums of up to 11008 products in another order
TOL_BF16 = 1e-2       # bf16 outputs: one bf16 ulp is 2^-8 of |y|
TOL_LOGITS = 1e-4     # whole-model logits vs the reference (fixture's own)

KERNEL_ROWS = {
    "bcq_gemv": ("src/repro_torch/csrc/bcq_matmul.cu",
                 "src/repro/kernels/bcq_matmul.py:218"),
    "bcq_matmul": ("src/repro_torch/csrc/bcq_matmul.cu",
                   "src/repro/kernels/bcq_matmul.py:162"),
    "bcq_expert_matmul": ("src/repro_torch/csrc/bcq_matmul.cu",
                          "src/repro/kernels/bcq_matmul.py:229"),
    "paged_attention": ("src/repro_torch/csrc/paged_attention.cu",
                        "src/repro/kernels/paged_attention.py:145"),
    "paged_attention_quant": ("src/repro_torch/csrc/paged_attention.cu",
                              "src/repro/kernels/paged_attention.py:188"),
}
# the Qwen3-MoE depth served in phase 5: at w3 its 94 layers hold ~85 GB
# of expert codes, more than the card's 80 GB; 16 layers hold ~14.5 GB
MOE_LAYERS = 16


# the card; rehearsals of the control flow set this to "cpu"
DEV = "cuda"


def sync() -> None:
    import torch
    if DEV == "cuda":
        torch.cuda.synchronize()


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class SmokeFailure(Exception):
    pass


def require(cond, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def cuda_ms(fn, iters: int) -> float:
    """Mean milliseconds of fn() on the card over `iters` calls after a
    warm-up, by CUDA events around the whole run. This includes any
    host time between launches the card waits through."""
    import torch
    for _ in range(3):
        fn()
    if DEV != "cuda":             # control-flow rehearsal: host clock
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_ms(fn, iters: int) -> dict:
    """Device time of fn(): the summed durations of the CUDA kernels one
    call launches, from a torch.profiler trace of `iters` calls (host
    gaps excluded), beside the CUDA-event time per call. Where the trace
    holds no kernel ("device_ms" None) only the event time is known."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    event = cuda_ms(fn, iters)
    if DEV != "cuda":
        return {"device_ms": None, "event_ms": event}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    return {"device_ms": us / 1e3 / iters if us else None, "event_ms": event}


def best_ms(t: dict) -> float:
    return t["device_ms"] if t["device_ms"] is not None else t["event_ms"]


def bound_ms(n_bytes: float, flops: float, peak: float = FP32_FLOPS):
    """The least time of the work: its bytes at the HBM rate or its
    operations at `peak`, whichever is longer, and which it was."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def gemm_arithmetic(x_dtype) -> tuple:
    """The tensor-core GEMM's arithmetic for x of `x_dtype`: three TF32
    passes for fp32 x (3xTF32), one for bf16 x; (name, passes)."""
    import torch
    return ("tf32", 1) if x_dtype == torch.bfloat16 else ("tf32x3", 3)


def sass_functions(out: Path, lib: str) -> list:
    """The SASS of every kernel instance in a built library (cuobjdump
    -sass), each starting with its mangled name."""
    from repro_torch.kernels import build
    tool = Path(build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(out / f"lib{lib}.so")],
                          capture_output=True, text=True, timeout=300).stdout
    return sass.split("Function : ")[1:]


def sass_check(out: Path) -> None:
    """The tensor-core GEMM was compiled to wgmma: HGMMA instructions in
    every instance of its kernel in the built library, and ptxas reports
    no spill in any of them. Every instance of the binary-coded attention
    reader copies its rows by cp.async: LDGSTS in each."""
    funcs = sass_functions(out, "bcq_matmul")
    gemm = [f for f in funcs if "bcq_tc_gemm_kernel" in f.split("\n", 1)[0]]
    hgmma = [sum("HGMMA" in ln for ln in f.splitlines()) for f in gemm]
    gemm_spills, cur = [], ""
    for ln in (out / "bcq_matmul.log").read_text().splitlines():
        if "Compiling entry function" in ln:
            cur = ln
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m and int(m.group(1)) and "bcq_tc_gemm_kernel" in cur:
            gemm_spills.append(re.search(r"kernelILi(\d+)", cur).group(1))
    ldgsts = {}
    for f in sass_functions(out, "paged_attention"):
        name = f.split("\n", 1)[0]
        if "QuantPages" in name:
            m = re.search(r"QuantPagesILi(\d+)EE+Li(\d+)E", name)
            key = (("bf16" if "bfloat16" in name else "f32")
                   + (f"/hd{m.group(1)}/rep{m.group(2)}" if m else
                      f"/{name.strip()[:60]}"))
            ldgsts[key] = sum("LDGSTS" in ln for ln in f.splitlines())
    emit({"check": "sass", "gemm_instances": len(gemm),
          "hgmma_per_instance_min": min(hgmma) if hgmma else 0,
          "token_tiles_with_spills": gemm_spills,
          "quant_attention_instances": len(ldgsts),
          "ldgsts_per_quant_instance": ldgsts})
    require(gemm and min(hgmma) > 0, "the GEMM kernel has no HGMMA")
    require(not gemm_spills, f"the GEMM kernel spills: {gemm_spills}")
    require(ldgsts and min(ldgsts.values()) > 0,
            f"a binary-coded attention instance has no LDGSTS: {ldgsts}")


# ---------------------------------------------------------------------------
# phase 1: kernels vs plain versions
# ---------------------------------------------------------------------------

def random_qt(gen, K, N, gs, scale_dtype, bits=3, beta_scale=0.1, E=None):
    """Seeded random packed weight on the card (a stack of E experts when
    E is given): uniform code words, alphas (4,2,1)/sqrt(21) * K^-0.5
    with 10 % jitter (so W has std ~K^-0.5), small random betas."""
    import torch
    from repro_torch.quant import QuantizedTensor
    lead = () if E is None else (E,)
    G = 1 if gs == 0 else K // gs
    codes = torch.randint(-2 ** 31, 2 ** 31, (*lead, bits, K // 32, N),
                          dtype=torch.int32, generator=gen, device=DEV)
    base = torch.tensor([4.0, 2.0, 1.0][:bits], device=DEV)
    base = base / base.square().sum().sqrt() * K ** -0.5
    jitter = 1 + 0.1 * torch.rand((*lead, G, N, bits), generator=gen,
                                  device=DEV)
    alphas = (base * jitter).to(scale_dtype).contiguous()
    betas = (torch.randn((*lead, G, N), generator=gen, device=DEV)
             * beta_scale * K ** -0.5).to(scale_dtype)
    return QuantizedTensor(codes, alphas, betas, K, "float32")


LLAMA_SHAPES = [(4096, 4096), (4096, 11008), (11008, 4096)]
# Qwen3-MoE's q (4096 -> 8192) and k/v (4096 -> 512) projections: the GEMV
# only (phase 1's bcq_matmul_shape lines time the GEMM there)
QWEN_SHAPES = [(4096, 8192), (4096, 512)]
GEMV_MS = tuple(range(1, 9))
GEMM_MS = (9, 16, 64, 128)
# (M, K, N) of the GEMM beside its line: llama2-7b's prefill buckets 16
# and 64, Qwen3-MoE's k/v (N=512) and q (N=8192) projections
GEMM_SHAPES = ((16, 4096, 11008), (64, 4096, 11008), (16, 4096, 512),
               (128, 4096, 512), (16, 4096, 8192), (128, 4096, 8192))
# (Hkv, rep, hd) of the binary-coded decode: llama2-7b, Qwen3-MoE
QUANT_GEOMS = ((32, 1, 128), (4, 16, 128))
PAGED_CTX = [50, 80, 110, 131]
# (bits, hd, G) of the binary-coded reader's grid: every bits 1..8 at each
# head dim with one scale group, two, and groups of 32 entries; then
# layouts that take its other paths: groups narrower than the 32-entry
# runs it expands (16, 4 entries: scales read per entry), a scale row of
# exactly ATTN_QUANT_SCALES_MAX bytes, and scale rows too wide to stage
# (read from the pool)
QUANT_GRID = tuple((bits, hd, G) for hd in (32, 64, 128, 256)
                   for bits in range(1, 9) for G in sorted({1, 2, hd // 32}))
QUANT_EDGES = ((5, 128, 8), (2, 32, 8), (7, 256, 16), (3, 64, 64),
               (8, 256, 256))
# (contexts, Hkv, rep, page, window, cap, q dtype) the grid cycles through:
# contexts that end mid-partition, ctx 1, windows that start mid-partition,
# caps, GQA widths 1-16, bf16 q
QUANT_VARIANTS = (
    ([45, 1, 77], 4, 1, 16, None, None, "float32"),
    ([131, 33], 2, 4, 64, 40, 30.0, "bfloat16"),
    ([100, 250], 2, 16, 16, None, 5.0, "float32"),
    ([70, 95, 3], 3, 2, 32, 50, None, "bfloat16"),
)
BF16_ULP = 2.0 ** -8   # bf16 rounding of an output: half an ulp, relative


def check_bcq(gen, shapes, Ms=GEMV_MS + GEMM_MS):
    import torch
    from repro_torch.kernels.bcq_matmul import (_bcq_matmul_plain, bcq_gemv,
                                                bcq_matmul)
    worst = {"bcq_gemv": 0.0, "bcq_matmul": 0.0}
    n_checks = {"bcq_gemv": 0, "bcq_matmul": 0}
    for K, N in shapes:
        for gs in (0, 128):
            for sdt in (torch.float32, torch.bfloat16):
                # copies of the weight whose codes exceed twice the 50 MB
                # L2, cycled through so timed launches read from HBM
                n_copy = max(2, -(-100_000_000 // (3 * K * N // 8)))
                qts = [random_qt(gen, K, N, gs, sdt) for _ in range(n_copy)]
                qt = qts[0]
                for M in Ms:
                    name = "bcq_gemv" if M <= 8 else "bcq_matmul"
                    fn = bcq_gemv if M <= 8 else bcq_matmul
                    x = torch.randn((M, K), generator=gen, device=DEV)
                    y = fn(x, qt.codes, qt.alphas, qt.betas)
                    ref = _bcq_matmul_plain(x, qt.codes, qt.alphas, qt.betas)
                    sync()
                    err = float((y - ref).abs().max())
                    rel = err / float(ref.abs().max())
                    ok = bool(torch.isfinite(y).all()) and rel <= TOL_FP32
                    row = {"check": name, "M": M, "K": K, "N": N,
                           "group_size": gs,
                           "scale_dtype": str(sdt).removeprefix("torch."),
                           "x_dtype": "float32", "max_abs_err": err,
                           "rel_err": rel, "tol": TOL_FP32}
                    it = [0]

                    def run(fn=fn, x=x):
                        q = qts[it[0] % n_copy]
                        it[0] += 1
                        fn(x, q.codes, q.alphas, q.betas)
                    t = kernel_ms(run, 20)
                    row["ms"] = best_ms(t)
                    row["event_ms"] = t["event_ms"]
                    emit(row)
                    require(ok, f"{name} M={M} K={K} N={N} gs={gs} {sdt}: "
                                f"rel err {rel:.3g} > {TOL_FP32}")
                    worst[name] = max(worst[name], rel)
                    n_checks[name] += 1
                # bf16 activations: W rounds to bf16 as in the reference
                for M in (m for m in (4, 128) if m in Ms):
                    name = "bcq_gemv" if M <= 8 else "bcq_matmul"
                    fn = bcq_gemv if M <= 8 else bcq_matmul
                    x = torch.randn((M, K), generator=gen,
                                    device=DEV).bfloat16()
                    y = fn(x, qt.codes, qt.alphas, qt.betas).float()
                    ref = _bcq_matmul_plain(x, qt.codes, qt.alphas,
                                            qt.betas).float()
                    rel = float((y - ref).abs().max() / ref.abs().max())
                    emit({"check": name, "M": M, "K": K, "N": N,
                          "group_size": gs,
                          "scale_dtype": str(sdt).removeprefix("torch."),
                          "x_dtype": "bfloat16", "rel_err": rel,
                          "tol": TOL_BF16})
                    require(rel <= TOL_BF16, f"{name} bf16 x M={M} K={K} "
                                             f"N={N}: rel err {rel:.3g}")
                    n_checks[name] += 1
                del qts
    return worst, n_checks


def summarize_bcq(gen, name, M, K, N):
    """The kernel's line: time, bound, plain and library (torch.matmul on
    the pre-dequantized W) at one main-path shape, w3 per-channel fp32."""
    import torch
    from repro_torch.kernels.bcq_matmul import (_bcq_matmul_plain, bcq_gemv,
                                                bcq_matmul)
    fn = bcq_gemv if name == "bcq_gemv" else bcq_matmul
    n_copy = max(2, -(-100_000_000 // (3 * K * N // 8)))
    qts = [random_qt(gen, K, N, 0, torch.float32) for _ in range(n_copy)]
    x = torch.randn((M, K), generator=gen, device=DEV)
    it = [0]

    def run():
        q = qts[it[0] % n_copy]
        it[0] += 1
        return fn(x, q.codes, q.alphas, q.betas)
    q0 = qts[0]
    y = fn(x, q0.codes, q0.alphas, q0.betas)
    ref = _bcq_matmul_plain(x, q0.codes, q0.alphas, q0.betas)
    err = float((y - ref).abs().max())
    t = kernel_ms(run, 50)
    plain_ms = best_ms(kernel_ms(lambda: _bcq_matmul_plain(
        x, q0.codes, q0.alphas, q0.betas), 5))
    w = q0.dequant(torch.float32)
    lib_ms = best_ms(kernel_ms(lambda: torch.matmul(x, w), 20))
    n_bytes = q0.packed_bytes() + 4 * M * K + 4 * M * N
    row = {}
    if name == "bcq_gemv":
        b, by = bound_ms(n_bytes, 2.0 * M * K * N)
        row["arithmetic"] = "fp32"
    else:
        from repro_torch.kernels.bcq_matmul import gemm_launch_shape
        arith, passes = gemm_arithmetic(x.dtype)
        b, by = bound_ms(n_bytes, passes * 2.0 * M * K * N, TF32_FLOPS)
        tile, ntiles, splits = gemm_launch_shape(
            M, K // 32, N, torch.cuda.get_device_properties(
                0).multi_processor_count if DEV == "cuda" else 132)
        row.update({"arithmetic": arith, "token_tile": tile,
                    "token_tiles": ntiles, "k_splits": splits})
    return {"max_abs_err": err, "ms": best_ms(t), "plain_ms": plain_ms,
            "bound_ms": b, "bound_by": by, **row, "library_ms": lib_ms,
            "event_ms": t["event_ms"],
            "timing": "profiler" if t["device_ms"] else "cuda_events",
            "shape": f"M={M} K={K} N={N} w3 per-channel fp32 scales"}


def paged_case(gen, B, Hkv, rep, hd, page, ctx, dtype):
    """Random pool + block tables: each sequence owns distinct pages
    (a permutation of 1..P-1), unused table slots hold the null page 0."""
    import torch
    T = max(-(-c // page) for c in ctx)
    n_pages = sum(-(-c // page) for c in ctx) + 1
    kp = torch.randn((n_pages, page, Hkv, hd), generator=gen,
                     device=DEV).to(dtype)
    vp = torch.randn((n_pages, page, Hkv, hd), generator=gen,
                     device=DEV).to(dtype)
    perm = (torch.randperm(n_pages - 1, generator=gen, device=DEV) + 1)
    bt = torch.zeros((B, T), dtype=torch.int32, device=DEV)
    used = 0
    for b, c in enumerate(ctx):
        n = -(-c // page)
        bt[b, :n] = perm[used:used + n].to(torch.int32)
        used += n
    q = torch.randn((B, Hkv, rep, hd), generator=gen, device=DEV).to(dtype)
    cl = torch.tensor(ctx, dtype=torch.int32, device=DEV)
    return q, kp, vp, bt, cl


def check_paged(gen):
    import torch
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.kernels.ref import paged_attention_ref
    cases = [
        # main path: llama2-7b decode, batch 4, ragged contexts
        dict(B=4, Hkv=32, rep=1, hd=128, page=64, ctx=[17, 64, 100, 160],
             window=None, cap=None),
        # GQA, window and cap, a row on the null page only (inactive)
        dict(B=3, Hkv=3, rep=2, hd=64, page=16, ctx=[40, 1, 33],
             window=8, cap=30.0),
        # Qwen3-MoE decode: 64 query heads over 4 KV heads (rep 16)
        dict(B=4, Hkv=4, rep=16, hd=128, page=64, ctx=[50, 80, 110, 131],
             window=None, cap=None),
        # long contexts: 8 blocks a cluster, several partitions a block
        # (two K/V stages), with and without a window that starts
        # mid-partition
        dict(B=2, Hkv=4, rep=4, hd=128, page=16, ctx=[700, 999],
             window=None, cap=None),
        dict(B=2, Hkv=4, rep=4, hd=128, page=16, ctx=[700, 999],
             window=301, cap=None),
    ]
    worst = 0.0
    for c in cases:
        q, kp, vp, bt, cl = paged_case(gen, c["B"], c["Hkv"], c["rep"],
                                       c["hd"], c["page"], c["ctx"],
                                       torch.float32)
        if c["ctx"][1] == 1:
            bt[1] = 0                       # inactive row: null page only
        y = paged_attention(q, kp, vp, bt, cl, window=c["window"],
                            cap=c["cap"])
        ref = paged_attention_ref(q, kp, vp, bt, cl, window=c["window"],
                                  cap=c["cap"])
        sync()
        err = float((y - ref).abs().max())
        rel = err / float(ref.abs().max())
        emit({"check": "paged_attention", **{k: c[k] for k in
                                             ("B", "Hkv", "rep", "hd",
                                              "page", "ctx", "window",
                                              "cap")},
              "max_abs_err": err, "rel_err": rel, "tol": TOL_FP32})
        require(bool(torch.isfinite(y).all()) and rel <= TOL_FP32,
                f"paged_attention {c}: rel err {rel:.3g}")
        worst = max(worst, rel)
    return worst


def summarize_paged(gen, Hkv=32, rep=1, hd=128, page=64, ctx=PAGED_CTX):
    """The kernel's line at a decode shape (default: phase 3's llama2-7b):
    time, bound, plain, and SDPA on the gathered K/V."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.kernels.ref import paged_attention_ref
    B = len(ctx)
    q, kp, vp, bt, cl = paged_case(gen, B, Hkv, rep, hd, page, ctx,
                                   torch.float32)
    y = paged_attention(q, kp, vp, bt, cl)
    ref = paged_attention_ref(q, kp, vp, bt, cl)
    err = float((y - ref).abs().max())
    t = kernel_ms(lambda: paged_attention(q, kp, vp, bt, cl), 200)
    plain_ms = best_ms(kernel_ms(
        lambda: paged_attention_ref(q, kp, vp, bt, cl), 20))
    # library yardstick: SDPA over the gathered K/V with a context mask
    T = bt.shape[1]
    k = kp[bt.long()].reshape(B, T * page, Hkv, hd).transpose(1, 2)
    v = vp[bt.long()].reshape(B, T * page, Hkv, hd).transpose(1, 2)
    mask = (torch.arange(T * page, device=DEV)[None, :]
            < cl[:, None])[:, None, None, :]
    qs = q.reshape(B, Hkv * rep, 1, hd)
    lib_ms = best_ms(kernel_ms(lambda: F.scaled_dot_product_attention(
        qs, k, v, attn_mask=mask, enable_gqa=True), 200))
    tokens = sum(ctx)
    n_bytes = (2 * tokens * Hkv * hd * 4 + 2 * q.numel() * 4
               + bt.numel() * 4 + cl.numel() * 4)
    b, by = bound_ms(n_bytes, 4.0 * tokens * Hkv * rep * hd)
    return {"max_abs_err": err, "ms": best_ms(t), "plain_ms": plain_ms,
            "bound_ms": b, "bound_by": by, "library_ms": lib_ms,
            "event_ms": t["event_ms"],
            "timing": "profiler" if t["device_ms"] else "cuda_events",
            "shape": f"B={B} Hkv={Hkv} rep={rep} hd={hd} page={page} "
                     f"ctx={ctx} fp32"}


def quant_pages(kp, vp, bits, gs):
    """Binary-coded K/V pools (quant/kv.py layout) of fp pools."""
    from repro_torch.quant.kv import kv_quantize
    return (*kv_quantize(kp, bits, gs), *kv_quantize(vp, bits, gs))


def random_quant_pages(gen, like, bits, G):
    """Binary-coded K/V pools (quant/kv.py layout) of random code words
    and scales, shaped as the fp pool `like`: every sign pattern, alphas
    in [0.1, 1.1) / sqrt(bits), small betas."""
    import torch
    P, page, Hkv, hd = like.shape
    out = []
    for _ in range(2):
        out += [torch.randint(-2 ** 31, 2 ** 31,
                              (P, page, Hkv, bits, hd // 32),
                              dtype=torch.int32, generator=gen, device=DEV),
                (0.1 + torch.rand((P, page, Hkv, G, bits), generator=gen,
                                  device=DEV)) / bits ** 0.5,
                0.1 * torch.randn((P, page, Hkv, G), generator=gen,
                                  device=DEV)]
    return tuple(out)




def check_paged_quant(gen, geoms=QUANT_GEOMS, page=64, ctx=PAGED_CTX):
    """paged_attention_quant against its plain version: bits 2/3/4, one
    group per head vector and groups of 32, with and without window and
    cap, at each (Hkv, rep, hd)."""
    import torch
    from repro_torch.kernels.paged_attention import paged_attention_quant
    from repro_torch.kernels.ref import paged_attention_quant_ref
    worst = 0.0
    for Hkv, rep, hd in geoms:
        for bits in (2, 3, 4):
            for gs in (0, 32):
                for window, cap in ((None, None), (40, 30.0)):
                    q, kp, vp, bt, cl = paged_case(gen, len(ctx), Hkv, rep,
                                                   hd, page, ctx,
                                                   torch.float32)
                    pool = quant_pages(kp, vp, bits, gs)
                    y = paged_attention_quant(q, *pool, bt, cl,
                                              window=window, cap=cap)
                    ref = paged_attention_quant_ref(q, *pool, bt, cl,
                                                    window=window, cap=cap)
                    sync()
                    err = float((y - ref).abs().max())
                    rel = err / float(ref.abs().max())
                    emit({"check": "paged_attention_quant", "Hkv": Hkv,
                          "rep": rep, "hd": hd, "page": page, "ctx": ctx,
                          "bits": bits, "kv_group_size": gs,
                          "window": window, "cap": cap,
                          "max_abs_err": err, "rel_err": rel,
                          "tol": TOL_FP32})
                    require(bool(torch.isfinite(y).all()) and rel <= TOL_FP32,
                            f"paged_attention_quant Hkv={Hkv} rep={rep} "
                            f"bits={bits} gs={gs} window={window}: rel err "
                            f"{rel:.3g}")
                    worst = max(worst, rel)
    return worst


def check_paged_quant_grid(seed, cases=QUANT_GRID + QUANT_EDGES):
    """paged_attention_quant against its plain version over the reader's
    (bits, hd, G) grid, each case on the next of QUANT_VARIANTS, on random
    pools (kv_quantize yields NaN alphas for some vectors at many bits a
    32-entry group, the reference's as well), drawn from a generator of
    their own (so the later phase-1 lines get the inputs they would get
    without these checks). fp32 q: within TOL_FP32 x max|out|; bf16 q:
    the bf16 output within half a bf16 ulp of the plain fp32 output plus
    TOL_FP32 x max|out| (both compute in fp32 from the same bf16 q, then
    the kernel rounds)."""
    import torch
    from repro_torch.kernels.paged_attention import paged_attention_quant
    from repro_torch.kernels.ref import paged_attention_quant_ref
    gen = torch.Generator(device=DEV)
    gen.manual_seed(seed)
    worst = 0.0
    for i, (bits, hd, G) in enumerate(cases):
        ctx, Hkv, rep, page, window, cap, dt = \
            QUANT_VARIANTS[i % len(QUANT_VARIANTS)]
        q, kp, vp, bt, cl = paged_case(gen, len(ctx), Hkv, rep, hd, page,
                                       ctx, torch.float32)
        pool = random_quant_pages(gen, kp, bits, G)
        q = q.to(getattr(torch, dt))
        y = paged_attention_quant(q, *pool, bt, cl, window=window, cap=cap)
        ref = paged_attention_quant_ref(q.float(), *pool, bt, cl,
                                        window=window, cap=cap)
        sync()
        diff = (y.float() - ref).abs()
        if dt == "bfloat16":
            diff = (diff - BF16_ULP * ref.abs()).clamp_min(0)
        rel = float(diff.max()) / float(ref.abs().max())
        emit({"check": "paged_attention_quant_grid", "bits": bits, "hd": hd,
              "G": G, "ctx": ctx, "Hkv": Hkv, "rep": rep, "page": page,
              "window": window, "cap": cap, "q_dtype": dt,
              "max_abs_err": float((y.float() - ref).abs().max()),
              "rel_err": rel, "tol": TOL_FP32,
              **({"plus": "bf16 rounding"} if dt == "bfloat16" else {})})
        require(bool(torch.isfinite(y).all()) and rel <= TOL_FP32,
                f"paged_attention_quant bits={bits} hd={hd} G={G} "
                f"{dt} window={window} cap={cap}: rel err {rel:.3g}")
        worst = max(worst, rel)
    return worst


def summarize_paged_quant(gen, Hkv=32, rep=1, hd=128, bits=4, page=64,
                          ctx=PAGED_CTX):
    """The kernel's line at the phase-4 decode shape: time, bound, plain,
    and two library yardsticks: SDPA on K/V gathered and expanded to fp32
    before the call (it gets its operand already expanded), and the whole
    PyTorch equivalent timed as one call (gather the binary-coded rows,
    kv_dequantize, SDPA)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.paged_attention import paged_attention_quant
    from repro_torch.kernels.ref import paged_attention_quant_ref
    from repro_torch.quant.kv import kv_bytes_per_token_head, kv_dequantize
    B = len(ctx)
    q, kp, vp, bt, cl = paged_case(gen, B, Hkv, rep, hd, page, ctx,
                                   torch.float32)
    pool = quant_pages(kp, vp, bits, 0)
    G = pool[2].shape[-1]
    y = paged_attention_quant(q, *pool, bt, cl)
    ref = paged_attention_quant_ref(q, *pool, bt, cl)
    err = float((y - ref).abs().max())
    t = kernel_ms(lambda: paged_attention_quant(q, *pool, bt, cl), 200)
    plain_ms = best_ms(kernel_ms(
        lambda: paged_attention_quant_ref(q, *pool, bt, cl), 20))
    T = bt.shape[1]
    k = kv_dequantize(*pool[:3])[bt.long()].reshape(
        B, T * page, Hkv, hd).transpose(1, 2)
    v = kv_dequantize(*pool[3:])[bt.long()].reshape(
        B, T * page, Hkv, hd).transpose(1, 2)
    mask = (torch.arange(T * page, device=DEV)[None, :]
            < cl[:, None])[:, None, None, :]
    qs = q.reshape(B, Hkv * rep, 1, hd)
    lib_ms = best_ms(kernel_ms(lambda: F.scaled_dot_product_attention(
        qs, k, v, attn_mask=mask, enable_gqa=True), 200))
    btl = bt.long()

    def whole():
        kf = kv_dequantize(*(t[btl] for t in pool[:3])).reshape(
            B, T * page, Hkv, hd).transpose(1, 2)
        vf = kv_dequantize(*(t[btl] for t in pool[3:])).reshape(
            B, T * page, Hkv, hd).transpose(1, 2)
        return F.scaled_dot_product_attention(qs, kf, vf, attn_mask=mask,
                                              enable_gqa=True)
    full = kernel_ms(whole, 50)
    tokens = sum(ctx)
    n_bytes = (2 * tokens * Hkv * kv_bytes_per_token_head(hd, bits, hd // G)
               + 2 * q.numel() * 4 + bt.numel() * 4 + cl.numel() * 4)
    b, by = bound_ms(n_bytes, 4.0 * tokens * Hkv * rep * hd)
    return {"max_abs_err": err, "ms": best_ms(t), "plain_ms": plain_ms,
            "bound_ms": b, "bound_by": by, "library_ms": lib_ms,
            "library_gets": "K/V gathered and expanded to fp32 beforehand",
            "library_full_ms": best_ms(full),
            "library_full_event_ms": full["event_ms"],
            "library_full_is": "gather, kv_dequantize, SDPA in one call",
            "event_ms": t["event_ms"],
            "timing": "profiler" if t["device_ms"] else "cuda_events",
            "shape": f"B={B} Hkv={Hkv} rep={rep} hd={hd} page={page} "
                     f"ctx={ctx} {bits}-bit G={G}, fp32 q"}


# the Qwen3-MoE expert matrices: wg/wu (4096 x 1536) and wd (1536 x 4096)
EXPERT_SHAPES = ((4096, 1536), (1536, 4096))


def routed_rows(gen, E=128, T=4, k=8, C=4):
    """Filled slots of each expert for T tokens routed top-k over E
    experts by seeded random router logits, clamped at C (what
    moe_forward passes as rows): an (E,) int32 tensor on the card."""
    import torch
    logits = torch.randn((T, E), generator=gen, device=DEV)
    top = torch.topk(logits, min(k, E), dim=-1).indices.reshape(-1)
    return torch.bincount(top, minlength=E).clamp(max=C).int()


def check_expert(gen, E=128, shapes=EXPERT_SHAPES, Ms=(4, 16)):
    """bcq_expert_matmul against its plain version (w3 per-channel fp32
    scales and group 128 bf16 scales), and each expert's slice against
    the single-matrix kernel on that expert alone, bit for bit; then the
    same with rows from a seeded routing (most experts empty): exact
    zeros past each count, the live rows bit-equal to the single-matrix
    kernel."""
    import torch
    from repro_torch.kernels.bcq_matmul import (_bcq_expert_plain,
                                                bcq_expert_matmul, bcq_gemv,
                                                bcq_matmul)
    from repro_torch.hw import GEMV_ROWS
    worst, n_exact = 0.0, 0
    for K, N in shapes:
        for gs, sdt in ((0, torch.float32), (128, torch.bfloat16)):
            qt = random_qt(gen, K, N, gs, sdt, E=E)
            c, a, b = qt.codes, qt.alphas, qt.betas
            for M in Ms:
                x = torch.randn((E, M, K), generator=gen, device=DEV)
                y = bcq_expert_matmul(x, c, a, b)
                ref = _bcq_expert_plain(x, c, a, b)
                dense = bcq_gemv if M <= GEMV_ROWS else bcq_matmul
                exact = all(torch.equal(y[e], dense(x[e], c[e], a[e], b[e]))
                            for e in range(E))
                sync()
                err = float((y - ref).abs().max())
                rel = err / float(ref.abs().max())
                t = kernel_ms(lambda: bcq_expert_matmul(x, c, a, b), 10)
                emit({"check": "bcq_expert_matmul", "E": E, "M": M, "K": K,
                      "N": N, "group_size": gs,
                      "scale_dtype": str(sdt).removeprefix("torch."),
                      "max_abs_err": err, "rel_err": rel, "tol": TOL_FP32,
                      "equals_single_matrix_kernels": exact,
                      "ms": best_ms(t), "event_ms": t["event_ms"]})
                require(bool(torch.isfinite(y).all()) and rel <= TOL_FP32,
                        f"bcq_expert_matmul M={M} K={K} N={N} gs={gs}: rel "
                        f"err {rel:.3g}")
                require(exact, f"bcq_expert_matmul M={M} K={K} N={N} "
                               f"gs={gs}: an expert differs from the "
                               f"single-matrix kernel")
                worst = max(worst, rel)
                n_exact += E
                # live rows only: a routing's counts (M=16: a prefill's)
                rows = routed_rows(gen, E, T=4 if M <= GEMV_ROWS else 128,
                                   C=M)
                yr = bcq_expert_matmul(x, c, a, b, rows)
                refr = _bcq_expert_plain(x, c, a, b, rows)
                live = rows.tolist()
                zeros = all(not bool(yr[e, n:].any())
                            for e, n in enumerate(live))
                exact_r = all(torch.equal(yr[e, :n], y[e, :n])
                              for e, n in enumerate(live))
                sync()
                rel_r = float((yr - refr).abs().max()
                              / refr.abs().max().clamp(min=1e-30))
                emit({"check": "bcq_expert_matmul_rows", "E": E, "M": M,
                      "K": K, "N": N, "group_size": gs,
                      "live_experts": sum(n > 0 for n in live),
                      "live_rows": sum(live), "rel_err": rel_r,
                      "tol": TOL_FP32, "dead_rows_exact_zero": zeros,
                      "live_rows_equal_single_matrix": exact_r})
                require(rel_r <= TOL_FP32 and zeros and exact_r,
                        f"bcq_expert_matmul rows M={M} K={K} N={N} gs={gs}: "
                        f"rel err {rel_r:.3g}, zeros {zeros}, exact "
                        f"{exact_r}")
                worst = max(worst, rel_r)
            del qt, c, a, b
    return worst, n_exact


def summarize_expert(gen, E=128, M=4, K=4096, N=1536, routed=True):
    """The kernel's line at the phase-5 decode shape (wg/wu, C = 4 rows
    per expert), w3 per-channel fp32: time, bound, plain, and the library
    yardstick: torch.bmm on the stack dequantized to fp32 beforehand (it
    gets its operand already expanded). With `routed`, the rows of a
    seeded batch-4 top-8 routing, as moe_forward passes them: the bound
    counts the routed experts' codes and scales and their live rows (y
    is written whole), and the line also times every row (rows=None).
    M > 8 runs the tensor-core GEMM body: its bound is its TF32 passes."""
    import torch
    from repro_torch.hw import GEMV_ROWS
    from repro_torch.kernels.bcq_matmul import (_bcq_expert_plain,
                                                bcq_expert_matmul)
    qt = random_qt(gen, K, N, 0, torch.float32, E=E)
    c, a, b = qt.codes, qt.alphas, qt.betas
    x = torch.randn((E, M, K), generator=gen, device=DEV)
    rows = routed_rows(gen, E, C=M) if routed else None
    y = bcq_expert_matmul(x, c, a, b, rows)
    ref = _bcq_expert_plain(x, c, a, b, rows)
    err = float((y - ref).abs().max())
    t = kernel_ms(lambda: bcq_expert_matmul(x, c, a, b, rows), 50)
    plain_ms = best_ms(kernel_ms(
        lambda: _bcq_expert_plain(x, c, a, b, rows), 2))
    w = qt.dequant(torch.float32)                      # (E, K, N) fp32
    lib_ms = best_ms(kernel_ms(lambda: torch.bmm(x, w), 20))
    del w
    live = [M] * E if rows is None else rows.tolist()
    used = sum(n > 0 for n in live)
    n_bytes = (qt.packed_bytes() * used / E + 4 * sum(live) * K
               + 4 * E * M * N)
    if M <= GEMV_ROWS:
        bd, by = bound_ms(n_bytes, 2.0 * sum(live) * K * N)
        arith = "fp32"
    else:
        arith, passes = gemm_arithmetic(x.dtype)
        bd, by = bound_ms(n_bytes, passes * 2.0 * sum(live) * K * N,
                          TF32_FLOPS)
    row = {"max_abs_err": err, "ms": best_ms(t), "plain_ms": plain_ms,
           "bound_ms": bd, "bound_by": by, "arithmetic": arith,
           "library_ms": lib_ms,
           "library_gets": "the expert stack dequantized to fp32 "
                           "beforehand (torch.bmm, every row)",
           "event_ms": t["event_ms"],
           "timing": "profiler" if t["device_ms"] else "cuda_events",
           "shape": f"E={E} M={M} K={K} N={N} w3 per-channel fp32 scales"}
    if rows is not None:
        whole = qt.packed_bytes() + 4 * E * M * K + 4 * E * M * N
        row.update({
            "rows": f"batch-4 top-8 routing, {used} live experts, "
                    f"{sum(live)} live rows",
            "live_experts": used,
            "ms_every_row": best_ms(kernel_ms(
                lambda: bcq_expert_matmul(x, c, a, b), 50)),
            "bound_ms_every_row": bound_ms(whole, 2.0 * E * M * K * N)[0]})
    return row


# ---------------------------------------------------------------------------
# phase 2: the reference fixture on the card
# ---------------------------------------------------------------------------

def logits_err(got, want) -> float:
    """Worst step of a logits trajectory against the reference's, over
    TOL_LOGITS x max|reference logit| of that step."""
    import numpy as np
    worst = 0.0
    for g, w in zip(got, want):
        w = np.asarray(w, np.float64)
        d = np.abs(g.double().cpu().numpy() - w).max()
        worst = max(worst, d / (TOL_LOGITS * np.abs(w).max()))
    return worst


def fixture_steps(cfg, params, prompt, toks, page, kv_bits, dev):
    """Logits of a fixture prompt's prefill and its teacher-forced paged
    decode steps on `dev`; with KV bits, the pool holds what the run's
    own quantize-on-write wrote."""
    import torch
    from repro_torch.models import (decode_step_paged, init_paged_cache,
                                    prefill, scatter_prefill_cache)
    L = len(prompt)
    logits, row = prefill(cfg, params, torch.tensor([prompt], device=dev), L)
    out = [logits[0]]
    n_pg = -(-(L + len(toks)) // page)
    cache = init_paged_cache(cfg, n_pg + 1, page, 1, kv_bits=kv_bits,
                             device=dev)
    ids = list(range(1, n_pg + 1))
    scatter_prefill_cache(cfg, cache, row, 0, ids[:-(-L // page)], L)
    bt = torch.tensor([ids], dtype=torch.int32, device=dev)
    for t, tok in enumerate(toks[:-1]):
        logits, cache = decode_step_paged(
            cfg, params, cache, torch.tensor([[tok]], device=dev),
            torch.tensor([L + t], dtype=torch.int32, device=dev), bt)
        out.append(logits[0])
    return out


def check_kv_quantize(cfg, host, prompts, kv_bits):
    """The card's quantize-on-write against the CPU plain path's on the
    same inputs: each layer's prefill K and V of every prompt, computed
    on the CPU, quantized on both. Codes must be equal except at
    near-ties of the final levels on either side (NEAR_TIE, as
    tests/test_torch_kv_quant.py excuses them); alphas and betas within
    1e-5 relative plus NEAR_TIE * max|x| (that test's tolerance)."""
    import torch
    from repro_torch.models import prefill
    from repro_torch.quant.kv import kv_quantize
    from repro_torch.quant.packing import unpack_signs_last
    writes = entries = ties = differ = 0
    scales = 0.0
    for prompt in prompts:
        _, rows = prefill(cfg, host, torch.tensor([prompt]), len(prompt))
        for layer in rows:
            for side in "kv":
                x = layer[side]
                c, a, b = kv_quantize(x, kv_bits)
                gc_, ga, gb = (t.cpu() for t in kv_quantize(x.to(DEV),
                                                           kv_bits))
                tie = near_ties(x, a, b) | near_ties(x, ga, gb)
                flip = (unpack_signs_last(c)
                        != unpack_signs_last(gc_)).any(dim=-2)
                tol = NEAR_TIE * float(x.abs().max())
                for want, got in ((a, ga), (b, gb)):
                    scales = max(scales, float(
                        ((got - want).abs() / (tol + 1e-5 * want.abs()))
                        .max()))
                writes += 1
                entries += x.numel()
                ties += int(tie.sum())
                differ += int((flip & ~tie).sum())
    return {"kv_quantize_writes": writes, "kv_quantize_entries": entries,
            "kv_quantize_near_ties": ties,
            "kv_quantize_codes_differ_off_ties": differ,
            "kv_quantize_scales_err_over_tol": scales}


def near_tie_witness(cfg, params, host, wit, page, kv_bits):
    """Why the fixture drops prompts whose quantize-on-write has a
    near-tie (make_fixture.py, KV_TIE_MARGIN): the first prompt it
    dropped, served on its own pool with the GEMM kernel, with the
    GEMM's plain version on the card, with an fp64 GEMM on the card,
    and by the CPU plain path, each one's logits error against the
    reference's (over TOL_LOGITS); and, at the first layer whose prefill
    K or V from the kernel quantizes differently from the CPU's, how far
    apart the inputs were and the first kv_quantize round whose codes
    differ. Reported, not gated."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.bcq_matmul import _bcq_matmul_plain
    from repro_torch.kernels.ref import dequant_ref
    from repro_torch.models import prefill

    def fp64(x, codes, alphas, betas):
        w = dequant_ref(codes[:alphas.shape[-1]], alphas, betas, x.shape[1])
        return (x.double() @ w.double()).to(x.dtype)

    prompt, toks = wit["prompt"], wit["tokens"]
    want = [wit["prefill_logits"], *wit["decode_logits"]]
    row = {"check": "fixture_near_tie_witness", "prompt_len": len(prompt),
           "quant_margin": wit["quant_margin"]}
    kernel = ops.bcq_matmul
    for label, gemm in (("kernel", kernel), ("plain_on_card",
                                             _bcq_matmul_plain),
                        ("fp64_on_card", fp64)):
        ops.bcq_matmul = gemm
        try:
            got = fixture_steps(cfg, params, prompt, toks, page, kv_bits, DEV)
        finally:
            ops.bcq_matmul = kernel
        row[f"{label}_logits_err_over_tol"] = logits_err(got, want)
    row["cpu_plain_logits_err_over_tol"] = logits_err(
        fixture_steps(cfg, host, prompt, toks, page, kv_bits, "cpu"), want)
    _, card = prefill(cfg, params, torch.tensor([prompt], device=DEV),
                      len(prompt))
    _, cpu = prefill(cfg, host, torch.tensor([prompt]), len(prompt))
    row["first_write_quantized_differently"] = None
    for i, (lk, lc) in enumerate(zip(card, cpu)):
        for side in "kv":
            xk, xc = lk[side].cpu(), lc[side]
            diff = first_refit_difference(xk, xc, kv_bits, 0)
            if diff["entries_differing_then"]:
                row["first_write_quantized_differently"] = {
                    "layer": i, "side": side,
                    "kv_rel_err": float((xk - xc).abs().max()
                                        / xc.abs().max()), **diff}
                return row
    return row


def phase_fixture():
    import numpy as np
    from repro_torch.ckpt import load_packed
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import main as launch_main
    from repro_torch.serve import Request, ServeEngine

    ref = json.loads((FIXTURE / "reference.json").read_text())
    kvb = ref["kv_bits"]
    runs = [(name, art, 0) for name, art in ref["artifacts"].items()]
    runs += [(name, art, kvb["bits"])
             for name, art in kvb["artifacts"].items()]
    out = {}
    for name, art, kv_bits in runs:
        params, _, meta = load_packed(FIXTURE / name, device=DEV)
        cfg = get_config(meta["arch"]).replace(
            dtype="float32", n_layers=len(params["layers"]))
        page = kvb["page_size"]
        # with KV bits, each prompt's pool is the card's own writes (the
        # fixture keeps only prompts whose quantize-on-write has no
        # near-tie in the reference, see near_tie_witness)
        worst = 0.0
        for prompt, toks, pl, dl in zip(art["prompts"], art["tokens"],
                                        art["prefill_logits"],
                                        art["decode_logits"]):
            got = fixture_steps(cfg, params, prompt, toks, page, kv_bits, DEV)
            worst = max(worst, logits_err(got, [pl, *dl]))
        eng = ServeEngine(cfg, params, batch_size=2, max_len=64,
                          dtype="float32", cache_kind="paged", page_size=page,
                          kv_bits=kv_bits, device=DEV)
        reqs = [Request(prompt=np.asarray(p, np.int32),
                        max_new_tokens=ref["max_new"])
                for p in art["prompts"]]
        eng.run(reqs)
        match = sum(r.out == t for r, t in zip(reqs, art["tokens"]))
        tag = f"{name}" + (f" kv_bits={kv_bits}" if kv_bits else "")
        row = {"check": "fixture", "artifact": name, "arch": meta["arch"],
               "kv_bits": kv_bits, "logits_err_over_tol": worst,
               "tol_rel": TOL_LOGITS,
               "greedy_match": f"{match}/{len(reqs)}"}
        if kv_bits:
            host = load_packed(FIXTURE / name, device="cpu")[0]
            row.update({"quant_margin_min": min(art["quant_margin"]),
                        "tie_margin": kvb["tie_margin"],
                        **check_kv_quantize(cfg, host, art["prompts"],
                                            kv_bits)})
        emit(row)
        require(worst <= 1.0, f"fixture {tag}: logits off by {worst:.3g} "
                              f"x the tolerance")
        require(match == len(reqs), f"fixture {tag}: greedy tokens differ")
        if kv_bits:
            require(row["kv_quantize_codes_differ_off_ties"] == 0
                    and row["kv_quantize_scales_err_over_tol"] <= 1.0,
                    f"fixture {tag}: the card's kv_quantize differs from "
                    f"the CPU's: {row}")
            emit(near_tie_witness(cfg, params, host, art["near_tie"], page,
                                  kv_bits))
        out[tag] = row
    # the launcher, as a user runs it, on the per-channel artifact
    lref = ref["launcher"]
    _, reqs = launch_main(["--load-quantized", str(FIXTURE / lref["artifact"]),
                           "--device", DEV, "--cache", "paged",
                           "--requests", str(len(lref["prompts"])),
                           "--batch-size", "3",
                           "--max-new", str(lref["max_new"])])
    need = [g >= ref["gap_factor"] for g in lref["gap_ratio"]]
    match = sum(r.out == t for r, t in zip(reqs, lref["tokens"]))
    emit({"check": "launcher", "greedy_match": f"{match}/{len(reqs)}"})
    require(all(r.out == t for r, t, n in zip(reqs, lref["tokens"], need)
                if n), "launcher: greedy tokens differ from the reference")
    return out


# ---------------------------------------------------------------------------
# phase 3: the main path at full width
# ---------------------------------------------------------------------------

def _w3(gen, K, N, E=None):
    """A seeded synthetic w3 per-channel packed weight (K, N), or a stack
    of E experts: uniform code words, alphas (4,2,1)/sqrt(21) * K^-0.5,
    betas 0."""
    import torch
    from repro_torch.quant import QuantizedTensor
    lead = () if E is None else (E,)
    base = torch.tensor([4.0, 2.0, 1.0], device=DEV)
    base = base / base.square().sum().sqrt()
    codes = torch.randint(-2 ** 31, 2 ** 31, (*lead, 3, K // 32, N),
                          dtype=torch.int32, generator=gen, device=DEV)
    alphas = (base * K ** -0.5).expand(*lead, 1, N, 3).contiguous()
    betas = torch.zeros((*lead, 1, N), device=DEV)
    return QuantizedTensor(codes, alphas, betas, K, "float32")


def _attn_weights(cfg, gen):
    import torch
    d, hd = cfg.d_model, cfg.resolved_head_dim
    p = {"wq": _w3(gen, d, cfg.n_heads * hd),
         "wk": _w3(gen, d, cfg.n_kv_heads * hd),
         "wv": _w3(gen, d, cfg.n_kv_heads * hd),
         "wo": _w3(gen, cfg.n_heads * hd, d)}
    if cfg.qk_norm:
        p["qn"] = torch.zeros(hd, device=DEV)
        p["kn"] = torch.zeros(hd, device=DEV)
    return p


def synthetic_llama(seed: int, arch: str = "llama2-7b"):
    """llama2-7b at full width and depth with seeded synthetic w3
    per-channel packed linears (betas 0) and fp32 embeddings, head and
    norms from the port's init_params."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    cfg = get_config(arch).replace(dtype="float32")
    params = init_params(cfg.replace(n_layers=0), seed=seed,
                         dtype="float32", device=DEV)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(seed + 1)
    d, f = cfg.d_model, cfg.d_ff
    params["layers"] = [
        {"ln": torch.zeros(d, device=DEV), "attn": _attn_weights(cfg, gen),
         "ln2": torch.zeros(d, device=DEV),
         "mlp": {"wg": _w3(gen, d, f), "wu": _w3(gen, d, f),
                 "wd": _w3(gen, f, d)}}
        for _ in range(cfg.n_layers)]
    return cfg, params


def synthetic_moe(seed: int, arch: str = "qwen3-moe-235b-a22b",
                  n_layers: int = MOE_LAYERS):
    """A MoE config at full width, cut to `n_layers`, with seeded
    synthetic w3 per-channel packed attention linears and expert stacks
    (codes made on the card), an fp32 router N(0, 1/d), and fp32
    embeddings, head and norms from the port's init_params."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    cfg = get_config(arch).replace(dtype="float32", n_layers=n_layers)
    params = init_params(cfg.replace(n_layers=0), seed=seed,
                         dtype="float32", device=DEV)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(seed + 2)
    d, f, E = cfg.d_model, cfg.moe.d_ff_expert, cfg.moe.n_experts
    params["layers"] = [
        {"ln": torch.zeros(d, device=DEV), "attn": _attn_weights(cfg, gen),
         "ln2": torch.zeros(d, device=DEV),
         "moe": {"router": torch.randn((d, E), generator=gen, device=DEV)
                 * d ** -0.5,
                 "wg": _w3(gen, d, f, E), "wu": _w3(gen, d, f, E),
                 "wd": _w3(gen, f, d, E)}}
        for _ in range(cfg.n_layers)]
    return cfg, params


def _code_bytes(params) -> int:
    return sum(w.codes.numel() * 4 for layer in params["layers"]
               for g in ("attn", "mlp", "moe") for w in layer.get(g, {})
               .values() if hasattr(w, "codes"))


PROMPT_LENS = [16, 45, 77, 100]


def serve_path(name, cfg, params, seed, kv_bits=0):
    """Serve the path's 4 requests (32 new tokens each) through the paged
    engine, every launch count set to 0 just before and read just
    after; returns (counts, row, prompts, engine)."""
    import numpy as np
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve import Request, ServeEngine
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in PROMPT_LENS]
    eng = ServeEngine(cfg, params, batch_size=4, max_len=160,
                      dtype="float32", cache_kind="paged", page_size=64,
                      kv_bits=kv_bits, device=DEV)
    reqs = [Request(prompt=p, max_new_tokens=32) for p in prompts]
    if DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()
    sync()
    reset_launch_counts()
    t1 = time.time()
    eng.run(reqs)
    sync()
    wall = time.time() - t1
    counts = launch_counts()
    st = eng.stats
    row = {"check": name, "model": cfg.name, "layers": cfg.n_layers,
           "requests": len(reqs), "prompt_lens": PROMPT_LENS, "max_new": 32,
           "kv_bits": kv_bits, "packed_code_bytes": _code_bytes(params),
           "kv_bytes_per_token": eng.kv.bytes_per_page() // eng.page_size,
           "wall_s": wall, "prefill_s": st["prefill_s"],
           "prefill_tokens": st["prefill_tokens"],
           "prefills": len(reqs) + eng.sched.preemptions,
           "decode_s": st["decode_s"], "decode_ticks": st["ticks"],
           "decode_tokens": st["tokens"],
           "decode_tok_per_s": st["tokens"] / max(st["decode_s"], 1e-9),
           "decode_ms_per_tick": 1e3 * st["decode_s"] / max(st["ticks"], 1),
           "ttft_avg_s": st["ttft_avg_s"], "tpot_avg_s": st["tpot_avg_s"],
           "peak_mem_gb": (torch.cuda.max_memory_allocated() / 1e9
                           if DEV == "cuda" else None),
           "launches": counts}
    require(all(r.done and len(r.out) == 32 for r in reqs),
            f"{name}: a request did not finish with 32 tokens")
    require(all(0 <= t < cfg.vocab_size for r in reqs for t in r.out),
            f"{name}: token out of the vocabulary")
    require(counts["bcq_plain"] == 0, f"{name}: a BCQ call took the "
                                      f"plain path")
    require(eng.kv.free_page_count == eng.kv.usable_pages,
            f"{name}: pages did not drain back to the pool")
    return counts, row, prompts, [r.out for r in reqs]


def paged_vs_dense(name, cfg, params, prompt, toks, steps=8):
    """The paged path (paged-attention kernel, page scatter) against the
    dense-cache torch path, teacher-forced on one request's tokens. For a
    MoE model it also counts the (token, layer) routings whose top-k
    expert sets differ between the two paths: a set that flips on a
    near-tie of the router moves the output by a whole expert's share,
    which no summation-order tolerance covers."""
    import torch
    from repro_torch.models import (decode_step, decode_step_paged,
                                    init_paged_cache, model, prefill,
                                    scatter_prefill_cache)
    L = len(prompt)
    tok_t = torch.tensor(prompt[None], device=DEV)
    logits_d, dense = prefill(cfg, params, tok_t, L + steps)
    require(bool(torch.isfinite(logits_d).all())
            and tuple(logits_d.shape) == (1, cfg.vocab_size),
            f"{name}: prefill logits not finite / wrong shape")
    _, prow = prefill(cfg, params, tok_t, L)
    page = 64
    pool = init_paged_cache(cfg, 4, page, 1, device=DEV)
    scatter_prefill_cache(cfg, pool, prow, 0, [1], L)
    bt = torch.tensor([[1, 2, 3]], dtype=torch.int32, device=DEV)
    routes: list = []
    forward = model.moe_forward

    def recorded(cfg_, p, x, **kw):
        probs = torch.softmax(x.reshape(-1, x.shape[-1]).float()
                              @ p["router"].float(), dim=-1)
        top = torch.topk(probs, cfg_.moe.top_k + 1, dim=-1).values
        routes.append((torch.topk(probs, cfg_.moe.top_k, dim=-1).indices
                       .sort(dim=-1).values, top[..., -2] - top[..., -1]))
        return forward(cfg_, p, x, **kw)
    errs, flips, min_gap = [], 0, None
    model.moe_forward = recorded
    try:
        for t in range(steps):
            tk = torch.tensor([[toks[t]]], device=DEV)
            pos = torch.tensor([L + t], dtype=torch.int32, device=DEV)
            routes.clear()
            ld, dense = decode_step(cfg, params, dense, tk, pos)
            n = len(routes)
            lp, pool = decode_step_paged(cfg, params, pool, tk, pos, bt)
            for (a, gap), (b, _) in zip(routes[:n], routes[n:]):
                flips += int((a != b).any(dim=-1).sum())
                g = float(gap.min())
                min_gap = g if min_gap is None else min(min_gap, g)
            errs.append(float((ld - lp).abs().max() / ld.abs().max()))
            require(bool(torch.isfinite(lp).all()), f"{name}: decode logits "
                                                    f"not finite")
    finally:
        model.moe_forward = forward
    sync()
    worst = max(errs)
    emit({"check": f"{name}_paged_vs_dense", "steps": steps,
          "rel_err": worst, "rel_err_by_step": errs, "tol": TOL_LOGITS,
          **({"routing_sets_differing": flips,
              "min_router_gap_kth_to_next": min_gap} if cfg.moe else {})})
    require(worst <= TOL_LOGITS, f"{name}: paged vs dense logits differ "
                                 f"by {worst:.3g}")


def phase_main_path(seed: int, model, build_s: float):
    """Phase 3 on `model`, built by synthetic_llama in `build_s` s."""
    cfg, params = model
    counts, row, prompts, outs = serve_path("main_path", cfg, params, seed)
    row["weights_build_s"] = build_s
    emit(row)
    for k in ("bcq_gemv", "bcq_matmul", "paged_attention"):
        require(counts[k] > 0, f"main path: {k} was never launched")
    require(counts["paged_attention"] == cfg.n_layers * row["decode_ticks"]
            and counts["paged_attention_quant"] == 0
            and counts["bcq_expert_matmul"] == 0,
            f"main path: launches {counts}")
    paged_vs_dense("main_path", cfg, params, prompts[0], outs[0])
    profile_decode(cfg, params, prompts)
    return counts, row


def phase_kv_bits(seed: int, model, kv_bits: int = 4):
    """Phase 3's model and requests with binary-coded KV pages."""
    import torch
    from repro_torch.models import (attention, decode_step_paged,
                                    init_paged_cache, prefill,
                                    scatter_prefill_cache)
    from repro_torch.kernels.ref import paged_attention_quant_ref
    cfg, params = model
    counts, row, prompts, outs = serve_path("kv_bits_path", cfg, params,
                                            seed, kv_bits=kv_bits)
    row["kv_bytes_per_token_fp32_pages"] = (
        2 * cfg.n_kv_heads * cfg.resolved_head_dim * 4 * cfg.n_layers)
    emit(row)
    require(counts["paged_attention_quant"]
            == cfg.n_layers * row["decode_ticks"] > 0
            and counts["paged_attention"] == 0,
            f"kv_bits path: launches {counts}")
    # the kernel against its plain version on the path's own inputs: every
    # layer's call of 8 teacher-forced decode steps of request 0 also runs
    # the plain version; whole-model runs follow in kv_divergence_witness
    L, steps, page = len(prompts[0]), 8, 64
    _, row_cache = prefill(cfg, params,
                           torch.tensor(prompts[0][None], device=DEV), L)
    pool = init_paged_cache(cfg, 4, page, 1, kv_bits=kv_bits, device=DEV)
    scatter_prefill_cache(cfg, pool, row_cache, 0, [1], L)
    bt = torch.tensor([[1, 2, 3]], dtype=torch.int32, device=DEV)
    kernel = attention.paged_attention_quant
    errs = []

    def checked(*args, **kw):
        y = kernel(*args, **kw)
        ref = paged_attention_quant_ref(*args, **kw)
        errs.append(float((y - ref).abs().max() / ref.abs().max()))
        return y
    attention.paged_attention_quant = checked
    try:
        for t in range(steps):
            logits, _ = decode_step_paged(
                cfg, params, pool, torch.tensor([[outs[0][t]]], device=DEV),
                torch.tensor([L + t], dtype=torch.int32, device=DEV), bt)
            require(bool(torch.isfinite(logits).all()),
                    "kv_bits path: decode logits not finite")
    finally:
        attention.paged_attention_quant = kernel
    sync()
    emit({"check": "kv_bits_path_kernel_vs_plain", "steps": steps,
          "calls": len(errs), "max_rel_err": max(errs), "tol": TOL_FP32})
    require(len(errs) == steps * cfg.n_layers and max(errs) <= TOL_FP32,
            f"kv_bits path: kernel vs plain differ by {max(errs):.3g}")
    kv_divergence_witness(cfg, params, prompts[0], outs[0], kv_bits)
    profile_decode(cfg, params, prompts, kv_bits=kv_bits, tag="kv_bits")
    return counts, row


NEAR_TIE = 1e-5       # as tests/test_torch_kv_quant.py counts near-ties


def near_ties(x, alphas, betas):
    """Entries of x (..., hd) whose distances to their two nearest
    levels under the given scales differ by less than NEAR_TIE *
    max|x|."""
    import torch
    from repro_torch.quant.kv import sign_combos
    bits, G = alphas.shape[-1], betas.shape[-1]
    xg = x.float().reshape(*x.shape[:-1], G, -1) - betas[..., None]
    levels = alphas @ sign_combos(bits, x.device).T          # (..., G, L)
    d = torch.sort((xg[..., None, :] - levels[..., None]).abs(),
                   dim=-2).values
    tie = (d[..., 1, :] - d[..., 0, :]) < NEAR_TIE * x.abs().max()
    return tie.reshape(x.shape)


def first_refit_difference(xk, xp, bits, gs):
    """Quantize both sides' K/V inputs again with 0, 1, ... refit rounds
    (0 = the greedy signs alone): the first round after which their codes
    differ, the entries that differ then, and, for a refit round (which
    assigns each entry to its nearest level), how many of them are
    near-ties of that round's levels on either side."""
    import torch
    from repro_torch.quant.kv import KV_REFINE_ITERS, kv_quantize
    from repro_torch.quant.packing import unpack_signs_last
    for i in range(KV_REFINE_ITERS + 1):
        (ck, ak, bk), (cp, ap, bp) = (kv_quantize(x, bits, gs, iters=i)
                                      for x in (xk, xp))
        if not torch.equal(ck, cp):
            break
    differ = (unpack_signs_last(ck) != unpack_signs_last(cp)).any(dim=-2)
    ties = near_ties(xk, ak, bk) | near_ties(xp, ap, bp)
    return {"first_round_codes_differ": i,
            "entries_differing_then": int(differ.sum()),
            "of_them_near_ties_then": (int((differ & ties).sum()) if i
                                       else None)}


def kv_divergence_witness(cfg, params, prompt, toks, kv_bits, steps=8):
    """Whole-model runs of the quantized-KV path with the kernel and with
    its plain version, teacher-forced on one request's tokens, three
    pools filled by one prefill:
      - kernel: the kernel reads pool A;
      - plain: the plain version reads pool B, which its own
        quantize-on-write fills;
      - shared: the plain version reads pool C, which takes the kernel
        run's quantized values, so it holds what pool A holds.
    Reports the kernel-vs-plain and kernel-vs-shared logits by step and,
    at the first (step, layer) whose written codes differ between A and
    B, how far apart the quantized K/V inputs were and how many entries
    whose codes differ are near-ties of their final levels (on either
    side). The kernel-vs-shared logits must agree within
    TOL_LOGITS."""
    import torch
    from repro_torch.kernels.ref import paged_attention_quant_ref
    from repro_torch.models import (attention, decode_step_paged,
                                    init_paged_cache, prefill,
                                    scatter_prefill_cache)
    from repro_torch.quant.packing import unpack_signs_last
    L, page = len(prompt), 64
    _, row_cache = prefill(cfg, params,
                           torch.tensor(prompt[None], device=DEV), L)
    pools = []
    for _ in range(3):
        pools.append(init_paged_cache(cfg, 4, page, 1, kv_bits=kv_bits,
                                      device=DEV))
        scatter_prefill_cache(cfg, pools[-1], row_cache, 0, [1], L)
    bt = torch.tensor([[1, 2, 3]], dtype=torch.int32, device=DEV)
    kernel, quantize = attention.paged_attention_quant, attention.kv_quantize

    def step(pool, attend, t, writes=None):
        rec = []

        def quantize_rec(x, *a, **kw):
            vals = (writes[len(rec)] if writes is not None
                    else quantize(x, *a, **kw))
            rec.append((x, vals))
            return vals
        attention.paged_attention_quant = attend
        attention.kv_quantize = quantize_rec
        try:
            logits, _ = decode_step_paged(
                cfg, params, pool, torch.tensor([[toks[t]]], device=DEV),
                torch.tensor([L + t], dtype=torch.int32, device=DEV), bt)
        finally:
            attention.paged_attention_quant = kernel
            attention.kv_quantize = quantize
        return logits, rec

    def rel(a, b):
        return float((a - b).abs().max() / a.abs().max())
    plain, shared, first = [], [], None
    for t in range(steps):
        lk, rk = step(pools[0], kernel, t)
        lp, rp = step(pools[1], paged_attention_quant_ref, t)
        ls, _ = step(pools[2], paged_attention_quant_ref, t,
                     writes=[v for _, v in rk])
        plain.append(rel(lk, lp))
        shared.append(rel(lk, ls))
        for layer, ((xk, vk), (xp, vp)) in enumerate(zip(rk, rp)):
            if first is not None or torch.equal(vk[0], vp[0]):
                continue
            differ = (unpack_signs_last(vk[0])
                      != unpack_signs_last(vp[0])).any(dim=-2)
            ties = near_ties(xk, *vk[1:]) | near_ties(xp, *vp[1:])
            first = {"step": t, "layer": layer,
                     "input_rel_diff": rel(xk, xp),
                     "vectors_differing": int(differ.any(-1).sum()),
                     "vectors": xk[..., 0].numel(),
                     "entries_differing": int(differ.sum()),
                     "of_them_near_ties": int((differ & ties).sum()),
                     "max_alpha_rel_diff": rel(vk[1], vp[1]),
                     **first_refit_difference(xk, xp, kv_bits,
                                              xk.shape[-1] // vk[2].shape[-1])}
    sync()
    emit({"check": "kv_bits_path_whole_model", "steps": steps,
          "kernel_vs_plain_rel_err_by_step": plain,
          "kernel_vs_shared_pool_rel_err_by_step": shared,
          "first_quantize_difference": first, "near_tie": NEAR_TIE,
          "tol": TOL_LOGITS})
    require(max(shared) <= TOL_LOGITS, f"kv_bits path: kernel vs plain "
                                       f"logits on one pool differ by "
                                       f"{max(shared):.3g}")


def phase_moe(seed: int, arch: str = "qwen3-moe-235b-a22b",
              n_layers: int = MOE_LAYERS):
    from repro_torch.configs import get_config
    t0 = time.time()
    cfg, params = synthetic_moe(seed, arch, n_layers)
    sync()
    build_s = time.time() - t0
    counts, row, prompts, outs = serve_path("moe_path", cfg, params, seed)
    full = get_config(arch).n_layers
    row.update({"weights_build_s": build_s,
                "depth": f"{n_layers} of {full} layers (cut: the full "
                         f"depth's w3 expert codes exceed the card's "
                         f"memory)",
                "experts": cfg.moe.n_experts, "top_k": cfg.moe.top_k,
                "rep": cfg.n_heads // cfg.n_kv_heads})
    emit(row)
    moe_layers = sum(s.mlp == "moe" for s in cfg.layer_specs())
    require(counts["bcq_expert_matmul"]
            == 3 * moe_layers * (row["decode_ticks"] + row["prefills"]),
            f"moe path: launches {counts}")
    require(counts["paged_attention"] == cfg.n_layers * row["decode_ticks"]
            > 0 and counts["paged_attention_quant"] == 0,
            f"moe path: launches {counts}")
    paged_vs_dense("moe_path", cfg, params, prompts[0], outs[0])
    profile_decode(cfg, params, prompts, tag="moe")
    return counts, row


def profile_decode(cfg, params, prompts, steps: int = 4, kv_bits: int = 0,
                   tag: str = "main"):
    """Where a path's decode step's time goes: the paged decode step at
    batch 4 (each prompt already in its pages), timed untraced, then
    traced with torch.profiler: device busy time per step, kernels per
    step and the kernels that take the most device time. With kv_bits,
    also the quantize-on-write of one step alone (every layer's new K/V
    through kv_quantize), host wall and device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import (decode_step_paged, init_paged_cache,
                                    prefill, scatter_prefill_cache)
    from repro_torch.quant.kv import kv_quantize
    B, page, pps = len(prompts), 64, 3
    pool = init_paged_cache(cfg, B * pps + 1, page, B, kv_bits=kv_bits,
                            device=DEV)
    bt = torch.zeros((B, pps), dtype=torch.int32)
    for b, p in enumerate(prompts):
        ids = list(range(1 + b * pps, 1 + (b + 1) * pps))
        bt[b] = torch.tensor(ids, dtype=torch.int32)
        _, row = prefill(cfg, params, torch.tensor(p[None], device=DEV),
                         len(p))
        scatter_prefill_cache(cfg, pool, row, b, ids[:-(-len(p) // page)],
                              len(p))
    bt = bt.to(DEV)
    pos = torch.tensor([len(p) for p in prompts], dtype=torch.int32,
                       device=DEV)
    tok = torch.zeros((B, 1), dtype=torch.long, device=DEV)

    def run(first):
        for i in range(first, first + steps):
            decode_step_paged(cfg, params, pool, tok, pos + i, bt)
        sync()
    run(0)                                   # warm-up
    t0 = time.perf_counter()
    run(steps)
    untraced = (time.perf_counter() - t0) / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(2 * steps)
        traced = (time.perf_counter() - t0) / steps
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name: dict = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy = sum(by_name.values()) / 1e3 / steps
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    row = {"check": "decode_profile", "path": tag, "batch": B,
           "kv_bits": kv_bits, "steps": steps,
           "wall_ms_per_step": untraced * 1e3,
           "traced_wall_ms_per_step": traced * 1e3,
           "device_busy_ms_per_step": busy,
           # idle share of the untraced step (tracing slows the host)
           "device_idle_share": (1 - busy / (untraced * 1e3)) if busy
           else None,
           "kernels_per_step": len(kernels) / steps,
           # the GEMM's split-K second pass; the decode GEMV has none
           "splitk_reduce_per_step": sum("splitk_reduce" in e.name
                                         for e in kernels) / steps,
           "top_kernels_ms_per_step": [
               {"name": n[:80], "ms": us / 1e3 / steps} for n, us in top]}
    if kv_bits:
        new = torch.randn((2, B, cfg.n_kv_heads, cfg.resolved_head_dim),
                          device=DEV)

        def quantize_step():
            for _ in range(cfg.n_layers):
                kv_quantize(new, kv_bits)
        quantize_step()
        sync()
        t0 = time.perf_counter()
        for _ in range(steps):
            quantize_step()
        sync()
        q_wall = (time.perf_counter() - t0) / steps * 1e3
        q_dev = kernel_ms(quantize_step, steps)["device_ms"]
        with profile(activities=[ProfilerActivity.CPU]) as qprof:
            quantize_step()
            sync()
        ops = sorted(qprof.key_averages(), key=lambda e: -e.self_cpu_time_total)
        row.update({"kv_quantize_wall_ms_per_step": q_wall,
                    "kv_quantize_share_of_step": q_wall / (untraced * 1e3),
                    "kv_quantize_device_ms_per_step": q_dev,
                    "kv_quantize_top_host_ops_ms_per_step": [
                        {"name": e.key[:60], "calls": e.count,
                         "ms": e.self_cpu_time_total / 1e3}
                        for e in ops[:8]]})
    emit(row)
    require(DEV != "cuda" or row["splitk_reduce_per_step"] == 0,
            f"{tag} decode: a split-K reduce ran ({row})")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default="1,2,3,4,5")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    phases = {int(p) for p in args.phases.split(",")}

    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: the port's sources (src/repro_torch) are not "
              "beside this script", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    print(card, flush=True)
    emit({"torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0), "card": card})

    from repro_torch.kernels import build
    t0 = time.time()
    out = build.build_all()
    emit({"check": "build", "seconds": time.time() - t0,
          "dir": str(out.relative_to(ROOT))})
    for log in sorted(out.glob("*.log")):
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas[{log.stem}] {line.strip()}")
    try:
        sass_check(out)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    gen = torch.Generator(device=DEV)
    gen.manual_seed(args.seed)
    lines = {k: {"name": k, "route": "cuda", "source": KERNEL_ROWS[k][0],
                 "replaces": KERNEL_ROWS[k][1], "launches": 0,
                 "launches_by_path": {}}
             for k in KERNEL_ROWS}

    def phase_done(n, t0):
        emit({"check": "phase_done", "phase": n,
              "seconds": time.time() - t0})

    def count(path, counts):
        for k in lines:
            lines[k]["launches_by_path"][path] = counts[k]
            lines[k]["launches"] += counts[k]
    try:
        if 1 in phases:
            t0 = time.time()
            worst, n_checks = check_bcq(gen, LLAMA_SHAPES)
            worst_q, n_q = check_bcq(gen, QWEN_SHAPES, GEMV_MS)
            worst["bcq_gemv"] = max(worst["bcq_gemv"], worst_q["bcq_gemv"])
            n_checks["bcq_gemv"] += n_q["bcq_gemv"]
            worst["paged_attention"] = check_paged(gen)
            worst["paged_attention_quant"] = max(
                check_paged_quant(gen), check_paged_quant_grid(args.seed))
            worst["bcq_expert_matmul"], n_exact = check_expert(gen)
            summaries = {
                "bcq_gemv": summarize_bcq(gen, "bcq_gemv", 4, 4096, 11008),
                "bcq_matmul": summarize_bcq(gen, "bcq_matmul", 128, 4096,
                                            11008),
                "bcq_expert_matmul": summarize_expert(gen),
                "paged_attention": summarize_paged(gen),
                "paged_attention_quant": summarize_paged_quant(gen)}
            for k in lines:
                lines[k].update(summaries[k])
                lines[k]["max_rel_err_all_checks"] = worst[k]
            lines["bcq_expert_matmul"]["experts_bit_equal_to_single"] = \
                n_exact
            for k in ("bcq_gemv", "bcq_matmul"):
                lines[k]["checks"] = n_checks[k]
            # the rep-16 geometry of phase 5 (Qwen3-MoE), beside the lines
            emit({"check": "paged_attention_rep16",
                  **summarize_paged(gen, Hkv=4, rep=16)})
            emit({"check": "paged_attention_quant_rep16",
                  **summarize_paged_quant(gen, Hkv=4, rep=16)})
            # the GEMV at one and eight rows, beside the line's four
            for M in (1, 8):
                emit({"check": "bcq_gemv_shape",
                      **summarize_bcq(gen, "bcq_gemv", M, 4096, 11008)})
            emit({"check": "bcq_expert_matmul_prefill",
                  **summarize_expert(gen, M=16, routed=False)})
            # the GEMM at the other prefill buckets and at Qwen3-MoE's
            # attention projections (k/v N=512, q N=8192)
            for M, K, N in GEMM_SHAPES:
                emit({"check": "bcq_matmul_shape",
                      **summarize_bcq(gen, "bcq_matmul", M, K, N)})
            phase_done(1, t0)
        if 2 in phases:
            t0 = time.time()
            phase_fixture()
            phase_done(2, t0)
        llama = None
        if phases & {3, 4}:
            t0 = time.time()
            llama = synthetic_llama(args.seed)
            sync()
            llama_build_s = time.time() - t0
        if 3 in phases:
            t0 = time.time()
            counts, _ = phase_main_path(args.seed, llama, llama_build_s)
            count("main_path", counts)
            phase_done(3, t0)
        if 4 in phases:
            t0 = time.time()
            counts, _ = phase_kv_bits(args.seed, llama)
            count("kv_bits_path", counts)
            phase_done(4, t0)
        del llama                # free the llama weights before phase 5
        gc.collect()
        torch.cuda.empty_cache()
        if 5 in phases:
            t0 = time.time()
            counts, _ = phase_moe(args.seed)
            count("moe_path", counts)
            phase_done(5, t0)
        torch.cuda.synchronize()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    emit({"kernels": list(lines.values())})
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
