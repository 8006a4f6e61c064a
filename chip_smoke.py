#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA
GPU, from the root of a checkout:

    python3 chip_smoke.py [--phases 1,2,3] [--seed 0]

It builds the port's CUDA kernels from `src/repro_torch/csrc/` and runs
three phases; any failure is a non-zero exit.

  1. kernels: each kernel against its plain PyTorch version on the same
     card at the llama2-7b main-path shapes (BCQ GEMV M in {1,4,8} and
     GEMM M in {9,128} on 4096x4096, 4096x11008, 11008x4096, w3
     per-channel and group 128, fp32 and bf16 scales; paged attention at
     B=4, Hkv=32, hd=128, page 64, ragged contexts), with times.
  2. reference fixture: the committed tiny-lm artifacts
     (tests/data/torch_port/) served on the card through the launcher and
     the paged ServeEngine; logits and greedy tokens are held against
     those the JAX reference recorded.
  3. main path at full width: seeded synthetic w3 per-channel packed
     llama2-7b (32 layers) served by the paged engine, 4 requests with
     16-100 token prompts and 32 new tokens each, with per-kernel launch
     counts.

The line before the last is {"kernels": [...]} (one entry per ported
kernel: launches on the main path, error against the plain version,
time, bound, plain and library times); the last line is
{"ok": true, "device": {...}}. It exits non-zero without a result when
no CUDA device is available or the port's sources are missing.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
FIXTURE = ROOT / "tests" / "data" / "torch_port"

# H100 SXM peaks (NVIDIA data sheet; dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12

# tolerances, relative to max|reference| of each output
TOL_FP32 = 2e-5       # fp32 sums of up to 11008 products in another order
TOL_BF16 = 1e-2       # bf16 outputs: one bf16 ulp is 2^-8 of |y|
TOL_LOGITS = 1e-4     # whole-model logits vs the reference (fixture's own)

KERNEL_ROWS = {
    "bcq_gemv": ("src/repro_torch/csrc/bcq_matmul.cu",
                 "src/repro/kernels/bcq_matmul.py:218"),
    "bcq_matmul": ("src/repro_torch/csrc/bcq_matmul.cu",
                   "src/repro/kernels/bcq_matmul.py:162"),
    "paged_attention": ("src/repro_torch/csrc/paged_attention.cu",
                        "src/repro/kernels/paged_attention.py:145"),
}


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


def bound_ms(n_bytes: float, flops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 1: kernels vs plain versions
# ---------------------------------------------------------------------------

def random_qt(gen, K, N, gs, scale_dtype, bits=3, beta_scale=0.1):
    """Seeded random packed weight on the card: uniform code words,
    alphas (4,2,1)/sqrt(21) * K^-0.5 (so W has std ~K^-0.5), small
    random betas."""
    import torch
    from repro_torch.quant import QuantizedTensor
    G = 1 if gs == 0 else K // gs
    codes = torch.randint(-2 ** 31, 2 ** 31, (bits, K // 32, N),
                          dtype=torch.int32, generator=gen, device=DEV)
    base = torch.tensor([4.0, 2.0, 1.0][:bits], device=DEV)
    base = base / base.square().sum().sqrt() * K ** -0.5
    jitter = 1 + 0.1 * torch.rand((G, N, bits), generator=gen, device=DEV)
    alphas = (base * jitter).to(scale_dtype).contiguous()
    betas = (torch.randn((G, N), generator=gen, device=DEV)
             * beta_scale * K ** -0.5).to(scale_dtype)
    return QuantizedTensor(codes, alphas, betas, K, "float32")


LLAMA_SHAPES = [(4096, 4096), (4096, 11008), (11008, 4096)]


def check_bcq(gen, shapes):
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
                for M in (1, 4, 8, 9, 128):
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
                for M in (4, 128):
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
    b, by = bound_ms(n_bytes, 2.0 * M * K * N)
    return {"max_abs_err": err, "ms": best_ms(t), "plain_ms": plain_ms,
            "bound_ms": b, "bound_by": by, "library_ms": lib_ms,
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


def summarize_paged(gen):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.kernels.ref import paged_attention_ref
    B, Hkv, rep, hd, page = 4, 32, 1, 128, 64
    ctx = [50, 80, 110, 131]
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
        qs, k, v, attn_mask=mask), 200))
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


# ---------------------------------------------------------------------------
# phase 2: the reference fixture on the card
# ---------------------------------------------------------------------------

def phase_fixture():
    import numpy as np
    import torch
    from repro_torch.ckpt import load_packed
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import main as launch_main
    from repro_torch.models import (decode_step_paged, init_paged_cache,
                                    prefill, scatter_prefill_cache)
    from repro_torch.serve import Request, ServeEngine

    ref = json.loads((FIXTURE / "reference.json").read_text())
    out = {}
    for name, art in ref["artifacts"].items():
        params, _, meta = load_packed(FIXTURE / name, device=DEV)
        cfg = get_config(meta["arch"]).replace(
            dtype="float32", n_layers=len(params["layers"]))
        worst = 0.0
        page = 16
        for prompt, toks, pl, dl in zip(art["prompts"], art["tokens"],
                                        art["prefill_logits"],
                                        art["decode_logits"]):
            L = len(prompt)
            logits, row = prefill(cfg, params,
                                  torch.tensor([prompt], device=DEV), L)
            steps = [(logits[0], pl)]
            n_pg = -(-(L + len(toks)) // page)
            cache = init_paged_cache(cfg, n_pg + 1, page, 1, device=DEV)
            ids = list(range(1, n_pg + 1))
            scatter_prefill_cache(cfg, cache, row, 0, ids[:-(-L // page)], L)
            bt = torch.tensor([ids], dtype=torch.int32, device=DEV)
            for t, want in enumerate(dl):
                logits, cache = decode_step_paged(
                    cfg, params, cache,
                    torch.tensor([[toks[t]]], device=DEV),
                    torch.tensor([L + t], dtype=torch.int32, device=DEV),
                    bt)
                steps.append((logits[0], want))
            for got, want in steps:
                want = np.asarray(want, np.float64)
                d = np.abs(got.double().cpu().numpy() - want).max()
                worst = max(worst, d / (TOL_LOGITS * np.abs(want).max()))
        eng = ServeEngine(cfg, params, batch_size=2, max_len=64,
                          dtype="float32", cache_kind="paged", page_size=16,
                          device=DEV)
        reqs = [Request(prompt=np.asarray(p, np.int32),
                        max_new_tokens=ref["max_new"])
                for p in art["prompts"]]
        eng.run(reqs)
        match = sum(r.out == t for r, t in zip(reqs, art["tokens"]))
        row = {"check": "fixture", "artifact": name,
               "logits_err_over_tol": worst, "tol_rel": TOL_LOGITS,
               "greedy_match": f"{match}/{len(reqs)}"}
        emit(row)
        require(worst <= 1.0, f"fixture {name}: logits off by {worst:.3g} "
                              f"x the tolerance")
        require(match == len(reqs), f"fixture {name}: greedy tokens differ")
        out[name] = row
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

def synthetic_llama(seed: int, arch: str = "llama2-7b"):
    """llama2-7b at full width and depth with seeded synthetic w3
    per-channel packed linears (betas 0) and fp32 embeddings, head and
    norms from the port's init_params."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.quant import QuantizedTensor
    cfg = get_config(arch).replace(dtype="float32")
    params = init_params(cfg.replace(n_layers=0), seed=seed,
                         dtype="float32", device=DEV)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(seed + 1)
    base = torch.tensor([4.0, 2.0, 1.0], device=DEV)
    base = base / base.square().sum().sqrt()

    def qt(K, N):
        codes = torch.randint(-2 ** 31, 2 ** 31, (3, K // 32, N),
                              dtype=torch.int32, generator=gen,
                              device=DEV)
        alphas = (base * K ** -0.5).expand(1, N, 3).contiguous()
        betas = torch.zeros((1, N), device=DEV)
        return QuantizedTensor(codes, alphas, betas, K, "float32")

    d, f = cfg.d_model, cfg.d_ff
    hd = cfg.resolved_head_dim
    params["layers"] = [
        {"ln": torch.zeros(d, device=DEV),
         "attn": {"wq": qt(d, cfg.n_heads * hd),
                  "wk": qt(d, cfg.n_kv_heads * hd),
                  "wv": qt(d, cfg.n_kv_heads * hd),
                  "wo": qt(cfg.n_heads * hd, d)},
         "ln2": torch.zeros(d, device=DEV),
         "mlp": {"wg": qt(d, f), "wu": qt(d, f), "wd": qt(f, d)}}
        for _ in range(cfg.n_layers)]
    return cfg, params


def phase_main_path(seed: int, arch: str = "llama2-7b"):
    import numpy as np
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import (decode_step, decode_step_paged,
                                    init_cache, init_paged_cache, prefill,
                                    scatter_prefill_cache)
    from repro_torch.serve import Request, ServeEngine

    t0 = time.time()
    cfg, params = synthetic_llama(seed, arch)
    sync()
    build_s = time.time() - t0
    codes_bytes = sum(l[g][w].codes.numel() * 4 for l in params["layers"]
                      for g in ("attn", "mlp") for w in l[g])
    rng = np.random.default_rng(seed)
    lens = [16, 45, 77, 100]
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in lens]
    eng = ServeEngine(cfg, params, batch_size=4, max_len=160,
                      dtype="float32", cache_kind="paged", page_size=64,
                      device=DEV)
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
    row = {"check": "main_path", "model": cfg.name, "layers": cfg.n_layers,
           "requests": len(reqs), "prompt_lens": lens, "max_new": 32,
           "packed_code_bytes": codes_bytes, "weights_build_s": build_s,
           "wall_s": wall, "prefill_s": st["prefill_s"],
           "prefill_tokens": st["prefill_tokens"],
           "decode_s": st["decode_s"], "decode_ticks": st["ticks"],
           "decode_tokens": st["tokens"],
           "decode_tok_per_s": st["tokens"] / max(st["decode_s"], 1e-9),
           "decode_ms_per_tick": 1e3 * st["decode_s"] / max(st["ticks"], 1),
           "ttft_avg_s": st["ttft_avg_s"], "tpot_avg_s": st["tpot_avg_s"],
           "peak_mem_gb": (torch.cuda.max_memory_allocated() / 1e9
                           if DEV == "cuda" else None),
           "launches": counts}
    emit(row)
    require(all(r.done and len(r.out) == 32 for r in reqs),
            "main path: a request did not finish with 32 tokens")
    require(all(0 <= t < cfg.vocab_size for r in reqs for t in r.out),
            "main path: token out of the vocabulary")
    for k in ("bcq_gemv", "bcq_matmul", "paged_attention"):
        require(counts[k] > 0, f"main path: {k} was never launched")
    require(counts["bcq_plain"] == 0, "main path: a BCQ call took the "
                                      "plain path")
    require(eng.kv.free_page_count == eng.kv.usable_pages,
            "main path: pages did not drain back to the pool")

    # the paged path (paged-attention kernel, page scatter) against the
    # dense-cache torch path, teacher-forced on request 0's tokens
    prompt, toks = prompts[0], reqs[0].out
    L = len(prompt)
    steps = 8
    tok_t = torch.tensor(prompt[None], device=DEV)
    logits_d, row_cache = prefill(cfg, params, tok_t, L + steps)
    require(bool(torch.isfinite(logits_d).all())
            and tuple(logits_d.shape) == (1, cfg.vocab_size),
            "main path: prefill logits not finite / wrong shape")
    dense = row_cache
    logits_p, prow = prefill(cfg, params, tok_t, L)
    page = 64
    pool = init_paged_cache(cfg, 4, page, 1, device=DEV)
    scatter_prefill_cache(cfg, pool, prow, 0, [1], L)
    bt = torch.tensor([[1, 2, 3]], dtype=torch.int32, device=DEV)
    worst = 0.0
    for t in range(steps):
        tk = torch.tensor([[toks[t]]], device=DEV)
        pos = torch.tensor([L + t], dtype=torch.int32, device=DEV)
        ld, dense = decode_step(cfg, params, dense, tk, pos)
        lp, pool = decode_step_paged(cfg, params, pool, tk, pos, bt)
        worst = max(worst, float((ld - lp).abs().max() / ld.abs().max()))
        require(bool(torch.isfinite(lp).all()), "main path: decode logits "
                                                "not finite")
    sync()
    emit({"check": "main_path_paged_vs_dense", "steps": steps,
          "rel_err": worst, "tol": TOL_LOGITS})
    require(worst <= TOL_LOGITS, f"main path: paged vs dense logits differ "
                                 f"by {worst:.3g}")
    profile_decode(cfg, params, prompts)
    return counts, row


def profile_decode(cfg, params, prompts, steps: int = 4):
    """Where a main-path decode step's time goes: the paged decode step
    at batch 4 (each prompt already in its pages), timed untraced, then
    traced with torch.profiler: device busy time per step, kernels per
    step and the kernels that take the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import (decode_step_paged, init_paged_cache,
                                    prefill, scatter_prefill_cache)
    B, page, pps = len(prompts), 64, 3
    pool = init_paged_cache(cfg, B * pps + 1, page, B, device=DEV)
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
    emit({"check": "decode_profile", "batch": B, "steps": steps,
          "wall_ms_per_step": untraced * 1e3,
          "traced_wall_ms_per_step": traced * 1e3,
          "device_busy_ms_per_step": busy,
          # idle share of the untraced step (tracing slows the host)
          "device_idle_share": (1 - busy / (untraced * 1e3)) if busy
          else None,
          "kernels_per_step": len(kernels) / steps,
          "top_kernels_ms_per_step": [
              {"name": n[:80], "ms": us / 1e3 / steps} for n, us in top]})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default="1,2,3")
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

    gen = torch.Generator(device=DEV)
    gen.manual_seed(args.seed)
    lines = {k: {"name": k, "route": "cuda", "source": KERNEL_ROWS[k][0],
                 "replaces": KERNEL_ROWS[k][1], "launches": 0}
             for k in KERNEL_ROWS}
    try:
        if 1 in phases:
            worst, n_checks = check_bcq(gen, LLAMA_SHAPES)
            worst["paged_attention"] = check_paged(gen)
            summaries = {
                "bcq_gemv": summarize_bcq(gen, "bcq_gemv", 4, 4096, 11008),
                "bcq_matmul": summarize_bcq(gen, "bcq_matmul", 128, 4096,
                                            11008),
                "paged_attention": summarize_paged(gen)}
            for k in lines:
                lines[k].update(summaries[k])
                lines[k]["max_rel_err_all_checks"] = worst[k]
        if 2 in phases:
            phase_fixture()
        if 3 in phases:
            counts, _ = phase_main_path(args.seed)
            for k in lines:
                lines[k]["launches"] = counts[k]
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
