#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA
GPU, from the root of a checkout:

    python3 chip_smoke.py [--phases 1,2,3,4,5,6,7,8,9,10,11,12,13] [--seed 0]

It builds the port's CUDA kernels from `src/repro_torch/csrc/` and runs
thirteen phases (in the order 1, 2, 3, 4, 6, 8, 12, 7, 5, 9, 10, 11,
13: phases 8 and 12 run on phase 3's model before it is freed, and 7,
5, 9, 10 and 13 each free their own); any failure is a non-zero exit.

  1. kernels: each kernel against its plain PyTorch version on the same
     card at the main-path shapes (BCQ GEMV every M in 1..8 and the
     tensor-core GEMM M in {9,16,64,128} on 4096x4096, 4096x11008,
     11008x4096, the GEMV also on Qwen3-MoE's 4096x8192 and 4096x512,
     w3 per-channel and group 128, fp32 and bf16 scales; on the llama
     shapes also draft views, 2 of the 3 stored planes with their own
     scales, through the GEMV at M 1..8 and the GEMM at M 12 and 20;
     the batched-expert GEMM at E=128, M in {4,16}, 4096x1536 and
     1536x4096, also bit for bit against the single-matrix kernels
     expert by expert, with and without the rows of a routing; paged
     attention over fp and 2/3/4-bit binary-coded pages at the
     llama2-7b (Hkv 32, rep 1) and Qwen3-MoE (Hkv 4, rep 16)
     geometries, page 64, ragged contexts, window and cap, and the
     binary-coded reader over bits 1..8 x hd {32, 64, 128, 256} x G in
     {1, 2, hd/32} and its edge layouts, with windows, caps, bf16 q and
     contexts ending mid-partition), with times; then phase 9's shapes:
     the GEMV and GEMM at minicpm3-4b's 2560->288, 256->5120 (M up to
     768, its latent expansion) and 2560->768, gemma2-27b's
     36864->4608, falcon-mamba-7b's 4096->16384 and 8192->4096, the
     expert kernel at jamba-1.5-large's 16 experts of 8192<->24576, and
     attention at gemma2's (rep 2, window, cap 50) and jamba's (rep 8)
     geometries, and fp attention at head_dim 16 (the zoo's smoke
     configs: rep 1, 2, 4 and 16, windows, caps, long contexts); the
     GEMM at phase 10's perplexity shape (M = 2048 on
     llama2-7b's three shapes) and at MLA's latent expansion (M = 768,
     256 -> 5120), with plain and torch.matmul times; then phase 12's
     shard shapes on a 2-way model axis (MESH_SHARD_SHAPES: the GEMV at
     a rank's falcon-mamba, minicpm3 and jamba linears, `*_mesh` lines)
     and the expert kernel at 8 experts of 8192<->24576; both attention
     kernels at a rank's KV head of phase 12's replicated Qwen3-MoE pool
     (a 4-head pool, kv0 0..3, rep 8, fp, 4-bit G 1 and groups of 32;
     `*_rank` lines and timed rows); after the build, the
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
     counts; a `dryrun_check` line: the dry run's w3 stand-ins
     (quant/abstract.py) have the served leaves' shapes and their code
     and scale bytes, exactly, and its FLOPs, memory term and bound of
     the batch-4 decode step stand beside the graph's measured device
     ms a step.
  4. binary-coded KV at full width: phase 3's model and requests with
     4-bit KV pages (one group per head vector).
  5. MoE at full width: seeded synthetic w3 per-channel qwen3-moe-235b-a22b
     (128 experts top-8), cut to 16 of its 94 layers, 4 requests, 32 new
     tokens each, fp KV pages.
  6. shared prefixes and chunked prefill at full width: phase 3's model,
     a 192-token system prefix and the four suffixes, in three waves
     (request 0; requests 1-3, which hit the prefix; request 0's prompt +
     its first 8 tokens, which forks request 0's tail page copy-on-write)
     through engines with prefix sharing, without, and with 64-token
     chunked prefill, 32 new tokens each, max_len 384; the waves again
     with 4-bit KV pages, sharing and chunks, 8 new tokens each. Checks
     hits, forks, the prefill tokens saved, byte-equal forked leaves,
     extend against prefill logits, greedy tokens against the no-sharing
     engine, launches and page accounting; times TTFT per wave and the
     extend path's share of prefill.
  7. quantize, save, load and serve at full width: seeded fp32
     llama2-7b (init_params), cut to 1 of 32 layers, calibrated on 24
     slices of 192 tokens of the port's wiki corpus and quantized by
     quantize_model (GPTQT w3 per-channel, actorder), saved by
     save_packed, loaded by load_packed and served (phase 3's requests)
     with launch counts; then one layer at group 128 saved with bf16
     scales. Checks every quantized matrix's finite scales and its
     dequant against the solver's levels (1e-6 x max|w|), the save/load
     round trip byte for byte, layer 0's wq and wd slices quantized on
     the card against the CPU path on the card's own Hessians (picks,
     codes and output error outside recorded near-ties), and the loaded
     artifact's greedy tokens against the in-memory params'; prints
     seconds per stage, layer and in total, peak memory, and per leaf
     GPTQT's output error beside RTN's. The artifact carries the v4
     draft block (draft_bits=2): its scales must equal a refit of the
     loaded params on the card bit for bit, a load-then-save with the
     block must be byte-equal, and the artifact served with speculate=4
     from the block must give the plain serving's tokens (up to a
     printed near-tie).
  8. self-speculative decoding at full width: phase 3's model and
     requests through speculative paged engines: A, a w2 view of the
     target's codes with scales refit at boot, k=4; B, the same draft,
     k=1 (verify at 8 rows stays on the GEMV); C, a perfect draft (the
     target's params), k=4. Each must give phase 3's tokens (up to a
     printed near-tie), launch the GEMV, paged attention and (A, C) the
     GEMM and never the plain BCQ path, drain its pages, and add exactly
     its scale bytes with codes sharing the target's storage; C must
     accept at least 95 % of its draft tokens; one draft_propose_paged
     call must run with no device-to-host copy. Prints a
     `speculative_path` line an engine and a `speculative_profile` line
     (one tick of A, propose and verify, beside phase 3's decode step).
  9. the model zoo at full width: seeded synthetic w3 per-channel packs
     (phase 3's requests, fp32 KV, 64-token pages) of minicpm3-4b (MLA
     on latent pages, 32 of 62 layers), falcon-mamba-7b (Mamba with
     state slabs, 32 of 64 layers), gemma2-27b (sandwich norms, caps 50
     and 30, alternating window 4096 prefilled through the extend path,
     24 of 46 layers) and jamba-1.5-large-398b (one super-block, 8 of 72 layers:
     7 Mamba, 1 attention, 4 MoE layers of 16 experts), each through the
     paged engine with a `zoo_path` and a `decode_profile` line;
     minicpm3 and falcon-mamba also through the dense engine, whose
     tokens must equal the paged engine's up to a printed near-tie.
     Every request finishes, pages and slabs drain, no BCQ call takes
     the plain path, and paged attention launches once a decode tick
     in every attention layer (none under MLA).
 10. training and perplexity at full width: (a) llama2-7b cut to 1 of
     32 layers, fp32, remat full, AdamW (lr 1e-3), wiki batches of 4 x
     512 in 2 microbatches: run A trains 4 steps; run B trains 2, saves
     a checkpoint (8.0 GB, in a temporary directory the phase
     deletes), and a new Trainer resumes it to 4, landing within 1e-5
     x max|p| of A (`train_path`: ms, tokens/s and model-FLOP share a
     step, peak memory, checkpoint bytes, save and restore seconds);
     (b) A's model quantized to RTN w3 per-channel (packed, the RTN
     grid as its exact binary coding) and its perplexity on 4 eval
     batches of 4 x 512 through the BCQ GEMM at M = 2048, equal to its
     dequantized weights' through torch.matmul within 1e-5 relative
     (`eval_path`); (c) tiny-lm trained 300 steps on the card and its
     perplexity fp / RTN w3 / GPTQT w3 (`ppl_table`, each packed one
     held to its dequantized weights), and the fixture's w3_moe through
     the batched-expert kernel; (d) hubert-xlarge at full width (48
     layers, frames (2, 256, 1280)): one loss and its gradients, finite
     (`train_path_encoder`). The packed evaluations launch the GEMM and
     the expert kernel and nothing else, never the plain BCQ path. A
     `dryrun_check` line: the dry run of (a)'s step has the Trainer's
     parameter and AdamW element counts, its model FLOPs are what the
     model-FLOP share divides by, and its peak of live storages stands
     beside the measured peak memory.
 11. the dry run (launch/dryrun.py) on the meta device: the 32 (arch x
     shape) cells of the ten pool architectures at bf16, then the 22
     inference cells w3 packed, DRYRUN_JOBS at once in worker
     processes (the longest traces handed out first), a `dryrun` line
     each (bytes of params, cache and train state, peak of live storages
     against the card's 80 GB, the three roofline terms and the bound);
     a cell that fails fails the run. Nothing runs on the card: the
     cells trace in the background at the least priority from the end
     of the build on, beside phases 1-8 (BackgroundDryRun), and phase 11
     waits for them (`dryrun_background` line).
 12. meshes of ranks on the one card (torch.distributed over gloo, the
     ranks sharing cuda:0, dist/context.py): phase 3's model (32 layers
     on the data axis, cut to 4 on a model axis and under FSDP), saved
     by save_packed with a w2 draft block and served (phase 3's
     prompts, 32 new tokens each; 16 and 8 under FSDP) on (data, model)
     meshes (1, 2), (2, 1) and (2, 2), each rank loading its slice with
     load_packed(mesh=); speculatively (k=4, the draft block cut by
     load_draft_scales(mesh=)) on (2, 1) and (1, 2); FSDP-sharded
     (load_packed(mesh=, fsdp=True): every weight leaf's data-axis block
     a rank, gathered layer by layer) on (2, 1), plainly and
     speculatively (8 new tokens); then Qwen3-MoE cut to 4 of 94 layers
     with its experts on a (1, 2) model axis, and minicpm3-4b (MLA, 8
     of 62 layers), falcon-mamba-7b (8 of 64) and jamba-1.5-large (8 of
     72) on (1, 2), each rank cutting the seeded model with
     shard_params; Qwen3-MoE cut to 2 layers on (1, 8), whose 4 KV heads
     the axis does not divide (wk, wv and the fp or 4-bit pool whole on
     every rank, each rank's 8 query heads reading one KV head), built
     and cut once and each rank's slice saved; minicpm3-4b (8 layers)
     through the dense engine on (1, 2), its latent cache split along
     the sequence. One spawn of eight ranks serves the meshes in turn.
     Every mesh must give the single-device engine's greedy tokens (up
     to a printed near-tie; a speculative mesh its plain tokens) with
     every logits row within TOL_LOGITS x max|logit| of its (a verify
     row where its context holds the emitted tokens), drain every shard
     (and state slab), keep each rank's page ids in its block, and
     launch the GEMV, the GEMM, paged attention (fp or binary-coded; not
     under MLA or on a dense engine) and the expert kernel (MoE) on
     every rank at its shard's shapes with no plain BCQ call; a
     speculative mesh's ranks accept alike; an FSDP rank holds 1/D of
     every field the data axis cuts and the rest whole. A `mesh_path`
     line a mesh: backend and devices, the card, per rank the load
     seconds, the decode step's (speculative tick's) wall ms and traced
     device-busy ms, collectives a step, one all-reduce's ms (timed
     alone), one layer's FSDP gather ms, parameter and pool bytes; with
     speculation the acceptance and ticks.
 13. training over meshes of ranks on the one card (gloo, the ranks
     sharing cuda:0): llama2-7b at full width cut to 1 of its 32 layers,
     fp32, remat full, TF32 off, wiki batches of 4 x 256, 3 steps, on
     (2, 1) with FSDP and (1, 2) side by side, then (2, 2) with FSDP, 2
     microbatches and int8 accumulation (make_train_step(mesh=), each
     rank holding its blocks of the params and AdamW by the reference's
     rules). Each mesh is held to the single device's run of the same
     options: losses and gradient norms within TOL_TRAIN_MESH relative,
     each leaf of AdamW's mu within TOL_TRAIN_MESH x max|mu| (or, for a
     model whose gradients cancel, TRAIN_MESH_FLOOR_X x its one-device
     noise floor, 2 microbatches against 1), each params leaf within
     TOL_TRAIN_MESH of its norm (its largest entry error printed beside
     the floor); a rank holds exactly the bytes of the rule's blocks
     (shard_params' for the leaves the port cuts otherwise) and peaks
     below one device. (2, 2) saves its state whole at step 2 and a
     single-device Trainer resumes it to step 3, held alike. Then, alike
     and with four ranks, the other families (TRAIN_MESH_FAMILIES):
     mixtral-8x7b cut to 1 of 32 layers with its experts on the model
     axis, 2 microbatches, on (1, 2) and on (2, 2) with FSDP, each data
     rank routing the whole microbatch (every mesh drops the single
     device's (token, choice) pairs a step, its aux loss beside them);
     minicpm3-4b (MLA) cut to 2 of 62 layers on (1, 2) and (2, 2) with
     FSDP;
     falcon-mamba-7b cut to 2 of 64 layers on (1, 2) and (2, 2) with
     FSDP, 2 microbatches and int8. A `train_mesh_path` line a mesh: per
     rank the wall ms of each step and the device-busy ms of the last
     (traced), the collectives of a step by kind and direction, one
     layer's gather and reduce-scatter ms (or an activation's
     all-reduce), the bytes held beside the whole state's, shard_params'
     and the reference's specs', one gathered layer's bytes, peak
     memory, save and restore seconds.

Phases 2-9 serve through ServeEngine, whose decode step, draft
propose pass and verify come from serve/compile_cache.py: on the card
each is a CUDA graph captured on its first call and replayed after that,
so every token, launch-count and drain gate of those phases holds on the
graphs. Each `decode_profile` line times the eager step beside its
replayed graph on the same pool (graph_* fields; logits within
TOL_GRAPH of the eager step's, expected equal), phase 8's
`speculative_profile` does the same for a propose + verify tick, and
`decode_step_sync` lines (phases 3 and 4) hold one eager step and one
replay to no device-to-host copy. After each path's models are freed a
`compile_cache` line gives the cache's stats, graphs captured, capture
seconds, replays and the kernel launches inside them, and the memory
allocated and reserved before and after clear(): no graph may outlive
the params and pool it reads. The GEMV, the GEMM, the expert kernel and
both attention kernels must each run inside a replayed graph on some
path.

Phases 2-5, 7, 8, 9 and 12 serve without a prefix index
(prefix_sharing=False), as they did before it existed. Each path
(phases 3-10, 12 and 13; in phase 8 each engine's run, in phase 10
each packed evaluation, in phases 12 and 13 each rank's run, its counts
summed over the ranks) is driven with every launch count set to 0 just
before it and read just after. Phase 12's steps run eagerly on a model axis > 1
and under FSDP (gloo's collectives cannot be captured in a CUDA
graph); the data-only (2, 1) mesh of replicated weights replays graphs
as one device does.
The line before the last is
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
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
FIXTURE = ROOT / "tests" / "data" / "torch_port"

# tolerances, relative to max|reference| of each output
TOL_FP32 = 2e-5       # fp32 sums of up to 11008 products in another order
TOL_BF16 = 1e-2       # bf16 outputs: one bf16 ulp is 2^-8 of |y|
TOL_LOGITS = 1e-4     # whole-model logits vs the reference (fixture's own)
# a replayed CUDA graph against the eager step it captured: the same
# kernels in the same order on the same inputs (expected 0.0)
TOL_GRAPH = 1e-6
# what may stay allocated on the card once a path's models are freed
# (cuBLAS workspaces, the smoke's own small tensors); any model's params
# are several GB
FREED_ALLOCATED_GB = 1.0

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
# the card's name and power limit (nvidia-smi), beside phase 12's figures
CARD = ""


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
    from repro_torch.roofline.op_profile import (kernel_time_by_name,
                                                 traced_kernels)
    event = cuda_ms(fn, iters)
    if DEV != "cuda":
        return {"device_ms": None, "event_ms": event}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(kernel_time_by_name(traced_kernels(prof)).values())
    return {"device_ms": us / 1e3 / iters if us else None, "event_ms": event}


def best_ms(t: dict) -> float:
    return t["device_ms"] if t["device_ms"] is not None else t["event_ms"]


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
# a speculative draft's weights: the leading DRAFT_PLANES of w3 codes
# with their own scales, through the GEMV at every batch (M 1-8), and
# the verify pass's rows at batch 4 through the GEMM: M = 4 (k + 1) at
# k = 2 and 4
DRAFT_PLANES = 2
DRAFT_MS = GEMV_MS + (12, 20)
# (M, K, N) of the GEMM beside its line: llama2-7b's prefill buckets 16
# and 64, a k=4 verify at batch 4 (M=20), Qwen3-MoE's k/v (N=512) and q
# (N=8192) projections
GEMM_SHAPES = ((16, 4096, 11008), (64, 4096, 11008), (20, 4096, 11008),
               (16, 4096, 512), (128, 4096, 512), (16, 4096, 8192),
               (128, 4096, 8192))
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


def draft_operands(qt, planes=DRAFT_PLANES):
    """(codes, alphas, betas) of a draft view of `qt`: its leading
    `planes` code planes, as kernels/ops.py slices them (no copy), with
    the leading alphas as its scales."""
    return (qt.codes[..., :planes, :, :],
            qt.alphas[..., :planes].contiguous(), qt.betas)


def check_bcq(gen, shapes, Ms=GEMV_MS + GEMM_MS, draft_Ms=DRAFT_MS):
    """Each BCQ kernel against its plain version at every M of `Ms` (and
    `draft_Ms` on draft views, 2 of 3 stored planes) on each (K, N),
    per-channel and group 128, fp32 and bf16 scales; returns (worst
    relative error, checks) by kernel, draft views under `<name>_draft`."""
    import torch
    from repro_torch.kernels.bcq_matmul import (_bcq_matmul_plain, bcq_gemv,
                                                bcq_matmul)
    worst = {"bcq_gemv": 0.0, "bcq_matmul": 0.0, "bcq_gemv_draft": 0.0,
             "bcq_matmul_draft": 0.0}
    n_checks = {k: 0 for k in worst}
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
                # draft views: the leading planes of the stored codes
                ops = draft_operands(qt)
                for M in draft_Ms:
                    name = "bcq_gemv" if M <= 8 else "bcq_matmul"
                    fn = bcq_gemv if M <= 8 else bcq_matmul
                    x = torch.randn((M, K), generator=gen, device=DEV)
                    y = fn(x, *ops)
                    ref = _bcq_matmul_plain(x, *ops)
                    sync()
                    rel = float((y - ref).abs().max() / ref.abs().max())
                    emit({"check": f"{name}_draft", "M": M, "K": K, "N": N,
                          "planes": f"{DRAFT_PLANES} of 3", "group_size": gs,
                          "scale_dtype": str(sdt).removeprefix("torch."),
                          "rel_err": rel, "tol": TOL_FP32})
                    require(bool(torch.isfinite(y).all()) and rel <= TOL_FP32,
                            f"{name} draft view M={M} K={K} N={N} gs={gs} "
                            f"{sdt}: rel err {rel:.3g} > {TOL_FP32}")
                    worst[f"{name}_draft"] = max(worst[f"{name}_draft"], rel)
                    n_checks[f"{name}_draft"] += 1
                del qts
    return worst, n_checks


# (K, N, Ms) of the linears phase 9 adds: minicpm3's wkv_a (N=288, not
# a multiple of the GEMM's 64 columns), wkv_b (K=256: 8 words, below
# several GEMV split sizes; M=768 is its expansion over a batch-4
# decode's 192-token latent views) and wq_a; gemma2's wd (K=36864);
# falcon-mamba's in_proj and out_proj
ZOO_SHAPES = ((2560, 288, (1, 4, 8, 100)), (256, 5120, (1, 4, 8, 128, 768)),
              (2560, 768, (1, 4, 8, 100)), (36864, 4608, (1, 4, 8, 100)),
              (4096, 16384, (1, 4, 8, 100)), (8192, 4096, (1, 4, 8, 100)))
# jamba-1.5-large's expert stacks: 16 experts, 8192 -> 24576 and back, at
# a batch-4 decode's 4 rows and a 100-token prefill's 26-row capacity
JAMBA_EXPERT_SHAPES = ((8192, 24576), (24576, 8192))
# (K, N, Ms) of a rank's linears on phase 12's 2-way model axis:
# falcon-mamba's in_proj (both halves' d_inner / 2 columns), out_proj
# and dt_w; minicpm3's wq_b, wkv_b (also at its expansion's M = 768) and
# wo; jamba's in_proj and out_proj (4096 x 8192 is also its wo); then at
# decode's 4 rows the others phase 12 newly cuts: minicpm3's MLP,
# jamba's dt_w, wq, wk / wv and dense MLP; with jamba's 8 experts a rank
MESH_SHARD_SHAPES = ((4096, 8192, (1, 4)), (4096, 4096, (1, 4)),
                     (256, 4096, (1, 4)), (768, 1920, (1, 4)),
                     (256, 2560, (1, 4, 768)), (1280, 2560, (1, 4)),
                     (8192, 16384, (1, 4)), (8192, 8192, (1, 4)),
                     (2560, 3200, (4,)), (3200, 2560, (4,)),
                     (512, 8192, (4,)), (8192, 4096, (4,)), (8192, 512, (4,)),
                     (8192, 12288, (4,)), (12288, 8192, (4,)))
MESH_EXPERTS = 8


def check_bcq_zoo(gen, shapes=ZOO_SHAPES, tag="zoo"):
    """The GEMV (M <= 8) and the GEMM at phase 9's shapes (or phase 12's
    shard shapes), w3 per-channel fp32 scales (as those phases serve
    them) and group 128 bf16 scales at one row, each against its plain
    version, a `<kernel>_<tag>` line each; returns (worst relative
    error, checks) by kernel."""
    import torch
    from repro_torch.hw import GEMV_ROWS
    from repro_torch.kernels.bcq_matmul import (_bcq_matmul_plain, bcq_gemv,
                                                bcq_matmul)
    worst = {"bcq_gemv": 0.0, "bcq_matmul": 0.0}
    n_checks = {"bcq_gemv": 0, "bcq_matmul": 0}
    for K, N, Ms in shapes:
        n_copy = max(2, -(-100_000_000 // (3 * K * N // 8)))
        qts = [random_qt(gen, K, N, 0, torch.float32) for _ in range(n_copy)]
        cases = [(M, qts[0]) for M in Ms]
        if K % 128 == 0:
            cases.append((4, random_qt(gen, K, N, 128, torch.bfloat16)))
        for M, qt in cases:
            name = "bcq_gemv" if M <= GEMV_ROWS else "bcq_matmul"
            fn = bcq_gemv if M <= GEMV_ROWS else bcq_matmul
            x = torch.randn((M, K), generator=gen, device=DEV)
            y = fn(x, qt.codes, qt.alphas, qt.betas)
            ref = _bcq_matmul_plain(x, qt.codes, qt.alphas, qt.betas)
            sync()
            err = float((y - ref).abs().max())
            rel = err / float(ref.abs().max())
            row = {"check": f"{name}_{tag}", "M": M, "K": K, "N": N,
                   "group_size": qt.group_size if qt.n_groups > 1 else 0,
                   "scale_dtype": str(qt.alphas.dtype).removeprefix(
                       "torch."), "max_abs_err": err, "rel_err": rel,
                   "tol": TOL_FP32}
            if qt is qts[0]:
                it = [0]

                def run(fn=fn, x=x):
                    q = qts[it[0] % n_copy]
                    it[0] += 1
                    fn(x, q.codes, q.alphas, q.betas)
                t = kernel_ms(run, 10)
                row.update({"ms": best_ms(t), "event_ms": t["event_ms"]})
            emit(row)
            require(bool(torch.isfinite(y).all()) and rel <= TOL_FP32,
                    f"{name} M={M} K={K} N={N}: rel err {rel:.3g} > "
                    f"{TOL_FP32}")
            worst[name] = max(worst[name], rel)
            n_checks[name] += 1
        del qts, cases
    return worst, n_checks


def summarize_bcq(gen, name, M, K, N, planes=3):
    """The kernel's line: time, bound, plain and library (torch.matmul on
    the pre-dequantized W) at one main-path shape, w3 per-channel fp32
    (a draft view of its leading `planes` when planes < 3)."""
    import torch
    from repro_torch.kernels.bcq_matmul import (_bcq_matmul_plain, bcq_gemv,
                                                bcq_matmul)
    from repro_torch.kernels.ref import dequant_ref
    from repro_torch.roofline.analysis import bcq_bound_ms, bcq_work
    fn = bcq_gemv if name == "bcq_gemv" else bcq_matmul
    n_copy = max(2, -(-100_000_000 // (3 * K * N // 8)))
    ops = [draft_operands(q, planes) for q in
           (random_qt(gen, K, N, 0, torch.float32) for _ in range(n_copy))]
    x = torch.randn((M, K), generator=gen, device=DEV)
    it = [0]

    def run():
        q = ops[it[0] % n_copy]
        it[0] += 1
        return fn(x, *q)
    q0 = ops[0]
    y = fn(x, *q0)
    ref = _bcq_matmul_plain(x, *q0)
    err = float((y - ref).abs().max())
    t = kernel_ms(run, 50)
    plain_ms = best_ms(kernel_ms(lambda: _bcq_matmul_plain(x, *q0), 5))
    w = dequant_ref(*q0, K)
    lib_ms = best_ms(kernel_ms(lambda: torch.matmul(x, w), 20))
    # the active planes' code words, the scales, x and y
    b, by, arith = bcq_bound_ms(bcq_work(M, K, N, planes, 1), M)
    row = {"arithmetic": arith}
    if name == "bcq_matmul":
        from repro_torch.kernels.bcq_matmul import gemm_launch_shape
        tile, ntiles, splits = gemm_launch_shape(
            M, K // 32, N, torch.cuda.get_device_properties(
                0).multi_processor_count if DEV == "cuda" else 132)
        row.update({"token_tile": tile, "token_tiles": ntiles,
                    "k_splits": splits})
    return {"max_abs_err": err, "ms": best_ms(t), "plain_ms": plain_ms,
            "bound_ms": b, "bound_by": by, **row, "library_ms": lib_ms,
            "event_ms": t["event_ms"],
            "timing": "profiler" if t["device_ms"] else "cuda_events",
            "shape": f"M={M} K={K} N={N} w3 per-channel fp32 scales"
                     + (f", a draft view of {planes} of 3 planes"
                        if planes < 3 else "")}


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


# head_dim 16, every smoke config of the zoo: jamba's (Hkv 2, rep 2) and
# rep 1 (half of the P . V threads idle), 4 and 16, windows, caps,
# several partitions a block
HD16_CASES = (
    dict(B=4, Hkv=2, rep=2, hd=16, page=64, ctx=[16, 45, 77, 131],
         window=None, cap=None),
    dict(B=3, Hkv=2, rep=1, hd=16, page=16, ctx=[700, 1, 333],
         window=None, cap=None),
    dict(B=3, Hkv=3, rep=4, hd=16, page=16, ctx=[40, 23, 9],
         window=8, cap=5.0),
    dict(B=2, Hkv=2, rep=16, hd=16, page=16, ctx=[700, 999],
         window=301, cap=30.0),
)


def check_paged(gen, cases=None):
    """paged_attention against its plain version at each case (default:
    the main paths' geometries); a case whose second context is 1 runs
    that row on the null page only."""
    import torch
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.kernels.ref import paged_attention_ref
    cases = cases or [
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
        # phase 9: gemma2-27b (rep 2, window 4096, cap 50; and a window
        # that binds) and jamba-1.5-large's attention layer (rep 8)
        dict(B=4, Hkv=16, rep=2, hd=128, page=64, ctx=[16, 45, 77, 131],
             window=4096, cap=50.0),
        dict(B=4, Hkv=16, rep=2, hd=128, page=64, ctx=[16, 45, 77, 131],
             window=40, cap=50.0),
        dict(B=4, Hkv=8, rep=8, hd=128, page=64, ctx=[16, 45, 77, 131],
             window=None, cap=None),
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


def summarize_paged(gen, Hkv=32, rep=1, hd=128, page=64, ctx=PAGED_CTX,
                    pool_heads=None, kv0=0):
    """The kernel's line at a decode shape (default: phase 3's llama2-7b):
    time, bound, plain, and SDPA on the gathered K/V. With `pool_heads`
    q's Hkv heads read the pool's kv0.. (a rank's heads of a pool the
    model axis replicates); the bound counts the heads read."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.kernels.ref import paged_attention_ref
    from repro_torch.roofline.analysis import bound_ms, paged_attention_work
    B = len(ctx)
    q, kp, vp, bt, cl = paged_case(gen, B, pool_heads or Hkv, rep, hd, page,
                                   ctx, torch.float32)
    q = q[:, kv0:kv0 + Hkv].contiguous()
    kw = {"kv0": kv0}
    y = paged_attention(q, kp, vp, bt, cl, **kw)
    ref = paged_attention_ref(q, kp, vp, bt, cl, **kw)
    err = float((y - ref).abs().max())
    t = kernel_ms(lambda: paged_attention(q, kp, vp, bt, cl, **kw), 200)
    plain_ms = best_ms(kernel_ms(
        lambda: paged_attention_ref(q, kp, vp, bt, cl, **kw), 20))
    # library yardstick: SDPA over the gathered K/V with a context mask
    T = bt.shape[1]
    heads = slice(kv0, kv0 + Hkv)
    k = kp[bt.long()][:, :, :, heads].reshape(B, T * page, Hkv,
                                              hd).transpose(1, 2)
    v = vp[bt.long()][:, :, :, heads].reshape(B, T * page, Hkv,
                                              hd).transpose(1, 2)
    mask = (torch.arange(T * page, device=DEV)[None, :]
            < cl[:, None])[:, None, None, :]
    qs = q.reshape(B, Hkv * rep, 1, hd)
    lib_ms = best_ms(kernel_ms(lambda: F.scaled_dot_product_attention(
        qs, k, v, attn_mask=mask, enable_gqa=True), 200))
    w = paged_attention_work(sum(ctx), B, Hkv, rep, hd, T,
                             kv_bytes_per_token_head=hd * 4)
    b, by = bound_ms(w["bytes"], w["flops"])
    return {"max_abs_err": err, "ms": best_ms(t), "plain_ms": plain_ms,
            "bound_ms": b, "bound_by": by, "library_ms": lib_ms,
            "event_ms": t["event_ms"],
            "timing": "profiler" if t["device_ms"] else "cuda_events",
            "shape": f"B={B} Hkv={Hkv} rep={rep} hd={hd} page={page} "
                     f"ctx={ctx} fp32"
                     + (f", KV heads {kv0}.. of a {pool_heads}-head pool"
                        if pool_heads else "")}


# a rank's KV heads of a pool the model axis replicates: Qwen3-MoE on a
# (1, 8) mesh (its 64 query heads over 4 KV heads: rank r's 8 query heads
# read KV head r // 2 of the whole 4-head pool)
RANK_POOL_HEADS, RANK_REP, RANK_AXIS = 4, 8, 8


def check_paged_rank(seed, B=4, hd=128, page=64, ctx=PAGED_CTX):
    """Both kernels at every rank's KV head of Qwen3-MoE's pool on (1, 8)
    (kv0 = r // 2), fp32 q, against their plain versions: fp pages, and
    4-bit pages with one group a head vector and with groups of 32; from
    a generator of their own. -> {kernel: worst rel err}."""
    import torch
    from repro_torch.kernels.paged_attention import (paged_attention,
                                                     paged_attention_quant)
    from repro_torch.kernels.ref import (paged_attention_quant_ref,
                                         paged_attention_ref)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(seed)
    worst = {"paged_attention": 0.0, "paged_attention_quant": 0.0}
    for kv0 in sorted({r * RANK_POOL_HEADS // RANK_AXIS
                       for r in range(RANK_AXIS)}):
        q, kp, vp, bt, cl = paged_case(gen, B, RANK_POOL_HEADS, RANK_REP,
                                       hd, page, ctx, torch.float32)
        q = q[:, kv0:kv0 + 1].contiguous()
        runs = [("paged_attention", 0, (kp, vp), paged_attention,
                 paged_attention_ref)]
        runs += [("paged_attention_quant", gs, quant_pages(kp, vp, 4, gs),
                  paged_attention_quant, paged_attention_quant_ref)
                 for gs in (0, 32)]
        for name, gs, pool, fn, plain in runs:
            y = fn(q, *pool, bt, cl, kv0=kv0)
            ref = plain(q, *pool, bt, cl, kv0=kv0)
            sync()
            err = float((y - ref).abs().max())
            rel = err / float(ref.abs().max())
            emit({"check": f"{name}_rank", "B": B, "pool_heads":
                  RANK_POOL_HEADS, "kv0": kv0, "rep": RANK_REP, "hd": hd,
                  "page": page, "ctx": ctx,
                  **({"bits": 4, "kv_group_size": gs}
                     if name == "paged_attention_quant" else {}),
                  "max_abs_err": err, "rel_err": rel, "tol": TOL_FP32})
            require(bool(torch.isfinite(y).all()) and rel <= TOL_FP32,
                    f"{name} at KV head {kv0} of {RANK_POOL_HEADS}: rel err "
                    f"{rel:.3g}")
            worst[name] = max(worst[name], rel)
    return worst


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
                          ctx=PAGED_CTX, pool_heads=None, kv0=0):
    """The kernel's line at the phase-4 decode shape: time, bound, plain,
    and two library yardsticks: SDPA on K/V gathered and expanded to fp32
    before the call (it gets its operand already expanded), and the whole
    PyTorch equivalent timed as one call (gather the binary-coded rows,
    kv_dequantize, SDPA). `pool_heads`, `kv0`: as summarize_paged's."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.paged_attention import paged_attention_quant
    from repro_torch.kernels.ref import paged_attention_quant_ref
    from repro_torch.quant.kv import kv_bytes_per_token_head, kv_dequantize
    from repro_torch.roofline.analysis import bound_ms, paged_attention_work
    B = len(ctx)
    q, kp, vp, bt, cl = paged_case(gen, B, pool_heads or Hkv, rep, hd, page,
                                   ctx, torch.float32)
    q = q[:, kv0:kv0 + Hkv].contiguous()
    pool = quant_pages(kp, vp, bits, 0)
    G = pool[2].shape[-1]
    kw = {"kv0": kv0}
    y = paged_attention_quant(q, *pool, bt, cl, **kw)
    ref = paged_attention_quant_ref(q, *pool, bt, cl, **kw)
    err = float((y - ref).abs().max())
    t = kernel_ms(lambda: paged_attention_quant(q, *pool, bt, cl, **kw),
                  200)
    plain_ms = best_ms(kernel_ms(
        lambda: paged_attention_quant_ref(q, *pool, bt, cl, **kw), 20))
    T = bt.shape[1]
    # the rank's heads of the pool, as the kernel reads them
    pool = tuple(t[:, :, kv0:kv0 + Hkv] for t in pool)
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
    w = paged_attention_work(
        sum(ctx), B, Hkv, rep, hd, T,
        kv_bytes_per_token_head=kv_bytes_per_token_head(hd, bits, hd // G))
    b, by = bound_ms(w["bytes"], w["flops"])
    return {"max_abs_err": err, "ms": best_ms(t), "plain_ms": plain_ms,
            "bound_ms": b, "bound_by": by, "library_ms": lib_ms,
            "library_gets": "K/V gathered and expanded to fp32 beforehand",
            "library_full_ms": best_ms(full),
            "library_full_event_ms": full["event_ms"],
            "library_full_is": "gather, kv_dequantize, SDPA in one call",
            "event_ms": t["event_ms"],
            "timing": "profiler" if t["device_ms"] else "cuda_events",
            "shape": f"B={B} Hkv={Hkv} rep={rep} hd={hd} page={page} "
                     f"ctx={ctx} {bits}-bit G={G}, fp32 q"
                     + (f", KV heads {kv0}.. of a {pool_heads}-head pool"
                        if pool_heads else "")}


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
    from repro_torch.kernels.bcq_matmul import (_bcq_expert_plain,
                                                bcq_expert_matmul)
    from repro_torch.roofline.analysis import bcq_bound_ms, bcq_work
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
    bd, by, arith = bcq_bound_ms(bcq_work(M, K, N, 3, 1, live_rows=live,
                                          E=E), M)
    row = {"max_abs_err": err, "ms": best_ms(t), "plain_ms": plain_ms,
           "bound_ms": bd, "bound_by": by, "arithmetic": arith,
           "library_ms": lib_ms,
           "library_gets": "the expert stack dequantized to fp32 "
                           "beforehand (torch.bmm, every row)",
           "event_ms": t["event_ms"],
           "timing": "profiler" if t["device_ms"] else "cuda_events",
           "shape": f"E={E} M={M} K={K} N={N} w3 per-channel fp32 scales"}
    if rows is not None:
        row.update({
            "rows": f"batch-4 top-8 routing, {used} live experts, "
                    f"{sum(live)} live rows",
            "live_experts": used,
            "ms_every_row": best_ms(kernel_ms(
                lambda: bcq_expert_matmul(x, c, a, b), 50)),
            "bound_ms_every_row": bcq_bound_ms(bcq_work(M, K, N, 3, 1, E=E),
                                               M)[0]})
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
                          kv_bits=kv_bits, prefix_sharing=False, device=DEV)
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
    codes = torch.randint(-2 ** 31, 2 ** 31, (*lead, 3, -(-K // 32), N),
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
SERVE_MAX_LEN = 160       # the engines' max_len (phases 3-5, 8 and 9)


def serve_path(name, cfg, params, seed, kv_bits=0, max_new=32, **spec):
    """Serve the path's 4 requests (`max_new` new tokens each) through
    the paged engine (speculatively with `spec`: speculate, draft_bits,
    draft_params), every launch count set to 0 just before and read just
    after; returns (counts, row, prompts, tokens per request, engine)."""
    import numpy as np
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve import Request, ServeEngine, compile_cache
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in PROMPT_LENS]
    if DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()
    eng = ServeEngine(cfg, params, batch_size=4, max_len=SERVE_MAX_LEN,
                      dtype="float32", cache_kind="paged", page_size=64,
                      kv_bits=kv_bits, prefix_sharing=False, device=DEV,
                      **spec)
    reqs = [Request(prompt=p, max_new_tokens=max_new) for p in prompts]
    sync()
    reset_launch_counts()
    g0 = compile_cache.graph_stats()
    t1 = time.time()
    eng.run(reqs)
    sync()
    wall = time.time() - t1
    counts = launch_counts()
    g1 = compile_cache.graph_stats()
    st = eng.stats
    # the first decode tick captures the run's graphs (warm-up included)
    capture_s = g1["capture_s"] - g0["capture_s"]
    row = {"check": name, "model": cfg.name, "layers": cfg.n_layers,
           "requests": len(reqs), "prompt_lens": PROMPT_LENS,
           "max_new": max_new,
           "kv_bits": kv_bits, "packed_code_bytes": _code_bytes(params),
           "kv_bytes_per_token": eng.kv.bytes_per_page() // eng.page_size,
           "wall_s": wall, "prefill_s": st["prefill_s"],
           "prefill_tokens": st["prefill_tokens"],
           "prefills": len(reqs) + eng.sched.preemptions,
           "decode_s": st["decode_s"], "decode_ticks": st["ticks"],
           "decode_tokens": st["tokens"],
           "decode_tok_per_s": st["tokens"] / max(st["decode_s"], 1e-9),
           "decode_ms_per_tick": 1e3 * st["decode_s"] / max(st["ticks"], 1),
           "graphs_captured": g1["captured"] - g0["captured"],
           "graph_capture_s": capture_s,
           "graph_replays": g1["replays"] - g0["replays"],
           "decode_ms_per_tick_without_capture":
               1e3 * (st["decode_s"] - capture_s) / max(st["ticks"], 1),
           "ttft_avg_s": st["ttft_avg_s"], "tpot_avg_s": st["tpot_avg_s"],
           "peak_mem_gb": (torch.cuda.max_memory_allocated() / 1e9
                           if DEV == "cuda" else None),
           "launches": counts}
    if spec:
        snap = eng.stats_snapshot()
        row.update({"speculate": eng.speculate,
                    "draft": ("the target's params" if spec.get(
                        "draft_params") is params else
                        f"w{eng.draft_bits} view of the target's codes"),
                    "draft_tokens": snap.draft_tokens,
                    "accepted_tokens": snap.accepted_tokens,
                    "acceptance_rate": snap.acceptance_rate,
                    "decode_ms_per_token": 1e3 * st["decode_s"]
                    / max(st["tokens"], 1),
                    "draft_build_s": eng.draft_build_s})
    require(all(r.done and len(r.out) == max_new for r in reqs),
            f"{name}: a request did not finish with {max_new} tokens")
    require(all(0 <= t < cfg.vocab_size for r in reqs for t in r.out),
            f"{name}: token out of the vocabulary")
    require(counts["bcq_plain"] == 0, f"{name}: a BCQ call took the "
                                      f"plain path")
    require(eng.kv.free_page_count == eng.kv.usable_pages,
            f"{name}: pages did not drain back to the pool")
    return counts, row, prompts, [r.out for r in reqs], eng


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
    """Phase 3 on `model`, built by synthetic_llama in `build_s` s;
    returns (counts, row, greedy tokens per request)."""
    cfg, params = model
    counts, row, prompts, outs, _ = serve_path("main_path", cfg, params,
                                               seed)
    row["weights_build_s"] = build_s
    emit(row)
    for k in ("bcq_gemv", "bcq_matmul", "paged_attention"):
        require(counts[k] > 0, f"main path: {k} was never launched")
    require(counts["paged_attention"] == cfg.n_layers * row["decode_ticks"]
            and counts["paged_attention_quant"] == 0
            and counts["bcq_expert_matmul"] == 0,
            f"main path: launches {counts}")
    paged_vs_dense("main_path", cfg, params, prompts[0], outs[0])
    prof = profile_decode(cfg, params, prompts)
    decode_dryrun_check(cfg, params, len(prompts), SERVE_MAX_LEN, prof)
    decode_step_sync(cfg, params, prompts)
    return counts, row, outs


def decode_dryrun_check(cfg, params, batch, max_len, prof):
    """The dry run (launch/dryrun.py) of the served model's decode step
    on the meta device: w3 stand-ins from quant/abstract.py with the
    served leaves' shapes leaf by leaf, their code bytes equal to
    _code_bytes(params) and their scale bytes to the served scales',
    exactly; then its FLOPs, bytes, memory term and bound (fp32, as
    served; a dense cache of `max_len`) beside the graph's measured
    device ms a step (`prof`, profile_decode's row) and the codes-only
    bound."""
    from repro_torch.configs import ShapeSpec
    from repro_torch.launch import dryrun
    from repro_torch.quant import QuantizedTensor
    from repro_torch.roofline.analysis import (FP32_FLOPS, HBM_BYTES_PER_S,
                                               CollectiveStats,
                                               roofline_terms)
    shape = ShapeSpec("decode_served", max_len, batch, "decode")
    step, args, meta = dryrun.lower_cell(cfg, shape, quant_bits=3,
                                         dtype="float32")
    abstract = args[0]
    fields = ("codes", "alphas", "betas")
    mismatched, n_packed, code_b, scale_b, served_scale_b = [], 0, 0, 0, 0
    for j, (la, ls) in enumerate(zip(abstract["layers"], params["layers"])):
        for g in ("attn", "mlp", "moe"):
            for k, w in ls.get(g, {}).items():
                a = la[g][k]
                if isinstance(w, QuantizedTensor) != isinstance(
                        a, QuantizedTensor):
                    mismatched.append(f"layers.{j}.{g}.{k}: packed "
                                      f"{isinstance(w, QuantizedTensor)}")
                    continue
                if not isinstance(w, QuantizedTensor):
                    continue
                n_packed += 1
                if any(tuple(getattr(a, f).shape) != tuple(getattr(w, f)
                                                           .shape)
                       for f in fields) or a.k_in != w.k_in:
                    mismatched.append(f"layers.{j}.{g}.{k}")
                code_b += a.codes.numel() * a.codes.element_size()
                scale_b += sum(t.numel() * t.element_size()
                               for t in (a.alphas, a.betas))
                served_scale_b += sum(t.numel() * t.element_size()
                                      for t in (w.alphas, w.betas))
    traced = dryrun.trace_cell(step, args)
    cost = traced["cost"]
    terms = roofline_terms({"flops": cost["flops"],
                            "bytes accessed": cost["bytes"]},
                           CollectiveStats(), FP32_FLOPS)
    row = {"check": "dryrun_check", "path": "main_path decode", "model":
           cfg.name, "shape": f"decode, batch {batch}, dense cache of "
                              f"{max_len} (the engine's max_len), fp32",
           "packed_leaves": n_packed, "mismatched_leaves": mismatched,
           "code_bytes_abstract": code_b,
           "code_bytes_served": _code_bytes(params),
           "scale_bytes_abstract": scale_b,
           "scale_bytes_served": served_scale_b,
           "params_bytes_packed": meta["params_bytes_packed"],
           "dryrun_flops": cost["flops"], "dryrun_bytes": cost["bytes"],
           "kernel_calls": cost["kernels"]["calls"],
           "t_memory_ms": 1e3 * terms["t_memory_s"],
           "t_compute_ms_fp32": 1e3 * terms["t_compute_s"],
           "bound_ms": 1e3 * terms["t_bound_s"], "bound": terms["bound"],
           "codes_only_bound_ms": 1e3 * code_b / HBM_BYTES_PER_S,
           "measured_graph_device_ms_per_step":
               prof.get("graph_device_busy_ms_per_step"),
           "peak_live_bytes_est": traced["memory"]["peak_live_bytes_est"]}
    emit(row)
    require(n_packed > 0 and not mismatched,
            f"dry run: packed leaves differ from the served ones: "
            f"{mismatched[:4]}")
    require(code_b == row["code_bytes_served"]
            and scale_b == served_scale_b,
            f"dry run: code / scale bytes {code_b} / {scale_b} against the "
            f"served {row['code_bytes_served']} / {served_scale_b}")
    return row


def phase_kv_bits(seed: int, model, kv_bits: int = 4):
    """Phase 3's model and requests with binary-coded KV pages."""
    import torch
    from repro_torch.models import (attention, decode_step_paged,
                                    init_paged_cache, prefill,
                                    scatter_prefill_cache)
    from repro_torch.kernels.ref import paged_attention_quant_ref
    cfg, params = model
    counts, row, prompts, outs, _ = serve_path("kv_bits_path", cfg, params,
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
    decode_step_sync(cfg, params, prompts, kv_bits)
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
    counts, row, prompts, outs, _ = serve_path("moe_path", cfg, params,
                                               seed)
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


# ---------------------------------------------------------------------------
# phase 6: shared prefixes and chunked prefill at full width
# ---------------------------------------------------------------------------

PREFIX_TOKENS = 192     # the system prefix: 3 full 64-token pages
FORK_TOKENS = 8         # wave 3: request 0's prompt + its first 8 tokens
PREFIX_MAX_LEN = 384
PREFIX_CHUNK = 64


def prefix_workload(seed, vocab):
    """The system prefix and the four prompts (prefix + PROMPT_LENS
    suffixes). Every suffix starts with another token than request 0's,
    so a wave-2 match ends exactly at the prefix."""
    import numpy as np
    rng = np.random.default_rng(seed + 6)
    prefix = rng.integers(0, vocab, PREFIX_TOKENS)
    suffixes = [rng.integers(0, vocab, n) for n in PROMPT_LENS]
    for i, sfx in enumerate(suffixes[1:], 1):
        sfx[0] = (suffixes[0][0] + i) % vocab
    return [np.concatenate([prefix, sfx]).astype(np.int32)
            for sfx in suffixes]


def serve_waves(name, cfg, params, waves, max_new, hook=None, **kw):
    """Serve `waves` (lists of prompts; None: request 0's prompt + its
    first FORK_TOKENS tokens) in turn through one paged engine (`hook`
    sees it first), every launch count set to 0 just before and read
    just after. Times the engine's extend passes. Returns (row, tokens
    per request, prompts, engine, counts)."""
    import numpy as np
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve import Request, ServeEngine
    eng = ServeEngine(cfg, params, batch_size=4, max_len=PREFIX_MAX_LEN,
                      dtype="float32", cache_kind="paged", page_size=64,
                      device=DEV, **kw)
    if hook is not None:
        hook(eng)
    extend, ext_s = eng._extend, [0.0]

    def timed(*args):
        sync()
        t0 = time.time()
        out = extend(*args)
        sync()
        ext_s[0] += time.time() - t0
        return out
    eng._extend = timed
    if DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()
    outs, prompts, ttft = [], [], []
    sync()
    reset_launch_counts()
    t1 = time.time()
    for wave in waves:
        wave = wave or [np.concatenate([prompts[0], np.asarray(
            outs[0][:FORK_TOKENS], np.int32)])]
        reqs = [Request(prompt=p, max_new_tokens=max_new) for p in wave]
        eng.run(reqs)
        ttft.append(eng.stats["ttft_avg_s"])
        prompts += list(wave)
        outs += [r.out for r in reqs]
    sync()
    wall = time.time() - t1
    counts = launch_counts()
    st = eng.stats
    row = {"check": name, "model": cfg.name, "layers": cfg.n_layers,
           "requests": len(outs), "waves": [len(w or [0]) for w in waves],
           "max_new": max_new, "engine": kw, "wall_s": wall,
           "ttft_s_by_wave": ttft, "prefill_s": st["prefill_s"],
           "extend_s": ext_s[0],
           "extend_share_of_prefill": ext_s[0] / max(st["prefill_s"], 1e-9),
           "prefill_tokens": st["prefill_tokens"],
           "decode_ticks": st["ticks"], "decode_tokens": st["tokens"],
           "decode_ms_per_tick": 1e3 * st["decode_s"] / max(st["ticks"], 1),
           "tpot_avg_s": st["tpot_avg_s"],
           "peak_mem_gb": (torch.cuda.max_memory_allocated() / 1e9
                           if DEV == "cuda" else None),
           **{k: st[k] for k in ("prefix_hits", "prefix_tokens_saved",
                                 "cow_forks", "pages_allocated",
                                 "preemptions", "prefix_cached_pages")},
           "live_pages": eng.kv.live_pages, "launches": counts}
    require(all(len(o) == max_new for o in outs)
            and all(0 <= t < cfg.vocab_size for o in outs for t in o),
            f"{name}: a request did not finish with {max_new} tokens")
    require(counts["bcq_plain"] == 0, f"{name}: a BCQ call took the plain "
                                      f"path")
    # pages: only the index holds any after the run; clearing it frees all
    require(eng.kv.live_pages == st["prefix_cached_pages"]
            and not eng.kv.active_slots(),
            f"{name}: {eng.kv.live_pages} live pages, the index holds "
            f"{st['prefix_cached_pages']}")
    if eng._prefix is not None:
        eng._prefix.clear()
    require(eng.kv.free_page_count == eng.kv.usable_pages,
            f"{name}: pages did not drain back to the pool")
    return row, outs, prompts, eng, counts


def first_divergence(cfg, params, prompt, want, got):
    """None when `got` equals `want`; else the first index where they
    differ and the top-2 logit gap of `want`'s run there, relative to
    max|logit| (a full prefill of the prompt + want's earlier tokens)."""
    import numpy as np
    import torch
    from repro_torch.models import prefill
    if got == want:
        return None
    t = next(i for i, (a, b) in enumerate(zip(want, got)) if a != b)
    toks = np.concatenate([prompt, np.asarray(want[:t], np.int32)])
    logits, _ = prefill(cfg, params, torch.tensor(toks[None], device=DEV),
                        len(toks))
    top = torch.topk(logits[0].double(), 2).values
    return t, float((top[0] - top[1]) / logits[0].abs().max())


def extend_vs_prefill(cfg, params, prompt):
    """The extend path at the model level: extend_paged of the suffix
    over the prefix's pages (written by prefill + scatter), against
    prefill of the whole prompt: the last logits' error relative to
    max|logit|, the extend call's bcq_matmul launches, and both calls'
    device and CUDA-event times (kernel_ms; the extend re-writes the
    same slots each call)."""
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import (extend_paged, init_paged_cache, prefill,
                                    scatter_prefill_cache)
    from repro_torch.serve.engine import bucket_len
    page, N, L = 64, PREFIX_TOKENS, len(prompt)
    npg = -(-L // page)
    pool = init_paged_cache(cfg, npg + 1, page, 1, device=DEV)
    _, row = prefill(cfg, params, torch.tensor(prompt[None, :N], device=DEV),
                     N)
    ids = list(range(1, npg + 1))
    scatter_prefill_cache(cfg, pool, row, 0, ids[:N // page], N)
    C = bucket_len(L - N, PREFIX_MAX_LEN)
    tokens = torch.zeros((1, C), dtype=torch.int32, device=DEV)
    tokens[0, :L - N] = torch.tensor(prompt[N:], device=DEV)
    args = (tokens, torch.tensor([N], dtype=torch.int32, device=DEV),
            torch.tensor([ids], dtype=torch.int32, device=DEV),
            torch.tensor([L - N], dtype=torch.int32, device=DEV))
    whole = torch.tensor(prompt[None], device=DEV)
    sync()
    reset_launch_counts()
    got, _ = extend_paged(cfg, params, pool, *args)
    sync()
    gemm = launch_counts()["bcq_matmul"]
    want, _ = prefill(cfg, params, whole, L)
    require(bool(torch.isfinite(got).all()), "prefix path: extend logits "
                                             "not finite")
    return {"suffix": L - N, "chunk": C,
            "rel_err": float((got - want).abs().max() / want.abs().max()),
            "bcq_matmul_launches": gemm,
            "extend_ms": kernel_ms(lambda: extend_paged(cfg, params, pool,
                                                        *args), 3),
            "prefill_whole_prompt_ms": kernel_ms(
                lambda: prefill(cfg, params, whole, L), 3)}


def phase_prefix(seed: int, model, kv_bits: int = 4, max_new: int = 32):
    """Phase 6 on phase 3's model: one system prefix, three waves
    (request 0; requests 1-3, which hit the prefix; request 0's prompt +
    its first tokens, whose match ends inside request 0's tail page and
    forks it) through engines with prefix sharing (A), without (B, the
    yardstick) and with chunked prefill and no sharing (C), then the
    waves with 4-bit KV pages, sharing and chunks, 8 new tokens each
    (`max_new` and 8 shrink for rehearsals on the CPU). Returns (summed
    launch counts, rows)."""
    import torch
    cfg, params = model
    prompts = prefix_workload(seed, cfg.vocab_size)
    waves = [prompts[:1], prompts[1:], None]
    rows, outs, total = {}, {}, {}

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    rows["A"], outs["A"], five, eng, counts = serve_waves(
        "prefix_path_share", cfg, params, waves, max_new,
        prefix_sharing=True)
    add(counts)
    del eng
    suffix = sum(len(p) - PREFIX_TOKENS for p in prompts[1:])
    rows["A"]["want_prefill_tokens"] = want = \
        len(prompts[0]) + suffix + 1      # wave 3: all but its last token
    emit(rows["A"])
    require(rows["A"]["prefix_hits"] >= 4 and rows["A"]["cow_forks"] >= 1,
            f"prefix path: hits/forks {rows['A']}")
    require(rows["A"]["prefill_tokens"] == want,
            f"prefix path: prefilled {rows['A']['prefill_tokens']} tokens, "
            f"the unshared suffixes hold {want}")
    for tag, kw in (("B", {"prefix_sharing": False}),
                    ("C", {"prefix_sharing": False,
                           "prefill_chunk": PREFIX_CHUNK})):
        rows[tag], outs[tag], _, eng, counts = serve_waves(
            f"prefix_path_{'none' if tag == 'B' else 'chunked'}", cfg,
            params, [[p] for p in five[:1]] + [five[1:4], five[4:]],
            max_new, **kw)
        add(counts)
        del eng
        emit(rows[tag])
    require(rows["C"]["prefill_tokens"] == rows["B"]["prefill_tokens"],
            f"prefix path: chunked prefill ran {rows['C']['prefill_tokens']} "
            f"tokens, B {rows['B']['prefill_tokens']}")
    require(rows["C"]["launches"]["bcq_matmul"] > 0,
            "prefix path: the chunked extends never launched bcq_matmul")
    for tag in ("A", "B", "C"):
        r = rows[tag]
        require(r["launches"]["paged_attention"]
                == cfg.n_layers * r["decode_ticks"] > 0
                and r["launches"]["paged_attention_quant"] == 0,
                f"prefix path {tag}: launches {r['launches']}")
    # greedy tokens of A and C against B, up to a printed near-tie
    for tag in ("A", "C"):
        for i, (want_t, got_t) in enumerate(zip(outs["B"], outs[tag])):
            div = first_divergence(cfg, params, five[i], want_t, got_t)
            emit({"check": "prefix_path_tokens", "engine": tag,
                  "request": i, "equal_to_B": div is None,
                  **({} if div is None else
                     {"first_diff": div[0], "B_top2_gap_rel": div[1],
                      "gap_limit": 2 * TOL_LOGITS})})
            if div is not None:
                require(div[1] <= 2 * TOL_LOGITS,
                        f"prefix path {tag}: request {i} differs from B at "
                        f"token {div[0]} with a gap of {div[1]:.3g}")
    row = extend_vs_prefill(cfg, params, five[1])
    emit({"check": "prefix_path_extend_vs_prefill", **row,
          "tol": TOL_LOGITS})
    require(row["rel_err"] <= TOL_LOGITS, f"prefix path: extend vs "
                                          f"prefill logits differ by "
                                          f"{row['rel_err']:.3g}")
    require(row["bcq_matmul_launches"] > 0, "prefix path: the extend call "
                                            "never launched bcq_matmul")
    # 4-bit KV pages: a fork copies every leaf (codes, alphas, betas),
    # byte for byte
    forks = []

    def check_first_fork(eng):
        apply = eng._apply_copies

        def run(slot, copies):
            apply(slot, copies)
            if copies and not forks:
                src = [a for a, _ in copies]
                dst = [b for _, b in copies]
                forks.append(all(torch.equal(leaf[dst].view(torch.int32),
                                             leaf[src].view(torch.int32))
                                 for layer in eng.cache
                                 for leaf in layer.values()))
        eng._apply_copies = run
    rows["kv"], _, _, eng, counts = serve_waves(
        "prefix_path_kv_bits", cfg, params,
        [[p] for p in five[:1]] + [five[1:4], None], min(8, max_new),
        hook=check_first_fork, prefix_sharing=True,
        prefill_chunk=PREFIX_CHUNK, kv_bits=kv_bits)
    add(counts)
    del eng
    rows["kv"]["fork_copied_every_leaf"] = forks[:1] == [True]
    emit(rows["kv"])
    require(rows["kv"]["cow_forks"] >= 1 and forks == [True],
            f"prefix path kv_bits: forks {rows['kv']['cow_forks']}, every "
            f"leaf copied: {forks}")
    require(rows["kv"]["launches"]["paged_attention_quant"]
            == cfg.n_layers * rows["kv"]["decode_ticks"] > 0
            and rows["kv"]["launches"]["paged_attention"] == 0,
            f"prefix path kv_bits: launches {rows['kv']['launches']}")
    return total, rows


# ---------------------------------------------------------------------------
# phase 7: quantize full-width llama2-7b, save, load and serve the artifact
# ---------------------------------------------------------------------------

# the llama2-7b depth quantized in phase 7: for time, not memory (a
# layer holds ~0.9 GB of Hessians and 0.8 GB of fp32 weights; the column
# sweep runs ~35.6 k sequential columns a layer, ~9-10 s on the card; 8
# layers until phase 13 needed the room, 2 until its other families
# did)
QUANT_LAYERS = 1
# calibration (benchmarks/common.py): 24 slices of 192 tokens of the
# wiki train split, slice seed 1, batches of 4
CALIB_SLICES, CALIB_LEN, CALIB_BATCH = 24, 192, 4
# card-vs-CPU slice: the first 256 output rows of layer 0's wq and wd
CHECK_ROWS = 256
# near-tie thresholds of the BCchoice and multiplier picks, the parity
# tests' (tests/test_torch_quant_core.py: CHOICE_TIE_RTOL, MULT_TIE_RTOL)
CHOICE_TIE_RTOL = 4e-6
MULT_TIE_RTOL = 1e-6
# a level pick's near-tie between the card's and the CPU's sweeps, of
# the level span: their Cholesky factors of H^-1 (cuSOLVER vs LAPACK)
# differ at fp32 rounding times H's conditioning, which every later
# column's compensation carries, so the two sweeps' inputs drift apart
# over thousands of columns (on an H100 the first flips read up to
# 2.9e-4 of the span at K=4096 and 1.6e-3 at K=11008); a wrong pick
# lands anywhere in a level gap, ~0.14 of the span at 3 bits
CARD_LEVEL_TIE_RTOL = 1e-2
TOL_OUTPUT_ERR = 1e-4     # card vs CPU output error, rows without a tie


def calibration_batches(vocab: int):
    from repro_torch.data import calibration_slices, corpus_tokens
    toks = corpus_tokens("wiki", split="train")
    require(int(toks.max()) < vocab, "calibration tokens exceed the vocab")
    sl = calibration_slices(toks, CALIB_SLICES, CALIB_LEN, seed=1)
    return [sl[i:i + CALIB_BATCH] for i in range(0, len(sl), CALIB_BATCH)]


class FuseCheck:
    """Wraps the registered gptqt quantizer while installed: every
    matrix it quantizes must have finite alphas and betas and a dequant
    of its QuantizedTensor equal to the solver's wq_t within 1e-6 x
    max|w| (the levels are computed as fused dequant computes them)."""

    def __enter__(self):
        from repro_torch.quant import get_quantizer
        self.q = get_quantizer("gptqt")
        inner = self.q.quantize
        self.n, self.worst, self.bad = 0, 0.0, []

        def checked(Wt, H, plan, *, orig_dtype="bfloat16"):
            import torch
            res = inner(Wt, H, plan, orig_dtype=orig_dtype)
            qt = res.qt
            finite = bool(torch.isfinite(qt.alphas.float()).all()
                          and torch.isfinite(qt.betas.float()).all())
            err = float((qt.dequant("float32").T - res.wq_t).abs().max()
                        / Wt.abs().max())
            self.n += 1
            self.worst = max(self.worst, err)
            if not finite or err > 1e-6:
                self.bad.append((tuple(Wt.shape), finite, err))
            return res
        self.q.quantize = checked
        return self

    def __exit__(self, *exc):
        del self.q.quantize                  # back to the class's method
        return False


def _leaves_equal(a, b) -> bool:
    """Two params trees (the port's per-layer layout) hold the same
    bytes leaf for leaf."""
    import torch
    from repro_torch.quant import QuantizedTensor
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_leaves_equal(a[k], b[k])
                                            for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(map(_leaves_equal, a, b))
    if isinstance(a, QuantizedTensor):
        return ((a.k_in, a.orig_dtype) == (b.k_in, b.orig_dtype)
                and all(_leaves_equal(getattr(a, f), getattr(b, f))
                        for f in ("codes", "alphas", "betas")))
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.view(torch.uint8) if a.dtype.is_floating_point
                            else a, b.view(torch.uint8)
                            if b.dtype.is_floating_point else b))


def save_and_load(cfg, qparams, spec, d: Path, scale_dtype=None,
                  draft_bits=None):
    """save_packed then load_packed on the card; -> (loaded, save s,
    load s, bytes on disk)."""
    from repro_torch.ckpt import load_packed, save_packed
    sync()
    t0 = time.time()
    save_packed(d, qparams, cfg=cfg, spec=spec, scale_dtype=scale_dtype,
                meta={"arch": cfg.name, "n_layers": cfg.n_layers},
                draft_bits=draft_bits)
    save_s = time.time() - t0
    t0 = time.time()
    loaded, lspec, meta = load_packed(d, device=DEV)
    sync()
    load_s = time.time() - t0
    require(lspec == spec.to_dict() and meta["n_layers"] == cfg.n_layers,
            "quantize path: the artifact's spec or meta changed")
    size = sum(f.stat().st_size for f in d.iterdir())
    return loaded, save_s, load_s, size


def _qts(tree) -> list:
    """The QuantizedTensor leaves of a params tree, in tree order."""
    from repro_torch.quant import QuantizedTensor
    if isinstance(tree, dict):
        return [q for v in tree.values() for q in _qts(v)]
    if isinstance(tree, list):
        return [q for v in tree for q in _qts(v)]
    return [tree] if isinstance(tree, QuantizedTensor) else []


def _qt_pairs(a, b) -> list:
    """The QuantizedTensor leaves of two like params trees, pairwise."""
    return list(zip(_qts(a), _qts(b)))


def _same_files(d1: Path, d2: Path) -> bool:
    """Two artifacts hold the same manifest and the same arrays.npz
    members byte for byte."""
    import numpy as np
    if (d1 / "manifest.json").read_text() != (d2 / "manifest.json") \
            .read_text():
        return False
    with np.load(d1 / "arrays.npz") as a, np.load(d2 / "arrays.npz") as b:
        return a.files == b.files and all(
            a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes()
            for k in a.files)


def draft_block_check(cfg, loaded, spec, d: Path):
    """The artifact's v4 draft block (saved with draft_bits=DRAFT_PLANES)
    read back by load_draft_scales against a refit of the loaded params
    on the card (the same inputs, so bit for bit), and a load-then-save
    round trip with the block, byte for byte. Returns (row, the draft
    params built from the block)."""
    from repro_torch.ckpt import load_draft_scales, save_packed
    from repro_torch.quant import make_draft_params
    sync()
    t0 = time.time()
    tree = load_draft_scales(d, device=DEV)
    block = make_draft_params(loaded, DRAFT_PLANES, tree)
    sync()
    block_s = time.time() - t0
    t0 = time.time()
    refit = make_draft_params(loaded, DRAFT_PLANES)
    sync()
    refit_s = time.time() - t0
    pairs = _qt_pairs(block, refit)
    diff = max(float((getattr(a, f).float() - getattr(b, f).float())
                     .abs().max()) for a, b in pairs
               for f in ("alphas", "betas"))
    equal = all(_leaves_equal(getattr(a, f), getattr(b, f))
                for a, b in pairs for f in ("alphas", "betas"))
    shared = all(a.codes is b.codes and a.bits == DRAFT_PLANES
                 for a, b in pairs)
    again = save_packed(d.with_name(d.name + "_resaved"), loaded, cfg=cfg,
                        spec=spec, draft_bits=DRAFT_PLANES,
                        meta={"arch": cfg.name, "n_layers": cfg.n_layers})
    row = {"check": "quantize_path_draft_block", "draft_bits": DRAFT_PLANES,
           "leaves": len(pairs), "block_draft_s": block_s,
           "refit_draft_s": refit_s, "block_vs_refit_max_abs_diff": diff,
           "block_equals_refit": equal, "codes_shared": shared,
           "resave_byte_equal": _same_files(d, again)}
    emit(row)
    require(tree is not None and len(pairs) == 7 * cfg.n_layers,
            f"quantize path: the draft block holds {len(pairs)} leaves")
    require(equal and shared, f"quantize path: the block's draft scales "
                              f"differ from a refit by {diff:.3g}")
    require(row["resave_byte_equal"], "quantize path: load then save with "
                                      "the draft block is not byte-equal")
    return row, block


def _tie_rows(choice_margin, mult_margin, N):
    """Rows with a BCchoice or multiplier near-tie in any group."""
    return ((choice_margin < CHOICE_TIE_RTOL)
            | (mult_margin < MULT_TIE_RTOL)).reshape(N, -1).any(1)


def card_vs_cpu(name, W, H):
    """One slice (the first CHECK_ROWS output rows of W (K, N)),
    quantized on the card and by the CPU path from the card's own H:
    the picks agree on every row without a choice/multiplier near-tie,
    codes on every row without a level near-tie at its first flip, and
    the output error of the rows without either within TOL_OUTPUT_ERR."""
    import torch
    from repro_torch.core.gptq import output_error
    from repro_torch.core.gptqt import gptqt_quantize
    from repro_torch.core.hessian import damp
    from repro_torch.quant import unpack_signs
    Wt = W[:, :CHECK_ROWS].T.contiguous()
    t0 = time.time()
    card = gptqt_quantize(Wt, H, orig_dtype="float32", margins=True)
    sync()
    card_s = time.time() - t0
    Wh, Hh = Wt.cpu(), H.cpu()
    t0 = time.time()
    host = gptqt_quantize(Wh, Hh, orig_dtype="float32", margins=True)
    host_s = time.time() - t0
    N, K = Wh.shape
    c = {f: getattr(card, f).cpu() for f in
         ("choice_e", "choice_j", "mult", "level_margin", "levels",
          "choice_margin", "mult_margin", "wq_t")}
    tie = (_tie_rows(host.choice_margin, host.mult_margin, N)
           | _tie_rows(c["choice_margin"], c["mult_margin"], N))
    picks = ((c["choice_e"] != host.choice_e).reshape(N, -1).any(1)
             | (c["choice_j"] != host.choice_j).reshape(N, -1).any(1)
             | ((c["mult"] - host.mult).abs() > 2.5e-7 * host.mult)
             .reshape(N, -1).any(1))
    diff = (unpack_signs(card.qt.codes.cpu(), K)
            != unpack_signs(host.qt.codes, K)).any(0).T & ~picks[:, None]
    Hd, _ = damp(Hh)
    order = torch.argsort(-torch.diagonal(Hd), stable=True)
    lv = host.levels.reshape(N, -1, 2 ** card.qt.bits)
    span = (lv.amax(-1) - lv.amin(-1)).amax(1)
    flips, at_flip = [], []
    for r in torch.nonzero(diff.any(1)).flatten().tolist():
        col = int(order[torch.nonzero(diff[r, order])[0, 0]])
        m = float(torch.minimum(host.level_margin[r, col],
                                c["level_margin"][r, col]) / span[r])
        at_flip.append(m)
        if m >= CARD_LEVEL_TIE_RTOL:
            flips.append((r, col, m))
    same = ~(picks | tie | diff.any(1))

    def errs(rows):
        return (output_error(Wh[rows], c["wq_t"][rows], Hh),
                output_error(Wh[rows], host.wq_t[rows], Hh))
    e_card, e_host = errs(same)

    def row_errs(Q):
        D = Wh - Q
        return ((D @ Hh) * D).sum(1)
    flip = diff.any(1)
    rel = ((row_errs(c["wq_t"]) - row_errs(host.wq_t))
           / row_errs(host.wq_t))[flip]
    # how far each side's factor of H^-1 is from an fp64 one (K <= 4096:
    # the fp64 chain at K=11008 takes a minute on the host)
    chol = None
    if K <= 4096:
        from repro_torch.core.gptq import _chol_inv_upper
        Hp = Hd[order][:, order]
        U64 = _chol_inv_upper(Hp.double())

        def off(U):
            return float((U.double() - U64).abs().max() / U64.abs().max())
        chol = {"card": off(_chol_inv_upper(Hp.to(DEV)).cpu()),
                "cpu": off(_chol_inv_upper(Hp))}
    row = {"check": "quantize_card_vs_cpu", "leaf": name,
           "shape": f"{CHECK_ROWS} rows x K={K}",
           "card_s": card_s, "cpu_s": host_s,
           "pick_tie_rows": int(tie.sum()),
           "picks_differ_rows": int(picks.sum()),
           "picks_differ_without_tie": int((picks & ~tie).sum()),
           "level_flip_rows": len(at_flip),
           "level_margin_at_flip_max": max(at_flip, default=None),
           "level_flips_without_tie": len(flips),
           "rows_compared_exactly": int(same.sum()),
           "output_err_card": e_card, "output_err_cpu": e_host,
           "output_err_rel": abs(e_card - e_host) / max(e_host, 1e-30),
           # card, CPU: all rows, the rows whose picks differ, the rows
           # that flipped a level pick (reported, not gated)
           "output_err_all_rows": errs(torch.ones_like(same)),
           "output_err_pick_rows": errs(picks),
           "output_err_flip_rows": errs(flip),
           # per flipped row, (card - CPU) / CPU output error
           "flip_rows_rel_err_mean": float(rel.mean()) if len(rel) else None,
           "flip_rows_rel_err_std": float(rel.std()) if len(rel) > 1
           else None,
           "flip_rows_card_lower": int((rel < 0).sum()),
           "chol_inv_upper_max_rel_off_fp64": chol}
    emit(row)
    require(not (picks & ~tie).any(),
            f"{name}: card and CPU picks differ without a near-tie")
    require(not flips, f"{name}: codes differ without a level near-tie: "
                       f"{flips[:4]}")
    require(row["output_err_rel"] <= TOL_OUTPUT_ERR,
            f"{name}: card vs CPU output error {row['output_err_rel']:.3g}")


def rtn_errors(cfg, params, batches, spec):
    """Per leaf name, RTN's output error at the same bits and group size
    (fake mode, the same calibration)."""
    from repro_torch.core import quantize_model
    _, report = quantize_model(cfg, params, batches, device=DEV,
                               spec=spec.replace(method="rtn", mode="fake"))
    return {k: v["err"] for k, v in report.items()}


def phase_quantize(seed: int, arch: str = "llama2-7b",
                   n_layers: int = QUANT_LAYERS):
    """Phase 7: quantize `arch` at full width, cut to `n_layers`, with
    GPTQT w3 per-channel (then one layer at group 128 with bf16 scales),
    save, load and serve the artifact through the paged engine."""
    import tempfile
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import StageTimer, collect_hessians, quantize_model
    from repro_torch.models import init_params
    from repro_torch.quant import QuantSpec
    cfg = get_config(arch).replace(dtype="float32", n_layers=n_layers)
    t0 = time.time()
    params = init_params(cfg, seed=seed + 3, dtype="float32", device=DEV)
    sync()
    init_s = time.time() - t0
    batches = calibration_batches(cfg.vocab_size)
    spec = QuantSpec.from_config(cfg.quant, method="gptqt", mode="packed")
    if DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()
    with FuseCheck() as fuse, StageTimer(sync) as timer:
        t0 = time.time()
        qparams, report = quantize_model(cfg, params, batches, spec=spec,
                                         device=DEV)
        sync()
        quant_s = time.time() - t0
    peak = (torch.cuda.max_memory_allocated() / 1e9 if DEV == "cuda"
            else None)
    rtn = rtn_errors(cfg, params, batches, spec)
    with tempfile.TemporaryDirectory() as tmp:
        # with the v4 draft block: w2 re-fit scales of every leaf
        loaded, save_s, load_s, size = save_and_load(
            cfg, qparams, spec, Path(tmp) / "w3_pc",
            draft_bits=DRAFT_PLANES)
        same_bytes = _leaves_equal(loaded, qparams)
        _, block_draft = draft_block_check(cfg, loaded, spec,
                                           Path(tmp) / "w3_pc")
    # one layer at group 128, scales saved as bf16
    cfg1 = cfg.replace(n_layers=1)
    p1 = {**params, "layers": params["layers"][:1]}
    spec128 = spec.replace(group_size=128)
    with FuseCheck() as fuse128:
        q128, _ = quantize_model(cfg1, p1, batches, spec=spec128, device=DEV)
    with tempfile.TemporaryDirectory() as tmp:
        l128, _, _, _ = save_and_load(cfg1, q128, spec128, Path(tmp) / "g128",
                                      scale_dtype="bfloat16")
        wd = l128["layers"][0]["mlp"]["wd"]
        bf16_ok = (wd.alphas.dtype == torch.bfloat16 and wd.n_groups
                   == cfg.d_ff // 128 and _leaves_equal(
                       l128["layers"][0]["mlp"]["wd"],
                       q128["layers"][0]["mlp"]["wd"].cast_scales("bfloat16")))
    del q128, l128
    stages = dict(timer.seconds)
    row = {"check": "quantize_path_quantize", "model": cfg.name,
           "depth": f"{n_layers} of {get_config(arch).n_layers} layers "
                    f"(cut for time)",
           "method": "gptqt w3 n=5 range 1, 33 points, per-channel, "
                     "actorder",
           "calibration": f"{CALIB_SLICES} x {CALIB_LEN} tokens, batches "
                          f"of {CALIB_BATCH}",
           "init_s": init_s, "quantize_s": quant_s,
           "s_per_layer": quant_s / n_layers,
           "stage_s": {k: v for k, v in stages.items()
                       if not k.startswith("leaf ")},
           "leaf_s_per_layer": {k[5:]: v / n_layers for k, v in
                                stages.items() if k.startswith("leaf ")},
           "save_s": save_s, "load_s": load_s, "artifact_bytes": size,
           "peak_mem_gb": peak,
           "matrices_fuse_checked": fuse.n + fuse128.n,
           "fuse_max_rel_err": max(fuse.worst, fuse128.worst),
           "roundtrip_byte_equal": same_bytes,
           "g128_bf16_roundtrip": bf16_ok,
           "output_err": {k: {"gptqt": v["err"], "rtn": rtn[k]}
                          for k, v in report.items()}}
    emit(row)
    require(not fuse.bad and not fuse128.bad,
            f"quantize path: fuse check failed {fuse.bad + fuse128.bad}")
    require(fuse.n == 7 * n_layers and fuse128.n == 7,
            f"quantize path: {fuse.n}, {fuse128.n} matrices quantized")
    require(same_bytes, "quantize path: load_packed(save_packed(x)) != x")
    require(bf16_ok, "quantize path: the g128 bf16 artifact did not "
                     "round-trip")
    # card vs CPU on layer 0's wq and wd, from the card's own Hessians
    # (layer 0's inputs depend on nothing after it)
    hs = collect_hessians(cfg1, p1, batches, spec=spec, device=DEV)
    for leaf, grp in (("wq", "attn"), ("wd", "mlp")):
        key = (0, f"['L0']['{grp}']['{leaf}']")
        card_vs_cpu(leaf, params["layers"][0][grp][leaf], hs[key][3])
    del hs, params, p1
    # serve: the loaded artifact, then the in-memory params
    counts, srow, prompts, outs, _ = serve_path("quantize_path", cfg,
                                                loaded, seed)
    emit(srow)
    _, _, _, outs_mem, _ = serve_path("quantize_path_in_memory", cfg,
                                      qparams, seed)
    emit({"check": "quantize_path_tokens", "requests": len(outs),
          "loaded_equals_in_memory": outs == outs_mem})
    # the loaded artifact served speculatively from its draft block
    _, sprow, _, outs_spec, _ = serve_path(
        "quantize_path_speculative", cfg, loaded, seed, speculate=4,
        draft_params=block_draft)
    emit(sprow)
    for i, (want_t, got_t) in enumerate(zip(outs, outs_spec)):
        div = first_divergence(cfg, loaded, prompts[i], want_t, got_t)
        emit({"check": "quantize_path_speculative_tokens", "request": i,
              "equal_to_plain": div is None,
              **({} if div is None else
                 {"first_diff": div[0], "plain_top2_gap_rel": div[1],
                  "gap_limit": 2 * TOL_LOGITS})})
        require(div is None or div[1] <= 2 * TOL_LOGITS,
                f"quantize path: speculative request {i} differs at "
                f"token {div and div[0]} with a gap of {div and div[1]}")
    for k in ("bcq_gemv", "bcq_matmul", "paged_attention"):
        require(counts[k] > 0, f"quantize path: {k} was never launched")
    require(counts["paged_attention"] == cfg.n_layers * srow["decode_ticks"]
            and counts["paged_attention_quant"] == 0
            and counts["bcq_expert_matmul"] == 0,
            f"quantize path: launches {counts}")
    require(outs == outs_mem, "quantize path: the loaded artifact served "
                              "other tokens than the in-memory params")
    return counts, row


def _state_snapshot(pool, n_pages):
    """Copies of a pool's leaves that a decode step advances rather than
    rewrites (Mamba state rows), to put back with _restore."""
    from repro_torch.models import is_page_leaf
    return [(leaf, leaf.clone()) for layer in pool for leaf in layer.values()
            if not is_page_leaf(leaf, n_pages)]


def _restore(saved):
    for leaf, copy in saved:
        leaf.copy_(copy)


def graph_decode_profile(cfg, params, pool, bt, pos, steps):
    """The same decode step borrowed from serve/compile_cache.py (on the
    card a CUDA graph captured on its first call, then replayed) on the
    pool profile_decode prefilled: its logits against the eager step's
    on the same pool and inputs (Mamba state rows put back between the
    two), then timed as profile_decode times the eager step."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import decode_step_paged
    from repro_torch.roofline.op_profile import (kernel_time_by_name,
                                                 traced_kernels)
    from repro_torch.serve import compile_cache
    B = len(pos)
    step = compile_cache.get("decode_paged", cfg)
    tok_np = np.zeros((B, 1), np.int32)
    pos_np = pos.cpu().numpy()
    live = np.ones((B,), np.int32)
    null = torch.zeros((B,), dtype=torch.int32, device=DEV)
    n_pages = next(iter(pool[0].values())).shape[0]
    saved = _state_snapshot(pool, n_pages)
    want = decode_step_paged(cfg, params, pool, torch.tensor(tok_np,
                                                             device=DEV),
                             pos, bt)[0].clone()
    _restore(saved)
    got = step(params, pool, tok_np, pos_np, bt, live, null)[0].clone()
    dlogit = float((got - want).abs().max() / want.abs().max())

    def run(first):
        for i in range(first, first + steps):
            step(params, pool, tok_np, pos_np + i, bt, live, null)
        sync()
    run(0)
    t0 = time.perf_counter()
    run(steps)
    wall = (time.perf_counter() - t0) / steps * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run(2 * steps)
    kernels = traced_kernels(prof)
    busy = sum(kernel_time_by_name(kernels).values()) / 1e3 / steps
    return {"graph_wall_ms_per_step": wall,
            "graph_device_busy_ms_per_step": busy,
            "graph_device_idle_share": (1 - busy / wall) if busy else None,
            "graph_kernels_per_step": len(kernels) / steps,
            "graph_max_dlogit_rel": dlogit,
            "graph_dlogit_tol": TOL_GRAPH}


def profile_decode(cfg, params, prompts, steps: int = 4, kv_bits: int = 0,
                   tag: str = "main"):
    """Where a path's decode step's time goes: the paged decode step at
    batch 4 (each prompt already in its pages), timed untraced, then
    traced with torch.profiler: device busy time per step, kernels per
    step and the kernels that take the most device time; beside it the
    same step replayed from its CUDA graph (graph_decode_profile), whose
    logits must equal the eager step's within TOL_GRAPH. With kv_bits,
    also the quantize-on-write of one step alone (every layer's new K/V
    through kv_quantize), host wall and device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import decode_step_paged
    from repro_torch.quant.kv import kv_quantize
    from repro_torch.roofline.op_profile import (kernel_time_by_name,
                                                 top_kernels, traced_kernels)
    B = len(prompts)
    pool, bt, pos = prefilled_pool(cfg, params, prompts, kv_bits)
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
    kernels = traced_kernels(prof)
    by_name = kernel_time_by_name(kernels)
    busy = sum(by_name.values()) / 1e3 / steps
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
           "top_kernels_ms_per_step": top_kernels(by_name, steps)}
    row.update(graph_decode_profile(cfg, params, pool, bt, pos, steps))
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
    require(row["graph_max_dlogit_rel"] <= TOL_GRAPH,
            f"{tag} decode: the graph's logits differ from the eager "
            f"step's by {row['graph_max_dlogit_rel']:.3g} of max|logit|")
    return row


def prefilled_pool(cfg, params, prompts, kv_bits=0, page=64, pps=3):
    """A paged pool holding each prompt in pages of its own (`pps` a
    sequence, prefilled and scattered, or with window layers written by
    one extend pass, as the engine prefills them; a Mamba layer's state
    lands in row b): (pool, block tables (B, pps), positions (B,) = the
    prompts' lengths), on the card."""
    import torch
    from repro_torch.models import (extend_paged, init_paged_cache, prefill,
                                    scatter_prefill_cache)
    B = len(prompts)
    pool = init_paged_cache(cfg, B * pps + 1, page, B, kv_bits=kv_bits,
                            device=DEV)
    bt = torch.zeros((B, pps), dtype=torch.int32)
    windows = any(s.window is not None for s in cfg.pattern)
    for b, p in enumerate(prompts):
        ids = list(range(1 + b * pps, 1 + (b + 1) * pps))
        bt[b] = torch.tensor(ids, dtype=torch.int32)
        npg = -(-len(p) // page)
        tok = torch.tensor(p[None], device=DEV)
        if windows:
            ints = lambda v: torch.tensor(v, dtype=torch.int32, device=DEV)
            extend_paged(cfg, params, pool, tok, ints([0]),
                         ints([ids[:npg]]), ints([len(p)]))
            continue
        _, row = prefill(cfg, params, tok, len(p))
        scatter_prefill_cache(cfg, pool, row, b, ids[:npg], len(p))
    pos = torch.tensor([len(p) for p in prompts], dtype=torch.int32,
                       device=DEV)
    return pool, bt.to(DEV), pos


# ---------------------------------------------------------------------------
# phase 8: self-speculative decoding at full width
# ---------------------------------------------------------------------------

SPEC_K = 4
SPEC_MIN_ACCEPT_PERFECT = 0.95


def _propose_args(cfg, params, draft, prompts, k):
    """A prefilled pool and a k-step draft_propose_paged call on it for
    every prompt's row (its last token 0, full depth)."""
    import torch
    from repro_torch.models import draft_propose_paged
    pool, bt, pos = prefilled_pool(cfg, params, prompts)
    B = len(prompts)
    cur = torch.zeros((B,), dtype=torch.int32, device=DEV)
    ke = torch.full((B,), k, dtype=torch.int32, device=DEV)
    null = torch.zeros((B,), dtype=torch.int32, device=DEV)

    def propose():
        return draft_propose_paged(cfg, draft, pool, cur, pos, bt, ke,
                                   null, k)[0]
    return pool, bt, pos, cur, propose


def host_copy_check(fn) -> dict:
    """Run fn() once with no device-to-host copy allowed: under
    torch.cuda.set_sync_debug_mode("error"); should that mode raise, the
    DtoH copies of a torch.profiler trace of the call are counted
    instead. Returns {"method", "synced", ...}."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    row = {}
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
        row.update(method="sync_debug_mode error", synced=False)
    except RuntimeError as e:
        row.update(method="profiler DtoH memcpy count",
                   sync_debug_raised=str(e)[:200])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    sync()
    if "synced" not in row:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            sync()
        row["dtoh_copies"] = sum("DtoH" in e.name or "Device -> Pageable"
                                 in e.name for e in prof.events())
        row["synced"] = row["dtoh_copies"] > 0
    return row


def propose_sync_check(cfg, params, draft, prompts, k=SPEC_K):
    """One draft_propose_paged call runs with no device-to-host copy
    (host_copy_check)."""
    *_, propose = _propose_args(cfg, params, draft, prompts, k)
    propose()                                  # warm-up (kernel loads)
    sync()
    row = {"check": "speculative_propose_sync", "k": k,
           "batch": len(prompts)}
    if DEV != "cuda":
        row["method"] = "not run off the card"
        emit(row)
        return row
    row.update(host_copy_check(propose))
    emit(row)
    require(not row["synced"], f"speculative path: draft_propose_paged "
                               f"copies to the host ({row})")
    return row


def decode_step_sync(cfg, params, prompts, kv_bits=0):
    """One decode step runs with no device-to-host copy (host_copy_check):
    decode_step_paged eagerly, and the compile cache's `decode_paged`
    (host inputs in, the graph replayed), at batch 4 on a prefilled
    pool; both warmed up (and the graph captured) first."""
    import numpy as np
    import torch
    from repro_torch.models import decode_step_paged
    from repro_torch.serve import compile_cache
    pool, bt, pos = prefilled_pool(cfg, params, prompts, kv_bits)
    B = len(prompts)
    tok = torch.zeros((B, 1), dtype=torch.int32, device=DEV)
    step = compile_cache.get("decode_paged", cfg)
    args = (np.zeros((B, 1), np.int32), pos.cpu().numpy(), bt,
            np.ones((B,), np.int32),
            torch.zeros((B,), dtype=torch.int32, device=DEV))
    calls = {"eager": lambda: decode_step_paged(cfg, params, pool, tok, pos,
                                                bt),
             "graph": lambda: step(params, pool, *args)}
    for fn in calls.values():
        fn()
    sync()
    row = {"check": "decode_step_sync", "kv_bits": kv_bits, "batch": B}
    if DEV != "cuda":
        row["method"] = "not run off the card"
        emit(row)
        return row
    for name, fn in calls.items():
        row[name] = host_copy_check(fn)
    emit(row)
    require(not row["eager"]["synced"] and not row["graph"]["synced"],
            f"decode step (kv_bits {kv_bits}) copies to the host ({row})")
    return row


def compile_cache_report(path: str) -> dict:
    """The compile cache after a path's models are freed: its stats(),
    graphs captured, capture seconds, replays and the kernel launches
    inside them, the graphs still alive (must be 0: a graph goes with
    the params or pool it reads), allocated memory, and the memory
    reserved before and after clear()."""
    import torch
    from repro_torch.serve import compile_cache
    gc.collect()
    sync()
    gs = compile_cache.graph_stats()
    row = {"check": "compile_cache", "path": path,
           "stats": compile_cache.stats(),
           "graphs_captured": gs["captured"], "capture_s": gs["capture_s"],
           "replays": gs["replays"], "launches_in_replays": gs["launches"],
           "graphs_alive_after_models_freed": gs["live"]}
    if DEV == "cuda":
        torch.cuda.empty_cache()
        row.update(allocated_gb=torch.cuda.memory_allocated() / 1e9,
                   reserved_before_clear_gb=torch.cuda.memory_reserved()
                   / 1e9)
    compile_cache.clear()
    gc.collect()
    if DEV == "cuda":
        torch.cuda.empty_cache()
        row["reserved_after_clear_gb"] = torch.cuda.memory_reserved() / 1e9
    emit(row)
    require(gs["live"] == 0, f"{path}: {gs['live']} graphs outlived the "
                             f"models they read")
    require(DEV != "cuda" or row["allocated_gb"] < FREED_ALLOCATED_GB,
            f"{path}: {row.get('allocated_gb')} GB still allocated after "
            f"its models were freed")
    return row


def _device_profile(fn, steps):
    """fn() timed untraced over `steps` calls (synchronised), then traced:
    wall ms, device-busy ms and kernels per call, and the idle share."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.roofline.op_profile import (kernel_time_by_name,
                                                 traced_kernels)
    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(steps):
        fn()
    sync()
    wall = (time.perf_counter() - t0) / steps * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        sync()
    kernels = traced_kernels(prof)
    busy = sum(kernel_time_by_name(kernels).values()) / 1e3 / steps
    return {"wall_ms": wall, "device_busy_ms": busy,
            "device_idle_share": (1 - busy / wall) if busy else None,
            "kernels": len(kernels) / steps}


def speculative_profile(cfg, params, draft, prompts, decode_row, k=SPEC_K,
                        steps=3):
    """Where one tick of engine A's time goes: draft_propose_paged (k
    draft steps) and verify_paged (k+1 positions a row) at batch 4 on a
    prefilled pool, each timed untraced and traced; beside it the
    non-speculative decode step (`decode_row`, profile_decode's), and the
    whole tick through the compile cache's `draft_propose` and
    `verify_paged` (CUDA graphs on the card), whose draft tokens must
    equal the eager tick's and its logits within TOL_GRAPH."""
    import numpy as np
    import torch
    from repro_torch.models import verify_paged
    from repro_torch.serve import compile_cache
    pool, bt, pos, cur, propose = _propose_args(cfg, params, draft,
                                                prompts, k)
    B = len(prompts)
    toks = torch.cat([cur[:, None], propose()], dim=1)
    nv = torch.full((B,), k + 1, dtype=torch.int32, device=DEV)
    g_propose = compile_cache.get("draft_propose", cfg)
    g_verify = compile_cache.get("verify_paged", cfg)
    cur_np, pos_np = cur.cpu().numpy(), pos.cpu().numpy()
    ke_np = np.full((B,), k, np.int32)
    nv_np = np.full((B,), k + 1, np.int32)
    live = np.ones((B,), np.int32)
    null = torch.zeros((B,), dtype=torch.int32, device=DEV)

    def graph_tick():
        d = g_propose(draft, pool, cur_np, pos_np, bt, ke_np, null, k)[0]
        t = torch.cat([cur[:, None], d], dim=1)
        return t, g_verify(params, pool, t, pos_np, bt, nv_np, live,
                           null)[0]
    want_logits = verify_paged(cfg, params, pool, toks, pos, bt, nv)[0]
    want_logits = want_logits.clone()
    got_toks, got_logits = graph_tick()
    graph = {"draft_tokens_equal": bool(torch.equal(got_toks, toks)),
             "max_dlogit_rel": float((got_logits - want_logits).abs().max()
                                     / want_logits.abs().max()),
             **_device_profile(graph_tick, steps)}
    parts = {"propose": _device_profile(propose, steps),
             "verify": _device_profile(
                 lambda: verify_paged(cfg, params, pool, toks, pos, bt, nv),
                 steps)}
    tick = {key: sum(p[key] for p in parts.values())
            for key in ("wall_ms", "device_busy_ms", "kernels")}
    row = {"check": "speculative_profile", "engine": "A", "k": k,
           "batch": len(prompts), "steps": steps, **parts,
           "tick_wall_ms": tick["wall_ms"],
           "tick_device_busy_ms": tick["device_busy_ms"],
           "tick_device_idle_share": (1 - tick["device_busy_ms"]
                                      / tick["wall_ms"])
           if tick["device_busy_ms"] else None,
           "kernels_per_tick": tick["kernels"],
           "graph_tick_wall_ms": graph["wall_ms"],
           "graph_tick_device_busy_ms": graph["device_busy_ms"],
           "graph_tick_device_idle_share": graph["device_idle_share"],
           "graph_kernels_per_tick": graph["kernels"],
           "graph_draft_tokens_equal": graph["draft_tokens_equal"],
           "graph_max_dlogit_rel": graph["max_dlogit_rel"],
           "graph_dlogit_tol": TOL_GRAPH,
           "decode_step": {key: decode_row[key] for key in (
               "wall_ms_per_step", "device_busy_ms_per_step",
               "device_idle_share", "kernels_per_step",
               "graph_wall_ms_per_step", "graph_device_busy_ms_per_step",
               "graph_device_idle_share", "graph_kernels_per_step")}}
    emit(row)
    require(graph["draft_tokens_equal"]
            and graph["max_dlogit_rel"] <= TOL_GRAPH,
            f"speculative tick: the graphs differ from the eager tick "
            f"({graph})")
    return row


def phase_speculative(seed: int, model, baseline=None, max_new=32,
                      profile_steps=4):
    """Phase 8 on phase 3's model and requests: engines A (a w2 self-draft
    refit at boot, k=4), B (the same draft, k=1: verify at 8 rows on the
    GEMV) and C (a perfect draft, the target's own params, k=4), each
    held to the non-speculative paged engine's tokens (`baseline`, phase
    3's; run here when None) up to a printed near-tie; then the propose
    sync check and one profiled tick of A beside the plain decode step,
    each over `profile_steps` calls (`max_new` and `profile_steps`
    shrink for rehearsals on the CPU). Returns (summed launch counts of
    the three runs, rows)."""
    import math
    import torch
    from repro_torch.quant import draft_extra_bytes
    cfg, params = model
    if baseline is None:
        _, brow, _, baseline, _ = serve_path("speculative_path_baseline",
                                             cfg, params, seed,
                                             max_new=max_new)
        emit(brow)
    total, rows, draft_a = {}, {}, None
    for tag, k, kw in (("A", SPEC_K, {}), ("B", 1, {}),
                       ("C", SPEC_K, {"draft_params": params})):
        counts, row, prompts, outs, eng = serve_path(
            "speculative_path", cfg, params, seed, max_new=max_new,
            speculate=k, draft_bits=DRAFT_PLANES, **kw)
        pairs = _qt_pairs(eng.params, eng.draft_params)
        extra = draft_extra_bytes(eng.params, eng.draft_params)
        scale = sum(a.numel() * a.element_size() for t, q in pairs
                    if q.alphas is not t.alphas for a in (q.alphas, q.betas))
        shared = all(q.codes.untyped_storage().data_ptr()
                     == t.codes.untyped_storage().data_ptr()
                     for t, q in pairs)
        row.update({"engine": tag, "draft_extra_bytes": extra,
                    "draft_scale_bytes": scale,
                    "draft_codes_share_target_storage": shared})
        if tag == "C":
            # a perfect draft: each tick emits k+1 of the decode tokens
            row["ideal_ticks"] = math.ceil((max_new - 1) / (k + 1))
        rows[tag] = row
        emit(row)
        require(extra == scale and shared,
                f"speculative path {tag}: the draft adds {extra} bytes, "
                f"its scales hold {scale}; codes shared: {shared}")
        for name in ("bcq_gemv", "paged_attention") + (
                ("bcq_matmul",) if k > 1 else ()):
            require(counts[name] > 0, f"speculative path {tag}: {name} was "
                                      f"never launched")
        for i, (want_t, got_t) in enumerate(zip(baseline, outs)):
            div = first_divergence(cfg, params, prompts[i], want_t, got_t)
            emit({"check": "speculative_path_tokens", "engine": tag,
                  "request": i, "equal_to_plain": div is None,
                  **({} if div is None else
                     {"first_diff": div[0], "plain_top2_gap_rel": div[1],
                      "gap_limit": 2 * TOL_LOGITS})})
            require(div is None or div[1] <= 2 * TOL_LOGITS,
                    f"speculative path {tag}: request {i} differs from the "
                    f"plain engine at token {div and div[0]} with a gap of "
                    f"{div and div[1]}")
        for name, v in counts.items():
            total[name] = total.get(name, 0) + v
        if tag == "A":
            draft_a = eng.draft_params
        del eng
    require(rows["C"]["acceptance_rate"] >= SPEC_MIN_ACCEPT_PERFECT,
            f"speculative path C: a perfect draft accepted "
            f"{rows['C']['acceptance_rate']:.3f} of its tokens")
    propose_sync_check(cfg, params, draft_a, prompts)
    decode_row = profile_decode(cfg, params, prompts, steps=profile_steps,
                                tag="speculative_plain")
    speculative_profile(cfg, params, draft_a, prompts, decode_row,
                        steps=profile_steps)
    del draft_a
    if DEV == "cuda":
        torch.cuda.empty_cache()
    return total, rows


# ---------------------------------------------------------------------------
# phase 12: meshes of ranks on the one card
# ---------------------------------------------------------------------------

# (data, model) meshes of phase 3's model; Qwen3-MoE serves on (1, 2).
# The data-axis mesh (2, 1), plain and speculative, serves phase 3's 32
# layers (its steps replay graphs, as one device's do); the meshes with
# a model axis ((1, 2), (2, 2), speculative (1, 2)) and the FSDP meshes
# serve its first MESH_CUT_LAYERS layers, for time (their steps run
# eagerly: ~4 ms an all-reduce on the model axis, and an FSDP pass
# gathers every layer's codes through host memory; 8 layers until
# phase 13 needed the room)
MESHES = ((1, 2), (2, 1), (2, 2))
MESH_CUT_LAYERS = 4
# weights sharded over the data axis too (load_packed(fsdp=True)), plain
# (FSDP_MAX_NEW tokens) and speculative (FSDP_SPEC_MAX_NEW), for time:
# ~1 s a pass on one card
FSDP_MESH = (2, 1)
FSDP_MAX_NEW, FSDP_SPEC_MAX_NEW = 16, 8
# a resident FSDP rank: the share of the single device's weight bytes
# the data axis cuts (llama2-7b's every matrix, embedding and head: all
# but the norms and the expand leaves' scales) is at least this
FSDP_MIN_CUT_SHARE = 0.99
# a model axis wider than the KV heads: Qwen3-MoE (4 KV heads) on (1, 8),
# its pools replicated over the axis, cut to REP_LAYERS of 94 layers for
# time; built and cut once, each rank loading its slice
REP_MESH = (1, 8)
REP_LAYERS = 2
# a 4-bit replicated pool's words that may differ from the single
# device's at quantize-on-write near-ties (12 of 212,992 read on an
# H100; forced_pool_check holds the run itself)
NEAR_TIE_WORDS = 64
# dense caches split along the sequence: minicpm3-4b's latents on (1, 2)
DENSE_ZOO = (("minicpm3-4b", 8),)
MOE_MESH = (1, 2)
# Qwen3-MoE's depth in phase 12: for time (the ranks each build the
# whole synthetic model before keeping their experts)
MESH_MOE_LAYERS = 4
# MLA and Mamba on a model axis: (arch, layers) at full width on
# ZOO_MESH, each rank building the seeded model (synthetic_zoo) and
# cutting it with shard_params. minicpm3-4b and falcon-mamba-7b are cut
# to 8 layers for time (eager steps on a model axis pay ~4 ms an
# all-reduce, two a Mamba layer; 16 until phase 13 needed the room);
# jamba-1.5-large to one super-block of 8, as in phase 9 (its 72
# layers' w3 codes exceed the card)
MESH_ZOO = (("minicpm3-4b", 8), ("falcon-mamba-7b", 8),
            ("jamba-1.5-large-398b", 8))
ZOO_MESH = (1, 2)
# speculation under a mesh: phase 3's model (cut on the model axis)
# with a w2 self-draft from a saved v4 draft block, k=SPEC_K
SPEC_MESHES = ((2, 1), (1, 2))
MESH_TIMEOUT_S = 600
# decode calls (speculative ticks) of a rank traced by torch.profiler
# (device busy time), and all-reduces timed alone a rank
MESH_TRACE_FROM, MESH_TRACE_STEPS = 8, 2
MESH_SPEC_TRACE_FROM = 2
ALLREDUCE_ITERS = 20


def _tree_bytes(tree, whole=False) -> int:
    """Device bytes of a param tree (QuantizedTensors' three fields, an
    FSDP block's fields; with `whole` a block counts as the leaf it is
    gathered into)."""
    if isinstance(tree, dict):
        return sum(_tree_bytes(v, whole) for v in tree.values())
    if isinstance(tree, list):
        return sum(_tree_bytes(v, whole) for v in tree)
    if hasattr(tree, "fields"):
        return sum(t.numel() * t.element_size()
                   * (tree.parts if whole and tree.dims[f] is not None
                      else 1)
                   for f, t in tree.fields.items())
    if hasattr(tree, "codes"):
        return sum(t.numel() * t.element_size()
                   for t in (tree.codes, tree.alphas, tree.betas))
    return tree.numel() * tree.element_size()


# a dense decoder's matrices by the dim the reference's FSDP rule
# (dist/sharding.py) puts the data axis on: K of the expand leaves (their
# codes; the scales, one a column, stay whole), N of the contract leaves
# (codes and scales)
_EXPAND, _CONTRACT = ("wq", "wk", "wv", "wg", "wu"), ("wo", "wd")


def _fsdp_cut_bytes(tree, name="") -> int:
    """The bytes of an unsharded dense decoder's tree (llama2-7b's) that
    FSDP cuts over the data axis: every matrix's codes, the contract
    leaves' scales, the embedding and the head (d_model); the norms stay
    whole. Any other leaf raises (this counts a dense decoder only)."""
    nbytes = lambda t: t.numel() * t.element_size()
    if isinstance(tree, dict):
        return sum(_fsdp_cut_bytes(v, k) for k, v in tree.items())
    if isinstance(tree, list):
        return sum(_fsdp_cut_bytes(v, name) for v in tree)
    if hasattr(tree, "codes"):
        if name in _EXPAND:
            return nbytes(tree.codes)
        if name in _CONTRACT:
            return sum(map(nbytes, (tree.codes, tree.alphas, tree.betas)))
    elif name in ("embed", "lm_head"):
        return nbytes(tree)
    elif tree.dim() == 1:
        return 0
    raise ValueError(f"{name}: not a leaf of a dense decoder")


def path_prompts(seed, vocab):
    """serve_path's four prompts."""
    import numpy as np
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in PROMPT_LENS]


def record_logits(eng, requests) -> list:
    """Wrap an engine's first-token and decode (or, speculating,
    verify) paths so that every logits row of a token of `requests` on
    this rank lands in the returned list as (request index, token index,
    row, the draft tokens the row's context holds before it). A verify
    row j stands for the token j places on only where the j draft tokens
    before it are the tokens the request emitted there."""
    import numpy as np
    index = {id(r): i for i, r in enumerate(requests)}
    log, emit = [], eng._emit_first_token

    def first(e, last_logits, prompt_len):
        if last_logits is not None:
            log.append((index[id(e.req)], len(e.req.out),
                        last_logits[0].float().cpu(), []))
        return emit(e, last_logits, prompt_len)

    def req_of(r):
        return eng.sched.running[eng.lo + int(r)].req

    if eng.speculate:
        verify = eng._verify

        def step(*args):
            logits, cache = verify(*args)
            toks = args[2].cpu().numpy()
            for r in np.flatnonzero(np.asarray(args[6])):   # live rows
                req = req_of(r)
                for j in range(int(np.asarray(args[5])[r])):
                    log.append((index[id(req)], len(req.out) + j,
                                logits[r, j].float().cpu(),
                                [int(t) for t in toks[r, 1:1 + j]]))
            return logits, cache
        eng._emit_first_token, eng._verify = first, step
        return log
    decode = eng._decode

    def step(*args):
        # the live rows: a paged step's mask; a dense step runs every row
        # of the rank, whose ready ones take their tokens
        rows = (np.flatnonzero(np.asarray(args[5])) if len(args) > 4 else
                [s - eng.lo for s in eng._decode_ready()
                 if eng.lo <= s < eng.lo + eng.rows])
        logits, cache = decode(*args)
        for r in rows:
            req = req_of(r)
            log.append((index[id(req)], len(req.out),
                        logits[r].float().cpu(), []))
        return logits, cache
    eng._emit_first_token, eng._decode = first, step
    return log


def serve_recorded(cfg, params, prompts, path, max_new=32, kv_bits=0,
                   cache_kind="paged", keep_codes=False):
    """The single-device engine (paged, or dense) on `prompts`, every
    logits row a token was taken from recorded and saved to `path` (for
    the ranks to hold theirs against; with `keep_codes` the final pool's
    binary-coded K/V words too); returns (tokens, ms a decode tick)."""
    import torch
    from repro_torch.serve import Request, ServeEngine
    eng = ServeEngine(cfg, params, batch_size=4, max_len=SERVE_MAX_LEN,
                      dtype="float32", cache_kind=cache_kind, page_size=64,
                      kv_bits=kv_bits, prefix_sharing=False, device=DEV)
    reqs = [Request(prompt=p, max_new_tokens=max_new) for p in prompts]
    log = record_logits(eng, reqs)
    eng.run(reqs)
    sync()
    torch.save({"tokens": [r.out for r in reqs],
                "logits": {(i, t): row for i, t, row, _ in log},
                "codes": _pool_codes(eng.cache) if keep_codes else None},
               path)
    return ([r.out for r in reqs],
            1e3 * eng.stats["decode_s"] / max(eng.stats["ticks"], 1))


def _pool_codes(cache) -> list:
    """The binary-coded K/V words of a pool, on the host."""
    return [layer[k].cpu() for layer in cache for k in ("k_codes", "v_codes")
            if k in layer]


def _pool_digest(cache) -> str:
    """sha256 of every leaf of a pool, in order."""
    import hashlib
    h = hashlib.sha256()
    for layer in cache:
        for k in sorted(layer):
            h.update(layer[k].cpu().numpy().tobytes())
    return h.hexdigest()


def forced_pool_check(name, cfg, spec) -> float:
    """A 4-bit mesh's quantize-on-write flips a code at a near-tie
    wherever a rank's K/V differs from the single device's in the last
    bit (the model group sums wo's partial products in another order);
    the two pools then drift apart, and the whole run's logits differ
    beyond any tolerance that holds arithmetic. So the whole run is held
    to the single device forced onto the rank's writes: rank 0 recorded
    the input of every quantize-on-write, its logits rows and its final
    pool; here the single-device engine (eager) serves the same requests
    and at each write, in order, takes the rank's input in place of its
    own after holding the two within TOL_LOGITS x max|x|. Its final pool
    must then be the rank's bit for bit (every write right and in its
    place), its tokens the rank's and every logits row within
    TOL_LOGITS x max|logit|; the words the rank's final pool holds other
    than the unforced single device's (near-ties) stay within
    NEAR_TIE_WORDS. Emits a `mesh_path_forced_pool` line; returns the
    worst logits row's |Δlogit| / max|logit|."""
    import types
    import torch
    from repro_torch.models import attention
    from repro_torch.serve import Request, ServeEngine, compile_cache
    rec = torch.load(spec["forced"])
    params = synthetic_zoo(spec["seed"], cfg)
    eng = ServeEngine(cfg, params, batch_size=4, max_len=SERVE_MAX_LEN,
                      dtype="float32", cache_kind="paged", page_size=64,
                      kv_bits=spec["kv_bits"], prefix_sharing=False,
                      device=DEV)
    # eager: a graph would replay the first step's writes
    d = eng._decode
    eng._decode = compile_cache.Step(d.kind, d.cfg, d._fn, d._roles)
    quantize, calls, x_err = attention.kv_quantize, [0], [0.0]

    def forced(x, *a, **kw):
        i = calls[0]
        calls[0] += 1
        xr = rec["x"][i].to(x.device) if i < len(rec["x"]) else None
        if xr is None or xr.shape != x.shape:
            x_err[0] = float("inf")
            return quantize(x, *a, **kw)
        x_err[0] = max(x_err[0], float((x - xr).abs().max()
                                       / xr.abs().max().clamp_min(1e-30)))
        return quantize(xr, *a, **kw)
    reqs = [Request(prompt=p, max_new_tokens=spec["max_new"])
            for p in spec["prompts"]]
    log = record_logits(eng, reqs)
    attention.kv_quantize = forced
    try:
        eng.run(reqs)
    finally:
        attention.kv_quantize = quantize
    pool_equal = len(eng.cache) == len(rec["pool"]) and all(
        layer.keys() == r.keys() and all(torch.equal(layer[k].cpu(), r[k])
                                         for k in r)
        for layer, r in zip(eng.cache, rec["pool"]))
    want = {"tokens": [r.out for r in reqs],
            "logits": {(i, t): row for i, t, row, _ in log}}
    worst, rows, gaps = _rank_tokens_check(
        [types.SimpleNamespace(out=t) for t in rec["tokens"]],
        [(i, t, row, []) for (i, t), row in rec["logits"].items()], want)
    single = torch.load(spec["want"])["codes"]
    differ = sum(int((a != b).sum())
                 for a, b in zip(_pool_codes(rec["pool"]), single))
    del params, eng
    _free()
    emit({"check": "mesh_path_forced_pool", "path": name, "card": CARD,
          "writes": len(rec["x"]), "writes_forced": calls[0],
          "max_dx_rel": x_err[0], "final_pool_equal": pool_equal,
          "tokens_equal": not gaps, "logit_rows_compared": rows,
          "max_dlogit_rel": worst, "tol": TOL_LOGITS,
          "near_tie_words": differ, "near_tie_words_limit": NEAR_TIE_WORDS,
          "final_pool_words": sum(t.numel() for t in single)})
    require(calls[0] == len(rec["x"]) and x_err[0] <= TOL_LOGITS,
            f"{name}: the rank's {len(rec['x'])} quantize-on-write inputs "
            f"are not the forced single device's {calls[0]} (worst "
            f"{x_err[0]:.3g} of max|x|)")
    require(pool_equal, f"{name}: the forced single device's final pool "
                        f"is not the rank's")
    require(not gaps and rows > 0 and worst <= TOL_LOGITS,
            f"{name}: forced onto the rank's writes the single device's "
            f"tokens differ ({gaps}) or its logits are {worst:.3g} of "
            f"max|logit| off")
    require(differ <= NEAR_TIE_WORDS,
            f"{name}: {differ} words of the rank's final pool are not the "
            f"single device's (limit {NEAR_TIE_WORDS})")
    return worst


def _rank_tokens_check(reqs, logits_log, want):
    """A rank's tokens and logits rows against the single device's: the
    first token index each request differs at (None: equal), the top-2
    gap there relative to max|logit| of the single device's row, and the
    worst |Δlogit| / max|logit| over the rows up to the divergence (a
    verify row where its context holds the emitted tokens)."""
    first = {}
    for i, r in enumerate(reqs):
        w = want["tokens"][i]
        diff = [t for t, (a, b) in enumerate(zip(r.out, w)) if a != b]
        if len(r.out) != len(w) and not diff:
            diff = [min(len(r.out), len(w))]
        first[i] = diff[0] if diff else None
    worst, rows = 0.0, 0
    for i, t, row, drafted in logits_log:
        if first[i] is not None and t > first[i]:
            continue
        if drafted and (reqs[i].out[t - len(drafted):t] != drafted
                        or (i, t) not in want["logits"]):
            continue   # a rejected draft's context, or past the last token
        ref = want["logits"][(i, t)]
        worst = max(worst, float((row - ref).abs().max() / ref.abs().max()))
        rows += 1
    gaps = {}
    for i, t in first.items():
        if t is not None:
            top = want["logits"][(i, t)].double().topk(2).values
            gaps[i] = (t, float((top[0] - top[1])
                                / want["logits"][(i, t)].abs().max()))
    return worst, rows, gaps


def _mesh_rank(mesh, spec):
    """One rank of a phase-12 mesh: its slice of the model (load_packed(
    mesh=) from a saved artifact, with its draft block's cut when
    speculating; or a seeded synthetic model built and cut by
    shard_params), the path's requests served with every decode call
    (speculative tick) timed, a window of them traced, and the launches'
    shapes logged; then the model group's all-reduce timed alone. -> the
    rank's row."""
    from repro_torch.dist.context import mesh_context
    with mesh_context(mesh):
        return _mesh_rank_row(mesh, spec)


def _rank_model(mesh, spec):
    """(cfg, this rank's params, its draft tree or None) of a spec."""
    import torch
    from repro_torch.ckpt.packed import load_draft_scales, load_packed
    from repro_torch.configs import get_config
    from repro_torch.dist.sharding import shard_params
    from repro_torch.quant.draft import make_draft_params
    if spec["artifact"]:
        fsdp = spec.get("fsdp", False)
        params, _, _ = load_packed(spec["artifact"], mesh=mesh, fsdp=fsdp)
        cfg = get_config(spec["arch"]).replace(
            dtype="float32", n_layers=len(params["layers"]))
        draft = None
        if spec.get("speculate"):
            draft = make_draft_params(params, DRAFT_PLANES, load_draft_scales(
                spec["artifact"], mesh=mesh, fsdp=fsdp))
        return cfg, params, draft
    if spec.get("in_turn"):
        # each rank builds the whole model on the card and cuts its slice
        # in turn (all at once they would hold the model D x M times)
        from repro_torch.dist.context import gather_data, reduce_model
        cfg = spec["cfg"]
        for r in range(mesh.size):
            if r == mesh.rank:
                params = shard_params(cfg, synthetic_zoo(spec["seed"], cfg),
                                      mesh)
                if DEV == "cuda":
                    torch.cuda.empty_cache()
            reduce_model(torch.zeros(1, device=DEV))    # the mesh's barrier
            gather_data(torch.zeros(1), mesh)
        return cfg, params, None
    if "cfg" in spec:
        cfg = spec["cfg"]
        full = synthetic_zoo(spec["seed"], cfg)
    else:
        cfg, full = synthetic_moe(spec["seed"], spec["arch"],
                                  spec["n_layers"])
    params = shard_params(cfg, full, mesh)
    del full
    if DEV == "cuda":
        torch.cuda.empty_cache()
    return cfg, params, None


def _mesh_rank_row(mesh, spec):
    global DEV
    DEV = spec["dev"]
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.dist.context import reduce_model
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.work import launch_shapes
    from repro_torch.roofline.op_profile import (kernel_time_by_name,
                                                 traced_kernels)
    from repro_torch.serve import Request, ServeEngine
    t0 = time.time()
    cfg, params, draft = _rank_model(mesh, spec)
    sync()
    load_s = time.time() - t0
    k = spec.get("speculate", 0)
    paged = spec.get("cache_kind", "paged") == "paged"
    eng = ServeEngine(cfg, params, batch_size=4, max_len=SERVE_MAX_LEN,
                      dtype="float32", cache_kind=spec.get("cache_kind",
                                                           "paged"),
                      page_size=64, kv_bits=spec.get("kv_bits", 0),
                      prefix_sharing=False, speculate=k,
                      draft_bits=DRAFT_PLANES, draft_params=draft, mesh=mesh)
    kv, d = eng.kv, mesh.coords[0]
    # a plain engine's decode step, a speculative one's propose + verify
    attr = "_propose_verify" if k else "_decode"
    trace_from = MESH_SPEC_TRACE_FROM if k else MESH_TRACE_FROM
    step, calls, trace, in_block = getattr(eng, attr), [], {}, [True]

    def timed(*args):
        # this rank's rows hold pages of its own block only
        if paged:
            rows = kv.block_tables[eng.lo:eng.lo + eng.rows]
            in_block[0] &= bool(((rows == 0) | (rows // kv.pages_per_shard
                                               == d)).all())
        i = len(calls)
        if i == trace_from and DEV == "cuda":
            trace["prof"] = profile(activities=[ProfilerActivity.CUDA])
            trace["prof"].__enter__()
        sync()
        before = dict(mesh.counts)
        t = time.perf_counter()
        out = step(*args)
        sync()
        calls.append((time.perf_counter() - t,
                      {k: v - before.get(k, 0)
                       for k, v in mesh.counts.items()}))
        if i == trace_from + MESH_TRACE_STEPS - 1 and "prof" in trace:
            trace["prof"].__exit__(None, None, None)
            trace["done"] = True
        return out
    setattr(eng, attr, timed)
    reqs = [Request(prompt=p, max_new_tokens=spec["max_new"])
            for p in spec["prompts"]]
    log = record_logits(eng, reqs)
    # a 4-bit replicated pool: rank 0 records every quantize-on-write's
    # input (on the card, copied after the run) for forced_pool_check
    from repro_torch.models import attention
    quantize, writes = attention.kv_quantize, []
    if spec.get("forced") and mesh.rank == 0:
        def recorded(x, *a, **kw):
            writes.append(x.detach().clone())
            return quantize(x, *a, **kw)
        attention.kv_quantize = recorded
    sync()
    reset_launch_counts()
    mesh.counts.clear()
    try:
        with launch_shapes() as shapes:
            t0 = time.time()
            eng.run(reqs)
            sync()
            wall = time.time() - t0
    finally:
        attention.kv_quantize = quantize
    counts = launch_counts()
    if writes:
        torch.save({"x": [w.cpu() for w in writes],
                    "tokens": [r.out for r in reqs],
                    "logits": {(i, t): row for i, t, row, _ in log},
                    "pool": [{k: v.cpu() for k, v in layer.items()}
                             for layer in eng.cache]}, spec["forced"])
        del writes[:]
    if "prof" in trace and "done" not in trace:
        trace["prof"].__exit__(None, None, None)   # fewer calls: no window
        del trace["prof"]
    token_collectives = {k: v for k, v in mesh.counts.items()
                         if k.endswith("_host")}
    busy = None
    if "prof" in trace:
        kernels = traced_kernels(trace["prof"])
        if kernels:
            busy = sum(kernel_time_by_name(kernels).values()) / 1e3 \
                / MESH_TRACE_STEPS
    untraced = [c for i, c in enumerate(calls)
                if not trace_from <= i < trace_from + MESH_TRACE_STEPS]
    per_step = {}
    for _, n in calls:
        for key, v in n.items():
            per_step[key] = per_step.get(key, 0) + v / len(calls)
    ar_ms = None
    if mesh.shape[1] > 1:
        x = torch.randn((eng.rows, 1, cfg.d_model), device=DEV)
        for _ in range(3):
            reduce_model(x)
        sync()
        t = time.perf_counter()
        for _ in range(ALLREDUCE_ITERS):
            reduce_model(x)
        sync()
        ar_ms = (time.perf_counter() - t) / ALLREDUCE_ITERS * 1e3
    gathers = None
    if eng.fsdp:
        # a layer's weight blocks gathered over the data group alone
        # (every data rank runs these in the same order)
        from repro_torch.dist.fsdp import gather_tree
        layer = eng.params["layers"][0]
        gather_tree(layer, mesh)
        sync()
        t = time.perf_counter()
        for _ in range(ALLREDUCE_ITERS // 4):
            gather_tree(layer, mesh)
        sync()
        gathers = {"layer_gather_ms": (time.perf_counter() - t)
                   / (ALLREDUCE_ITERS // 4) * 1e3,
                   "layer_gather_bytes": _tree_bytes(layer, whole=True),
                   # the embedding and head both ways (the plain mesh)
                   **({} if k else _fsdp_table_designs(eng, mesh))}
    want = torch.load(spec["want"])
    worst, n_rows, gaps = _rank_tokens_check(reqs, log, want)
    drained = all(kv.free_in_shard(s) == kv.usable_in_shard(s)
                  for s in range(kv.n_shards))
    slab = eng.slab
    row = {"rank": mesh.rank, "coords": list(mesh.coords),
           "mesh": mesh.describe(), "backend": mesh.backend,
           "device": str(mesh.device), "load_s": load_s, "wall_s": wall,
           "tokens": [r.out for r in reqs],
           "max_dlogit_rel": worst, "logit_rows_compared": n_rows,
           "first_diff": gaps,
           "decode_calls": len(calls),
           "decode_wall_ms_per_step": (1e3 * sum(c[0] for c in untraced)
                                       / max(len(untraced), 1)),
           "decode_device_busy_ms_per_step": busy,
           "collectives_per_decode_step": per_step,
           "token_collectives_in_run": token_collectives,
           "all_reduce_ms": ar_ms, "all_reduce_shape": [eng.rows, 1,
                                                        cfg.d_model],
           "param_bytes": _tree_bytes(eng.params),
           "cache_kind": spec.get("cache_kind", "paged"),
           "kv_bits": spec.get("kv_bits", 0), "fsdp": eng.fsdp,
           # weights (param_bytes held): gathered whole; the single
           # device's, and the bytes FSDP cuts of them (_fsdp_cut_bytes)
           "replicated_weight_bytes": _tree_bytes(eng.params, whole=True),
           "single_device_weight_bytes": spec.get("single_bytes"),
           "single_device_fsdp_cut_bytes": spec.get("cut_bytes"),
           "fsdp_gathers": gathers,
           "pool_bytes": sum(t.numel() * t.element_size()
                             for layer in eng.cache for t in layer.values()),
           "pages_in_own_block": in_block[0],
           "drained": drained and (slab is None or slab.live_slabs == 0),
           "launches": counts,
           "shapes": {k: sorted(v) for k, v in shapes.items()}}
    if spec.get("forced"):
        row["pool_digest"] = _pool_digest(eng.cache)   # replicas agree
    if k:
        st = eng.stats
        row["speculation"] = {
            "k": k, "draft_bits": DRAFT_PLANES,
            "draft_tokens": st["draft_tokens"],
            "accepted_tokens": st["accepted_tokens"],
            "acceptance": st["accepted_tokens"] / max(st["draft_tokens"], 1),
            "ticks": st["ticks"], "draft": "v4 draft block, cut"}
    return row


def _fsdp_table_designs(eng, mesh) -> dict:
    """An FSDP rank's embedding lookup and head at a decode step's shape,
    timed two ways: as the model runs them (the data ranks' ids and
    activations gathered, each rank applying its block of d_model,
    models/model.py:embed_inputs/unembed), and with the tables gathered
    whole first, as a layer's leaves are (dist/fsdp.py:gather_tree).
    -> their ms a call and the tables' whole bytes."""
    import torch
    from repro_torch.dist.fsdp import gather_tree
    from repro_torch.models.model import embed_inputs, unembed
    cfg = eng.run_cfg
    tables = {k: eng.params[k] for k in ("embed", "lm_head")
              if k in eng.params}
    ids = torch.zeros((eng.rows, 1), dtype=torch.int64, device=DEV)

    def activation_side():
        return unembed(cfg, eng.params, embed_inputs(cfg, eng.params, ids))

    def gathered():
        whole = {**eng.params, **gather_tree(tables, mesh)}
        return unembed(cfg, whole, embed_inputs(cfg, whole, ids))
    out, logits = {"table_bytes": _tree_bytes(tables, whole=True)}, []
    with torch.no_grad():
        for key, fn, iters in (("activation_side_ms", activation_side, 10),
                               ("tables_gathered_ms", gathered, 1)):
            logits.append(fn())                          # warm-up
            sync()
            t = time.perf_counter()
            for _ in range(iters):
                fn()
            sync()
            out[key] = (time.perf_counter() - t) / iters * 1e3
    a, b = logits
    out["designs_max_dlogit_rel"] = float((a - b).abs().max()
                                          / b.abs().max())
    return out


def _expected_shapes(cfg, rows, pps, dense=False):
    """At a rank's shard config: the (K, N) of every quantized linear
    (not expert) it runs at decode (the GEMV: attention, MLA but its
    latent expansion, Mamba's in_proj, dt_w and out_proj, dense MLPs)
    and at prefill (the GEMM: those and the expansion, which runs over
    every context row; a dense cache split along the sequence expands
    its positions through every head's wkv_b), and paged attention's
    {(rows, the KV heads q reads, rep, hd, pages)} (none under MLA or on
    a dense engine)."""
    d = cfg.d_model
    kinds = {s.kind for s in cfg.pattern}
    gemv, attn = set(), set()
    gemm = set()
    M = getattr(cfg, "model_axis", 1)
    if "attn" in kinds and cfg.mla is None:
        hd = cfg.resolved_head_dim
        q, kv_ = cfg.n_heads * hd, cfg.n_kv_heads * hd
        gemv |= {(d, q), (d, kv_), (q, d)}
        # a rank with whole wk/wv reads one KV head of the pool
        heads = 1 if getattr(cfg, "kv_whole", False) else cfg.n_kv_heads
        attn = set() if dense else {(rows, heads, cfg.n_heads // heads, hd,
                                     pps)}
    if "attn" in kinds and cfg.mla is not None:
        m, H = cfg.mla, cfg.n_heads
        gemv |= {(d, m.q_lora_rank),
                 (m.q_lora_rank, H * (m.qk_nope_head_dim
                                      + m.qk_rope_head_dim)),
                 (d, m.kv_lora_rank + m.qk_rope_head_dim),
                 (H * m.v_head_dim, d)}
        gemm = {(m.kv_lora_rank, H * (m.qk_nope_head_dim + m.v_head_dim))}
        if dense and M > 1:
            gemm.add((m.kv_lora_rank,
                      M * H * (m.qk_nope_head_dim + m.v_head_dim)))
    if "mamba" in kinds:
        di = cfg.d_inner
        gemv |= {(d, 2 * di), (cfg.mamba.resolved_dt_rank(d), di), (di, d)}
    if any(s.mlp == "dense" for s in cfg.pattern):
        gemv |= {(d, cfg.d_ff), (cfg.d_ff, d)}
    return gemv, gemv | gemm, attn


def check_mesh_shapes(name, cfg, mesh_shape, row, pps):
    """The rank's launches ran at its shard's shapes: the GEMV (decode)
    and the GEMM (prefill) at the shard config's (K, N) pairs (an FSDP
    rank's gathered leaves are its slice's), paged attention (fp or
    binary-coded pages) at its heads, rows and pool block, the expert
    kernel (MoE) at its E / M experts."""
    from repro_torch.models.model import shard_config
    D, M = mesh_shape
    dense = row["cache_kind"] == "dense"
    rcfg = shard_config(cfg, M, SERVE_MAX_LEN if dense else 0)
    rows = 4 // D
    kn, kn_gemm, want_attn = _expected_shapes(rcfg, rows, pps, dense)
    sh = {k: {tuple(s) for s in v} for k, v in row["shapes"].items()}
    got_gemv = {s[1:] for s in sh.get("bcq_gemv", ())}
    got_gemm = {s[1:] for s in sh.get("bcq_matmul", ())}
    attn = "paged_attention_quant" if row["kv_bits"] else "paged_attention"
    ok = (got_gemv == kn and got_gemm == kn_gemm
          and all(s[0] == rows for s in sh.get("bcq_gemv", ()))
          and sh.get(attn, set()) == want_attn)
    if cfg.moe is not None:
        E = cfg.moe.n_experts // M
        f = cfg.moe.d_ff_expert
        got = {(s[0], s[2], s[3]) for s in sh.get("bcq_expert_matmul", ())}
        ok &= got == {(E, cfg.d_model, f), (E, f, cfg.d_model)}
    require(ok, f"{name} rank {row['rank']}: launch shapes {row['shapes']} "
                f"are not the shard's ({sorted(kn_gemm)}, "
                f"{sorted(want_attn)})")


def mesh_stages(shapes, n):
    """(stage, first rank) of each mesh of `shapes` in a world of `n`
    ranks: the two-rank meshes side by side in n // 2 lanes of two ranks
    (stage 0; the meshes whose ranks each build a whole model on the
    card, `built`, in lane 0 one after another, the others spread over
    the remaining lanes in turn), then each larger mesh alone from rank
    0 (a stage each)."""
    lanes = max(n // 2, 1)
    out, load, stage = [], [0] * lanes, 0
    for shape, built in shapes:
        if shape[0] * shape[1] > 2:
            stage += 1
            out.append((stage, 0))
            continue
        lane = 0 if built or lanes == 1 else \
            min(range(1, lanes), key=lambda i: load[i])
        load[lane] += 1
        out.append((0, 2 * lane))
    return out


def _mesh_ranks(world, plan):
    """Every phase-12 mesh in one spawn: for each (mesh shape, spec,
    stage, first rank) of `plan` every rank makes its sub-mesh (ranks
    first .. first + D x M - 1), in plan order; then stage by stage each
    rank serves the meshes it belongs to (_mesh_rank), in plan order, so
    meshes on disjoint ranks run side by side, and every rank waits at a
    barrier after each stage. -> a row or None for each mesh."""
    import torch
    import torch.distributed as dist
    subs = [world.submesh(*shape, first=first)
            for shape, _, _, first in plan]
    rows = [None] * len(plan)
    for stage in sorted({p[2] for p in plan}):
        for j, (_, spec, st, _) in enumerate(plan):
            if st != stage or subs[j] is None:
                continue
            rows[j] = _mesh_rank(subs[j], spec)
            # the mesh's engine and params go before the next mesh's load
            gc.collect()
            if spec["dev"] == "cuda":
                torch.cuda.empty_cache()
        dist.barrier()
    return rows


def report_mesh(name, cfg, mesh_shape, ranks, single_ms, forced=None):
    """Hold one mesh's ranks to the single device and to the shard's
    shapes (the whole run's logits; for a 4-bit replicated pool those of
    the single device forced onto the rank's writes, `forced`, the worst
    row forced_pool_check read, and every replica the same pool); emit
    its `mesh_path` line; returns the kernel launches summed over its
    ranks."""
    D, M = mesh_shape
    print(f"{name}: {ranks[0]['mesh']}", flush=True)
    pps = -(-(4 * -(-SERVE_MAX_LEN // 64) + D) // D)
    gaps = {}
    for r in ranks:
        require(r["tokens"] == ranks[0]["tokens"],
                f"{name}: ranks 0 and {r['rank']} hold other tokens")
        require(r.get("speculation") == ranks[0].get("speculation"),
                f"{name}: ranks 0 and {r['rank']} accepted otherwise")
        gaps.update(r["first_diff"])
        check_mesh_shapes(name, cfg, mesh_shape, r, pps)
    counts = {}
    for r in ranks:
        for k, v in r["launches"].items():
            counts[k] = counts.get(k, 0) + v
    worst = max(r["max_dlogit_rel"] for r in ranks)
    row = {"check": "mesh_path", "path": name, "model": cfg.name,
           "layers": cfg.n_layers, "mesh": {"data": D, "model": M},
           "backend": ranks[0]["backend"], "card": CARD,
           "tokens_equal": not gaps,
           "first_diff": {str(i): {"token": t, "single_top2_gap_rel": g}
                          for i, (t, g) in gaps.items()},
           "gap_limit": 2 * TOL_LOGITS, "max_dlogit_rel": worst,
           # what the logits gate holds: the single device's rows, or
           # (a 4-bit replicated pool) the forced single device's
           "logits_gate": ("single_device" if forced is None
                           else "single_device_on_the_rank_writes"),
           "max_dlogit_rel_gated": worst if forced is None else forced,
           "tol": TOL_LOGITS, "single_device_decode_ms_per_tick": single_ms,
           "speculation": ranks[0].get("speculation"),
           "ranks": [{k: v for k, v in r.items()
                      if k not in ("tokens", "shapes", "first_diff",
                                   "speculation")}
                     for r in ranks]}
    emit(row)
    require(all(g <= 2 * TOL_LOGITS for _, g in gaps.values()),
            f"{name}: tokens differ from the single device's beyond a "
            f"near-tie: {gaps}")
    gated = worst if forced is None else forced
    require(gated <= TOL_LOGITS,
            f"{name}: logits off by {gated:.3g} of max|logit|")
    require(len({r.get("pool_digest") for r in ranks}) == 1,
            f"{name}: the replicas of the pool differ")
    require(all(r["logit_rows_compared"] > 0 for r in ranks),
            f"{name}: a rank compared no logits row")
    require(all(r["drained"] and r["pages_in_own_block"] for r in ranks),
            f"{name}: a shard (or its state slabs) did not drain or a "
            f"rank's pages left its block")
    for r in ranks:
        if r["fsdp"]:
            # a rank holds 1/D of the single device's bytes the data
            # axis cuts (counted on the unsharded tree: every matrix's
            # codes, a contract leaf's scales, embedding and head), the
            # rest whole (norms, expand leaves' scales); its blocks
            # gathered are the single device's
            held, one, cut = (r["param_bytes"],
                              r["single_device_weight_bytes"],
                              r["single_device_fsdp_cut_bytes"])
            require(held * D == one * D - cut * (D - 1)
                    and cut >= FSDP_MIN_CUT_SHARE * one
                    and r["replicated_weight_bytes"] == one,
                    f"{name} rank {r['rank']}: holds {held} weight bytes, "
                    f"not the single device's {one} less {D - 1}/{D} of "
                    f"the {cut} the data axis cuts (gathered: "
                    f"{r['replicated_weight_bytes']})")
    need = ["bcq_gemv", "bcq_matmul"]
    if (cfg.mla is None and any(s.kind == "attn" for s in cfg.pattern)
            and ranks[0]["cache_kind"] == "paged"):
        need.append("paged_attention_quant" if ranks[0]["kv_bits"]
                    else "paged_attention")
    if cfg.moe is not None:
        need.append("bcq_expert_matmul")
    for r in ranks:
        require(all(r["launches"][k] > 0 for k in need)
                and r["launches"]["bcq_plain"] == 0,
                f"{name} rank {r['rank']}: launches {r['launches']}")
    return counts


def _free() -> None:
    gc.collect()
    if DEV == "cuda":
        import torch
        torch.cuda.empty_cache()


def phase_mesh(seed: int, model, want_outs=None, max_new: int = 32,
               moe_arch: str = "qwen3-moe-235b-a22b",
               moe_layers: int = MESH_MOE_LAYERS, zoo=None,
               layers: int = MESH_CUT_LAYERS, rep=None, dense=None):
    """Phase 12 on `model` (phase 3's): saved as an artifact with a w2
    draft block, and so is its first `layers` layers; the path's
    requests served on MESHES, every rank loading its slice with
    load_packed(mesh=) (the whole model on the data axis, the cut one on
    a model axis), speculatively on SPEC_MESHES (k=SPEC_K, the draft
    block cut by load_draft_scales(mesh=)), and the cut one on FSDP_MESH
    loaded with fsdp=True, plainly and speculatively; then Qwen3-MoE
    cut to `moe_layers` on MOE_MESH and each config of `zoo` (default
    MESH_ZOO at full width) on ZOO_MESH, each rank building the seeded
    model and cutting it; `rep` ((config, mesh shape), default
    Qwen3-MoE at REP_LAYERS on REP_MESH) built and cut by each rank in
    turn, served with fp and with 4-bit pages; each config of `dense`
    (default DENSE_ZOO) through the dense engine on ZOO_MESH. Each
    against a single-device engine in this process, the speculative
    meshes against its plain tokens. One spawn of the largest mesh's
    ranks serves every mesh in turn. Returns the launches summed over
    every rank."""
    import tempfile
    from repro_torch.ckpt.packed import save_packed
    from repro_torch.configs import get_config
    from repro_torch.dist.context import spawn
    from repro_torch.launch.mesh import make_serve_mesh
    cfg, params = model
    if zoo is None:
        zoo = [get_config(a).replace(dtype="float32", n_layers=n)
               for a, n in MESH_ZOO]
    if rep is None:
        rep = (get_config(moe_arch).replace(dtype="float32",
                                            n_layers=REP_LAYERS), REP_MESH)
    if dense is None:
        dense = [get_config(a).replace(dtype="float32", n_layers=n)
                 for a, n in DENSE_ZOO]
    total = {}
    with tempfile.TemporaryDirectory(prefix="mesh_path_") as tmp:
        tmp = Path(tmp)
        t0 = time.time()
        meta = {"arch": cfg.name, "n_layers": cfg.n_layers}
        art = save_packed(tmp / cfg.name, params, cfg=cfg, meta=meta,
                          draft_bits=DRAFT_PLANES)
        save_s = time.time() - t0
        prompts = path_prompts(seed, cfg.vocab_size)
        # the whole model on one device: phase 3's tokens
        want, single_ms = serve_recorded(cfg, params, prompts,
                                         tmp / "single.pt", max_new)
        emit({"check": "mesh_path_single_device", "model": cfg.name,
              "save_packed_s": save_s, "decode_ms_per_tick": single_ms,
              "card": CARD,
              "tokens_equal_phase_3": (None if want_outs is None
                                       else want == want_outs)})
        require(want_outs is None or want == want_outs,
                "mesh path: the single-device engine's tokens are not "
                "phase 3's")
        dev = {"dev": DEV, "max_new": max_new, "seed": seed}
        # its first `layers` layers: the model-axis and FSDP meshes'
        cut = cfg.replace(n_layers=min(layers, cfg.n_layers))
        cut_params = {**params, "layers": params["layers"][:cut.n_layers]}
        t0 = time.time()
        cut_art = save_packed(tmp / f"{cfg.name}-{cut.n_layers}", cut_params,
                              cfg=cut, meta={**meta,
                                             "n_layers": cut.n_layers},
                              draft_bits=DRAFT_PLANES)
        save_s = time.time() - t0
        fsdp_new = min(FSDP_MAX_NEW, max_new)
        spec_new = min(FSDP_SPEC_MAX_NEW, max_new)
        cut_ms = {}
        for n in sorted({max_new, fsdp_new, spec_new}):
            _, cut_ms[n] = serve_recorded(cut, cut_params, prompts,
                                          tmp / f"cut{n}.pt", n)
        emit({"check": "mesh_path_single_device", "model": cfg.name,
              "layers": cut.n_layers, "save_packed_s": save_s,
              "decode_ms_per_tick": cut_ms[max_new], "card": CARD})
        whole = {"artifact": str(art), "arch": cfg.name, "prompts": prompts,
                 "want": str(tmp / "single.pt"), **dev}
        llama = {**whole, "artifact": str(cut_art),
                 "want": str(tmp / f"cut{max_new}.pt")}
        def on(shape):
            """(config, single-device ms, spec) of phase 3's model on
            `shape`: whole on the data axis, cut on a model axis."""
            return ((cfg, single_ms, whole) if shape[1] == 1
                    else (cut, cut_ms[max_new], llama))
        plan = [(shape, "llama", *on(shape)) for shape in MESHES]
        for shape in SPEC_MESHES:
            c, ms, sp = on(shape)
            plan.append((shape, "llama_spec", c, ms,
                         {**sp, "speculate": SPEC_K}))
        fsdp = {**llama, "fsdp": True,
                "single_bytes": _tree_bytes(cut_params),
                "cut_bytes": _fsdp_cut_bytes(cut_params)}
        # the speculative one first: it shares a lane with the plain
        # whole-model (2, 1), the plain one with its speculation
        plan += [(FSDP_MESH, "llama_fsdp_spec", cut, cut_ms[spec_new],
                  {**fsdp, "speculate": SPEC_K, "max_new": spec_new,
                   "want": str(tmp / f"cut{spec_new}.pt")}),
                 (FSDP_MESH, "llama_fsdp", cut, cut_ms[fsdp_new],
                  {**fsdp, "max_new": fsdp_new,
                   "want": str(tmp / f"cut{fsdp_new}.pt")})]
        del cut_params
        moe_cfg, moe_params = synthetic_moe(seed, moe_arch, moe_layers)
        moe_prompts = path_prompts(seed, moe_cfg.vocab_size)
        _, moe_ms = serve_recorded(moe_cfg, moe_params, moe_prompts,
                                   tmp / "moe.pt", max_new)
        del moe_params
        _free()
        plan.append((MOE_MESH, "moe", moe_cfg, moe_ms,
                     {"artifact": None, "arch": moe_arch,
                      "n_layers": moe_layers, "prompts": moe_prompts,
                      "want": str(tmp / "moe.pt"), **dev}))
        for zcfg in zoo:
            t0 = time.time()
            zparams = synthetic_zoo(seed, zcfg)
            zprompts = path_prompts(seed, zcfg.vocab_size)
            want_z = tmp / f"{zcfg.name}.pt"
            _, z_ms = serve_recorded(zcfg, zparams, zprompts, want_z,
                                     max_new)
            del zparams
            _free()
            emit({"check": "mesh_path_single_device", "model": zcfg.name,
                  "layers": zcfg.n_layers, "build_and_serve_s":
                  time.time() - t0, "decode_ms_per_tick": z_ms,
                  "card": CARD})
            plan.append((ZOO_MESH, zcfg.name.split("-")[0], zcfg, z_ms,
                         {"artifact": None, "cfg": zcfg,
                          "prompts": zprompts, "want": str(want_z), **dev}))
        # replicated pools: the ranks build the model and cut it in turn
        # (all at once they would hold it D x M times, ~55 GB)
        rcfg, rep_shape = rep
        t0 = time.time()
        rparams = synthetic_zoo(seed, rcfg)
        rprompts = path_prompts(seed, rcfg.vocab_size)
        rep_ms = {}
        for kv_bits in (0, 4):
            _, rep_ms[kv_bits] = serve_recorded(
                rcfg, rparams, rprompts, tmp / f"rep{kv_bits}.pt", max_new,
                kv_bits=kv_bits, keep_codes=bool(kv_bits))
        del rparams
        _free()
        emit({"check": "mesh_path_single_device", "model": rcfg.name,
              "layers": rcfg.n_layers, "build_and_serve_s":
              time.time() - t0, "decode_ms_per_tick": rep_ms[0],
              "decode_ms_per_tick_kv4": rep_ms[4], "card": CARD})
        for kv_bits in (0, 4):
            plan.append((rep_shape, "moe_rep" + ("_kv4" if kv_bits else ""),
                         rcfg, rep_ms[kv_bits],
                         {"artifact": None, "in_turn": True, "cfg": rcfg,
                          "kv_bits": kv_bits, "prompts": rprompts,
                          "forced": (str(tmp / "rep4_rank0.pt")
                                     if kv_bits else None),
                          "want": str(tmp / f"rep{kv_bits}.pt"), **dev}))
        for dcfg in dense:
            dparams = synthetic_zoo(seed, dcfg)
            dprompts = path_prompts(seed, dcfg.vocab_size)
            want_d = tmp / f"{dcfg.name}_dense.pt"
            _, d_ms = serve_recorded(dcfg, dparams, dprompts, want_d,
                                     max_new, cache_kind="dense")
            del dparams
            _free()
            plan.append((ZOO_MESH, dcfg.name.split("-")[0] + "_dense", dcfg,
                         d_ms, {"artifact": None, "cfg": dcfg,
                                "cache_kind": "dense", "prompts": dprompts,
                                "want": str(want_d), **dev}))
        n = max(D * M for (D, M), *_ in plan)
        world = make_serve_mesh(2, n // 2, [f"{DEV}:0" if DEV == "cuda"
                                            else DEV] * n)
        # two-rank meshes side by side, the larger ones alone
        stages = mesh_stages([(shape, spec["artifact"] is None
                               and not spec.get("in_turn"))
                              for shape, *_, spec in plan], n)
        print(f"mesh path: one spawn of {world.describe()}", flush=True)
        t0 = time.time()
        # one torch thread a rank on the CPU (rehearsals): ranks share cores
        rows = spawn(_mesh_ranks, world,
                     ([(shape, spec, *st) for (shape, *_, spec), st
                       in zip(plan, stages)],),
                     threads=1 if DEV == "cpu" else None,
                     timeout_s=MESH_TIMEOUT_S)
        emit({"check": "mesh_path_spawn", "ranks": n, "card": CARD,
              "seconds": time.time() - t0,
              "stages": [[f"{tag}_{D}x{M}@{first}"
                          for ((D, M), tag, *_), (st, first)
                          in zip(plan, stages) if st == s]
                         for s in sorted({st for st, _ in stages})]})
        for j, ((D, M), tag, c, single, spec) in enumerate(plan):
            ranks = [r[j] for r in rows if r[j] is not None]
            forced = (forced_pool_check(f"{tag}_{D}x{M}", c, spec)
                      if spec.get("forced") else None)
            counts = report_mesh(f"{tag}_{D}x{M}", c, (D, M), ranks, single,
                                 forced=forced)
            for k, v in counts.items():
                total[k] = total.get(k, 0) + v
    return total


# ---------------------------------------------------------------------------
# phase 9: the model zoo at full width
# ---------------------------------------------------------------------------

# (arch, layers served or None for full depth, also through the dense
# engine): minicpm3-4b, falcon-mamba-7b and gemma2-27b at about half
# their depth (62, 64, 46 until phase 13 needed the room; 24 keeps
# gemma2's alternating window pairs whole), for time;
# jamba-1.5-large's 72 layers hold ~149 GB of w3 codes, more than the
# card's 80 GB; one super-block of 8 holds ~16.5 GB
ZOO_MODELS = (("minicpm3-4b", 32, True), ("falcon-mamba-7b", 32, True),
              ("gemma2-27b", 24, False), ("jamba-1.5-large-398b", 8, False))


def _mla_weights(cfg, gen):
    """MLA projections as seeded w3 packs; the latent norms zero."""
    import torch
    m, d, H = cfg.mla, cfg.d_model, cfg.n_heads
    return {"wq_a": _w3(gen, d, m.q_lora_rank),
            "q_a_norm": torch.zeros(m.q_lora_rank, device=DEV),
            "wq_b": _w3(gen, m.q_lora_rank,
                        H * (m.qk_nope_head_dim + m.qk_rope_head_dim)),
            "wkv_a": _w3(gen, d, m.kv_lora_rank + m.qk_rope_head_dim),
            "kv_a_norm": torch.zeros(m.kv_lora_rank, device=DEV),
            "wkv_b": _w3(gen, m.kv_lora_rank,
                         H * (m.qk_nope_head_dim + m.v_head_dim)),
            "wo": _w3(gen, H * m.v_head_dim, d)}


def _mamba_weights(cfg, gen):
    """A Mamba mixer: in_proj, dt_w and out_proj as seeded w3 packs
    (dt_w is packed, as the reference packs it); x_proj fp32 N(0, 1/di)
    (the config's exclude); conv, dt bias, A_log and D as init_mamba
    draws them."""
    import math
    import torch
    mc, d, di = cfg.mamba, cfg.d_model, cfg.d_inner
    dtr = mc.resolved_dt_rank(d)
    u = torch.rand(di, generator=gen, device=DEV)
    dt0 = torch.exp(math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3)))
    return {"in_proj": _w3(gen, d, 2 * di),
            "conv_w": torch.randn((mc.d_conv, di), generator=gen,
                                  device=DEV) * mc.d_conv ** -0.5,
            "conv_b": torch.zeros(di, device=DEV),
            "x_proj": torch.randn((di, dtr + 2 * mc.d_state), generator=gen,
                                  device=DEV) * di ** -0.5,
            "dt_w": _w3(gen, dtr, di),
            "dt_b": torch.log(torch.expm1(dt0)),
            "A_log": torch.log(torch.arange(1, mc.d_state + 1,
                                            dtype=torch.float32,
                                            device=DEV)).repeat(di, 1),
            "D": torch.ones(di, device=DEV),
            "out_proj": _w3(gen, di, d)}


def synthetic_zoo(seed: int, cfg):
    """Any decoder of the zoo at `cfg`'s widths and depth: seeded w3
    per-channel packs for every linear the reference quantizes (GQA or
    MLA attention, Mamba mixers, dense MLPs and expert stacks), an fp32
    router N(0, 1/d), zero norms (sandwich norms included) and fp32
    embeddings and head from the port's init_params."""
    import torch
    from repro_torch.models import init_params
    params = init_params(cfg.replace(n_layers=0), seed=seed,
                         dtype="float32", device=DEV)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(seed + 3)
    d = cfg.d_model
    zeros = lambda: torch.zeros(d, device=DEV)
    layers = []
    for spec in cfg.layer_specs():
        lp = {"ln": zeros()}
        if spec.kind != "attn":
            lp["mamba"] = _mamba_weights(cfg, gen)
        elif cfg.mla is not None:
            lp["attn"] = _mla_weights(cfg, gen)
        else:
            lp["attn"] = _attn_weights(cfg, gen)
        if cfg.post_block_norms:
            lp["post_ln"] = zeros()
        if spec.mlp != "none":
            lp["ln2"] = zeros()
            if spec.mlp == "moe":
                f, E = cfg.moe.d_ff_expert, cfg.moe.n_experts
                lp["moe"] = {"router": torch.randn((d, E), generator=gen,
                                                   device=DEV) * d ** -0.5,
                             "wg": _w3(gen, d, f, E), "wu": _w3(gen, d, f, E),
                             "wd": _w3(gen, f, d, E)}
            else:
                lp["mlp"] = {"wg": _w3(gen, d, cfg.d_ff),
                             "wu": _w3(gen, d, cfg.d_ff),
                             "wd": _w3(gen, cfg.d_ff, d)}
            if cfg.post_block_norms:
                lp["post_ln2"] = zeros()
        layers.append(lp)
    params["layers"] = layers
    return params


def _zoo_code_bytes(params) -> int:
    def walk(node):
        if isinstance(node, dict):
            return sum(walk(v) for v in node.values())
        return node.codes.numel() * 4 if hasattr(node, "codes") else 0
    return sum(walk(lp) for lp in params["layers"])


def _fp_bytes(params) -> int:
    """Bytes of the fp tensors of the tree (embeddings, head, norms,
    routers, excluded projections)."""
    import torch

    def walk(node):
        if isinstance(node, dict):
            return sum(walk(v) for v in node.values())
        if isinstance(node, list):
            return sum(walk(v) for v in node)
        return (node.numel() * node.element_size()
                if torch.is_tensor(node) else 0)
    return walk(params)


def zoo_dense_tokens(name, cfg, params, prompts, want, max_new):
    """The dense engine on the paged run's prompts: its greedy tokens
    must equal the paged engine's (`want`) up to a printed near-tie."""
    import torch
    from repro_torch.serve import Request, ServeEngine
    eng = ServeEngine(cfg, params, batch_size=4, max_len=SERVE_MAX_LEN,
                      dtype="float32", cache_kind="dense", device=DEV)
    reqs = [Request(prompt=p, max_new_tokens=max_new) for p in prompts]
    t0 = time.time()
    eng.run(reqs)
    sync()
    wall = time.time() - t0
    rows = []
    for i, (r, w) in enumerate(zip(reqs, want)):
        div = first_divergence(cfg, params, prompts[i], w, r.out)
        rows.append({"request": i, "equal_to_paged": div is None,
                     **({} if div is None else
                        {"first_diff": div[0], "paged_top2_gap_rel": div[1],
                         "gap_limit": 2 * TOL_LOGITS})})
        require(div is None or div[1] <= 2 * TOL_LOGITS,
                f"{name}: dense request {i} differs from paged at token "
                f"{div and div[0]} with a gap of {div and div[1]}")
    emit({"check": "zoo_path_dense_vs_paged", "model": cfg.name,
          "wall_s": wall, "decode_s": eng.stats["decode_s"],
          "decode_ticks": eng.stats["ticks"], "requests": rows})
    del eng
    if DEV == "cuda":
        torch.cuda.empty_cache()


def zoo_plain_paths(cfg, params, iters: int = 10) -> dict:
    """Device times of the plain-PyTorch hot paths the zoo adds (no TPU
    kernel: the reference writes them in jnp): MLA's latent expansion
    through wkv_b over a batch-4 decode's 192-token views (the BCQ GEMM
    at M=768) and its whole attention step; the selective scan of one
    Mamba layer at the longest prompt (100 tokens) and the whole layer.
    Layer 0's (or the first Mamba layer's) weights; a `zoo_plain_paths`
    line."""
    import torch
    from repro_torch.models import mamba as mam
    from repro_torch.models import mla as mla_mod
    row = {"check": "zoo_plain_paths", "model": cfg.name}
    gen = torch.Generator(device=DEV)
    gen.manual_seed(7)
    if cfg.mla is not None:
        m, p = cfg.mla, params["layers"][0]["attn"]
        B, S, H = 4, 192, cfg.n_heads
        c_kv = torch.randn((B, S, m.kv_lora_rank), generator=gen, device=DEV)
        k_pe = torch.randn((B, S, m.qk_rope_head_dim), generator=gen,
                           device=DEV)
        q_nope = torch.randn((B, 1, H, m.qk_nope_head_dim), generator=gen,
                             device=DEV)
        q_pe = torch.randn((B, 1, H, m.qk_rope_head_dim), generator=gen,
                           device=DEV)
        ok = torch.ones((B, 1, 1, S), dtype=torch.bool, device=DEV)
        t = kernel_ms(lambda: mla_mod._expand_kv(cfg, p, c_kv), iters)
        a = kernel_ms(lambda: mla_mod._mla_attend(cfg, p, q_nope, q_pe, c_kv,
                                                  k_pe, ok), iters)
        row.update({"mla_expand_ms": best_ms(t),
                    "mla_expand_shape": f"M={B * S} K={m.kv_lora_rank} "
                                        f"N={H * (m.qk_nope_head_dim + m.v_head_dim)}",
                    "mla_attend_step_ms": best_ms(a),
                    "mla_expand_ms_per_decode_step": best_ms(t)
                    * sum(s.kind == "attn" for s in cfg.layer_specs())})
    js = [j for j, s in enumerate(cfg.layer_specs()) if s.kind == "mamba"]
    if js:
        mc, p = cfg.mamba, params["layers"][js[0]]["mamba"]
        L, di, ds = 100, cfg.d_inner, cfg.mamba.d_state
        ops = (torch.randn((1, L, di), generator=gen, device=DEV),
               torch.rand((1, L, di), generator=gen, device=DEV) * 0.1,
               -torch.exp(p["A_log"]),
               torch.randn((1, L, ds), generator=gen, device=DEV),
               torch.randn((1, L, ds), generator=gen, device=DEV),
               torch.zeros((1, di, ds), device=DEV))
        t = kernel_ms(lambda: mam.selective_scan(*ops, mc.chunk), iters)
        x = torch.randn((1, L, cfg.d_model), generator=gen, device=DEV)
        f = kernel_ms(lambda: mam.mamba_forward(cfg, p, x, return_state=True),
                      iters)
        row.update({"selective_scan_ms": best_ms(t),
                    "selective_scan_shape": f"L={L} d_inner={di} "
                                            f"d_state={ds}",
                    "mamba_layer_prefill_ms": best_ms(f),
                    "selective_scan_ms_per_prefill": best_ms(t) * len(js)})
    emit(row)
    return row


def phase_zoo(seed: int, models=None, max_new: int = 32):
    """Phase 9: each model of `models` ((cfg, full depth, dense too), by
    default ZOO_MODELS from the registry at full width) built by
    synthetic_zoo and served through the paged engine (serve_path: 4
    requests, batch 4, 64-token pages, every launch count set to 0 just
    before and read just after), with a `zoo_path` line and a
    `decode_profile` line; the dense engine's tokens against the paged
    engine's where asked. Each model is freed before the next. Returns
    (summed launch counts, rows)."""
    import torch
    from repro_torch.configs import get_config
    if models is None:
        models = []
        for arch, n_layers, dense in ZOO_MODELS:
            full = get_config(arch)
            models.append((full.replace(dtype="float32",
                                        n_layers=n_layers or full.n_layers),
                           full.n_layers, dense))
    total, rows = {}, {}
    for cfg, full_depth, dense in models:
        t0 = time.time()
        params = synthetic_zoo(seed, cfg)
        sync()
        build_s = time.time() - t0
        counts, row, prompts, outs, eng = serve_path("zoo_path", cfg,
                                                     params, seed,
                                                     max_new=max_new)
        specs = cfg.layer_specs()
        n_attn = sum(s.kind == "attn" for s in specs)
        n_moe = sum(s.mlp == "moe" for s in specs)
        slab = eng.slab
        row.update({
            "weights_build_s": build_s,
            "depth": (f"{cfg.n_layers} of {full_depth} layers"
                      + ("" if cfg.n_layers == full_depth else
                         " (cut: the full depth's w3 codes exceed the "
                         "card's memory)")),
            "mixers": {"attention": n_attn - (n_attn if cfg.mla else 0),
                       "mla": n_attn if cfg.mla else 0,
                       "mamba": len(specs) - n_attn},
            "moe_layers": n_moe, "post_block_norms": cfg.post_block_norms,
            "packed_code_bytes": _zoo_code_bytes(params),
            "fp_bytes": _fp_bytes(params),
            "pages_allocated": eng.kv.pages_allocated,
            "kv_high_water_pages": eng.kv.high_water,
            "latent_pages": cfg.mla is not None,
            "slabs_allocated": slab.slabs_allocated if slab else 0,
            "slab_high_water": slab.high_water if slab else 0,
            "slab_bytes_per_slab": slab.bytes_per_slab() if slab else 0,
            "engines": "paged and dense" if dense else "paged only"})
        emit(row)
        rows[cfg.name] = row
        require(slab is None or (slab.live_slabs == 0 and slab.free_slab_count
                                 == slab.usable_slabs
                                 and slab.slabs_allocated >= 4),
                f"zoo {cfg.name}: state slabs did not drain")
        require((slab is not None) == (n_attn < len(specs)),
                f"zoo {cfg.name}: a slab pool without Mamba layers or none "
                f"with them")
        require(counts["bcq_gemv"] > 0 and counts["bcq_matmul"] > 0,
                f"zoo {cfg.name}: launches {counts}")
        ticks, prefills = row["decode_ticks"], row["prefills"]
        attn_kernel = 0 if cfg.mla is not None else n_attn * ticks
        require(counts["paged_attention"] == attn_kernel
                and counts["paged_attention_quant"] == 0,
                f"zoo {cfg.name}: paged attention launched "
                f"{counts['paged_attention']} times, expected {attn_kernel}")
        require(counts["bcq_expert_matmul"] == 3 * n_moe * (ticks + prefills),
                f"zoo {cfg.name}: expert launches {counts}")
        del eng
        if dense:
            zoo_dense_tokens(cfg.name, cfg, params, prompts, outs, max_new)
        profile_decode(cfg, params, prompts, tag=cfg.name)
        if cfg.mla is not None or cfg.mamba is not None:
            zoo_plain_paths(cfg, params)
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        del params
        gc.collect()
        if DEV == "cuda":
            torch.cuda.empty_cache()
    return total, rows


# ---------------------------------------------------------------------------
# phase 10: training and perplexity at full width
# ---------------------------------------------------------------------------

# (a) llama2-7b at full width cut to TRAIN_LAYERS of 32 layers (for the
# checkpoint's bytes and time: 1 layer and the embedding and head hold
# 5.6 GB of params and AdamW moments; 2 until phase 13's other families
# needed the room), fp32, remat "full"
TRAIN_LAYERS = 1
TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO = 4, 512, 2
TRAIN_STEPS, TRAIN_WARMUP, TRAIN_SPLIT = 4, 2, 2
TOL_RESUME = 1e-5      # run B vs run A, of max|p| (atomics in the backward)
TOL_PPL = 1e-5         # packed vs dequantized perplexity, relative
EVAL_BATCH, EVAL_SEQ, EVAL_BATCHES = 4, 512, 4
# (c) the tiny LMs' table: benchmarks/common.py's eval windows
TABLE_BATCH, TABLE_SEQ, TABLE_BATCHES = 8, 192, 6
TABLE_STEPS = 300
# (d) hubert-xlarge at full width: one loss and its gradients
ENCODER_BATCH, ENCODER_FRAMES = 2, 256


def _timed(obj, name, log):
    """Wrap obj.name so each call appends its seconds (synchronised) to
    `log`."""
    inner = getattr(obj, name)

    def wrapped(*a, **kw):
        sync()
        t0 = time.time()
        out = inner(*a, **kw)
        sync()
        log.append(time.time() - t0)
        return out
    setattr(obj, name, wrapped)


def _tree_numel(tree) -> int:
    from repro_torch.tree import leaves
    return sum(a.numel() for a in leaves(tree))


def train_dryrun_check(cfg, trainer, batch, seq):
    """The dry run (launch/dryrun.py) of the Trainer's step on the meta
    device, at its config, batch, microbatches and optimizer: parameter
    and AdamW state element counts equal the Trainer's tensors'; the
    model FLOPs (roofline/analysis.py) the model-FLOP share divides by,
    beside the traced step's FLOPs; the step's peak of live storages.
    The row is emitted by train_path with the measured peak beside it."""
    from repro_torch.configs import ShapeSpec
    from repro_torch.launch import dryrun
    from repro_torch.roofline.analysis import model_flops
    shape = ShapeSpec("train_path", seq, batch, "train")
    step, args, _ = dryrun.lower_cell(
        cfg, shape, microbatches=trainer.tcfg.microbatches,
        dtype=cfg.dtype, opt_cfg=trainer.tcfg.opt)
    params, opt, _ = args
    traced = dryrun.trace_cell(step, args)
    row = {"check": "dryrun_check", "path": "train_path", "model": cfg.name,
           "layers": cfg.n_layers, "batch": batch, "seq": seq,
           "params_elements": _tree_numel(params),
           "trainer_params_elements": _tree_numel(trainer.params),
           "adamw_elements": _tree_numel(opt),
           "trainer_adamw_elements": _tree_numel(trainer.opt_state),
           "model_flops": model_flops(cfg, shape),
           "dryrun_flops": traced["cost"]["flops"],
           "dryrun_bytes": traced["cost"]["bytes"],
           "peak_live_bytes_est": traced["memory"]["peak_live_bytes_est"]}
    require(row["params_elements"] == row["trainer_params_elements"]
            and row["adamw_elements"] == row["trainer_adamw_elements"],
            f"dry run: element counts differ from the Trainer's: {row}")
    return row


def train_path(seed, arch, n_layers, batch, seq, steps=TRAIN_STEPS,
               split=TRAIN_SPLIT):
    """(a) Run A trains `steps` steps; run B trains `split` steps, saves,
    and a new Trainer resumes it to `steps`. Returns (A's params in the
    stacked layout, cfg, row)."""
    import shutil
    import tempfile
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import batches, token_stream
    from repro_torch.roofline.analysis import FP32_FLOPS
    from repro_torch.train import AdamWConfig, Trainer, TrainerConfig
    cfg = get_config(arch).replace(dtype="float32", n_layers=n_layers,
                                   remat="full")
    toks = token_stream("wiki")
    opt = AdamWConfig(lr=1e-3, master_fp32=False)
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_"))
    du = shutil.disk_usage(root)
    emit({"check": "train_path_disk", "dir": str(root),
          "total_gb": du.total / 1e9, "free_gb": du.free / 1e9})
    saves, restores = [], []

    def trainer(name, n_steps, data, write=True):
        """A Trainer checkpointing into root/name; with write=False its
        end-of-run save is skipped (no run reads it: 12-20 s of I/O at
        llama2-7b's 2-4 layers)."""
        tr = Trainer(cfg, TrainerConfig(
            steps=n_steps, ckpt_every=10 ** 9, ckpt_dir=str(root / name),
            keep_n=1, log_every=10 ** 9, microbatches=TRAIN_MICRO,
            warmup=TRAIN_WARMUP, seed=seed, opt=opt), data,
            dtype="float32", device=DEV)
        if write:
            _timed(tr.ckpt, "save", saves)
        else:
            tr.ckpt.save = lambda *a, **kw: None
        _timed(tr.ckpt, "restore", restores)
        return tr
    try:
        if DEV == "cuda":
            torch.cuda.reset_peak_memory_stats()
        a = trainer("a", steps, batches(toks, batch, seq, seed=0),
                    write=False)
        n_params = _tree_numel(a.params)
        dry = train_dryrun_check(cfg, a, batch, seq)
        a.run()
        peak = (torch.cuda.max_memory_allocated() / 1e9 if DEV == "cuda"
                else None)
        p_a, log_a = a.params, a.metrics_log
        del a
        b1 = trainer("b", split, batches(toks, batch, seq, seed=0))
        b1.run()
        del b1
        ckpt_bytes = sum(f.stat().st_size for f in
                         (root / "b").rglob("*") if f.is_file())
        it = batches(toks, batch, seq, seed=0)
        for _ in range(split):          # replay the stream, as a restart
            next(it)
        b2 = trainer("b", steps, it, write=False)
        out = b2.run()
        from repro_torch.tree import leaves_with_paths
        worst, scale = 0.0, 0.0
        pb = dict(leaves_with_paths(b2.params))
        for path, x in leaves_with_paths(p_a):
            worst = max(worst, float((x - pb[path]).abs().max()))
            scale = max(scale, float(x.abs().max()))
        log_b = b2.metrics_log
        del b2, pb
    finally:
        shutil.rmtree(root, ignore_errors=True)
    tokens = batch * seq
    step_rows = [{"step": m["step"], "loss": m["loss"], "ms": 1e3 * m["sec"],
                  "tokens_per_s": tokens / m["sec"],
                  "model_flop_share_fp32_peak":
                      dry["model_flops"] / m["sec"] / FP32_FLOPS}
                 for m in log_a]
    dry.update({"peak_mem_gb_measured": peak,
                "peak_live_gb_est": dry["peak_live_bytes_est"] / 1e9})
    emit(dry)
    row = {"check": "train_path", "model": cfg.name,
           "depth": f"{n_layers} of {get_config(arch).n_layers} layers "
                    f"(cut for checkpoint bytes and time)",
           "params": n_params, "batch": batch, "seq": seq,
           "microbatches": TRAIN_MICRO, "remat": cfg.remat,
           "optimizer": "AdamW lr 1e-3, fp32 params, no master copy",
           "steps": step_rows, "peak_mem_gb": peak,
           "checkpoint_bytes": ckpt_bytes, "save_s": saves,
           "restore_s": restores, "resumed": out["resumed"],
           "losses_b": [m["loss"] for m in log_b],
           "resume_max_abs_diff": worst, "max_abs_param": scale,
           "resume_tol": TOL_RESUME * scale}
    emit(row)
    losses = [m["loss"] for m in log_a] + row["losses_b"]
    require(all(math.isfinite(v) for v in losses),
            f"train path: a loss is not finite: {losses}")
    require(out["resumed"] and len(log_b) == steps - split,
            "train path: run B did not resume from its checkpoint")
    require(worst <= TOL_RESUME * scale,
            f"train path: run B lies {worst:.3g} from run A (tolerance "
            f"{TOL_RESUME * scale:.3g})")
    return p_a, cfg, row


def _packed_ppl(name, cfg, params, windows, n_batches, counts):
    """Perplexity of a packed model with every launch count set to 0
    just before and read (and added to `counts`) just after, and of its
    dequantized fp32 weights through torch.matmul; they must agree
    within TOL_PPL. Returns the row."""
    from repro_torch.data.evaluate import perplexity
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.quant import dequantize_params
    sync()
    reset_launch_counts()
    t0 = time.time()
    ppl = perplexity(cfg, params, windows(), max_batches=n_batches,
                     device=DEV)
    sync()
    wall = time.time() - t0
    got = launch_counts()
    for k, v in got.items():
        counts[k] = counts.get(k, 0) + v
    deq = dequantize_params(params)
    ppl_fp = perplexity(cfg, deq, windows(), max_batches=n_batches,
                        device=DEV)
    del deq
    rel = abs(ppl - ppl_fp) / ppl_fp
    row = {"model": name, "ppl_packed": ppl, "ppl_dequantized": ppl_fp,
           "rel_diff": rel, "tol": TOL_PPL, "eval_s": wall,
           "forward_ms_per_batch": 1e3 * wall / n_batches,
           "launches": got}
    require(math.isfinite(ppl) and rel <= TOL_PPL,
            f"eval path {name}: packed perplexity {ppl} vs dequantized "
            f"{ppl_fp} (rel {rel:.3g} > {TOL_PPL})")
    require(got["bcq_plain"] == 0, f"eval path {name}: a BCQ call took "
                                   f"the plain path")
    return row


def _gemm_profile(cfg, params, windows):
    """Device ms of one packed forward of the first eval batch, and of
    the BCQ GEMM kernels in it (torch.profiler)."""
    import numpy as np
    import torch
    from repro_torch.models import forward
    batch = next(iter(windows()))
    x = torch.from_numpy(np.asarray(batch["inputs"])).to(DEV)
    if DEV != "cuda":
        return {}
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.roofline.op_profile import (kernel_time_by_name,
                                                 traced_kernels)
    with torch.inference_mode():
        forward(cfg, params, x, remat="none")
        sync()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            forward(cfg, params, x, remat="none")
            sync()
    ev = traced_kernels(prof)
    by_name = kernel_time_by_name(ev)
    return {"forward_device_ms": sum(by_name.values()) / 1e3,
            "bcq_matmul_device_ms": sum(us for n, us in by_name.items()
                                        if "bcq_tc_gemm" in n) / 1e3,
            "bcq_matmul_kernels": sum("bcq_tc_gemm" in e.name for e in ev),
            "kernels": len(ev)}


class RTNPacked:
    """While entered, the packed RTN baseline is installed under
    "rtn_packed" (outside, the registry holds the reference's names
    only)."""

    def __enter__(self):
        from repro_torch.core.quantizers import RTNPackedQuantizer
        from repro_torch.quant import register_quantizer
        register_quantizer("rtn_packed")(RTNPackedQuantizer)
        return self

    def __exit__(self, *exc):
        from repro_torch.quant import registry
        registry._REGISTRY.pop("rtn_packed", None)
        return False


def eval_path(cfg, params, counts):
    """(b) A's trained model quantized to RTN w3 per-channel, packed;
    perplexity of the fp model, the packed one (the BCQ GEMM at M = B*S)
    and its dequantized weights."""
    from repro_torch.core import quantize_model
    from repro_torch.data import corpus_tokens, eval_batches
    from repro_torch.data.evaluate import perplexity
    from repro_torch.quant import QuantSpec

    toks = corpus_tokens(split="eval")

    def windows():
        return eval_batches(toks, EVAL_BATCH, EVAL_SEQ)
    t0 = time.time()
    ppl_fp = perplexity(cfg, params, windows(), max_batches=EVAL_BATCHES,
                        device=DEV)
    sync()
    fp_s = time.time() - t0
    spec = QuantSpec.from_config(cfg.quant, method="rtn_packed",
                                 mode="packed", bits=3)
    t0 = time.time()
    with RTNPacked():
        q, _ = quantize_model(cfg, params,
                              calibration_batches(cfg.vocab_size),
                              spec=spec, device=DEV)
    sync()
    quant_s = time.time() - t0
    row = _packed_ppl(cfg.name, cfg, q, windows, EVAL_BATCHES, counts)
    row.update({"check": "eval_path", "ppl_fp": ppl_fp,
                "fp_eval_s": fp_s, "quantize_s": quant_s,
                "method": "rtn w3 per-channel, packed",
                "windows": f"{EVAL_BATCHES} batches of {EVAL_BATCH} x "
                           f"{EVAL_SEQ} (M = {EVAL_BATCH * EVAL_SEQ})",
                **_gemm_profile(cfg, q, windows)})
    emit(row)
    require(row["launches"]["bcq_matmul"] > 0,
            "eval path: bcq_matmul was never launched")
    return row


def ppl_table(steps=TABLE_STEPS, arch="tiny-lm", counts=None):
    """(c) The paper's table on the card: `arch` trained by the port's
    Trainer for `steps` steps (a fresh cache directory, so it always
    trains), quantized to RTN w3 and GPTQT w3 (packed), each held to its
    dequantized weights; then the fixture's w3_moe artifact through the
    batched-expert kernel."""
    import shutil
    import tempfile
    from repro_torch.ckpt import load_packed
    from repro_torch.configs import get_config
    from repro_torch.core import quantize_model
    from repro_torch.data import corpus_tokens, eval_batches, pretrained
    from repro_torch.data.evaluate import perplexity
    from repro_torch.quant import QuantSpec

    toks = corpus_tokens(split="eval")

    def windows():
        return eval_batches(toks, TABLE_BATCH, TABLE_SEQ)
    cache = Path(tempfile.mkdtemp(prefix="chip_smoke_models_"))
    old = pretrained.MODELS_DIR
    pretrained.MODELS_DIR = cache
    try:
        t0 = time.time()
        cfg, params = pretrained.get_trained_lm(arch, steps=steps,
                                                device=DEV)
        sync()
        train_s = time.time() - t0
    finally:
        pretrained.MODELS_DIR = old
        shutil.rmtree(cache, ignore_errors=True)
    table = {"fp": perplexity(cfg, params, windows(),
                              max_batches=TABLE_BATCHES, device=DEV)}
    rows = []
    for method in ("rtn_packed", "gptqt"):
        spec = QuantSpec.from_config(cfg.quant, method=method,
                                     mode="packed", bits=3)
        t0 = time.time()
        with RTNPacked():
            q, _ = quantize_model(cfg, params,
                                  calibration_batches(cfg.vocab_size),
                                  spec=spec, device=DEV)
        sync()
        r = _packed_ppl(f"{arch} {method} w3", cfg, q, windows,
                        TABLE_BATCHES, counts)
        r["quantize_s"] = time.time() - t0
        rows.append(r)
        table[method.removesuffix("_packed")] = r["ppl_packed"]
        del q
    mp, _, meta = load_packed(FIXTURE / "w3_moe", device=DEV)
    mcfg = get_config(meta["arch"]).replace(dtype="float32",
                                            n_layers=len(mp["layers"]))
    r = _packed_ppl("fixture w3_moe", mcfg, mp, windows, TABLE_BATCHES,
                    counts)
    rows.append(r)
    require(r["launches"]["bcq_expert_matmul"] > 0,
            "eval path: bcq_expert_matmul was never launched on w3_moe")
    for r in rows:
        emit({"check": "eval_path", **r})
    row = {"check": "ppl_table", "model": arch, "train_steps": steps,
           "train_s": train_s, "windows": f"{TABLE_BATCHES} batches of "
                                          f"{TABLE_BATCH} x {TABLE_SEQ}",
           "ppl": table, "w3_moe_ppl": r["ppl_packed"]}
    emit(row)
    require(all(math.isfinite(v) for v in table.values()),
            f"ppl table: {table}")
    return row


def encoder_path(seed, arch="hubert-xlarge", n_layers=None,
                 batch=ENCODER_BATCH, frames=ENCODER_FRAMES):
    """(d) One loss_fn value and its gradients of the encoder at full
    width on seeded frames."""
    import torch
    from repro_torch.ckpt import stack_params
    from repro_torch.configs import get_config
    from repro_torch.models import init_params, loss_fn
    from repro_torch.train import global_norm
    from repro_torch.tree import leaves, tree_map, unflatten
    cfg = get_config(arch).replace(dtype="float32")
    if n_layers:
        cfg = cfg.replace(n_layers=n_layers)
    params = stack_params(cfg, init_params(cfg, seed=seed, device=DEV))
    gen = torch.Generator(device=DEV)
    gen.manual_seed(seed)
    x = torch.randn((batch, frames, cfg.d_model), generator=gen, device=DEV)
    y = torch.randint(0, cfg.vocab_size, (batch, frames), generator=gen,
                      device=DEV)
    if DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()
    live = tree_map(lambda a: a.requires_grad_(), params)
    sync()
    t0 = time.time()
    loss, _ = loss_fn(cfg, live, {"inputs": x, "labels": y})
    grads = torch.autograd.grad(loss, leaves(live))
    sync()
    ms = (time.time() - t0) * 1e3
    g = unflatten(params, grads)
    finite = all(bool(torch.isfinite(a).all()) for a in grads)
    gnorm = float(global_norm(g))
    row = {"check": "train_path_encoder", "model": cfg.name,
           "layers": cfg.n_layers, "params": _tree_numel(params),
           "frames": [batch, frames, cfg.d_model], "remat": cfg.remat,
           "loss": float(loss.detach()), "grads_finite": finite,
           "grad_global_norm": gnorm, "ms": ms,
           "peak_mem_gb": (torch.cuda.max_memory_allocated() / 1e9
                           if DEV == "cuda" else None)}
    emit(row)
    require(math.isfinite(row["loss"]) and finite and gnorm > 0,
            f"encoder path: loss {row['loss']}, finite grads {finite}, "
            f"norm {gnorm}")
    return row


def phase_train_eval(seed, arch="llama2-7b", n_layers=TRAIN_LAYERS,
                     batch=TRAIN_BATCH, seq=TRAIN_SEQ, table_steps=TABLE_STEPS,
                     table_arch="tiny-lm", encoder_layers=None):
    """Phase 10: (a) train, checkpoint and resume `arch` at full width,
    (b) its perplexity fp / packed RTN w3 through the BCQ GEMM, (c) the
    tiny LM's perplexity table and the MoE fixture through the expert
    kernel, (d) the encoder's loss and gradients. Returns (the launch
    counts of the packed evaluations, rows)."""
    import gc
    import torch
    from repro_torch.ckpt import unstack_blocks
    from repro_torch.kernels import launch_counts
    counts = {k: 0 for k in launch_counts()}
    p_a, cfg, train_row = train_path(seed, arch, n_layers, batch, seq)
    params = unstack_blocks(p_a)
    del p_a
    eval_row = eval_path(cfg, params, counts)
    del params
    gc.collect()
    if DEV == "cuda":
        torch.cuda.empty_cache()
    table_row = ppl_table(table_steps, table_arch, counts)
    encoder_row = encoder_path(seed, n_layers=encoder_layers)
    gc.collect()
    if DEV == "cuda":
        torch.cuda.empty_cache()
    require(counts["bcq_plain"] == 0,
            "phase 10: a BCQ call took the plain path")
    for k in ("bcq_matmul", "bcq_expert_matmul"):
        require(counts[k] > 0, f"phase 10: {k} was never launched")
    for k in ("bcq_gemv", "paged_attention", "paged_attention_quant"):
        require(counts[k] == 0, f"phase 10: {k} was launched")
    return counts, {"train": train_row, "eval": eval_row,
                    "table": table_row, "encoder": encoder_row}


# ---------------------------------------------------------------------------
# phase 11: the dry run of every cell on the meta device
# ---------------------------------------------------------------------------

# cells traced at once, each in a process of its own (the host's cores;
# no cell touches the card)
DRYRUN_JOBS = 8


def _dryrun_tasks() -> list:
    from repro_torch.launch import dryrun
    return [(arch, shape, {"quant_bits": bits, "probe": False,
                           "save": False})
            for bits in (None, 3) for arch, shape in dryrun.cells(bits)]


class BackgroundDryRun:
    """Phase 11's cells traced while the card's phases run: a thread of
    its own lowers its priority to the least (os.nice acts on the calling
    thread on Linux) before its pool spawns the workers, which inherit
    it, so the phases driving the card keep the cores they use; nothing
    here touches the card. result() waits for the cells."""

    def __init__(self, jobs=DRYRUN_JOBS):
        import threading
        self.out = self.error = self.seconds = None
        self.t0 = time.time()
        self.thread = threading.Thread(target=self._run, args=(jobs,),
                                       daemon=True)
        self.thread.start()

    def _run(self, jobs):
        import os
        try:
            os.nice(19)
            from repro_torch.launch import dryrun
            self.out = dryrun.run_cells(_dryrun_tasks(), jobs)
        except Exception as e:          # raised again by result()
            self.error = e
        self.seconds = time.time() - self.t0

    def result(self) -> list:
        self.thread.join()
        if self.error is not None:
            raise self.error
        return self.out


def phase_dryrun(jobs=DRYRUN_JOBS, pending=None):
    """launch/dryrun.py's cells on the meta device, sized against the
    card: the 32 (arch x shape) cells at bf16 and the 22 inference cells
    w3 packed, `jobs` at once, the longest traces handed out first (or
    the cells of `pending`, a BackgroundDryRun, once it ends); a
    `dryrun` line each, and a failing cell fails the phase. The costs
    are the full-depth trace's own count, without the 2/3-group probes
    (`python -m repro_torch.launch.dryrun --all` extrapolates them from
    the probes, to the same numbers)."""
    from repro_torch.launch import dryrun
    results = (pending.result() if pending is not None
               else dryrun.run_cells(_dryrun_tasks(), jobs))
    rows = []
    for r in results:
        row = {"check": "dryrun", "arch": r["arch"], "shape": r["shape"],
               "quant_bits": r["quant_bits"], "ok": r["ok"]}
        if r["ok"]:
            rf, mem = r["roofline"], r["memory"]
            row.update({k: r[k] for k in (
                "params_bytes_bf16", "params_bytes_packed", "cache_bytes",
                "state_bytes", "t_trace_s", "t_probe_s") if k in r})
            row.update({
                "peak_live_bytes_est": mem["peak_live_bytes_est"],
                "argument_bytes": mem["argument_bytes"],
                "fits_device": mem["fits_device"],
                "devices_for_peak": mem["devices_for_peak"],
                "flops": rf["flops_per_device"],
                "bytes": rf["bytes_per_device"],
                "t_compute_s": rf["t_compute_s"],
                "t_memory_s": rf["t_memory_s"],
                "t_collective_s": rf["t_collective_s"],
                "bound": rf["bound"], "t_bound_s": rf["t_bound_s"],
                "model_flops": r["model_flops_global"],
                "useful_flops_ratio": rf["useful_flops_ratio"]})
        else:
            row["error"] = r["error"]
        emit(row)
        rows.append(row)
    bad = [(r["arch"], r["shape"], r["quant_bits"]) for r in rows
           if not r["ok"]]
    require(not bad, f"dry run: cells failed: {bad}")
    return rows


# ---------------------------------------------------------------------------
# phase 13: training over meshes of ranks on the one card
# ---------------------------------------------------------------------------

# llama2-7b at full width cut to TRAIN_MESH_LAYERS of its 32 layers (for
# time: each pass gathers a layer's 809.6 MB of fp32 blocks through host
# memory over gloo, and the whole state is checkpointed; 2 until the
# other families needed the room), fp32, remat full, TF32 off, wiki
# batches of 4 x 256, 3 steps
TRAIN_MESH_LAYERS = 1
TRAIN_MESH_BATCH, TRAIN_MESH_SEQ, TRAIN_MESH_STEPS = 4, 256, 3
TRAIN_MESH_WARMUP, TRAIN_MESH_SAVE_AT = 2, 2
# (mesh shape, first rank, stage, options): (2, 1) and (1, 2) side by
# side on ranks 0-1 and 2-3, then (2, 2); the (2, 2) run saves its state
# at step TRAIN_MESH_SAVE_AT for a single-device Trainer to resume
TRAIN_MESHES = (
    ((2, 1), 0, 0, {"fsdp": True}),
    ((1, 2), 2, 0, {"fsdp": False}),
    ((2, 2), 0, 1, {"fsdp": True, "microbatches": 2, "grad_compress": "int8",
                    "save_at": TRAIN_MESH_SAVE_AT}))
# against the single device's run: losses and the global gradient norm
# of each step relative; each leaf of AdamW's first moment (a running
# mean of the gradient) within TOL x max|mu|; each params leaf in
# norm, ||p - p1|| <= TOL x ||p1|| (p the weight, or 1 + w for a
# zero-centred norm scale w: what rmsnorm applies). A leaf's largest
# entry error is printed beside it: Adam moves every entry ~lr a step,
# whatever its gradient, so an entry whose gradient the reduction order
# changes in its leading digits (a sum that cancels) moves otherwise by
# a share of lr (the one-device noise floor line shows the same between
# 1 and 2 microbatches)
TOL_TRAIN_MESH = 1e-5
# A model whose noise floor moves a leaf of mu by TOL / 2 or more in
# norm (a gradient that cancels: one reordering moves the whole leaf, not
# a few entries; falcon-mamba-7b's dt_w, 6.4e-6 on an H100) holds mu's
# largest entry to TRAIN_MESH_FLOOR_X x the floor's, where that is above
# TOL: a (2, 2) step reorders several sums at once (its token sums split
# over data ranks, a contraction over model ranks, the microbatches)
# where the floor reorders one, and independent rounding errors add in
# quadrature (sqrt 2-4)
TRAIN_MESH_FLOOR_X = 2
TRAIN_MESH_TIMEOUT_S = 900
# the other families, at full width with 4 ranks sharing the card, each
# mesh held to the single device's run of its options: (arch, layers,
# meshes). mixtral-8x7b 1 of 32 layers (1713.4 M params) with its 8
# experts on the model axis, 2 microbatches on both meshes (one
# single-device state, 13.7 GB on disk, serves both), on (2, 2) each
# routed over the data ranks, with FSDP: a step holds the old and new
# params, mu and nu beside the gradients (7 copies of a rank's 3.43 GB
# of params without FSDP, 96 GB for four ranks; one device peaks at
# 54.3 GB), 1/4 of that with it;
# minicpm3-4b (MLA) 2 of 62 layers, (2, 2) FSDP;
# falcon-mamba-7b 2 of 64 layers, (2, 2) FSDP, 2 microbatches, int8.
# All join llama2-7b's spawn, a model's meshes after the one's before;
# the one-device noise floor (1 against 2 microbatches) is measured for
# every model but a MoE config (whose microbatches route apart)
# qwen3-moe-235b-a22b's layer (~60 GB with AdamW) and jamba's MoE layer
# (38.7 GB of experts) do not fit beside their state: they train on the
# CPU only (tests/test_torch_train_mesh_families.py)
TRAIN_MESH_FAMILIES = (
    ("mixtral-8x7b", 1, (
        ((1, 2), 0, 0, {"fsdp": False, "microbatches": 2}),
        ((2, 2), 0, 1, {"fsdp": True, "microbatches": 2}))),
    ("minicpm3-4b", 2, (
        ((1, 2), 0, 0, {"fsdp": False}),
        ((2, 2), 0, 1, {"fsdp": True}))),
    ("falcon-mamba-7b", 2, (
        ((1, 2), 0, 0, {"fsdp": False}),
        ((2, 2), 0, 1, {"fsdp": True, "microbatches": 2,
                        "grad_compress": "int8"}))))


def _train_mesh_cfg(arch, n_layers):
    from repro_torch.configs import get_config
    return get_config(arch).replace(dtype="float32", n_layers=n_layers,
                                    remat="full")


def _train_mesh_opt():
    from repro_torch.train import AdamWConfig
    return AdamWConfig(lr=1e-3, master_fp32=False)


def _applied(key, w):
    """What the forward applies of the leaf `w` at `key`: the weight, or
    1 + w for a zero-centred norm scale (rmsnorm); mu as it is."""
    from repro_torch.dist.sharding import REPLICATED_LEAVES
    norm = (key.startswith("['params']")
            and key.split("'")[-2] in REPLICATED_LEAVES)
    return (1.0 + w if norm else w).float()


def leaf_scales(state: dict) -> dict:
    """{leaf: max|p|} of a whole state ({keystr: tensor}, p _applied; on
    the card)."""
    return {k: float(_applied(k, w.to(DEV)).abs().max())
            for k, w in state.items()}


def block_stats(got: dict, want: dict, scales: dict) -> dict:
    """Per leaf of two blocks of a state ({keystr: tensor}): max|got -
    want|, sum (got - want)^2, sum p^2 (p _applied) and the entries
    beyond TOL_TRAIN_MESH x the whole leaf's max|p| (`scales`); on the
    card."""
    def sq(t):
        # in fp64, 2^26 entries at a time (a mixtral expert stack is 1.9
        # GB in fp64 whole, on four ranks at once)
        return float(sum(c.double().square().sum()
                         for c in t.reshape(-1).split(1 << 26)))
    out = {}
    for key, w in want.items():
        w = w.to(DEV)
        d = got[key].to(DEV).float() - w.float()
        p = _applied(key, w)
        out[key] = {"max": float(d.abs().max()), "d2": sq(d), "p2": sq(p),
                    "over": int((d.abs() > TOL_TRAIN_MESH
                                 * scales[key]).sum())}
    return out


def leaf_errors(stats: list, scales: dict) -> dict:
    """block_stats of every rank (a leaf a group replicates counted on
    each, in d and p alike) -> the worst leaf of each measure: params
    max|d| / max|p| ("params_max") and ||d|| / ||p|| ("params_norm"),
    mu's alike ("mu_max", "mu_norm"), each with its leaf, and the params
    entries over TOL_TRAIN_MESH x max|p| in all."""
    keys = stats[0].keys()
    per = {k: {"max": max(s[k]["max"] for s in stats)
               / max(scales[k], 1e-30),
               "norm": math.sqrt(sum(s[k]["d2"] for s in stats)
                                 / max(sum(s[k]["p2"] for s in stats),
                                       1e-60)),
               "over": sum(s[k]["over"] for s in stats)} for k in keys}
    out = {}
    for part, measures in (("params", ("max", "norm")),
                           ("mu", ("max", "norm"))):
        rows = {k: v for k, v in per.items()
                if k.startswith("['params']") == (part == "params")}
        for m in measures:
            key = max(rows, key=lambda k: rows[k][m])
            out[f"{part}_{m}"] = rows[key][m]
            out[f"{part}_{m}_leaf"] = key
    out["params_entries_over_tol_x_max"] = sum(
        v["over"] for k, v in per.items() if k.startswith("['params']"))
    return out


def _whole_errors(got: dict, want: dict) -> dict:
    """leaf_errors of two whole states."""
    scales = leaf_scales(want)
    return leaf_errors([block_stats(got, want, scales)], scales)


def _state_of(params, opt) -> dict:
    """{keystr: tensor} of the params and AdamW's mu."""
    from repro_torch.tree import keystr, leaves_with_paths
    return {keystr(p): a for p, a in
            leaves_with_paths({"params": params, "opt": {"mu": opt["mu"]}})}


def _single_train(cfg, batches, mb, comp):
    """The single device's run of `batches`: -> (losses, gradient norms,
    ms a step, peak GB, its params and mu on the host, a MoE config's
    (aux, dropped pairs) a step)."""
    import torch
    from repro_torch.ckpt import stack_params
    from repro_torch.models import init_params
    from repro_torch.train import init_train_state, make_train_step
    opt_cfg = _train_mesh_opt()
    params = stack_params(cfg, init_params(cfg, seed=0, device=DEV))
    opt = init_train_state(cfg, params, opt_cfg)
    step = make_train_step(cfg, opt_cfg, microbatches=mb, grad_compress=comp,
                           warmup=TRAIN_MESH_WARMUP,
                           total_steps=len(batches))
    if DEV == "cuda":
        torch.cuda.reset_peak_memory_stats()
    losses, norms, ms, moe = [], [], [], []
    for b in batches:
        sync()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, b)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        ms.append((time.perf_counter() - t0) * 1e3)
        moe.append(_moe_metrics(m))
    peak = torch.cuda.max_memory_allocated() / 1e9 if DEV == "cuda" else None
    state = {k: a.cpu() for k, a in _state_of(params, opt).items()}
    del params, opt, step
    _free()
    return losses, norms, ms, peak, state, moe


def _moe_metrics(m):
    """A step's (aux loss, dropped (token, choice) pairs) of a MoE
    config, else None."""
    if "moe_dropped" not in m:
        return None
    return float(m["aux"]), int(m["moe_dropped"])


# the leaves the port cuts otherwise than the rule's spec
# (dist/sharding.py:_local_spec): the router and MLA's latent projections
# whole on the model axis; Mamba's in_proj by halves, x_proj by rows and
# its per-channel leaves (which the rule replicates) on d_inner. A rank's
# bytes of these are shard_params' blocks, of every other leaf the spec's
PORT_CUT = frozenset({"router", "wq_a", "wkv_a"})
PORT_CUT_MAMBA = frozenset({"in_proj", "x_proj", "conv_w", "conv_b", "dt_b",
                            "D", "A_log"})


def _port_cut(names) -> bool:
    return names[-1] in (PORT_CUT_MAMBA if "mamba" in names else PORT_CUT)


def _cut_numel(cfg, mesh, fsdp) -> int:
    """The entries of the PORT_CUT leaves a rank holds under shard_params'
    cut of the whole tree (the model axis by the port's local spec, the
    data axis with fsdp), counted on the meta device."""
    from repro_torch.dist.fsdp import FsdpLeaf
    from repro_torch.dist.sharding import shard_params
    from repro_torch.models import init_params

    def numel(t, names):
        if isinstance(t, dict):
            return sum(numel(v, names + (k,)) for k, v in t.items())
        if isinstance(t, list):
            return sum(numel(v, names + (i,)) for i, v in enumerate(t))
        if not _port_cut(names):
            return 0
        if isinstance(t, FsdpLeaf):
            return sum(f.numel() for f in t.fields.values())
        return t.numel()
    return numel(shard_params(cfg, init_params(cfg, device="meta"), mesh,
                              fsdp=fsdp), ())


def _spec_numel(cfg, mesh, fsdp, keep=lambda names: True) -> int:
    """The entries of the leaves `keep` names that a rank holds under the
    rule's specs at the mesh (named_pspec, guarded; local_shape),
    counted apart from the port's cut."""
    from repro_torch.ckpt import stack_params
    from repro_torch.dist.sharding import local_shape, named_pspec
    from repro_torch.models import init_params
    from repro_torch.tree import leaves_with_paths
    meta = stack_params(cfg, init_params(cfg, device="meta"))
    return sum(math.prod(local_shape(a.shape, named_pspec(cfg, p, a, mesh,
                                                          fsdp=fsdp), mesh))
               for p, a in leaves_with_paths(meta) if keep(p))


def _state_bytes(n) -> int:
    """The bytes of params, mu and nu (fp32) of n entries and AdamW's
    int32 step."""
    return 3 * 4 * n + 4


def _train_mesh_rank(mesh, spec):
    """One rank of a phase-13 mesh: the seeded whole init cut to its
    blocks (TrainLayout), `spec["batches"]` through make_train_step(mesh=)
    with every step timed (the last traced), the (2, 2) state saved at
    its step, the whole params and mu gathered and (rank 0) held to the
    single device's, then one layer's gather and its reduce-scatter (or,
    on a model axis, an activation's all-reduce) timed alone. -> the
    rank's row."""
    global DEV
    DEV = spec["dev"]
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.ckpt import CheckpointManager, stack_params
    from repro_torch.dist.context import (gather_fsdp, mesh_any,
                                          mesh_context, reduce_model)
    from repro_torch.dist.sharding import TrainLayout
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import init_params
    from repro_torch.roofline.op_profile import (kernel_time_by_name,
                                                 traced_kernels)
    from repro_torch.train import init_train_state, make_train_step
    from repro_torch.tree import keystr, leaves, leaves_with_paths
    cfg = _train_mesh_cfg(spec["arch"], spec["n_layers"])
    opt_cfg = _train_mesh_opt()
    fsdp = spec["fsdp"]
    cuda = DEV == "cuda"
    D, M = mesh.shape
    with mesh_context(mesh):
        t0 = time.time()
        layout = TrainLayout(cfg, mesh, fsdp)
        whole = stack_params(cfg, init_params(cfg, seed=0,
                                              device=mesh.device))
        params, _ = layout.shard(whole, {})
        del whole
        _free()
        opt = init_train_state(cfg, params, opt_cfg)
        step = make_train_step(
            cfg, opt_cfg, microbatches=spec.get("microbatches", 1),
            grad_compress=spec.get("grad_compress", "none"),
            warmup=TRAIN_MESH_WARMUP, total_steps=len(spec["batches"]),
            mesh=mesh, fsdp=fsdp)
        sync()
        init_s = time.time() - t0
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        losses, norms, walls, collectives, moe = [], [], [], [], []
        busy, save_s = None, None
        last = len(spec["batches"]) - 1
        for i, b in enumerate(spec["batches"]):
            mesh.counts.clear()
            sync()
            t = time.perf_counter()
            if i == last and cuda:
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    params, opt, m = step(params, opt, b)
                    sync()
                busy = sum(kernel_time_by_name(
                    traced_kernels(prof)).values()) / 1e3
            else:
                params, opt, m = step(params, opt, b)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            walls.append((time.perf_counter() - t) * 1e3)
            collectives.append(dict(mesh.counts))
            moe.append(_moe_metrics(m))
            if spec.get("save_at") == i + 1:
                t = time.time()
                CheckpointManager(spec["ckpt"], keep_n=1).save(
                    i + 1, {"params": params, "opt": opt}, layout=layout)
                save_s = time.time() - t
        launches = launch_counts()
        peak = torch.cuda.max_memory_allocated() / 1e9 if cuda else None
        held = {k: sum(a.numel() * a.element_size() for a in leaves(t))
                for k, t in (("params", params), ("opt", opt))}
        # one layer's weights as the forward gathers them (the rank's
        # model-axis slice, whole on the data axis)
        layer_bytes = sum(
            a[0].numel() * a.element_size()
            * (1 if layout.data_dim(("blocks", "L0") + p) is None else D)
            for p, a in leaves_with_paths(params["blocks"]["L0"]))
        # this rank's blocks of the params and mu against its blocks of
        # the single device's (the parent combines the ranks' sums)
        want = torch.load(spec["want"], mmap=True)
        got, stats = _state_of(params, opt), {}
        for path, _ in leaves_with_paths({"params": params,
                                          "opt": {"mu": opt["mu"]}}):
            k = keystr(path)      # leaf by leaf: four ranks share the card
            stats |= block_stats({k: got[k]}, {k: layout.cut(path, want[k])},
                                 spec["scales"])
        del want, got
        _free()
        # one layer's collectives alone: a block gathered, then its
        # gradient reduce-scattered (the gather's backward), or an
        # activation all-reduced over the model group
        times = {}
        if D > 1 and fsdp:
            # the first layer's largest data-cut leaf
            _, path, x = max((a[0].numel(), p, a[0]) for p, a in
                             leaves_with_paths(params["blocks"]["L0"])
                             if layout.data_dim(("blocks", "L0") + p)
                             is not None)
            x = x.detach().clone().requires_grad_()
            sync()
            mesh_any(False, mesh)        # every rank starts together
            t = time.perf_counter()
            y = gather_fsdp(x, layout.data_dim(("blocks", "L0") + path))
            sync()
            times["gather_ms"] = (time.perf_counter() - t) * 1e3
            t = time.perf_counter()
            y.backward(torch.ones_like(y))
            sync()
            times["reduce_scatter_ms"] = (time.perf_counter() - t) * 1e3
            times["gather_bytes"] = y.numel() * y.element_size()
            times["gather_leaf"] = "/".join(path)
            del x, y
        if M > 1:
            act = torch.ones((TRAIN_MESH_BATCH // D, TRAIN_MESH_SEQ,
                              cfg.d_model), device=mesh.device)
            reduce_model(act)
            sync()
            mesh_any(False, mesh)
            t = time.perf_counter()
            reduce_model(act)
            sync()
            times["all_reduce_ms"] = (time.perf_counter() - t) * 1e3
            times["all_reduce_bytes"] = act.numel() * act.element_size()
    return {"rank": mesh.rank, "coords": list(mesh.coords),
            "init_s": init_s, "losses": losses, "grad_norms": norms,
            "wall_ms": walls, "device_busy_ms_last_step": busy,
            "collectives_by_step": collectives, "moe": moe,
            "held_bytes": held["params"] + held["opt"],
            "held_params_bytes": held["params"],
            # the specs' blocks of every leaf, and the bytes a rank must
            # hold: those, but shard_params' blocks of the PORT_CUT leaves
            "spec_local_bytes": _state_bytes(_spec_numel(cfg, mesh, fsdp)),
            "rule_local_bytes": _state_bytes(
                _spec_numel(cfg, mesh, fsdp,
                            lambda names: not _port_cut(names))
                + _cut_numel(cfg, mesh, fsdp)),
            "gathered_layer_bytes": layer_bytes, "peak_mem_gb": peak,
            "save_s": save_s, "stats": stats, "launches": launches,
            **times}


def _train_mesh_ranks(world, plan):
    """Every phase-13 mesh in one spawn: each rank makes every sub-mesh
    of `plan` ([(mesh shape, first rank, stage, spec)]), in plan order,
    then stage by stage trains the meshes it belongs to, meshes of one
    stage side by side, a barrier after each stage. -> a row or None a
    mesh."""
    import torch.distributed as dist
    from repro_torch.dist.context import mesh_any
    subs = [world.submesh(*shape, first=first)
            for shape, first, _, _ in plan]
    # every rank's first collective on a device tensor, all at once: a
    # rank's first costs seconds, paid once and not inside a timed step
    # of a mesh it joins late
    mesh_any(False, world)
    rows = [None] * len(plan)
    for stage in sorted({p[2] for p in plan}):
        for j, (_, _, st, spec) in enumerate(plan):
            if st == stage and subs[j] is not None:
                rows[j] = _train_mesh_rank(subs[j], spec)
                _free()
        dist.barrier()
    return rows


def _directions(counts: dict) -> dict:
    """A step's collectives by direction: forward, backward (the hooks'
    "_backward" kinds), step (the gradient and norm reductions)."""
    out = {"forward": {}, "backward": {}, "step": {}}
    for k, v in counts.items():
        d = ("backward" if k.endswith("_backward") else
             "step" if k.startswith("step_") else "forward")
        out[d][k] = v
    return out


def _rel(got, want) -> float:
    return max(abs(a - b) / abs(b) for a, b in zip(got, want))


def _param_count(cfg) -> int:
    """The number of `cfg`'s parameters (shapes only)."""
    from repro_torch.ckpt import stack_params
    from repro_torch.models import init_params
    from repro_torch.tree import leaves
    return sum(a.numel() for a in leaves(stack_params(
        cfg, init_params(cfg, device="meta"))))


def _resume_single(cfg, spec, bs, single):
    """A single-device Trainer resuming the mesh's checkpoint (its
    microbatches and compression) to the end of `bs`: its restore
    seconds, losses, params and mu against the single device's run."""
    import torch
    from repro_torch.train import Trainer, TrainerConfig
    restores = []
    tr = Trainer(cfg, TrainerConfig(
        steps=len(bs), ckpt_every=10 ** 9, ckpt_dir=spec["ckpt"], keep_n=1,
        log_every=10 ** 9, microbatches=spec.get("microbatches", 1),
        grad_compress=spec.get("grad_compress", "none"),
        warmup=TRAIN_MESH_WARMUP, seed=0, opt=_train_mesh_opt()),
        iter(bs[spec["save_at"]:]), dtype="float32", device=DEV)
    tr.ckpt.save = lambda *a, **kw: None       # nothing reads its end
    _timed(tr.ckpt, "restore", restores)
    out = tr.run()
    want = torch.load(single["path"], mmap=True)
    errs = _whole_errors(_state_of(tr.params, tr.opt_state), want)
    losses = [m["loss"] for m in tr.metrics_log]
    res = {"resumed": out["resumed"], "from_step": spec["save_at"],
           "restore_s": restores, "losses": losses,
           "max_loss_rel_err": _rel(losses,
                                    single["losses"][spec["save_at"]:]),
           "errors": errs}
    del tr, want
    _free()
    return res


def _mu_gate(floor) -> float:
    """The bound on mu's largest entry error (of max|mu|) for a model with
    the noise floor line `floor` (None without one): TOL_TRAIN_MESH, or
    TRAIN_MESH_FLOOR_X x the floor's where a leaf's gradient cancels."""
    if floor is None or floor["mu_norm"] < TOL_TRAIN_MESH / 2:
        return TOL_TRAIN_MESH
    return max(TOL_TRAIN_MESH, TRAIN_MESH_FLOOR_X * floor["mu_max"])


def _errors_ok(errs, mu_gate) -> bool:
    return (errs["params_norm"] <= TOL_TRAIN_MESH
            and errs["mu_max"] <= mu_gate)


def _singles(cfg, bs, meshes, root, floor):
    """The single device's runs of `cfg` for the options of `meshes`
    (each saved under `root` for the ranks to hold to, with its leaves'
    scales) and, with `floor`, of 1 and 2 microbatches, whose difference
    a `train_mesh_noise_floor` line prints. -> ({(microbatches,
    compression): run}, that line or None)."""
    import torch
    moe = cfg.moe is not None and any(s.mlp == "moe" for s in cfg.pattern)
    singles, states = {}, {}
    used = {(o.get("microbatches", 1), o.get("grad_compress", "none"))
            for _, _, _, o in meshes}
    for mb, comp in sorted(used | ({(1, "none"), (2, "none")} if floor
                                   else set())):
        losses, norms, ms, peak, state, drops = _single_train(
            cfg, bs, mb, comp)
        run = {"losses": losses, "grad_norms": norms, "ms": ms,
               "peak_mem_gb": peak, "moe": drops}
        if (mb, comp) in used:              # for the ranks to hold to
            run["path"] = str(root / f"single_{cfg.name}_mb{mb}_{comp}.pt")
            torch.save(state, run["path"])
            run["scales"] = leaf_scales(state)
        if floor and (mb, comp) in ((1, "none"), (2, "none")):
            states[mb] = state
        del state
        singles[(mb, comp)] = run
        emit({"check": "train_mesh_single_device", "model": cfg.name,
              "layers": cfg.n_layers, "microbatches": mb,
              "grad_compress": comp, "losses": losses,
              "grad_norms": norms, "ms": ms, "peak_mem_gb": peak,
              **({"aux": [a for a, _ in drops],
                  "dropped_pairs": [d for _, d in drops]} if moe else {}),
              "card": CARD})
    line = None
    if floor:
        one, two = singles[(1, "none")], singles[(2, "none")]
        line = {"check": "train_mesh_noise_floor", "model": cfg.name,
                "compared": "one device, 2 microbatches against 1",
                "max_loss_rel_err": _rel(two["losses"], one["losses"]),
                "max_grad_norm_rel_err": _rel(two["grad_norms"],
                                              one["grad_norms"]),
                **_whole_errors(states[2], states[1]), "card": CARD}
        emit(line)
    return singles, line


def phase_train_mesh(seed, arch="llama2-7b", n_layers=TRAIN_MESH_LAYERS,
                     batch=TRAIN_MESH_BATCH, seq=TRAIN_MESH_SEQ,
                     steps=TRAIN_MESH_STEPS, meshes=TRAIN_MESHES, others=()):
    """Phase 13: `arch` cut to `n_layers` and each model of `others`
    ((arch, layers, meshes), ...), trained `steps` steps on wiki batches
    of batch x seq on one device (with each mesh's microbatches and
    compression) and on each of its meshes (ranks sharing the card over
    gloo, one spawn for every model, a model's stages after the one's
    before); each mesh held to the single device's run of its options
    (TOL_TRAIN_MESH); a mesh with `save_at` saves its state whole at
    that step and a single-device Trainer resumes it to the end, held
    alike. A MoE config's mesh drops the single device's (token, choice)
    pairs at every step (its aux loss beside them). A `train_mesh_path`
    line a mesh, and for a model without MoE layers (whose microbatches
    route apart) a `train_mesh_noise_floor` line (one device's 2
    microbatches against 1: the same gradient summed in another order),
    which sets the model's mu gate (_mu_gate).
    Returns the launches summed over the ranks (training runs no port
    kernel)."""
    import shutil
    import tempfile
    import torch
    from repro_torch.data import batches as make_batches
    from repro_torch.data import token_stream
    from repro_torch.dist.context import spawn
    from repro_torch.launch.mesh import make_serve_mesh
    it = make_batches(token_stream("wiki"), batch, seq, seed=0)
    bs = [next(it) for _ in range(steps)]
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_train_mesh_"))
    total, rows, plan, models = {}, [], [], []
    try:
        for m_arch, m_layers, m_meshes in ((arch, n_layers, meshes),
                                           *others):
            cfg = _train_mesh_cfg(m_arch, m_layers)
            moe = cfg.moe is not None and any(s.mlp == "moe"
                                              for s in cfg.pattern)
            singles, floor = _singles(cfg, bs, m_meshes, root,
                                      floor=not moe)
            first_stage = 1 + max((p[2] for p in plan), default=-1)
            for shape, first, stage, opts in m_meshes:
                key = (opts.get("microbatches", 1),
                       opts.get("grad_compress", "none"))
                plan.append((shape, first, first_stage + stage, {
                    **opts, "arch": m_arch, "n_layers": m_layers,
                    "batches": bs, "dev": DEV, "model": len(models),
                    "want": singles[key]["path"], "single": key,
                    "scales": singles[key]["scales"],
                    "ckpt": str(root / f"ckpt_{cfg.name}_{shape[0]}x"
                                f"{shape[1]}")}))
            models.append((cfg, m_layers, moe, singles, _mu_gate(floor)))
        n = max(D * M for (D, M), *_ in plan)
        world = make_serve_mesh(2, n // 2, [f"{DEV}:0" if DEV == "cuda"
                                            else DEV] * n)
        print(f"train mesh path: one spawn of {world.describe()}",
              flush=True)
        t0 = time.time()
        ranks_of = spawn(_train_mesh_ranks, world, (plan,),
                         threads=1 if DEV == "cpu" else None,
                         timeout_s=TRAIN_MESH_TIMEOUT_S)
        emit({"check": "train_mesh_spawn", "ranks": n, "card": CARD,
              "seconds": time.time() - t0,
              "stages": [[f"{D}x{M}@{first}" for (D, M), first, st, _
                          in plan if st == s]
                         for s in sorted({p[2] for p in plan})]})
        for j, ((D, M), _, _, spec) in enumerate(plan):
            cfg, m_layers, moe, singles, mu_gate = models[spec["model"]]
            ranks = [r[j] for r in ranks_of if r[j] is not None]
            single = singles[spec["single"]]
            lead = next(r for r in ranks if r["rank"] == 0)
            row = {"check": "train_mesh_path", "mesh": [D, M],
                   "model": cfg.name, "layers": m_layers, "card": CARD,
                   "batch": batch, "seq": seq, "fsdp": spec["fsdp"],
                   "microbatches": spec.get("microbatches", 1),
                   "grad_compress": spec.get("grad_compress", "none"),
                   "losses": lead["losses"],
                   "single_losses": single["losses"],
                   "max_loss_rel_err": max(_rel(r["losses"],
                                                single["losses"])
                                           for r in ranks),
                   "max_grad_norm_rel_err": max(
                       _rel(r["grad_norms"], single["grad_norms"])
                       for r in ranks),
                   "errors": leaf_errors([r["stats"] for r in ranks],
                                         spec["scales"]),
                   "mu_gate": mu_gate,
                   **({"aux": [a for a, _ in lead["moe"]],
                       "single_aux": [a for a, _ in single["moe"]],
                       "dropped_pairs": [d for _, d in lead["moe"]],
                       "single_dropped_pairs": [d for _, d in
                                                single["moe"]],
                       "max_aux_rel_err": max(
                           _rel([a for a, _ in r["moe"]],
                                [a for a, _ in single["moe"]])
                           for r in ranks),
                       "drops_equal": all([d for _, d in r["moe"]]
                                          == [d for _, d in single["moe"]]
                                          for r in ranks)}
                      if moe else {}),
                   "single_ms": single["ms"],
                   "single_peak_mem_gb": single["peak_mem_gb"],
                   # params, mu and nu, fp32
                   "whole_state_bytes": 12 * _param_count(cfg),
                   "ranks": [{k: v for k, v in r.items()
                              if k not in ("stats", "launches", "moe",
                                           "collectives_by_step")}
                             | {"collectives_last_step": _directions(
                                 r["collectives_by_step"][-1])}
                             for r in ranks]}
            for r in ranks:
                for k, v in r["launches"].items():
                    total[k] = total.get(k, 0) + v
            if spec.get("save_at"):
                row["resume"] = _resume_single(cfg, spec, bs, single)
            emit(row)
            rows.append((row, ranks, single))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for row, ranks, single in rows:
        name = (f"train mesh {row['model']} "
                f"{row['mesh'][0]}x{row['mesh'][1]}")
        require(row["max_loss_rel_err"] <= TOL_TRAIN_MESH
                and row["max_grad_norm_rel_err"] <= TOL_TRAIN_MESH,
                f"{name}: losses {row['max_loss_rel_err']:.3g}, gradient "
                f"norms {row['max_grad_norm_rel_err']:.3g} from the single "
                f"device's")
        require(_errors_ok(row["errors"], row["mu_gate"]),
                f"{name}: params or mu off the single device's: "
                f"{row['errors']}")
        if "drops_equal" in row:
            require(row["drops_equal"]
                    and row["max_aux_rel_err"] <= TOL_TRAIN_MESH,
                    f"{name}: dropped pairs {row['dropped_pairs']} and aux "
                    f"{row['aux']}, one device's "
                    f"{row['single_dropped_pairs']} and {row['single_aux']}")
        for r in ranks:
            require(r["held_bytes"] == r["rule_local_bytes"],
                    f"{name}: rank {r['rank']} holds {r['held_bytes']} B, "
                    f"the rule's blocks {r['rule_local_bytes']} B")
            require(DEV != "cuda"
                    or r["peak_mem_gb"] < single["peak_mem_gb"],
                    f"{name}: rank {r['rank']} peaks at {r['peak_mem_gb']} "
                    f"GB, one device at {single['peak_mem_gb']} GB")
        resume = row.get("resume")
        if resume is not None:
            require(resume["resumed"]
                    and _errors_ok(resume["errors"], row["mu_gate"])
                    and resume["max_loss_rel_err"] <= TOL_TRAIN_MESH,
                    f"{name}: the single-device resume of its checkpoint: "
                    f"{resume}")
    return total


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default="1,2,3,4,5,6,7,8,9,10,11,12,13")
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
    global CARD
    CARD = card
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

    # phase 11 runs on the CPU alone: its cells trace from here, beside
    # the phases that drive the card, and phase 11 waits for them
    dry = BackgroundDryRun() if 11 in phases else None
    gen = torch.Generator(device=DEV)
    gen.manual_seed(args.seed)
    lines = {k: {"name": k, "route": "cuda", "source": KERNEL_ROWS[k][0],
                 "replaces": KERNEL_ROWS[k][1], "launches": 0,
                 "launches_by_path": {}, "launches_in_graphs": 0}
             for k in KERNEL_ROWS}

    def phase_done(n, t0):
        emit({"check": "phase_done", "phase": n,
              "seconds": time.time() - t0})

    def count(path, counts):
        for k in lines:
            lines[k]["launches_by_path"][path] = counts[k]
            lines[k]["launches"] += counts[k]

    def graphs(path):
        """The compile cache once `path`'s models are freed; the kernel
        launches its graphs replayed (each also counted in its path)."""
        row = compile_cache_report(path)
        for k in lines:
            lines[k]["launches_in_graphs"] += row["launches_in_replays"].get(
                k, 0)
    try:
        if 1 in phases:
            t0 = time.time()
            worst, n_checks = check_bcq(gen, LLAMA_SHAPES)
            worst_q, n_q = check_bcq(gen, QWEN_SHAPES, GEMV_MS, ())
            worst["bcq_gemv"] = max(worst["bcq_gemv"], worst_q["bcq_gemv"])
            n_checks["bcq_gemv"] += n_q["bcq_gemv"]
            # head_dim 16 from a generator of its own, so the later
            # phase-1 lines get the inputs they would get without it
            worst["paged_attention"] = max(check_paged(gen), check_paged(
                torch.Generator(device=DEV).manual_seed(args.seed + 16),
                HD16_CASES))
            worst["paged_attention_quant"] = max(
                check_paged_quant(gen), check_paged_quant_grid(args.seed))
            # a rank's KV heads of a replicated pool (phase 12's (1, 8))
            for k, v in check_paged_rank(args.seed + 8).items():
                worst[k] = max(worst[k], v)
            worst["bcq_expert_matmul"], n_exact = check_expert(gen)
            # phase 9's shapes: the zoo's linears, jamba's expert stacks
            worst_z, n_z = check_bcq_zoo(gen)
            for k in ("bcq_gemv", "bcq_matmul"):
                worst[k] = max(worst[k], worst_z[k])
                n_checks[k] += n_z[k]
            worst_j, n_exact_j = check_expert(gen, E=16,
                                              shapes=JAMBA_EXPERT_SHAPES,
                                              Ms=(4, 26))
            worst["bcq_expert_matmul"] = max(worst["bcq_expert_matmul"],
                                             worst_j)
            n_exact += n_exact_j
            # phase 12's shard shapes, from a generator of their own (the
            # later lines get the inputs they would get without them)
            gen12 = torch.Generator(device=DEV).manual_seed(args.seed + 12)
            worst_m, n_m = check_bcq_zoo(gen12, MESH_SHARD_SHAPES, "mesh")
            for k in ("bcq_gemv", "bcq_matmul"):
                worst[k] = max(worst[k], worst_m[k])
                n_checks[k] += n_m[k]
            worst_e, n_exact_e = check_expert(
                gen12, E=MESH_EXPERTS, shapes=JAMBA_EXPERT_SHAPES, Ms=(4,))
            worst["bcq_expert_matmul"] = max(worst["bcq_expert_matmul"],
                                             worst_e)
            n_exact += n_exact_e
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
                # draft views (2 of 3 stored planes), within the same
                # tolerance
                lines[k]["draft_view_checks"] = n_checks[f"{k}_draft"]
                lines[k]["max_rel_err_all_checks"] = max(
                    worst[k], worst[f"{k}_draft"])
            # the rep-16 geometry of phase 5 (Qwen3-MoE), beside the lines
            emit({"check": "paged_attention_rep16",
                  **summarize_paged(gen, Hkv=4, rep=16)})
            emit({"check": "paged_attention_quant_rep16",
                  **summarize_paged_quant(gen, Hkv=4, rep=16)})
            # a rank of phase 12's (1, 8) Qwen3-MoE: one KV head of the
            # replicated 4-head pool, 8 query heads (generator of its own)
            gen_r = torch.Generator(device=DEV).manual_seed(args.seed + 9)
            emit({"check": "paged_attention_rank",
                  **summarize_paged(gen_r, Hkv=1, rep=RANK_REP,
                                    pool_heads=RANK_POOL_HEADS, kv0=1)})
            emit({"check": "paged_attention_quant_rank",
                  **summarize_paged_quant(gen_r, Hkv=1, rep=RANK_REP,
                                          pool_heads=RANK_POOL_HEADS,
                                          kv0=1)})
            # the GEMV at one and eight rows, beside the line's four
            for M in (1, 8):
                emit({"check": "bcq_gemv_shape",
                      **summarize_bcq(gen, "bcq_gemv", M, 4096, 11008)})
            # a draft step's GEMV: batch 4 on 2 of the 3 stored planes
            emit({"check": "bcq_gemv_shape",
                  **summarize_bcq(gen, "bcq_gemv", 4, 4096, 11008,
                                  planes=DRAFT_PLANES)})
            emit({"check": "bcq_expert_matmul_prefill",
                  **summarize_expert(gen, M=16, routed=False)})
            # the GEMM at the other prefill buckets and at Qwen3-MoE's
            # attention projections (k/v N=512, q N=8192), and MLA's
            # latent expansion (minicpm3-4b's wkv_b at M=768)
            for M, K, N in GEMM_SHAPES + ((768, 256, 5120),):
                emit({"check": "bcq_matmul_shape",
                      **summarize_bcq(gen, "bcq_matmul", M, K, N)})
            # phase 10's perplexity forward: M = 4 x 512 on llama2-7b
            for K, N in LLAMA_SHAPES:
                emit({"check": "bcq_matmul_eval_shape",
                      **summarize_bcq(gen, "bcq_matmul",
                                      EVAL_BATCH * EVAL_SEQ, K, N)})
            phase_done(1, t0)
        if 2 in phases:
            t0 = time.time()
            phase_fixture()
            graphs("fixture")
            phase_done(2, t0)
        llama, main_outs = None, None
        if phases & {3, 4, 6, 8, 12}:
            t0 = time.time()
            llama = synthetic_llama(args.seed)
            sync()
            llama_build_s = time.time() - t0
        if 3 in phases:
            t0 = time.time()
            counts, _, main_outs = phase_main_path(args.seed, llama,
                                                   llama_build_s)
            count("main_path", counts)
            phase_done(3, t0)
        if 4 in phases:
            t0 = time.time()
            counts, _ = phase_kv_bits(args.seed, llama)
            count("kv_bits_path", counts)
            phase_done(4, t0)
        if 6 in phases:
            t0 = time.time()
            counts, _ = phase_prefix(args.seed, llama)
            count("prefix_path", counts)
            phase_done(6, t0)
        if 8 in phases:
            t0 = time.time()
            counts, _ = phase_speculative(args.seed, llama, main_outs)
            count("speculative_path", counts)
            phase_done(8, t0)
        if 12 in phases:
            t0 = time.time()
            count("mesh_path", phase_mesh(args.seed, llama, main_outs))
            gc.collect()
            torch.cuda.empty_cache()
            phase_done(12, t0)
        del llama                # free the llama weights before phase 7
        gc.collect()
        torch.cuda.empty_cache()
        if phases & {3, 4, 6, 8, 12}:
            graphs("llama2-7b: phases 3, 4, 6, 8, 12")
        if 7 in phases:
            t0 = time.time()
            counts, _ = phase_quantize(args.seed)
            count("quantize_path", counts)
            gc.collect()         # and phase 7's model before phase 5
            torch.cuda.empty_cache()
            graphs("quantize_path")
            phase_done(7, t0)
        if 5 in phases:
            t0 = time.time()
            counts, _ = phase_moe(args.seed)
            count("moe_path", counts)
            gc.collect()         # and phase 5's model before phase 9
            torch.cuda.empty_cache()
            graphs("moe_path")
            phase_done(5, t0)
        if 9 in phases:
            t0 = time.time()
            counts, _ = phase_zoo(args.seed)
            count("zoo_path", counts)
            gc.collect()         # and phase 9's models before phase 10
            torch.cuda.empty_cache()
            graphs("zoo_path")
            phase_done(9, t0)
        if 10 in phases:
            t0 = time.time()
            counts, _ = phase_train_eval(args.seed)
            count("train_eval_path", counts)
            graphs("train_eval_path")
            phase_done(10, t0)
        if 11 in phases:
            t0 = time.time()
            phase_dryrun(pending=dry)
            emit({"check": "dryrun_background",
                  "seconds_from_start": dry.seconds,
                  "waited_s": time.time() - t0, "jobs": DRYRUN_JOBS})
            phase_done(11, t0)
        if 13 in phases:
            t0 = time.time()
            count("train_mesh_path", phase_train_mesh(
                args.seed, others=TRAIN_MESH_FAMILIES))
            phase_done(13, t0)
        torch.cuda.synchronize()
        # every kernel of the served paths ran inside a replayed graph:
        # the GEMV in each decode step, the GEMM in verify (phase 8), the
        # expert kernel in MoE decode (phase 5), fp and binary-coded
        # attention (phases 3 and 4)
        for k, need in (("bcq_gemv", {3}), ("bcq_matmul", {8}),
                        ("bcq_expert_matmul", {5}),
                        ("paged_attention", {3}),
                        ("paged_attention_quant", {4})):
            require(not need <= phases or lines[k]["launches_in_graphs"] > 0,
                    f"{k} never ran inside a replayed CUDA graph")
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
