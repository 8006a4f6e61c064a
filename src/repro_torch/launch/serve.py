"""Serving launcher: loads a packed artifact, or trains (or restores)
a tiny LM and optionally quantizes it, then serves a demo request batch
through the continuous-batching engine (the reference's
`launch/serve.py`).

  # quantize once, save the packed artifact, serve
  PYTHONPATH=src python -m repro_torch.launch.serve --quant 3 \\
      --save-quantized artifacts/packed/tiny-w3 [--arch tiny-lm] \\
      [--method gptqt] [--group-size G] [--train-steps 300]

  # every later launch boots the artifact as-is
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --load-quantized DIR [--cache auto|dense|paged] [--requests N] \\
      [--batch-size B] [--max-new T] [--kv-bits BITS] \\
      [--kv-group-size GS] [--speculate K] [--draft-bits D] \\
      [--device cuda|cpu]

  # the sensitivity sweep: print paste-ready OverrideRules, serve nothing
  PYTHONPATH=src python -m repro_torch.launch.serve --suggest-overrides \\
      [--bytes-budget BYTES]

  # an artifact over a (data, model) mesh of ranks: one card a rank by
  # default; --devices names them (cuda:0,cuda:0 rehearses two ranks on
  # one card over gloo, cpu,cpu two ranks on the CPU); any decoder of
  # the zoo, speculatively too (attention-only patterns)
  PYTHONPATH=src python -m repro_torch.launch.serve --load-quantized DIR \\
      --mesh 2,1 [--devices cuda:0,cuda:1] [--speculate K]

Without --load-quantized the model is data/pretrained.py:get_trained_lm
(--arch trained for --train-steps steps, or its cached checkpoint,
either package's), quantized with --quant by core.api.quantize_model
(packed, calibrated on 24 windows of 192 tokens of the wiki train split)
and saved by ckpt.packed.save_packed with a w--draft-bits draft block.
An artifact is read by ckpt.packed.load_packed (manifests v1-v4, as the
reference writes them); the model config is the registry entry its meta
"arch" names (any decoder of the zoo: attention, MLA, Mamba or hybrid,
dense or MoE MLPs), at the artifact's own depth. `--mesh D,M` spawns
one process a mesh position (dist/context.py:spawn); each loads its
slice with load_packed(mesh=) and runs the engine on the mesh (the
paged cache; the batch rounded up to a multiple of D, as the
reference does), and rank 0 prints. `--speculate K` serves
self-speculatively, with or without --mesh: a `--draft-bits D` view of
the same packed codes proposes K tokens a tick, with the scales of the
artifact's v4 draft block when it has one (each rank's cut on a mesh)
and an LS re-fit otherwise (the launcher says which).
"""
from __future__ import annotations

import argparse
import sys

SEEDS = ["the ancient city", "a famous museum", "this railway",
         "the council", "another region", "the early dynasty"]
# the reference's calibration (benchmarks/common.py): 24 slices of 192
# tokens of the wiki train split, slice seed 1, batches of 4
N_CALIB, CALIB_LEN, CALIB_BATCH = 24, 192, 4


def calibration_batches(corpus: str = "wiki"):
    from repro_torch.data import calibration_slices, corpus_tokens
    sl = calibration_slices(corpus_tokens(corpus, split="train"), N_CALIB,
                            CALIB_LEN, seed=1)
    return [sl[i:i + CALIB_BATCH] for i in range(0, len(sl), CALIB_BATCH)]


def suggest(args, get_trained_lm) -> None:
    """--suggest-overrides: the sensitivity sweep's report and rules."""
    from repro_torch.quant import (QuantSpec, format_overrides,
                                   format_report, sensitivity_sweep,
                                   suggest_overrides)
    from repro_torch.quant.search import bump_cost_bytes
    cfg, params = get_trained_lm(args.arch, steps=args.train_steps,
                                 device=args.device)
    spec = QuantSpec.from_config(cfg.quant, method=args.method or "gptqt",
                                 bits=args.quant or cfg.quant.bits,
                                 group_size=args.group_size)
    scores = sensitivity_sweep(cfg, params, calibration_batches("wiki"),
                               spec=spec, device=args.device)
    print(format_report(scores))
    rules = suggest_overrides(scores, base_bits=spec.bits,
                              bytes_budget=args.bytes_budget)
    if args.bytes_budget is not None:
        spent = sum(bump_cost_bytes(s, spec.bits, spec.bits + 1)
                    for s in scores if any(r.pattern == s.path
                                           for r in rules))
        print(f"\n# bytes budget {args.bytes_budget}: bumped "
              f"{len(rules)}/{len(scores)} leaves from w{spec.bits} to "
              f"w{spec.bits + 1} ({spent} bytes spent); paste into "
              f"QuantSpec(..., overrides=...):")
    else:
        print(f"\n# most sensitive {len(rules)}/{len(scores)} leaves "
              f"bumped from w{spec.bits} to w{spec.bits + 1}; paste into "
              f"QuantSpec(..., overrides=...):")
    print(format_overrides(rules))
    return rules


def _parser():
    ap = argparse.ArgumentParser(prog="repro_torch.launch.serve")
    ap.add_argument("--arch", default="tiny-lm",
                    help="registry name of the model get_trained_lm "
                         "trains (ignored with --load-quantized)")
    ap.add_argument("--quant", type=int, default=0,
                    help="quantization bits (0 = serve the fp model)")
    ap.add_argument("--method", default=None,
                    help="registered quantizer name (default gptqt)")
    ap.add_argument("--group-size", type=int, default=0,
                    help="K entries per scale group (0 = per-channel); "
                         "must divide every quantized leaf's K_in")
    ap.add_argument("--suggest-overrides", action="store_true",
                    help="run the FineQuant-style sensitivity sweep and "
                         "print a paste-ready OverrideRule tuple instead "
                         "of serving")
    ap.add_argument("--bytes-budget", type=int, default=None,
                    metavar="BYTES",
                    help="with --suggest-overrides: spend this many extra "
                         "checkpoint bytes greedily by error reduction "
                         "per byte (default: bump the top-quantile "
                         "sensitive leaves regardless of size)")
    ap.add_argument("--save-quantized", default=None, metavar="DIR",
                    help="write the packed model artifact after quantizing")
    ap.add_argument("--load-quantized", default=None, metavar="DIR",
                    help="boot from a packed artifact (ckpt/packed.py; "
                         "skips training, calibration and quantization)")
    ap.add_argument("--train-steps", type=int, default=300,
                    help="tiny-LM training steps (ignored with "
                         "--load-quantized)")
    ap.add_argument("--cache", default="auto",
                    choices=("auto", "dense", "paged"),
                    help="cache backend; auto picks paged when --kv-bits "
                         "or --speculate asks for it and dense otherwise, "
                         "as the reference does without a mesh")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--batch-size", type=int, default=3)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--kv-bits", type=int, default=0,
                    help="binary-code the KV page pool at this many bits "
                         "per coefficient (0 = raw fp pages); implies "
                         "the paged cache backend")
    ap.add_argument("--kv-group-size", type=int, default=0,
                    help="head_dim entries per KV scale group (0 = one "
                         "group per head vector); must divide head_dim")
    ap.add_argument("--speculate", type=int, default=0, metavar="K",
                    help="self-speculative decoding: a low-bit draft "
                         "view of the SAME packed weights proposes K "
                         "tokens per tick, one batched target pass "
                         "verifies them (greedy acceptance); implies "
                         "the paged cache backend")
    ap.add_argument("--draft-bits", type=int, default=2,
                    help="code planes the speculative draft keeps "
                         "(< the target's bits); draft scales come "
                         "from the artifact's v4 draft block when "
                         "present, else an on-the-fly LS re-fit")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the device without --mesh (with it, --devices)")
    ap.add_argument("--mesh", default=None, metavar="D,M",
                    help="serve --load-quantized over a (data, model) mesh "
                         "of D x M ranks, e.g. 2,1: the page pool and the "
                         "batch split over D, heads, MLP width and experts "
                         "over M")
    ap.add_argument("--devices", default=None, metavar="DEV,DEV,...",
                    help="with --mesh: each rank's device in rank order "
                         "(default one card a rank; too few cards raise)")
    return ap


def _mesh_shape(text: str):
    d, m = (int(x) for x in text.replace("x", ",").split(","))
    return d, m


def main(argv=None):
    """Parse `argv`, serve, print a summary; returns the engine and its
    finished requests (with --suggest-overrides, the suggested rules;
    with --mesh, each rank's {"rank", "tokens"} in rank order)."""
    ap = _parser()
    args = ap.parse_args(argv)
    paged = args.kv_bits > 0 or args.speculate > 0 or bool(args.mesh)
    if args.cache == "paged":
        paged = True
    elif args.cache == "dense" and paged:
        ap.error("--cache dense conflicts with --mesh/--kv-bits/--speculate "
                 "(each requires the paged backend)")
    if args.devices and not args.mesh:
        ap.error("--devices names a mesh's devices: it needs --mesh")
    if args.mesh:
        if not args.load_quantized:
            ap.error("--mesh serves a packed artifact: each rank loads its "
                     "slice with --load-quantized")
        from repro_torch.dist.context import spawn
        from repro_torch.launch.mesh import make_serve_mesh
        mesh = make_serve_mesh(*_mesh_shape(args.mesh), args.devices)
        print(f"serving over {mesh.describe()}")
        return spawn(serve_rank, mesh, (list(sys.argv[1:] if argv is None
                                             else argv),))

    from repro_torch.data.pretrained import get_trained_lm

    if args.suggest_overrides:
        return suggest(args, get_trained_lm)
    if args.load_quantized:
        if (args.quant or args.save_quantized or args.group_size
                or args.method):
            ap.error("--load-quantized boots the artifact as-is; it is "
                     "incompatible with --quant/--save-quantized/"
                     "--group-size/--method (re-quantize and re-save to "
                     "change them)")
        cfg, params = _load(ap, args)
    else:
        if args.save_quantized and not args.quant:
            ap.error("--save-quantized requires --quant")
        cfg, params = get_trained_lm(args.arch, steps=args.train_steps,
                                     device=args.device)
        if args.quant:
            params = quantize(args, cfg, params)
    draft_params = _draft(args, params) if args.speculate else None
    return _serve(args, cfg, params, paged, draft_params)


def _draft(args, params, mesh=None, cfg=None):
    """--speculate: the --draft-bits draft of `params` with the scales of
    the artifact's v4 draft block (on a mesh, this rank's cut of it),
    else a re-fit: here, or on a mesh by the engine (None), which refits
    a leaf whose rows the model axis splits on its gathered rows."""
    from repro_torch.ckpt.packed import load_draft_scales
    from repro_torch.quant.draft import make_draft_params
    block = (load_draft_scales(args.load_quantized, mesh=mesh,
                               device=None if mesh else args.device,
                               cfg=cfg)
             if args.load_quantized else None)
    if mesh is None or mesh.rank == 0:
        print("draft scales: "
              + ("manifest v4 draft block" if block is not None
                 else "on-the-fly LS re-fit (no v4 draft block)"))
    if mesh is not None and block is None:
        return None
    return make_draft_params(params, args.draft_bits, block)


def _load(ap, args, mesh=None):
    """--load-quantized: (cfg, params), this rank's slice on a mesh."""
    from repro_torch.ckpt.packed import load_packed, packed_meta
    from repro_torch.configs import get_config
    arch = packed_meta(args.load_quantized).get("arch")
    if arch is None:
        ap.error(f"{args.load_quantized}: the artifact's meta names no arch")
    # the config's head counts say how a mesh cuts wk and wv
    params, spec, meta = load_packed(args.load_quantized, mesh=mesh,
                                     device=None if mesh else args.device,
                                     cfg=get_config(arch))
    # the artifact's depth wins over the registry's (fixtures cut n_layers)
    cfg = get_config(arch).replace(dtype="float32",
                                   n_layers=len(params["layers"]))
    desc = f"{spec['method']} w{spec['bits']}" if spec else "unknown spec"
    where = args.device if mesh is None else f"rank {mesh.rank} of the mesh"
    if mesh is None or mesh.rank == 0:
        print(f"loaded packed model '{arch}' ({desc}) from "
              f"{args.load_quantized} on {where}")
    return cfg, params


def serve_rank(mesh, argv):
    """One rank of `--mesh`: load this rank's slice and serve on the mesh
    (rank 0 prints). -> {"rank", "tokens"}."""
    ap = _parser()
    args = ap.parse_args(argv)
    cfg, params = _load(ap, args, mesh)
    draft = _draft(args, params, mesh, cfg) if args.speculate else None
    eng, reqs = _serve(args, cfg, params, True, draft, mesh)
    return {"rank": mesh.rank, "tokens": [r.out for r in reqs]}


def _serve(args, cfg, params, paged, draft_params, mesh=None):
    """Serve the demo requests; prints (on rank 0 of a mesh) the cache,
    the throughput and the first texts. -> (engine, requests)."""
    from repro_torch.data import ByteTokenizer
    from repro_torch.models.attention import paged_kv_page_bytes
    from repro_torch.serve import Request, ServeEngine

    def say(*a):
        if mesh is None or mesh.rank == 0:
            print(*a, flush=True)
    batch = args.batch_size
    if mesh is not None and batch % mesh.shape[0]:
        # every page-pool shard serves an equal slice of the batch
        batch = -(-batch // mesh.shape[0]) * mesh.shape[0]
        say(f"batch_size rounded {args.batch_size} -> {batch} (must split "
            f"over {mesh.shape[0]} data shards)")
    eng = ServeEngine(cfg, params, batch_size=batch, max_len=160,
                      dtype="float32",
                      cache_kind="paged" if paged else "dense",
                      kv_bits=args.kv_bits,
                      kv_group_size=args.kv_group_size,
                      speculate=args.speculate, draft_bits=args.draft_bits,
                      draft_params=draft_params, mesh=mesh,
                      device=None if mesh else args.device)
    if paged:
        kv = eng.kv
        kind = "latent" if cfg.mla is not None else "kv"
        say(f"paged {kind} cache: {kv.n_pages} pages x {kv.page_size} "
            f"tok, {kv.bytes_per_page()} B/page")
        if eng.slab is not None:
            sl = eng.slab
            say(f"state slab pool: {sl.usable_slabs} usable slabs "
                f"({sl.n_shards} reserve), {sl.bytes_per_slab()} B/slab")
    if args.kv_bits:
        kv = eng.kv
        raw = paged_kv_page_bytes(eng.run_cfg, kv.page_size, "float32")
        say(f"quantized KV cache: {args.kv_bits}-bit binary-coded pages, "
            f"{kv.bytes_per_page()} B/page vs {raw} B/page raw "
            f"({raw / kv.bytes_per_page():.1f}x capacity)")
    if mesh is not None:
        kv = eng.kv
        say(f"sharded page pool: {kv.n_shards} shards x "
            f"{kv.pages_per_shard} pages ({kv.usable_in_shard(0)} usable "
            f"+ 1 reserve each, page_size={kv.page_size}); heads, MLP "
            f"width and experts over {mesh.shape[1]} model ranks")
    tok = ByteTokenizer()
    reqs = [Request(prompt=tok.encode(SEEDS[i % len(SEEDS)]),
                    max_new_tokens=args.max_new)
            for i in range(args.requests)]
    eng.run(reqs)
    tput = eng.stats["tokens"] / max(eng.stats["decode_s"], 1e-9)
    where = args.device if mesh is None else mesh.describe()
    say(f"served {len(reqs)} requests, {eng.stats['tokens']} tokens, "
        f"decode throughput {tput:.1f} tok/s ({where})")
    if args.speculate:
        st = eng.stats_snapshot()
        say(f"speculation: k={args.speculate}, w{args.draft_bits} draft, "
            f"{st.accepted_tokens}/{st.draft_tokens} draft tokens "
            f"accepted ({st.acceptance_rate:.2f})")
    for r in reqs[:3]:
        say(" ", repr(tok.decode(r.out)))
    return eng, reqs


def quantize(args, cfg, params):
    """--quant: packed quantization of the trained model, saved with
    --save-quantized (with a w--draft-bits draft block whenever a draft
    is expressible)."""
    from repro_torch.core import quantize_model
    from repro_torch.quant import QuantSpec
    spec = QuantSpec.from_config(cfg.quant, method=args.method or "gptqt",
                                 mode="packed", bits=args.quant,
                                 group_size=args.group_size)
    gdesc = f", group_size={spec.group_size}" if spec.group_size else ""
    print(f"quantizing with {spec.method} to {spec.bits} bits "
          f"(packed{gdesc}) ...")
    params, _ = quantize_model(cfg, params, calibration_batches("wiki"),
                               spec=spec, device=args.device)
    if args.save_quantized:
        from repro_torch.ckpt.packed import save_packed
        d_bits = (args.draft_bits if 0 < args.draft_bits < args.quant
                  else None)
        out = save_packed(args.save_quantized, params, cfg=cfg, spec=spec,
                          meta={"arch": args.arch}, draft_bits=d_bits)
        print(f"saved packed artifact to {out}"
              + (f" (w{d_bits} draft scales included)" if d_bits else ""))
    return params


if __name__ == "__main__":
    main()
