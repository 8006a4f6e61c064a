"""Serving launcher: boots a GPTQT-packed artifact and serves a demo
request batch through the continuous-batching engine.

  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --load-quantized DIR [--cache auto|dense|paged] [--requests N] \\
      [--batch-size B] [--max-new T] [--kv-bits BITS] \\
      [--kv-group-size GS] [--speculate K] [--draft-bits D] \\
      [--device cuda|cpu]

The artifact is read by ckpt.packed.load_packed (manifests v1-v4, as
the reference writes them); the model config is the registry entry its
meta "arch" names (any decoder of the zoo: attention, MLA, Mamba or
hybrid, dense or MoE MLPs), at the artifact's own depth. An artifact the port
quantized (core.api.quantize_model, then ckpt.packed.save_packed)
serves the same way; the quantize flags arrive with training (ROADMAP
Queue 1 item 7) and --mesh with multi-GPU (item 6). `--speculate K`
serves self-speculatively: a `--draft-bits D` view of the same packed
codes proposes K tokens a tick, with the scales of the artifact's v4
draft block when it has one and an LS re-fit otherwise (the launcher
says which).
"""
from __future__ import annotations

import argparse

SEEDS = ["the ancient city", "a famous museum", "this railway",
         "the council", "another region", "the early dynasty"]


def main(argv=None):
    """Parse `argv`, serve, print a summary; returns the engine and its
    finished requests."""
    ap = argparse.ArgumentParser(prog="repro_torch.launch.serve")
    ap.add_argument("--load-quantized", required=True, metavar="DIR",
                    help="packed artifact directory (ckpt/packed.py)")
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
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    paged = args.kv_bits > 0 or args.speculate > 0
    if args.cache == "paged":
        paged = True
    elif args.cache == "dense" and paged:
        ap.error("--cache dense conflicts with --kv-bits/--speculate "
                 "(each requires the paged backend)")

    from repro_torch.ckpt.packed import load_packed
    from repro_torch.configs import get_config
    from repro_torch.data import ByteTokenizer
    from repro_torch.models.attention import paged_kv_page_bytes
    from repro_torch.serve import Request, ServeEngine

    params, spec, meta = load_packed(args.load_quantized, device=args.device)
    arch = meta.get("arch")
    if arch is None:
        ap.error(f"{args.load_quantized}: the artifact's meta names no arch")
    # the artifact's depth wins over the registry's (fixtures cut n_layers)
    cfg = get_config(arch).replace(dtype="float32",
                                   n_layers=len(params["layers"]))
    desc = (f"{spec['method']} w{spec['bits']}" if spec else "unknown spec")
    print(f"loaded packed model '{arch}' ({desc}) from "
          f"{args.load_quantized} on {args.device}")
    draft_params = None
    if args.speculate:
        from repro_torch.ckpt.packed import load_draft_scales
        from repro_torch.quant.draft import make_draft_params
        scales_tree = load_draft_scales(args.load_quantized,
                                        device=args.device)
        print("draft scales: "
              + ("manifest v4 draft block" if scales_tree is not None
                 else "on-the-fly LS re-fit (no v4 draft block)"))
        draft_params = make_draft_params(params, args.draft_bits,
                                         scales_tree)
    eng = ServeEngine(cfg, params, batch_size=args.batch_size, max_len=160,
                      dtype="float32",
                      cache_kind="paged" if paged else "dense",
                      kv_bits=args.kv_bits,
                      kv_group_size=args.kv_group_size,
                      speculate=args.speculate, draft_bits=args.draft_bits,
                      draft_params=draft_params, device=args.device)
    if paged:
        kv = eng.kv
        kind = "latent" if cfg.mla is not None else "kv"
        print(f"paged {kind} cache: {kv.n_pages} pages x {kv.page_size} "
              f"tok, {kv.bytes_per_page()} B/page")
        if eng.slab is not None:
            sl = eng.slab
            print(f"state slab pool: {sl.usable_slabs} usable slabs "
                  f"({sl.n_shards} reserve), {sl.bytes_per_slab()} B/slab")
    if args.kv_bits:
        kv = eng.kv
        raw = paged_kv_page_bytes(cfg, kv.page_size, "float32")
        print(f"quantized KV cache: {args.kv_bits}-bit binary-coded pages, "
              f"{kv.bytes_per_page()} B/page vs {raw} B/page raw "
              f"({raw / kv.bytes_per_page():.1f}x capacity)")
    tok = ByteTokenizer()
    reqs = [Request(prompt=tok.encode(SEEDS[i % len(SEEDS)]),
                    max_new_tokens=args.max_new)
            for i in range(args.requests)]
    eng.run(reqs)
    tput = eng.stats["tokens"] / max(eng.stats["decode_s"], 1e-9)
    print(f"served {len(reqs)} requests, {eng.stats['tokens']} tokens, "
          f"decode throughput {tput:.1f} tok/s ({args.device})")
    if args.speculate:
        st = eng.stats_snapshot()
        print(f"speculation: k={args.speculate}, w{args.draft_bits} draft, "
              f"{st.accepted_tokens}/{st.draft_tokens} draft tokens "
              f"accepted ({st.acceptance_rate:.2f})")
    for r in reqs[:3]:
        print(" ", repr(tok.decode(r.out)))
    return eng, reqs


if __name__ == "__main__":
    main()
