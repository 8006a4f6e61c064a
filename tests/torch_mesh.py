"""Rank bodies of the port's mesh tests (tests/test_torch_sharded_serve.py):
module-level functions that repro_torch.dist.context.spawn runs in each
rank's process. This module imports torch and the port only, never JAX,
so a spawned rank starts in a few seconds."""
import json
from pathlib import Path

import numpy as np
import torch

FIXTURE = Path(__file__).resolve().parent / "data" / "torch_port"
REF = json.loads((FIXTURE / "reference.json").read_text())
ZOO = json.loads((FIXTURE / "zoo" / "zoo.json").read_text())


def _config(name, params, meta):
    from repro_torch.configs import get_config, smoke_config
    if name.startswith("zoo/"):
        ent = ZOO["artifacts"][name[4:]]
        cfg = smoke_config(ent["arch"]).replace(dtype="float32")
        if ent["bits"] is not None:
            import dataclasses
            cfg = cfg.replace(quant=dataclasses.replace(cfg.quant,
                                                        bits=ent["bits"]))
        return cfg
    return get_config(meta["arch"]).replace(dtype="float32",
                                            n_layers=len(params["layers"]))


def _same(a, b) -> bool:
    """Two param trees equal leaf for leaf (QuantizedTensors by field and
    k_in), every leaf of `b` contiguous."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(map(_same, a, b))
    if hasattr(a, "codes"):
        return a.k_in == b.k_in and all(
            torch.equal(getattr(a, f), getattr(b, f))
            and getattr(b, f).is_contiguous()
            for f in ("codes", "alphas", "betas"))
    return torch.equal(a, b) and b.is_contiguous()


def record_logits(eng, requests) -> list:
    """Wrap a paged engine's first-token and decode paths so that every
    logits row a token of `requests` is taken from on this rank lands in
    the returned list as (request index, token index, row)."""
    index = {id(r): i for i, r in enumerate(requests)}
    log, emit, decode = [], eng._emit_first_token, eng._decode

    def first(e, last_logits, prompt_len):
        if last_logits is not None:
            log.append((index[id(e.req)], len(e.req.out),
                        last_logits[0].float().cpu()))
        return emit(e, last_logits, prompt_len)

    def step(*args):
        logits, cache = decode(*args)
        for r in np.flatnonzero(np.asarray(args[5])):   # the live rows
            req = eng.sched.running[eng.lo + int(r)].req
            log.append((index[id(req)], len(req.out),
                        logits[r].float().cpu()))
        return logits, cache
    eng._emit_first_token, eng._decode = first, step
    return log


def serve_case(mesh, case: dict) -> dict:
    """Serve one fixture case on this rank: its slice loaded by
    load_packed(mesh=) (and held to shard_params of the whole tree), the
    requests through the paged engine, their logits rows recorded. ->
    tokens, the logits rows this rank computed, and the allocator's
    checks."""
    from repro_torch.ckpt.packed import load_packed
    from repro_torch.dist.sharding import shard_params
    from repro_torch.serve import Request, ServeEngine
    art = FIXTURE / case["artifact"]
    params, _, meta = load_packed(art, mesh=mesh)
    cfg = _config(case["artifact"], params, meta)
    whole, _, _ = load_packed(art, device="cpu")
    same_as_shard_params = _same(shard_params(cfg, whole, mesh), params)
    eng = ServeEngine(cfg, params, batch_size=2, max_len=64,
                      dtype="float32", cache_kind="paged",
                      page_size=case["page_size"], kv_bits=case["kv_bits"],
                      prefix_sharing=case.get("prefix_sharing", False),
                      prefill_chunk=case.get("prefill_chunk"),
                      mesh=mesh)
    kv, d = eng.kv, mesh.coords[0]
    decode, in_block = eng._decode, [True]

    def checked(*args):
        rows = kv.block_tables[eng.lo:eng.lo + eng.rows]
        in_block[0] &= bool(((rows == 0) | (rows // kv.pages_per_shard
                                           == d)).all())
        in_block[0] &= int(eng._bt_dev.max()) < kv.pages_per_shard
        return decode(*args)
    eng._decode = checked
    tokens, log = [], []
    for wave in case.get("waves") or [case["prompts"]]:
        reqs = [Request(prompt=np.asarray(p, np.int32),
                        max_new_tokens=case["max_new"]) for p in wave]
        if not case.get("waves"):
            log = record_logits(eng, reqs)
        eng.run(reqs)
        tokens.append([r.out for r in reqs])
    hits = eng.stats.get("prefix_hits", 0)
    if eng._prefix is not None:
        eng._prefix.clear()
    return {"tokens": tokens if case.get("waves") else tokens[0],
            "prefix_hits": hits,
            "logits": [(i, t, row.numpy()) for i, t, row in log],
            "same_as_shard_params": same_as_shard_params,
            "pages_in_own_block": in_block[0],
            "drained": all(kv.free_in_shard(s) == kv.usable_in_shard(s)
                           for s in range(kv.n_shards)),
            "n_shards": kv.n_shards, "rows": eng.rows,
            "pool_pages": [leaf.shape[0] for layer in eng.cache
                           for leaf in layer.values()],
            "collectives": dict(mesh.counts)}


def serve_cases(mesh, cases) -> dict:
    """Every case of a mesh in one spawn: {case id: serve_case(...)}."""
    out = {}
    for key, case in cases.items():
        mesh.counts.clear()
        out[key] = serve_case(mesh, case)
    return out



def fail_on_rank_1(mesh):
    """Rank 1 raises; rank 0 waits in a collective it never joins."""
    if mesh.rank == 1:
        raise ValueError("rank 1 refuses")
    from repro_torch.dist.context import gather_data
    return gather_data(torch.zeros(1), mesh)
