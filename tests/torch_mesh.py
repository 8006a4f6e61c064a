"""Rank bodies of the port's mesh tests (tests/test_torch_sharded_serve.py,
tests/test_torch_train_mesh.py): module-level functions that
repro_torch.dist.context.spawn runs in each rank's process. This module imports torch, the port and chip_smoke.py
(whose record_logits it shares), never JAX, so a spawned rank starts in
a few seconds."""
import importlib.util
import json
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
FIXTURE = ROOT / "tests" / "data" / "torch_port"
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
    k_in, FSDP blocks by field and cut), every leaf of `b` contiguous."""
    if hasattr(a, "fields"):
        return (type(a) is type(b) and a.dims == b.dims
                and a.k_in == b.k_in and _same(a.fields, b.fields))
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


def scales_err(a, b) -> float:
    """The largest |a - b| / max|b| over the scales (alphas, betas) of two
    param trees' QuantizedTensors (or FSDP blocks of them; 0 for a tree
    without any)."""
    if isinstance(a, dict):
        return max((scales_err(a[k], b[k]) for k in a), default=0.0)
    if isinstance(a, list):
        return max(map(scales_err, a, b), default=0.0)
    get = ((lambda t, f: t.fields[f]) if getattr(a, "quantized", False)
           else getattr if hasattr(a, "codes") else None)
    if get is None:
        return 0.0
    return max(float((get(a, f) - get(b, f)).abs().max()
                     / get(b, f).abs().max().clamp_min(1e-30))
               for f in ("alphas", "betas"))


def record_logits(eng, requests) -> list:
    """chip_smoke.py's record_logits (one recording contract for the
    smoke and the tests): (request index, token index, row, the draft
    tokens the row's context holds before it) for every logits row of a
    token of `requests` on this rank."""
    if not _SMOKE:
        spec = importlib.util.spec_from_file_location(
            "chip_smoke", ROOT / "chip_smoke.py")
        _SMOKE.append(importlib.util.module_from_spec(spec))
        spec.loader.exec_module(_SMOKE[0])
    return _SMOKE[0].record_logits(eng, requests)


_SMOKE: list = []


def serve_case(mesh, case: dict) -> dict:
    """Serve one case on this rank: its slice loaded by load_packed(mesh=,
    fsdp=) from a fixture artifact (and held to shard_params of the whole
    tree), or cut by shard_params from the case's own whole params; the
    requests through the paged engine (or the dense one, `cache_kind`),
    speculatively with a w2 self-draft when the case says so (refit at
    boot, or its artifact's v4 draft block loaded with
    load_draft_scales(mesh=, fsdp=)), their logits rows recorded. ->
    tokens, the logits rows this rank computed, the speculation counts,
    the allocator's checks and the resident weight bytes."""
    from repro_torch.ckpt.packed import load_draft_scales, load_packed
    from repro_torch.dist.sharding import shard_params
    from repro_torch.quant.draft import make_draft_params
    from repro_torch.quant.qlinear import tree_tensors
    from repro_torch.serve import Request, ServeEngine
    fsdp = case.get("fsdp", False)
    if "params" in case:
        cfg, whole, art = case["cfg"], case["params"], None
        params = shard_params(cfg, whole, mesh, fsdp=fsdp)
        same_as_shard_params = True
    else:
        art = FIXTURE / case["artifact"]
        params, _, meta = load_packed(art, mesh=mesh, fsdp=fsdp)
        cfg = _config(case["artifact"], params, meta)
        whole, _, _ = load_packed(art, device="cpu")
        same_as_shard_params = _same(shard_params(cfg, whole, mesh, fsdp),
                                     params)
    draft = None
    if case.get("draft") == "block":
        draft = make_draft_params(params, 2, load_draft_scales(
            art, mesh=mesh, fsdp=fsdp))
    paged = case.get("cache_kind", "paged") == "paged"
    eng = ServeEngine(cfg, params, batch_size=2, max_len=64,
                      dtype="float32", cache_kind=case.get("cache_kind",
                                                           "paged"),
                      page_size=case["page_size"], kv_bits=case["kv_bits"],
                      prefix_sharing=case.get("prefix_sharing", False),
                      prefill_chunk=case.get("prefill_chunk"),
                      speculate=case.get("speculate", 0), draft_bits=2,
                      draft_params=draft,
                      accept_rule=case.get("accept_rule", "greedy"),
                      mesh=mesh)
    draft_err = None
    if eng.speculate:
        # this rank's draft scales against the cut of the whole tree's
        # (a refit on the gathered rows of a row-split leaf; a column
        # slice's refit; or the cut draft block)
        from repro_torch.ckpt.packed import load_draft_scales as whole_block
        want = shard_params(cfg, make_draft_params(
            whole, 2, whole_block(art, device="cpu") if draft else None),
            mesh, fsdp)
        draft_err = scales_err(eng.draft_params, want)
    kv, d = eng.kv, mesh.coords[0]
    # the step that reads the block tables: decode, or speculation's verify
    attr = "_verify" if eng.speculate else "_decode"
    step, in_block = getattr(eng, attr), [True]

    def checked(*args):
        rows = kv.block_tables[eng.lo:eng.lo + eng.rows]
        in_block[0] &= bool(((rows == 0) | (rows // kv.pages_per_shard
                                           == d)).all())
        in_block[0] &= int(eng._bt_dev.max()) < kv.pages_per_shard
        return step(*args)
    if paged:
        setattr(eng, attr, checked)
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
    nbytes = lambda tree: sum(t.numel() * t.element_size()
                              for t in tree_tensors(tree))
    return {"tokens": tokens if case.get("waves") else tokens[0],
            "prefix_hits": hits,
            # the rows whose context is the emitted tokens (a verify
            # row after a draft token stands for a token only where the
            # draft was accepted)
            "logits": [(i, t, row.numpy()) for i, t, row, ctx in log
                       if not ctx],
            "same_as_shard_params": same_as_shard_params,
            "pages_in_own_block": in_block[0],
            "drained": all(kv.free_in_shard(s) == kv.usable_in_shard(s)
                           for s in range(kv.n_shards)),
            "n_shards": kv.n_shards, "rows": eng.rows,
            "pool_pages": [leaf.shape[0] for layer in eng.cache
                           for leaf in layer.values()],
            "cache_shapes": [{k: tuple(v.shape) for k, v in layer.items()}
                             for layer in eng.cache],
            "state_shapes": [tuple(leaf.shape) for layer in eng.cache
                             for leaf in layer.values() if leaf.dim() == 3],
            "slabs_drained": (eng.slab is None
                              or eng.slab.live_slabs == 0),
            "slab_bytes": (None if eng.slab is None
                           else eng.slab.bytes_per_slab()),
            "draft_scales_err": draft_err,
            "spec_counts": (eng.stats["draft_tokens"],
                            eng.stats["accepted_tokens"],
                            eng.stats["ticks"]),
            # resident weight bytes: this rank's, and its slice's without
            # the data-axis cut
            "param_bytes": nbytes(eng.params),
            "slice_bytes": nbytes(shard_params(cfg, whole, mesh)),
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


# --------------------------------------------------------------------------
# training on a mesh (tests/test_torch_train_mesh.py)
# --------------------------------------------------------------------------

def train_config(case):
    """The case's config, fp32, remat full: the registry's cut to 2
    layers, or with `smoke` the reduced config of its family (one
    super-block of depth)."""
    from repro_torch.configs import get_config, smoke_config
    if case.get("smoke"):
        return smoke_config(case["arch"]).replace(
            dtype="float32", remat="full", **case.get("kw", {}))
    return get_config(case["arch"]).replace(
        dtype="float32", n_layers=2, remat="full", **case.get("kw", {}))


def train_case(mesh, case: dict) -> dict:
    """Train one case on this rank of the bound `mesh`: the seeded whole
    init (seed 0) cut by shard_train_state, `case["batches"]` (numpy: token
    ids, or frames of a frame-input config)
    through make_train_step(mesh=, fsdp=), or through a Trainer
    (`ckpt`: resume from the directory's checkpoint, and with `save_at`
    save there at that step). -> the losses, a MoE config's (aux loss,
    dropped pairs) a step, the whole trained state (gather_train_state,
    numpy), the shapes this rank held and the collectives of its
    steps."""
    from repro_torch.ckpt import stack_params
    from repro_torch.dist.context import mesh_context
    from repro_torch.dist.sharding import gather_train_state, shard_train_state
    from repro_torch.models import init_params
    from repro_torch.train import (AdamWConfig, Trainer, TrainerConfig,
                                   init_train_state, make_train_step)
    from repro_torch.tree import keystr, leaves_with_paths
    cfg = train_config(case)
    opt_cfg = AdamWConfig(lr=1e-3, master_fp32=case.get("master", False))
    fsdp, mb = case.get("fsdp", True), case.get("microbatches", 1)
    batches = case["batches"]
    mesh.counts.clear()
    with mesh_context(mesh):
        if "ckpt" in case:
            steps = case.get("save_at") or len(batches)
            tr = Trainer(cfg, TrainerConfig(
                steps=steps, ckpt_every=10 ** 9, ckpt_dir=case["ckpt"],
                log_every=10 ** 9, microbatches=mb, warmup=case["warmup"],
                opt=opt_cfg), iter(batches[case.get("start", 0):]),
                dtype="float32", device="cpu", mesh=mesh, fsdp=fsdp)
            out = tr.run()
            params, opt = tr.params, tr.opt_state
            losses = [m["loss"] for m in tr.metrics_log]
            norms, resumed, moe = None, out["resumed"], []
        else:
            whole = stack_params(cfg, init_params(cfg, seed=0, device="cpu"))
            params, opt = shard_train_state(
                cfg, whole, init_train_state(cfg, whole, opt_cfg), mesh, fsdp)
            step = make_train_step(
                cfg, opt_cfg, microbatches=mb, warmup=case["warmup"],
                grad_compress=case.get("grad_compress", "none"), mesh=mesh,
                fsdp=fsdp)
            losses, norms, moe = [], [], []
            for b in batches:
                params, opt, m = step(params, opt, b)
                losses.append(float(m["loss"]))
                norms.append(float(m["grad_norm"]))
                if "moe_dropped" in m:
                    moe.append((float(m["aux"]), float(m["moe_dropped"])))
            resumed = False
        counts = dict(mesh.counts)
        held = {"params": {k: tuple(v.shape)
                           for k, v in leaves_with_paths(params)},
                "opt": {k: tuple(v.shape)
                        for k, v in leaves_with_paths(opt)}}
        P, O = gather_train_state(cfg, params, opt, mesh, fsdp)
    to_np = {keystr(k): v.detach().numpy() for k, v in leaves_with_paths(
        {"params": P, "opt": O})}
    return {"losses": losses, "grad_norms": norms, "moe": moe,
            "state": to_np if mesh.rank == 0 else None,
            "held": held, "counts": counts, "resumed": resumed,
            "coords": mesh.coords}


def gathered_alive(mesh, case: dict) -> dict:
    """How many weights the FSDP forward gathered (FsdpLeaf.gather's
    outputs) are still alive once the training forward has run (its
    loss recorded by autograd), and once the backward has: the gather
    runs inside each layer's activation checkpoint, so neither should
    keep any (a gather outside it would keep every layer's until the
    backward)."""
    import gc
    import weakref
    from repro_torch.ckpt import stack_params
    from repro_torch.dist.context import mesh_context
    from repro_torch.dist.fsdp import FsdpLeaf, fsdp_view
    from repro_torch.dist.sharding import TrainLayout
    from repro_torch.models import init_params
    from repro_torch.models.model import loss_fn
    from repro_torch.tree import leaves, tree_map
    cfg = train_config(case)
    lay = TrainLayout(cfg, mesh)
    params, _ = lay.shard(stack_params(cfg, init_params(cfg, device="cpu")),
                          {})
    live = tree_map(lambda a: a.detach().requires_grad_(), params)
    refs, gather = [], FsdpLeaf.gather

    def recorded(self, mesh=None):
        out = gather(self, mesh)
        refs.append(weakref.ref(out))
        return out
    b = case["batches"][0]
    batch = {k: torch.from_numpy(v[:2]) for k, v in b.items()}
    FsdpLeaf.gather = recorded
    try:
        with mesh_context(mesh):
            loss, _ = loss_fn(lay.rank_cfg, fsdp_view(
                live, lay.data_dims(), lay.D), batch)
            gc.collect()
            after_forward = sum(r() is not None for r in refs)
            n_forward = len(refs)
            loss.backward()
    finally:
        FsdpLeaf.gather = gather
    gc.collect()
    return {"gathered": n_forward, "alive_after_forward": after_forward,
            "gathered_in_backward": len(refs) - n_forward,
            "alive_after_backward": sum(r() is not None for r in refs),
            "grads": sum(a.grad is not None for a in leaves(live))}


def train_meshes(world, plan) -> list:
    """Every training mesh of `plan` ([(mesh shape, first rank, stage,
    cases)]) in one spawn: each rank makes every sub-mesh, in plan
    order, then stage by stage trains the cases of the meshes it
    belongs to (meshes of one stage on disjoint ranks side by side) and
    waits at a barrier after each stage. -> {(shape, case id): result}
    of this rank's cases."""
    import torch.distributed as dist
    subs = [world.submesh(*shape, first=first) for shape, first, _, _
            in plan]
    out = {}
    for stage in sorted({p[2] for p in plan}):
        for sub, (shape, _, st, cases) in zip(subs, plan):
            if st != stage or sub is None:
                continue
            for key, case in cases.items():
                fn = gathered_alive if case.get("alive") else train_case
                out[(shape, key)] = fn(sub, case)
        dist.barrier()
    return out

