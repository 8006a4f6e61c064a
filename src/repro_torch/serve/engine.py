"""Batched serving engine: continuous batching over prefill and greedy
decode with two cache backends behind one switch (the reference's
`serve/engine.py`).

  cache_kind="dense"  — `batch_size` sequences, each owning a dense
    max_len KV slab.
  cache_kind="paged"  — block-table paged KV (serve/kv_cache.py): all
    sequences share one page pool and admission is gated on free pages.
    Prefill runs on the bucket-padded prompt and its K/V is scattered
    into the sequence's pages; every decode step runs the paged-attention
    kernel over the pool. `kv_bits > 0` binary-codes the pool
    (quant/kv.py): K/V are quantized on write and the fused-dequant
    kernel reads the codes. With prefix sharing (the default) a radix
    index (serve/prefix_cache.py) maps completed prompt pages to token
    prefixes: a request with an N-token cached prefix attaches those
    pages by reference, prefills only its suffix through the extend
    path (models/model.py:extend_paged), and allocates only its suffix
    pages; a shared page forks copy-on-write before any write.
    `prefill_chunk` prefills prompts through the same extend path, one
    chunk of one sequence per engine tick, so long prompts do not stall
    decode; sliding-window layers always prefill through it. MLA pages
    its compressed latents through the same block tables, forks and
    prefix index; Mamba layers keep their recurrent state in per-slot
    rows, and a StateSlabPool (serve/state_slab.py) admits a sequence
    only when a state slab is free, as pages gate K/V.

Both run on the FCFS Scheduler (serve/scheduler.py). Works with plain
weights or GPTQT-packed QuantizedTensor weights (dense or MoE expert
stacks): `layers.linear` and `models/moe.py` dispatch per leaf. Prompt
lengths are padded to power-of-two buckets (attention-only patterns
without windows), as the reference does to bound its compilations; the
port keeps the buckets so that both run the same shapes. Padding would
mix pad tokens into rolling windows and recurrent state, so window and
Mamba configs prefill at exact length, as in the reference.

Decode always runs the full (batch_size,) row batch: rows without a
ready sequence are routed to the null page 0 through their block-table
row and keep an arbitrary position, so their K/V writes land in the
null page (the reference's live-row / null-row trick,
`serve/compile_cache.py` "decode_paged").

Self-speculative decoding (`speculate=k`, paged only): a draft, by
default a view of the target's own packed codes at `draft_bits` planes
with re-fit scales (quant/draft.py), proposes k tokens a tick through
k draft decode steps (models/model.py:draft_propose_paged), one target
pass over the k+1 positions verifies them (verify_paged), and the
engine keeps the longest agreeing prefix plus the target's own token.
The verify pass overwrites every K/V slot the draft wrote, so greedy
output equals target-only decode whatever the draft; rejected tokens
roll back through `kv.truncate`. `accept_rule="typical"` keeps a draft
token the target gives at least `typical_tau` of its argmax's
probability (lossy for an imperfect draft, as in the reference).
`stats_snapshot()` freezes every counter into a serve/stats.py
EngineStats.

Every step function is borrowed from the process-wide
serve/compile_cache.py, with the reference's kinds in the reference's
order, so engines of one config share their wrappers. On the card the
decode step, the draft's propose pass and verify replay CUDA graphs
captured on their first call (one launch a step instead of a Python
loop of ~2,000), fed from the engine's host arrays through pinned
memory; prefill, extend, scatter, page copies and block-table pushes
run eagerly, as everything does on the CPU. Nothing but graphs pads to
a shape, so copy lists and dirty-row lists are not padded to powers of
two as the reference pads them to bound its compilations; timing
synchronizes the CUDA device where the reference blocks on its result.
Only greedy decode exists (`greedy=False` raises).

Mesh serving (`mesh=`, a bound dist/context.py ServeMesh: the engine
runs in every rank of the mesh, as dist/context.py:spawn or
launch/serve.py starts them). Every rank runs the same scheduler over
the whole batch, with the reference's global page ids and per-shard
accounting (serve/kv_cache.py `n_shards` = the data axis), so every
rank makes the same admission, allocation and preemption decisions.
Data rank d owns slots [d*B/D, (d+1)*B/D) and holds only block d of the
page pool (and of the Mamba state rows), indexed by local page ids (its
reserve page is local 0): it runs the prefill, extend, scatter, fork
and decode work of its own slots and nothing else. The model axis
splits heads, MLP width and experts (params sliced by
ckpt/packed.py:load_packed(mesh=) or dist/sharding's shard_params; the
steps run on models/model.py:shard_config's config), with the model
group's all-reduces inside the model. After each decode step the
sampled tokens are all-gathered over the data group, and a first token
is broadcast from its slot's data rank, so every rank's scheduler sees
every sequence; a speculative tick all-gathers each row's accepted
tokens instead (the verify logits are whole on every model rank, so
every model rank accepts the same). A self-draft refit on a model axis
refits a row-split per-channel leaf on its gathered rows, so its scales
are the single device's. Where the model axis does not divide the KV
heads, every model rank holds the whole pool (replicated, as the rule
says) and its query heads read theirs; a dense cache the rule splits
along the sequence holds the rank's positions (models/attention.py).

Weights sharded over the data axis too (load_packed(mesh=, fsdp=True),
dist/fsdp.py) are all-gathered over the data group layer by layer
inside every pass, so the data ranks run their passes in lockstep: a
rank whose shard holds no row of a pass (another shard's prefill, or a
decode step with none of its rows ready) joins it with masked rows (the
same prompt with no page of its own, or every row on the null page) and
drops the result. Under a model axis > 1, and on an FSDP mesh, the
decode steps run eagerly: gloo's collectives cannot be captured in a
CUDA graph; a data-only mesh of replicated weights replays graphs as
one device does (serve/compile_cache.py).
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.dist.context import (broadcast_data, gather_data,
                                      gather_model, mesh_context)
from repro_torch.dist.fsdp import FsdpLeaf, gather_tree, is_fsdp
from repro_torch.dist.sharding import (cache_pspec, cut_data, cuts_k,
                                      local_shape)
from repro_torch.hw import resolve_device
from repro_torch.models.attention import seq_block
from repro_torch.models.model import (init_cache, init_paged_cache,
                                      require_decoder, shard_config)
from repro_torch.quant.draft import make_draft_params, refit_draft_scales
from repro_torch.quant.qlinear import QuantizedTensor
from repro_torch.serve import compile_cache
from repro_torch.serve.kv_cache import PagedKVCache
from repro_torch.serve.prefix_cache import RadixPrefixCache
from repro_torch.serve.scheduler import Scheduler
from repro_torch.serve.state_slab import StateSlabPool

MIN_BUCKET = 8


def bucket_len(n: int, cap: int) -> int:
    """Smallest power-of-two >= n (floor MIN_BUCKET), clamped to cap."""
    b = MIN_BUCKET
    while b < n:
        b *= 2
    return min(b, cap)


def params_to(params, device):
    """The param tree (dicts, lists, tensors, QuantizedTensors) on
    `device`; leaves already there are not copied."""
    if isinstance(params, dict):
        return {k: params_to(v, device) for k, v in params.items()}
    if isinstance(params, list):
        return [params_to(v, device) for v in params]
    return params.to(device)


def _has_quantized(params) -> bool:
    if isinstance(params, FsdpLeaf):
        return params.quantized
    if isinstance(params, dict):
        return any(_has_quantized(v) for v in params.values())
    if isinstance(params, list):
        return any(_has_quantized(v) for v in params)
    return isinstance(params, QuantizedTensor)


@dataclass
class Request:
    prompt: np.ndarray
    max_new_tokens: int = 32
    eos: int | None = None
    out: list = field(default_factory=list)
    done: bool = False


class DenseSlotPool:
    """Slot accounting so the Scheduler drives the dense engine too: one
    fixed max_len 'page' per sequence, and one trivial shard for the
    scheduler's shard protocol."""

    n_shards = 1

    def __init__(self, n_slots: int):
        self.max_seqs = n_slots
        self._active = np.zeros((n_slots,), bool)
        self.high_water = 0
        self.usable_pages = n_slots

    def pages_for(self, n_tokens: int) -> int:
        return 1

    @property
    def free_page_count(self) -> int:
        return int((~self._active).sum())

    @property
    def used_pages(self) -> int:
        return int(self._active.sum())

    # shard protocol (one shard)
    def shard_of_slot(self, slot: int) -> int:
        return 0

    def pick_shard(self):
        return 0 if self.free_page_count else None

    def free_in_shard(self, shard: int) -> int:
        return self.free_page_count

    def usable_in_shard(self, shard: int) -> int:
        return self.usable_pages

    def alloc_slot(self, shard=None):
        for i in range(self.max_seqs):
            if not self._active[i]:
                self._active[i] = True
                self.high_water = max(self.high_water, self.used_pages)
                return i
        return None

    def owned_pages(self, slot: int):
        return [slot] if self._active[slot] else []

    def release(self, slot: int) -> None:
        self._active[slot] = False


class ServeEngine:
    def __init__(self, cfg, params, *, batch_size=4, max_len=512,
                 dtype=None, greedy=True, cache_kind="dense",
                 page_size=64, n_pages=None, prefill_chunk=None,
                 bucket_prompts=True, watermark=1, prefix_sharing=True,
                 prefix_max_pages=None, mesh=None, kv_bits=0,
                 kv_group_size=0, speculate=0, draft_bits=2,
                 draft_params=None, accept_rule="greedy", typical_tau=0.3,
                 state_slabs=None, device=None):
        if not greedy:
            raise NotImplementedError(
                "greedy=False: only greedy decode exists (the reference "
                "stores the flag and never reads it)")
        if cache_kind not in ("dense", "paged"):
            raise ValueError(f"cache_kind={cache_kind!r}")
        if kv_bits and cache_kind != "paged":
            raise ValueError(
                "kv_bits requires cache_kind='paged': the binary-coded "
                "KV layout lives in the page pool (quantize-on-write "
                "needs page-granular scatter)")
        if prefill_chunk and cache_kind != "paged":
            raise NotImplementedError(
                "chunked prefill requires cache_kind='paged'")
        if speculate and cache_kind != "paged":
            raise ValueError(
                "speculate requires cache_kind='paged': draft KV is "
                "written speculatively into the page pool and rejected "
                "tokens roll back by page truncation")
        if accept_rule not in ("greedy", "typical"):
            raise ValueError(
                f"accept_rule={accept_rule!r}; expected 'greedy' or "
                f"'typical'")
        require_decoder(cfg)
        D, M = (1, 1) if mesh is None else mesh.shape
        if mesh is not None:
            if mesh.rank is None:
                raise ValueError("an unbound mesh: the engine runs inside "
                                 "each rank (dist.context.spawn binds it)")
            if batch_size % D:
                raise ValueError(
                    f"batch_size={batch_size} must divide over the "
                    f"{D}-way data axis so every sequence slot maps to "
                    f"exactly one page-pool shard")
            if device is not None and resolve_device(device) != mesh.device:
                raise ValueError(f"device={device!r}, but this rank of "
                                 f"the mesh is on {mesh.device}")
            device = mesh.device
        # MLA counts as attention here: its latent pages ride the same
        # block tables, forks and prefix index, and it has an extend path
        attn_only = all(s.kind == "attn" for s in cfg.pattern)
        no_window = all(s.window is None for s in cfg.pattern)
        if speculate and (not attn_only or cfg.mla is not None):
            raise NotImplementedError(
                "speculate>0 verifies k+1 positions through the paged "
                "extend path, which needs a standard attention-only "
                "pattern (MLA drafts are not wired up)")
        self.device = resolve_device(device)
        self.cfg = cfg
        # the config this rank's steps run: its heads, MLP width and
        # experts of the model axis (cfg itself without a mesh)
        self.run_cfg = shard_config(
            cfg, M, dense_len=max_len if cache_kind == "dense" else 0)
        self.mesh = mesh
        self.params = params_to(params, self.device)
        # weights sharded over the data axis: passes in lockstep
        self.fsdp = mesh is not None and is_fsdp(self.params)
        if mesh is not None:
            self._check_local_params()
        self.B = batch_size
        # this rank's batch rows: slots [lo, lo + rows) of the data axis
        self.rows = batch_size // D
        self.lo = (mesh.coords[0] if mesh is not None else 0) * self.rows
        self.max_len = max_len
        self.greedy = greedy
        self.cache_kind = cache_kind
        self.kv_bits = int(kv_bits)
        self.prefill_chunk = prefill_chunk
        dtype = dtype or cfg.dtype
        # bucketed prefill needs harmless padding: causal attention masks
        # it and decode overwrites its slots, but rolling windows and
        # recurrent state mix pad tokens in
        self._bucket = bool(bucket_prompts and attn_only and no_window)
        # window layers: prefill()'s rolling buffer cannot be scattered
        # into absolute page slots, so the paged engine prefills them
        # through the extend path
        self._extend_prefill = cache_kind == "paged" and \
            (bool(prefill_chunk) or not no_window)
        self._prefix = None
        self.slab = None
        rcfg = self.run_cfg
        if cache_kind == "paged":
            if self._extend_prefill and not attn_only:
                raise NotImplementedError(
                    "paged prefill via extend (chunked or sliding-window) "
                    "needs an attention-only pattern")
            # the pool's shards: the data axis (page blocks live on the
            # ranks whose batch rows use them)
            n_shards = D
            pages_per_seq = -(-max_len // page_size)
            if n_pages is None:
                # the dense engine's byte budget + one reserve page a shard
                n_pages = batch_size * pages_per_seq + n_shards
            n_pages = -(-n_pages // n_shards) * n_shards
            self.kv = PagedKVCache(rcfg, n_pages=n_pages, page_size=page_size,
                                   max_seqs=batch_size,
                                   max_pages_per_seq=pages_per_seq,
                                   dtype=dtype, create_pool=mesh is None,
                                   n_shards=n_shards, kv_bits=kv_bits,
                                   kv_group_size=kv_group_size,
                                   device=self.device)
            self.page_size = page_size
            # recurrent layers: one state slab a sequence, under the
            # page allocator's invariants (+1 a shard: its reserve slab)
            if not attn_only:
                n_slabs = (batch_size + n_shards if state_slabs is None
                           else int(state_slabs))
                n_slabs = -(-n_slabs // n_shards) * n_shards
                self.slab = StateSlabPool(rcfg, n_slabs=n_slabs,
                                          max_seqs=batch_size,
                                          n_shards=n_shards, dtype=dtype)
            # prefix sharing skips matched prefill through the extend
            # path, so it needs an attention-only pattern too
            if prefix_sharing and attn_only:
                self._prefix = RadixPrefixCache(
                    self.kv, max_cached_pages=prefix_max_pages)
            if mesh is None:
                self.cache = self.kv.take_pool()
            else:
                # this rank's block of the pool: pages_per_shard pages of
                # its kv heads, and its rows of Mamba state
                self.cache = init_paged_cache(
                    rcfg, self.kv.pages_per_shard, page_size, self.rows,
                    dtype, kv_bits=kv_bits, kv_group_size=kv_group_size,
                    device=self.device)
                self._check_local_cache(init_paged_cache(
                    cfg, n_pages, page_size, batch_size, dtype,
                    kv_bits=kv_bits, kv_group_size=kv_group_size,
                    device="meta"))
            # device mirror of this rank's block-table rows (local page
            # ids): rows are pushed only when the allocator bumps their
            # version
            self._bt_dev = torch.zeros((self.rows, pages_per_seq),
                                       dtype=torch.int32, device=self.device)
            self._bt_applied = np.full((batch_size,), -1, np.int64)
            # every row's null page: its shard's reserve, local page 0
            self._null_row = torch.zeros((self.rows,), dtype=torch.int32,
                                         device=self.device)
            self._bt_update = compile_cache.get("bt_update", None, mesh)
            self._decode = compile_cache.get("decode_paged", rcfg, mesh,
                                             self.fsdp)
            self._scatter = compile_cache.get("scatter_prefill", rcfg, mesh)
            self._extend = compile_cache.get("extend_paged", rcfg, mesh,
                                             self.fsdp)
            self._copy = compile_cache.get("copy_pages", None, mesh)
            if speculate:
                self._draft_propose = compile_cache.get(
                    "draft_propose", rcfg, mesh, self.fsdp)
                self._verify = compile_cache.get("verify_paged", rcfg, mesh,
                                                 self.fsdp)
        else:
            # the dense engine has no pages to share: prefix_sharing is
            # accepted and ignored, as in the reference
            self.kv = DenseSlotPool(batch_size)
            self.cache = init_cache(rcfg, self.rows, max_len, dtype,
                                    device=self.device)
            if mesh is not None:
                self._check_local_cache(init_cache(
                    cfg, batch_size, max_len, dtype, device="meta"))
                self._whole_wkv_b()
            self._decode = compile_cache.get("decode_dense", rcfg, mesh,
                                             self.fsdp)
        # spare pages (the watermark) keep a decode tick's growth from
        # starving at once; the dense engine has none
        self.sched = Scheduler(self.kv, watermark=watermark
                               if cache_kind == "paged" else 0,
                               prefill_chunk=prefill_chunk,
                               prefix=self._prefix, slab=self.slab)
        self.pos = np.zeros((batch_size,), np.int32)
        self.cur = np.zeros((batch_size,), np.int32)
        self._prefill = compile_cache.get("prefill", rcfg, mesh, self.fsdp)
        # self-speculative decoding: built from the params on the
        # device, so a self-draft's codes are the target's tensors and
        # it adds only its re-fit scales (quant/draft.py)
        self.speculate = int(speculate)
        self.draft_bits = int(draft_bits)
        self.accept_rule = accept_rule
        self.typical_tau = float(typical_tau)
        self.draft_params = None
        self.draft_build_s = 0.0
        if self.speculate:
            t0 = time.time()
            if draft_params is None:
                if not _has_quantized(self.params):
                    raise ValueError(
                        "speculate>0 needs GPTQT-quantized params (the "
                        "draft is a code-plane prefix of the target) or "
                        "an explicit draft_params tree")
                # a model rank holding some rows of a per-channel
                # leaf (or an FSDP block of a leaf) refits it whole, as
                # one device does
                draft_params = make_draft_params(
                    self.params, self.draft_bits,
                    self._whole_row_scales()
                    if M > 1 or self.fsdp else None)
            self.draft_params = params_to(draft_params, self.device)
            self._sync()
            self.draft_build_s = time.time() - t0
        # raw accumulators; stats_snapshot() freezes them with the pool
        # and index counters into an EngineStats
        self.stats = {"prefill_s": 0.0, "decode_s": 0.0, "tokens": 0,
                      "ticks": 0, "prefill_tokens": 0,
                      "draft_tokens": 0, "accepted_tokens": 0}
        self._entries = []

    # ---------------- mesh geometry ----------------
    def _check_local_params(self) -> None:
        """This rank's weights must be its slice (load_packed(mesh=) or
        shard_params): the first layer's mixer has the shard config's
        output width (wq's query heads, MLA's wq_b, Mamba's in_proj)."""
        rcfg = self.run_cfg
        spec, lp = rcfg.pattern[0], self.params["layers"][0]
        if spec.kind != "attn":
            name, want = "in_proj", 2 * rcfg.d_inner
            w = lp["mamba"][name]
        else:
            m = rcfg.mla
            name = "wq" if m is None else "wq_b"
            hd = (rcfg.resolved_head_dim if m is None
                  else m.qk_nope_head_dim + m.qk_rope_head_dim)
            w, want = lp["attn"][name], rcfg.n_heads * hd
        n = w.shape[-1]
        if n != want:
            raise ValueError(
                f"{name} has {n} output columns; a rank of this mesh holds "
                f"{want} (slice the params with load_packed(mesh=) or "
                f"dist.sharding.shard_params)")

    def _whole_row_scales(self):
        """Draft scales (a make_draft_params scales tree) for the leaves
        a self-draft must not refit on this rank's slice alone: a
        per-channel leaf whose rows the model axis splits (dist/
        sharding.py:cuts_k) is refit on every model rank's code words,
        gathered, so its scales are the single device's; an FSDP block
        (dist/fsdp.py) is refit on its gathered leaf and its scales cut
        as the leaf's are. None at every other leaf, whose refit on
        this rank's slice is a column or expert slice of the whole
        leaf's."""
        M, bits = self.mesh.shape[1], self.draft_bits

        def walk(node, names):
            if isinstance(node, dict):
                return {k: walk(v, names + (k,)) for k, v in node.items()}
            if isinstance(node, (list, tuple)):
                return [walk(v, names + (i,)) for i, v in enumerate(node)]
            fsdp = isinstance(node, FsdpLeaf)
            if fsdp and not node.quantized:
                return None
            qt = node.gather(self.mesh) if fsdp else node
            if not isinstance(qt, QuantizedTensor) or bits >= qt.bits:
                return None
            if M > 1 and cuts_k(names) and qt.n_groups == 1:
                qt = QuantizedTensor(
                    gather_model(qt.codes, dim=-2, mesh=self.mesh),
                    qt.alphas, qt.betas, qt.k_in * M, qt.orig_dtype)
            elif not fsdp:
                return None
            alphas, betas = refit_draft_scales(qt, bits)
            if fsdp:
                alphas = cut_data(alphas, node.dims["alphas"], self.mesh)[0]
                betas = cut_data(betas, node.dims["betas"], self.mesh)[0]
            return {"bits": bits, "alphas": alphas, "betas": betas}
        return walk(self.params, ())

    def _whole_wkv_b(self) -> None:
        """A dense MLA cache split along the sequence is expanded through
        every head's wkv_b (models/mla.py): each MLA layer gets its whole
        wkv_b, gathered once over the model group, as "wkv_b_all"."""
        rcfg = self.run_cfg
        if rcfg.mla is None or not any(
                seq_block(rcfg, spec, self.max_len)[2]
                for spec in rcfg.pattern if spec.kind == "attn"):
            return
        for lp in self.params["layers"]:
            if "attn" not in lp:
                continue
            w = gather_tree(lp["attn"]["wkv_b"], self.mesh)
            if isinstance(w, QuantizedTensor):
                w = QuantizedTensor(*(gather_model(t, dim=d, mesh=self.mesh)
                                      for t, d in ((w.codes, -1),
                                                   (w.alphas, -2),
                                                   (w.betas, -1))),
                                    w.k_in, w.orig_dtype)
            else:
                w = gather_model(w, dim=-1, mesh=self.mesh)
            lp["attn"] = {**lp["attn"], "wkv_b_all": w}

    def _check_local_cache(self, whole) -> None:
        """Every leaf of this rank's pool (or dense cache) has the shape
        of its block under the reference's cache rule (dist/sharding.py
        cache_pspec) of the whole cache `whole` (meta tensors): split
        where the rule splits, whole where it replicates."""
        for layer, mine in zip(whole, self.cache):
            for name, leaf in layer.items():
                shape = (1,) + tuple(leaf.shape)
                spec = cache_pspec(self.cfg, ["L0", name], leaf.new_empty(
                    shape), self.mesh)
                want = local_shape(shape, spec, self.mesh)[1:]
                if tuple(mine[name].shape) != want:
                    raise ValueError(
                        f"cache leaf {name}: the reference's rule places "
                        f"{tuple(leaf.shape)} as {spec[1:]}, a block of "
                        f"{want}, but this rank's config gives "
                        f"{tuple(mine[name].shape)}")

    def _mine(self, slot: int) -> bool:
        """This rank's data shard holds `slot`."""
        return self.lo <= slot < self.lo + self.rows

    def _local_pages(self, ids) -> np.ndarray:
        """Global page ids of this rank's shard (and 0) -> local ids."""
        return self.kv.local_page(np.asarray(ids, np.int64))

    def stats_snapshot(self):
        """Every serving counter (engine accumulators, the scheduler's
        request metrics with per-request TTFT/TPOT samples, page-pool and
        prefix-index counters) as an immutable serve/stats.py
        EngineStats; the `stats` dict stays the running accumulator."""
        from repro_torch.serve.stats import EngineStats
        return EngineStats.capture(self)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _ints(self, arr) -> torch.Tensor:
        return torch.as_tensor(np.asarray(arr, np.int32), device=self.device)

    # ---------------- COW forks ----------------
    def _apply_copies(self, slot, copies) -> None:
        """Apply the allocator's copy-on-write forks of `slot` to the
        device pool (on the rank that holds the slot's shard)."""
        if copies and self._mine(slot):
            self.cache = self._copy(
                self.cache, self._local_pages([s for s, _ in copies]),
                self._local_pages([d for _, d in copies]),
                self.kv.pages_per_shard)

    # ---------------- device block-table mirror ----------------
    def _sync_block_tables(self) -> None:
        lo = self.lo
        dirty = [s for s in range(lo, lo + self.rows)
                 if self._bt_applied[s] != self.kv.bt_version[s]]
        if not dirty:
            return
        self._bt_dev = self._bt_update(
            self._bt_dev, np.asarray(dirty, np.int32) - lo,
            self._local_pages(self.kv.block_tables[dirty]).astype(np.int32))
        for s in dirty:
            self._bt_applied[s] = self.kv.bt_version[s]

    def _bt_slice(self, slot, n_tokens) -> np.ndarray:
        """Block-table row (local page ids) cut to the pages covering
        n_tokens, so the extend path gathers only live pages (its width
        changes from chunk to chunk)."""
        npg = self.kv.pages_for(n_tokens)
        return self._local_pages(
            self.kv.block_tables[slot:slot + 1, :npg]).astype(np.int32)

    def _null_bt(self, n_tokens) -> np.ndarray:
        """A block-table row of null pages (local 0) as wide as
        _bt_slice's for n_tokens: an FSDP rank joining another shard's
        extend pass writes nothing of its own."""
        return np.zeros((1, self.kv.pages_for(n_tokens)), np.int32)

    def _extend_pass(self, tokens, start, bt, n_valid):
        """One extend pass of one sequence: (last valid logits, cache)."""
        logits, self.cache = self._extend(
            self.params, self.cache, tokens[None],
            np.asarray([start], np.int32), bt,
            np.asarray([n_valid], np.int32))
        return logits

    # ---------------- admission ----------------
    def _padded_prompt(self, prompt):
        L = len(prompt)
        S = bucket_len(L, self.max_len) if self._bucket else L
        padded = np.zeros((S,), np.int32)
        padded[:L] = prompt
        return padded, L

    def _admit(self, e):
        """Admission's device work (the prompt's prefill into the
        slot's pages or rows) on the rank that holds the slot (on an
        FSDP mesh every other data rank joins the pass, masked); every
        rank then takes the first token (_emit_first_token)."""
        t0 = time.time()
        if e.shared_tokens:
            # attach the matched prefix pages by reference before any
            # allocation: the attach pins them (refcount >= 2) against
            # the allocator's index reclaim
            self.kv.share(e.slot, e.shared_pages)
            e.prefilled = e.shared_tokens
        if self.prefill_chunk:
            # chunked mode: admission only reserves the slot (and any
            # shared prefix); the prompt flows through _prefill_tick
            self.pos[e.slot] = 0
            self.stats["prefill_s"] += time.time() - t0
            return
        L = len(e.prompt)
        mine, logits = self._mine(e.slot), None
        row = e.slot - self.lo
        if e.shared_tokens:
            # prefix hit: prefill only the unshared suffix through the
            # extend path, after forking the page the match ends in
            N = e.shared_tokens
            nv = L - N
            C = bucket_len(nv, self.max_len) if self._bucket else nv
            padded = np.zeros((C,), np.int32)
            padded[:nv] = e.prompt[N:]
            self.kv.ensure(e.slot, L)
            self._apply_copies(e.slot, self.kv.cow_for_write(e.slot, N, L))
            if mine:
                logits = self._extend_pass(padded, N,
                                           self._bt_slice(e.slot, L), nv)
            elif self.fsdp:
                self._extend_pass(padded, N, self._null_bt(L), 0)
            self.stats["prefill_tokens"] += nv
        elif self._extend_prefill:
            # sliding-window layers: the whole prompt in one extend pass
            # writes it at absolute page slots
            padded, L = self._padded_prompt(e.prompt)
            self.stats["prefill_tokens"] += L
            self.kv.ensure(e.slot, L)
            if mine:
                logits = self._extend_pass(padded, 0,
                                           self._bt_slice(e.slot, L), L)
            elif self.fsdp:
                self._extend_pass(padded, 0, self._null_bt(L), 0)
        elif self.cache_kind == "paged":
            padded, L = self._padded_prompt(e.prompt)
            self.stats["prefill_tokens"] += L
            self.kv.ensure(e.slot, L)
            if mine:
                logits, row_cache = self._prefill(
                    self.params, padded[None, :],
                    np.asarray([L - 1], np.int32), len(padded))
                npg = -(-len(padded) // self.page_size)
                ids = self.kv.owned_pages(e.slot)
                # null-page pad (the shard's reserve): never written
                ids = self._local_pages((ids + [0] * npg)[:npg]).tolist()
                self.cache = self._scatter(self.cache, row_cache, row, ids,
                                           L)
            elif self.fsdp:
                self._prefill(self.params, padded[None, :],
                              np.asarray([L - 1], np.int32), len(padded))
        else:
            padded, L = self._padded_prompt(e.prompt)
            self.stats["prefill_tokens"] += L
            if mine or self.fsdp:
                logits, row_cache = self._prefill(
                    self.params, padded[None, :],
                    np.asarray([L - 1], np.int32), self.max_len)
            if mine:
                for layer, one in zip(self.cache, row_cache):
                    for name, leaf in layer.items():
                        leaf[row] = one[name][0].to(leaf.dtype)
            else:
                logits = None
        self._emit_first_token(e, logits, L)
        self._sync()
        self.stats["prefill_s"] += time.time() - t0

    def _emit_first_token(self, e, last_logits, prompt_len):
        """The prompt's greedy token: taken from `last_logits` by the
        ranks of the slot's data shard (None elsewhere) and broadcast
        over the data axis, so every rank's scheduler appends it."""
        tok = torch.zeros((1,), dtype=torch.int64)
        if last_logits is not None:
            tok[0] = int(torch.argmax(last_logits[0]))
        if self.mesh is not None:
            tok = broadcast_data(tok, e.slot // self.rows, self.mesh)
        tok = int(tok[0])
        e.req.out.append(tok)
        if not e.metrics.t_first_token:
            e.metrics.t_first_token = time.time()
        self.pos[e.slot] = prompt_len
        self.cur[e.slot] = tok
        e.prefilled = prompt_len
        if self._prefix is not None:
            # index the prompt's full pages at once, so concurrent
            # same-prefix requests share them (decode writes only at
            # positions >= prompt_len); the partial tail page is indexed
            # at finish, since indexing it now would fork it on the very
            # next decode token
            nfull = prompt_len // self.page_size
            if nfull:
                self._prefix.insert(
                    np.asarray(e.prompt[:nfull * self.page_size]),
                    self.kv.owned_pages(e.slot)[:nfull])
        if (len(e.req.out) >= e.req.max_new_tokens
                or (e.req.eos is not None and tok == e.req.eos)):
            self._finish(e)

    def _finish(self, e):
        """Complete a request, handing the tokens whose KV its pages
        hold (prompt + generated-minus-last) to the scheduler, so the
        radix index can keep them for later prefix hits."""
        slot = e.slot
        if self._prefix is None:
            self.sched.finish(slot)
            return
        n_cached = int(self.pos[slot])
        folded = len(e.prompt) - e.metrics.n_prompt   # resumed prompts
        toks = np.concatenate([
            e.prompt, np.asarray(e.req.out[folded:], np.int32)])[:n_cached]
        self.sched.finish(slot, cached_tokens=toks)

    # ---------------- chunked prefill ----------------
    def _prefill_tick(self):
        """Advance the first admitted, not yet prefilled sequence by one
        chunk (from the matched offset after a prefix hit)."""
        pending = [e for e in self.sched.running.values()
                   if e.prefilled < len(e.prompt)]
        if not pending:
            return
        e = min(pending, key=lambda x: x.admitted)
        t0 = time.time()
        C = self.prefill_chunk
        s = e.prefilled
        chunk = e.prompt[s:s + C]
        nv = len(chunk)
        padded = np.zeros((C,), np.int32)
        padded[:nv] = chunk
        ok, copies = self.sched.ensure_write_capacity(e.slot, s, s + nv)
        if not ok:
            return    # evicted while growing; it will be re-admitted
        self._apply_copies(e.slot, copies)
        logits = None
        if self._mine(e.slot):
            logits = self._extend_pass(padded, s,
                                       self._bt_slice(e.slot, s + nv), nv)
        elif self.fsdp:
            self._extend_pass(padded, s, self._null_bt(s + nv), 0)
        e.prefilled = s + nv
        self.stats["prefill_tokens"] += nv
        if e.prefilled >= len(e.prompt):
            self._emit_first_token(e, logits, len(e.prompt))
        self._sync()
        self.stats["prefill_s"] += time.time() - t0

    # ---------------- decode ----------------
    def _decode_ready(self):
        return [s for s, e in self.sched.running.items()
                if e.prefilled >= len(e.prompt)]

    def _decode_tick(self):
        if self.speculate:
            return self._spec_decode_tick()
        ready = self._decode_ready()
        if not ready:
            return
        if self.cache_kind == "paged":
            grown = []
            for slot in ready:
                if slot not in self.sched.running:
                    continue    # evicted while growing an earlier slot
                # the new token lands at pos: pos + 1 tokens of capacity,
                # and a fork first if that page is shared
                p = int(self.pos[slot])
                ok, copies = self.sched.ensure_write_capacity(slot, p, p + 1)
                if ok:
                    self._apply_copies(slot, copies)
                    grown.append(slot)
            ready = [s for s in grown if s in self.sched.running]
            if not ready:
                return
        t0 = time.time()
        # this rank's rows step; the others' tokens arrive by all-gather
        # (on an FSDP mesh a rank with no ready row steps all rows dead)
        lo, hi = self.lo, self.lo + self.rows
        mine = [s for s in ready if lo <= s < hi]
        nxt = torch.zeros((self.rows,), dtype=torch.int64)
        if mine or self.fsdp:
            if self.cache_kind == "paged":
                self._sync_block_tables()
                live = np.zeros((self.rows,), np.int32)
                live[np.asarray(mine, np.int64) - lo] = 1   # others: null
                logits, self.cache = self._decode(
                    self.params, self.cache, self.cur[lo:hi, None],
                    self.pos[lo:hi], self._bt_dev, live, self._null_row)
            else:
                logits, self.cache = self._decode(
                    self.params, self.cache, self.cur[lo:hi, None],
                    self.pos[lo:hi])
            if mine:
                nxt = torch.argmax(logits, dim=-1).cpu()
        nxt = gather_data(nxt, self.mesh).numpy()
        self._sync()
        self.stats["decode_s"] += time.time() - t0
        self.stats["ticks"] += 1
        for slot in ready:
            e = self.sched.running[slot]
            self.stats["tokens"] += 1
            tok = int(nxt[slot])
            e.req.out.append(tok)
            self.pos[slot] += 1
            self.cur[slot] = tok
            hit_eos = e.req.eos is not None and tok == e.req.eos
            if (len(e.req.out) >= e.req.max_new_tokens or hit_eos
                    or self.pos[slot] >= self._seq_cap() - 1):
                self._finish(e)

    # ---------------- speculative decode ----------------
    def _spec_decode_tick(self):
        """Propose, verify, accept. The draft proposes up to k tokens a
        ready sequence (k draft decode steps writing draft K/V at
        pos..pos+k-1), then one target pass scores the k+1 positions
        [cur, draft...] causally and overwrites every speculatively
        written K/V slot with the target's own, which makes greedy
        speculative decode token-identical to target-only decode for
        any draft. Acceptance takes the longest draft prefix the target
        agrees with plus the target's token at the first disagreement
        (or the bonus token after full acceptance); rejected tokens roll
        back by truncating pos and unref'ing whole pages past the accept
        point (kv.truncate). Stale K/V inside the kept tail page is
        masked by the context length and overwritten by the next write,
        as in any partial tail page. Between the draft steps nothing
        leaves the device; the tick's device-to-host copies come after
        verify (draft tokens, greedy tokens, and under `typical` the
        per-position keep decisions computed on the device). On a mesh
        each data rank runs its own rows and the rows' accepted tokens
        are all-gathered over the data group, so every rank's replicated
        scheduler emits, truncates and finishes the same."""
        k = self.speculate
        cap = self._seq_cap()
        ready = self._decode_ready()
        if not ready:
            return
        k_eff, grown = {}, []
        for slot in ready:
            if slot not in self.sched.running:
                continue    # evicted while growing an earlier slot
            p = int(self.pos[slot])
            # clamp the depth at the sequence capacity: verify writes
            # k_eff + 1 positions from pos
            ke = min(k, cap - 1 - p)
            ok, copies = self.sched.ensure_write_capacity(slot, p,
                                                          p + ke + 1)
            if ok:
                self._apply_copies(slot, copies)
                k_eff[slot] = ke
                grown.append(slot)
        ready = [s for s in grown if s in self.sched.running]
        if not ready:
            return
        t0 = time.time()
        # this rank's rows propose and verify; a row a slot comes back
        # from every data rank: the accepted draft count m, the m
        # accepted tokens and the target's own (-1 past them)
        lo, hi = self.lo, self.lo + self.rows
        mine = [s for s in ready if lo <= s < hi]
        bursts = torch.full((self.rows, k + 2), -1, dtype=torch.int64)
        if mine or self.fsdp:
            bursts = self._propose_verify(mine, k_eff, bursts)
        bursts = gather_data(bursts, self.mesh).numpy()
        self._sync()
        self.stats["decode_s"] += time.time() - t0
        self.stats["ticks"] += 1
        base_pos = self.pos.copy()

        for slot in ready:
            e = self.sched.running[slot]
            m = int(bursts[slot, 0])
            self.stats["draft_tokens"] += k_eff[slot]
            self.stats["accepted_tokens"] += m
            # the accepted draft prefix + the target's token at position
            # m, emitted one by one under the plain stop conditions
            burst = [int(t) for t in bursts[slot, 1:m + 2]]
            emitted, fin = 0, False
            for tok in burst:
                e.req.out.append(tok)
                self.stats["tokens"] += 1
                emitted += 1
                hit_eos = e.req.eos is not None and tok == e.req.eos
                if (len(e.req.out) >= e.req.max_new_tokens or hit_eos
                        or int(base_pos[slot]) + emitted >= cap - 1):
                    fin = True
                    break
            new_pos = int(base_pos[slot]) + emitted
            self.pos[slot] = new_pos
            self.cur[slot] = burst[emitted - 1]
            # rollback: K/V is cached for [0, new_pos); whole pages past
            # it return to the pool (or stay with their other readers)
            self.kv.truncate(slot, new_pos)
            if fin:
                self._finish(e)

    def _propose_verify(self, mine, k_eff, bursts):
        """The device half of a speculative tick on this rank's rows
        (`mine`: ready slots of its data shard, at depths `k_eff`):
        propose, verify, and accept on each row into `bursts` (row
        slot - lo: m, then m + 1 tokens). Under a model axis the verify
        logits are whole on every model rank (the vocabulary gathered),
        so every model rank accepts the same tokens."""
        k, lo, hi = self.speculate, self.lo, self.lo + self.rows
        self._sync_block_tables()
        base_pos = self.pos[lo:hi].copy()
        cur = self.cur[lo:hi].copy()
        ke_arr = np.zeros((self.rows,), np.int32)
        live = np.zeros((self.rows,), np.int32)
        for s in mine:
            ke_arr[s - lo] = k_eff[s]
            live[s - lo] = 1
        draft, self.cache = self._draft_propose(
            self.draft_params, self.cache, cur, base_pos, self._bt_dev,
            ke_arr, self._null_row, k)
        # verify: dead rows read and write the null page at position 0
        # with no valid token. The tokens are assembled on the device, in
        # a tensor of the engine's own: on the card `draft` is a graph's
        # output, which the verify replay may overwrite
        toks = torch.cat([self._ints(cur)[:, None], draft], dim=1)
        draft = toks[:, 1:]
        logits_all, self.cache = self._verify(
            self.params, self.cache, toks,
            np.where(live > 0, base_pos, 0).astype(np.int32), self._bt_dev,
            np.where(live > 0, ke_arr + 1, 0).astype(np.int32), live,
            self._null_row)
        keep = None
        if self.accept_rule == "typical":
            # the target's probabilities of the draft tokens against its
            # argmax's, in fp32 on the device
            probs = torch.softmax(logits_all[:, :k].float(), dim=-1)
            p_draft = probs.gather(-1, draft.long()[..., None])[..., 0]
            keep = (p_draft >= self.typical_tau
                    * probs.amax(dim=-1)).cpu().numpy()
        draft_toks = draft.cpu().numpy()                       # (rows, k)
        greedy = torch.argmax(logits_all, dim=-1).cpu().numpy()
        for s in mine:
            r, ke = s - lo, k_eff[s]
            dt, g = draft_toks[r], greedy[r]
            m = 0
            if keep is not None:
                while m < ke and keep[r, m]:
                    m += 1
            else:
                while m < ke and dt[m] == g[m]:
                    m += 1
            bursts[r, 0] = m
            bursts[r, 1:m + 1] = torch.as_tensor(dt[:m])
            bursts[r, m + 1] = int(g[m])
        return bursts

    # ---------------- engine ----------------
    def _seq_cap(self) -> int:
        """Per-sequence token capacity: max_len, further bounded by what
        one page-pool shard can hold for one sequence (its pages all
        come from its slot's shard)."""
        if self.cache_kind == "dense":
            return self.max_len
        return min(self.max_len,
                   self.kv.usable_in_shard(0) * self.page_size)

    def run(self, requests: list[Request]):
        cap = self._seq_cap()
        # validate the whole batch before submitting anything
        for r in requests:
            if len(r.prompt) >= cap:
                raise ValueError(
                    f"prompt of {len(r.prompt)} tokens cannot fit the "
                    f"engine capacity of {cap} tokens")
            if self.cache_kind == "paged":
                # the admission gate's arithmetic with nothing shared
                need = self.sched.admission_need(len(r.prompt))
                if need > self.kv.usable_in_shard(0):
                    raise ValueError(
                        f"prompt of {len(r.prompt)} tokens needs {need} "
                        f"pages (incl. watermark) but a pool shard only "
                        f"has {self.kv.usable_in_shard(0)}")
        for r in requests:
            self.sched.submit(r)
        self._entries = list(self.sched.waiting)
        with (mesh_context(self.mesh) if self.mesh is not None
              else contextlib.nullcontext()):
            while self.sched.has_work():
                while True:
                    e = self.sched.try_admit()
                    if e is None:
                        break
                    self._admit(e)
                if self.prefill_chunk:
                    self._prefill_tick()
                self._decode_tick()
        self.stats.update(self.sched.metrics_summary(self._entries))
        return requests
