"""Structured serving statistics: the EngineStats snapshot (the
reference's `serve/stats.py`).

The engine accumulates raw counters in a plain dict while it runs.
`EngineStats.capture(engine)` freezes that dict plus the scheduler's
request metrics and the allocator and prefix-index counters into one
typed, immutable record, the thing benchmarks and monitoring read.
Every field is a real field: a mistyped stats key is an AttributeError
here, not a silent 0 from `.get()`, and `as_dict()` gives the
JSON-ready form. The field names are the reference's.

The compile-cache fields are serve/compile_cache.py's process-wide
entries, hits and misses, counted as the reference counts its own. The
slab fields read 0 unless the engine holds a state slab pool (Mamba
layers, paged).
"""
from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Tuple


@dataclass(frozen=True)
class EngineStats:
    """One snapshot of a serving engine's counters."""

    # phase timings / token accounting (engine accumulators)
    prefill_s: float = 0.0
    decode_s: float = 0.0
    tokens: int = 0
    ticks: int = 0
    prefill_tokens: int = 0

    # request lifecycle (scheduler summary)
    n_done: int = 0
    preemptions: int = 0
    ttft_avg_s: float = 0.0
    tpot_avg_s: float = 0.0
    ttft_samples_s: Tuple[float, ...] = ()
    tpot_samples_s: Tuple[float, ...] = ()

    # KV page pool
    kv_high_water_pages: int = 0
    kv_usable_pages: int = 0
    pages_allocated: int = 0
    cow_forks: int = 0

    # binary-coded KV (0 bits == raw fp pages)
    kv_bits: int = 0
    kv_bytes_per_page: int = 0
    kv_pool_bytes: int = 0

    # self-speculative decoding (0 == speculation off)
    speculate_k: int = 0
    draft_bits: int = 0
    draft_tokens: int = 0
    accepted_tokens: int = 0
    acceptance_rate: float = 0.0

    # recurrent state slab pool (0 == no recurrent layers / dense)
    slab_usable_slabs: int = 0
    slab_high_water: int = 0
    slabs_allocated: int = 0
    slab_bytes_per_slab: int = 0

    # radix prefix index
    prefix_hits: int = 0
    prefix_lookups: int = 0
    prefix_hit_rate: float = 0.0
    prefix_tokens_saved: int = 0
    prefix_cached_pages: int = 0
    prefix_evictions: int = 0

    # process-wide step cache (serve/compile_cache.py)
    compile_cache_entries: int = 0
    compile_cache_hits: int = 0
    compile_cache_misses: int = 0

    @property
    def decode_tok_s(self) -> float:
        """Decode throughput over the engine's lifetime so far."""
        return self.tokens / max(self.decode_s, 1e-9)

    @property
    def us_per_token(self) -> float:
        return 1e6 * self.decode_s / max(self.tokens, 1)

    def as_dict(self) -> dict:
        """JSON-ready form (sample tuples become lists), including the
        derived throughput fields."""
        d = asdict(self)
        d["ttft_samples_s"] = list(self.ttft_samples_s)
        d["tpot_samples_s"] = list(self.tpot_samples_s)
        d["decode_tok_s"] = self.decode_tok_s
        d["us_per_token"] = self.us_per_token
        return d

    @classmethod
    def capture(cls, engine) -> "EngineStats":
        """Snapshot a ServeEngine now: its accumulator dict, a fresh
        scheduler summary (so mid-run captures see current requests,
        not the last run()'s), and the pool, index and compile-cache
        counters."""
        from repro_torch.serve import compile_cache

        s = dict(engine.stats)
        s.update(engine.sched.metrics_summary(engine._entries))
        speculate = int(getattr(engine, "speculate", 0))
        drafted = int(s.get("draft_tokens", 0))
        accepted = int(s.get("accepted_tokens", 0))
        kv = engine.kv
        cc = compile_cache.stats()
        fields = {
            "prefill_s": float(s.get("prefill_s", 0.0)),
            "decode_s": float(s.get("decode_s", 0.0)),
            "tokens": int(s.get("tokens", 0)),
            "ticks": int(s.get("ticks", 0)),
            "prefill_tokens": int(s.get("prefill_tokens", 0)),
            "n_done": int(s.get("n_done", 0)),
            "preemptions": int(s.get("preemptions", 0)),
            "ttft_avg_s": float(s.get("ttft_avg_s", 0.0)),
            "tpot_avg_s": float(s.get("tpot_avg_s", 0.0)),
            "ttft_samples_s": tuple(s.get("ttft_samples_s", ())),
            "tpot_samples_s": tuple(s.get("tpot_samples_s", ())),
            "kv_high_water_pages": int(s.get("kv_high_water_pages", 0)),
            "kv_usable_pages": int(s.get("kv_usable_pages", 0)),
            "pages_allocated": int(s.get("pages_allocated", 0)),
            "cow_forks": int(s.get("cow_forks", 0)),
            "kv_bits": int(getattr(engine, "kv_bits", 0)),
            "kv_bytes_per_page": (int(kv.bytes_per_page())
                                  if hasattr(kv, "bytes_per_page") else 0),
            "kv_pool_bytes": (int(kv.pool_bytes())
                              if hasattr(kv, "pool_bytes") else 0),
            "speculate_k": speculate,
            "draft_bits": (int(getattr(engine, "draft_bits", 0))
                           if speculate else 0),
            "draft_tokens": drafted,
            "accepted_tokens": accepted,
            "acceptance_rate": accepted / max(drafted, 1),
            "slab_usable_slabs": int(s.get("slab_usable_slabs", 0)),
            "slab_high_water": int(s.get("slab_high_water", 0)),
            "slabs_allocated": int(s.get("slabs_allocated", 0)),
            "slab_bytes_per_slab": (
                int(engine.slab.bytes_per_slab())
                if getattr(engine, "slab", None) is not None else 0),
            "prefix_hits": int(s.get("prefix_hits", 0)),
            "prefix_lookups": int(s.get("prefix_lookups", 0)),
            "prefix_hit_rate": float(s.get("prefix_hit_rate", 0.0)),
            "prefix_tokens_saved": int(s.get("prefix_tokens_saved", 0)),
            "prefix_cached_pages": int(s.get("prefix_cached_pages", 0)),
            "prefix_evictions": int(s.get("prefix_evictions", 0)),
            "compile_cache_entries": int(cc["entries"]),
            "compile_cache_hits": int(cc["hits"]),
            "compile_cache_misses": int(cc["misses"]),
        }
        return cls(**fields)
