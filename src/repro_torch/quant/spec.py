"""Declarative quantization spec: what to quantize, with which method,
at which bit-widths — resolved per weight leaf (the port's copy of the
reference's `quant/spec.py`).

A `QuantSpec` is pure data. It carries the model-wide defaults (method,
bits, mode, GPTQT knobs) plus an ordered tuple of `OverrideRule`s that
rewrite those defaults for leaves matched by name or dotted path — the
FineQuant-style mixed-precision hook (e.g. keep `lm_head` and `wv` at
higher bits than the rest of the network). Rules are matched first-hit
against the leaf name and the dotted tree path ("blocks.L0.attn.wq");
patterns use fnmatch glob syntax, so "wv", "blocks.L1.*" and "*.wd"
all work. Paths address the repeating pattern block (L0, L1, ...), not
unrolled layer indices — the over-groups scan stacks all groups of a
slot into one leaf, so a slot is the natural override granularity.

The module also owns the ONE quantizable-leaf predicate
(`is_quantizable`) shared by calibration (core/api.py), the
sensitivity sweep (quant/search.py) and the spec resolver, so
eligibility cannot drift between them.

`spec.resolve(path, name)` returns a `LeafPlan` (the fully-resolved
per-leaf settings handed to a registered quantizer) or None when the
leaf should be skipped. Specs serialize to/from plain dicts so packed
artifacts (ckpt/packed.py) can record exactly how a model was
quantized.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from fnmatch import fnmatchcase
from typing import Optional, Tuple

# param-leaf names eligible for quantization (2D GEMM weights + 3D expert
# stacks); everything else (norms, convs, A_log, embeddings) is left alone.
QUANTIZABLE = {
    "wq", "wk", "wv", "wo", "wg", "wu", "wd", "in_proj", "out_proj",
    "x_proj", "dt_w", "wq_a", "wq_b", "wkv_a", "wkv_b", "lm_head",
}

MODES = ("fake", "packed")


def leaf_name(path) -> str:
    """Last component of a tree path (a tuple of dict keys)."""
    return str(path[-1])


def dotted_path(path) -> str:
    """("L0", "attn", "wq") -> "L0.attn.wq" (for rule matching)."""
    return ".".join(str(k) for k in path)


def is_quantizable(name: str, *, include_head: bool = False,
                   exclude: Tuple[str, ...] = (), ndim: int = 2) -> bool:
    """THE shared eligibility predicate. A leaf is quantizable iff its
    name is a known GEMM weight, it is at least 2D (matrix or expert
    stack), the head is opted in, and no exclude substring matches."""
    return (name in QUANTIZABLE
            and ndim >= 2
            and (name != "lm_head" or include_head)
            and not any(sub in name for sub in exclude))


@dataclass(frozen=True)
class LeafPlan:
    """Fully-resolved settings for quantizing ONE weight leaf; this is
    what a registered Quantizer receives."""
    method: str
    bits: int
    mode: str = "fake"
    intermediate_bits: int = 5
    group_size: int = 0
    reexplore_range: int = 1
    reexplore_points: int = 33
    exact_search: bool = False

    def __post_init__(self):
        _check_group_size(self.group_size)

    def n_groups(self, k_in: int) -> int:
        """Scale groups along a K_in-length contraction axis; raises a
        clear error when group_size does not divide k_in (no implicit
        padding)."""
        return n_groups_for(k_in, self.group_size)


def n_groups_for(k_in: int, group_size: int) -> int:
    """THE quant-layer divisibility check (one error message for every
    caller)."""
    if group_size == 0:
        return 1
    if k_in % group_size:
        raise ValueError(
            f"group_size={group_size} does not divide the weight's "
            f"K_in={k_in}; pick a divisor of every quantized leaf's K "
            f"(or add an OverrideRule with a fitting group_size / "
            f"group_size=0 for the odd leaves)")
    return k_in // group_size


def _check_group_size(group_size) -> None:
    if group_size is None:
        return
    if not isinstance(group_size, int) or isinstance(group_size, bool):
        raise ValueError(
            f"group_size must be an int (K entries per scale group), "
            f"got {group_size!r}")
    if group_size < 0:
        raise ValueError(
            f"group_size must be >= 0 (0 = per-channel scales), got "
            f"{group_size}")


@dataclass(frozen=True)
class OverrideRule:
    """Per-leaf override: first rule whose pattern matches the leaf name
    or dotted path wins. Fields left at None inherit the spec default;
    `skip=True` leaves the matched leaf dense."""
    pattern: str
    method: Optional[str] = None
    bits: Optional[int] = None
    intermediate_bits: Optional[int] = None
    group_size: Optional[int] = None
    skip: bool = False

    def __post_init__(self):
        _check_group_size(self.group_size)

    def matches(self, path: str, name: str) -> bool:
        return fnmatchcase(name, self.pattern) or fnmatchcase(path,
                                                              self.pattern)


@dataclass(frozen=True)
class QuantSpec:
    """Declarative description of a whole-model quantization run."""
    method: str = "gptqt"
    bits: int = 3
    mode: str = "fake"                 # "fake" | "packed"
    intermediate_bits: int = 5
    group_size: int = 0
    reexplore_range: int = 1
    reexplore_points: int = 33
    exact_search: bool = False
    include_head: bool = False
    exclude: Tuple[str, ...] = ()
    overrides: Tuple[OverrideRule, ...] = ()

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got "
                             f"{self.mode!r}")
        _check_group_size(self.group_size)

    # ---------------- construction ----------------
    @classmethod
    def from_config(cls, qcfg, **kw) -> "QuantSpec":
        """Spec from a configs.base.QuantConfig (the per-model defaults),
        with keyword overrides (method=, mode=, bits=, overrides=, ...)."""
        base = dict(
            bits=qcfg.bits, intermediate_bits=qcfg.intermediate_bits,
            group_size=qcfg.group_size, reexplore_range=qcfg.reexplore_range,
            reexplore_points=qcfg.reexplore_points,
            exclude=tuple(qcfg.exclude))
        base.update(kw)
        return cls(**base)

    def replace(self, **kw) -> "QuantSpec":
        return dataclasses.replace(self, **kw)

    # ---------------- resolution ----------------
    def eligible(self, name: str, ndim: int = 2) -> bool:
        return is_quantizable(name, include_head=self.include_head,
                              exclude=self.exclude, ndim=ndim)

    def resolve(self, path: str, name: str,
                ndim: int = 2) -> Optional[LeafPlan]:
        """-> LeafPlan for this leaf, or None to leave it dense."""
        if not self.eligible(name, ndim):
            return None
        method, bits, ibits = self.method, self.bits, self.intermediate_bits
        gsize = self.group_size
        for rule in self.overrides:
            if rule.matches(path, name):
                if rule.skip:
                    return None
                method = rule.method or method
                bits = rule.bits or bits
                ibits = rule.intermediate_bits or ibits
                if rule.group_size is not None:
                    gsize = rule.group_size
                break
        return LeafPlan(
            method=method, bits=bits, mode=self.mode,
            intermediate_bits=ibits, group_size=gsize,
            reexplore_range=self.reexplore_range,
            reexplore_points=self.reexplore_points,
            exact_search=self.exact_search)

    # ---------------- (de)serialization ----------------
    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["exclude"] = list(self.exclude)
        d["overrides"] = [dataclasses.asdict(r) for r in self.overrides]
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "QuantSpec":
        d = dict(d)
        d["exclude"] = tuple(d.get("exclude", ()))
        d["overrides"] = tuple(OverrideRule(**r)
                               for r in d.get("overrides", ()))
        return cls(**d)
