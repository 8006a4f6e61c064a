"""FineQuant-style per-leaf sensitivity sweep (the reference's
`quant/search.py`): score every quantizable leaf by its
Hessian-diagonal-weighted quantization error at a grid of bit-widths,
then emit a ready-to-paste `OverrideRule` tuple that keeps the most
sensitive leaves at higher precision.

The score for leaf W (GPTQ orientation, rows = output channels) at b
bits is the *relative* diag(H)-weighted error of a cheap RTN proxy:

    err(b) = sum_k hd[k] * (W - RTN_b(W))^2  /  sum_k hd[k] * W^2

— the same second-order proxy the GPTQT BCchoice search minimizes, so
the ranking orders leaves by how much layer-output MSE each one
contributes at a given width, without running the (much slower) GPTQ
solves per leaf. Scores are comparable across leaves because they are
normalized by the leaf's own weighted energy.

Typical use (the launcher's `--suggest-overrides` flag runs it on a
trained tiny LM):

    scores = sensitivity_sweep(cfg, params, calib_batches)
    rules = suggest_overrides(scores, base_bits=cfg.quant.bits)
    print(format_overrides(rules))     # paste into your QuantSpec
    spec = QuantSpec.from_config(cfg.quant, overrides=rules)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, Tuple

import numpy as np
import torch

from repro_torch.quant.spec import OverrideRule, QuantSpec, dotted_path

DEFAULT_BITS_GRID = (2, 3, 4)


@dataclass(frozen=True)
class LeafScore:
    """Sensitivity of one weight leaf (averaged over layer groups and
    experts when the leaf is stacked)."""
    path: str                       # dotted path, e.g. "blocks.L0.attn.wv"
    err: Dict[int, float]           # bits -> relative weighted error
    params: int                     # elements (for budget accounting)

    def sensitivity(self, bits: int) -> float:
        """Error at `bits`, snapped to the nearest scored width (the
        sweep grid is fixed; callers may ask about e.g. 5 bits)."""
        return self.err[min(self.err, key=lambda b: abs(b - bits))]


def _leaf_err(Wt, hd, bits: int, group_size: int) -> float:
    """Relative diag(H)-weighted RTN error for one (N, K) matrix."""
    from repro_torch.core.rtn import quantize_rtn  # lazy: core imports quant
    Wt = Wt.float()
    try:
        wq, _ = quantize_rtn(Wt, bits, group_size=group_size)
    except ValueError:              # group_size does not divide this K
        wq, _ = quantize_rtn(Wt, bits)
    hd = torch.clamp(hd, min=1e-12)[None, :]
    num = torch.sum(hd * (Wt - wq) ** 2)
    den = torch.sum(hd * Wt ** 2) + 1e-12
    return float(num / den)


def sensitivity_sweep(cfg, params, calib_batches, *,
                      bits_grid: Tuple[int, ...] = DEFAULT_BITS_GRID,
                      spec: QuantSpec | None = None,
                      hessians=None, device=None) -> Tuple[LeafScore, ...]:
    """Calibrate on `device` (default cuda), or reuse `hessians` from
    collect_hessians, and score every spec-eligible leaf at each width
    in `bits_grid`. Returns LeafScores sorted most-sensitive-first at
    the spec's base bits."""
    from repro_torch.core.api import collect_hessians  # lazy, as above
    if spec is None:
        spec = QuantSpec.from_config(cfg.quant)
    if hessians is None:
        hessians = collect_hessians(cfg, params, calib_batches, spec=spec,
                                    device=device)

    by_path: Dict[str, list] = {}
    for path, g, leaf, H in hessians.values():
        dotted = ("blocks." if g != -1 else "") + dotted_path(path)
        by_path.setdefault(dotted, []).append((leaf, H))

    scores = []
    for dotted, entries in sorted(by_path.items()):
        name = dotted.rsplit(".", 1)[-1]
        plan = spec.resolve(dotted, name, getattr(entries[0][0], "ndim", 2))
        gsize = plan.group_size if plan is not None else 0
        errs: Dict[int, list] = {b: [] for b in bits_grid}
        n_params = 0
        for leaf, H in entries:
            mats = ([(leaf[e], H[e]) for e in range(leaf.shape[0])]
                    if leaf.dim() == 3 else [(leaf, H)])
            for W, He in mats:
                Wt = W.T                                  # (N, K)
                hd = torch.diagonal(He.float())
                for b in bits_grid:
                    errs[b].append(_leaf_err(Wt, hd, b, gsize))
                n_params += W.numel()
        scores.append(LeafScore(
            path=dotted,
            err={b: float(np.mean(errs[b])) for b in bits_grid},
            params=n_params))

    base = min(bits_grid, key=lambda b: abs(b - spec.bits))
    scores.sort(key=lambda s: -s.sensitivity(base))
    return tuple(scores)


def bump_cost_bytes(score: LeafScore, base_bits: int, bump_to: int) -> int:
    """Extra checkpoint bytes of raising one leaf from base_bits to
    bump_to: (bump_to - base_bits) extra sign bitplanes over `params`
    elements, 1 bit per element per plane (scale overhead is per-group,
    negligible at leaf granularity and identical for every candidate)."""
    return max(bump_to - base_bits, 0) * score.params // 8


def suggest_overrides(scores: Iterable[LeafScore], *, base_bits: int,
                      bump_frac: float = 0.25,
                      bump_to: int | None = None,
                      bytes_budget: int | None = None,
                      ) -> Tuple[OverrideRule, ...]:
    """Pick which leaves get an OverrideRule raising them to `bump_to`
    (default base_bits + 1) — the FineQuant recipe: spend the extra bits
    where the weighted error concentrates.

    Two selection modes:
      - default: top `bump_frac` most-sensitive leaves at `base_bits`
        (quantile recipe — size-blind: a tiny norm leaf and a d_ff x
        d_model matmul cost the same slot).
      - `bytes_budget`: greedily spend a byte allowance by error
        reduction *per byte* — candidates are ranked by
        (err[base] - err[bump_to]) / bump_cost_bytes and taken while
        they fit, skipping any leaf too large for the remaining budget
        (greedy knapsack cover). This is the mode the serving CLI's
        `--bytes-budget` exposes: "I can afford 2 MiB more checkpoint,
        place it where it buys the most accuracy."
    """
    scores = list(scores)
    if not scores:
        return ()
    bump_to = bump_to if bump_to is not None else base_bits + 1
    if bytes_budget is None:
        ranked = sorted(scores, key=lambda s: -s.sensitivity(base_bits))
        n_bump = max(1, int(round(len(ranked) * bump_frac)))
        return tuple(OverrideRule(pattern=s.path, bits=bump_to)
                     for s in ranked[:n_bump])

    if bytes_budget < 0:
        raise ValueError(f"bytes_budget must be >= 0, got {bytes_budget}")

    def gain_per_byte(s: LeafScore) -> float:
        cost = bump_cost_bytes(s, base_bits, bump_to)
        if cost <= 0:
            return 0.0
        gain = s.sensitivity(base_bits) - s.sensitivity(bump_to)
        return max(gain, 0.0) / cost

    ranked = sorted(scores, key=lambda s: -gain_per_byte(s))
    chosen, remaining = [], int(bytes_budget)
    for s in ranked:
        cost = bump_cost_bytes(s, base_bits, bump_to)
        if cost <= 0 or gain_per_byte(s) <= 0.0:
            continue                  # bump buys nothing for this leaf
        if cost > remaining:
            continue                  # too big — a cheaper leaf may fit
        chosen.append(s)
        remaining -= cost
    return tuple(OverrideRule(pattern=s.path, bits=bump_to)
                 for s in chosen)


def format_overrides(rules: Iterable[OverrideRule]) -> str:
    """Render rules as paste-ready QuantSpec construction source."""
    lines = ["overrides = ("]
    for r in rules:
        parts = [repr(r.pattern)]
        for f in ("method", "bits", "intermediate_bits", "group_size"):
            v = getattr(r, f)
            if v is not None:
                parts.append(f"{f}={v!r}")
        if r.skip:
            parts.append("skip=True")
        lines.append(f"    OverrideRule({', '.join(parts)}),")
    lines.append(")")
    return "\n".join(lines)


def format_report(scores: Iterable[LeafScore],
                  bits_grid: Tuple[int, ...] = DEFAULT_BITS_GRID) -> str:
    """Human-readable sensitivity table (one line per leaf)."""
    header = "leaf".ljust(32) + "".join(f"  err@w{b}" for b in bits_grid)
    lines = [header, "-" * len(header)]
    for s in scores:
        lines.append(s.path.ljust(32) + "".join(
            f"  {s.err[b]:7.4f}" for b in bits_grid))
    return "\n".join(lines)
