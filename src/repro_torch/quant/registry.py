"""Quantizer registry: string method names -> Quantizer implementations
(the reference's `quant/registry.py`).

Every quantization method (`rtn`, `bcq`, `gptq`, `gptq_minmse`,
`gptq_bcq`, `gptqt`, ...) is a `Quantizer` registered under its name
with `@register_quantizer("name")`; `core/api.quantize_matrix` and
`quantize_model` dispatch through `get_quantizer` — there is no
string if/elif chain anywhere. Registration is open: downstream code
can plug in new methods (experimental grids, per-layer searches)
without touching the core, which is what FineQuant-style method x bits
sweeps need.

The built-in quantizers live in core/quantizers.py (they wrap the
paper's solvers in core/); this module stays import-light, so quant/
never depends on core/ at import time.
`get_quantizer` lazily imports the built-ins on first lookup.
"""
from __future__ import annotations

from dataclasses import dataclass

_REGISTRY: dict = {}
_BUILTINS_LOADED = False


@dataclass
class QuantResult:
    """What a Quantizer returns for one matrix (GPTQ orientation).

    wq_t: dequantized fp32 weights (N_out, K_in) — always present, used
          for fake-quant installs and output-error reporting.
    qt:   packed QuantizedTensor (layer layout K, N) when the method has
          a fused binary-coding representation and the plan asked for
          mode="packed"; None otherwise.
    """
    wq_t: object
    qt: object = None


class Quantizer:
    """Protocol for one quantization method.

    Subclasses implement `quantize(Wt, H, plan, orig_dtype=...)` where
    Wt is the fp32 weight in GPTQ orientation (N_out, K_in), H the
    (K, K) calibration Hessian and plan a spec.LeafPlan. Set
    `supports_packed = True` iff the method can emit a QuantizedTensor.
    """
    name: str = "?"
    supports_packed: bool = False

    def quantize(self, Wt, H, plan, *, orig_dtype="bfloat16") -> QuantResult:
        raise NotImplementedError


def register_quantizer(name: str):
    """Class decorator: `@register_quantizer("gptqt")`. Instantiates the
    class and binds it under `name` (later registrations override)."""
    def deco(cls):
        inst = cls()
        inst.name = name
        _REGISTRY[name] = inst
        return cls
    return deco


def _ensure_builtins():
    global _BUILTINS_LOADED
    if not _BUILTINS_LOADED:
        import repro_torch.core.quantizers  # noqa: F401  (registers built-ins)
        _BUILTINS_LOADED = True       # only after a successful import


def get_quantizer(name: str) -> Quantizer:
    _ensure_builtins()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown quantizer {name!r}; registered: "
            f"{', '.join(available_quantizers())}") from None


def available_quantizers() -> list:
    _ensure_builtins()
    return sorted(_REGISTRY)
