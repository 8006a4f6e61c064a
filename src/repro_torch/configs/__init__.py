"""Config registry of the port: the attention-only dense models the
serving slice runs."""
from __future__ import annotations

from repro_torch.configs import paper_models as _paper
from repro_torch.configs.base import LayerSpec, ModelConfig, QuantConfig

REGISTRY = {
    c.name: c for c in [
        _paper.OPT_125M, _paper.LLAMA2_7B, _paper.BLOOM_560M,
        _paper.TINY_LM, _paper.TINY_LM_WIDE, _paper.TINY_LM_DEEP,
    ]
}


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(REGISTRY)}")
    return REGISTRY[name]


__all__ = ["ModelConfig", "LayerSpec", "QuantConfig", "REGISTRY",
           "get_config"]
