"""Config registry of the port: the attention-only dense and MoE models
its serving slices run."""
from __future__ import annotations

from repro_torch.configs import paper_models as _paper
from repro_torch.configs.base import (LayerSpec, ModelConfig, MoEConfig,
                                      QuantConfig)

REGISTRY = {
    c.name: c for c in [
        _paper.OPT_125M, _paper.LLAMA2_7B, _paper.BLOOM_560M,
        _paper.TINY_LM, _paper.TINY_LM_WIDE, _paper.TINY_LM_DEEP,
        _paper.TINY_MOE, _paper.QWEN3_MOE_235B_A22B,
    ]
}


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(REGISTRY)}")
    return REGISTRY[name]


__all__ = ["ModelConfig", "LayerSpec", "MoEConfig", "QuantConfig", "REGISTRY",
           "get_config"]
