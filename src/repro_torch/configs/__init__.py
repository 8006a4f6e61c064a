"""Config registry of the port: get_config(name) and the reduced
same-family smoke configs (the port's own copy of the reference's
`configs/__init__.py`)."""
from __future__ import annotations

import dataclasses

from repro_torch.configs import paper_models as _paper
from repro_torch.configs.base import (SHAPES, LayerSpec, MambaConfig,
                                      MLAConfig, ModelConfig, MoEConfig,
                                      QuantConfig, ShapeSpec,
                                      runnable_shapes)
from repro_torch.configs.chameleon_34b import CONFIG as _chameleon
from repro_torch.configs.falcon_mamba_7b import CONFIG as _falcon_mamba
from repro_torch.configs.gemma2_27b import CONFIG as _gemma2
from repro_torch.configs.hubert_xlarge import CONFIG as _hubert
from repro_torch.configs.jamba_1_5_large_398b import CONFIG as _jamba
from repro_torch.configs.minicpm3_4b import CONFIG as _minicpm3
from repro_torch.configs.mixtral_8x7b import CONFIG as _mixtral
from repro_torch.configs.qwen3_0_6b import CONFIG as _qwen3_06b
from repro_torch.configs.qwen3_4b import CONFIG as _qwen3_4b

# the ten pool architectures
ASSIGNED = {
    c.name: c for c in [
        _jamba, _mixtral, _paper.QWEN3_MOE_235B_A22B, _qwen3_4b, _minicpm3,
        _qwen3_06b, _gemma2, _falcon_mamba, _hubert, _chameleon,
    ]
}

EXTRA = {
    c.name: c for c in [
        _paper.OPT_125M, _paper.LLAMA2_7B, _paper.BLOOM_560M,
        _paper.TINY_LM, _paper.TINY_LM_WIDE, _paper.TINY_LM_DEEP,
        _paper.TINY_MLA, _paper.TINY_MOE,
    ]
}

REGISTRY = {**ASSIGNED, **EXTRA}


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(REGISTRY)}")
    return REGISTRY[name]


def smoke_config(name: str) -> ModelConfig:
    """Reduced same-family config: small widths, one super-block of
    depth, 4 experts, vocab 97, the same block pattern and feature flags
    (the reference's reductions, value for value)."""
    cfg = get_config(name)
    kw = dict(
        name=cfg.name + "-smoke",
        n_layers=len(cfg.pattern),          # one super-block
        d_model=64,
        n_heads=4,
        n_kv_heads=max(1, min(cfg.n_kv_heads, 2)),
        head_dim=16,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=97,
    )
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(
            cfg.moe, n_experts=4, top_k=min(cfg.moe.top_k, 2), d_ff_expert=64)
    if cfg.mamba is not None:
        kw["mamba"] = dataclasses.replace(cfg.mamba, d_state=8, chunk=16)
    if cfg.mla is not None:
        kw["mla"] = MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                              qk_nope_head_dim=16, qk_rope_head_dim=8,
                              v_head_dim=16)
        kw["head_dim"] = 24
    if cfg.pattern and cfg.pattern[0].window is not None:
        kw["pattern"] = tuple(
            dataclasses.replace(s, window=32 if s.window else None)
            for s in cfg.pattern)
    return cfg.replace(**kw)


__all__ = ["ModelConfig", "LayerSpec", "MoEConfig", "MambaConfig",
           "MLAConfig", "QuantConfig", "ShapeSpec", "SHAPES",
           "runnable_shapes", "ASSIGNED", "EXTRA", "REGISTRY", "get_config",
           "smoke_config"]
