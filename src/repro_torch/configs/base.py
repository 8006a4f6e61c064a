"""Model configuration dataclasses (the port's own copy of the
reference's `configs/base.py`, trimmed to what the serving slices read).

A ModelConfig fully determines a model: the block *pattern* (a repeating
super-block of layer specs, `n_groups` repeats), attention details,
and the quantization defaults. Pure data — importing it touches no
device.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25       # train-time dispatch capacity
    inference_capacity_factor: float = 2.0  # prefill; decode uses 4.0


@dataclass(frozen=True)
class LayerSpec:
    """One layer inside the repeating super-block."""
    kind: str = "attn"          # "attn" | "mamba"
    mlp: str = "dense"          # "dense" | "moe" | "none"
    window: Optional[int] = None  # sliding-window size; None = global


@dataclass(frozen=True)
class QuantConfig:
    """GPTQT defaults for this model."""
    bits: int = 3                 # final binary-coding bits (k)
    intermediate_bits: int = 5    # step-1 linear bits (n)
    group_size: int = 0           # 0 = per-channel (one group along K)
    reexplore_range: int = 1
    reexplore_points: int = 33
    exclude: Tuple[str, ...] = ()


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0             # 0 -> d_model // n_heads
    # repeating super-block; len(pattern) must divide n_layers
    pattern: Tuple[LayerSpec, ...] = (LayerSpec(),)
    qk_norm: bool = False
    rope_theta: float = 10000.0
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    causal: bool = True
    post_block_norms: bool = False
    moe: Optional[MoEConfig] = None
    # sub-module configs of later slices (Mamba, MLA); the port refuses
    # configs that set them
    mamba: Optional[object] = None
    mla: Optional[object] = None
    tie_embeddings: bool = True
    embed_input: str = "tokens"
    norm_eps: float = 1e-6
    has_decode: bool = True
    dtype: str = "bfloat16"
    quant: QuantConfig = field(default_factory=QuantConfig)

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim > 0 else self.d_model // self.n_heads

    @property
    def n_groups(self) -> int:
        if self.n_layers % len(self.pattern):
            raise ValueError(
                f"{self.name}: n_layers={self.n_layers} not divisible by "
                f"pattern length {len(self.pattern)}")
        return self.n_layers // len(self.pattern)

    def layer_specs(self) -> Tuple[LayerSpec, ...]:
        """The spec of every layer in order (the pattern repeated
        n_groups times) — the port keeps one weight dict per layer
        instead of the reference's (n_groups, ...) stacks."""
        return tuple(self.pattern) * self.n_groups

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
