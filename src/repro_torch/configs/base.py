"""Model configuration dataclasses (the port's own copy of the
reference's `configs/base.py`, trimmed to what the port reads).

A ModelConfig fully determines a model: the block *pattern* (a repeating
super-block of layer specs, `n_groups` repeats), attention details,
and the quantization defaults. `param_counts` is the analytic parameter
count the roofline's model FLOPs read; `SHAPES` are the four input
shapes of the dry run's cells and `runnable_shapes` those that apply to
a config. Pure data — importing it touches no device.
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
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0          # 0 -> ceil(d_model / 16)
    chunk: int = 256          # chunked-scan block length

    def resolved_dt_rank(self, d_model: int) -> int:
        return self.dt_rank if self.dt_rank > 0 else -(-d_model // 16)


@dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int
    kv_lora_rank: int
    qk_nope_head_dim: int
    qk_rope_head_dim: int
    v_head_dim: int


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
    mamba: Optional[MambaConfig] = None
    mla: Optional[MLAConfig] = None
    tie_embeddings: bool = True
    embed_input: str = "tokens"   # "tokens" | "frames" (train forward only)
    norm_eps: float = 1e-6
    has_decode: bool = True       # encoder-only archs: False
    subquadratic: bool = False    # eligible for long-context cells
    dtype: str = "bfloat16"
    # activation remat policy for training: "none" | "dots" | "full"
    remat: str = "full"
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

    @property
    def d_inner(self) -> int:
        if self.mamba is None:
            raise ValueError(f"{self.name}: d_inner needs a Mamba config")
        return self.mamba.expand * self.d_model

    def layer_specs(self) -> Tuple[LayerSpec, ...]:
        """The spec of every layer in order (the pattern repeated
        n_groups times) — the port keeps one weight dict per layer
        instead of the reference's (n_groups, ...) stacks."""
        return tuple(self.pattern) * self.n_groups

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_counts(self) -> dict:
        """Analytic parameter counts (the reference's, term for term):
        embed, lm_head (untied only), blocks_total / blocks_active (MoE
        layers count top_k experts as active), total and active. The
        embedding counts once when tied."""
        d, hd = self.d_model, self.resolved_head_dim
        nh, nkv = self.n_heads, self.n_kv_heads
        counts = {"embed": self.vocab_size * d}
        if not self.tie_embeddings:
            counts["lm_head"] = self.vocab_size * d
        total = active = 0
        for spec in self.pattern:
            p = 0
            if spec.kind == "attn":
                if self.mla is not None:
                    m = self.mla
                    qk_hd = m.qk_nope_head_dim + m.qk_rope_head_dim
                    p += d * m.q_lora_rank + m.q_lora_rank * nh * qk_hd
                    p += d * (m.kv_lora_rank + m.qk_rope_head_dim)
                    p += m.kv_lora_rank * nh * (m.qk_nope_head_dim
                                                + m.v_head_dim)
                    p += nh * m.v_head_dim * d
                else:
                    p += d * nh * hd + 2 * d * nkv * hd + nh * hd * d
            elif spec.kind == "mamba":
                mc = self.mamba
                di = mc.expand * d
                dtr = mc.resolved_dt_rank(d)
                p += d * 2 * di                      # in_proj (x and z)
                p += mc.d_conv * di                  # conv
                p += di * (dtr + 2 * mc.d_state)     # x_proj
                p += dtr * di + di                   # dt_proj (+bias)
                p += di * mc.d_state + di            # A_log, D
                p += di * d                          # out_proj
            a = p
            if spec.mlp == "dense":
                p += 3 * d * self.d_ff
                a += 3 * d * self.d_ff
            elif spec.mlp == "moe":
                w1 = 3 * d * self.moe.d_ff_expert
                p += self.moe.n_experts * w1 + d * self.moe.n_experts
                a += self.moe.top_k * w1 + d * self.moe.n_experts
            # norms
            p += 2 * d + (2 * d if self.post_block_norms else 0)
            a += 2 * d
            total += p
            active += a
        counts["blocks_total"] = total * self.n_groups
        counts["blocks_active"] = active * self.n_groups
        head = counts["embed"] + counts.get("lm_head", 0)
        counts["total"] = head + counts["blocks_total"]
        counts["active"] = head + counts["blocks_active"]
        return counts


# ---------------------------------------------------------------------------
# the input shapes of the dry run's cells (seq_len, global_batch, kind)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def runnable_shapes(cfg: ModelConfig):
    """The shapes of SHAPES that apply to `cfg`: no decode cell for an
    encoder-only model, long_500k only for a sub-quadratic one."""
    out = []
    for s in SHAPES.values():
        if s.kind == "decode" and not cfg.has_decode:
            continue
        if s.name == "long_500k" and not cfg.subquadratic:
            continue
        out.append(s)
    return out
