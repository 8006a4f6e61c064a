"""jamba-1.5-large-398b [hybrid]: Mamba + attention 1:7 interleave, MoE.

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536, MoE 16 experts
top-2 [arXiv:2403.19887]. Super-block of 8 layers: attention at index 4
(1 attention : 7 Mamba), MoE on odd layers, dense FFN on even layers.
"""
from repro_torch.configs.base import (LayerSpec, MambaConfig, ModelConfig,
                                      MoEConfig, QuantConfig)


def _pattern():
    return tuple(LayerSpec(kind="attn" if i == 4 else "mamba",
                           mlp="moe" if i % 2 == 1 else "dense")
                 for i in range(8))


CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    pattern=_pattern(),
    moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=24576),
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
    rope_theta=10000.0,
    tie_embeddings=False,
    subquadratic=True,
    quant=QuantConfig(exclude=("x_proj", "dt_proj")),
)
