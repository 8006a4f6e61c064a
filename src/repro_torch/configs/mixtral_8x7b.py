"""mixtral-8x7b [moe]: 8 experts top-2, sliding-window attention.

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000 [arXiv:2401.04088].
Window 4096 on every layer.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    pattern=(LayerSpec(kind="attn", mlp="moe", window=4096),),
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=14336),
    rope_theta=1e6,
    tie_embeddings=False,
    subquadratic=True,
)
