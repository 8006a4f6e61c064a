"""qwen3-4b [dense]: qk_norm, GQA.

36L d_model=2560 32H (GQA kv=8) d_ff=9728 vocab=151936, head_dim=128.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-4b",
    family="dense",
    n_layers=36,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=9728,
    vocab_size=151936,
    pattern=(LayerSpec(kind="attn", mlp="dense"),),
    qk_norm=True,
    rope_theta=1e6,
    tie_embeddings=True,
)
