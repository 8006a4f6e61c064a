"""minicpm3-4b [dense]: Multi-head Latent Attention (MLA).

62L d_model=2560 40H d_ff=6400 vocab=73448 [hf:openbmb/MiniCPM3-4B].
MLA: q_lora=768, kv_lora=256, rope 32, nope 64, v 64. The KV cache holds
the compressed latent (kv_lora + rope dims) per position.
"""
from repro_torch.configs.base import LayerSpec, MLAConfig, ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b",
    family="dense",
    n_layers=62,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    head_dim=96,  # qk head dim = nope(64) + rope(32)
    d_ff=6400,
    vocab_size=73448,
    pattern=(LayerSpec(kind="attn", mlp="dense"),),
    mla=MLAConfig(q_lora_rank=768, kv_lora_rank=256,
                  qk_nope_head_dim=64, qk_rope_head_dim=32, v_head_dim=64),
    rope_theta=10000.0,
    tie_embeddings=True,
)
