"""chameleon-34b [vlm]: early-fusion token-in/token-out backbone.

48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536 (text + VQ image
tokens) [arXiv:2405.09818]. The backbone consumes a unified token
stream; qk-norm as in the published model.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    family="vlm",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=22016,
    vocab_size=65536,
    pattern=(LayerSpec(kind="attn", mlp="dense"),),
    qk_norm=True,
    rope_theta=10000.0,
    tie_embeddings=False,
)
