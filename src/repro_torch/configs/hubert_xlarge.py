"""hubert-xlarge [audio]: encoder-only transformer backbone.

48L d_model=1280 16H d_ff=5120 vocab=504 [arXiv:2106.07447]. Inputs are
precomputed frame embeddings (B, T, d_model); bidirectional attention,
no decode step. It runs through the training forward and loss
(models/model.py: forward, loss_fn); serving refuses it, as the
reference has no decode step for it.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab_size=504,
    pattern=(LayerSpec(kind="attn", mlp="dense"),),
    causal=False,
    has_decode=False,
    embed_input="frames",
    tie_embeddings=False,
    rope_theta=10000.0,
)
