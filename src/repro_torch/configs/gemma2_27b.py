"""gemma2-27b [dense]: local/global alternating attention, logit softcaps.

46L d_model=4608 32H (GQA kv=16) d_ff=36864 vocab=256000
[arXiv:2408.00118]. Super-block of 2: (local window 4096, global).
Sandwich (pre + post) norms, attention softcap 50, final logit softcap 30.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b",
    family="dense",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=36864,
    vocab_size=256000,
    pattern=(LayerSpec(kind="attn", mlp="dense", window=4096),
             LayerSpec(kind="attn", mlp="dense", window=None)),
    attn_softcap=50.0,
    final_softcap=30.0,
    post_block_norms=True,
    rope_theta=10000.0,
    tie_embeddings=True,
)
