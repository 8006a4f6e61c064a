"""The paper's model families and the tiny trained-from-scratch LMs
(the port's own copy of the reference's `configs/paper_models.py`,
attention-only members)."""
from repro_torch.configs.base import LayerSpec, ModelConfig

OPT_125M = ModelConfig(
    name="opt-125m", family="dense", n_layers=12, d_model=768,
    n_heads=12, n_kv_heads=12, head_dim=64, d_ff=3072, vocab_size=50272,
    pattern=(LayerSpec(kind="attn", mlp="dense"),), tie_embeddings=True,
)
LLAMA2_7B = ModelConfig(
    name="llama2-7b", family="dense", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=32, head_dim=128, d_ff=11008, vocab_size=32000,
    pattern=(LayerSpec(kind="attn", mlp="dense"),), tie_embeddings=False,
)
BLOOM_560M = ModelConfig(
    name="bloom-560m", family="dense", n_layers=24, d_model=1024,
    n_heads=16, n_kv_heads=16, head_dim=64, d_ff=4096, vocab_size=250880,
    pattern=(LayerSpec(kind="attn", mlp="dense"),), tie_embeddings=True,
)

TINY_LM = ModelConfig(
    name="tiny-lm", family="dense", n_layers=4, d_model=256,
    n_heads=4, n_kv_heads=4, head_dim=64, d_ff=1024, vocab_size=258,
    pattern=(LayerSpec(kind="attn", mlp="dense"),), tie_embeddings=True,
    rope_theta=10000.0,
)
TINY_LM_WIDE = TINY_LM.replace(name="tiny-lm-wide", d_model=384, n_heads=6,
                               n_kv_heads=3, d_ff=1536, n_layers=4)
TINY_LM_DEEP = TINY_LM.replace(name="tiny-lm-deep", n_layers=8)
