"""The paper's model families, the tiny trained-from-scratch LMs (tiny
MLA and MoE members included) and qwen3-moe-235b-a22b (the port's own
copy of the reference's `configs/paper_models.py` and
`configs/qwen3_moe_235b_a22b.py`)."""
from repro_torch.configs.base import (LayerSpec, MLAConfig, ModelConfig,
                                      MoEConfig)

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
# byte-vocab (258) versions of the MLA and MoE block structures
TINY_MLA = TINY_LM.replace(
    name="tiny-mla", n_layers=2, d_model=128, d_ff=512,
    head_dim=24,  # qk head dim = nope(16) + rope(8)
    mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                  qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16),
)
TINY_MOE = TINY_LM.replace(
    name="tiny-moe", family="moe", n_layers=2, d_model=128, d_ff=512,
    pattern=(LayerSpec(kind="attn", mlp="moe"),),
    moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=256),
)

# qwen3-moe-235b-a22b: 94L d_model=4096 64H (GQA kv=4) d_ff_expert=1536
# vocab=151936, 128 experts top-8, qk_norm, head_dim=128.
QWEN3_MOE_235B_A22B = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe", n_layers=94, d_model=4096,
    n_heads=64, n_kv_heads=4, head_dim=128, d_ff=1536, vocab_size=151936,
    pattern=(LayerSpec(kind="attn", mlp="moe"),),
    moe=MoEConfig(n_experts=128, top_k=8, d_ff_expert=1536),
    qk_norm=True, rope_theta=1e6, tie_embeddings=False,
)
