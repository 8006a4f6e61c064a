"""falcon-mamba-7b [ssm]: attention-free Mamba-1.

64L d_model=4096 vocab=65024 ssm_state=16 [arXiv:2410.05355]. Pure
Mamba blocks, no separate FFN (d_ff=0).
"""
from repro_torch.configs.base import (LayerSpec, MambaConfig, ModelConfig,
                                      QuantConfig)

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=1,       # unused (attention-free)
    n_kv_heads=1,
    head_dim=64,
    d_ff=0,
    vocab_size=65024,
    pattern=(LayerSpec(kind="mamba", mlp="none"),),
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
    tie_embeddings=True,
    subquadratic=True,
    # matches the leaf x_proj only: the dt projection's leaf is dt_w,
    # which is packed (as in the reference)
    quant=QuantConfig(exclude=("x_proj", "dt_proj")),
)
