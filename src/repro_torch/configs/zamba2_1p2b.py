"""Zamba2-1.2B: 38 Mamba2 layers + ONE shared attention block applied
periodically (params reused), d=2048, 32H (GQA kv=32), d_ff=8192, state 64.

[arXiv:2411.15242; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2_1p2b", family="hybrid",
    num_layers=38, d_model=2048, num_heads=32, num_kv_heads=32,
    d_ff=8192, vocab_size=32000, mlp="swiglu",
    ssm_kind="mamba2", ssm_state=64, ssm_heads=64, ssm_expand=2,
    attn_every=6, source="arXiv:2411.15242; hf",
)
