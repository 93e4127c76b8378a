"""Granite-MoE-3B-A800M: 32L, d=1536, 24H (GQA kv=8), fine-grained MoE:
40 experts top-8, d_ff=512 per expert, vocab 49155.

[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]  NOTE: the pool entry says
both "40e top-8" and "32 experts"; we follow the structured field (40).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite_moe_3b_a800m", family="moe",
    num_layers=32, d_model=1536, num_heads=24, num_kv_heads=8,
    d_ff=512, vocab_size=49155, mlp="swiglu",
    num_experts=40, top_k=8,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base; hf",
)
