"""DBRX-132B: 40L, d=6144, 48H (GQA kv=8), MoE 16 experts top-4,
d_ff=10752 per expert, vocab 100352, fine-grained experts.

[hf:databricks/dbrx-base; unverified]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="dbrx_132b", family="moe",
    num_layers=40, d_model=6144, num_heads=48, num_kv_heads=8,
    d_ff=10752, vocab_size=100352, mlp="swiglu", norm="ln",
    num_experts=16, top_k=4, rope_theta=5e5,
    source="hf:databricks/dbrx-base; unverified",
)
