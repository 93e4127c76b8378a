"""Qwen2-VL-72B backbone: 80L, d=8192, 64H (GQA kv=8), d_ff=29568,
vocab 152064, M-RoPE, dynamic resolution.  Vision frontend is a STUB —
input_specs provide precomputed patch embeddings.

[arXiv:2409.12191; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2_vl_72b", family="vlm",
    num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=29568, vocab_size=152064, mlp="swiglu", qkv_bias=True,
    mrope=True, rope_theta=1e6, frontend="vision",
    source="arXiv:2409.12191; hf",
)
