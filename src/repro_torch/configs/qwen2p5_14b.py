"""Qwen2.5-14B: 48L, d=5120, 40H (GQA kv=8), d_ff=13824, vocab 152064.
QKV bias, SwiGLU.

[hf:Qwen/Qwen2.5-0.5B; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2p5_14b", family="dense",
    num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8,
    d_ff=13824, vocab_size=152064, mlp="swiglu", qkv_bias=True,
    rope_theta=1e6, source="hf:Qwen/Qwen2.5-0.5B; hf",
)
