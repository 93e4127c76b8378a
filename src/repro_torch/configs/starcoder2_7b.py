"""StarCoder2-7B: 32L, d=4608, 36H (GQA kv=4), d_ff=18432, vocab 49152.
GQA + RoPE, plain-GELU MLP, learned biases.

[arXiv:2402.19173; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2_7b", family="dense",
    num_layers=32, d_model=4608, num_heads=36, num_kv_heads=4,
    d_ff=18432, vocab_size=49152, mlp="gelu", norm="ln", qkv_bias=True,
    rope_theta=1e5, source="arXiv:2402.19173; hf",
)
