"""TinyLlama-1.1B: 22L, d=2048, 32H (GQA kv=4), d_ff=5632, vocab 32000.
Llama2-architecture small model; also the end-to-end training example.

[arXiv:2401.02385; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="tinyllama_1p1b", family="dense",
    num_layers=22, d_model=2048, num_heads=32, num_kv_heads=4,
    d_ff=5632, vocab_size=32000, mlp="swiglu",
    rope_theta=1e4, source="arXiv:2401.02385; hf",
)
