"""RWKV6-7B ("Finch"): 32L, d=4096, attention-free, d_ff=14336, vocab 65536.
Data-dependent decay; constant-size decode state (runs long_500k).

[arXiv:2404.05892; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6_7b", family="ssm",
    num_layers=32, d_model=4096, num_heads=64, num_kv_heads=64,
    head_dim=64, d_ff=14336, vocab_size=65536, mlp="relu",
    ssm_kind="rwkv6", pin_prefill=False,  # §Perf: pins triple its prefill
    source="arXiv:2404.05892; hf",
)
