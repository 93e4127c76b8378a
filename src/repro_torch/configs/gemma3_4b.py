"""Gemma3-4B: 34L, d=2560, 8H (GQA kv=4), d_ff=10240, vocab 262144.
5:1 local:global attention (window 1024), 128k context, tied embeddings.

[hf:google/gemma-3-1b-pt; unverified]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3_4b", family="dense",
    num_layers=34, d_model=2560, num_heads=8, num_kv_heads=4,
    d_ff=10240, vocab_size=262144, mlp="geglu",
    attention="local_global", window=1024, group_size=6,
    rope_theta=1e4, rope_theta_global=1e6, tie_embeddings=True,
    source="hf:google/gemma-3-1b-pt; unverified",
)
