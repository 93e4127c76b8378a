"""SeamlessM4T-medium backbone: 12L enc + 12L dec, d=1024, 16H, vocab 256206.

[arXiv:2308.11596; hf]  Multimodal enc-dec; the audio frontend is a STUB —
input_specs provide precomputed frame embeddings (DESIGN.md §3).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless_m4t_medium", family="encdec",
    num_layers=24, encoder_layers=12, decoder_layers=12,
    d_model=1024, num_heads=16, num_kv_heads=16, d_ff=4096,
    vocab_size=256206, mlp="relu", norm="ln", frontend="audio",
    rope_theta=1e4, source="arXiv:2308.11596; hf",
)
