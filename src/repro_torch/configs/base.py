"""Config schema + shape grid for the assigned architectures.

Every architecture is a ``ModelConfig``; every workload cell is a
``ShapeConfig``.  ``applicable_shapes`` encodes the skip rules from
DESIGN.md §3 (long_500k only for sub-quadratic archs; decode only for archs
with a decoder).
"""

from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass, field


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int | None = None          # default d_model // num_heads
    mlp: str = "swiglu"                  # swiglu | geglu | gelu | relu
    norm: str = "rms"                    # rms | ln
    attention: str = "full"              # full | local_global
    window: int = 1024
    group_size: int = 6                  # local_global: 5 local + 1 global
    rope_theta: float = 1e4
    rope_theta_global: float = 1e6       # gemma3 global layers
    qkv_bias: bool = False
    mrope: bool = False
    tie_embeddings: bool = False
    # MoE
    num_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # SSM / hybrid
    ssm_kind: str = ""                   # mamba2 | rwkv6
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_expand: int = 2
    attn_every: int = 0                  # hybrid: shared attn block period
    # enc-dec
    encoder_layers: int = 0
    decoder_layers: int = 0
    # modality frontend stub ("": none)
    frontend: str = ""                   # audio | vision
    source: str = ""                     # provenance note
    # training memory policy: "full" remat, "dots" (save matmul outputs),
    # or "none" (save everything)
    remat: str = "full"
    # batch-pin activations during prefill lowering (measured per arch:
    # essential for MoE, harmful for the GLA-recurrence prefill of rwkv6)
    pin_prefill: bool = True

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to 256 so the embedding shards evenly over the
        model axis (MaxText-style logical vocab padding)."""
        return ((self.vocab_size + 255) // 256) * 256

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks), for roofline."""
        D, F, V = self.d_model, self.d_ff, self.vocab_size
        hd = self.hd
        emb = V * D * (1 if self.tie_embeddings else 2)
        att = D * self.num_heads * hd * 2 + D * self.num_kv_heads * hd * 2
        gated = self.mlp in ("swiglu", "geglu")
        mlp = D * F * (3 if gated else 2)
        if self.family == "moe":
            mlp = self.num_experts * mlp + D * self.num_experts
        if self.family == "ssm" and self.ssm_kind == "rwkv6":
            att = 5 * D * D + D * 64 * 2     # r/k/v/g/out + decay MLP
        if self.family == "hybrid":
            d_inner = self.ssm_expand * D
            m2 = (D * 2 * d_inner + D * 2 * self.ssm_state * self.ssm_heads
                  + D * self.ssm_heads + d_inner * D)
            n_attn = max(1, self.num_layers // max(1, self.attn_every))
            return emb + self.num_layers * (m2 + mlp) + att * 1  # shared attn
        if self.family == "encdec":
            enc = self.encoder_layers * (att + mlp)
            dec = self.decoder_layers * (att * 2 + mlp)  # + cross attn
            return emb + enc + dec
        return emb + self.num_layers * (att + mlp)

    def active_param_count(self) -> int:
        """MoE: params touched per token (for 6*N_active*D roofline)."""
        if self.family != "moe":
            return self.param_count()
        D, F = self.d_model, self.d_ff
        gated = self.mlp in ("swiglu", "geglu")
        mlp_one = D * F * (3 if gated else 2)
        att = (D * self.num_heads * self.hd * 2
               + D * self.num_kv_heads * self.hd * 2)
        emb = self.vocab_size * D * (1 if self.tie_embeddings else 2)
        return emb + self.num_layers * (att + self.top_k * mlp_one
                                        + D * self.num_experts)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}

ARCH_IDS = [
    "seamless_m4t_medium",
    "zamba2_1p2b",
    "gemma3_4b",
    "starcoder2_7b",
    "qwen2p5_14b",
    "tinyllama_1p1b",
    "rwkv6_7b",
    "qwen2_vl_72b",
    "granite_moe_3b_a800m",
    "dbrx_132b",
]

# archs that may run the 500k decode shape (sub-quadratic sequence mixing)
_LONG_OK = {"zamba2_1p2b", "gemma3_4b", "rwkv6_7b"}


def applicable_shapes(arch: str) -> dict[str, str]:
    """shape name -> 'run' or a skip reason (all 40 cells documented)."""
    out: dict[str, str] = {}
    for s in SHAPES.values():
        if s.name == "long_500k" and arch not in _LONG_OK:
            out[s.name] = "skip: pure full-attention arch (DESIGN.md §3)"
        else:
            out[s.name] = "run"
    return out


def get_config(arch: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.CONFIG


def reduced_config(cfg: ModelConfig) -> ModelConfig:
    """Small same-family config for CPU smoke tests."""
    changes: dict = dict(
        num_layers=min(cfg.num_layers, 4),
        d_model=128,
        num_heads=4,
        num_kv_heads=min(4, max(1, cfg.num_kv_heads * 4 // cfg.num_heads)),
        head_dim=32,
        d_ff=256,
        vocab_size=512,
    )
    if cfg.family == "moe":
        changes.update(num_experts=min(8, cfg.num_experts),
                       top_k=min(2, cfg.top_k), d_ff=64)
    if cfg.ssm_kind == "mamba2":
        changes.update(ssm_state=16, ssm_heads=8)
    if cfg.ssm_kind == "rwkv6":
        changes.update(num_heads=4, head_dim=32)
    if cfg.family == "hybrid":
        changes.update(num_layers=5, attn_every=2)
    if cfg.family == "encdec":
        changes.update(encoder_layers=2, decoder_layers=2)
    if cfg.attention == "local_global":
        changes.update(num_layers=4, group_size=2, window=64)
    return dataclasses.replace(cfg, **changes)
