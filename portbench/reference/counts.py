"""The benchmark's yardstick of work: the peaks of the chip, and the
operations and bytes of a decode step, a prefill and a flash-attention
call, computed from their shapes.

Each input byte is counted read once and each output byte written once,
whatever a kernel reads again; the operations are those the inputs need
(the causal pairs of a prefill, the live positions of a decode step).  So
the least time, the larger of operations over the peak rate and bytes over
the memory rate, is a true lower bound on a call's time.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet: dense bf16 tensor-core rate, HBM3 rate.
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
BF16 = 2


def least_seconds(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_BF16_FLOPS, nbytes / HBM_BYTES_PER_S)


def _dims(model: dict) -> tuple[int, int, int, int, int, int, int]:
    H, KV = model["num_heads"], model["num_kv_heads"]
    hd = model.get("head_dim") or model["d_model"] // H
    return (model["num_layers"], model["d_model"], H, KV, hd, model["d_ff"],
            model["vocab_size"])


def layer_matmul_params(model: dict) -> int:
    """Weights a token multiplies in one layer: Q, K, V, O and the MLP."""
    _, d, H, KV, hd, ff, _ = _dims(model)
    mlp = 3 if model["mlp"] in ("swiglu", "geglu") else 2
    return d * (H + 2 * KV) * hd + H * hd * d + mlp * d * ff


def layer_vector_params(model: dict) -> int:
    """The layer's biases and norm weights."""
    _, d, H, KV, hd, _, _ = _dims(model)
    norms = 2 * d if model["norm"] == "rms" else 4 * d
    return norms + ((H + 2 * KV) * hd if model["qkv_bias"] else 0)


def flash_pairs(Sq: int, Sk: int, causal: bool, q_offset: int) -> int:
    """(query, key) pairs a causal mask leaves, query i at position
    ``q_offset + i`` seeing keys 0..that position."""
    if not causal:
        return Sq * Sk
    total = 0
    for i in range(Sq):
        total += max(0, min(Sk, q_offset + i + 1))
    return total


def flash_call(B: int, Sq: int, Sk: int, Hq: int, Hkv: int, D: int,
               causal: bool = True, q_offset: int | None = None
               ) -> tuple[float, float]:
    """(operations, bytes) of one bf16 flash-attention forward call: two
    products of 2 * D operations per (query head, pair); q, k, v read once
    and the output written once."""
    if q_offset is None:
        q_offset = Sk - Sq
    pairs = flash_pairs(Sq, Sk, causal, q_offset)
    flops = 4.0 * B * Hq * D * pairs
    nbytes = BF16 * B * D * (2 * Sq * Hq + 2 * Sk * Hkv)
    return flops, float(nbytes)


def prefill_flops(model: dict, B: int, S: int) -> float:
    """A prefill of B prompts of S tokens: the layers' products over every
    token, causal attention, and the unembedding of each last position."""
    L, d, H, _, hd, _, V = _dims(model)
    dense = 2.0 * B * S * L * layer_matmul_params(model)
    attn = 4.0 * B * H * hd * L * (S * (S + 1) // 2)
    return dense + attn + 2.0 * B * d * V


def decode_step(model: dict, B: int, kv_len: int) -> tuple[float, float]:
    """(operations, bytes) of one decode step of B tokens at ``kv_len``
    cached positions: every weight read once (of the embedding table, the B
    rows looked up), the live K/V read once, the new K/V and the bf16
    logits written once."""
    L, d, H, KV, hd, _, V = _dims(model)
    matmul = L * layer_matmul_params(model) + d * V
    flops = 2.0 * B * matmul + 4.0 * B * H * hd * L * (kv_len + 1)
    weights = BF16 * (L * (layer_matmul_params(model) + layer_vector_params(model))
                      + d * V + d + B * d)
    kv_read = BF16 * 2 * L * B * kv_len * KV * hd
    kv_write = BF16 * 2 * L * B * KV * hd
    return flops, float(weights + kv_read + kv_write + BF16 * B * V)
