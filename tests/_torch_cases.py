"""Kernel case tables and seeded numpy inputs shared by the port's kernel
tests: ``test_torch_kernels.py``, ``test_torch_flash_bwd.py`` and
``test_torch_ssm_scan.py`` (plain versions against the JAX package, on the
CPU) and
``test_torch_kernels_gpu.py`` (CUDA kernels against the plain versions, on
a card).  Nothing here imports JAX, so the card's
machine, which has none, can run the GPU tests."""

import numpy as np

# B, Sq, Sk, Hq, Hkv, D, causal, window  (FA_CASES of tests/test_kernels.py)
FA_CASES = [
    (2, 128, 128, 4, 2, 64, True, None),
    (1, 256, 256, 8, 8, 64, True, 64),
    (2, 64, 192, 4, 1, 32, False, None),
    (1, 128, 128, 6, 2, 128, True, None),
    (1, 64, 64, 2, 2, 64, True, 16),
    (1, 100, 100, 2, 2, 64, True, None),    # ragged
]
# B, Sq, Sk, Hq, Hkv, D, causal, window: the MoE family's heads, which no
# other path gives the flash kernel: granite-MoE (G = 3, D 64) and DBRX
# (G = 6, D 128), the second also at a ragged S.
FA_MOE_CASES = [
    (2, 256, 256, 6, 2, 64, True, None),
    (1, 192, 192, 12, 2, 128, True, None),
    (1, 100, 100, 12, 2, 128, True, None),
]
# B, Sq, Sk, Hq, Hkv, D, causal, window: the encoder-decoder's
# cross-attention (SeamlessM4T: G 1, never causal), one query against the
# source as at decode, a prompt shorter than the source as at prefill, and
# the encoder's Sq = Sk, at D 32 (the reduced config) and 64 (the full one),
# off the 64-row and 64-key tile grids.
FA_ENCDEC_CASES = [
    (2, 1, 96, 4, 4, 32, False, None),
    (2, 16, 100, 4, 4, 32, False, None),
    (2, 130, 130, 4, 4, 32, False, None),
    (2, 1, 96, 4, 4, 64, False, None),
    (2, 16, 100, 4, 4, 64, False, None),
    (2, 130, 130, 4, 4, 64, False, None),
]
# B, Sq, Sk, Hq, Hkv, D, causal, window: gemma3_4b's head dim (d_model 2560
# over 8 heads: D 320, five 64-column blocks) at its G 2, with a window
# shorter than the keys (local layers) and without (global layers), at S on
# the 64-row tile grid, at a ragged S and at Sq < Sk (q_offset Sk - Sq).
FA_GEMMA_CASES = [
    (1, 192, 192, 4, 2, 320, True, 64),
    (1, 128, 128, 4, 2, 320, True, None),
    (2, 100, 100, 2, 1, 320, True, 48),
    (1, 64, 192, 4, 2, 320, True, 100),
]
# B, Sq, Sk, Hq, Hkv, D, causal, window: qwen2_vl_72b's heads (64 over 8 of
# 128: G 8 at D 128, the heaviest query tile the wgmma kernel takes at D
# 128), on the 64-row tile grid, at a ragged S and at Sq < Sk.
FA_VLM_CASES = [
    (1, 256, 256, 16, 2, 128, True, None),
    (2, 130, 130, 8, 1, 128, True, None),
    (1, 64, 320, 16, 2, 128, True, None),
]
# B, Sq, Sk, Hq, Hkv, D, causal, window, q_offset: the flash backward
# (attention_bwd_ref against jax.vjp of the JAX chunked path in fp32 on the
# CPU; the backward kernel against attention_bwd_ref on a card).  G 8
# (TinyLlama's ratio), 3 (granite-MoE) and 1, causal and not, a window, an
# explicit q_offset with Sq != Sk, ragged S off the 64-row tiles, and D 32,
# 64, 128 and 320; every row sees at least one key (a row that sees none
# gets zero gradients here, where the JAX path's uniform softmax does not:
# the GPU tests check those rows against the plain version alone).
FA_BWD_CASES = [
    (2, 128, 128, 8, 1, 64, True, None, None),
    (1, 96, 96, 6, 2, 64, True, None, None),
    (2, 40, 136, 4, 4, 32, False, None, None),
    (1, 128, 128, 8, 1, 128, True, 48, None),
    (1, 64, 192, 4, 2, 64, True, None, 100),
    (1, 80, 80, 4, 2, 320, True, 32, None),
    (1, 48, 48, 2, 1, 320, False, None, None),
]
# B, Hq, Hkv, D, pool_pages, page, max_pages  (PA_CASES of tests/test_kernels.py)
PA_CASES = [
    (2, 8, 2, 64, 16, 16, 4),
    (1, 4, 4, 32, 8, 8, 8),
    (3, 16, 8, 128, 32, 32, 3),
    (2, 4, 1, 64, 8, 64, 2),
]
# Hq, Hkv, D, pool_pages, page, max_pages, seq_lens: calls of the split
# paged route (D 64 or 128, G = Hq / Hkv in 1..9, page a multiple of 16), at
# the G of the configs the paged path serves or will serve (Zamba2 1,
# granite 3, qwen2.5 5, DBRX 6, TinyLlama 8 at D 64 and qwen2_vl 8 at D 128,
# starcoder2 9).  The lengths straddle
# the page and split boundaries (C = min(max_pages, 8) ranks take pages
# r, r + C, ...): 1, page - 1, page, page + 1, C * page +- 1 and
# max_pages * page; the last case's table is wider than the pages used, so
# most ranks have no page.
PA_SPLIT_CASES = [
    (8, 8, 64, 40, 16, 8, (1, 15, 16, 17, 128)),
    (6, 2, 128, 40, 16, 12, (127, 128, 129, 192)),
    (20, 4, 128, 12, 128, 4, (512, 129, 1)),
    (32, 4, 64, 24, 128, 8, (1024, 513, 127)),
    (36, 4, 128, 48, 16, 10, (160, 129, 33, 8)),
    (36, 4, 64, 12, 128, 3, (384, 200)),
    (32, 4, 64, 64, 16, 32, (17, 16, 3)),
    (48, 8, 128, 16, 128, 5, (640, 513, 128, 1)),  # DBRX's heads
    (64, 8, 128, 40, 128, 9, (1152, 1025, 129, 1)),  # qwen2_vl_72b's heads
]
# B, H, S, K, V, chunk  (GLA_CASES of tests/test_kernels.py)
GLA_CASES = [
    (2, 4, 128, 64, 64, 32),
    (1, 2, 256, 32, 64, 64),
    (2, 1, 96, 16, 16, 32),
    (1, 3, 64, 128, 32, 16),
]
# B, H, S, chunk, layout, decay: calls of the tensor-core GLA route (bf16,
# K = V = 64).  layout "transposed" passes q/k/v as head-transposed views of
# (B, S, H, 64) buffers, as RWKV6 and Mamba2 do; decay "rwkv6" is a per-key
# log decay, "mamba2" one decay per head broadcast over K with stride 0,
# "strong" w = -2.5 everywhere.
GLA_MMA_CASES = [
    (2, 4, 256, 32, "contiguous", "rwkv6"),
    (2, 4, 256, 64, "contiguous", "rwkv6"),
    (2, 4, 256, 128, "contiguous", "rwkv6"),
    (1, 3, 500, 128, "contiguous", "rwkv6"),     # ragged S
    (1, 2, 200, 48, "contiguous", "rwkv6"),      # 3 query tiles a chunk
    (1, 2, 40, 16, "contiguous", "rwkv6"),       # 1 query tile, ragged
    (2, 3, 300, 128, "transposed", "rwkv6"),
    (2, 3, 256, 128, "transposed", "mamba2"),
    (1, 2, 256, 128, "contiguous", "strong"),
]
# Tolerances of the JAX kernel tests (tests/test_kernels.py), on the max
# absolute difference.
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def fa_inputs(case, seed=0):
    """q (B, Sq, Hq, D), k and v (B, Sk, Hkv, D), float32."""
    B, Sq, Sk, Hq, Hkv, D, causal, window = case
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, Hq, D), np.float32),
            rng.standard_normal((B, Sk, Hkv, D), np.float32),
            rng.standard_normal((B, Sk, Hkv, D), np.float32))


def fa_bwd_inputs(case, seed=6):
    """q (B, Sq, Hq, D), k and v (B, Sk, Hkv, D) and the output gradient
    do (B, Sq, Hq, D), float32."""
    B, Sq, Sk, Hq, Hkv, D = case[:6]
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, Hq, D), np.float32),
            rng.standard_normal((B, Sk, Hkv, D), np.float32),
            rng.standard_normal((B, Sk, Hkv, D), np.float32),
            rng.standard_normal((B, Sq, Hq, D), np.float32))


def pa_inputs(case, seed=2):
    """q, k/v pools, a random block table and seq_lens >= 1."""
    B, Hq, Hkv, D, P, page, maxp = case
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Hq, D), np.float32)
    kp = rng.standard_normal((P, page, Hkv, D), np.float32)
    vp = rng.standard_normal((P, page, Hkv, D), np.float32)
    bt = rng.integers(0, P, (B, maxp)).astype(np.int32)
    sl = np.asarray([maxp * page - 3] + [(maxp - 1) * page - 1] * (B - 1),
                    np.int32)[:B]
    return q, kp, vp, bt, sl


def pa_split_inputs(case, seed=5):
    """q, k/v pools, a random block table with distinct pages per sequence
    and the case's seq_lens."""
    Hq, Hkv, D, P, page, maxp, lens = case
    B = len(lens)
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Hq, D), np.float32)
    kp = rng.standard_normal((P, page, Hkv, D), np.float32)
    vp = rng.standard_normal((P, page, Hkv, D), np.float32)
    bt = np.stack([rng.permutation(P)[:maxp] for _ in range(B)]).astype(np.int32)
    return q, kp, vp, bt, np.asarray(lens, np.int32)


def gla_inputs(case, seed=4):
    """q, k (x0.5), v and the log decay w = -0.05 exp(N(0, 1)), float32, as
    tests/test_kernels.py::test_gla_xla_chunked draws them."""
    B, H, S, K, V, _ = case
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, S, K), np.float32) * 0.5
    k = rng.standard_normal((B, H, S, K), np.float32) * 0.5
    v = rng.standard_normal((B, H, S, V), np.float32)
    w = -np.exp(rng.standard_normal((B, H, S, K), np.float32)) * 0.05
    return q, k, v, w.astype(np.float32)


def gla_exact_bound_inputs(seed=0):
    """B 1, H 2, S 64, K = V = 16, chunk 32: every 7th position's w exactly
    0, w exactly -30 at one position and below it at another, and one key
    column whose w of -1.875 brings -a to exactly 60 at a chunk's last row
    (32 x 1.875, exact in fp32)."""
    case = (1, 2, 64, 16, 16, 32)
    q, k, v, w = gla_inputs(case, seed=seed)
    w[:, :, ::7] = 0.0
    w[:, :, 40, 2] = -30.0
    w[:, :, 45, 3] = -41.0
    w[:, 0, 0:32, 1] = -1.875
    return case, (q, k, v, w)


def gla_mma_inputs(case, seed=11):
    """q, k (x0.5), v as (B, S, H, 64) float32 and w as (B, S, H, 64), or
    (B, S, H, 1) for the "mamba2" decay (one per head), drawn as
    chip_smoke.py draws them."""
    B, H, S, _, _, decay = case
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, 64), np.float32) * 0.5
    k = rng.standard_normal((B, S, H, 64), np.float32) * 0.5
    v = rng.standard_normal((B, S, H, 64), np.float32)
    if decay == "strong":
        w = np.full((B, S, H, 64), -2.5, np.float32)
    else:
        w = -0.05 * np.exp(rng.standard_normal(
            (B, S, H, 1 if decay == "mamba2" else 64), np.float32))
    return q, k, v, w.astype(np.float32)
