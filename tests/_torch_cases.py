"""Attention case tables and seeded numpy inputs shared by the port's kernel
tests: ``test_torch_kernels.py`` (plain versions against the JAX package,
on the CPU) and ``test_torch_kernels_gpu.py`` (CUDA kernels against the
plain versions, on a card).  Nothing here imports JAX, so the card's
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
# B, Hq, Hkv, D, pool_pages, page, max_pages  (PA_CASES of tests/test_kernels.py)
PA_CASES = [
    (2, 8, 2, 64, 16, 16, 4),
    (1, 4, 4, 32, 8, 8, 8),
    (3, 16, 8, 128, 32, 32, 3),
    (2, 4, 1, 64, 8, 64, 2),
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
