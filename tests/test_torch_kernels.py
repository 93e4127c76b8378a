"""Port's attention kernels: plain PyTorch versions against the JAX package.
The CUDA kernels are held against these plain versions on a card by
``test_torch_kernels_gpu.py``.

Inputs come from numpy with a fixed seed; bf16 inputs are rounded once in
float32 and cast on both sides, so both frameworks see the same bits.
Tolerances are those of the JAX kernel tests (tests/test_kernels.py):
2e-5 for fp32 and 2e-2 for bf16, on the max absolute difference.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cases import FA_CASES, PA_CASES, TOL, fa_inputs, pa_inputs
from repro.kernels.flash_attention.ops import flash_attention_xla as jax_fa_xla
from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref
from repro.kernels.paged_attention.ref import \
    paged_attention_ref as jax_paged_ref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.flash_attention.ops import flash_attention_xla
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.kernels.paged_attention.kernel import paged_attention_cuda
from repro_torch.kernels.paged_attention.ref import paged_attention_ref

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(a: np.ndarray, dtype: str):
    jd, td = DTYPES[dtype]
    return jnp.asarray(a).astype(jd), torch.from_numpy(a).to(td)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


# ---------------------------------------------------------------------------
# Flash attention: plain versions against JAX.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FA_CASES)
def test_flash_attention_xla_matches_jax(case, dtype):
    B, Sq, Sk, Hq, Hkv, D, causal, window = case
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in fa_inputs(case))
    ref = jax_fa_xla(jq, jk, jv, causal=causal, window=window,
                     block_q=64, block_k=64)
    out = flash_attention_xla(tq, tk, tv, causal=causal, window=window,
                              block_q=64, block_k=64)
    assert out.dtype == tq.dtype and out.shape == tq.shape
    np.testing.assert_allclose(_np(out), _np(ref), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FA_CASES)
def test_attention_ref_matches_jax(case, dtype):
    B, Sq, Sk, Hq, Hkv, D, causal, window = case
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in fa_inputs(case))
    ref = jax_attention_ref(jq, jk, jv, causal=causal, window=window)
    out = attention_ref(tq, tk, tv, causal=causal, window=window)
    np.testing.assert_allclose(_np(out), _np(ref), atol=TOL[dtype],
                               rtol=TOL[dtype])


def test_flash_dispatcher_takes_plain_path_on_cpu():
    tq, tk, tv = (torch.from_numpy(a) for a in fa_inputs(FA_CASES[0]))
    before = flash_attention_cuda.launches
    out = flash_attention(tq, tk, tv, block_q=64, block_k=64)
    assert flash_attention_cuda.launches == before
    np.testing.assert_allclose(_np(out), _np(attention_ref(tq, tk, tv)),
                               atol=2e-5)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(tq, tk, tv, impl="cuda")


# ---------------------------------------------------------------------------
# Paged attention: plain version against JAX.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", PA_CASES)
def test_paged_attention_ref_matches_jax(case, dtype):
    q, kp, vp, bt, sl = pa_inputs(case)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, kp, vp))
    ref = jax_paged_ref(jq, jk, jv, jnp.asarray(bt), jnp.asarray(sl))
    out = paged_attention_ref(tq, tk, tv, torch.from_numpy(bt),
                              torch.from_numpy(sl))
    assert out.dtype == tq.dtype and out.shape == tq.shape
    np.testing.assert_allclose(_np(out), _np(ref), atol=TOL[dtype],
                               rtol=TOL[dtype])


def test_paged_attention_respects_block_table():
    """Permuting physical pages + table together must not change results."""
    B, Hq, Hkv, D, P, page, maxp = 1, 4, 2, 32, 8, 16, 4
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((B, Hq, D), np.float32))
    kp = torch.from_numpy(rng.standard_normal((P, page, Hkv, D), np.float32))
    vp = torch.from_numpy(rng.standard_normal((P, page, Hkv, D), np.float32))
    bt = torch.tensor([[0, 1, 2, 3]], dtype=torch.int32)
    sl = torch.tensor([maxp * page], dtype=torch.int32)
    base = paged_attention(q, kp, vp, bt, sl)
    perm = torch.tensor([3, 0, 1, 2, 4, 5, 6, 7])
    inv = torch.argsort(perm).to(torch.int32)
    out = paged_attention(q, kp[perm], vp[perm], inv[bt.long()], sl)
    np.testing.assert_allclose(_np(base), _np(out), atol=1e-6)


def test_paged_dispatcher_takes_plain_path_on_cpu():
    q, kp, vp, bt, sl = (torch.from_numpy(a) for a in pa_inputs(PA_CASES[0]))
    before = paged_attention_cuda.launches
    out = paged_attention(q, kp, vp, bt, sl)
    assert paged_attention_cuda.launches == before
    np.testing.assert_allclose(_np(out), _np(paged_attention_ref(q, kp, vp, bt, sl)),
                               atol=0)
    with pytest.raises(ValueError, match="CUDA"):
        paged_attention(q, kp, vp, bt, sl, impl="cuda")
