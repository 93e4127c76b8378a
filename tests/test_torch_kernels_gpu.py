"""The port's hand-written CUDA kernels against their plain PyTorch versions,
on a card.  These tests need CUDA and skip without it; they import no JAX,
so they run on the card's machine:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_kernels_gpu.py -q

Inputs and tolerances are those of ``test_torch_kernels.py``
(``_torch_cases.py``): 2e-5 for fp32 and 2e-2 for bf16.
"""

import numpy as np
import pytest
import torch

from _torch_cases import FA_CASES, PA_CASES, TOL, fa_inputs, pa_inputs
from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.paged_attention.kernel import paged_attention_cuda
from repro_torch.kernels.paged_attention.ref import paged_attention_ref

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _on(a: np.ndarray, device, dtype=None):
    t = torch.from_numpy(a).to(device)
    return t.to(DTYPES[dtype]) if dtype else t


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().cpu().numpy()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FA_CASES)
def test_flash_attention_cuda_matches_plain(case, dtype, cuda_device):
    B, Sq, Sk, Hq, Hkv, D, causal, window = case
    tq, tk, tv = (_on(a, cuda_device, dtype) for a in fa_inputs(case))
    out = flash_attention_cuda(tq, tk, tv, causal=causal, window=window)
    torch.cuda.synchronize()
    ref = attention_ref(tq, tk, tv, causal=causal, window=window)
    np.testing.assert_allclose(_np(out), _np(ref), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", PA_CASES)
def test_paged_attention_cuda_matches_plain(case, dtype, cuda_device):
    q, kp, vp, bt, sl = pa_inputs(case)
    tq, tk, tv = (_on(a, cuda_device, dtype) for a in (q, kp, vp))
    tbt, tsl = _on(bt, cuda_device), _on(sl, cuda_device)
    out = paged_attention_cuda(tq, tk, tv, tbt, tsl)
    torch.cuda.synchronize()
    ref = paged_attention_ref(tq, tk, tv, tbt, tsl)
    np.testing.assert_allclose(_np(out), _np(ref), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.gpu
def test_paged_attention_cuda_zero_length_gives_zeros(cuda_device):
    """seq_len == 0: zeros, as the Pallas kernel (the ref gives mean(V))."""
    q, kp, vp, bt, _ = pa_inputs(PA_CASES[0])
    tq, tk, tv, tbt = (_on(a, cuda_device) for a in (q, kp, vp, bt))
    out = paged_attention_cuda(tq, tk, tv, tbt,
                               torch.zeros(q.shape[0], dtype=torch.int32,
                                           device=cuda_device))
    assert torch.count_nonzero(out).item() == 0
