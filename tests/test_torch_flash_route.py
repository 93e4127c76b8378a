"""The flash-attention wrapper's route rule, on the CPU: bfloat16 calls take
the tensor-core kernel (``wgmma``), float32 calls the CUDA-core kernel
(``simt``), and anything else raises before a kernel library is built or
loaded.  The kernels themselves are held against their plain versions on a
card by ``test_torch_kernels_gpu.py``."""

import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import kernel as K


@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "wgmma"),
                                         (torch.float32, "simt")])
@pytest.mark.parametrize("head_dim", K.HEAD_DIMS)
def test_route_by_dtype(dtype, route, head_dim):
    assert K.route(dtype, head_dim) == route


@pytest.mark.parametrize("dtype,head_dim,error", [
    (torch.float16, 64, TypeError),
    (torch.float64, 64, TypeError),
    (torch.bfloat16, 96, ValueError),
    (torch.float32, 16, ValueError),
])
def test_unsupported_call_raises_before_any_library(dtype, head_dim, error,
                                                    monkeypatch):
    def no_build(*args, **kwargs):
        raise AssertionError("a kernel library was requested")

    monkeypatch.setattr(_build, "function", no_build)
    monkeypatch.setattr(_build, "build", no_build)
    libs = dict(_build._libs)
    launches = (K.flash_attention_cuda.launches,
                dict(K.flash_attention_cuda.launches_by_route))
    q = torch.zeros(1, 8, 2, head_dim, dtype=dtype)
    with pytest.raises(error, match="flash_attention_cuda"):
        K.flash_attention_cuda(q, q, q)
    with pytest.raises(error):
        K.route(dtype, head_dim)
    assert _build._libs == libs
    assert (K.flash_attention_cuda.launches,
            K.flash_attention_cuda.launches_by_route) == launches


def test_route_counters_cover_every_route():
    assert set(K.flash_attention_cuda.launches_by_route) == set(K._LIBS)


def test_autograd_guard_raises_before_the_device_check(monkeypatch):
    """Flash has a backward now: a call that autograd would record goes
    through ``FlashAttentionFn`` and meets the same device check as any
    other call (a CPU tensor shows it), as it does under no_grad or
    inference_mode.  No library is built or loaded either way, and no
    launch is counted.  (gla_scan and paged attention keep their guard:
    ``test_torch_gla_route.py``, ``test_torch_paged_route.py``.)"""
    def no_build(*args, **kwargs):
        raise AssertionError("a kernel library was requested")

    monkeypatch.setattr(_build, "function", no_build)
    monkeypatch.setattr(_build, "build", no_build)
    launches = (K.flash_attention_cuda.launches,
                K.flash_attention_bwd_cuda.launches)
    q = torch.zeros(1, 8, 2, 64, requires_grad=True)
    k = torch.zeros(1, 8, 2, 64)
    with pytest.raises(ValueError, match="CUDA device"):
        K.flash_attention_cuda(q, k, k)
    with pytest.raises(ValueError, match="CUDA device"):
        K.flash_attention_cuda(k, k, k.clone().requires_grad_())
    for context in (torch.no_grad, torch.inference_mode):
        with context(), pytest.raises(ValueError, match="CUDA device"):
            K.flash_attention_cuda(q, k, k)
    with pytest.raises(ValueError, match="CUDA device"):
        K.flash_attention_bwd_cuda(k, k, k, k, k)
    assert (K.flash_attention_cuda.launches,
            K.flash_attention_bwd_cuda.launches) == launches
