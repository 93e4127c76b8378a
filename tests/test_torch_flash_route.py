"""The flash-attention wrapper's route rules, on the CPU: bfloat16 calls take
the tensor-core kernel (``wgmma``), float32 calls the CUDA-core kernel
(``simt``), and anything else raises before a kernel library is built or
loaded; the backward's rule (``bwd_route``) is the same at every head dim,
D 320 included, and an autograd call asks the forward for the log-sum-exp
exactly where the backward takes the tensor cores.  The kernels themselves
are held against their plain versions on a card by
``test_torch_kernels_gpu.py``."""

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


@pytest.mark.parametrize("dtype,head_dim,route", [
    (torch.bfloat16, 32, "wgmma"),
    (torch.bfloat16, 64, "wgmma"),
    (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 320, "wgmma"),
    *[(torch.float32, d, "simt") for d in K.HEAD_DIMS],
])
def test_bwd_route_by_dtype_and_head_dim(dtype, head_dim, route):
    """The backward takes the tensor cores for bfloat16 at D 32, 64, 128
    and 320 (there dK and dV on two warpgroups); every float32 call stays
    on the CUDA-core kernel."""
    assert K.bwd_route(dtype, head_dim) == route


@pytest.mark.parametrize("dtype,head_dim,with_lse", [
    (torch.bfloat16, 320, True),
    (torch.bfloat16, 64, True),
    (torch.float32, 320, False),
    (torch.float32, 64, False),
])
def test_autograd_forward_writes_lse_for_the_wgmma_backward(dtype, head_dim, with_lse,
                                                           monkeypatch):
    """``FlashAttentionFn`` asks the forward launch for each row's
    log-sum-exp where ``bwd_route`` names the tensor-core backward (bfloat16,
    D 320 included) and not where it names the CUDA-core one (float32), and
    hands it to the backward launch.  The launches are replaced by
    recorders, so this runs on CPU tensors."""
    calls = {}

    def fwd(q, k, v, *, with_lse=False, **kw):
        calls["with_lse"] = with_lse
        B, Sq, Hq, _ = q.shape
        return torch.zeros_like(q), torch.zeros(B, Hq, Sq) if with_lse else None

    def bwd(q, k, v, o, do, *, lse=None, **kw):
        calls["lse"] = lse
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)

    monkeypatch.setattr(K, "flash_attention_fwd_cuda", fwd)
    monkeypatch.setattr(K, "flash_attention_bwd_cuda", bwd)
    q = torch.zeros(1, 8, 2, head_dim, dtype=dtype, requires_grad=True)
    k, v = (torch.zeros(1, 8, 1, head_dim, dtype=dtype, requires_grad=True)
            for _ in range(2))
    K.flash_attention_cuda(q, k, v).sum().backward()
    assert calls["with_lse"] is with_lse
    assert (calls["lse"] is not None) is with_lse
    assert K.bwd_route(dtype, head_dim) == ("wgmma" if with_lse else "simt")


@pytest.mark.parametrize("dtype,head_dim,error", [
    (torch.float16, 64, TypeError),
    (torch.float64, 128, TypeError),
    (torch.bfloat16, 96, ValueError),
    (torch.float32, 16, ValueError),
])
def test_unsupported_bwd_call_raises_before_any_library(dtype, head_dim, error,
                                                        monkeypatch):
    def no_build(*args, **kwargs):
        raise AssertionError("a kernel library was requested")

    monkeypatch.setattr(_build, "function", no_build)
    monkeypatch.setattr(_build, "build", no_build)
    libs = dict(_build._libs)
    bwd = K.flash_attention_bwd_cuda
    launches = (bwd.launches, dict(bwd.launches_by_route),
                K.flash_attention_cuda.launches)
    q = torch.zeros(1, 8, 2, head_dim, dtype=dtype)
    with pytest.raises(error, match="flash_attention_bwd_cuda"):
        bwd(q, q, q, q, q)
    with pytest.raises(error, match="flash_attention_bwd_cuda"):
        K.bwd_route(dtype, head_dim)
    assert _build._libs == libs
    assert (bwd.launches, bwd.launches_by_route,
            K.flash_attention_cuda.launches) == launches


def test_bwd_route_counters_cover_every_route():
    assert (set(K.flash_attention_bwd_cuda.launches_by_route) == set(K._BWD_LIBS)
            == {"wgmma", "simt"})

