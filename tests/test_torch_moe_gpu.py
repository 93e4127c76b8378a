"""The port's MoE layer (``repro_torch.models.moe``) on a card.  These tests
need CUDA and skip without it; they import no JAX, so they run on the
card's machine:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_moe_gpu.py -q

Reduced granite-MoE's layer (E 8, top-2, D 128, F 64), B 4, S 64, at
capacity factor 0.5, so tokens drop.  Dispatch and gather must use no
atomics (two runs give the same bits), read nothing on the host (the layer
replays from a CUDA graph) and agree with the CPU in fp32 at 1e-4.
"""

import pytest
import torch

from repro_torch.models.moe import init_moe, moe_fwd

E, K, D, F_, B, S, CF = 8, 2, 128, 64, 4, 64, 0.5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _inputs(device, dtype=torch.bfloat16, seed=0):
    params, _ = init_moe(torch.Generator().manual_seed(seed), D, F_, E, K)
    x = torch.randn(B, S, D, generator=torch.Generator().manual_seed(seed + 1))
    return ({k: v.to(device, dtype) for k, v in params.items()},
            x.to(device, dtype))


def _fwd(params, x):
    return moe_fwd(params, x, num_experts=E, top_k=K, capacity_factor=CF)


@pytest.mark.gpu
def test_moe_fwd_on_cuda_gives_the_same_bits_twice(cuda_device):
    params, x = _inputs(cuda_device)
    with torch.inference_mode():
        (a, aux_a), (b, aux_b) = _fwd(params, x), _fwd(params, x)
    assert float(aux_a["dropped_frac"]) > 0.0
    assert torch.equal(a, b)
    assert all(torch.equal(aux_a[k], aux_b[k]) for k in aux_a)


@pytest.mark.gpu
def test_moe_fwd_on_cuda_matches_the_cpu_in_fp32(cuda_device):
    params, x = _inputs("cpu", torch.float32)
    with torch.inference_mode():
        want, want_aux = _fwd(params, x)
        got, got_aux = _fwd({k: v.to(cuda_device) for k, v in params.items()},
                            x.to(cuda_device))
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
    for k in want_aux:
        torch.testing.assert_close(got_aux[k].cpu(), want_aux[k], atol=1e-4,
                                   rtol=1e-4)


@pytest.mark.gpu
def test_moe_fwd_replays_from_a_graph(cuda_device):
    """Captured once, replayed on the captured input and then on a new one
    copied into it: each replay equals an eager call bit for bit."""
    params, x = _inputs(cuda_device)
    with torch.inference_mode():
        _fwd(params, x)                  # warm-up: library set-up
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            out, aux = _fwd(params, x)
        for new_input in (False, True):
            if new_input:
                x.copy_(torch.randn(B, S, D, generator=torch.Generator()
                                    .manual_seed(9)).to(x))
            g.replay()
            want, want_aux = _fwd(params, x.clone())
            torch.cuda.synchronize()
            assert torch.equal(out, want)
            assert torch.equal(aux["dropped_frac"], want_aux["dropped_frac"])
