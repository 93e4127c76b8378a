"""The encoder-decoder on a card: the flash kernel at the cross-attention
shapes, captured in CUDA graphs, and reduced SeamlessM4T-medium (2 + 2
layers, d_model 128, 4 heads of 32) decoding from a ``DecodeGraph``.
These tests need CUDA and skip without it; they import no JAX, so they
run on the card's machine:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_encdec_gpu.py -q

A replay runs the kernels the eager call launches, in the same order, on
the same inputs, so it must equal the eager call bit for bit.  The card
against the CPU path is held at 1e-4 in fp32 (summation order and the
flash kernel against its plain version are the only differences).
"""

import numpy as np
import pytest
import torch

from _torch_cases import FA_ENCDEC_CASES, TOL, fa_inputs
from repro_torch.configs import get_config, reduced_config
from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.models.registry import build_model
from repro_torch.serve import engine
from repro_torch.serve.engine import BatchScheduler, DecodeGraph, Request

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
ROUTE = {"float32": "simt", "bfloat16": "wgmma"}
B, S_ENC, PROMPT, N_STEPS, CACHE_LEN = 4, 48, 16, 8, 32


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels and CUDA graphs have no CPU mode")
    return torch.device("cuda")


def _qkv(case, dtype, device):
    return [torch.from_numpy(a).to(device, DTYPES[dtype]) for a in fa_inputs(case)]


def _routes_since(before):
    after = flash_attention_cuda.launches_by_route
    return {r: after[r] - before[r] for r in after}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FA_ENCDEC_CASES)
def test_flash_attention_cuda_at_encdec_shapes(case, dtype, cuda_device):
    """Non-causal, q_offset 0, Sq 1 / 16 / 130 against Sk 96 / 100 / 130:
    the wgmma kernel zero-fills queries past Sq and writes only rows below
    it."""
    q, k, v = _qkv(case, dtype, cuda_device)
    before = dict(flash_attention_cuda.launches_by_route)
    out = flash_attention_cuda(q, k, v, causal=False, q_offset=0)
    torch.cuda.synchronize()
    assert _routes_since(before) == {r: int(r == ROUTE[dtype]) for r in before}
    ref = attention_ref(q, k, v, causal=False, q_offset=0)
    assert out.shape == q.shape and out.dtype == q.dtype
    np.testing.assert_allclose(out.float().cpu().numpy(), ref.float().cpu().numpy(),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq", [1, 64])
def test_flash_attention_cuda_replays_from_a_graph(sq, dtype, cuda_device):
    """Captured once on each route (after one eager call, which on wgmma
    sets the kernel's shared-memory limit) and replayed on the captured
    inputs and on new ones copied into them: each replay equals an eager
    call bit for bit, and replays count no launch."""
    case = (2, sq, 200, 16, 16, 64, False, None)
    q, k, v = _qkv(case, dtype, cuda_device)
    with torch.inference_mode():
        flash_attention_cuda(q, k, v, causal=False, q_offset=0)
        torch.cuda.synchronize()
        before = dict(flash_attention_cuda.launches_by_route)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            out = flash_attention_cuda(q, k, v, causal=False, q_offset=0)
        captured = _routes_since(before)
        for new_input in (False, True):
            if new_input:
                for t in (q, k, v):
                    t.copy_(torch.randn_like(t, dtype=torch.float32))
            g.replay()
            want = flash_attention_cuda(q, k, v, causal=False, q_offset=0)
            torch.cuda.synchronize()
            assert torch.equal(out, want)
    assert captured == {r: int(r == ROUTE[dtype]) for r in captured}


def _to(tree, device, dtype=None):
    if isinstance(tree, dict):
        return {k: _to(v, device, dtype) for k, v in tree.items()}
    return tree.to(device, dtype)


def _api(device, dtype=torch.bfloat16):
    cfg = reduced_config(get_config("seamless_m4t_medium"))
    api = build_model(cfg, device)
    params, _ = api.init(torch.Generator(device=device).manual_seed(0))
    return api, _to(params, device, dtype)


def _inputs(cfg, device):
    gen = torch.Generator(device=device).manual_seed(1)
    frames = torch.randn(B, S_ENC, cfg.d_model, generator=gen, device=device)
    tok = torch.randint(0, cfg.vocab_size, (B, PROMPT + N_STEPS), generator=gen,
                        device=device, dtype=torch.int32)
    return frames, tok


@pytest.mark.gpu
def test_decode_graph_replays_equal_eager(cuda_device):
    """N_STEPS replays of the encdec decode step against N_STEPS eager
    steps from the same prefilled cache: logits and every cache tensor
    bitwise equal; the cross-attention runs the flash kernel at Sq 1 on
    wgmma, once a layer, in the warm-up and the capture only."""
    api, params = _api(cuda_device)
    frames, tok = _inputs(api.cfg, cuda_device)
    with torch.inference_mode():
        _, cache = api.prefill(params, {"tokens": tok[:, :PROMPT], "frames": frames},
                               cache_len=CACHE_LEN)
    static, eager = engine.tree_clone(cache), engine.tree_clone(cache)
    g = DecodeGraph(api.decode_step, params, static)
    before = dict(flash_attention_cuda.launches_by_route)
    with torch.inference_mode():
        for i, t in enumerate(range(PROMPT, PROMPT + N_STEPS)):
            x = tok[:, t:t + 1]
            got, _ = g(params, static, torch.tensor(t, dtype=torch.int32,
                                                    device=cuda_device), x)
            if i == 0:
                first = _routes_since(before)
            want, eager = api.decode_step(params, eager, t, x)
            assert torch.equal(got, want), f"logits differ at step {i}"
            assert all(torch.equal(a, b) for a, b in zip(
                engine.tree_leaves(static), engine.tree_leaves(eager)))
    torch.cuda.synchronize()
    n = api.cfg.decoder_layers * (DecodeGraph.WARMUP + 1)
    assert first == {r: n * (r == "wgmma") for r in first}
    assert _routes_since(before)["wgmma"] == n + api.cfg.decoder_layers * N_STEPS


@pytest.mark.gpu
def test_batch_scheduler_captured_equals_eager(cuda_device):
    api, params = _api(cuda_device)
    runs = []
    for captured in (True, False):
        sched = BatchScheduler(api, params, slots=4, cache_len=CACHE_LEN)
        assert isinstance(sched._decode, DecodeGraph)
        if not captured:
            sched._decode = api.decode_step
        rng = np.random.default_rng(0)
        reqs = [Request(i, rng.integers(0, api.cfg.vocab_size, size=4), max_new=6)
                for i in range(6)]
        for r in reqs:
            sched.submit(r)
        done = steps = 0
        while done < len(reqs) and steps < 100:
            done += sched.step()
            steps += 1
        assert done == len(reqs)
        runs.append([r.generated for r in reqs])
    assert runs[0] == runs[1]


@pytest.mark.gpu
def test_reduced_seamless_on_the_card_matches_the_cpu_fp32(cuda_device):
    """Forward, prefill and 4 decode steps in fp32, the card (flash on its
    fp32 route) against the CPU path (its plain version)."""
    api_cpu, params = _api("cpu", torch.float32)
    frames, tok = _inputs(api_cpu.cfg, "cpu")
    outs = {}
    for dev in ("cpu", cuda_device):
        api = build_model(api_cpu.cfg, dev)
        p = _to(params, dev)
        f, t = frames.to(dev), tok.to(dev)
        with torch.inference_mode():
            seq = [api.forward(p, {"tokens": t, "frames": f})[0]]
            logits, cache = api.prefill(p, {"tokens": t[:, :PROMPT], "frames": f},
                                        cache_len=CACHE_LEN)
            seq.append(logits)
            for i in range(PROMPT, PROMPT + 4):
                logits, cache = api.decode_step(p, cache, i, t[:, i:i + 1])
                seq.append(logits)
        outs[str(dev)] = [x.float().cpu() for x in seq]
    for a, b in zip(outs["cpu"], outs[str(cuda_device)]):
        torch.testing.assert_close(b, a, atol=1e-4, rtol=1e-4)
