"""The node map of a captured decode step (``obs.capture`` inside
``serve.engine.DecodeGraph``) against a profiled replay, on a card.  These
tests need CUDA and skip without it; they import no JAX, so they run on the
card's machine:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_obs_gpu.py -q

Reduced TinyLlama (2 layers) in bf16 with weights from a seed, decoding
over the dense cache and over the paged pool.  A replay's device
activities, in the order they start, are the graph's nodes in the order the
capture made them, so each span's node range picks out its own kernels.
"""

import dataclasses

import pytest
import torch
from torch.autograd import DeviceType

from repro_torch import obs
from repro_torch.configs import get_config, reduced_config
from repro_torch.models import transformer as TF
from repro_torch.models.registry import build_model
from repro_torch.serve.engine import DecodeGraph

LAYERS, B, PROMPT, CACHE_LEN, PAGE = 2, 4, 40, 64, 16
# A kernel that only the core attention launches, by step.
ATTEND = {"dense": "softmax", "paged": "paged_attention"}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA graph has no CPU mode")
    return torch.device("cuda")


def _graph(kind, device):
    """(DecodeGraph after its first call, params, cache, the next token)."""
    cfg = dataclasses.replace(reduced_config(get_config("tinyllama_1p1b")),
                              num_layers=LAYERS)
    api = build_model(cfg, device)
    params, _ = api.init(torch.Generator(device=device).manual_seed(0))
    tok = torch.randint(0, cfg.vocab_size, (B, PROMPT + 2), device=device,
                        generator=torch.Generator(device=device).manual_seed(1),
                        dtype=torch.int32)
    with torch.inference_mode():
        _, cache = api.prefill(params, {"tokens": tok[:, :PROMPT]}, CACHE_LEN)
        step = api.decode_step
        if kind == "paged":
            paged = TF.lm_init_paged_cache(cfg, B, CACHE_LEN, page=PAGE,
                                           device=device)
            for name in ("k", "v"):
                L, _, S, KV, hd = cache[name].shape
                paged[f"{name}_pool"].copy_(cache[name].reshape(
                    L, B * S // PAGE, PAGE, KV, hd))
            cache = paged
            step = lambda p, c, n, t: TF.lm_decode_step_paged(p, cfg, c, n, t)  # noqa: E731
        g = DecodeGraph(step, params, cache)
        g(params, cache, PROMPT, tok[:, PROMPT:PROMPT + 1])
    return g, params, cache, tok[:, PROMPT + 1:]


def _replay_activities(g, params, cache, tok):
    """The device activities of one profiled replay, in the order they
    start: those the profiler ties to the replay's ``cudaGraphLaunch``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with torch.inference_mode():
            g(params, cache, PROMPT + 1, tok)
        torch.cuda.synchronize()
    events = list(prof.profiler.kineto_results.events())
    launch = [e.correlation_id() for e in events
              if e.device_type() != DeviceType.CUDA
              and e.name().startswith("cudaGraphLaunch")]
    assert len(launch) == 1
    return sorted(((e.start_ns(), e.name()) for e in events
                   if e.device_type() == DeviceType.CUDA
                   and not e.is_user_annotation()
                   and e.correlation_id() == launch[0]))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_node_map_places_a_replays_activities(kind, cuda_device):
    """The map holds a layer and an attend span a layer, the layers in
    increasing, disjoint node ranges, each attend inside its layer; a
    profiled replay yields one activity a node, and the ones each attend
    span picks out hold the attention's own kernel."""
    g, params, cache, tok = _graph(kind, cuda_device)
    m = obs.maps[-1]
    spans = {n: [(f, e) for name, f, e in m.spans if name == n]
             for n in ("layer", "attend")}
    assert len(m.spans) == 2 * LAYERS
    layers = spans["layer"]
    assert len(layers) == len(spans["attend"]) == LAYERS
    assert all(0 <= f < e <= m.nodes for f, e in layers)
    assert all(a[1] <= b[0] for a, b in zip(layers, layers[1:]))
    assert all(lf <= f < e <= le for (lf, le), (f, e) in zip(layers, spans["attend"]))
    acts = _replay_activities(g, params, cache, tok)
    assert len(acts) == m.nodes
    for f, e in spans["attend"]:
        assert any(ATTEND[kind] in name.lower() for _, name in acts[f:e]), acts[f:e]
