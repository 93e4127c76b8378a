"""The port's spans (``repro_torch.obs``) on the CPU: a shared no-op when
nothing reads them; under a CPU ``torch.profiler``, ``record_function``
ranges around each layer and each core attention of a prefill and a decode
step, and around the attention inside a checkpointed train step; inside a
capture, node ranges of the graph, here with every dispatched aten op
standing for a node (the driver's counts need a card:
``test_torch_obs_gpu.py``).

Reduced TinyLlama (2 layers) with parameters from a torch seed, in fp32.
"""

import dataclasses

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch import obs
from repro_torch.configs import get_config, reduced_config
from repro_torch.models import transformer as TF
from repro_torch.models.registry import build_model
from repro_torch.train.loop import value_and_grad

LAYERS, B, PROMPT, CACHE_LEN, PAGE = 2, 2, 8, 16, 4
STEPS = ["prefill", "decode", "paged"]


@pytest.fixture(scope="module")
def model():
    cfg = dataclasses.replace(reduced_config(get_config("tinyllama_1p1b")),
                              num_layers=LAYERS)
    params, _ = build_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    tok = torch.randint(0, cfg.vocab_size, (B, PROMPT + 1),
                        generator=torch.Generator().manual_seed(1),
                        dtype=torch.int32)
    return cfg, params, tok


def _entry(kind, cfg, params, tok):
    """A call of ``kind``: the prefill of a PROMPT-token prompt, or one
    decode step after it, over the dense or the paged cache."""
    def prefill():
        with torch.inference_mode():
            return TF.lm_prefill(params, cfg, tok[:, :PROMPT], CACHE_LEN)

    if kind == "prefill":
        return prefill
    _, cache = prefill()
    step = TF.lm_decode_step
    if kind == "paged":
        with torch.inference_mode():
            paged = TF.lm_init_paged_cache(cfg, B, CACHE_LEN, page=PAGE,
                                           device="cpu")
            for name in ("k", "v"):
                L, _, S, KV, hd = cache[name].shape
                paged[f"{name}_pool"].copy_(cache[name].reshape(
                    L, B * S // PAGE, PAGE, KV, hd))
        cache, step = paged, TF.lm_decode_step_paged

    def decode():
        with torch.inference_mode():
            return step(params, cfg, cache, PROMPT, tok[:, PROMPT:])

    return decode


def _nested(spans):
    """Check the spans [(name, start, end)]: LAYERS layers in increasing,
    disjoint ranges, one attend inside each, and no other name."""
    by = {n: sorted((s, e) for m, s, e in spans if m == n)
          for n in ("layer", "attend")}
    assert {m for m, _, _ in spans} == {"layer", "attend"}
    layers, attends = by["layer"], by["attend"]
    assert len(layers) == len(attends) == LAYERS
    assert all(s < e for s, e in layers)
    assert all(a[1] <= b[0] for a, b in zip(layers, layers[1:]))
    assert all(ls <= s < e <= le for (ls, le), (s, e) in zip(layers, attends))


@pytest.mark.parametrize("remat, attends", [("none", LAYERS), ("full", 2 * LAYERS),
                                             ("dots", 2 * LAYERS)])
def test_a_profiled_train_step_keeps_its_gradients(remat, attends, model):
    """The attend span inside a checkpointed layer body: a profiled step's
    loss and gradients equal the unprofiled step's, and the span is entered
    again where the layer is recomputed."""
    cfg, params, tok = model
    api = build_model(dataclasses.replace(cfg, remat=remat), "cpu")
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    want = value_and_grad(api, params, batch)[:2]
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        got = value_and_grad(api, params, batch)[:2]
    assert all(map(torch.equal, tree_leaves(got), tree_leaves(want)))
    assert sum(e.name == obs.PREFIX + "attend" for e in prof.events()) == attends


def test_span_is_one_shared_noop_without_profiler_or_capture():
    assert obs.span("layer") is obs.NULL
    assert obs.span("attend") is obs.NULL


@pytest.mark.parametrize("kind", STEPS)
def test_spans_under_the_cpu_profiler(kind, model):
    run = _entry(kind, *model)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        run()
    spans = [(e.name.removeprefix(obs.PREFIX), e.time_range.start,
              e.time_range.end)
             for e in prof.events() if e.name.startswith(obs.PREFIX)]
    _nested(spans)


class _Nodes(TorchDispatchMode):
    """Counts the aten ops dispatched: each stands for a node of a graph."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.fixture
def fake_driver(monkeypatch):
    """``obs``'s driver calls on a counter of dispatched ops."""
    nodes = _Nodes()
    monkeypatch.setattr(obs, "_capturing_graph", lambda: nodes)
    monkeypatch.setattr(obs, "_count", lambda graph: graph.n)
    monkeypatch.setattr(obs, "maps", [])
    return nodes


@pytest.mark.parametrize("kind", ["decode", "paged"])
def test_capture_notes_each_span_as_a_node_range(kind, model, fake_driver):
    run = _entry(kind, *model)
    with fake_driver, obs.capture() as m:
        run()
    assert obs.maps == [m] and obs._open is None
    assert m.nodes == fake_driver.n > 0
    assert [s[0] for s in m.spans][:2] == ["layer", "attend"]
    assert all(0 <= first < end <= m.nodes for _, first, end in m.spans)
    _nested([tuple(s) for s in m.spans])
    assert obs.span("layer") is obs.NULL


def test_a_failed_capture_keeps_no_map(fake_driver):
    with pytest.raises(ValueError), fake_driver, obs.capture():
        with obs.span("layer"):
            raise ValueError("the step failed")
    assert obs.maps == [] and obs._open is None
