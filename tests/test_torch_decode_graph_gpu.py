"""The captured decode step (``serve.engine.DecodeGraph``) against the
eager step, on a card.  These tests need CUDA and skip without it; they
import no JAX, so they run on the card's machine:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_decode_graph_gpu.py -q

Reduced TinyLlama (2 layers; dense, and paged at page 16 with head dim 64,
which takes the cluster-split paged kernel, or 32, which takes the
CUDA-core one), RWKV6-7B (2 layers), Zamba2-1.2B (3 layers: one group
and a tail), granite-MoE-3B (2 layers of 8 experts top-2; dense, and
paged on the split route) and gemma3_4b (5 layers: two groups of a
window layer and a global one, and a window tail; rings of 16 slots that
the prompt has wrapped, and the steps wrap again) and qwen2_vl_72b (2
layers; M-RoPE, a prompt whose first 8 positions are a seeded embeds
prefix; dense, and paged on the split route at head dim 64) in bf16 with
random weights from a seed.  A replay runs the
kernels the eager step launches, in the same order, on the same inputs, so
logits and state must be bitwise equal.
"""

import dataclasses

import pytest
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.kernels.paged_attention.kernel import paged_attention_cuda
from repro_torch.models import transformer as TF
from repro_torch.models.registry import build_model
from repro_torch.serve import engine
from repro_torch.serve.engine import BatchScheduler, DecodeGraph, Request

STEPS = ["dense", "paged_split", "paged_simt", "rwkv6", "zamba2", "moe",
         "moe_paged_split", "local_global", "vlm", "vlm_paged_split"]
ARCH = {"dense": "tinyllama_1p1b", "paged_split": "tinyllama_1p1b",
        "paged_simt": "tinyllama_1p1b", "rwkv6": "rwkv6_7b",
        "zamba2": "zamba2_1p2b", "moe": "granite_moe_3b_a800m",
        "moe_paged_split": "granite_moe_3b_a800m", "local_global": "gemma3_4b",
        "vlm": "qwen2_vl_72b", "vlm_paged_split": "qwen2_vl_72b"}
LAYERS = {"tinyllama_1p1b": dict(num_layers=2), "rwkv6_7b": dict(num_layers=2),
          "zamba2_1p2b": dict(num_layers=3, attn_every=2),
          "granite_moe_3b_a800m": dict(num_layers=2),
          "gemma3_4b": dict(num_layers=5, group_size=2, window=16),
          "qwen2_vl_72b": dict(num_layers=2)}
PAGED_ROUTE = {"paged_split": "split", "paged_simt": "simt",
               "moe_paged_split": "split", "vlm_paged_split": "split"}
B, PROMPT, N_STEPS, CACHE_LEN, PAGE = 4, 40, 8, 64, 16
EMBEDS = 8          # the vlm prompt's patch prefix


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA graph has no CPU mode")
    return torch.device("cuda")


def _api(kind, device):
    arch = ARCH[kind]
    changes = dict(LAYERS[arch])
    if PAGED_ROUTE.get(kind) == "split":
        changes["head_dim"] = 64
    cfg = dataclasses.replace(reduced_config(get_config(arch)), **changes)
    api = build_model(cfg, device)
    params, _ = api.init(torch.Generator(device=device).manual_seed(0))
    return api, params


def _start(kind, device):
    """(api, params, step, start state, tokens): the state after a prefill
    of PROMPT tokens; for the paged steps laid into the pool under a
    shuffled block table."""
    api, params = _api(kind, device)
    cfg = api.cfg
    gen = torch.Generator(device=device).manual_seed(1)
    tok = torch.randint(0, cfg.vocab_size, (B, PROMPT + N_STEPS),
                        generator=gen, device=device, dtype=torch.int32)
    batch = {"tokens": tok[:, :PROMPT]}
    if cfg.family == "vlm":
        batch["embeds"] = 0.02 * torch.randn(B, EMBEDS, cfg.d_model, generator=gen,
                                             device=device).bfloat16()
    with torch.inference_mode():
        _, state = api.prefill(params, batch, cache_len=CACHE_LEN)
    step = api.decode_step
    if kind in PAGED_ROUTE:
        paged = TF.lm_init_paged_cache(cfg, B, CACHE_LEN, page=PAGE,
                                       device=device)
        n = CACHE_LEN // PAGE
        perm = torch.randperm(B * n, generator=gen, device=device)
        paged["block_table"] = perm.int().view(B, n).contiguous()
        for name in ("k", "v"):
            L, _, S, KV, hd = state[name].shape
            paged[f"{name}_pool"][:, perm] = state[name].reshape(
                L, B * n, PAGE, KV, hd)
        state = paged
        step = lambda p, c, n, t: TF.lm_decode_step_paged(p, cfg, c, n, t)  # noqa: E731
    return api, params, step, state, tok


def _leaves(tree):
    return [t for t in engine.tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _equal(a, b):
    return all(torch.equal(u, v) for u, v in zip(_leaves(a), _leaves(b)))


def _kv(t, device):
    return torch.tensor(t, dtype=torch.int32, device=device)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", STEPS)
def test_replay_equals_eager_step(kind, cuda_device):
    """N_STEPS replays against N_STEPS eager steps from the same state:
    logits and every state tensor bitwise equal.  The kernel wrappers count
    the warm-up and captured launches on the first call, none on replays;
    the paged steps take the route their head dim names."""
    api, params, step, state, tok = _start(kind, cuda_device)
    static, eager = engine.tree_clone(state), engine.tree_clone(state)
    g = DecodeGraph(step, params, static)
    before = dict(paged_attention_cuda.launches_by_route)
    with torch.inference_mode():
        for i, t in enumerate(range(PROMPT, PROMPT + N_STEPS)):
            x = tok[:, t:t + 1]
            got, _ = g(params, static, _kv(t, cuda_device), x)
            if i == 0:
                first = dict(paged_attention_cuda.launches_by_route)
            want, eager = step(params, eager, t, x)
            assert torch.equal(got, want), f"logits differ at step {i}"
            assert _equal(static, eager), f"state differs at step {i}"
    torch.cuda.synchronize()
    route = PAGED_ROUTE.get(kind)
    per_capture = api.cfg.num_layers * (DecodeGraph.WARMUP + 1) if route else 0
    assert {r: first[r] - before[r] for r in first} == {
        r: per_capture * (r == route) for r in first}
    after = paged_attention_cuda.launches_by_route
    eager_launches = api.cfg.num_layers * N_STEPS if route else 0
    assert {r: after[r] - first[r] for r in after} == {
        r: eager_launches * (r == route) for r in after}


@pytest.mark.gpu
def test_paged_graph_follows_a_remapped_block_table(cuda_device):
    """Between replays every page moves to another physical page and the
    table is rewritten in place (what PagedKVEngine does when pages spill
    and come back): the replays read the new entries and give the logits of
    an eager run whose pages never moved."""
    api, params, step, state, tok = _start("paged_split", cuda_device)
    static, still = engine.tree_clone(state), engine.tree_clone(state)
    g = DecodeGraph(step, params, static)
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    with torch.inference_mode():
        for i, t in enumerate(range(PROMPT, PROMPT + N_STEPS)):
            if i % 3 == 1:
                P = static["k_pool"].shape[1]
                perm = torch.randperm(P, generator=gen, device=cuda_device)
                for name in ("k_pool", "v_pool"):
                    moved = torch.empty_like(static[name])
                    moved[:, perm] = static[name]
                    static[name].copy_(moved)
                static["block_table"].copy_(perm.int()[static["block_table"].long()])
            x = tok[:, t:t + 1]
            got, _ = g(params, static, _kv(t, cuda_device), x)
            want, still = step(params, still, t, x)
            assert torch.equal(got, want), f"logits differ at step {i}"
    assert not torch.equal(static["block_table"], still["block_table"])


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["tinyllama_1p1b", "rwkv6_7b", "zamba2_1p2b",
                                  "granite_moe_3b_a800m", "gemma3_4b",
                                  "qwen2_vl_72b"])
def test_graph_and_eager_schedulers_give_the_same_tokens(arch, cuda_device):
    kind = {"tinyllama_1p1b": "dense", "rwkv6_7b": "rwkv6",
            "zamba2_1p2b": "zamba2", "granite_moe_3b_a800m": "moe",
            "gemma3_4b": "local_global", "qwen2_vl_72b": "vlm"}[arch]
    api, params = _api(kind, cuda_device)
    prompts = torch.randint(0, api.cfg.vocab_size, (10, 4),
                            generator=torch.Generator().manual_seed(3)).numpy()
    generated = []
    for graph in (True, False):
        sched = BatchScheduler(api, params, slots=B, cache_len=32)
        assert isinstance(sched._decode, DecodeGraph)
        if not graph:
            sched._decode = api.decode_step
        reqs = [Request(i, p, max_new=6) for i, p in enumerate(prompts)]
        for r in reqs:
            sched.submit(r)
        done = steps = 0
        while done < len(reqs) and steps < 200:
            done += sched.step()
            steps += 1
        assert done == len(reqs)
        generated.append([r.generated for r in reqs])
    assert generated[0] == generated[1]


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["dense", "rwkv6"])
def test_decode_graph_refuses_foreign_tensors(kind, cuda_device):
    api, params, step, state, tok = _start(kind, cuda_device)
    g = DecodeGraph(step, params, state)
    x, n = tok[:, PROMPT:PROMPT + 1], _kv(PROMPT, cuda_device)
    with torch.inference_mode():
        g(params, state, n, x)
        for p, c in ((params, engine.tree_clone(state)),
                     (engine.tree_clone(params), state)):
            with pytest.raises(ValueError, match="other than the ones"):
                g(p, c, n, x)
        with pytest.raises(ValueError, match="shape"):
            g(params, state, n, tok[:1, PROMPT:PROMPT + 1])
    with pytest.raises(ValueError, match="CUDA"):
        DecodeGraph(step, params, [t.cpu() for t in _leaves(state)])


@pytest.mark.gpu
@pytest.mark.parametrize("route,D,page", [("split", 128, 16),
                                          ("simt", 128, 8)])
def test_paged_kernel_replays_from_a_graph(route, D, page, cuda_device):
    """The paged wrapper captured alone: the split route's cluster launch,
    and a simt-route call whose shared memory (G 8, D 128: about 76 KB)
    makes its launcher set the kernel's shared-memory limit on every
    launch.  One eager call first (the build, the split setup); the replay
    equals it bit for bit, counts no launch, and follows new q and
    ``seq_lens`` written into the captured inputs."""
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    B, Hq, Hkv, P, max_pages = 3, 16, 2, 24, 6
    q = torch.randn(B, Hq, D, generator=gen, device=cuda_device).bfloat16()
    kp, vp = (torch.randn(P, page, Hkv, D, generator=gen,
                          device=cuda_device).bfloat16() for _ in range(2))
    table = torch.randperm(P, generator=gen, device=cuda_device)[
        :B * max_pages].int().view(B, max_pages).contiguous()
    seq_lens = torch.tensor([page * max_pages, page + 1, 1], dtype=torch.int32,
                            device=cuda_device)
    before = dict(paged_attention_cuda.launches_by_route)
    eager = paged_attention_cuda(q, kp, vp, table, seq_lens)
    assert {r: c - before[r] for r, c in
            paged_attention_cuda.launches_by_route.items()} == {
        r: int(r == route) for r in before}
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = paged_attention_cuda(q, kp, vp, table, seq_lens)
    counted = dict(paged_attention_cuda.launches_by_route)
    g.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    q.copy_(torch.randn(B, Hq, D, generator=gen, device=cuda_device))
    seq_lens.copy_(torch.tensor([2, page * 3, page - 1], dtype=torch.int32))
    g.replay()
    want = paged_attention_cuda(q.clone(), kp, vp, table, seq_lens.clone())
    torch.cuda.synchronize()
    assert torch.equal(out, want)
    assert paged_attention_cuda.launches_by_route[route] == counted[route] + 1
