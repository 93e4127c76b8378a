"""The decode steps with ``kv_len`` as a 0-d int32 tensor (what a captured
step reads), and the body and checks of ``serve.engine.DecodeGraph``, on
the CPU.

Reduced TinyLlama (2 layers; dense, and paged at page 4), RWKV6-7B (2
layers) and Zamba2-1.2B (3 layers, a shared attention block every 2: one
group and a one-layer tail) with JAX-initialised parameters cast to
float32.  A tensor ``kv_len`` runs the same operations as an int, so those
two are compared bitwise; against the JAX functions (fed
``jnp.asarray(t, jnp.int32)``) the tolerance is the parity files' 1e-4,
for summation order and float32 transcendental rounding.  The capture
itself needs a card: ``test_torch_decode_graph_gpu.py``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced_config
from repro.models import hybrid as JHY
from repro.models import ssm_stack as JSS
from repro.models import transformer as JTF
from repro.models.registry import build_model as jax_build_model
from repro.serve.engine import BatchScheduler as JaxBatchScheduler
from repro.serve.engine import Request as JaxRequest
from repro_torch.configs import get_config, reduced_config
from repro_torch.interop import to_numpy, to_torch
from repro_torch.models import hybrid as HY
from repro_torch.models import ssm_stack as SS
from repro_torch.models import transformer as TF
from repro_torch.models.registry import build_model
from repro_torch.serve import engine
from repro_torch.serve.engine import (BatchScheduler, DecodeGraph, Request,
                                      write_back)

TOL = dict(atol=1e-4, rtol=1e-4)
CPU = "cpu"
STEPS = ["dense", "paged", "rwkv6", "zamba2"]
ARCH = {"dense": "tinyllama_1p1b", "paged": "tinyllama_1p1b",
        "rwkv6": "rwkv6_7b", "zamba2": "zamba2_1p2b"}
LAYERS = {"tinyllama_1p1b": dict(num_layers=2), "rwkv6_7b": dict(num_layers=2),
          "zamba2_1p2b": dict(num_layers=3, attn_every=2)}
PROMPT, N_STEPS, CACHE_LEN, PAGE = 8, 4, 16, 4


@functools.lru_cache(maxsize=None)
def _model(arch):
    changes = LAYERS[arch]
    cfg = dataclasses.replace(reduced_config(get_config(arch)), **changes)
    jcfg = dataclasses.replace(jax_reduced_config(jax_get_config(arch)),
                               **changes)
    jparams, _ = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    jparams = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jparams)
    return cfg, jcfg, jparams, to_torch(jax.device_get(jparams), device=CPU)


def _tokens(B=2, S=PROMPT + N_STEPS, seed=3):
    return np.random.default_rng(seed).integers(0, 512, (B, S)).astype(np.int32)


def _start(kind):
    """(torch step, JAX step, params both sides, start states both sides,
    first position): the paged cache starts empty at position 0, the others
    after a prefill of PROMPT tokens."""
    cfg, jcfg, jparams, tparams = _model(ARCH[kind])
    tok = _tokens()
    if kind == "paged":
        tstate = TF.lm_init_paged_cache(cfg, 2, CACHE_LEN, page=PAGE,
                                        dtype=torch.float32, device=CPU)
        jstate = JTF.lm_init_paged_cache(jcfg, 2, CACHE_LEN, page=PAGE,
                                         dtype=jnp.float32)
        t0 = 0
    else:
        _, tstate = build_model(cfg, CPU).prefill(
            tparams, {"tokens": torch.from_numpy(tok[:, :PROMPT])},
            cache_len=CACHE_LEN)
        _, jstate = jax_build_model(jcfg).prefill(
            jparams, {"tokens": jnp.asarray(tok[:, :PROMPT])},
            cache_len=CACHE_LEN)
        t0 = PROMPT
    tstep, jstep = {
        "dense": (TF.lm_decode_step, JTF.lm_decode_step),
        "paged": (TF.lm_decode_step_paged, JTF.lm_decode_step_paged),
        "rwkv6": (SS.rwkv_decode_step, JSS.rwkv_decode_step),
        "zamba2": (HY.hybrid_decode_step, JHY.hybrid_decode_step)}[kind]
    return (lambda p, c, n, t: tstep(p, cfg, c, n, t),
            lambda p, c, n, t: jstep(p, jcfg, c, n, t),
            tparams, jparams, tstate, jstate, t0, tok)


def _leaves(tree):
    return [t for t in engine.tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _kv(t):
    return torch.tensor(t, dtype=torch.int32)


@pytest.mark.parametrize("kind", STEPS)
def test_tensor_kv_len_equals_int_path(kind):
    step, _, params, _, state, _, t0, tok = _start(kind)
    by_int, by_tensor = engine.tree_clone(state), engine.tree_clone(state)
    for t in range(t0, t0 + N_STEPS):
        x = torch.from_numpy(tok[:, t:t + 1])
        a, by_int = step(params, by_int, t, x)
        b, by_tensor = step(params, by_tensor, _kv(t), x)
        assert torch.equal(a, b)
        assert all(torch.equal(u, v)
                   for u, v in zip(_leaves(by_int), _leaves(by_tensor)))


@pytest.mark.parametrize("kind", STEPS)
def test_tensor_kv_len_matches_jax(kind):
    step, jstep, params, jparams, state, jstate, t0, tok = _start(kind)
    for t in range(t0, t0 + N_STEPS):
        logits, state = step(params, state, _kv(t),
                             torch.from_numpy(tok[:, t:t + 1]))
        jlogits, jstate = jstep(jparams, jstate, jnp.asarray(t, jnp.int32),
                                jnp.asarray(tok[:, t:t + 1]))
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    for a, b in zip(jax.tree_util.tree_leaves(to_numpy(state)),
                    jax.tree_util.tree_leaves(jax.device_get(jstate))):
        np.testing.assert_allclose(np.asarray(a, np.float32),
                                   np.asarray(b, np.float32), **TOL)


@pytest.mark.parametrize("kind", STEPS)
def test_write_back_equals_direct_call(kind):
    """The body a DecodeGraph captures leaves each step's new state in the
    static buffers (the same tensors every step) and returns the step's
    logits."""
    step, _, params, _, state, _, t0, tok = _start(kind)
    static, direct = engine.tree_clone(state), engine.tree_clone(state)
    ptrs = [t.data_ptr() for t in _leaves(static)]
    for t in range(t0, t0 + N_STEPS):
        x = torch.from_numpy(tok[:, t:t + 1])
        logits = write_back(step, params, static, _kv(t), x)
        want, direct = step(params, direct, _kv(t), x)
        assert torch.equal(logits, want)
        assert all(torch.equal(u, v)
                   for u, v in zip(_leaves(static), _leaves(direct)))
    assert [t.data_ptr() for t in _leaves(static)] == ptrs
    moved = [not torch.equal(u, v)
             for u, v in zip(_leaves(static), _leaves(state))]
    assert any(moved)


def test_decode_graph_refuses_the_cpu():
    step, _, params, _, state, _, _, _ = _start("dense")
    with pytest.raises(ValueError, match="CUDA"):
        DecodeGraph(step, params, state)


@pytest.mark.parametrize("kind", ["paged", "rwkv6"])
def test_decode_graph_refuses_foreign_tensors(kind, monkeypatch):
    """Params or a cache other than the captured ones raise before anything
    is captured or replayed (the device check is stood in for: the check
    of the tensors needs no card)."""
    monkeypatch.setattr(engine, "_cuda_device", lambda cache: torch.device(CPU))
    step, _, params, _, state, _, t0, tok = _start(kind)
    g = DecodeGraph(step, params, state)
    x = torch.from_numpy(tok[:, t0:t0 + 1])
    other = engine.tree_clone(state)
    if kind == "paged":   # a table remapped by reassignment, not in place
        swapped = dict(state, block_table=state["block_table"].flip(0).contiguous())
    else:                 # one leaf of another shape
        swapped = (state[0][:1], *state[1:])
    more_params = dict(params, final_norm=params["final_norm"].clone())
    for p, c in ((params, other), (params, swapped), (more_params, state)):
        with pytest.raises(ValueError, match="other than the ones"):
            g(p, c, _kv(t0), x)
    assert g.graph is None


@pytest.mark.parametrize("arch", ["tinyllama_1p1b", "rwkv6_7b", "zamba2_1p2b"])
def test_cpu_scheduler_is_eager_and_equals_jax(arch):
    cfg, jcfg, jparams, tparams = _model(arch)
    api = build_model(cfg, CPU)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 512, size=4) for _ in range(5)]
    generated = []
    for sched_cls, req_cls, a, p in ((BatchScheduler, Request, api, tparams),
                                     (JaxBatchScheduler, JaxRequest,
                                      jax_build_model(jcfg), jparams)):
        sched = sched_cls(a, p, slots=2, cache_len=CACHE_LEN)
        reqs = [req_cls(i, q, max_new=3) for i, q in enumerate(prompts)]
        for r in reqs:
            sched.submit(r)
        done = steps = 0
        while done < len(reqs) and steps < 100:
            done += sched.step()
            steps += 1
        generated.append([r.generated for r in reqs])
        if sched_cls is BatchScheduler:
            assert sched._decode is api.decode_step
    assert generated[0] == generated[1]


def test_launch_serve_says_the_cpu_step_is_eager(capsys):
    from repro_torch.launch import serve
    serve.main(["--device", "cpu", "--requests", "2", "--max-new", "2",
                "--slots", "2"])
    assert "decode step: eager (cpu)" in capsys.readouterr().out


@pytest.fixture(scope="module")
def sharded_decode():
    """A gloo world of one, its 1 x 1 mesh, and reduced TinyLlama's sharded
    decode step (``make_serve_fns``) with params, cache and tokens placed
    by the step's ``in_specs``; torn down after the module."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.serve.engine import make_serve_fns
    from repro_torch.train.loop import abstract_init

    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("gloo", store=dist.FileStore(f"{tmp}/store", 1),
                                rank=0, world_size=1)
        try:
            mesh = make_test_mesh(device=CPU)
            cfg, _, _, tparams = _model("tinyllama_1p1b")
            api = build_model(cfg, CPU)
            _, axes = abstract_init(api)
            tok = _tokens()
            _, cache = api.prefill(tparams, {"tokens": torch.from_numpy(tok[:, :PROMPT])},
                                   CACHE_LEN)
            run = make_serve_fns(api, mesh, axes,
                                 ShapeConfig("d", "decode", CACHE_LEN, 2))[1](cache)
            pspecs, cspecs, tok_spec = run.in_specs
            tokens = sh.place(torch.from_numpy(tok), tok_spec, mesh)
            yield (run, sh.place(tparams, pspecs, mesh), sh.place(cache, cspecs, mesh),
                   tokens)
        finally:
            dist.destroy_process_group()


def test_signature_tells_dtensor_caches_of_equal_shapes_apart(sharded_decode):
    """A DTensor's own ``data_ptr`` is 0, so a cache is keyed by its local
    shards' addresses (and its placements and mesh): a clone of equal
    shapes and placements is another cache."""
    from torch.distributed.tensor import DTensor
    _, params, cache, _ = sharded_decode
    clone = engine.tree_clone(cache)
    assert all(isinstance(t, DTensor) and t.placements == u.placements
               for t, u in zip(_leaves(clone), _leaves(cache)))
    assert engine._signature(clone) != engine._signature(cache)
    assert engine._signature(cache) == engine._signature(cache)
    assert engine._signature(engine.tree_clone(params)) != engine._signature(params)


def test_sharded_write_back_equals_the_eager_sharded_step(sharded_decode, monkeypatch):
    """The body a DecodeGraph captures, on the sharded step's DTensors
    without autograd (as the capture runs it), leaves the eager sharded
    step's state in the same buffers and returns its logits; and a
    DecodeGraph built on that cache refuses a clone of it."""
    from torch.distributed.tensor import DTensor
    run, params, cache, tokens = sharded_decode
    static, direct = engine.tree_clone(cache), engine.tree_clone(cache)
    ptrs = [t.to_local().data_ptr() for t in _leaves(static)]
    for t in range(PROMPT, PROMPT + N_STEPS):
        x = tokens[:, t:t + 1]
        with torch.no_grad():
            logits = write_back(run, params, static, _kv(t), x)
        want, direct = run(params, direct, _kv(t), x)
        assert isinstance(logits, DTensor)
        assert torch.equal(logits.full_tensor(), want.full_tensor())
        assert all(torch.equal(u.full_tensor(), v.full_tensor())
                   for u, v in zip(_leaves(static), _leaves(direct)))
    assert [t.to_local().data_ptr() for t in _leaves(static)] == ptrs
    monkeypatch.setattr(engine, "_cuda_device", lambda cache: torch.device(CPU))
    g = DecodeGraph(run, params, static)
    with pytest.raises(ValueError, match="other than the ones"):
        g(params, engine.tree_clone(static), _kv(PROMPT), tokens[:, PROMPT:PROMPT + 1])
