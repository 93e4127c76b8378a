"""Port's attention-free and hybrid models against the JAX package: the
Mamba2 and RWKV6 mixers (``models/ssm.py``), the RWKV6 stack on a reduced
rwkv6_7b (4 layers, d_model 128, 4 heads of 32) and the Zamba2 hybrid on a
reduced zamba2_1p2b (5 Mamba2 layers, attn_every 2, so two groups and a
one-layer tail), the registry members, the serving scheduler and launcher.

Both sides run JAX-initialised parameters cast to float32, so the only
differences are summation order and float32 transcendental rounding.
Tolerance: 1e-4 absolute and relative on outputs, logits and decode states
(all O(1)-O(10)); the schedulers' greedy tokens must be equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced_config
from repro.models import hybrid as JHY
from repro.models import ssm as JSSM
from repro.models import ssm_stack as JSS
from repro.models.registry import build_model as jax_build_model
from repro.serve.engine import BatchScheduler as JaxBatchScheduler
from repro.serve.engine import Request as JaxRequest
from repro_torch.configs import SHAPES, get_config, reduced_config
from repro_torch.interop import to_numpy, to_torch
from repro_torch.launch import serve
from repro_torch.models import hybrid as HY
from repro_torch.models import ssm as SSM
from repro_torch.models import ssm_stack as SS
from repro_torch.models.registry import build_model
from repro_torch.serve.engine import BatchScheduler, Request

TOL = dict(atol=1e-4, rtol=1e-4)
CPU = "cpu"
ARCHS = ["rwkv6_7b", "zamba2_1p2b"]


def _f32(tree):
    return jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), tree)


def _close(t, j, **tol):
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_allclose(
            np.asarray(a, np.float32), np.asarray(b, np.float32), **(tol or TOL)),
        to_numpy(t), jax.device_get(j))


def _tokens(B, S, vocab=512, seed=3):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(np.int32)


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    arch = request.param
    cfg = reduced_config(get_config(arch))
    jcfg = jax_reduced_config(jax_get_config(arch))
    jparams, _ = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    jparams = _f32(jparams)
    return arch, cfg, jcfg, jparams, to_torch(jax.device_get(jparams), device=CPU)


# ---------------------------------------------------------------------------
# Mixers.
# ---------------------------------------------------------------------------


def _mixer_params(init, *args):
    jp, jaxes = init(jax.random.PRNGKey(1), *args)
    jp = _f32(jp)
    # Non-zero conv taps and mix coefficients, so the short conv and the
    # token shift are exercised (their inits are zeros).
    for name in ("conv", "mix"):
        if name in jp:
            jp[name] = jnp.asarray(_x(jp[name].shape, 11) * 0.3)
    return jp, to_torch(jax.device_get(jp), device=CPU), jaxes


@pytest.mark.parametrize("with_carry", [False, True])
def test_mamba2_fwd_matches_jax(with_carry):
    D, state, H = 64, 16, 4
    jp, tp, _ = _mixer_params(JSSM.init_mamba2, D, state, H)
    x = _x((2, 24, D), 12)
    kw = dict(state=state, num_heads=H, chunk=16)
    carry = None
    if with_carry:
        carry = (_x((2, SSM.CONV_K - 1, 2 * D), 13),
                 _x((2, H, state, 2 * D // H), 14))
    jout = JSSM.mamba2_fwd(jp, jnp.asarray(x), carry=carry and tuple(
        map(jnp.asarray, carry)), **kw)
    tout = SSM.mamba2_fwd(tp, torch.from_numpy(x), carry=carry and tuple(
        map(torch.from_numpy, carry)), **kw)
    _close(tout, jout)
    if with_carry:  # one decode step from the carried state
        x1 = x[:, :1]
        jout = JSSM.mamba2_fwd(jp, jnp.asarray(x1), carry=jout[1],
                               decode=True, **kw)
        tout = SSM.mamba2_fwd(tp, torch.from_numpy(x1), carry=tout[1],
                              decode=True, **kw)
        _close(tout, jout)


@pytest.mark.parametrize("with_carry", [False, True])
def test_rwkv6_fwd_matches_jax(with_carry):
    D, H = 64, 2
    jp, tp, _ = _mixer_params(JSSM.init_rwkv6, D, H)
    x = _x((2, 40, D), 15)
    carry = None
    if with_carry:
        carry = (_x((2, 1, D), 16), _x((2, H, D // H, D // H), 17))
    kw = dict(num_heads=H, chunk=16)
    jout = JSSM.rwkv6_fwd(jp, jnp.asarray(x), carry=carry and tuple(
        map(jnp.asarray, carry)), **kw)
    tout = SSM.rwkv6_fwd(tp, torch.from_numpy(x), carry=carry and tuple(
        map(torch.from_numpy, carry)), **kw)
    _close(tout, jout)
    if with_carry:
        x1 = x[:, :1]
        jout = JSSM.rwkv6_fwd(jp, jnp.asarray(x1), carry=jout[1], decode=True,
                              **kw)
        tout = SSM.rwkv6_fwd(tp, torch.from_numpy(x1), carry=tout[1],
                             decode=True, **kw)
        _close(tout, jout)


def test_mixer_inits_match_jax_axes_and_shapes():
    for jinit, tinit, args in ((JSSM.init_mamba2, SSM.init_mamba2, (64, 16, 4)),
                               (JSSM.init_rwkv6, SSM.init_rwkv6, (64, 2))):
        jp, jaxes = jinit(jax.random.PRNGKey(0), *args)
        tp, taxes = tinit(torch.Generator().manual_seed(0), *args)
        assert taxes == jaxes
        assert {k: tuple(v.shape) for k, v in tp.items()} == \
            {k: tuple(v.shape) for k, v in jp.items()}
        assert {k: str(v.dtype) for k, v in to_numpy(tp).items()} == \
            {k: "float32" if v.dtype == jnp.bfloat16 else str(v.dtype)
             for k, v in jp.items()}


# ---------------------------------------------------------------------------
# Stacks.
# ---------------------------------------------------------------------------


def test_native_init_matches_jax_shapes_and_axes(model):
    arch, cfg, jcfg, _, _ = model
    tp, taxes = build_model(cfg, device=CPU).init(torch.Generator().manual_seed(0))
    jp, jaxes = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    assert taxes == jaxes
    tl = jax.tree_util.tree_leaves(to_numpy(tp))
    jl = jax.tree_util.tree_leaves(jp)
    assert [a.shape for a in tl] == [a.shape for a in jl]


def test_forward_matches_jax(model):
    arch, cfg, jcfg, jparams, tparams = model
    tok = _tokens(2, 40)
    fwd = {"rwkv6_7b": (JSS.rwkv_forward, SS.rwkv_forward),
           "zamba2_1p2b": (JHY.hybrid_forward, HY.hybrid_forward)}[arch]
    jlogits, _ = fwd[0](jparams, jcfg, jnp.asarray(tok))
    tlogits, aux = fwd[1](tparams, cfg, torch.from_numpy(tok))
    assert float(aux) == 0.0
    _close(tlogits, jlogits)


def test_prefill_and_decode_match_jax(model):
    """Prefill of 20 tokens (one chunk: C = min(128, S)) and four decode
    steps through the recurrence; logits and the whole decode state, leaf
    for leaf."""
    arch, cfg, jcfg, jparams, tparams = model
    japi, tapi = jax_build_model(jcfg), build_model(cfg, device=CPU)
    tok = _tokens(2, 24)
    jlog, jst = japi.prefill(jparams, {"tokens": jnp.asarray(tok[:, :20])},
                             cache_len=24)
    tlog, tst = tapi.prefill(tparams, {"tokens": torch.from_numpy(tok[:, :20])},
                             cache_len=24)
    _close(tlog, jlog)
    _close(tst, jst)
    for t in range(20, 24):
        jlog, jst = japi.decode_step(jparams, jst, t, jnp.asarray(tok[:, t:t + 1]))
        tlog, tst = tapi.decode_step(tparams, tst, t,
                                     torch.from_numpy(tok[:, t:t + 1]))
        _close(tlog, jlog)
    _close(tst, jst)


def test_decode_continues_prefill(model):
    """prefill(S) then n decode steps == the last logits of prefill(S + n):
    the scan's final state carries on through the recurrence."""
    _, cfg, _, _, tparams = model
    api = build_model(cfg, device=CPU)
    tok = torch.from_numpy(_tokens(2, 140, seed=6))
    _, st = api.prefill(tparams, {"tokens": tok[:, :136]}, cache_len=140)
    for t in range(136, 140):
        lg, st = api.decode_step(tparams, st, t, tok[:, t:t + 1])
    full, _ = api.prefill(tparams, {"tokens": tok}, cache_len=140)
    np.testing.assert_allclose(lg.numpy(), full.numpy(), **TOL)


def test_registry_members_and_specs(model):
    arch, cfg, jcfg, _, _ = model
    api = build_model(cfg, device=CPU)
    jfields = [f.name for f in dataclasses.fields(jax_build_model(jcfg))]
    assert [f.name for f in dataclasses.fields(api)][:len(jfields)] == jfields
    assert api.device.type == "cpu"
    for shape in ("prefill_32k", "decode_32k"):
        tspecs = api.input_specs(SHAPES[shape])
        jspecs = jax_build_model(jcfg).input_specs(SHAPES[shape])
        tl = jax.tree_util.tree_leaves(tspecs)
        jl = jax.tree_util.tree_leaves(jspecs)
        assert all(t.device.type == "meta" for t in tl)
        assert [tuple(t.shape) for t in tl] == [tuple(j.shape) for j in jl]
        assert [str(t.dtype).replace("torch.", "") for t in tl] == \
            [str(j.dtype) for j in jl]
    cache = api.init_cache(3, 16)
    jcache = jax_build_model(jcfg).init_cache(3, 16)
    assert [tuple(t.shape) for t in jax.tree_util.tree_leaves(cache)] == \
        [tuple(j.shape) for j in jax.tree_util.tree_leaves(jcache)]


def test_ssm_and_hybrid_state_roundtrip_through_interop(model):
    """A JAX decode state (RWKV6: a tuple; Zamba2: a dict) crosses to torch
    and back leaf for leaf, keeping its container types and dtypes."""
    arch, cfg, jcfg, _, _ = model
    jstate = jax_build_model(jcfg).init_cache(2, 8)
    jstate = jax.tree_util.tree_map(
        lambda a: a + jnp.asarray(np.random.default_rng(0).standard_normal(
            a.shape), a.dtype), jstate)
    t = to_torch(jax.device_get(jstate), device=CPU)
    assert type(t) is type(jstate)
    assert jax.tree_util.tree_structure(to_numpy(t)) == \
        jax.tree_util.tree_structure(jstate)
    for tl, jl in zip(jax.tree_util.tree_leaves(t),
                      jax.tree_util.tree_leaves(jstate)):
        assert str(tl.dtype).replace("torch.", "") == str(jl.dtype)
    _close(t, jstate, atol=0, rtol=0)
    assert isinstance(to_torch([np.zeros(2)], device=CPU), list)


# ---------------------------------------------------------------------------
# Serving.
# ---------------------------------------------------------------------------


def _serve(sched_cls, req_cls, api, params, prompts, max_new, slots=4,
           cache_len=32):
    sched = sched_cls(api, params, slots=slots, cache_len=cache_len)
    reqs = [req_cls(i, p, max_new=max_new) for i, p in enumerate(prompts)]
    for r in reqs:
        sched.submit(r)
    done = steps = 0
    while done < len(reqs) and steps < 500:
        done += sched.step()
        steps += 1
    return reqs, done, steps


def test_greedy_tokens_equal_jax_scheduler(model):
    _, cfg, jcfg, jparams, tparams = model
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 512, size=4) for _ in range(6)]
    treqs, tdone, tsteps = _serve(BatchScheduler, Request,
                                  build_model(cfg, device=CPU), tparams,
                                  prompts, 4)
    jreqs, _, jsteps = _serve(JaxBatchScheduler, JaxRequest,
                              jax_build_model(jcfg), jparams, prompts, 4)
    assert tdone == 6 and tsteps == jsteps
    assert [r.generated for r in treqs] == [r.generated for r in jreqs]


def test_launch_serve_rwkv6_on_cpu(capsys):
    serve.main(["--arch", "rwkv6_7b", "--device", "cpu", "--requests", "4",
                "--max-new", "2", "--slots", "2"])
    out = capsys.readouterr().out
    assert "arch=rwkv6_7b: 4 requests x 2 tokens over 2 slots" in out
    assert "(CPU)" in out
