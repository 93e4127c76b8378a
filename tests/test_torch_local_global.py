"""Port's local:global attention (gemma3_4b) against
``repro.models.transformer`` on the CPU.

Two reduced configs, both with a tail and distinct local and global
thetas (1e4 and 1e6, gemma3's):
- ``tail``: 5 layers in groups of 2 (two groups of one window layer and
  one global layer, then one window layer left over), window 8, head dim
  32;
- ``hd320``: the same layers at gemma3_4b's head dim of 320 (2 query heads,
  1 K/V head, d_model 128), window 8.

Params come from JAX's ``init_lm`` through ``interop``.  In fp32 both sides
differ only in summation order: logits and caches are held at 1e-4 absolute
and relative (as tests/test_torch_transformer.py).  In bf16 the two
frameworks round at other places, so outputs are held at 2e-2 of the
reference's largest magnitude (as tests/test_torch_encdec.py).  Prompts
of S <= W and S > W with S % W != 0 take both branches of the
reference's ``ring``; decode steps run past the end of the ring.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced_config
from repro.models import transformer as JTF
from repro.models.registry import build_model as jax_build_model
from repro_torch.configs import SHAPES, get_config, reduced_config
from repro_torch.interop import to_numpy, to_torch
from repro_torch.models import transformer as TF
from repro_torch.models.registry import build_model
from repro_torch.serve.engine import BatchScheduler, Request

ARCH = "gemma3_4b"
CPU = "cpu"
TOL = dict(atol=1e-4, rtol=1e-4)
BF16_REL = 2e-2
W, CACHE_LEN, B = 8, 24, 2
CHANGES = {"tail": dict(num_layers=5, group_size=2, window=W),
           "hd320": dict(num_layers=5, group_size=2, window=W, num_heads=2,
                         num_kv_heads=1, head_dim=320)}


def _cfgs(kind):
    return (dataclasses.replace(reduced_config(get_config(ARCH)), **CHANGES[kind]),
            dataclasses.replace(jax_reduced_config(jax_get_config(ARCH)),
                                **CHANGES[kind]))


def _build(kind, jdtype=jnp.float32):
    cfg, jcfg = _cfgs(kind)
    jparams, _ = JTF.init_lm(jcfg, jax.random.PRNGKey(0))
    jparams = jax.tree_util.tree_map(lambda a: a.astype(jdtype), jparams)
    return cfg, jcfg, jparams, to_torch(jax.device_get(jparams), device=CPU)


@pytest.fixture(scope="module", params=sorted(CHANGES))
def model(request):
    return _build(request.param)


@pytest.fixture(scope="module")
def bf16():
    return _build("tail", jnp.bfloat16)


def _tokens(n, seed=3):
    return np.random.default_rng(seed).integers(0, 512, (B, n)).astype(np.int32)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(t, j):
    np.testing.assert_allclose(_np(t), _np(j), **TOL)


def _close_rel(t, j):
    t, j = _np(t), _np(j)
    assert np.isfinite(t).all() and t.shape == j.shape
    assert np.abs(t - j).max() <= BF16_REL * np.abs(j).max()


def _close_cache(tcache, jcache, close=_close):
    assert sorted(tcache) == sorted(jcache)
    for name in jcache:
        close(tcache[name], jcache[name])


# ---------------------------------------------------------------------------
# Params and caches.
# ---------------------------------------------------------------------------


def test_config_has_a_tail_and_two_thetas():
    cfg, _ = _cfgs("tail")
    assert cfg.attention == "local_global"
    assert cfg.num_layers % cfg.group_size == 1
    assert cfg.rope_theta != cfg.rope_theta_global
    full = get_config(ARCH)
    assert (full.hd, full.num_layers % full.group_size) == (320, 4)


def test_native_init_matches_jax_tree():
    """The grouped tree: ``groups`` {``local`` (n_groups, gsz - 1, ...),
    ``global`` (n_groups, ...)} and ``tail`` (tail, ...), with the
    reference's axes, shapes and bf16."""
    cfg, jcfg = _cfgs("tail")
    tparams, taxes = TF.init_lm(cfg, torch.Generator().manual_seed(0), CPU)
    jparams, jaxes = JTF.init_lm(jcfg, jax.random.PRNGKey(0))
    assert taxes == jaxes and set(tparams) == {"embedding", "groups", "tail",
                                                "final_norm"}
    tl = jax.tree_util.tree_leaves(to_numpy(tparams))
    jl = jax.tree_util.tree_leaves(jparams)
    assert [a.shape for a in tl] == [a.shape for a in jl]
    wq = tparams["groups"]["local"]["attn"]["wq"]
    assert tuple(wq.shape[:2]) == (2, 1) and wq.dtype == torch.bfloat16
    assert tparams["groups"]["global"]["attn"]["wq"].shape[0] == 2
    assert tparams["tail"]["attn"]["wq"].shape[0] == 1


def test_interop_carries_the_nested_tree_unchanged(model):
    cfg, _, jparams, tparams = model
    jflat = jax.tree_util.tree_leaves_with_path(jparams)
    tflat = jax.tree_util.tree_leaves_with_path(to_numpy(tparams))
    assert [p for p, _ in tflat] == [p for p, _ in jflat]
    for (_, t), (_, j) in zip(tflat, jflat):
        np.testing.assert_array_equal(t, np.asarray(j))


def test_init_cache_matches_jax_shapes(model):
    cfg, jcfg, _, _ = model
    for cache_len in (CACHE_LEN, 5):   # W = min(window, cache_len)
        t = TF.lm_init_cache(cfg, B, cache_len, device=CPU)
        j = JTF.lm_init_cache(jcfg, B, cache_len)
        assert {k: tuple(v.shape) for k, v in t.items()} == {
            k: tuple(v.shape) for k, v in j.items()}
        assert all(v.dtype == torch.bfloat16 and not v.any() for v in t.values())


# ---------------------------------------------------------------------------
# fp32 against the reference.
# ---------------------------------------------------------------------------


def test_forward_matches_jax(model):
    cfg, jcfg, jparams, tparams = model
    tok = _tokens(20)
    jlogits, jaux = JTF.lm_forward(jparams, jcfg, jnp.asarray(tok))
    tlogits, aux = TF.lm_forward(tparams, cfg, torch.from_numpy(tok))
    assert float(aux) == 0.0
    _close(aux, jaux)
    _close(tlogits, jlogits)


@pytest.mark.parametrize("S", [5, W, 11, 19])
def test_prefill_matches_jax(model, S):
    """S < W and S = W (the rings padded with zeros), S > W with S % W 3
    and S > 2 W (the last W positions rolled by S % W)."""
    cfg, jcfg, jparams, tparams = model
    tok = _tokens(S)
    jlog, jcache = JTF.lm_prefill(jparams, jcfg, jnp.asarray(tok),
                                  cache_len=CACHE_LEN)
    tlog, tcache = TF.lm_prefill(tparams, cfg, torch.from_numpy(tok),
                                 cache_len=CACHE_LEN)
    _close(tlog, jlog)
    _close_cache(tcache, jcache)


@pytest.mark.parametrize("S", [5, 11])
def test_decode_past_the_ring_matches_jax(model, S):
    """From a prompt inside the ring (5) and one that has wrapped it (11),
    decode steps to the end of the cache: the ring wraps again and every
    window layer overwrites the slot of the position that leaves its
    window."""
    cfg, jcfg, jparams, tparams = model
    tok = _tokens(CACHE_LEN)
    _, jcache = JTF.lm_prefill(jparams, jcfg, jnp.asarray(tok[:, :S]),
                               cache_len=CACHE_LEN)
    _, tcache = TF.lm_prefill(tparams, cfg, torch.from_numpy(tok[:, :S]),
                              cache_len=CACHE_LEN)
    jstep = jax.jit(JTF.lm_decode_step, static_argnums=1)
    for t in range(S, CACHE_LEN):
        x = tok[:, t:t + 1]
        jlog, jcache = jstep(jparams, jcfg, jcache, t, jnp.asarray(x))
        tlog, same = TF.lm_decode_step(tparams, cfg, tcache, t,
                                       torch.from_numpy(x))
        assert same is tcache    # written in place
        _close(tlog, jlog)
    _close_cache(tcache, jcache)


def test_decode_continues_prefill(model):
    """The port alone: prefill(S) + n decode steps gives the last logits
    and the caches (every ring slot included) of prefill(S + n), across a
    wrap of the ring."""
    cfg, _, _, tparams = model
    tok = torch.from_numpy(_tokens(20))
    _, cache = TF.lm_prefill(tparams, cfg, tok[:, :11], cache_len=CACHE_LEN)
    for t in range(11, 20):
        logits, cache = TF.lm_decode_step(tparams, cfg, cache, t, tok[:, t:t + 1])
        want, want_cache = TF.lm_prefill(tparams, cfg, tok[:, :t + 1],
                                         cache_len=CACHE_LEN)
        _close(logits, want.numpy())
    for name in cache:
        _close(cache[name], want_cache[name].numpy())


def test_window_mask_and_ring_attend_to_the_same_keys(model):
    """A decode step from a ring of W slots equals the prefill's last row,
    whose window mask (kpos > qpos - window) leaves the same W keys; a
    ring whose slots are rolled by one (the newest position overwritten
    instead of the oldest) does not."""
    cfg, _, _, tparams = model
    tok = torch.from_numpy(_tokens(14))
    _, cache = TF.lm_prefill(tparams, cfg, tok[:, :13], cache_len=CACHE_LEN)
    want, _ = TF.lm_prefill(tparams, cfg, tok, cache_len=CACHE_LEN)
    faulted = {k: v.clone() for k, v in cache.items()}
    for name in ("local_k", "local_v"):
        faulted[name][0, 0] = faulted[name][0, 0].roll(1, dims=1)
    got, _ = TF.lm_decode_step(tparams, cfg, cache, 13, tok[:, 13:])
    bad, _ = TF.lm_decode_step(tparams, cfg, faulted, 13, tok[:, 13:])
    _close(got, want.numpy())
    assert np.abs(_np(bad) - _np(want)).max() > 1e-3


# ---------------------------------------------------------------------------
# bf16 against the reference.
# ---------------------------------------------------------------------------


def test_forward_prefill_and_decode_match_jax_bf16(bf16):
    cfg, jcfg, jparams, tparams = bf16
    tok = _tokens(16)
    jlogits, _ = JTF.lm_forward(jparams, jcfg, jnp.asarray(tok))
    tlogits, _ = TF.lm_forward(tparams, cfg, torch.from_numpy(tok))
    _close_rel(tlogits, jlogits)
    jlog, jcache = JTF.lm_prefill(jparams, jcfg, jnp.asarray(tok[:, :11]),
                                  cache_len=CACHE_LEN)
    tlog, tcache = TF.lm_prefill(tparams, cfg, torch.from_numpy(tok[:, :11]),
                                 cache_len=CACHE_LEN)
    _close_rel(tlog, jlog)
    for t in range(11, 16):
        x = tok[:, t:t + 1]
        jlog, jcache = JTF.lm_decode_step(jparams, jcfg, jcache, t, jnp.asarray(x))
        tlog, tcache = TF.lm_decode_step(tparams, cfg, tcache, t, torch.from_numpy(x))
        _close_rel(tlog, jlog)
    _close_cache(tcache, jcache, _close_rel)


# ---------------------------------------------------------------------------
# Entry points.
# ---------------------------------------------------------------------------


def test_paged_calls_raise(model):
    """No paged decode for local_global, as in the reference."""
    cfg, jcfg, _, tparams = model
    with pytest.raises(NotImplementedError, match="uniform-cache"):
        JTF.lm_init_paged_cache(jcfg, B, 16, page=4)
    with pytest.raises(NotImplementedError, match="uniform-cache"):
        TF.lm_init_paged_cache(cfg, B, 16, page=4, device=CPU)
    with pytest.raises(NotImplementedError, match="uniform-cache"):
        TF.lm_decode_step_paged(tparams, cfg, {"page": 4}, 0,
                                torch.zeros(B, 1, dtype=torch.int64))


def test_registry_matches_jax(model):
    cfg, jcfg, jparams, tparams = model
    api, japi = build_model(cfg, device=CPU), jax_build_model(jcfg)
    jfields = [f.name for f in dataclasses.fields(japi)]
    assert [f.name for f in dataclasses.fields(api)][:len(jfields)] == jfields
    tok = _tokens(11)
    tlog, tcache = api.prefill(tparams, {"tokens": torch.from_numpy(tok)},
                               cache_len=CACHE_LEN)
    jlog, jcache = japi.prefill(jparams, {"tokens": jnp.asarray(tok)},
                                cache_len=CACHE_LEN)
    _close(tlog, jlog)
    _close_cache(tcache, jcache)
    specs = api.input_specs(SHAPES["decode_32k"])
    jspecs = japi.input_specs(SHAPES["decode_32k"])
    assert {k: tuple(v.shape) for k, v in specs["cache"].items()} == {
        k: tuple(v.shape) for k, v in jspecs["cache"].items()}
    assert all(v.device.type == "meta" for v in specs["cache"].values())


def test_scheduler_matches_a_decode_loop():
    """BatchScheduler (eager on the CPU) over the ring caches: 4 requests in
    4 slots give the tokens of a greedy loop of ``decode_step`` from the
    same prompts' last tokens, past a wrap of every ring."""
    cfg, _, _, tparams = _build("tail")
    api = build_model(cfg, device=CPU)
    prompts = _tokens(4, seed=5).repeat(2, axis=0)
    sched = BatchScheduler(api, tparams, slots=4, cache_len=16)
    reqs = [Request(i, p, max_new=12) for i, p in enumerate(prompts)]
    for r in reqs:
        sched.submit(r)
    done = steps = 0
    while done < len(reqs) and steps < 50:
        done += sched.step()
        steps += 1
    cache = api.init_cache(4, 16)
    token = torch.from_numpy(prompts[:, -1:].astype(np.int64))
    loop = []
    for t in range(12):
        logits, cache = api.decode_step(tparams, cache, t, token)
        token = logits.argmax(-1, keepdim=True)
        loop.append(token[:, 0].tolist())
    assert [r.generated for r in reqs] == [list(c) for c in zip(*loop)]
