"""Port's encoder-decoder (``repro_torch.models.encdec``) against
``repro.models.encdec`` on reduced SeamlessM4T-medium (2 encoder and 2
decoder layers, d_model 128, 4 heads of 32, vocab 512).

Both sides run the same JAX-initialised parameters (carried by
``to_torch``) on the same seeded numpy frames and tokens.

- bf16, where the reference runs end to end: ``encode``, ``dec_forward``,
  ``encdec_forward``, ``loss_fn``, and ``encdec_prefill`` followed by 4
  ``encdec_decode_step``s.  The two frameworks round bf16 products and
  sums at other places, so outputs are held at 2e-2 of their largest
  magnitude (the convention of ``test_torch_moe.py``; measured under
  1e-2).
- fp32, at 1e-4 absolute and relative: ``dec_forward`` given encoder
  states and ``encdec_decode_step`` given a cache, which the reference
  runs in fp32; and the port's ``encode`` against a loop of the JAX
  package's own layer functions from bf16-rounded frames, since the
  reference's ``encode`` raises on fp32 params (its ``lax.scan`` carry
  turns from bf16 to fp32; pinned below, and not copied by the port).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced_config
from repro.models import encdec as JED
from repro.models import layers as JL
from repro.models.registry import build_model as jax_build_model
from repro.serve.engine import BatchScheduler as JaxBatchScheduler
from repro.serve.engine import Request as JaxRequest
from repro_torch.configs import SHAPES, get_config, reduced_config
from repro_torch.interop import to_numpy, to_torch
from repro_torch.models import encdec as ED
from repro_torch.models.registry import build_model
from repro_torch.serve.engine import BatchScheduler, Request

ARCH = "seamless_m4t_medium"
CPU = "cpu"
TOL = dict(atol=1e-4, rtol=1e-4)
BF16_REL = 2e-2
B, S_ENC, S = 2, 24, 12


def _cfgs():
    return (reduced_config(get_config(ARCH)),
            jax_reduced_config(jax_get_config(ARCH)))


def _params(jdtype):
    cfg, jcfg = _cfgs()
    jparams, _ = JED.init_encdec(jcfg, jax.random.PRNGKey(0))
    jparams = jax.tree_util.tree_map(lambda a: a.astype(jdtype), jparams)
    return cfg, jcfg, jparams, to_torch(jax.device_get(jparams), device=CPU)


@pytest.fixture(scope="module")
def bf16():
    return _params(jnp.bfloat16)


@pytest.fixture(scope="module")
def fp32():
    return _params(jnp.float32)


def _frames(seed=0, n=S_ENC):
    return np.random.default_rng(seed).standard_normal(
        (B, n, 128)).astype(np.float32)


def _tokens(n=S + 4, seed=3):
    return np.random.default_rng(seed).integers(0, 512, (B, n)).astype(np.int32)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close_rel(t, j):
    """bf16: within BF16_REL of the reference's largest magnitude."""
    t, j = _np(t), _np(j)
    assert np.isfinite(t).all() and t.shape == j.shape
    assert np.abs(t - j).max() <= BF16_REL * np.abs(j).max()


def _close(t, j):
    np.testing.assert_allclose(_np(t), _np(j), **TOL)


# ---------------------------------------------------------------------------
# Params.
# ---------------------------------------------------------------------------


def test_params_import_keeps_jax_tree(bf16):
    cfg, _, jparams, tparams = bf16
    jl = jax.tree_util.tree_leaves_with_path(jparams)
    tl = jax.tree_util.tree_leaves_with_path(to_numpy(tparams))
    assert [p for p, _ in tl] == [p for p, _ in jl]
    assert [a.shape for _, a in tl] == [a.shape for _, a in jl]
    wq = tparams["decoder"]["cross_attn"]["wq"]
    assert tuple(wq.shape) == (cfg.decoder_layers, cfg.d_model,
                               cfg.num_heads * cfg.hd)
    assert wq.dtype == torch.bfloat16


def test_native_init_matches_jax_shapes_dtypes_and_axes():
    cfg, jcfg = _cfgs()
    tparams, taxes = ED.init_encdec(cfg, torch.Generator().manual_seed(0), CPU)
    jparams, jaxes = JED.init_encdec(jcfg, jax.random.PRNGKey(0))
    assert taxes == jaxes
    tl = jax.tree_util.tree_leaves_with_path(to_numpy(tparams))
    jl = jax.tree_util.tree_leaves_with_path(jparams)
    assert [(p, a.shape) for p, a in tl] == [(p, a.shape) for p, a in jl]
    assert all(t.dtype == torch.bfloat16 for t in jax.tree_util.tree_leaves(
        tparams, is_leaf=lambda x: isinstance(x, torch.Tensor)))
    assert not tparams["final_norm"].any()
    assert tparams["encoder"]["norm1_w"].eq(1).all()
    assert not tparams["decoder"]["norm3_b"].any()


# ---------------------------------------------------------------------------
# bf16: the reference end to end.
# ---------------------------------------------------------------------------


def test_encode_matches_jax_bf16(bf16):
    cfg, jcfg, jparams, tparams = bf16
    f = _frames()
    out = ED.encode(tparams, cfg, torch.from_numpy(f))
    assert out.dtype == torch.bfloat16
    _close_rel(out, JED.encode(jparams, jcfg, jnp.asarray(f)))


def test_forward_matches_jax_bf16(bf16):
    cfg, jcfg, jparams, tparams = bf16
    f, tok = _frames(), _tokens()
    logits, aux = ED.encdec_forward(tparams, cfg, torch.from_numpy(tok),
                                    torch.from_numpy(f))
    jlogits, jaux = JED.encdec_forward(jparams, jcfg, jnp.asarray(tok),
                                       jnp.asarray(f))
    assert aux.dtype == torch.float32 and float(aux) == float(jaux) == 0.0
    assert tuple(logits.shape) == (B, S + 4, cfg.padded_vocab)
    _close_rel(logits, jlogits)
    # dec_forward over the reference's own encoder states
    enc = JED.encode(jparams, jcfg, jnp.asarray(f))
    _close_rel(ED.dec_forward(tparams, cfg, torch.from_numpy(tok),
                              torch.tensor(_np(enc)).bfloat16()),
               JED.dec_forward(jparams, jcfg, jnp.asarray(tok), enc))


def test_loss_fn_matches_jax_bf16(bf16):
    cfg, jcfg, jparams, tparams = bf16
    f, tok = _frames(), _tokens()
    labels = _tokens(seed=4)
    loss, metrics = build_model(cfg, CPU).loss_fn(
        tparams, {"tokens": torch.from_numpy(tok), "labels": torch.from_numpy(labels),
                  "frames": torch.from_numpy(f)})
    jloss, jmetrics = jax_build_model(jcfg).loss_fn(
        jparams, {"tokens": jnp.asarray(tok), "labels": jnp.asarray(labels),
                  "frames": jnp.asarray(f)})
    _close_rel(loss, jloss)
    assert float(metrics["aux"]) == float(jmetrics["aux"]) == 0.0


def test_prefill_and_decode_match_jax_bf16(bf16):
    cfg, jcfg, jparams, tparams = bf16
    f, tok = _frames(), _tokens()
    logits, cache = ED.encdec_prefill(tparams, cfg, torch.from_numpy(tok[:, :S]),
                                      torch.from_numpy(f), cache_len=S + 4)
    jlogits, jcache = JED.encdec_prefill(jparams, jcfg, jnp.asarray(tok[:, :S]),
                                         jnp.asarray(f), cache_len=S + 4)
    assert {k: tuple(v.shape) for k, v in cache.items()} == {
        k: v.shape for k, v in jcache.items()}
    assert tuple(cache["cross_k"].shape)[2] == S_ENC
    _close_rel(logits, jlogits)
    for name in cache:
        _close_rel(cache[name], jcache[name])
    for t in range(S, S + 4):
        logits, out = ED.encdec_decode_step(tparams, cfg, cache, t,
                                            torch.from_numpy(tok[:, t:t + 1]))
        assert out is cache   # written in place
        jlogits, jcache = JED.encdec_decode_step(jparams, jcfg, jcache, t,
                                                 jnp.asarray(tok[:, t:t + 1]))
        _close_rel(logits, jlogits)
    _close_rel(cache["k"], jcache["k"])


# ---------------------------------------------------------------------------
# fp32.
# ---------------------------------------------------------------------------


def test_jax_encode_raises_on_fp32_params(fp32):
    """The fault of the reference that the port does not copy (ROADMAP.md
    Queue 3): the first residual add promotes the bf16 frames to fp32, and
    ``lax.scan`` refuses a carry that changes type."""
    _, jcfg, jparams, _ = fp32
    with pytest.raises(TypeError, match="carry"):
        JED.encode(jparams, jcfg, jnp.asarray(_frames()))


def test_encode_matches_jax_layer_loop_fp32(fp32):
    """The port's fp32 encoder against the reference's own layer functions
    looped in Python from bf16-rounded frames: the first block's normed
    input stays bf16 and JAX promotes it in the products; from the first
    residual add on, everything is fp32."""
    cfg, jcfg, jparams, tparams = fp32
    f = _frames()
    x = jnp.asarray(f).astype(jnp.bfloat16)
    pos = jnp.broadcast_to(jnp.arange(S_ENC)[None], (B, S_ENC))
    for i in range(jcfg.encoder_layers):
        blk = jax.tree_util.tree_map(lambda a: a[i], jparams["encoder"])
        a, _ = JL.attention_fwd(blk["attn"],
                                JL.layer_norm(x, blk["norm1_w"], blk["norm1_b"]),
                                JED._self_cfg(jcfg, False), pos)
        x = x + a
        x = x + JL.mlp_fwd(blk["mlp"],
                           JL.layer_norm(x, blk["norm2_w"], blk["norm2_b"]),
                           jcfg.mlp)
    out = ED.encode(tparams, cfg, torch.from_numpy(f))
    assert out.dtype == torch.float32 and x.dtype == jnp.float32
    _close(out, x)


def test_dec_forward_matches_jax_fp32(fp32):
    cfg, jcfg, jparams, tparams = fp32
    enc, tok = _frames(seed=5), _tokens()
    _close(ED.dec_forward(tparams, cfg, torch.from_numpy(tok), torch.from_numpy(enc)),
           JED.dec_forward(jparams, jcfg, jnp.asarray(tok), jnp.asarray(enc)))


def _random_cache(cfg, filled, cache_len, seed=6):
    """An fp32 cache whose first ``filled`` self-attention positions and
    whole cross K/V are seeded normals."""
    rng = np.random.default_rng(seed)
    Ld, KV, hd = cfg.decoder_layers, cfg.num_kv_heads, cfg.hd
    cache = {name: np.zeros((Ld, B, n, KV, hd), np.float32)
             for name, n in (("k", cache_len), ("v", cache_len),
                             ("cross_k", S_ENC), ("cross_v", S_ENC))}
    for name in ("k", "v"):
        cache[name][:, :, :filled] = rng.standard_normal((Ld, B, filled, KV, hd))
    for name in ("cross_k", "cross_v"):
        cache[name][:] = rng.standard_normal(cache[name].shape)
    return cache


def test_decode_step_matches_jax_fp32(fp32):
    cfg, jcfg, jparams, tparams = fp32
    tok = _tokens()
    cache = _random_cache(cfg, S, S + 4)
    tcache = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    jcache = {k: jnp.asarray(v) for k, v in cache.items()}
    for t in range(S, S + 4):
        kv_len = torch.tensor(t, dtype=torch.int32)
        logits, tcache = ED.encdec_decode_step(tparams, cfg, tcache, kv_len,
                                               torch.from_numpy(tok[:, t:t + 1]))
        jlogits, jcache = JED.encdec_decode_step(jparams, jcfg, jcache, t,
                                                 jnp.asarray(tok[:, t:t + 1]))
        _close(logits, jlogits)
    for name in tcache:
        _close(tcache[name], jcache[name])


def test_prefill_then_decode_equals_longer_prefill_fp32(fp32):
    """prefill(S) + n decode steps give the last logits of prefill(S + n)
    over the same frames (the reference's bf16 run measured 0.0 here)."""
    cfg, _, _, tparams = fp32
    f, tok = torch.from_numpy(_frames()), torch.from_numpy(_tokens())
    _, cache = ED.encdec_prefill(tparams, cfg, tok[:, :S], f, cache_len=S + 4)
    for t in range(S, S + 4):
        logits, cache = ED.encdec_decode_step(tparams, cfg, cache, t,
                                              tok[:, t:t + 1])
        want, _ = ED.encdec_prefill(tparams, cfg, tok[:, :t + 1], f)
        _close(logits, want.numpy())


# ---------------------------------------------------------------------------
# Registry and serving.
# ---------------------------------------------------------------------------


def test_build_model_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="cuda"):
        build_model(get_config(ARCH))


def test_registry_members_and_specs_match_jax(bf16):
    cfg, jcfg, jparams, tparams = bf16
    api, japi = build_model(cfg, CPU), jax_build_model(jcfg)
    jfields = [f.name for f in dataclasses.fields(japi)]
    assert [f.name for f in dataclasses.fields(api)][:len(jfields)] == jfields
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        specs = api.input_specs(SHAPES[shape])
        jspecs = japi.input_specs(SHAPES[shape])
        got = jax.tree_util.tree_leaves_with_path(specs)
        want = jax.tree_util.tree_leaves_with_path(jspecs)
        assert [(p, tuple(t.shape), str(t.dtype).split(".")[-1]) for p, t in got] \
            == [(p, s.shape, str(s.dtype)) for p, s in want]
        assert all(t.device.type == "meta" for _, t in got)
    cache = api.init_cache(2, 10)
    assert cache["cross_k"].shape[2] == 10 and cache["k"].dtype == torch.bfloat16
    assert api.init_cache(2, 10, 7)["cross_v"].shape[2] == 7
    f, tok = _frames(), _tokens()
    logits, cache = api.prefill(tparams, {"tokens": torch.from_numpy(tok[:, :S]),
                                          "frames": torch.from_numpy(f)},
                                cache_len=S + 1)
    jlogits, _ = japi.prefill(jparams, {"tokens": jnp.asarray(tok[:, :S]),
                                        "frames": jnp.asarray(f)}, cache_len=S + 1)
    _close_rel(logits, jlogits)
    step, _ = api.decode_step(tparams, cache, S, torch.from_numpy(tok[:, S:S + 1]))
    assert tuple(step.shape) == (B, cfg.padded_vocab)


def _serve(sched_cls, req_cls, api, params, prompts, max_new=4):
    sched = sched_cls(api, params, slots=4, cache_len=32)
    reqs = [req_cls(i, p, max_new=max_new) for i, p in enumerate(prompts)]
    for r in reqs:
        sched.submit(r)
    done = steps = 0
    while done < len(reqs) and steps < 200:
        done += sched.step()
        steps += 1
    return reqs, steps


def test_batch_scheduler_serves_encdec_as_a_decode_loop_and_as_jax(fp32):
    """Reduced seamless through BatchScheduler on the CPU (eager): the cache
    is ``api.init_cache(slots, cache_len)``, cross K/V zeros as in the
    reference; the tokens equal a loop of ``api.decode_step`` over one
    batch of the same requests, and the JAX scheduler's."""
    cfg, jcfg, jparams, tparams = fp32
    api = build_model(cfg, CPU)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 512, size=4) for _ in range(4)]
    reqs, steps = _serve(BatchScheduler, Request, api, tparams, prompts)
    assert steps == 4 and all(len(r.generated) == 4 for r in reqs)
    cache = api.init_cache(4, 32)
    tok = torch.tensor([[int(p[-1])] for p in prompts], dtype=torch.int32)
    loop = []
    for t in range(4):
        logits, cache = api.decode_step(tparams, cache, t, tok)
        tok = logits.argmax(-1, keepdim=True).int()
        loop.append(tok[:, 0].tolist())
    assert [r.generated for r in reqs] == [list(c) for c in zip(*loop)]
    jreqs, jsteps = _serve(JaxBatchScheduler, JaxRequest, jax_build_model(jcfg),
                           jparams, prompts)
    assert jsteps == steps
    assert [r.generated for r in reqs] == [r.generated for r in jreqs]
