"""Port's decoder LM against ``repro.models.transformer`` on a reduced
TinyLlama (2 layers, d_model 128); the forward, prefill and dense decode
also on reduced StarCoder2-7B (LayerNorm, GELU, qkv bias) and Qwen2.5-14B
(qkv bias, SwiGLU), whose zero-initialised biases are drawn at random so
that the bias paths carry numbers; and the MoE family, reduced
granite-MoE-3B and DBRX-132B (2 layers, 8 experts top-2, DBRX with
LayerNorm biases drawn at random), through the forward and its summed
load-balance loss, ``loss_fn``, prefill, dense and paged decode.  (The
vlm family has its own file, test_torch_vlm.py.)

Both sides run JAX-initialised parameters cast to float32, so the only
differences are summation order and float32 transcendental rounding.
Tolerance on logits: 1e-4 absolute and relative (logits are O(1)); paged
against dense on the torch side: 1e-5, since the two paths differ only in
how the same attention is summed.
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
from repro.models.registry import cross_entropy as jax_cross_entropy
from repro_torch.configs import SHAPES, get_config, reduced_config
from repro_torch.interop import to_numpy, to_torch
from repro_torch.models import transformer as TF
from repro_torch.models.registry import build_model, cross_entropy

TOL = dict(atol=1e-4, rtol=1e-4)
CPU = "cpu"


MORE_DENSE = ["starcoder2_7b", "qwen2p5_14b"]
MOE = ["granite_moe_3b_a800m", "dbrx_132b"]
BIASES = ("bq", "bk", "bv", "norm1_b", "norm2_b")


def _cfgs(vocab=512, arch="tinyllama_1p1b"):
    changes = dict(num_layers=2, vocab_size=vocab)
    return (dataclasses.replace(reduced_config(get_config(arch)), **changes),
            dataclasses.replace(jax_reduced_config(jax_get_config(arch)),
                                **changes))


def _build(arch="tinyllama_1p1b", random_biases=False):
    cfg, jcfg = _cfgs(arch=arch)
    jparams, _ = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    jparams = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jparams)
    if random_biases:
        rng = np.random.default_rng(7)
        jparams = jax.tree_util.tree_map_with_path(
            lambda path, a: a + jnp.asarray(0.1 * rng.standard_normal(a.shape),
                                            jnp.float32)
            if path[-1].key in BIASES else a, jparams)
    tparams = to_torch(jax.device_get(jparams), device=CPU)
    return cfg, jcfg, jparams, tparams


@pytest.fixture(scope="module")
def model():
    return _build()


@pytest.fixture(scope="module", params=MORE_DENSE)
def more_dense(request):
    return _build(request.param, random_biases=True)


@pytest.fixture(scope="module", params=MOE)
def moe(request):
    return _build(request.param, random_biases=True)


def _tokens(B, S, vocab=512, seed=3):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(np.int32)


def _close(t, j, **tol):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), **(tol or TOL))


def test_params_import_keeps_jax_layout(model):
    cfg, _, jparams, tparams = model
    flat_j = jax.tree_util.tree_leaves_with_path(jparams)
    assert len(flat_j) == len(jax.tree_util.tree_leaves(to_numpy(tparams)))
    wq = tparams["blocks"]["attn"]["wq"]
    assert tuple(wq.shape) == (2, cfg.d_model, cfg.num_heads * cfg.hd)
    assert wq.dtype == torch.float32


def test_bf16_import_roundtrips_exactly():
    _, jcfg = _cfgs()
    jparams, _ = jax_build_model(jcfg).init(jax.random.PRNGKey(1))
    t = to_torch(jax.device_get(jparams), device=CPU)
    assert t["embedding"]["embed"].dtype == torch.bfloat16
    back = to_numpy(t)
    np.testing.assert_array_equal(
        back["blocks"]["mlp"]["wo"],
        np.asarray(jparams["blocks"]["mlp"]["wo"].astype(jnp.float32)))


def test_native_init_matches_jax_shapes_and_dtypes():
    cfg, jcfg = _cfgs()
    tparams, taxes = TF.init_lm(cfg, torch.Generator().manual_seed(0), CPU)
    jparams, jaxes = JTF.init_lm(jcfg, jax.random.PRNGKey(0))
    assert taxes == jaxes
    tl = jax.tree_util.tree_leaves(to_numpy(tparams))
    jl = jax.tree_util.tree_leaves(jparams)
    assert [a.shape for a in tl] == [a.shape for a in jl]
    flat = [tparams["embedding"]["embed"], tparams["blocks"]["attn"]["wq"],
            tparams["final_norm"]]
    assert all(t.dtype == torch.bfloat16 for t in flat)


def test_forward_matches_jax(model):
    _forward_matches_jax(model)


def test_forward_matches_jax_past_tinyllama(more_dense):
    _forward_matches_jax(more_dense)


def test_forward_matches_jax_moe(moe):
    _forward_matches_jax(moe)


def _forward_matches_jax(model):
    cfg, jcfg, jparams, tparams = model
    tok = _tokens(2, 16)
    jlogits, jaux = JTF.lm_forward(jparams, jcfg, jnp.asarray(tok))
    tlogits, aux = TF.lm_forward(tparams, cfg, torch.from_numpy(tok))
    if cfg.family == "dense":
        assert float(aux) == 0.0
    else:  # the load-balance loss summed over the layers, about 1 each
        assert float(aux) > 0.5 * cfg.num_layers
    _close(aux, jaux)
    _close(tlogits, jlogits)
    labels = _tokens(2, 16, seed=4)
    _close(cross_entropy(tlogits, torch.from_numpy(labels)),
           jax_cross_entropy(jlogits, jnp.asarray(labels)))


def test_prefill_and_dense_decode_match_jax(model):
    _prefill_and_dense_decode_match_jax(model)


def test_prefill_and_dense_decode_match_jax_past_tinyllama(more_dense):
    _prefill_and_dense_decode_match_jax(more_dense)


def test_prefill_and_dense_decode_match_jax_moe(moe):
    _prefill_and_dense_decode_match_jax(moe)


def _prefill_and_dense_decode_match_jax(model):
    cfg, jcfg, jparams, tparams = model
    tok = _tokens(2, 12)
    jlog, jcache = JTF.lm_prefill(jparams, jcfg, jnp.asarray(tok[:, :8]),
                                  cache_len=16)
    tlog, tcache = TF.lm_prefill(tparams, cfg, torch.from_numpy(tok[:, :8]),
                                 cache_len=16)
    _close(tlog, jlog)
    _close(tcache["k"], jcache["k"])
    for t in range(8, 12):
        jlog, jcache = JTF.lm_decode_step(jparams, jcfg, jcache, t,
                                          jnp.asarray(tok[:, t:t + 1]))
        tlog, tcache = TF.lm_decode_step(tparams, cfg, tcache, t,
                                         torch.from_numpy(tok[:, t:t + 1]))
        _close(tlog, jlog)
    _close(tcache["v"], jcache["v"])


def test_paged_decode_matches_jax(model):
    _paged_decode_matches_jax(model)


def test_paged_decode_matches_jax_moe(moe):
    _paged_decode_matches_jax(moe)


def _paged_decode_matches_jax(model):
    cfg, jcfg, jparams, tparams = model
    tok = _tokens(2, 10)
    jpaged = JTF.lm_init_paged_cache(jcfg, batch=2, max_len=16, page=4,
                                     dtype=jnp.float32)
    tpaged = TF.lm_init_paged_cache(cfg, batch=2, max_len=16, page=4,
                                    dtype=torch.float32, device=CPU)
    assert (tpaged["block_table"].numpy()
            == np.asarray(jpaged["block_table"])).all()
    for t in range(10):
        jlog, jpaged = JTF.lm_decode_step_paged(jparams, jcfg, jpaged, t,
                                                jnp.asarray(tok[:, t:t + 1]))
        tlog, tpaged = TF.lm_decode_step_paged(tparams, cfg, tpaged, t,
                                               torch.from_numpy(tok[:, t:t + 1]))
        _close(tlog, jlog)
    _close(tpaged["k_pool"], jpaged["k_pool"])


def test_paged_decode_matches_dense(model):
    """lm_decode_step_paged == lm_decode_step over the same prefix, torch
    side (mirrors tests/test_serve.py::test_paged_decode_matches_dense)."""
    cfg, _, _, tparams = model
    tok = torch.from_numpy(_tokens(2, 12, seed=5))
    _, dense = TF.lm_prefill(tparams, cfg, tok[:, :8], cache_len=16)
    paged = TF.lm_init_paged_cache(cfg, batch=2, max_len=16, page=4,
                                   dtype=torch.float32, device=CPU)
    for t in range(8):
        _, paged = TF.lm_decode_step_paged(tparams, cfg, paged, t,
                                           tok[:, t:t + 1])
    for t in range(8, 12):
        d_logits, dense = TF.lm_decode_step(tparams, cfg, dense, t,
                                            tok[:, t:t + 1])
        p_logits, paged = TF.lm_decode_step_paged(tparams, cfg, paged, t,
                                                  tok[:, t:t + 1])
        _close(p_logits, d_logits.numpy(), atol=1e-5, rtol=1e-5)


def test_paged_decode_matches_dense_moe(moe):
    """From one prefill's cache, laid into the pool under a shuffled block
    table: a MoE prefill of 8 tokens drops some at capacity (C 3) where 8
    one-token steps drop none, so the pool cannot be filled by decoding
    the prompt, as the dense test does."""
    cfg, _, _, tparams = moe
    tok = torch.from_numpy(_tokens(2, 12, seed=5))
    _, dense = TF.lm_prefill(tparams, cfg, tok[:, :8], cache_len=16)
    paged = TF.lm_init_paged_cache(cfg, batch=2, max_len=16, page=4,
                                   dtype=torch.float32, device=CPU)
    perm = torch.randperm(8, generator=torch.Generator().manual_seed(6))
    paged["block_table"] = perm.int().view(2, 4)
    for name in ("k", "v"):
        L_, B_, S_, KV, hd = dense[name].shape
        paged[f"{name}_pool"][:, perm] = dense[name].reshape(L_, 8, 4, KV, hd)
    for t in range(8, 12):
        d_logits, dense = TF.lm_decode_step(tparams, cfg, dense, t,
                                            tok[:, t:t + 1])
        p_logits, paged = TF.lm_decode_step_paged(tparams, cfg, paged, t,
                                                  tok[:, t:t + 1])
        _close(p_logits, d_logits.numpy(), atol=1e-5, rtol=1e-5)


def test_registry_api_matches_jax_members(model):
    _registry_api_matches_jax_members(model)


def test_registry_api_matches_jax_members_moe(moe):
    _registry_api_matches_jax_members(moe)


def _registry_api_matches_jax_members(model):
    cfg, jcfg, jparams, tparams = model
    api = build_model(cfg, device=CPU)
    jfields = [f.name for f in dataclasses.fields(jax_build_model(jcfg))]
    assert [f.name for f in dataclasses.fields(api)][:len(jfields)] == jfields
    tok = _tokens(2, 8)
    tlog, _ = api.prefill(tparams, {"tokens": torch.from_numpy(tok)},
                          cache_len=8)
    jlog, _ = jax_build_model(jcfg).prefill(jparams,
                                            {"tokens": jnp.asarray(tok)},
                                            cache_len=8)
    _close(tlog, jlog)
    specs = api.input_specs(SHAPES["decode_32k"])
    assert specs["cache"]["k"].device.type == "meta"


def test_loss_fn_adds_the_moe_aux_loss_as_jax(moe):
    """``loss_fn`` = cross entropy + 0.01 x the summed load-balance loss,
    with both in its metrics, as the JAX package's."""
    cfg, jcfg, jparams, tparams = moe
    tok, labels = _tokens(2, 16), _tokens(2, 16, seed=4)
    total, metrics = build_model(cfg, device=CPU).loss_fn(
        tparams, {"tokens": torch.from_numpy(tok),
                  "labels": torch.from_numpy(labels)})
    jtotal, jmetrics = jax_build_model(jcfg).loss_fn(
        jparams, {"tokens": jnp.asarray(tok), "labels": jnp.asarray(labels)})
    _close(total, jtotal)
    for name in ("xent", "aux"):
        _close(metrics[name], jmetrics[name])
    _close(total, (metrics["xent"] + 0.01 * metrics["aux"]).detach().numpy())
    assert float(metrics["aux"]) > 0.0


def test_native_init_matches_jax_shapes_and_dtypes_moe(moe):
    cfg, jcfg, _, _ = moe
    tparams, taxes = TF.init_lm(cfg, torch.Generator().manual_seed(0), CPU)
    jparams, jaxes = JTF.init_lm(jcfg, jax.random.PRNGKey(0))
    assert taxes == jaxes and "moe" in taxes["blocks"]
    tl = jax.tree_util.tree_leaves(to_numpy(tparams))
    jl = jax.tree_util.tree_leaves(jparams)
    assert [a.shape for a in tl] == [a.shape for a in jl]
    assert tparams["blocks"]["moe"]["wi_gate"].dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ["rwkv6_7b", "zamba2_1p2b",
                                  "seamless_m4t_medium"])
def test_transformer_refuses_families_that_are_not_transformers(arch):
    """Every transformer family is served (vlm since its port); the dense
    path still refuses a config of another family."""
    cfg = reduced_config(get_config(arch))
    with pytest.raises(NotImplementedError, match="not a transformer family"):
        TF.check_supported(cfg)
    with pytest.raises(NotImplementedError, match="not a transformer family"):
        TF.init_lm(cfg, torch.Generator().manual_seed(0), CPU)
    build_model(cfg, device=CPU)   # its own family's registry entry serves it
