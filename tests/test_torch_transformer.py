"""Port's decoder LM against ``repro.models.transformer`` on a reduced
TinyLlama (2 layers, d_model 128).

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


def _cfgs(vocab=512):
    changes = dict(num_layers=2, vocab_size=vocab)
    return (dataclasses.replace(reduced_config(get_config("tinyllama_1p1b")),
                                **changes),
            dataclasses.replace(
                jax_reduced_config(jax_get_config("tinyllama_1p1b")), **changes))


@pytest.fixture(scope="module")
def model():
    cfg, jcfg = _cfgs()
    jparams, _ = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    jparams = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jparams)
    tparams = to_torch(jax.device_get(jparams), device=CPU)
    return cfg, jcfg, jparams, tparams


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
    cfg, jcfg, jparams, tparams = model
    tok = _tokens(2, 16)
    jlogits, _ = JTF.lm_forward(jparams, jcfg, jnp.asarray(tok))
    tlogits, aux = TF.lm_forward(tparams, cfg, torch.from_numpy(tok))
    assert float(aux) == 0.0
    _close(tlogits, jlogits)
    labels = _tokens(2, 16, seed=4)
    _close(cross_entropy(tlogits, torch.from_numpy(labels)),
           jax_cross_entropy(jlogits, jnp.asarray(labels)))


def test_prefill_and_dense_decode_match_jax(model):
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


def test_registry_api_matches_jax_members(model):
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


@pytest.mark.parametrize("arch", ["gemma3_4b", "granite_moe_3b_a800m",
                                  "qwen2_vl_72b", "rwkv6_7b"])
def test_unported_families_raise(arch):
    cfg = reduced_config(get_config(arch))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        build_model(cfg, device=CPU)
