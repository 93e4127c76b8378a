"""Port's vlm family (Qwen2-VL: M-RoPE and an embeds prefix) against
``repro.models.transformer`` on a reduced qwen2_vl_72b (2 layers, d_model
128, 4 query heads over 1 K/V head of 32, M-RoPE sections (4, 6, 6)):
forward and prefill with a (B, 8, d_model) embeds prefix, dense decode
steps after it, paged decode steps, the registry's input specs and the
batch scheduler's greedy tokens; and ``apply_mrope`` at head dim 128's
sections with distinct per-axis positions.

Both sides run JAX-initialised parameters cast to float32, with the
zero-initialised q/k/v biases drawn at random so that the bias path carries
numbers.  Embeds are N(0, 0.02) from numpy, in bf16 as the reference's
input specs give them (cast to the embedding's float32 on both sides).
Tolerance on logits and caches: 1e-4 absolute and relative (logits are
O(1)); paged against dense on the torch side: 1e-5, since the two paths
differ only in how the same attention is summed.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced_config
from repro.models import layers as JL
from repro.models import transformer as JTF
from repro.models.registry import build_model as jax_build_model
from repro.serve.engine import BatchScheduler as JaxBatchScheduler
from repro.serve.engine import Request as JaxRequest
from repro_torch.configs import SHAPES, get_config, reduced_config
from repro_torch.interop import to_numpy, to_torch
from repro_torch.models import layers as TL
from repro_torch.models import registry as REG
from repro_torch.models import transformer as TF
from repro_torch.models.registry import build_model
from repro_torch.serve.engine import BatchScheduler, Request

ARCH = "qwen2_vl_72b"
TOL = dict(atol=1e-4, rtol=1e-4)
CPU = "cpu"
B, V, PROMPT, CACHE_LEN, PAGE = 2, 8, 12, 16, 4


def _cfgs():
    changes = dict(num_layers=2)
    return (dataclasses.replace(reduced_config(get_config(ARCH)), **changes),
            dataclasses.replace(jax_reduced_config(jax_get_config(ARCH)),
                                **changes))


@pytest.fixture(scope="module")
def model():
    cfg, jcfg = _cfgs()
    jparams, _ = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    jparams = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jparams)
    rng = np.random.default_rng(7)
    jparams = jax.tree_util.tree_map_with_path(
        lambda path, a: a + jnp.asarray(0.1 * rng.standard_normal(a.shape),
                                        jnp.float32)
        if path[-1].key in ("bq", "bk", "bv") else a, jparams)
    return cfg, jcfg, jparams, to_torch(jax.device_get(jparams), device=CPU)


def _tokens(n, seed=3, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (B, n)).astype(np.int32)


def _embeds(d_model, seed=0):
    """(B, V, d_model) N(0, 0.02), rounded to bf16, on both sides."""
    e = np.random.default_rng(seed).normal(0, 0.02, (B, V, d_model))
    j = jnp.asarray(e, jnp.bfloat16)
    return j, torch.tensor(np.asarray(j.astype(jnp.float32))).bfloat16()


def _close(t, j, **tol):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), **(tol or TOL))


def test_reduced_config_is_the_vlm_at_sections_4_6_6(model):
    cfg, jcfg, _, tparams = model
    assert cfg.family == "vlm" and cfg.mrope and cfg.qkv_bias
    assert (cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd) == (128, 4, 1, 32)
    assert TL._mrope_sections(cfg.hd) == JL._mrope_sections(jcfg.hd) == (4, 6, 6)
    assert float(tparams["blocks"]["attn"]["bq"].abs().max()) > 0.0


def test_native_init_matches_jax_shapes_dtypes_and_axes():
    cfg, jcfg = _cfgs()
    tparams, taxes = build_model(cfg, CPU).init(torch.Generator().manual_seed(0))
    jparams, jaxes = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    assert taxes == jaxes and "unembed" in taxes["embedding"]
    tl = jax.tree_util.tree_leaves(to_numpy(tparams))
    jl = jax.tree_util.tree_leaves(jparams)
    assert [a.shape for a in tl] == [a.shape for a in jl]
    assert tparams["blocks"]["attn"]["bq"].dtype == torch.bfloat16


def test_forward_with_embeds_matches_jax(model):
    cfg, jcfg, jparams, tparams = model
    tok = _tokens(16)
    je, te = _embeds(cfg.d_model)
    jlogits, jaux = JTF.lm_forward(jparams, jcfg, jnp.asarray(tok), embeds=je)
    tlogits, aux = TF.lm_forward(tparams, cfg, torch.from_numpy(tok), embeds=te)
    _close(tlogits, jlogits)
    _close(aux, jaux)
    # The prefix is used: the same tokens without it give other logits.
    plain, _ = TF.lm_forward(tparams, cfg, torch.from_numpy(tok))
    assert (plain - tlogits).abs().max() > 1e-2


def test_registry_forward_and_loss_take_the_batch_embeds(model):
    cfg, jcfg, jparams, tparams = model
    tok, labels = _tokens(16), _tokens(16, seed=4)
    je, te = _embeds(cfg.d_model, seed=1)
    total, metrics = build_model(cfg, CPU).loss_fn(
        tparams, {"tokens": torch.from_numpy(tok), "labels": torch.from_numpy(labels),
                  "embeds": te})
    jtotal, jmetrics = jax_build_model(jcfg).loss_fn(
        jparams, {"tokens": jnp.asarray(tok), "labels": jnp.asarray(labels),
                  "embeds": je})
    _close(total, jtotal)
    _close(metrics["xent"], jmetrics["xent"])


def _prefill(model, seed=0):
    """Both sides' prefill of PROMPT tokens whose first V are the embeds,
    into CACHE_LEN positions."""
    cfg, jcfg, jparams, tparams = model
    tok = _tokens(PROMPT + 4)
    je, te = _embeds(cfg.d_model, seed)
    jlog, jcache = JTF.lm_prefill(jparams, jcfg, jnp.asarray(tok[:, :PROMPT]),
                                  cache_len=CACHE_LEN, embeds=je)
    tlog, tcache = TF.lm_prefill(tparams, cfg, torch.from_numpy(tok[:, :PROMPT]),
                                 cache_len=CACHE_LEN, embeds=te)
    return tok, (jlog, jcache), (tlog, tcache)


def test_prefill_with_embeds_matches_jax(model):
    _, (jlog, jcache), (tlog, tcache) = _prefill(model)
    _close(tlog, jlog)
    for name in ("k", "v"):
        assert tuple(tcache[name].shape) == jcache[name].shape
        _close(tcache[name], jcache[name])


def test_dense_decode_steps_after_embeds_match_jax(model):
    cfg, jcfg, jparams, tparams = model
    tok, (_, jcache), (_, tcache) = _prefill(model)
    for t in range(PROMPT, PROMPT + 4):
        jlog, jcache = JTF.lm_decode_step(jparams, jcfg, jcache, t,
                                          jnp.asarray(tok[:, t:t + 1]))
        tlog, tcache = TF.lm_decode_step(tparams, cfg, tcache, t,
                                         torch.from_numpy(tok[:, t:t + 1]))
        _close(tlog, jlog)
    _close(tcache["k"], jcache["k"])


def _pools(model, tcache, jcache, perm):
    """Both sides' paged pools laid out from their prefill caches under the
    block table ``perm`` (logical page j of the (sequence, page) grid at
    physical page perm[j])."""
    cfg, jcfg, _, _ = model
    n = CACHE_LEN // PAGE
    tpaged = TF.lm_init_paged_cache(cfg, B, CACHE_LEN, page=PAGE,
                                    dtype=torch.float32, device=CPU)
    jpaged = JTF.lm_init_paged_cache(jcfg, B, CACHE_LEN, page=PAGE,
                                     dtype=jnp.float32)
    tpaged["block_table"] = torch.from_numpy(perm).int().view(B, n)
    jpaged["block_table"] = jnp.asarray(perm, jnp.int32).reshape(B, n)
    for name in ("k", "v"):
        L_, _, _, KV, hd = tcache[name].shape
        tpaged[f"{name}_pool"][:, torch.from_numpy(perm)] = tcache[name].reshape(
            L_, B * n, PAGE, KV, hd)
        jpaged[f"{name}_pool"] = jpaged[f"{name}_pool"].at[:, perm].set(
            jcache[name].reshape(L_, B * n, PAGE, KV, hd))
    return tpaged, jpaged


def test_paged_decode_steps_match_jax_and_dense(model):
    """From the prefill's caches laid into the pools under a shuffled block
    table: the port's paged steps against JAX's (1e-4) and against the
    port's dense steps (1e-5)."""
    cfg, jcfg, jparams, tparams = model
    tok, (_, jcache), (_, tcache) = _prefill(model)
    perm = np.random.default_rng(6).permutation(B * CACHE_LEN // PAGE)
    tpaged, jpaged = _pools(model, tcache, jcache, perm)
    for t in range(PROMPT, PROMPT + 4):
        x = tok[:, t:t + 1]
        jlog, jpaged = JTF.lm_decode_step_paged(jparams, jcfg, jpaged, t,
                                                jnp.asarray(x))
        plog, tpaged = TF.lm_decode_step_paged(tparams, cfg, tpaged, t,
                                               torch.from_numpy(x))
        dlog, tcache = TF.lm_decode_step(tparams, cfg, tcache, t,
                                         torch.from_numpy(x))
        _close(plog, jlog)
        _close(plog, dlog.numpy(), atol=1e-5, rtol=1e-5)
    _close(tpaged["k_pool"], jpaged["k_pool"])


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_input_specs_match_jax(model, shape):
    """Train and prefill batches carry a bf16 (B, min(1024, S // 4),
    d_model) embeds prefix; decode specs carry none."""
    cfg, jcfg, _, _ = model
    specs = build_model(cfg, CPU).input_specs(SHAPES[shape])
    jspecs = jax_build_model(jcfg).input_specs(JAX_SHAPES[shape])
    flat = jax.tree_util.tree_leaves_with_path(jspecs)
    tflat = jax.tree_util.tree_leaves_with_path(
        specs, is_leaf=lambda x: isinstance(x, torch.Tensor))
    assert [p for p, _ in tflat] == [p for p, _ in flat]
    for (_, t), (_, j) in zip(tflat, flat):
        assert t.device.type == "meta"
        assert tuple(t.shape) == j.shape
        assert str(t.dtype).removeprefix("torch.") == str(j.dtype)
    S, want = SHAPES[shape].seq_len, SHAPES[shape].kind != "decode"
    assert ("embeds" in specs) == want
    if want:
        assert tuple(specs["embeds"].shape)[1:] == (
            min(REG.VLM_PATCH_TOKENS, S // 4), cfg.d_model)


def test_batch_scheduler_tokens_equal_jax(model):
    """The scheduler feeds each prompt's last token, no embeds, as the
    reference's; on the CPU the port's steps are eager."""
    cfg, jcfg, jparams, tparams = model
    api = build_model(cfg, CPU)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, size=4) for _ in range(6)]
    generated = []
    for sched_cls, req_cls, a, p in ((BatchScheduler, Request, api, tparams),
                                     (JaxBatchScheduler, JaxRequest,
                                      jax_build_model(jcfg), jparams)):
        sched = sched_cls(a, p, slots=4, cache_len=32)
        reqs = [req_cls(i, q, max_new=4) for i, q in enumerate(prompts)]
        for r in reqs:
            sched.submit(r)
        done = steps = 0
        while done < len(reqs) and steps < 100:
            done += sched.step()
            steps += 1
        assert done == len(reqs)
        generated.append([r.generated for r in reqs])
        if sched_cls is BatchScheduler:
            assert sched._decode is api.decode_step
    assert generated[0] == generated[1]


def test_launch_serve_runs_the_reduced_vlm_on_the_cpu(capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", ARCH, "--device", "cpu", "--requests", "2",
                "--max-new", "2", "--slots", "2"])
    out = capsys.readouterr().out
    assert "decode step: eager (cpu)" in out and f"arch={ARCH}" in out


def _mrope_repeat_interleave(x, positions_3d, theta, sections):
    """``apply_mrope`` as the port wrote it before its section ids were
    built on the device: ``repeat_interleave`` over a tensor of repeats
    copied from the sections (a host-to-device copy and a host read of
    their sum on a card)."""
    B, S, H, D = x.shape
    half = D // 2
    freqs = TL._rope_freqs(D, theta, x.device)
    sec_id = torch.repeat_interleave(torch.arange(3, device=x.device),
                                     torch.tensor(sections, device=x.device))
    pos = torch.gather(positions_3d.float(), 2,
                       sec_id[None, None, :].expand(B, S, half))
    ang = pos * freqs[None, None, :]
    return TL._rotate_halves(x, ang.cos()[:, :, None, :], ang.sin()[:, :, None, :])


@pytest.mark.parametrize("head_dim", [32, 128])
def test_mrope_with_distinct_axis_positions_matches_jax(head_dim):
    """Temporal, height and width positions all different, at the reduced
    head dim (sections (4, 6, 6)) and the full one (16, 24, 24); bit-equal
    to the former repeat_interleave form.  Positions up to 4096 make
    angles of up to 4096 radians, where one float32 ulp is 5e-4 and the two
    frameworks' inverse frequencies differ in their last bits, so the
    comparison with JAX is held to the module's 1e-4."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 7, 3, head_dim), np.float32)
    pos3 = rng.integers(0, 4096, (2, 7, 3)).astype(np.int32)
    sections = TL._mrope_sections(head_dim)
    assert sections == JL._mrope_sections(head_dim)
    assert sections == {32: (4, 6, 6), 128: (16, 24, 24)}[head_dim]
    tx, tp = torch.from_numpy(x), torch.from_numpy(pos3)
    got = TL.apply_mrope(tx, tp, 1e6, sections)
    _close(got, JL.apply_mrope(jnp.asarray(x), jnp.asarray(pos3), 1e6, sections))
    assert torch.equal(got, _mrope_repeat_interleave(tx, tp, 1e6, sections))
    for dtype in (torch.bfloat16, torch.float32):
        assert torch.equal(TL.apply_mrope(tx.to(dtype), tp, 1e6, sections),
                           _mrope_repeat_interleave(tx.to(dtype), tp, 1e6, sections))


@pytest.mark.parametrize("head_dim", [32, 128])
def test_mrope_with_broadcast_positions_equals_rope_bitwise(head_dim):
    """A text token's three positions are equal, and then M-RoPE is RoPE:
    every section rotates by the same angle."""
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((2, 6, 4, head_dim), np.float32))
    pos = torch.arange(6)[None].expand(2, 6) + 1000
    for dtype in (torch.float32, torch.bfloat16):
        assert torch.equal(
            TL.apply_mrope(x.to(dtype), pos[..., None].expand(2, 6, 3), 1e6,
                           TL._mrope_sections(head_dim)),
            TL.apply_rope(x.to(dtype), pos, 1e6))
