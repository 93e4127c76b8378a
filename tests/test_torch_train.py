"""The port's training (``repro_torch.train.loop``) against the JAX
package's on the CPU.

Gradients: ``value_and_grad`` of the registry loss on reduced TinyLlama,
granite-MoE (with its load-balance loss), qwen2_vl (with an embeds
prefix), gemma3 (local:global with a tail: the remat of its groups and
tail), RWKV6 and Zamba2 (5 Mamba2 layers: two groups of 2 with the shared
attention block, and a tail of 1) against ``jax.value_and_grad(api.loss_fn)``, on JAX-initialised
parameters cast to float32 (``interop.to_torch``), so the only differences
are summation order and fp32 transcendental rounding.  Tolerances: the
loss 1e-5 relative; each gradient leaf 1e-4 of its largest |value| (the
gradients' scale varies by leaf; 1e-4 is the logits' tolerance of the
forward parity tests).

Trainer: four steps, microbatch 1 and 2, give the JAX Trainer's losses
and grad norms (started from the same fp32 parameters) within 1e-4
relative: Adam divides by sqrt(v), so a gradient element near zero turns
a last-digit difference into a visible one, and the steps carry it on.

The Trainer's in-place step (``make_train_fn(..., donate=True)``) is
bit-equal to the out-of-place one, on the storage it was given.

Also: remat recomputes every layer in the backward (the attention and
gla_scan calls counted; Zamba2's tail is not rematerialized, as in the
reference) and leaves the gradients bit for bit; a port of
``test_tinyllama_short_training_descends``; the reference's
``compress_pod_grads=True`` step raising (ROADMAP.md, Queue 3) and the
port's step equal to the reference's pieces composed by hand; and a run
resumed from a DDS checkpoint equal bit for bit to one that was not
interrupted.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced_config
from repro.data.pipeline import BatchSpec as JaxBatchSpec
from repro.data.pipeline import TokenPipeline as JaxTokenPipeline
from repro.models.registry import build_model as jax_build_model
from repro.optim import adamw_init as jax_adamw_init
from repro.optim import adamw_update as jax_adamw_update
from repro.optim import warmup_cosine as jax_warmup_cosine
from repro.optim.compression import compress_tree as jax_compress_tree
from repro.optim.compression import decompress_tree as jax_decompress_tree
from repro.optim.compression import init_compression as jax_init_compression
from repro.train.loop import TrainConfig as JaxTrainConfig
from repro.train.loop import Trainer as JaxTrainer
from repro_torch.configs import get_config, reduced_config
from repro_torch.core.dds_server import DDSStorageServer, ServerConfig
from repro_torch.data.pipeline import BatchSpec, TokenPipeline
from repro_torch.interop import to_torch
from repro_torch.models import layers as TL
from repro_torch.models import ssm as SSM
from repro_torch.models.registry import build_model
from repro_torch.optim import AdamWState, adamw_init
from repro_torch.optim.compression import CompressionState
from repro_torch.storage.checkpoint import CheckpointManager
from repro_torch.train import loop
from repro_torch.train.loop import TrainConfig, Trainer, value_and_grad
from repro_torch.tree import leaf_paths, tree_clone, tree_map

CPU = "cpu"
B, S = 2, 16
# arch -> changes to the reduced config (gemma3: a tail and a window the
# 16-token batch crosses)
ARCHS = {"tinyllama_1p1b": dict(num_layers=2),
         "granite_moe_3b_a800m": dict(num_layers=2),
         "qwen2_vl_72b": dict(num_layers=2),
         "gemma3_4b": dict(num_layers=5, group_size=2, window=6),
         "rwkv6_7b": dict(num_layers=2),
         "zamba2_1p2b": dict()}


def _cfgs(arch, **more):
    changes = {**ARCHS[arch], **more}
    return (dataclasses.replace(reduced_config(get_config(arch)), **changes),
            dataclasses.replace(jax_reduced_config(jax_get_config(arch)),
                                **changes))


def _fp32_params(jcfg):
    jparams, _ = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jparams)


def _batch(cfg, seed=3):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["embeds"] = (0.02 * rng.standard_normal((B, 4, cfg.d_model))
                           ).astype(np.float32)
    return batch


def _grads_close(tgrads, jgrads, tol=1e-4):
    tflat = leaf_paths(tgrads)
    jflat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert len(tflat) == len(jflat) > 0
    for (tpath, t), (jpath, j) in zip(tflat, jflat):
        assert tpath == tuple(p.key for p in jpath)
        j = np.asarray(j, np.float32)
        assert t.shape == j.shape, tpath
        err = np.abs(t.float().numpy() - j).max() / max(np.abs(j).max(), 1e-30)
        assert err <= tol, f"{tpath}: {err:.3e} of max |grad|"


@pytest.fixture(scope="module", params=list(ARCHS))
def model(request):
    cfg, jcfg = _cfgs(request.param)
    jparams = _fp32_params(jcfg)
    return cfg, jcfg, jparams, to_torch(jax.device_get(jparams), device=CPU)


def test_loss_and_every_gradient_leaf_match_jax(model):
    cfg, jcfg, jparams, tparams = model
    batch = _batch(cfg)
    japi = jax_build_model(jcfg)
    jloss, jgrads = jax.value_and_grad(
        lambda p: japi.loss_fn(p, {k: jnp.asarray(v) for k, v in batch.items()})[0]
    )(jparams)
    loss, grads = value_and_grad(build_model(cfg, CPU), tparams,
                                 {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    _grads_close(grads, jgrads)


def test_zamba2_gradients_through_a_live_scan_match_jax():
    """Mamba2's short-conv weights start at zero (the reference's init), so
    at init the scan's x, v and output are zero and every gradient through
    it is exactly zero.  With seeded conv weights the scan's inputs get
    gradients (in_bc, in_xz, in_dt, A_log all nonzero), held to JAX as
    above."""
    cfg, jcfg = _cfgs("zamba2_1p2b")
    jparams = _fp32_params(jcfg)
    rng = np.random.default_rng(0)
    for part in ("groups", "tail"):
        conv = jparams[part]["mamba"]["conv"]
        jparams[part]["mamba"]["conv"] = jnp.asarray(
            0.3 * rng.standard_normal(conv.shape), jnp.float32)
    tparams = to_torch(jax.device_get(jparams), device=CPU)
    batch = _batch(cfg)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jax_build_model(jcfg).loss_fn(
            p, {k: jnp.asarray(v) for k, v in batch.items()})[0])(jparams)
    loss, grads = value_and_grad(build_model(cfg, CPU), tparams,
                                 {k: torch.from_numpy(v) for k, v in batch.items()})
    for name in ("in_bc", "in_xz", "in_dt", "A_log"):
        assert grads["groups"]["mamba"][name].abs().amax() > 0, name
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    _grads_close(grads, jgrads)


def _calls(cfg, remat):
    """(flash, gla_scan) calls of one forward and backward: a rematerialized
    layer runs its kernel twice, another once."""
    n = 2 if remat else 1
    if cfg.family == "ssm":
        return 0, n * cfg.num_layers
    if cfg.family == "hybrid":
        groups = cfg.num_layers // cfg.attn_every
        return n * groups, n * groups * cfg.attn_every + cfg.num_layers % cfg.attn_every
    return n * cfg.num_layers, 0


def test_remat_recomputes_each_layer_and_keeps_the_gradients(model, monkeypatch):
    """With remat the backward runs every rematerialized layer's attention
    and gla_scan again (2 calls a layer in all, 1 without), and the
    gradients are the same bits."""
    cfg, _, _, tparams = model
    api = build_model(cfg, CPU)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    calls = {"flash": [], "gla": []}

    def counting(name, real):
        def fn(*args, **kw):
            calls[name].append(1)
            return real(*args, **kw)
        return fn

    monkeypatch.setattr(TL, "flash_attention", counting("flash", TL.flash_attention))
    monkeypatch.setattr(SSM, "gla_scan", counting("gla", SSM.gla_scan))
    out = {}
    for remat in (True, False):
        for c in calls.values():
            c.clear()
        api_r = dataclasses.replace(
            api, loss_fn=lambda p, b, r=remat: _loss(cfg, p, b, r))
        out[remat] = value_and_grad(api_r, tparams, batch)
        assert (len(calls["flash"]), len(calls["gla"])) == _calls(cfg, remat)
    assert torch.equal(out[True][0], out[False][0])
    for (_, a), (_, b) in zip(leaf_paths(out[True][1]), leaf_paths(out[False][1])):
        assert torch.equal(a, b)


def _loss(cfg, params, batch, remat):
    from repro_torch.models import hybrid as HY
    from repro_torch.models import ssm_stack as SS
    from repro_torch.models import transformer as TF
    from repro_torch.models.registry import cross_entropy
    if cfg.family == "ssm":
        logits, aux = SS.rwkv_forward(params, cfg, batch["tokens"], remat=remat)
    elif cfg.family == "hybrid":
        logits, aux = HY.hybrid_forward(params, cfg, batch["tokens"], remat=remat)
    else:
        logits, aux = TF.lm_forward(params, cfg, batch["tokens"],
                                    embeds=batch.get("embeds"), remat=remat)
    return cross_entropy(logits, batch["labels"]) + 0.01 * aux, {}


def _trainers(microbatch, arch="tinyllama_1p1b"):
    cfg, jcfg = _cfgs(arch)
    kw = dict(peak_lr=3e-3, warmup_steps=2, total_steps=30, microbatch=microbatch)
    jt = JaxTrainer(jax_build_model(jcfg), JaxTrainConfig(**kw),
                    JaxTokenPipeline(JaxBatchSpec(4, S, cfg.vocab_size), seed=0))
    jt.params = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jt.params)
    jt.opt = jax_adamw_init(jt.params)
    tt = Trainer(build_model(cfg, CPU), TrainConfig(**kw),
                 TokenPipeline(BatchSpec(4, S, cfg.vocab_size), seed=0),
                 params=to_torch(jax.device_get(jt.params), device=CPU))
    return jt, tt


@pytest.mark.parametrize("microbatch", [1, 2])
def test_trainer_steps_match_jax_trainer(microbatch):
    jt, tt = _trainers(microbatch)
    jh, th = jt.run(4), tt.run(4)
    for j, t in zip(jh, th):
        assert t["step"] == j["step"]
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(t[key], j[key], rtol=1e-4, err_msg=key)


@pytest.mark.parametrize("microbatch,dtype", [(1, torch.bfloat16),
                                              (2, torch.float32)])
def test_accumulated_gradients_are_fp32(microbatch, dtype):
    """bf16 parameters: one microbatch leaves the gradients bf16; two are
    summed into fp32 zeros, as the reference's scan carry, and their mean
    is the mean of the two halves' gradients."""
    cfg, _ = _cfgs("tinyllama_1p1b")
    api = build_model(cfg, CPU)
    params, _ = api.init(torch.Generator().manual_seed(0))
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    tcfg = TrainConfig(microbatch=microbatch)
    g, loss = loop.compute_grads(api, tcfg, params, batch)
    assert {t.dtype for _, t in leaf_paths(g)} == {dtype}
    if microbatch == 2:
        halves = [value_and_grad(api, params, {k: v[i * (B // 2):(i + 1) * (B // 2)]
                                               for k, v in batch.items()})
                  for i in range(2)]
        np.testing.assert_allclose(float(loss), float(sum(h[0] for h in halves)) / 2,
                                   rtol=1e-6)
        for (_, a), (_, b0), (_, b1) in zip(leaf_paths(g), leaf_paths(halves[0][1]),
                                            leaf_paths(halves[1][1])):
            assert torch.equal(a, (b0.float() + b1.float()) * 0.5)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("microbatch", [1, 2])
@pytest.mark.parametrize("arch", ["tinyllama_1p1b", "gemma3_4b"])
def test_in_place_step_is_bit_equal_to_out_of_place(arch, microbatch, dtype):
    """Three steps of ``make_train_fn(..., donate=True)`` (the Trainer's
    step) against the out-of-place step from the same state, with a clip
    that acts: the same parameters, moments, loss and grad norm bit for
    bit; the in-place step returns the trees and storage it was given, and
    the out-of-place step leaves its inputs as they were."""
    cfg, _ = _cfgs(arch)
    api = build_model(cfg, CPU)
    params, _ = api.init(torch.Generator().manual_seed(0))
    params = tree_map(lambda t: t.to(dtype), params)
    tcfg = TrainConfig(peak_lr=3e-3, warmup_steps=2, total_steps=30,
                       max_grad_norm=0.05, microbatch=microbatch)
    out_state = (tree_clone(params), adamw_init(params))
    in_p = tree_clone(params)
    in_state = (in_p, adamw_init(params))
    storage = [t.data_ptr() for _, t in leaf_paths((in_p, in_state[1].mu, in_state[1].nu))]
    out_fn, in_fn = loop.make_train_fn(api, tcfg), loop.make_train_fn(api, tcfg, donate=True)
    for step in range(3):
        batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, seed=step).items()}
        given = tree_clone(out_state)
        p, opt, _, om = out_fn(*out_state, None, batch, step)
        for (path, a), (_, b) in zip(leaf_paths(out_state), leaf_paths(given)):
            assert torch.equal(a, b), path
        out_state = (p, opt)
        p, opt, _, im = in_fn(*in_state, None, batch, step)
        assert p is in_p and opt.mu is in_state[1].mu and opt.nu is in_state[1].nu
        in_state = (p, opt)
        assert float(om["grad_norm"]) > tcfg.max_grad_norm
        for key in ("loss", "grad_norm"):
            assert torch.equal(om[key], im[key]), key
        assert int(opt.count) == int(out_state[1].count) == step + 1
        for (path, a), (_, b) in zip(leaf_paths(out_state), leaf_paths(in_state)):
            assert a.dtype == b.dtype and torch.equal(a, b), path
        assert [t.data_ptr() for _, t in leaf_paths((p, opt.mu, opt.nu))] == storage


def test_tinyllama_short_training_descends():
    """Port of the reference's test (tests/test_models.py), from the
    reference's own initial weights (``PRNGKey(0)``, bf16, through
    ``interop.to_torch``): on its uniform tokens the reference's loss falls
    by 0.05 over 12 steps, a margin of that draw, so the port is held to
    the same draw, where it retraces the reference's losses."""
    cfg, jcfg = (dataclasses.replace(c, num_layers=2, d_ff=128, vocab_size=256)
                 for c in (reduced_config(get_config("tinyllama_1p1b")),
                           jax_reduced_config(jax_get_config("tinyllama_1p1b"))))
    jparams, _ = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    api = build_model(cfg, CPU)
    pipe = TokenPipeline(BatchSpec(4, 32, cfg.vocab_size), seed=0)
    tcfg = TrainConfig(peak_lr=3e-3, warmup_steps=2, total_steps=30)
    trainer = Trainer(api, tcfg, pipe,
                      params=to_torch(jax.device_get(jparams), device=CPU))
    hist = trainer.run(12)
    first3 = np.mean([h["loss"] for h in hist[:3]])
    last3 = np.mean([h["loss"] for h in hist[-3:]])
    assert np.isfinite(last3)
    assert last3 < first3  # random-data memorization still descends


def test_jax_compressed_step_raises_on_its_one_tuple():
    """The fault of the reference that the port does not copy (ROADMAP.md
    Queue 3): ``init_train_state`` wraps the compression state in a
    1-tuple, and ``compress_tree`` reads ``.error`` from it."""
    _, jcfg = _cfgs("tinyllama_1p1b")
    jt = JaxTrainer(jax_build_model(jcfg), JaxTrainConfig(compress_pod_grads=True),
                    JaxTokenPipeline(JaxBatchSpec(4, S, jcfg.vocab_size), seed=0))
    assert isinstance(jt.comp, tuple) and len(jt.comp) == 1
    with pytest.raises(AttributeError, match="error"):
        jt.run(1)


def test_compressed_step_matches_jax_pieces_composed_by_hand():
    """The port's step with ``compress_pod_grads``: gradients, int8
    error-feedback compress and decompress, then AdamW, as the reference's
    ``compress_tree``, ``decompress_tree`` and ``adamw_update`` give them.
    Two steps (lr 1.5e-3, then 3e-3), each from the reference's state of
    the step before (parameters, moments and residuals), so the second
    consumes a nonzero residual.  Where the gradients' last digits round
    one int8 code the other way, the residual jumps by a whole code step
    and the parameter moves by another AdamW update (at most a few lr): in
    at most 1 in 1000 elements the residual may sit one code step from
    JAX's, and the parameter within 10 lr of it; every other element is
    held to 1e-3 of the leaf's scale (residual) or 1e-4 of its largest
    |value| (parameters)."""
    cfg, jcfg = _cfgs("tinyllama_1p1b")
    jparams = _fp32_params(jcfg)
    japi, api = jax_build_model(jcfg), build_model(cfg, CPU)
    tcfg = TrainConfig(peak_lr=3e-3, warmup_steps=2, total_steps=30,
                       compress_pod_grads=True)
    _, _, comp, _ = loop.init_train_state(
        api, tcfg, params=to_torch(jax.device_get(jparams), device=CPU))
    assert isinstance(comp, CompressionState)
    step_fn = loop.make_train_fn(api, tcfg)
    jopt, jcomp = jax_adamw_init(jparams), jax_init_compression(jparams)
    for step in (1, 2):
        batch = _batch(cfg, seed=step)
        opt = AdamWState(torch.tensor(int(jopt.count), dtype=torch.int32),
                         *to_torch(jax.device_get((jopt.mu, jopt.nu)), device=CPU))
        tparams, _, comp, metrics = step_fn(
            to_torch(jax.device_get(jparams), device=CPU), opt,
            CompressionState(to_torch(jax.device_get(jcomp.error), device=CPU)),
            {k: torch.from_numpy(v) for k, v in batch.items()}, step)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        jloss, jg = jax.value_and_grad(lambda p: japi.loss_fn(p, jb)[0])(jparams)
        q, scales, jcomp = jax_compress_tree(jg, jcomp)
        lr = jax_warmup_cosine(step, peak_lr=3e-3, warmup_steps=2, total_steps=30)
        jparams, jopt, jnorm = jax_adamw_update(jax_decompress_tree(q, scales),
                                                jopt, jparams, lr)
        np.testing.assert_allclose(float(metrics["loss"]), float(jloss), rtol=1e-5)
        np.testing.assert_allclose(float(metrics["grad_norm"]), float(jnorm),
                                   rtol=1e-4)
        for (path, p), j in zip(leaf_paths(tparams),
                                jax.tree_util.tree_leaves(jparams)):
            d = np.abs(p.numpy() - np.asarray(j))
            flipped = d > 1e-4 * np.abs(np.asarray(j)).max()
            assert flipped.mean() <= 1e-3 and (d <= 10 * float(lr)).all(), path
        for (path, e), j, sc in zip(leaf_paths(comp.error),
                                    jax.tree_util.tree_leaves(jcomp.error),
                                    jax.tree_util.tree_leaves(scales)):
            d = np.abs(e.numpy() - np.asarray(j)) / float(sc)
            flipped = np.abs(d - 1) <= 1e-3
            assert bool(((d <= 1e-3) | flipped).all()), path
            assert flipped.mean() <= 1e-3, path


def test_resumed_run_equals_uninterrupted_run():
    """Four steps straight, against two steps, a DDS checkpoint (through
    the Trainer's ``save_async``), a fresh Trainer (other weights)
    restored from it and two more steps: the same losses bit for bit, and
    the restored leaves equal to the saved ones."""
    cfg, _ = _cfgs("tinyllama_1p1b")
    api = build_model(cfg, CPU)
    tcfg = TrainConfig(peak_lr=3e-3, warmup_steps=2, total_steps=30)
    pipe = TokenPipeline(BatchSpec(4, S, cfg.vocab_size), seed=0, structured=True)

    def fresh(seed, ckpt=None):
        return Trainer(api, tcfg, pipe, checkpoint_mgr=ckpt, ckpt_every=2,
                       generator=torch.Generator().manual_seed(seed))

    straight = fresh(0).run(4)
    ckpt = CheckpointManager(DDSStorageServer(ServerConfig()), keep=2)
    first = fresh(0, ckpt)
    first.run(2)
    saved = {path: t.clone() for path, t in leaf_paths(first.state())}
    second = fresh(1, ckpt)
    assert second.restore_latest() and second.step == 2
    assert int(second.opt.count) == 2
    for path, t in leaf_paths(second.state()):
        assert torch.equal(t, saved[path])
    second.ckpt = None
    resumed = second.run(2)
    assert [h["step"] for h in resumed] == [2, 3]
    assert [h["loss"] for h in straight[2:]] == [h["loss"] for h in resumed]


def test_train_launcher_cuts_depth(capsys):
    """``launch.train --layers N`` (rwkv6_7b at full depth does not fit one
    80 GB card for training) takes its steps."""
    from repro_torch.launch import train as launch_train

    launch_train.main(["--arch", "rwkv6_7b", "--reduced", "--layers", "1",
                       "--device", "cpu", "--steps", "2", "--seq", "32",
                       "--batch", "2"])
    out = capsys.readouterr().out
    assert "arch=rwkv6_7b" in out and "2 steps" in out
