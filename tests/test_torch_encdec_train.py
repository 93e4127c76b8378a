"""Gradients of the port's encoder-decoder (``repro_torch.models.encdec``)
against the JAX package's on reduced SeamlessM4T-medium (2 encoder and 2
decoder layers, d_model 128, 4 heads of 32, vocab 512), in fp32.

Both sides start from the same JAX-initialised parameters cast to fp32
(``to_torch``), seeded numpy frames (B 2, 24 frames) and tokens (12).  The
reference's ``encode`` raises on fp32 params (``test_torch_encdec.py``), so
the gradients are taken of the pieces it does run in fp32, as the forward
tests there do:

- the decoder's leaves and the encoder states' gradient against
  ``jax.grad`` of ``JED.dec_forward`` given encoder states;
- every leaf (the encoder's among them) of the registry's ``loss_fn``
  against ``jax.grad`` of the JAX layer loop of the encoder (the one of
  ``test_encode_matches_jax_layer_loop_fp32``) followed by
  ``JED.dec_forward``.

Each gradient leaf is held to 1e-4 of its largest |value| (the logits'
tolerance of the forward parity tests; the gradients' scale varies by
leaf), the loss to 1e-5 relative, but for one slice: the first encoder
layer's ``norm1_w`` and ``norm1_b``.  Their normed output is rounded to
bf16 (the frames are bf16, and so is the first norm's output, in both
packages), so their gradient sums cotangents rounded to bf16, and a last
fp32 digit upstream flips a rounding: the JAX package's own jitted and
eager gradients differ there by 1.2e-3 and 5.6e-4.  That slice is held to
one bf16 step, 2^-7, of its largest |value|; the second layer's slice,
which sees fp32 inputs, to 1e-4.  Also: ``remat`` recomputes every layer
in the backward and leaves the loss and gradients bit for bit; microbatches
split the frames with the tokens; ``encdec_prefill`` runs no layer under
activation checkpointing.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced_config
from repro.models import encdec as JED
from repro.models import layers as JL
from repro.models.registry import cross_entropy as jax_cross_entropy
from repro_torch.configs import get_config, reduced_config
from repro_torch.interop import to_torch
from repro_torch.models import encdec as ED
from repro_torch.models import layers as TL
from repro_torch.models.registry import build_model, cross_entropy
from repro_torch.train import loop
from repro_torch.train.loop import TrainConfig, value_and_grad
from repro_torch.tree import leaf_paths

ARCH = "seamless_m4t_medium"
CPU = "cpu"
B, S_ENC, S = 2, 24, 12
TOL = 1e-4
TOL_BF16_COTANGENT = 2.0 ** -7


@pytest.fixture(scope="module")
def fp32():
    cfg, jcfg = (reduced_config(get_config(ARCH)),
                 jax_reduced_config(jax_get_config(ARCH)))
    jparams, _ = JED.init_encdec(jcfg, jax.random.PRNGKey(0))
    jparams = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jparams)
    return cfg, jcfg, jparams, to_torch(jax.device_get(jparams), device=CPU)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    return {"frames": rng.standard_normal((B, S_ENC, 128)).astype(np.float32),
            "tokens": rng.integers(0, 512, (B, S)).astype(np.int32),
            "labels": rng.integers(0, 512, (B, S)).astype(np.int32)}


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jax_encode_loop(jparams, jcfg, frames):
    """The reference's encoder as a Python loop of its own layer
    functions from bf16-rounded frames (its ``encode`` raises on fp32)."""
    x = frames.astype(jnp.bfloat16)
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
    return x


def _torch_grads(fn, *trees):
    """(value, gradient trees) of the scalar ``fn(*trees)``."""
    flat = [t.detach().requires_grad_() for tree in trees for _, t in leaf_paths(tree)]
    it = iter(flat)
    leaves = [{p: next(it) for p, _ in leaf_paths(tree)} for tree in trees]

    def rebuild(tree, by_path, prefix=()):
        if isinstance(tree, dict):
            return {k: rebuild(v, by_path, prefix + (k,)) for k, v in tree.items()}
        return by_path[prefix]

    with torch.enable_grad():
        value = fn(*(rebuild(t, l) for t, l in zip(trees, leaves)))
        grads = torch.autograd.grad(value, flat, allow_unused=True)
    grads = iter(g if g is not None else torch.zeros_like(t) for g, t in zip(grads, flat))
    return value.detach(), [{p: next(grads) for p in l} for l in leaves]


def _leaf_close(t, j, path):
    t, j = t.detach().float().numpy(), np.asarray(j, np.float32)
    assert t.shape == j.shape, path
    err = np.abs(t - j).max() / max(np.abs(j).max(), 1e-30)
    assert err <= TOL, f"{path}: {err:.3e} of max |grad|"


def _jax_by_path(tree):
    return {tuple(p.key for p in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_decoder_and_encoder_state_gradients_match_jax(fp32):
    cfg, jcfg, jparams, tparams = fp32
    batch = _inputs()
    enc = np.random.default_rng(5).standard_normal((B, S_ENC, 128)).astype(np.float32)
    tb = _torch_batch(batch)

    def loss(p, e):
        return cross_entropy(ED.dec_forward(p, cfg, tb["tokens"], e["enc"]),
                             tb["labels"])

    tloss, (tg, te) = _torch_grads(loss, tparams, {"enc": torch.from_numpy(enc)})
    jloss, (jg, je) = jax.value_and_grad(
        lambda p, e: jax_cross_entropy(
            JED.dec_forward(p, jcfg, jnp.asarray(batch["tokens"]), e),
            jnp.asarray(batch["labels"])), argnums=(0, 1))(jparams, jnp.asarray(enc))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    jg = _jax_by_path(jg)
    decoder = [p for p in tg if p[0] != "encoder"]
    assert {p[0] for p in decoder} == {"decoder", "embedding", "final_norm"}
    for path in decoder:
        assert float(tg[path].abs().max()) > 0, path
        _leaf_close(tg[path], jg[path], path)
    _leaf_close(te[("enc",)], je, "enc_states")


def test_every_leaf_of_the_loss_matches_jax_through_the_encoder_loop(fp32):
    """The registry's ``loss_fn`` (encoder and decoder under remat) against
    the JAX encoder loop and ``JED.dec_forward``: every leaf, the
    encoder's included."""
    cfg, jcfg, jparams, tparams = fp32
    batch = _inputs()
    tloss, tg = value_and_grad(build_model(cfg, CPU), tparams, _torch_batch(batch))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jloss, jg = jax.value_and_grad(lambda p: jax_cross_entropy(
        JED.dec_forward(p, jcfg, jb["tokens"], _jax_encode_loop(p, jcfg, jb["frames"])),
        jb["labels"]))(jparams)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    jg = _jax_by_path(jg)
    tflat = leaf_paths(tg)
    assert [p for p, _ in tflat] == list(jg)
    assert any(p[0] == "encoder" for p, _ in tflat)
    for path, t in tflat:
        if path[0] == "encoder":
            assert float(t.abs().max()) > 0, path
        if path[:2] in (("encoder", "norm1_w"), ("encoder", "norm1_b")):
            j = np.asarray(jg[path])
            _leaf_close(t[1:], j[1:], path)
            err = np.abs(t[0].numpy() - j[0]).max() / np.abs(j[0]).max()
            assert err <= TOL_BF16_COTANGENT, f"{path}[0]: {err:.3e} of max |grad|"
        else:
            _leaf_close(t, jg[path], path)


def _count_calls(monkeypatch, module, name, calls):
    real = getattr(module, name)

    def fn(*args, **kw):
        calls.append(name)
        return real(*args, **kw)

    monkeypatch.setattr(module, name, fn)


def test_remat_recomputes_each_layer_and_keeps_the_gradients(fp32, monkeypatch):
    """With remat the backward runs every encoder and decoder layer again:
    2 x (L_enc + 2 L_dec) flash calls (encoder self-attention, decoder
    self- and cross-attention) in one forward and backward, half that
    without; the same loss and gradients bit for bit."""
    cfg, _, _, tparams = fp32
    tb = _torch_batch(_inputs())
    calls = []
    _count_calls(monkeypatch, TL, "flash_attention", calls)
    _count_calls(monkeypatch, ED, "flash_attention", calls)
    out = {}
    for remat in (True, False):
        calls.clear()

        def loss(p, remat=remat):
            logits, _ = ED.encdec_forward(p, cfg, tb["tokens"], tb["frames"], remat=remat)
            return cross_entropy(logits, tb["labels"])

        out[remat] = _torch_grads(loss, tparams)
        per_pass = cfg.encoder_layers + 2 * cfg.decoder_layers
        assert len(calls) == (2 if remat else 1) * per_pass
    assert torch.equal(out[True][0], out[False][0])
    for path, t in out[True][1][0].items():
        assert torch.equal(t, out[False][1][0][path]), path


def test_microbatches_split_the_frames_with_the_tokens():
    """bf16 parameters, microbatch 2: each half batch carries its own
    frames, and the fp32 accumulated gradients equal the fp32 mean of the
    two halves' bf16 gradients bit for bit, the loss their mean."""
    cfg = reduced_config(get_config(ARCH))
    api = build_model(cfg, CPU)
    params, _ = api.init(torch.Generator().manual_seed(0))
    batch = _torch_batch(_inputs())
    g, loss = loop.compute_grads(api, TrainConfig(microbatch=2), params, batch)
    halves = [value_and_grad(api, params, {k: v[i:i + 1] for k, v in batch.items()})
              for i in range(2)]
    swapped = value_and_grad(api, params, {**{k: v[:1] for k, v in batch.items()},
                                           "frames": batch["frames"][1:]})
    assert not torch.equal(swapped[0], halves[0][0])   # the frames matter
    np.testing.assert_allclose(float(loss), float(halves[0][0] + halves[1][0]) / 2,
                               rtol=1e-6)
    assert {t.dtype for _, t in leaf_paths(g)} == {torch.float32}
    for (path, a), (_, b0), (_, b1) in zip(leaf_paths(g), leaf_paths(halves[0][1]),
                                           leaf_paths(halves[1][1])):
        assert torch.equal(a, (b0.float() + b1.float()) * 0.5), path


def test_prefill_is_not_rematerialized(fp32, monkeypatch):
    """``encdec_prefill`` encodes with ``remat=False``, as the reference's
    does, and its decoder loop has none: no layer goes through activation
    checkpointing, while the training forward checkpoints every layer."""
    cfg, _, _, tparams = fp32
    tb = _torch_batch(_inputs())
    calls = []
    _count_calls(monkeypatch, torch.utils.checkpoint, "checkpoint", calls)
    with torch.enable_grad():
        ED.encdec_prefill(tparams, cfg, tb["tokens"], tb["frames"])
        assert calls == []
        ED.encdec_forward(tparams, cfg, tb["tokens"], tb["frames"])
    assert len(calls) == cfg.encoder_layers + cfg.decoder_layers
