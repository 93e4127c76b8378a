"""The ``"dots"`` remat policy of the port (``layers.maybe_remat``: the
layer bodies under selective activation checkpointing, saving what
``layers._dots_policy`` names) against the JAX package's
``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``, on the CPU.

Gradients: reduced TinyLlama and granite-MoE (through ``lm_forward``),
gemma3_4b with a tail, RWKV6 and Zamba2 at ``remat="dots"`` against
``jax.value_and_grad`` of the reference's loss at ``remat="dots"``, from
the same JAX-initialised parameters cast to fp32; SeamlessM4T's decoder
(and the encoder states' gradient) against the reference's ``dec_forward``
at ``"dots"``, and every leaf of its loss through the reference's encoder
as a loop of its layer functions (its ``encode`` raises on fp32 params,
``tests/test_torch_encdec.py``).  Each leaf is held to ``TOL`` (2e-5) of its
largest |value|, but for SeamlessM4T's first encoder norm, whose gradient
sums bf16-rounded cotangents in both packages (2^-7, as in
``tests/test_torch_encdec_train.py``).

The port's ``"dots"`` gradients equal its ``"full"`` and ``"none"`` ones
bit for bit.  What the policy keeps is the projections of each
rematerialized layer, no more and no fewer: the outputs it saves are
counted, and so are the matrix products (``mm``/``addmm``) of the
backward, which at ``"dots"`` are those of ``"none"`` (no projection
recomputed) and at ``"full"`` one more a projection (counted with the
checkpoint's early stop off: it ends a recompute at the last tensor the
backward reads, which skips a layer's last projection).

Last, ``make_train_step`` at ``"dots"`` on a 2 x 2 gloo mesh equals the
unsharded step (``tests/_torch_sharded_cases.py``, group ``dots``).
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced_config
from repro.models import encdec as JED
from repro.models.registry import build_model as jax_build_model
from repro.models.registry import cross_entropy as jax_cross_entropy
from repro_torch.configs import get_config, reduced_config
from repro_torch.interop import to_torch
from repro_torch.models import encdec as ED
from repro_torch.models import layers as TL
from repro_torch.models.registry import build_model, cross_entropy
from repro_torch.train.loop import value_and_grad
from repro_torch.tree import leaf_paths

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _torch_sharded_cases as sharded_cases  # noqa: E402
from test_torch_encdec_train import S_ENC, _jax_by_path, _jax_encode_loop  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"
B, S = 2, 16
TOL = 2e-5
TOL_BF16_COTANGENT = 2.0 ** -7
# arch -> changes to the reduced config (gemma3: a tail and a window the
# 16-token batch crosses)
ARCHS = {"tinyllama_1p1b": dict(num_layers=2),
         "granite_moe_3b_a800m": dict(num_layers=2),
         "gemma3_4b": dict(num_layers=5, group_size=2, window=6),
         "rwkv6_7b": dict(num_layers=2),
         "zamba2_1p2b": dict()}
SEAMLESS = "seamless_m4t_medium"
# The weights each layer applies as ``x @ W`` (JAX's dots with no batch
# dimensions).  MoE's expert weights are not among them: their products
# run over the expert dim (``bmm``; ``einsum("becd,edf->becf")``).
PROJECTIONS = frozenset({
    "wq", "wk", "wv", "wo", "wi_gate", "wi_up", "router",           # attention, MLP, MoE
    "w_r", "w_k", "w_v", "w_g", "wd_a", "wd_b", "out", "wr",        # RWKV6
    "in_xz", "in_bc", "in_dt"})                                     # Mamba2


def _cfgs(arch, remat="dots"):
    changes = {**ARCHS.get(arch, {}), "remat": remat}
    return (dataclasses.replace(reduced_config(get_config(arch)), **changes),
            dataclasses.replace(jax_reduced_config(jax_get_config(arch)), **changes))


def _fp32_params(jcfg):
    jparams, _ = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jparams)


def _batch(cfg, seed=3):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal((B, S_ENC, cfg.d_model)).astype(np.float32)
    return batch


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _leaf_err(t, j) -> float:
    t, j = t.detach().float().numpy(), np.asarray(j, np.float32)
    assert t.shape == j.shape
    return float(np.abs(t - j).max() / max(np.abs(j).max(), 1e-30))


@pytest.fixture(scope="module", params=list(ARCHS) + [SEAMLESS])
def model(request):
    cfg, jcfg = _cfgs(request.param)
    jparams = _fp32_params(jcfg)
    return cfg, jcfg, jparams, to_torch(jax.device_get(jparams), device=CPU)


def _port_grads(cfg, tparams, batch, remat=None):
    if remat is not None:
        cfg = dataclasses.replace(cfg, remat=remat)
    return value_and_grad(build_model(cfg, CPU), tparams, _torch_batch(batch))


def _jax_loss(jcfg, jparams, batch):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    if jcfg.family == "encdec":
        return jax.value_and_grad(lambda p: jax_cross_entropy(
            JED.dec_forward(p, jcfg, jb["tokens"], _jax_encode_loop(p, jcfg, jb["frames"])),
            jb["labels"]))(jparams)
    japi = jax_build_model(jcfg)
    return jax.value_and_grad(lambda p: japi.loss_fn(p, jb)[0])(jparams)


def test_dots_gradients_match_jax_dots(model):
    cfg, jcfg, jparams, tparams = model
    assert cfg.remat == jcfg.remat == "dots"
    batch = _batch(cfg)
    tloss, tg = _port_grads(cfg, tparams, batch)
    jloss, jg = _jax_loss(jcfg, jparams, batch)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    jg = _jax_by_path(jg)
    tflat = leaf_paths(tg)
    assert [p for p, _ in tflat] == list(jg)
    errs = {}
    for path, t in tflat:
        if path[:2] in (("encoder", "norm1_w"), ("encoder", "norm1_b")):
            j = np.asarray(jg[path])
            assert _leaf_err(t[0], j[0]) <= TOL_BF16_COTANGENT, path
            t, j = t[1:], j[1:]
            errs[path] = _leaf_err(t, j)
        else:
            errs[path] = _leaf_err(t, jg[path])
    worst = max(errs, key=errs.get)
    assert errs[worst] <= TOL, f"{'/'.join(worst)}: {errs[worst]:.3e} of max |grad|"


def test_seamless_decoder_dots_gradients_match_jax_dec_forward():
    """The decoder's leaves and the encoder states' gradient against
    ``jax.grad`` of the reference's ``dec_forward`` at ``"dots"`` (its own
    checkpoint policy, given encoder states)."""
    cfg, jcfg = _cfgs(SEAMLESS)
    jparams = _fp32_params(jcfg)
    tparams = to_torch(jax.device_get(jparams), device=CPU)
    batch = _batch(cfg)
    enc = np.random.default_rng(5).standard_normal((B, S_ENC, cfg.d_model)).astype(np.float32)
    tb = _torch_batch(batch)
    flat = [t.detach().requires_grad_() for _, t in leaf_paths(tparams)]
    it = iter(flat)

    def rebuild(tree):
        if isinstance(tree, dict):
            return {k: rebuild(v) for k, v in tree.items()}
        return next(it)

    e = torch.from_numpy(enc).requires_grad_()
    with torch.enable_grad():
        tloss = cross_entropy(ED.dec_forward(rebuild(tparams), cfg, tb["tokens"], e),
                              tb["labels"])
        grads = torch.autograd.grad(tloss, flat + [e], allow_unused=True)
    jloss, (jg, je) = jax.value_and_grad(
        lambda p, x: jax_cross_entropy(
            JED.dec_forward(p, jcfg, jnp.asarray(batch["tokens"]), x),
            jnp.asarray(batch["labels"])), argnums=(0, 1))(jparams, jnp.asarray(enc))
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=1e-5)
    jg = _jax_by_path(jg)
    checked = 0
    for (path, _), g in zip(leaf_paths(tparams), grads):
        if path[0] == "encoder":
            assert g is None, path
            continue
        assert float(g.abs().max()) > 0, path
        assert _leaf_err(g, jg[path]) <= TOL, path
        checked += 1
    assert checked > 0
    assert _leaf_err(grads[-1], je) <= TOL


class _CountMatmuls(TorchDispatchMode):
    """Counts the matrix products (``mm``, ``addmm``) dispatched while on."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in TL._DOTS_SAVED:
            self.n += 1
        return func(*args, **(kwargs or {}))


def _projections(cfg, params) -> int:
    """The projections the rematerialized layer bodies apply: each
    ``PROJECTIONS`` leaf of a layer's params, once for each layer that
    applies it (Zamba2's shared block once a group; its tail is not
    rematerialized, as in the reference)."""
    n = 0
    for path, t in leaf_paths(params):
        name = path[-1]
        if name not in PROJECTIONS or path[0] == "embedding":
            continue
        if path[0] == "tail" and cfg.family == "hybrid":
            continue
        if path[-2] == "moe" and name != "router":      # the experts: bmm
            continue
        n += (cfg.num_layers // cfg.attn_every if path[0] == "shared_attn"
              else int(np.prod(t.shape[:-2])))
    return n


def _run_counted(cfg, tparams, batch, remat, monkeypatch):
    """(loss, grads, outputs the dots policy saved, products of the
    backward) at ``remat``."""
    cfg = dataclasses.replace(cfg, remat=remat)
    saved = []
    policy = TL._dots_policy

    def recording(ctx, op, *args, **kwargs):
        out = policy(ctx, op, *args, **kwargs)
        if not ctx.is_recompute and out == torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE:
            saved.append(op)
        return out

    monkeypatch.setattr(TL, "_dots_policy", recording)
    leaves = [t.detach().requires_grad_() for _, t in leaf_paths(tparams)]
    it = iter(leaves)

    def rebuild(tree):
        if isinstance(tree, dict):
            return {k: rebuild(v) for k, v in tree.items()}
        return next(it)

    params = rebuild(tparams)
    api = build_model(cfg, CPU)
    # torch's checkpoint stops a recompute at the last tensor the backward
    # reads; without that stop "full" recomputes every product
    with torch.enable_grad(), torch.utils.checkpoint.set_checkpoint_early_stop(False):
        loss, _ = api.loss_fn(params, _torch_batch(batch))
        with _CountMatmuls() as bwd:
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    monkeypatch.setattr(TL, "_dots_policy", policy)
    return loss.detach(), grads, saved, bwd.n


def test_dots_saves_each_layers_projections_and_recomputes_none(model, monkeypatch):
    cfg, _, _, tparams = model
    batch = _batch(cfg)
    runs = {r: _run_counted(cfg, tparams, batch, r, monkeypatch)
            for r in ("dots", "full", "none")}
    n = _projections(cfg, tparams)
    assert n > 0
    assert len(runs["dots"][2]) == n, (len(runs["dots"][2]), n)
    assert runs["full"][2] == runs["none"][2] == []
    # the backward's products: at "dots" those of "none" (the gradients'
    # own), at "full" one more for each projection it recomputes
    assert runs["dots"][3] == runs["none"][3]
    assert runs["full"][3] == runs["none"][3] + n
    for r in ("full", "none"):
        assert torch.equal(runs["dots"][0], runs[r][0])
        for a, b in zip(runs["dots"][1], runs[r][1]):
            assert (a is None and b is None) or torch.equal(a, b)


def test_dots_gradients_equal_full_through_value_and_grad(model):
    cfg, _, _, tparams = model
    batch = _batch(cfg)
    dots, full = (_port_grads(cfg, tparams, batch, r) for r in ("dots", "full"))
    assert torch.equal(dots[0], full[0])
    for (pa, a), (pb, b) in zip(leaf_paths(dots[1]), leaf_paths(full[1])):
        assert pa == pb and torch.equal(a, b), pa


@pytest.mark.parametrize("policy,recomputed", [("none", 0), ("dots", 0), ("full", 2)])
def test_backward_products_of_a_two_projection_body(policy, recomputed):
    """``tanh(x @ w) @ w``: the backward's own products are 4 (dx and dw of
    each); "full" recomputes both forward products, "dots" neither."""
    x = torch.randn(4, 8, requires_grad=True)
    w = torch.randn(8, 8, requires_grad=True)
    with torch.utils.checkpoint.set_checkpoint_early_stop(False):
        y = TL.maybe_remat(lambda x, w: torch.tanh(x @ w) @ w, policy)(x, w).sum()
    with _CountMatmuls() as c:
        y.backward()
    assert c.n == 4 + recomputed


@pytest.fixture(scope="module")
def dots_ranks(tmp_path_factory):
    data, model, batch = 2, 2, 4
    out = tmp_path_factory.mktemp("ranks_dots") / "results.pt"
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "_torch_sharded_cases.py"),
         str(data), str(model), str(batch), str(out), "dots"],
        cwd=ROOT, capture_output=True, text=True, timeout=240,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
             "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-4000:]
    return torch.load(out, weights_only=False), batch


def _err(a, b) -> float:
    a = [np.asarray(x, np.float64) for x in (a if isinstance(a, list) else [a])]
    b = [np.asarray(x, np.float64) for x in (b if isinstance(b, list) else [b])]
    assert [x.shape for x in a] == [x.shape for x in b]
    big = max(float(np.abs(x).max()) for x in b)
    return max(float(np.abs(x - y).max()) for x, y in zip(a, b)) / max(big, 1e-30)


@pytest.mark.parametrize("name", [c[0] for c in sharded_cases.CASES["dots"]])
def test_sharded_dots_step_on_2x2_equals_unsharded(dots_ranks, name):
    """Two ``make_train_step`` steps at ``"dots"`` on a 2 x 2 gloo mesh
    (the FSDP gathers inside the layer bodies are recomputed, the
    projections kept) within 1e-5 of the unsharded steps at ``"dots"``."""
    results, batch = dots_ranks
    got, want = results[name]["train"], sharded_cases.unsharded(name, batch)["train"]
    errs = {k: _err(got[k], want[k]) for k in ("loss", "grad_norm", "params", "mu", "nu")}
    assert max(errs.values()) <= 1e-5, errs
