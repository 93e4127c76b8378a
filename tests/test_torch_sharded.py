"""The port's sharded entry points on a 1 x 1 mesh (a gloo world of one
in this process) against the JAX package's, on the CPU.

Reduced TinyLlama, granite-MoE and RWKV6 in fp32, with JAX-initialised
parameters carried over by ``interop``: two steps of the port's
``make_train_step`` against the step of JAX's ``make_train_step`` on a
1 x 1 ``jax.make_mesh`` (losses, grad norms, then params and AdamW
moments; its ``jit_for`` refuses its own optimizer state, a fault pinned
here), and ``make_serve_fns``' prefill and four decode
steps against JAX's, each within 1e-5 of the largest |value|.  The other
families (Zamba2, SeamlessM4T, gemma3 with a tail and a window, qwen2-VL
with an embeds prefix) go through the port's 1 x 1 step against its own
single-device step.  Also: the entry points' outputs are DTensors, the
hooks leave a DTensor alone outside a scope, and a DTensor that reaches a
kernel's launcher raises.  ``tests/test_torch_sharded_ranks.py`` runs the
same entry points across ranks.
"""

import dataclasses
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)

from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced_config
from repro.configs.base import ShapeConfig as JaxShapeConfig
from repro.models.registry import build_model as jax_build_model
from repro.optim import adamw_init as jax_adamw_init
from repro.serve.engine import make_serve_fns as jax_make_serve_fns
from repro.train.loop import TrainConfig as JaxTrainConfig
from repro.train.loop import make_train_step as jax_make_train_step
from repro_torch.configs import get_config, reduced_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed import sharding as sh
from repro_torch.interop import to_torch
from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.kernels.paged_attention import kernel as PK
from repro_torch.kernels.ssm_scan import kernel as GK
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models.registry import build_model
from repro_torch.optim import adamw_init
from repro_torch.serve.engine import make_serve_fns
from repro_torch.train.loop import (TrainConfig, abstract_init, make_train_fn,
                                    make_train_step)
from repro_torch.tree import leaves, tree_map

B, S, STEPS, DECODE = 2, 16, 2, 4
TOL = 1e-5
JAX_ARCHS = ["tinyllama_1p1b", "granite_moe_3b_a800m", "rwkv6_7b"]
OWN_ARCHS = {"zamba2_1p2b": {}, "seamless_m4t_medium": {},
             "gemma3_4b": dict(num_layers=5, group_size=2, window=6),
             "qwen2_vl_72b": {}}


@pytest.fixture(scope="module")
def mesh():
    """A gloo world of one and its 1 x 1 mesh, torn down after the module."""
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("gloo", store=dist.FileStore(f"{tmp}/store", 1),
                                rank=0, world_size=1)
        try:
            yield make_test_mesh(device="cpu")
        finally:
            dist.destroy_process_group()


def _cfgs(arch, **changes):
    changes = {"num_layers": 2, **changes}
    return (dataclasses.replace(reduced_config(get_config(arch)), **changes),
            dataclasses.replace(jax_reduced_config(jax_get_config(arch)), **changes))


def _batch(cfg, seed=3):
    rng = np.random.default_rng(seed)
    batch = {k: rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
             for k in ("tokens", "labels")}
    if cfg.family == "vlm":
        batch["embeds"] = (0.02 * rng.standard_normal((B, 4, cfg.d_model))
                           ).astype(np.float32)
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    return batch


def _jax_mesh():
    """The reference's 1 x 1 test mesh with GSPMD's (Auto) axes, which its
    shardings assume."""
    auto = jax.sharding.AxisType.Auto
    return jax.make_mesh((1, 1), ("data", "model"), axis_types=(auto, auto))


def _full(t):
    return (t.full_tensor() if isinstance(t, DTensor) else t).detach()


def _np(tree) -> list:
    return [np.asarray(_full(t) if isinstance(t, torch.Tensor) else t, np.float64)
            for t in (leaves(tree) if not isinstance(tree, torch.Tensor) else [tree])]


def _jnp(tree) -> list:
    return [np.asarray(x, np.float64) for x in jax.tree_util.tree_leaves(tree)]


def _close(got: list, want: list, what: str):
    assert [g.shape for g in got] == [w.shape for w in want], what
    big = max(float(np.abs(w).max()) for w in want)
    err = max(float(np.abs(g - w).max()) for g, w in zip(got, want))
    assert err <= TOL * big, f"{what}: {err:.3e} of largest |value| {big:.3e}"


@pytest.fixture(scope="module", params=JAX_ARCHS)
def pair(request):
    cfg, jcfg = _cfgs(request.param)
    japi = jax_build_model(jcfg)
    jparams, jaxes = japi.init(jax.random.PRNGKey(0))
    jparams = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jparams)
    api = build_model(cfg, "cpu")
    _, axes = abstract_init(api)
    return cfg, api, axes, jcfg, japi, jaxes, jparams


def test_train_step_matches_jax_on_1x1(mesh, pair):
    cfg, api, axes, jcfg, japi, jaxes, jparams = pair
    batch = _batch(cfg)
    jmesh = _jax_mesh()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    # The reference's jit_for cannot take its own AdamWState (see the test
    # below): its un-jitted step, jitted without shardings, is what a
    # 1 x 1 mesh runs.
    jstep = jax.jit(jax_make_train_step(japi, jmesh, jaxes, JaxTrainConfig())[0])
    jp, jo = jparams, jax_adamw_init(jparams)
    params = to_torch(jax.device_get(jparams), device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    run = make_train_step(api, mesh, axes, TrainConfig())[1](tb)
    p, o = params, adamw_init(params)
    for i in range(STEPS):
        jp, jo, _, jm = jstep(jp, jo, None, jbatch, jnp.int32(i))
        p, o, _, m = run(p, o, None, tb, i)
        assert all(isinstance(t, DTensor) for t in leaves(p))
        for k in ("loss", "grad_norm"):
            _close(_np(m[k]), _jnp(jm[k]), f"step {i} {k}")
    _close(_np(p), _jnp(jp), "params")
    _close(_np(o.mu), _jnp(jo.mu), "mu")
    _close(_np(o.nu), _jnp(jo.nu), "nu")


def test_jax_jit_for_raises_on_its_own_adamw_state():
    """A fault of the reference the port does not copy: ``make_train_step``
    gives the moments the in_shardings ``(P(), pspecs, pspecs)``, a plain
    tuple, where the state is an ``AdamWState``, so its ``jit_for`` step
    refuses the state ``adamw_init`` makes.  The port places an
    ``AdamWState``."""
    _, jcfg = _cfgs("tinyllama_1p1b")
    japi = jax_build_model(jcfg)
    jparams, jaxes = japi.init(jax.random.PRNGKey(0))
    jbatch = {k: jnp.asarray(v) for k, v in _batch(jcfg).items()}
    jmesh = _jax_mesh()
    jstep = jax_make_train_step(japi, jmesh, jaxes, JaxTrainConfig())[1](jbatch)
    with pytest.raises(ValueError, match="AdamWState"):
        jstep(jparams, jax_adamw_init(jparams), None, jbatch, jnp.int32(0))


def test_serve_fns_match_jax_on_1x1(mesh, pair):
    cfg, api, axes, jcfg, japi, jaxes, jparams = pair
    batch = {"tokens": _batch(cfg)["tokens"]}
    jmesh = _jax_mesh()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jpre, jdec = jax_make_serve_fns(japi, jmesh, jaxes,
                                    JaxShapeConfig("serve", "prefill", S, B))
    params = to_torch(jax.device_get(jparams), device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    pre, dec = make_serve_fns(api, mesh, axes, ShapeConfig("serve", "prefill", S, B))
    logits, _ = pre(tb)(params, tb)
    assert isinstance(logits, DTensor)
    _close(_np(logits), _jnp(jpre(jbatch)(jparams, jbatch)[0]), "prefill")
    jcache = japi.prefill(jparams, jbatch, S + DECODE)[1]
    cache = api.prefill(params, tb, S + DECODE)[1]
    jstep, step = jdec(jcache), dec(cache)
    tok = tb["tokens"][:, :1]
    for i in range(DECODE):
        jl, jcache = jstep(jparams, jcache, S + i, jnp.asarray(tok.numpy()))
        lg, cache = step(params, cache, S + i, tok)
        _close(_np(lg), _jnp(jl), f"decode {i}")
    _close(_np(cache), _jnp(jcache), "cache")


@pytest.mark.parametrize("arch", list(OWN_ARCHS))
def test_other_families_step_on_1x1_equals_their_single_device_step(mesh, arch):
    cfg, _ = _cfgs(arch, **OWN_ARCHS[arch])
    api = build_model(cfg, "cpu")
    params, axes = api.init(torch.Generator().manual_seed(0))
    params = tree_map(lambda t: t.float(), params)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    tcfg = TrainConfig()
    plain, run = make_train_fn(api, tcfg), make_train_step(api, mesh, axes, tcfg)[1](batch)
    p, o, q, r = params, adamw_init(params), params, adamw_init(params)
    for i in range(STEPS):
        p, o, _, m = plain(p, o, None, batch, i)
        q, r, _, n = run(q, r, None, batch, i)
        for k in ("loss", "grad_norm"):
            _close(_np(n[k]), _np(m[k]), f"{arch} step {i} {k}")
    _close(_np(q), _np(p), f"{arch} params")
    _close(_np(r.mu), _np(o.mu), f"{arch} mu")


def test_abstract_init_allocates_nothing_and_matches_init():
    api = build_model(reduced_config(get_config("gemma3_4b")), "cpu")
    shapes, axes = abstract_init(api)
    params, axes2 = api.init(torch.Generator().manual_seed(0))
    assert axes == axes2
    assert all(s.device.type == "meta" for s in leaves(shapes))
    assert [(s.shape, s.dtype) for s in leaves(shapes)] == [
        (t.shape, t.dtype) for t in leaves(params)]


def test_hooks_leave_a_dtensor_alone_outside_a_scope(mesh):
    x = distribute_tensor(torch.randn(4, 8, 2, 16), mesh, [Replicate(), Replicate()])
    for hook in (sh.constrain_batch, sh.constrain_logits, sh.constrain_kv_layout,
                 lambda t: sh.gather_fsdp(t, tp_dim=1)):
        assert hook(x) is x


def test_reduce_model_partial_carries_out_the_pending_sum(mesh):
    """What Mamba2's dt needs before its bias add (torch 2.11's DTensor
    would make the model-sharded bias Partial, which it cannot): a Partial
    on ``model`` becomes a shard of the last dim; anything else is left
    alone."""
    t = torch.randn(2, 3, 8)
    y = sh.reduce_model_partial(DTensor.from_local(t, mesh, [Replicate(), Partial()]))
    assert tuple(y.placements) == (Replicate(), Shard(2))
    assert torch.equal(y.full_tensor(), t)
    r = distribute_tensor(t, mesh, [Replicate(), Replicate()])
    assert sh.reduce_model_partial(r) is r
    assert sh.reduce_model_partial(t) is t


def test_a_dtensor_at_a_kernel_launcher_raises(mesh):
    rep = [Replicate(), Replicate()]
    q = distribute_tensor(torch.randn(1, 8, 2, 64), mesh, rep)
    w = distribute_tensor(-torch.rand(1, 2, 8, 64), mesh, rep)
    with pytest.raises(TypeError, match="DTensor"):
        FK.flash_attention_fwd_cuda(q, q, q)
    with pytest.raises(TypeError, match="DTensor"):
        FK.flash_attention_bwd_cuda(q, q, q, q, q)
    g = q.permute(0, 2, 1, 3)
    with pytest.raises(TypeError, match="DTensor"):
        GK.gla_scan_fwd_cuda(g, g, g, w)
    pool = distribute_tensor(torch.randn(2, 16, 2, 64), mesh, rep)
    with torch.no_grad(), pytest.raises(TypeError, match="DTensor"):
        PK.paged_attention_cuda(q[:, 0], pool, pool,
                                torch.zeros(1, 2, dtype=torch.int32),
                                torch.ones(1, dtype=torch.int32))

