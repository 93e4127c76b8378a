"""Port's MoE layer (``repro_torch.models.moe``) against ``repro.models.moe``.

Both sides run the same JAX-initialised parameters (carried by
``to_torch``) on the same seeded numpy input, E 8, top-2, D 32, F 64,
B 2, S 16 (reduced granite's MoE), for each expert kind and at capacity
factors 1.25 (the configs'), 0.5 (C 2 against 4 assignments an expert on
average, so tokens drop) and 8.0 (no drops).

Tolerances: fp32 1e-4 absolute and relative on ``out``, ``aux_loss`` and
``dropped_frac`` (summation order and transcendental rounding are the only
differences).  bf16: the reference sums a token's K expert outputs in bf16
one by one, the port in one fp32 sum, and the two frameworks round the
expert activations differently, so ``out`` is held at 2e-2 relative to its
largest magnitude (measured at most 6.6e-3: under two bf16 steps), with
drops equal and ``aux_loss`` at 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.moe import init_moe as jax_init_moe
from repro.models.moe import moe_fwd as jax_moe_fwd
from repro_torch.interop import to_torch
from repro_torch.models.moe import capacity, init_moe, moe_fwd, route

E, K, D, F_, B, S = 8, 2, 32, 64, 2, 16
TOL = dict(atol=1e-4, rtol=1e-4)
BF16_REL = 2e-2
KINDS = ["swiglu", "geglu", "gelu"]
FACTORS = [1.25, 0.5, 8.0]


def _params(kind, dtype=jnp.float32, seed=1):
    jp, _ = jax_init_moe(jax.random.PRNGKey(seed), D, F_, E, K, kind)
    jp = jax.tree_util.tree_map(lambda a: a.astype(dtype), jp)
    return jp, to_torch(jax.device_get(jp), device="cpu")


def _x(seed=0):
    return np.random.default_rng(seed).standard_normal((B, S, D)).astype(np.float32)


def _both(jp, tp, x, kind, cf, jdtype=jnp.float32, tdtype=torch.float32):
    jout, jaux = jax_moe_fwd(jp, jnp.asarray(x).astype(jdtype), num_experts=E,
                             top_k=K, kind=kind, capacity_factor=cf)
    tout, taux = moe_fwd(tp, torch.from_numpy(x).to(tdtype), num_experts=E,
                         top_k=K, kind=kind, capacity_factor=cf)
    return (np.asarray(jout.astype(jnp.float32)), jaux), (tout.float().numpy(), taux)


@pytest.mark.parametrize("cf", FACTORS)
@pytest.mark.parametrize("kind", KINDS)
def test_moe_fwd_matches_jax_fp32(kind, cf):
    jp, tp = _params(kind)
    (jout, jaux), (tout, taux) = _both(jp, tp, _x(), kind, cf)
    np.testing.assert_allclose(tout, jout, **TOL)
    for name in ("aux_loss", "dropped_frac"):
        assert taux[name].dtype == torch.float32
        np.testing.assert_allclose(float(taux[name]), float(jaux[name]), **TOL)
    dropped = float(taux["dropped_frac"])
    # 0.5: C below the busiest expert's count, so tokens drop; 8.0: none.
    busiest = np.bincount(route(tp, torch.from_numpy(_x()), K)[2][0].reshape(-1)
                          .numpy(), minlength=E).max()
    if cf == 0.5:
        assert capacity(S, E, K, cf) < busiest and dropped > 0.0
    if cf == 8.0:
        assert dropped == 0.0


@pytest.mark.parametrize("cf", FACTORS)
@pytest.mark.parametrize("kind", KINDS)
def test_moe_fwd_matches_jax_bf16(kind, cf):
    jp, tp = _params(kind, jnp.bfloat16)
    x = np.array(jnp.asarray(_x()).astype(jnp.bfloat16).astype(jnp.float32))
    (jout, jaux), (tout, taux) = _both(jp, tp, x, kind, cf, jnp.bfloat16,
                                       torch.bfloat16)
    assert float(taux["dropped_frac"]) == float(jaux["dropped_frac"])
    np.testing.assert_allclose(float(taux["aux_loss"]), float(jaux["aux_loss"]),
                               **TOL)
    scale = np.abs(jout).max()
    assert np.abs(tout - jout).max() <= BF16_REL * scale


@pytest.mark.parametrize("cf", FACTORS)
def test_zero_router_ties_pick_the_lowest_experts_and_drop_as_jax(cf):
    """Every prob ties: experts 0..K-1 for every token, as ``lax.top_k``,
    and the same tokens drop at capacity (C 5 of 16 at 1.25, 2 at 0.5)."""
    jp, _ = _params("swiglu")
    jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    tp = to_torch(jax.device_get(jp), device="cpu")
    x = _x(3)
    _, _, idx = route(tp, torch.from_numpy(x), K)
    assert (idx == torch.arange(K)).all()
    (jout, jaux), (tout, taux) = _both(jp, tp, x, "swiglu", cf)
    np.testing.assert_allclose(tout, jout, **TOL)
    C = capacity(S, E, K, cf)
    want = 1.0 - min(C, S) * K / (S * K)
    assert float(taux["dropped_frac"]) == pytest.approx(want)
    np.testing.assert_allclose(float(taux["dropped_frac"]),
                               float(jaux["dropped_frac"]), **TOL)
    np.testing.assert_allclose(float(taux["aux_loss"]), float(jaux["aux_loss"]),
                               **TOL)


def test_route_tie_order_is_lax_top_k():
    """Probs (0.1, 0.3, 0.3, 0.3, 0.0): ``lax.top_k`` picks experts 1, 2;
    ``torch.topk`` may pick 1, 3."""
    p = np.asarray([0.1, 0.3, 0.3, 0.3, 0.0], np.float32)
    x = torch.eye(5)[None, :1]                          # (1, 1, 5)
    params = {"router": torch.from_numpy(np.log(p + 1e-30))[None].expand(5, 5)}
    _, _, idx = route(params, x, 2)
    _, jidx = jax.lax.top_k(jax.nn.softmax(jnp.log(jnp.asarray(p) + 1e-30)), 2)
    assert idx.reshape(-1).tolist() == np.asarray(jidx).tolist() == [1, 2]


def test_router_logits_round_to_bf16_before_routing():
    """Logits 1.0 and 1.001 tie once rounded to bf16 (the reference routes
    on ``(x @ router).astype(float32)`` in the params' dtype), so both
    sides pick expert 0 at top-1; fp32 logits would pick expert 1."""
    w = np.zeros((4, 4), np.float32)
    w[0, :2] = [1.0, 1.001]
    x = np.zeros((1, 1, 4), np.float32)
    x[0, 0, 0] = 1.0
    _, _, idx = route({"router": torch.from_numpy(w).bfloat16()},
                      torch.from_numpy(x).bfloat16(), 1)
    _, _, idx32 = route({"router": torch.from_numpy(w)}, torch.from_numpy(x), 1)
    logits = (jnp.asarray(x, jnp.bfloat16) @ jnp.asarray(w, jnp.bfloat16)
              ).astype(jnp.float32)
    _, jidx = jax.lax.top_k(jax.nn.softmax(logits, -1), 1)
    assert int(idx) == int(np.asarray(jidx).reshape(())) == 0
    assert int(idx32) == 1


def test_native_init_keeps_the_reference_layout_and_scales():
    """Names, shapes, axes and dtypes of the JAX init; router std 0.02 and
    expert std E^-0.5 (``shape[0] ** -0.5`` of an (E, D, F) weight, not
    the fan-in D^-0.5: a fault of the reference kept on purpose)."""
    En, Dn, Fn = 16, 256, 128
    tp, taxes = init_moe(torch.Generator().manual_seed(0), Dn, Fn, En, 2)
    jp, jaxes = jax_init_moe(jax.random.PRNGKey(0), Dn, Fn, En, 2)
    assert taxes == jaxes
    assert {k: tuple(v.shape) for k, v in tp.items()} == {
        k: tuple(v.shape) for k, v in jp.items()}
    assert all(v.dtype == torch.bfloat16 for v in tp.values())
    std = {k: v.float().std().item() for k, v in tp.items()}
    assert std["router"] == pytest.approx(0.02, rel=0.05)
    for name in ("wi_gate", "wi_up", "wo"):
        assert std[name] == pytest.approx(En ** -0.5, rel=0.05)
        assert float(jnp.std(jp[name].astype(jnp.float32))) == pytest.approx(
            En ** -0.5, rel=0.05)


@pytest.mark.parametrize("S_,E_,K_,want", [(512, 40, 8, 128), (1, 40, 8, 1),
                                           (512, 16, 4, 160), (1, 16, 4, 1),
                                           (16, 8, 2, 5)])
def test_capacity_is_the_reference_expression(S_, E_, K_, want):
    """granite at S 512 and at decode, dbrx likewise, reduced configs."""
    assert capacity(S_, E_, K_, 1.25) == want
