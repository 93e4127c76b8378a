"""Port's GLA scan (``repro_torch.kernels.ssm_scan``) against the JAX package.

Inputs come from numpy with a fixed seed (``_torch_cases.gla_inputs``);
bf16 inputs are rounded once and cast on both sides, so both frameworks see
the same bits.  Tolerances are those of the JAX GLA tests
(tests/test_kernels.py): on the output, atol = rtol = 4 x {2e-5 fp32,
2e-2 bf16} (``test_gla_xla_chunked``) or 1e-4 (``test_gla_pallas_interpret``,
``test_gla_decode_continuation``); on the final fp32 state 1e-3, or 1e-4
for the decode continuation.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cases import GLA_CASES, TOL, gla_exact_bound_inputs, gla_inputs
from repro.kernels.ssm_scan.kernel import gla_scan_pallas as jax_gla_pallas
from repro.kernels.ssm_scan.ops import gla_scan_xla as jax_gla_xla
from repro.kernels.ssm_scan.ref import gla_decode_step as jax_decode_step
from repro.kernels.ssm_scan.ref import gla_scan_ref as jax_gla_ref
from repro_torch.kernels.ssm_scan import gla_scan
from repro_torch.kernels.ssm_scan.ops import gla_scan_xla
from repro_torch.kernels.ssm_scan.ref import gla_decode_step, gla_scan_ref

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pairs(arrays, dtype="float32"):
    """(jax, torch) pairs; q, k, v in ``dtype``, w always float32."""
    jd, td = DTYPES[dtype]
    *qkv, w = arrays
    return ([(jnp.asarray(a).astype(jd), torch.from_numpy(a).to(td))
             for a in qkv] + [(jnp.asarray(w), torch.from_numpy(w))])


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, ref, o_tol, s_tol=1e-3):
    (o, s), (ro, rs) = got, ref
    np.testing.assert_allclose(_np(o), _np(ro), atol=o_tol, rtol=o_tol)
    np.testing.assert_allclose(_np(s), _np(rs), atol=s_tol, rtol=s_tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", GLA_CASES)
def test_gla_scan_xla_matches_jax(case, dtype):
    chunk = case[-1]
    (jq, tq), (jk, tk), (jv, tv), (jw, tw) = _pairs(gla_inputs(case), dtype)
    got = gla_scan_xla(tq, tk, tv, tw, chunk=chunk)
    assert got[0].dtype == tq.dtype and got[1].dtype == torch.float32
    _close(got, jax_gla_xla(jq, jk, jv, jw, chunk=chunk), 4 * TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", GLA_CASES)
def test_gla_scan_ref_matches_jax(case, dtype):
    (jq, tq), (jk, tk), (jv, tv), (jw, tw) = _pairs(gla_inputs(case), dtype)
    _close(gla_scan_ref(tq, tk, tv, tw), jax_gla_ref(jq, jk, jv, jw),
           4 * TOL[dtype])


@pytest.mark.parametrize("case", GLA_CASES[:3])
def test_plain_version_matches_jax_pallas_interpret(case):
    """The kernel's plain version against the Pallas kernel itself (its
    interpret mode on the CPU)."""
    chunk = case[-1]
    (jq, tq), (jk, tk), (jv, tv), (jw, tw) = _pairs(gla_inputs(case, seed=5))
    ref = jax_gla_pallas(jq, jk, jv, jw, chunk=chunk, interpret=True)
    _close(gla_scan_xla(tq, tk, tv, tw, chunk=chunk), ref, 1e-4)


def test_gla_scan_xla_init_state_matches_jax():
    case = GLA_CASES[1]
    (jq, tq), (jk, tk), (jv, tv), (jw, tw) = _pairs(gla_inputs(case, seed=8))
    s0 = np.random.default_rng(8).standard_normal(
        (case[0], case[1], case[3], case[4]), np.float32)
    got = gla_scan_xla(tq, tk, tv, tw, chunk=64, init_state=torch.from_numpy(s0))
    _close(got, jax_gla_xla(jq, jk, jv, jw, chunk=64, init_state=jnp.asarray(s0)),
           4 * TOL["float32"])


def test_gla_decode_continuation():
    """prefill(S-1) on the plain chunked path + one decode step == the
    full JAX recurrence at position S-1 (test_gla_decode_continuation)."""
    case = (2, 2, 64, 32, 32, 16)
    (jq, tq), (jk, tk), (jv, tv), (jw, tw) = _pairs(gla_inputs(case, seed=6))
    o_all, s_all = jax_gla_ref(jq, jk, jv, jw)
    _, s_pre = gla_scan_xla(tq[:, :, :-1], tk[:, :, :-1], tv[:, :, :-1],
                            tw[:, :, :-1], chunk=16)
    o_dec, s_dec = gla_decode_step(tq[:, :, -1], tk[:, :, -1], tv[:, :, -1],
                                   tw[:, :, -1], s_pre)
    _close((o_dec, s_dec), (o_all[:, :, -1], s_all), 1e-4, 1e-4)
    jo, js = jax_decode_step(jq[:, :, -1], jk[:, :, -1], jv[:, :, -1],
                             jw[:, :, -1], jnp.asarray(s_pre.numpy()))
    _close((o_dec, s_dec), (jo, js), 1e-6, 1e-6)


def test_gla_strong_decay_is_finite_and_equals_jax():
    """w = -2.5: the exponent guard keeps the output finite, and the port
    reproduces the JAX chunked path (guard included), which departs from
    the naive recurrence here (ROADMAP.md, Queue 3)."""
    case = (1, 1, 256, 32, 32, 128)
    q, k, v, _ = gla_inputs(case, seed=7)
    w = np.full(q.shape, -2.5, np.float32)
    (jq, tq), (jk, tk), (jv, tv), (jw, tw) = _pairs((q, k, v, w))
    o, s = gla_scan_xla(tq, tk, tv, tw, chunk=128)
    assert torch.isfinite(o).all() and torch.isfinite(s).all()
    _close((o, s), jax_gla_xla(jq, jk, jv, jw, chunk=128), 4 * TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ragged_sequence_matches_jax_and_recurrence(dtype):
    """S = 100 over chunks of 32: the zero padding of the last chunk."""
    case = (2, 2, 100, 32, 16, 32)
    (jq, tq), (jk, tk), (jv, tv), (jw, tw) = _pairs(gla_inputs(case, seed=3),
                                                    dtype)
    got = gla_scan_xla(tq, tk, tv, tw, chunk=32)
    assert got[0].shape == (2, 2, 100, 16)
    _close(got, jax_gla_xla(jq, jk, jv, jw, chunk=32), 4 * TOL[dtype])
    _close(got, gla_scan_ref(tq, tk, tv, tw), 4 * TOL[dtype])


def test_dispatcher_on_cpu_tensors_takes_the_plain_versions():
    case = GLA_CASES[2]
    q, k, v, w = (torch.from_numpy(a) for a in gla_inputs(case))
    for impl, ref in ((None, gla_scan_xla(q, k, v, w, chunk=32)),
                      ("naive", gla_scan_ref(q, k, v, w))):
        o, s = gla_scan(q, k, v, w, chunk=32, impl=impl)
        assert torch.equal(o, ref[0]) and torch.equal(s, ref[1])
    with pytest.raises(ValueError, match="CUDA"):
        gla_scan(q, k, v, w, chunk=32, impl="cuda")
    with pytest.raises(ValueError, match="unknown impl"):
        gla_scan(q, k, v, w, impl="pallas")


@pytest.mark.parametrize("case", GLA_CASES[:2])
def test_gla_xla_gradients_match_jax(case):
    """Port of tests/test_kernels.py::test_gla_xla_gradients_match_naive:
    the gradients of sum(o^2) through the chunked path, by torch autograd,
    against ``jax.grad`` of the JAX chunked path and against autograd of
    the port's plain recurrence, at that test's tolerance (5e-3)."""
    import jax

    _, _, _, _, _, chunk = case
    arrays = gla_inputs(case)
    j_grads = jax.grad(
        lambda *a: jnp.sum(jnp.square(jax_gla_xla(*a, chunk=chunk)[0])),
        argnums=(0, 1, 2, 3))(*(jnp.asarray(a) for a in arrays))
    for fn in (lambda *a: gla_scan_xla(*a, chunk=chunk), gla_scan_ref):
        leaves = [torch.from_numpy(a).requires_grad_() for a in arrays]
        fn(*leaves)[0].square().sum().backward()
        for t, j in zip(leaves, j_grads):
            np.testing.assert_allclose(_np(t.grad), np.asarray(j), atol=5e-3,
                                       rtol=5e-3)


def test_gla_xla_gradients_at_the_exact_bounds_match_jax(monkeypatch):
    """w exactly 0 and -30 and -a reaching 60 exactly (``gla_exact_bound_inputs``): autograd of the port's
    chunked path gives jax.grad's half derivative at each tie, within the
    5e-3 of the test above; the former ``clamp`` forms give all of it and
    miss.  The forward is the same bits either way."""
    import jax

    from repro_torch.kernels.ssm_scan import ops

    case, arrays = gla_exact_bound_inputs()
    chunk = case[-1]
    j_grads = jax.grad(
        lambda *a: jnp.sum(jnp.square(jax_gla_xla(*a, chunk=chunk)[0])),
        argnums=(0, 1, 2, 3))(*(jnp.asarray(a) for a in arrays))

    def run():
        leaves = [torch.from_numpy(a).requires_grad_() for a in arrays]
        o, s = gla_scan_xla(*leaves, chunk=chunk)
        o.square().sum().backward()
        return o.detach(), s.detach(), [t.grad for t in leaves]

    o, s, grads = run()
    for t, j in zip(grads, j_grads):
        np.testing.assert_allclose(_np(t), np.asarray(j), atol=5e-3, rtol=5e-3)
    monkeypatch.setattr(ops, "clamp_decay", lambda w: w.clamp(-ops.CLAMP, 0.0))
    monkeypatch.setattr(ops, "guard", lambda a: torch.clamp(-a, max=ops.GUARD))
    o_old, s_old, old = run()
    assert torch.equal(o, o_old) and torch.equal(s, s_old)
    assert np.abs(_np(old[3]) - np.asarray(j_grads[3])).max() > 1.0
