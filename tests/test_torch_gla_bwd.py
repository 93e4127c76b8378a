"""The plain backward of the GLA scan (``ref.gla_scan_bwd_ref``) against the
JAX package on the CPU.

``gla_scan_bwd_ref`` is an explicit reverse recurrence, the plain version
of the backward kernel (``csrc/gla_scan_bwd.cu``); the JAX package has no
Pallas backward, and its gradient is ``jax.vjp`` of ``gla_scan_xla``.
Both get the same seeded inputs and cotangents for the output and the
final state, and each of dq, dk, dv and dw is held to 2e-4 of its largest
|value| in fp32 (summation order and fp32 exp; the gradients' scale varies
by input), 2e-2 with bf16 q/k/v/dO (one rounding of each bf16 gradient;
w and dw stay fp32).  Cases: the GLA_CASES of the kernel tests, Mamba2's
stride-0 w, a ragged S, chunks shorter and longer than S, strong decay
(the guard saturates), and w at the exact bounds of the clip and the
guard, where JAX's derivative is one half.  The same function is also
held to autograd of the port's ``gla_scan_xla``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cases import GLA_CASES, gla_exact_bound_inputs, gla_inputs
from repro.kernels.ssm_scan.ops import gla_scan_xla as jax_gla_xla
from repro_torch.kernels.ssm_scan.ops import gla_scan_xla
from repro_torch.kernels.ssm_scan.ref import gla_scan_bwd_ref

TOL = {"float32": 2e-4, "bfloat16": 2e-2}


def _cotangents(case, seed=1):
    B, H, S, K, V, _ = case
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, S, V), np.float32),
            rng.standard_normal((B, H, K, V), np.float32))


def _jax_grads(arrays, do, d_final, chunk, dtype="float32"):
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    *qkv, w = (jnp.asarray(a) for a in arrays)
    qkv = [x.astype(jd) for x in qkv]
    _, vjp = jax.vjp(lambda *a: jax_gla_xla(*a, chunk=chunk), *qkv, w)
    return vjp((jnp.asarray(do).astype(jd), jnp.asarray(d_final)))


def _close(got, ref, tol):
    for name, t, j in zip(("dq", "dk", "dv", "dw"), got, ref):
        j = np.asarray(jnp.asarray(j).astype(jnp.float32))
        assert t.shape == j.shape, name
        err = np.abs(t.float().numpy() - j).max() / np.abs(j).max()
        assert err <= tol, f"{name}: {err:.3e} of max |grad|"


def _check(arrays, case, dtype="float32", with_final=True):
    chunk = case[-1]
    do, d_final = _cotangents(case)
    if not with_final:
        d_final = np.zeros_like(d_final)
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    *qkv, w = (torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)
    got = gla_scan_bwd_ref(*(x.to(td) for x in qkv), w, torch.from_numpy(do).to(td),
                           torch.from_numpy(d_final) if with_final else None, chunk)
    assert [g.dtype for g in got] == [td, td, td, torch.float32]
    _close(got, _jax_grads(arrays, do, d_final, chunk, dtype), TOL[dtype])


@pytest.mark.parametrize("case", GLA_CASES)
def test_bwd_ref_matches_jax_vjp(case):
    _check(gla_inputs(case), case)


def test_bwd_ref_without_a_final_state_gradient():
    case = GLA_CASES[0]
    _check(gla_inputs(case), case, with_final=False)


def test_bwd_ref_stride_zero_w():
    """Mamba2: one decay per head, broadcast over K with stride 0; dw per
    element, as JAX gives it for the broadcast array."""
    case = (2, 3, 128, 32, 64, 64)
    q, k, v, w = gla_inputs(case, seed=5)
    w1 = w[..., :1]
    wb = torch.from_numpy(w1).expand(*w.shape)
    assert wb.stride(-1) == 0
    do, d_final = _cotangents(case)
    got = gla_scan_bwd_ref(*(torch.from_numpy(x) for x in (q, k, v)), wb,
                           torch.from_numpy(do), torch.from_numpy(d_final), 64)
    _close(got, _jax_grads((q, k, v, np.broadcast_to(w1, w.shape)), do, d_final, 64),
           TOL["float32"])


@pytest.mark.parametrize("case", [(2, 2, 100, 32, 16, 32),     # ragged S
                                  (1, 2, 200, 64, 64, 128),    # ragged, chunk < S
                                  (1, 2, 50, 16, 32, 128)],    # chunk > S
                         ids=["ragged", "ragged-128", "chunk-over-S"])
def test_bwd_ref_ragged_and_chunk_sizes(case):
    _check(gla_inputs(case, seed=3), case)


def test_bwd_ref_strong_decay():
    """w = -2.5: the guard saturates after 24 positions of a chunk of 128,
    and its derivative is zero there."""
    case = (1, 2, 256, 32, 32, 128)
    q, k, v, _ = gla_inputs(case, seed=7)
    _check((q, k, v, np.full(q.shape, -2.5, np.float32)), case)


def test_bwd_ref_at_exact_bounds():
    case, arrays = gla_exact_bound_inputs()
    _check(arrays, case)


def test_bwd_ref_bf16():
    case = GLA_CASES[1]
    _check(gla_inputs(case), case, dtype="bfloat16")


@pytest.mark.parametrize("case", GLA_CASES[:2] + [(2, 2, 100, 32, 16, 32)])
def test_bwd_ref_matches_port_autograd(case):
    """The same gradients as torch autograd through the port's chunked
    ``gla_scan_xla`` (whose clip and guard give JAX's derivative)."""
    chunk = case[-1]
    do, d_final = _cotangents(case)
    leaves = [torch.from_numpy(a).requires_grad_() for a in gla_inputs(case)]
    o, s = gla_scan_xla(*leaves, chunk=chunk)
    torch.autograd.backward((o, s), (torch.from_numpy(do), torch.from_numpy(d_final)))
    got = gla_scan_bwd_ref(*(t.detach() for t in leaves), torch.from_numpy(do),
                           torch.from_numpy(d_final), chunk)
    for name, g, t in zip(("dq", "dk", "dv", "dw"), got, leaves):
        err = (g - t.grad).abs().max() / t.grad.abs().max()
        assert err <= TOL["float32"], f"{name}: {err:.3e}"
