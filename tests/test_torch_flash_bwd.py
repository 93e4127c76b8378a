"""The flash backward's plain version (``attention_bwd_ref``) against the
JAX package's gradient of flash attention, on the CPU.

The JAX package has no Pallas backward: it differentiates its chunked jnp
path (``impl="xla_chunked"``) under ``jax.checkpoint``.  Here ``jax.vjp``
of that path (64-row and 64-key chunks, so that the ragged cases pad)
gives the reference (dq, dk, dv) for the output cotangent ``do``, and
``attention_bwd_ref`` gets the same q, k, v, JAX's output o and do, all
fp32, over the shared case table ``FA_BWD_CASES`` (``_torch_cases.py``;
the GPU tests hold the kernel to ``attention_bwd_ref`` on the same table).
Tolerance: 2e-5 of each gradient's largest |value| (the fp32 tolerance of
the kernel tests, relative because the gradients' scale varies).  Also on
the CPU: the port's dispatcher differentiated through its own chunked path
gives the same gradients, and rows that see no key get zero gradients; and
a port of the reference's gradient check of its chunked path
(tests/test_kernels.py), at its tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cases import FA_BWD_CASES, fa_bwd_inputs
from repro.kernels.flash_attention import flash_attention as jax_flash_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_bwd_ref

TOL = 2e-5


def _rel_err(got, ref) -> float:
    ref = np.asarray(ref, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - ref).max()
                 / max(np.abs(ref).max(), 1e-30))


def _jax_vjp(case, q, k, v, do):
    _, _, _, _, _, _, causal, window, q_offset = case
    fn = lambda q, k, v: jax_flash_attention(  # noqa: E731
        q, k, v, causal=causal, window=window, q_offset=q_offset,
        impl="xla_chunked", block_q=64, block_k=64)
    o, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in (q, k, v)))
    return np.array(o), [np.asarray(g) for g in vjp(jnp.asarray(do))]


@pytest.mark.parametrize("case", FA_BWD_CASES)
def test_attention_bwd_ref_matches_jax_vjp(case):
    q, k, v, do = fa_bwd_inputs(case)
    o, jgrads = _jax_vjp(case, q, k, v, do)
    _, _, _, _, _, _, causal, window, q_offset = case
    ours = attention_bwd_ref(*(torch.from_numpy(a) for a in (q, k, v, o, do)),
                             causal=causal, window=window, q_offset=q_offset)
    for name, g, j in zip(("dq", "dk", "dv"), ours, jgrads):
        assert g.dtype == torch.float32 and g.shape == j.shape, name
        assert _rel_err(g.numpy(), j) <= TOL, name


@pytest.mark.parametrize("case", FA_BWD_CASES[:4])
def test_dispatcher_autograd_on_cpu_matches_bwd_ref(case):
    """The CPU path (``flash_attention_xla`` under autograd) and the plain
    backward give the same gradients."""
    q, k, v, do = (torch.from_numpy(a) for a in fa_bwd_inputs(case))
    _, _, _, _, _, _, causal, window, q_offset = case
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o = flash_attention(*leaves, block_q=64, block_k=64, **kw)
    o.backward(do)
    ref = attention_bwd_ref(q, k, v, o.detach(), do, **kw)
    for name, t, r in zip(("dq", "dk", "dv"), leaves, ref):
        assert _rel_err(t.grad.numpy(), r.numpy()) <= TOL, name


def test_attention_bwd_ref_masked_rows_give_zero():
    """Rows that see no key (a window behind q_offset 40 at Sk 64: rows
    39-63) get exactly zero dq and add nothing to dk and dv; every
    gradient stays finite."""
    case = (1, 64, 64, 4, 2, 32, True, 16, 40)
    q, k, v, do = (torch.from_numpy(a) for a in fa_bwd_inputs(case))
    o = torch.randn(q.shape, generator=torch.Generator().manual_seed(0))
    kw = dict(causal=True, window=16, q_offset=40)
    dq, dk, dv = attention_bwd_ref(q, k, v, o, do, **kw)
    assert all(bool(torch.isfinite(g).all()) for g in (dq, dk, dv))
    assert bool((dq[:, 39:] == 0).all()) and bool((dq[:, :39] != 0).any())
    # the masked rows' do and o do not reach dk, dv
    do2, o2 = do.clone(), o.clone()
    do2[:, 39:], o2[:, 39:] = 7.0, -3.0
    _, dk2, dv2 = attention_bwd_ref(q, k, v, o2, do2, **kw)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)


@pytest.mark.parametrize("case", FA_BWD_CASES[:3])
def test_flash_attention_xla_gradients_match_naive(case):
    """Port of tests/test_kernels.py::test_flash_attention_xla_gradients_match_naive:
    torch autograd of sum(o^2) through the chunked path (64-row and 64-key
    chunks) against autograd of the plain oracle, at that test's
    tolerance (2e-4)."""
    from repro_torch.kernels.flash_attention.ops import flash_attention_xla
    from repro_torch.kernels.flash_attention.ref import attention_ref

    q, k, v, _ = fa_bwd_inputs(case)
    _, _, _, _, _, _, causal, window, q_offset = case
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    grads = []
    for fn in (lambda *a: flash_attention_xla(*a, block_q=64, block_k=64, **kw),
               lambda *a: attention_ref(*a, **kw)):
        leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        fn(*leaves).square().sum().backward()
        grads.append([t.grad for t in leaves])
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-4, rtol=2e-4)


def wgmma_bwd_emulation(q, k, v, o, do, *, causal, window, q_offset,
                        scale=None):
    """(dq, dk, dv) with the rounding points of the tensor-core backward,
    ``src/repro_torch/csrc/flash_attention_bwd_wgmma.cu``, in fp32 torch,
    at every head dim (at D 320 the dK/dV kernel splits its work over two
    warpgroups, :540-601, at the same rounding points):

      * q, k, v, o, do are bf16; S = q k^T and dP = dO V^T accumulate in
        fp32 (``wgmma_ss``, :322-326 in the dK/dV kernel, :540 at D 320,
        :733-737 in dQ);
      * lse is the forward's fp32 log-sum-exp of the scaled, masked logits
        (``flash_attention_wgmma.cu``:246-252), read in log2 units
        (:272, :488, :706); delta = rowsum(dO o O) in fp32 (:184-216);
      * P = exp2(S scale log2(e) - lse log2(e)), 0 where masked (:347-354,
        :563-568, :755-760); dS = P (dP - delta) from the fp32 P (:356,
        :583-585, :762), at D 320 from the fp32 P that warpgroup V hands
        to warpgroup K through shared memory (:570, :581);
      * P and dS rounded to bf16 (:355-356, :571-572, :583-585, :762)
        before dV += P^T dO, dK += dS^T Q and dQ += dS K, which accumulate
        in fp32 (:373-380, :598-601, :772-774), dK and dV over the G heads
        of a K/V head;
      * dK and dQ scaled in fp32, then each gradient rounded once to bf16
        (:405-407, :620-625, :793).
    """
    def bf16(t):
        return t.to(torch.bfloat16).float()

    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    G = Hq // Hkv
    if scale is None:
        scale = D ** -0.5
    if q_offset is None:
        q_offset = Sk - Sq
    qf, kf, vf, of, dof = (bf16(t) for t in (q, k, v, o, do))
    kf, vf = (t.repeat_interleave(G, dim=2) for t in (kf, vf))
    qpos = torch.arange(Sq)[:, None] + q_offset
    kpos = torch.arange(Sk)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
    lse = torch.where(mask, s * scale, torch.full_like(s, -torch.inf)).logsumexp(-1)
    log2e = 1.0 / np.log(2.0)
    p = torch.where(mask, torch.exp2(s * (scale * log2e) - (lse * log2e)[..., None]),
                    torch.zeros_like(s))
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    delta = (dof * of).sum(-1).transpose(1, 2)[..., None]
    ds = bf16(p * (dp - delta))
    p = bf16(p)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof).reshape(B, Sk, Hkv, G, D).sum(3)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf).reshape(B, Sk, Hkv, G, D).sum(3)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    return bf16(dq * scale), bf16(dk * scale), bf16(dv)


WGMMA_BWD_TOL = 2e-2   # the bf16 kernel tolerance, of max |grad|


@pytest.mark.parametrize("case", FA_BWD_CASES)
def test_wgmma_bwd_emulation_matches_jax_vjp(case):
    """The tensor-core backward's arithmetic (``wgmma_bwd_emulation``)
    against ``jax.vjp`` of the JAX package's chunked path on the same
    bf16-rounded inputs (fp32 inside): within 2e-2 of each gradient's
    largest |value|, over ``FA_BWD_CASES``, every head dim of which that
    route takes (D 32, 64, 128 and 320)."""
    def bf16(a):
        return torch.from_numpy(a).to(torch.bfloat16).float().numpy()

    q, k, v, do = (bf16(a) for a in fa_bwd_inputs(case))
    o, jgrads = _jax_vjp(case, q, k, v, do)
    _, _, _, _, _, _, causal, window, q_offset = case
    ours = wgmma_bwd_emulation(*(torch.from_numpy(a) for a in (q, k, v, o, do)),
                               causal=causal, window=window, q_offset=q_offset)
    for name, g, j in zip(("dq", "dk", "dv"), ours, jgrads):
        assert g.shape == j.shape, name
        assert _rel_err(g.numpy(), j) <= WGMMA_BWD_TOL, name
