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

The tensor-core kernel (``csrc/gla_scan_bwd_mma.cu``) cannot run here: a
torch emulation of its roundings, ``mma_bwd_emulation``, is held to
``jax.vjp`` within a quarter of the bf16 tolerance, and dw (fp32) within
the fp32 one; dropping a lo part of its splits is shown to break the
latter.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _torch_cases import GLA_CASES, gla_exact_bound_inputs, gla_inputs
from repro.kernels.ssm_scan.ops import gla_scan_xla as jax_gla_xla
from repro_torch.kernels.ssm_scan.ops import gla_scan_xla
from repro_torch.kernels.ssm_scan.ref import CLAMP, GUARD, _tie_mask, gla_scan_bwd_ref

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


# ---------------------------------------------------------------------------
# The mma route's arithmetic, emulated in torch.
# ---------------------------------------------------------------------------

# Operands whose lo part ``mma_bwd_emulation(drop=...)`` can drop.
SPLITS = ("q~", "k~", "P", "dP", "S_c", "G", "k~ in S", "q~ in dS")


def _split(x, keep=True):
    """hi = bf16(x), lo = bf16(x - hi), as the kernel's split2 (in fp32,
    src/repro_torch/csrc/mma_sync.cuh:63); lo is zero unless ``keep``."""
    hi = x.bfloat16().float()
    return hi, (x - hi).bfloat16().float() if keep else torch.zeros_like(x)


def mma_bwd_emulation(q, k, v, w, do, d_final=None, chunk=128, drop=()):
    """gla_scan_bwd_ref with the mma kernel's roundings: q~, k~, P, dP, S_c
    and G = e dS each split hi/lo; a product of two split operands as hi hi
    + hi lo + lo hi, one with a bf16 input as hi + lo; fp32 accumulation;
    the last row's term of da as sum_v dS S_{c+1}; dq, dk, dv rounded to
    bf16.  ``drop`` names operands of ``SPLITS`` whose lo part is dropped.
    Its exponentials are torch's; the kernel's (``fast_exp``, ex2 on the
    special-function unit) differ by about 2^-18 of relative error.

    This is a hand copy of the kernel's arithmetic and shares no code with
    it: a change to which operands src/repro_torch/csrc/gla_scan_bwd_mma.cu
    splits is made here too.  Each line follows these lines of that file:

    * clip of w: :229; a and e^{a_last}: the tile scans, :274;
    * q~ and k~ split hi/lo (with the min(-a, 60) guard): :290-293;
    * S_{c+1} = e (S_c + k~ᵀ v), k~ hi then lo: :444-445, :452;
    * dS_c = e dS_{c+1} + q~ᵀ dO, q~ hi then lo: :424, :444-445;
    * G = e dS and S_c split hi/lo: :810 and :812 through :329;
    * Pᵀ = k~ q~ᵀ, hi hi + hi lo + lo hi: :560-562; dPᵀ = v dOᵀ: :563;
    * the causal mask, a select: :572-573 (Pᵀ, dPᵀ) and :676 (dP);
    * Pᵀ and dPᵀ split hi/lo: :580-583;
    * dv = Pᵀ dO (hi, lo) + k~ G (three): :596-597 and :536-538;
    * dk~ = dPᵀ q~ (three) + v Gᵀ (hi, lo): :598-600 and :528-529;
    * dP = dO vᵀ split hi/lo: :669 and :681-682;
    * dq~ = dP k~ (three) + dO S_cᵀ (hi, lo): :693-695 and :654-655;
    * dq, dk: :713 and :620; da = dq~ (q~ hi + lo) - dk~ (k~ hi + lo)
      [guard]: :707-709 and :612-615;
    * dw: the reverse cumsum (:715, :731) plus sum_v dS S_{c+1} (:840),
      times [clip]: :739-740.
    """
    B, H, S, K = q.shape
    V = v.shape[-1]
    C = min(chunk, S)
    pad = (-S) % C
    n = (S + pad) // C

    def chunks(x):
        return F.pad(x.float(), (0, 0, 0, pad)).reshape(B, H, n, C, -1)

    qf, kf, vf, dof, wr = (chunks(x) for x in (q, k, v, do, w))
    a = wr.clamp(-CLAMP, 0.0).cumsum(3)
    ea, eg = a.exp(), (-a).clamp(max=GUARD).exp()
    e = ea[:, :, :, -1, :, None]                                  # (B,H,n,K,1)
    qh, ql = _split(qf * ea, "q~" not in drop)
    kh, kl = _split(kf * eg, "k~" not in drop)
    states = [torch.zeros(B, H, K, V)]
    for c in range(n):
        kl_s = kl[:, :, c] if "k~ in S" not in drop else torch.zeros_like(kl[:, :, c])
        states.append(e[:, :, c] * (states[-1] + (kh[:, :, c].mT @ vf[:, :, c]
                                                  + kl_s.mT @ vf[:, :, c])))
    dS = [None] * n
    g = torch.zeros(B, H, K, V) if d_final is None else d_final.float()
    for c in reversed(range(n)):
        dS[c] = g
        ql_s = ql[:, :, c] if "q~ in dS" not in drop else torch.zeros_like(ql[:, :, c])
        g = e[:, :, c] * g + (qh[:, :, c].mT @ dof[:, :, c] + ql_s.mT @ dof[:, :, c])
    causal = torch.ones(C, C, dtype=torch.bool).tril()
    dq, dk, dv, dw = [], [], [], []
    for c in range(n):
        Qh, Ql, Kh, Kl = qh[:, :, c], ql[:, :, c], kh[:, :, c], kl[:, :, c]
        vc, doc = vf[:, :, c], dof[:, :, c]
        Sh, Sl = _split(states[c], "S_c" not in drop)
        Gh, Gl = _split(e[:, :, c] * dS[c], "G" not in drop)
        Pt = torch.where(causal.mT, Kh @ Qh.mT + Kh @ Ql.mT + Kl @ Qh.mT, 0.0)
        Pth, Ptl = _split(Pt, "P" not in drop)
        dPth, dPtl = _split(torch.where(causal.mT, vc @ doc.mT, 0.0), "dP" not in drop)
        dPh, dPl = _split(torch.where(causal, doc @ vc.mT, 0.0), "dP" not in drop)
        dv.append((Pth @ doc + Ptl @ doc) + (Kh @ Gh + Kh @ Gl + Kl @ Gh))
        dkt = (dPth @ Qh + dPth @ Ql + dPtl @ Qh) + (vc @ Gh.mT + vc @ Gl.mT)
        dqt = (dPh @ Kh + dPh @ Kl + dPl @ Kh) + (doc @ Sh.mT + doc @ Sl.mT)
        da = dqt * (Qh + Ql) - dkt * (Kh + Kl) * _tie_mask(-a[:, :, c], -torch.inf, GUARD)
        last = (dS[c] * states[c + 1]).sum(-1)[:, :, None]
        dw.append((da.flip(2).cumsum(2).flip(2) + last)
                  * _tie_mask(wr[:, :, c], -CLAMP, 0.0))
        dq.append(dqt * ea[:, :, c])
        dk.append(dkt * eg[:, :, c])

    def whole(parts, dtype):
        return torch.cat(parts, dim=2)[:, :, :S].to(dtype)

    return (whole(dq, q.dtype), whole(dk, k.dtype), whole(dv, v.dtype),
            whole(dw, torch.float32))


def _mma_case(decay, S=256, seed=3):
    """bf16 q, k, v, dO at RWKV6's and Mamba2's head width (B 1, H 2, K = V
    = 64), w fp32 (stride 0 over K for "mamba2"), from numpy."""
    B, H, Kd = 1, 2, 64
    q, k, v, w = gla_inputs((B, H, S, Kd, Kd, 128), seed=seed)
    if decay == "mamba2":
        w = np.broadcast_to(w[..., :1], w.shape)
    elif decay == "strong":
        w = np.full(q.shape, -2.5, np.float32)
    do, d_final = _cotangents((B, H, S, Kd, Kd, 128), seed=seed + 1)
    bf = [torch.from_numpy(np.ascontiguousarray(x)).bfloat16() for x in (q, k, v, do)]
    tw = torch.from_numpy(w[..., :1].copy()).expand(w.shape) if decay == "mamba2" \
        else torch.from_numpy(np.ascontiguousarray(w))
    return bf, tw, torch.from_numpy(d_final)


def _jax_at(bf, w, d_final):
    """jax.vjp of gla_scan_xla in fp32 at the bf16 inputs' values: the
    gradient at the kernel's inputs, rounded nowhere."""
    q, k, v, do = (t.float().numpy() for t in bf)
    return _jax_grads((q, k, v, np.asarray(w)), do, d_final.numpy(), 128)


def _errs(got, ref):
    return [np.abs(g.float().numpy() - np.asarray(r)).max() / np.abs(np.asarray(r)).max()
            for g, r in zip(got, ref)]


# dq, dk and dv are bf16: one rounding costs at most 2^-8 of the largest
# |gradient| (3.9e-3), inside a quarter of the card's 2e-2.  dw is fp32, and
# the splits keep about 16 bits of every operand, so it is held to the fp32
# tolerance of the backward, 1e-4 of its largest |value|.
TOL_EMU = {"dq": TOL["bfloat16"] / 4, "dk": TOL["bfloat16"] / 4,
           "dv": TOL["bfloat16"] / 4, "dw": 1e-4}


@pytest.mark.parametrize("with_final", [True, False], ids=["dS_n", "no dS_n"])
@pytest.mark.parametrize("decay,S", [("rwkv6", 256), ("mamba2", 256), ("strong", 256),
                                     ("rwkv6", 200)],
                         ids=["rwkv6", "mamba2 stride-0 w", "strong w -2.5", "ragged S 200"])
def test_mma_bwd_emulation_matches_jax_vjp(decay, S, with_final):
    bf, w, d_final = _mma_case(decay, S)
    if not with_final:
        d_final = torch.zeros_like(d_final)
    got = mma_bwd_emulation(*bf[:3], w, bf[3], d_final if with_final else None, 128)
    assert [g.dtype for g in got] == [torch.bfloat16] * 3 + [torch.float32]
    assert all(bool(torch.isfinite(g.float()).all()) for g in got)
    for name, err in zip(TOL_EMU, _errs(got, _jax_at(bf, w, d_final))):
        assert err <= TOL_EMU[name], f"{name}: {err:.3e} of max |grad|"


@pytest.mark.parametrize("part", [p for p in SPLITS if p != "P"])
def test_dropping_a_lo_part_puts_dw_outside_its_tolerance(part):
    """Each split but P's feeds dw: rounding that operand once to bf16
    costs dw its ~2^-9 relative error, about 2e-3 of its largest |value|,
    against the 1e-4 the kept splits hold (P feeds only dv, whose bf16
    rounding hides it).  No single dropped part takes dq, dk or dv past the
    card's 2e-2: their tolerance cannot see the splits, dw's can."""
    bf, w, d_final = _mma_case("rwkv6")
    ref = _jax_at(bf, w, d_final)
    kept = _errs(mma_bwd_emulation(*bf[:3], w, bf[3], d_final, 128), ref)
    dropped = _errs(mma_bwd_emulation(*bf[:3], w, bf[3], d_final, 128, drop=(part,)), ref)
    assert kept[3] <= TOL_EMU["dw"] < dropped[3]
    assert max(dropped[:3]) <= TOL["bfloat16"]
