"""The gla_scan wrapper's route rule, and the arithmetic of its tensor-core
route, on the CPU.

bf16 calls with K = V = 64, ``C = min(chunk, S)`` a multiple of 16 and
16-byte aligned q/k/v whose B/H/S strides are multiples of 8 elements take
the tensor-core kernel (``mma``); every other call the CUDA-core kernel
(``simt``); a call neither takes raises before a kernel library is built or
loaded.  The backward has the same two routes by ``bwd_route``, which also
asks that dO be aligned as q, k and v are, and a call autograd records goes
through ``GlaScanFn``.
The kernels themselves are held against ``gla_scan_xla`` on a card
by ``test_torch_kernels_gpu.py``.  Here a torch emulation of the mma
kernel's roundings (bf16 hi/lo splits of every fp32-derived operand, fp32
accumulation) is held against ``gla_scan_xla`` within a quarter of the
tolerances the card is held to, and rounding the state update's key
operand once to bf16 is shown to break the state's.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.ssm_scan import kernel as K
from repro_torch.kernels.ssm_scan.ops import gla_scan_xla

# The card's tolerances (tests/test_torch_kernels_gpu.py): atol = rtol on
# the bf16 output and on the fp32 final state.
TOL_O, TOL_STATE = 8e-2, 1e-3


def _qkvw(B=1, H=2, S=256, Kd=64, V=64, dtype=torch.bfloat16, decay="rwkv6",
          seed=0):
    rng = np.random.default_rng(seed)
    q, k = (torch.from_numpy(rng.standard_normal((B, H, S, Kd), np.float32) * 0.5)
            for _ in range(2))
    v = torch.from_numpy(rng.standard_normal((B, H, S, V), np.float32))
    if decay == "strong":
        w = torch.full((B, H, S, Kd), -2.5)
    elif decay == "mamba2":
        w = torch.from_numpy(-0.05 * np.exp(rng.standard_normal(
            (B, H, S, 1), np.float32))).expand(B, H, S, Kd)
    else:
        w = torch.from_numpy(-0.05 * np.exp(rng.standard_normal(
            (B, H, S, Kd), np.float32)))
    return q.to(dtype), k.to(dtype), v.to(dtype), w


def _transposed(B=2, H=3, S=300):
    """q/k/v as head-transposed views of (B, S, H, 64) buffers and Mamba2's
    stride-0 w, as the models pass them."""
    q, k, v = (torch.zeros(B, S, H, 64, dtype=torch.bfloat16).transpose(1, 2)
               for _ in range(3))
    w = torch.zeros(B, S, H).transpose(1, 2)[..., None].expand(B, H, S, 64)
    return q, k, v, w


def _misaligned():
    """bf16 views that start 2 bytes into their buffer."""
    q, k, v = (torch.zeros(1, 2, 64, 72, dtype=torch.bfloat16)[..., 1:65]
               for _ in range(3))
    return q, k, v, torch.zeros(1, 2, 64, 64)


def _odd_stride():
    """Aligned bf16 views whose S stride (68) is not a multiple of 8."""
    q, k, v = (torch.zeros(1, 2, 64, 68, dtype=torch.bfloat16)[..., :64]
               for _ in range(3))
    return q, k, v, torch.zeros(1, 2, 64, 64)


@pytest.mark.parametrize("make,chunk,want", [
    (lambda: _qkvw(S=256), 32, "mma"),
    (lambda: _qkvw(S=256), 64, "mma"),
    (lambda: _qkvw(S=256), 128, "mma"),
    (lambda: _qkvw(S=200), 128, "mma"),                  # ragged S
    (lambda: _qkvw(S=48), 128, "mma"),                   # C = S = 48
    (lambda: _qkvw(decay="mamba2"), 128, "mma"),         # stride-0 w
    (_transposed, 128, "mma"),
    (lambda: _qkvw(dtype=torch.float32), 128, "simt"),
    (lambda: _qkvw(Kd=32), 128, "simt"),
    (lambda: _qkvw(V=128), 128, "simt"),
    (lambda: _qkvw(S=256), 37, "simt"),                  # C = 37
    (lambda: _qkvw(S=40), 128, "simt"),                  # C = S = 40
    (_misaligned, 64, "simt"),
    (_odd_stride, 64, "simt"),
])
def test_route_rule(make, chunk, want):
    assert K.route(*make(), chunk) == want


@pytest.mark.parametrize("make,chunk,error", [
    (lambda: _qkvw(dtype=torch.float16), 128, TypeError),
    (lambda: _qkvw(dtype=torch.float64), 128, TypeError),
    (lambda: _qkvw(Kd=48), 128, ValueError),
    (lambda: _qkvw(), 0, ValueError),
    (lambda: _qkvw(), 129, ValueError),
    (lambda: _qkvw()[:3] + (torch.zeros(1, 2, 256, 64, dtype=torch.bfloat16),),
     128, TypeError),                                    # w not fp32
    (lambda: tuple(t.transpose(2, 3) for t in _qkvw(S=64)), 64, ValueError),
    (lambda: _qkvw(), 128, ValueError),                  # supported, but on the CPU
])
def test_unsupported_call_raises_before_any_library(make, chunk, error,
                                                    monkeypatch):
    def no_build(*args, **kwargs):
        raise AssertionError("a kernel library was requested")

    monkeypatch.setattr(_build, "function", no_build)
    monkeypatch.setattr(_build, "build", no_build)
    libs = dict(_build._libs)
    launches = (K.gla_scan_cuda.launches, dict(K.gla_scan_cuda.launches_by_route))
    with pytest.raises(error, match="gla_scan_cuda"):
        K.gla_scan_cuda(*make(), chunk)
    assert _build._libs == libs
    assert (K.gla_scan_cuda.launches, K.gla_scan_cuda.launches_by_route) == launches


def test_route_counters_cover_every_route():
    assert set(K.gla_scan_cuda.launches_by_route) == set(K._LIBS)
    assert set(K.gla_scan_bwd_cuda.launches_by_route) == set(K._BWD_LIBS)


# ---------------------------------------------------------------------------
# The mma route's arithmetic, emulated in torch.
# ---------------------------------------------------------------------------


def _split(x):
    """hi = bf16(x), lo = bf16(x - hi), as the kernel's split2 (in fp32,
    src/repro_torch/csrc/mma_sync.cuh:63)."""
    hi = x.bfloat16().float()
    return hi, (x - hi).bfloat16().float()


def mma_emulation(q, k, v, w, chunk=128, split_keys=True):
    """gla_scan_xla with the mma kernel's roundings: q~, k~, the scores and
    S each split hi/lo; q~ k~ᵀ and q~ S as hi hi + hi lo + lo hi, P v and
    k~ᵀ v as hi + lo against the exact bf16 v; fp32 accumulation; the state
    update as e^{a_last} (S + k~ᵀ v).  ``split_keys=False`` rounds the state
    update's key operand k~ once to bf16 instead.

    This is a hand copy of the kernel's arithmetic and shares no code with
    it: a change to which operands src/repro_torch/csrc/gla_scan_mma.cu
    splits is made here too.  Each line follows these lines of that file:

    * clamp of w: :206-207;
    * q~ and k~ split hi/lo (with the min(-a, 60) guard): :238 and :241;
    * the scores q~ k~ᵀ, hi hi + (hi lo + lo hi): :302-306 and :312;
    * the causal mask, a select: :319;
    * the scores split hi/lo: :324-327;
    * q~ S, hi hi + hi lo + lo hi: :280-282, from S's hi/lo tiles
      written at :385-388;
    * P v, hi then lo against v: :333 and :335;
    * k~ᵀ v, hi then lo: :365-366, scaled by e^{a_last} at :373-376.
    """
    B, H, S, Kd = q.shape
    C = min(chunk, S)
    pad = (-S) % C
    if pad:
        q, k, v, w = (F.pad(x, (0, 0, 0, pad)) for x in (q, k, v, w))
    n = (S + pad) // C
    qf, kf, vf = (x.float().reshape(B, H, n, C, -1) for x in (q, k, v))
    wf = w.float().clamp(-30.0, 0.0).reshape(B, H, n, C, Kd)
    state = torch.zeros(B, H, Kd, v.shape[-1])
    causal = torch.ones(C, C, dtype=torch.bool).tril()
    outs = []
    for c in range(n):
        a = wf[:, :, c].cumsum(2)
        qh, ql = _split(qf[:, :, c] * a.exp())
        kh, kl = _split(kf[:, :, c] * (-a).clamp(max=60.0).exp())
        vc = vf[:, :, c]
        s = qh @ kh.mT + (qh @ kl.mT + ql @ kh.mT)
        sh, sl = _split(torch.where(causal, s, 0.0))
        Sh, Sl = _split(state)
        outs.append(qh @ Sh + qh @ Sl + ql @ Sh + sh @ vc + sl @ vc)
        upd = kh.mT @ vc + kl.mT @ vc if split_keys else kh.mT @ vc
        state = a[:, :, -1, :, None].exp() * (state + upd)
    return torch.cat(outs, dim=2)[:, :, :S].to(q.dtype), state


def _use(got, ref, tol):
    """Largest |got - ref| / (tol + tol |ref|): 1.0 uses up allclose."""
    return ((got.float() - ref.float()).abs()
            / (tol + tol * ref.float().abs())).max().item()


@pytest.mark.parametrize("decay", ["rwkv6", "mamba2", "strong"])
def test_mma_arithmetic_within_a_quarter_of_each_tolerance(decay):
    q, k, v, w = _qkvw(B=1, H=4, S=256, decay=decay, seed=3)
    o, state = mma_emulation(q, k, v, w, 128)
    ro, rs = gla_scan_xla(q, k, v, w, 128)
    assert o.dtype == ro.dtype and torch.isfinite(o.float()).all()
    assert _use(o, ro, TOL_O) < 0.25
    assert _use(state, rs, TOL_STATE) < 0.25


@pytest.mark.parametrize("decay", ["rwkv6", "mamba2"])
def test_unsplit_keys_put_the_state_outside_its_tolerance(decay):
    """Rounding k~ once to bf16 in the state update costs its ~2^-9
    relative error on every term, against a state tolerance of 1e-3: the
    reason the kernel splits it."""
    q, k, v, w = _qkvw(B=1, H=4, S=256, decay=decay, seed=3)
    _, rs = gla_scan_xla(q, k, v, w, 128)
    _, split = mma_emulation(q, k, v, w, 128)
    _, unsplit = mma_emulation(q, k, v, w, 128, split_keys=False)
    assert torch.allclose(split, rs, atol=TOL_STATE, rtol=TOL_STATE)
    assert not torch.allclose(unsplit, rs, atol=TOL_STATE, rtol=TOL_STATE)


def test_autograd_guard_raises_before_the_device_check(monkeypatch):
    """The kernels have a backward now: a call that autograd records (q, k,
    v or w requiring grad) goes through ``GlaScanFn`` and meets the
    forward's device check there, and under no_grad or inference_mode the
    same call meets it directly.  No library is built or loaded either
    way."""
    def no_build(*args, **kwargs):
        raise AssertionError("a kernel library was requested")

    monkeypatch.setattr(_build, "function", no_build)
    monkeypatch.setattr(_build, "build", no_build)
    entered = []
    real = K.GlaScanFn.forward

    def forward(ctx, *args):
        entered.append(1)
        return real(ctx, *args)

    monkeypatch.setattr(K.GlaScanFn, "forward", staticmethod(forward))
    for i in range(4):
        args = list(_qkvw(S=64))
        args[i] = args[i].clone().requires_grad_()
        entered.clear()
        with pytest.raises(ValueError, match="CUDA device"):
            K.gla_scan_cuda(*args, 64)
        assert entered == [1]
        for context in (torch.no_grad, torch.inference_mode):
            entered.clear()
            with context(), pytest.raises(ValueError, match="CUDA device"):
                K.gla_scan_cuda(*args, 64)
            assert entered == []


# ---------------------------------------------------------------------------
# The backward's route rule.
# ---------------------------------------------------------------------------


def _with_do(make, do_make=None):
    """q, k, v, w from ``make`` and an output gradient: a zero (B, H, S, V)
    tensor in v's dtype, or ``do_make(v)``."""
    def call():
        q, k, v, w = make()
        do = (torch.zeros(v.shape, dtype=v.dtype) if do_make is None
              else do_make(v))
        return q, k, v, w, do
    return call


def _misaligned_do(v):
    """A view of v's shape that starts 2 bytes into its buffer."""
    B, H, S, V = v.shape
    return torch.zeros(B, H, S, V + 8, dtype=v.dtype)[..., 1:V + 1]


def _odd_stride_do(v):
    """An aligned view of v's shape whose S stride (V + 4) is not a
    multiple of 8."""
    B, H, S, V = v.shape
    return torch.zeros(B, H, S, V + 4, dtype=v.dtype)[..., :V]


def _transposed_do(v):
    B, H, S, V = v.shape
    return torch.zeros(B, S, H, V, dtype=v.dtype).transpose(1, 2)


@pytest.mark.parametrize("make,chunk,want", [
    (_with_do(lambda: _qkvw(S=256)), 128, "mma"),        # RWKV6 and Mamba2 at full width
    (_with_do(lambda: _qkvw(S=256)), 32, "mma"),
    (_with_do(lambda: _qkvw(S=200)), 128, "mma"),        # ragged S
    (_with_do(lambda: _qkvw(S=48)), 128, "mma"),         # C = S = 48
    (_with_do(lambda: _qkvw(decay="mamba2")), 128, "mma"),   # stride-0 w
    (_with_do(_transposed, _transposed_do), 128, "mma"),
    (_with_do(lambda: _qkvw(S=256)), 37, "simt"),        # C = 37
    (_with_do(lambda: _qkvw(S=40)), 128, "simt"),        # C = S = 40
    (_with_do(lambda: _qkvw(Kd=32, V=32, dtype=torch.float32)), 128, "simt"),
    (_with_do(lambda: _qkvw(Kd=16, V=128, dtype=torch.float32)), 1, "simt"),
    (_with_do(lambda: _qkvw(Kd=128, V=16)), 128, "simt"),
    (_with_do(lambda: _qkvw(Kd=32)), 128, "simt"),
    (_with_do(_misaligned), 64, "simt"),
    (_with_do(_odd_stride), 64, "simt"),
    (_with_do(lambda: _qkvw(S=64), _misaligned_do), 64, "simt"),
    (_with_do(lambda: _qkvw(S=64), _odd_stride_do), 64, "simt"),
])
def test_bwd_route_rule(make, chunk, want):
    """bf16 calls with K = V = 64, C a multiple of 16, and q, k, v and dO
    16-byte aligned with B/H/S strides that are multiples of 8 take the
    tensor-core kernel; every other call the backward takes, the CUDA-core
    kernel.  (``gla_scan_bwd_cuda`` copies a dO that alone keeps a call
    off ``mma``; ``bwd_route`` judges the dO it is given.)"""
    assert K.bwd_route(*make(), chunk) == want


@pytest.mark.parametrize("dtype,Kd,V,chunk,error", [
    (torch.float16, 64, 64, 128, TypeError),
    (torch.float64, 64, 64, 128, TypeError),
    (torch.bfloat16, 48, 64, 128, ValueError),
    (torch.bfloat16, 64, 256, 128, ValueError),
    (torch.bfloat16, 64, 64, 0, ValueError),
    (torch.bfloat16, 64, 64, 129, ValueError),
])
def test_bwd_unsupported_call_raises_before_any_library(dtype, Kd, V, chunk, error,
                                                        monkeypatch):
    def no_build(*args, **kwargs):
        raise AssertionError("a kernel library was requested")

    monkeypatch.setattr(_build, "function", no_build)
    monkeypatch.setattr(_build, "build", no_build)
    q, k, v, w = _qkvw(S=64, Kd=Kd, V=V, dtype=dtype)
    with pytest.raises(error, match="gla_scan_bwd_cuda"):
        K.bwd_route(q, k, v, w, torch.zeros_like(v), chunk)
    launches = K.gla_scan_bwd_cuda.launches
    with pytest.raises(error, match="gla_scan_bwd_cuda"):
        K.gla_scan_bwd_cuda(q, k, v, w, torch.zeros_like(v), None, chunk)
    assert K.gla_scan_bwd_cuda.launches == launches


def test_bwd_call_on_the_cpu_raises_before_any_library(monkeypatch):
    """A call the backward takes, with CPU tensors, meets the device check
    before a library is built or loaded."""
    def no_build(*args, **kwargs):
        raise AssertionError("a kernel library was requested")

    monkeypatch.setattr(_build, "function", no_build)
    monkeypatch.setattr(_build, "build", no_build)
    q, k, v, w = _qkvw(S=64)
    with pytest.raises(ValueError, match="CUDA device"):
        K.gla_scan_bwd_cuda(q, k, v, w, torch.zeros_like(v), None, 64)
    assert set(K.gla_scan_bwd_cuda.launches_by_route) == {"mma", "simt"}
