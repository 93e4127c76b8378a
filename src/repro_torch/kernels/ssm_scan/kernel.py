"""Hand-written CUDA chunked gated-linear-attention scan: two routes by a
rule of dtype, shape and alignment.

Replaces ``gla_scan_pallas`` (src/repro/kernels/ssm_scan/kernel.py).  One
block per (batch * head) walks the chunks of its sequence in order and
carries the K x V state, as the Pallas kernel carries it in VMEM across its
sequential chunk axis.  Both routes compute ``gla_scan_xla``'s arithmetic
(clamp of w to [-30, 0], exp(-a) capped at e^60) from a zero state, take
any S (positions past S act as the plain version's zero padding), strided
q/k/v views (the models pass head-transposed ones) and a stride-0 K axis on
w (Mamba2's one decay per head), which they then read once per position:

  * ``mma`` (``csrc/gla_scan_mma.cu``) takes bf16 calls with K = V = 64,
    ``C = min(chunk, S)`` a multiple of 16, 16-byte aligned q/k/v and B/H/S
    strides of q/k/v that are multiples of 8 elements -- what RWKV6 and
    Mamba2 run.  Every product is on the tensor cores (mma.sync m16n8k16),
    with each fp32-derived operand split into bf16 hi and lo parts;
  * ``simt`` (``csrc/gla_scan.cu``) takes every other call: fp32 products
    on CUDA cores, K and V in {16, 32, 64, 128} (V tiles of at most 64).

A route is never chosen because a build or a launch failed; a call that
neither kernel takes raises before a library is built or loaded.  At the
prefill shape the kernels' bound is the bytes they must move; see the
source notes.

The backward (``gla_scan_bwd_cuda``) is the gradient of the chunked form,
what ``ref.gla_scan_bwd_ref`` computes, on two routes by ``bwd_route``:

  * ``mma`` (``csrc/gla_scan_bwd_mma.cu``) takes the calls the forward's
    ``mma`` route takes whose dO is 16-byte aligned with B/H/S strides that
    are multiples of 8 elements (the wrapper copies a dO that is not):
    every product on the tensor cores with the same hi/lo splits; the two
    state recurrences, then one pass per (batch * head, chunk) for dq, dk,
    dv and dw;
  * ``simt`` (``csrc/gla_scan_bwd.cu``) takes every other call: fp32 FMAs
    on CUDA cores, four kernels.

Both recompute the chunk-start states, and the gradients of the states
after each chunk, into two fp32 workspaces of about (B, H, ceil(S / C), K,
V) that the wrapper allocates, and use no atomics, so two calls give the
same bits.  A call that autograd records goes through ``GlaScanFn``, whose
forward is the forward launch on either route and whose backward is the
backward launch; any other call is the forward launch alone (prefill and
its CUDA graphs).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

DIMS = (16, 32, 64, 128)    # the K and V sizes the simt source compiles
MAX_CHUNK = 128
MMA_DIM = 64                # the K = V the mma source compiles
# route -> (library, C entry point, argument types)
_LIBS = {
    "mma": ("gla_scan_mma", "gla_scan_mma_launch",
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
            + [ctypes.c_longlong] * 13 + [ctypes.c_void_p]),
    "simt": ("gla_scan", "gla_scan_launch",
             [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
             + [ctypes.c_longlong] * 16 + [ctypes.c_int, ctypes.c_void_p]),
}
_BWD_LIBS = {
    "mma": ("gla_scan_bwd_mma", "gla_scan_bwd_mma_launch",
            [ctypes.c_void_p] * 12 + [ctypes.c_int] * 4
            + [ctypes.c_longlong] * 16 + [ctypes.c_void_p]),
    "simt": ("gla_scan_bwd", "gla_scan_bwd_launch",
             [ctypes.c_void_p] * 12 + [ctypes.c_int] * 6
             + [ctypes.c_longlong] * 20 + [ctypes.c_int, ctypes.c_void_p]),
}


def _check_kind(name, dtype, K, V, chunk) -> None:
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: dtype {dtype} not in (float32, bfloat16)")
    if K not in DIMS or V not in DIMS:
        raise ValueError(f"{name}: K {K} and V {V} must be in {DIMS}")
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"{name}: chunk {chunk} not in [1, {MAX_CHUNK}]")


def _check_call(name, q, k, v, w, chunk) -> None:
    """The checks both directions make of q, k, v and w; raise TypeError
    or ValueError, naming ``name``, for a call neither kernel takes."""
    _build.refuse_dtensor(name, q, k, v, w)
    K, V = q.shape[-1], v.shape[-1]
    _check_kind(name, q.dtype, K, V, chunk)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: q, k and v must share a dtype")
    if w.dtype != torch.float32:
        raise TypeError(f"{name}: w must be float32, not {w.dtype}")
    if k.shape != q.shape or w.shape != q.shape or v.shape[:3] != q.shape[:3]:
        raise ValueError(f"{name}: bad shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, w {tuple(w.shape)}")
    if any(t.stride(-1) != 1 for t in (q, k, v)) or w.stride(-1) not in (0, 1):
        raise ValueError(f"{name}: the last axis of q, k, v must be "
                         "contiguous and that of w contiguous or broadcast")


def _mma_takes(tensors, K, V, C) -> bool:
    """bf16, K = V = 64, C a multiple of 16, and every tensor 16-byte
    aligned with B/H/S strides that are multiples of 8 elements."""
    return (tensors[0].dtype == torch.bfloat16 and K == V == MMA_DIM
            and C > 0 and C % 16 == 0
            and all(t.data_ptr() % 16 == 0 for t in tensors)
            and all(s % 8 == 0 for t in tensors for s in t.stride()[:3]))


def route(q, k, v, w, chunk: int = 128) -> str:
    """The kernel a call takes, ``"mma"`` or ``"simt"``, from the dtypes,
    K, V, ``C = min(chunk, S)`` and the alignment of q, k and v.  Raises
    TypeError or ValueError for a call that neither kernel takes."""
    _check_call("gla_scan_cuda", q, k, v, w, chunk)
    K, V = q.shape[-1], v.shape[-1]
    return "mma" if _mma_takes((q, k, v), K, V, min(chunk, q.shape[2])) else "simt"


def bwd_route(q, k, v, w, do, chunk: int = 128) -> str:
    """The backward kernel a call takes: ``"mma"`` where the forward's rule
    names it and dO is aligned as q, k and v must be, else ``"simt"``.
    Raises TypeError or ValueError for a call that neither takes."""
    name = "gla_scan_bwd_cuda"
    _check_call(name, q, k, v, w, chunk)
    if do.shape != v.shape or do.dtype != q.dtype or do.stride(-1) != 1:
        raise ValueError(f"{name}: do {tuple(do.shape)} {do.dtype} must have v's "
                         f"shape {tuple(v.shape)}, q's dtype {q.dtype} and a "
                         "contiguous last axis")
    K, V = q.shape[-1], v.shape[-1]
    return "mma" if _mma_takes((q, k, v, do), K, V, min(chunk, q.shape[2])) else "simt"


class GlaScanFn(torch.autograd.Function):
    """The scan with a gradient: the forward launch (either route), saving
    q, k, v and w, and ``gla_scan_bwd_cuda`` as its backward, which takes
    the final state's gradient when one arrives."""

    @staticmethod
    def forward(ctx, q, k, v, w, chunk):
        o, state = gla_scan_fwd_cuda(q, k, v, w, chunk)
        ctx.save_for_backward(q, k, v, w)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return o, state

    @staticmethod
    def backward(ctx, do, d_final):
        q, k, v, w = ctx.saved_tensors
        if do is None:
            do = torch.zeros((*q.shape[:3], v.shape[-1]), dtype=q.dtype, device=q.device)
        dq, dk, dv, dw = gla_scan_bwd_cuda(q, k, v, w, do, d_final, ctx.chunk)
        return dq, dk, dv, dw, None


def gla_scan_cuda(q, k, v, w, chunk: int = 128):
    """q, k, w: (B, H, S, K); v: (B, H, S, V) -> (o (B, H, S, V) in q's
    dtype, final state (B, H, K, V) fp32), on the card, from a zero state.

    A call that autograd records (grad enabled and an input that requires
    it) goes through ``GlaScanFn``; the forward launch is the same."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v, w)):
        return GlaScanFn.apply(q, k, v, w, chunk)
    return gla_scan_fwd_cuda(q, k, v, w, chunk)


def gla_scan_fwd_cuda(q, k, v, w, chunk: int = 128):
    """The forward launch, on the route ``route`` names."""
    kind = route(q, k, v, w, chunk)
    B, H, S, K = q.shape
    V = v.shape[-1]
    if not all(t.is_cuda and t.device == q.device for t in (q, k, v, w)):
        raise ValueError("gla_scan_cuda: q, k, v, w must be on one CUDA device")
    o = torch.empty((B, H, S, V), dtype=q.dtype, device=q.device)
    if o.numel() == 0:
        return o, torch.zeros((B, H, K, V), dtype=torch.float32, device=q.device)
    state = torch.empty((B, H, K, V), dtype=torch.float32, device=q.device)
    lib, symbol, argtypes = _LIBS[kind]
    fn = _build.function(lib, symbol, argtypes)
    ptrs = [t.data_ptr() for t in (q, k, v, w, o, state)]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        if kind == "mma":
            strides = [s for t in (q, k, v) for s in t.stride()[:3]] + list(w.stride())
            code = fn(*ptrs, B, H, S, min(chunk, S), *strides, stream)
        else:
            strides = [s for t in (q, k, v, w) for s in t.stride()]
            code = fn(*ptrs, B, H, S, K, V, min(chunk, S), *strides,
                      int(q.dtype == torch.bfloat16), stream)
    _build.check(lib, code)
    gla_scan_cuda.launches += 1
    gla_scan_cuda.launches_by_route[kind] += 1
    return o, state


gla_scan_cuda.launches = 0
gla_scan_cuda.launches_by_route = {"mma": 0, "simt": 0}


def gla_scan_bwd_cuda(q, k, v, w, do, d_final=None, chunk: int = 128):
    """(dq, dk, dv, dw) of ``gla_scan_cuda(q, k, v, w, chunk)`` on the card:
    dq, dk, dv in the inputs' dtype, dw fp32 in w's shape (for a stride-0
    K axis, one value per element, which autograd's expand sums).

    ``do`` (B, H, S, V) is the output's gradient, in q's dtype, with any
    strides (copied where its last axis is strided, or where it alone keeps
    the call off the ``mma`` route); ``d_final`` (B, H, K, V) the final
    state's, or None for zero.  What ``ref.gla_scan_bwd_ref`` computes.
    Inputs as the forward takes them, on the route ``bwd_route`` names."""
    name = "gla_scan_bwd_cuda"
    B, H, S, K = q.shape
    V = v.shape[-1]
    _check_call(name, q, k, v, w, chunk)
    C = min(chunk, S)
    if do.shape == v.shape and do.dtype == q.dtype and (do.stride(-1) != 1 or (
            _mma_takes((q, k, v), K, V, C) and not _mma_takes((do,), K, V, C))):
        do = do.contiguous()
    kind = bwd_route(q, k, v, w, do, chunk)
    if not all(t.is_cuda and t.device == q.device for t in (q, k, v, w, do)):
        raise ValueError(f"{name}: q, k, v, w, do must be on one CUDA device")
    if d_final is not None and (d_final.shape != (B, H, K, V)
                                or d_final.device != q.device):
        raise ValueError(f"{name}: d_final must be (B, H, K, V) = {(B, H, K, V)} "
                         "on q's device")
    if d_final is not None:
        d_final = d_final.float().contiguous()
    dq = torch.empty((B, H, S, K), dtype=q.dtype, device=q.device)
    dk = torch.empty_like(dq)
    dv = torch.empty((B, H, S, V), dtype=q.dtype, device=q.device)
    dw = torch.empty((B, H, S, K), dtype=torch.float32, device=q.device)
    if dq.numel() == 0 or dv.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_(), dw.zero_()
    n = -(-S // C)
    # mma keeps the final state as well: (n + 1) chunk-start states
    states = torch.empty((B, H, n + (kind == "mma"), K, V), dtype=torch.float32,
                         device=q.device)
    dstates = torch.empty((B, H, n, K, V), dtype=torch.float32, device=q.device)
    lib, symbol, argtypes = _BWD_LIBS[kind]
    fn = _build.function(lib, symbol, argtypes)
    ptrs = [t.data_ptr() for t in (q, k, v, w, do)]
    ptrs += [None if d_final is None else d_final.data_ptr()]
    ptrs += [t.data_ptr() for t in (dq, dk, dv, dw, states, dstates)]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        if kind == "mma":
            strides = [s for t in (q, k, v, do) for s in t.stride()[:3]] + list(w.stride())
            code = fn(*ptrs, B, H, S, C, *strides, stream)
        else:
            strides = [s for t in (q, k, v, w, do) for s in t.stride()]
            code = fn(*ptrs, B, H, S, K, V, C, *strides,
                      int(q.dtype == torch.bfloat16), stream)
    _build.check(lib, code)
    gla_scan_bwd_cuda.launches += 1
    gla_scan_bwd_cuda.launches_by_route[kind] += 1
    return dq, dk, dv, dw


gla_scan_bwd_cuda.launches = 0
gla_scan_bwd_cuda.launches_by_route = {"mma": 0, "simt": 0}
