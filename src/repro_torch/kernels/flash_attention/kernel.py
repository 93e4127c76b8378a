"""Hand-written CUDA flash attention: the forward on two routes by dtype,
and its backward.

Replaces ``flash_attention_pallas`` (src/repro/kernels/flash_attention/
kernel.py).  The route is a rule on the dtype, not a fallback:

  * ``wgmma`` (``csrc/flash_attention_wgmma.cu``) takes every bfloat16 call:
    both products on Hopper's tensor cores (wgmma), K/V tiles brought by
    TMA through a two-stage mbarrier ring, one block per (batch, query
    head, 64-row query tile), P rounded to bf16 before P V;
  * ``simt`` (``csrc/flash_attention.cu``) takes every float32 call: fp32
    FMAs on CUDA cores, so fp32 inputs stay exact (TF32 tensor cores would
    not meet the fp32 tolerance of 2e-5).

Both keep the fp32 online softmax with the finite mask value -1e30, skip
key tiles wholly masked by the causal frontier or the window, and take
ragged ``Sq`` and ``Sk``.  Any other dtype or head dim raises before a
library is built or loaded.  A forward launch sets nothing on the device,
so a CUDA graph can capture it: the wgmma kernel's shared-memory limit is
raised once per device by ``flash_attention_wgmma_setup`` at the first
call.

The backward (``flash_attention_bwd_cuda``) has two routes too, by the
rule ``bwd_route``:

  * ``wgmma`` (``csrc/flash_attention_bwd_wgmma.cu``) takes every bfloat16
    call (D 32, 64, 128 and 320): every product on the tensor cores, a
    dK/dV kernel with the keys as wgmma's rows (at D 320 dK and dV on two
    warpgroups, P^T passed between them in fp32 through shared memory) and
    a dQ kernel, P and dS rounded to bf16, the log-sum-exp of each row from
    the forward;
  * ``simt`` (``csrc/flash_attention_bwd.cu``) takes every float32 call:
    fp32 FMAs on CUDA cores, the softmax statistics recomputed.

Neither uses atomics, so two calls give the same bits.  A call that
autograd records goes through ``FlashAttentionFn``, whose forward is the
forward launch (writing the log-sum-exp on the wgmma route) and whose
backward is the backward launch; any other call is the forward launch alone
(prefill, decode and their CUDA graphs), with no log-sum-exp written.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
HEAD_DIMS = (32, 64, 128, 320)   # the head dims every flash source compiles
# route -> (library, C entry point, argument types)
_LIBS = {"wgmma": ("flash_attention_wgmma", "flash_attention_wgmma_launch",
                   [_P] * 5 + [_I] * 9 + [_F, _P]),
         "simt": ("flash_attention", "flash_attention_launch",
                  [_P] * 4 + [_I] * 9 + [_F, _P])}
_BWD_LIBS = {"wgmma": ("flash_attention_bwd_wgmma", "flash_attention_bwd_wgmma_launch",
                       [_P] * 10 + [_I] * 9 + [_F, _P]),
             "simt": ("flash_attention_bwd", "flash_attention_bwd_launch",
                      [_P] * 10 + [_I] * 10 + [_F, _P])}
# devices whose shared-memory limits are set, by wgmma library
_wgmma_ready: dict[str, set[int]] = {"flash_attention_wgmma": set(),
                                     "flash_attention_bwd_wgmma": set()}


def _check_kind(name: str, dtype: torch.dtype, head_dim: int) -> None:
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {head_dim} not in {HEAD_DIMS}")
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: dtype {dtype} not in (float32, bfloat16)")


def route(dtype: torch.dtype, head_dim: int) -> str:
    """The forward kernel a call takes: ``"wgmma"`` for bfloat16,
    ``"simt"`` for float32.  Raises TypeError for another dtype and
    ValueError for a head dim outside ``HEAD_DIMS``."""
    _check_kind("flash_attention_cuda", dtype, head_dim)
    return "wgmma" if dtype == torch.bfloat16 else "simt"


def bwd_route(dtype: torch.dtype, head_dim: int) -> str:
    """The backward kernel a call takes: ``"wgmma"`` for bfloat16 (at every
    head dim of ``HEAD_DIMS``, D 320 included), ``"simt"`` for float32.
    Raises as ``route`` does."""
    _check_kind("flash_attention_bwd_cuda", dtype, head_dim)
    return "wgmma" if dtype == torch.bfloat16 else "simt"


def _setup_once(lib: str, device: torch.device) -> None:
    """Run the wgmma library's ``<lib>_setup`` (its shared-memory limits)
    once per device, before its first launch there."""
    if device.index not in _wgmma_ready[lib]:
        _build.check(lib, _build.function(lib, f"{lib}_setup", [])())
        _wgmma_ready[lib].add(device.index)


def _check(name, q, k, v, window, rule) -> str:
    """The route of a call by ``rule``; raises on what the kernels do not
    take."""
    _build.refuse_dtensor(name, q, k, v)
    B, Sq, Hq, D = q.shape
    Bk, Sk, Hkv, Dk = k.shape
    kind = rule(q.dtype, D)
    if not all(t.is_cuda and t.device == q.device for t in (q, k, v)):
        raise ValueError(f"{name}: q, k, v must be on one CUDA device")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: q, k and v must share a dtype")
    if v.shape != k.shape or Bk != B or Dk != D or Hq % Hkv:
        raise ValueError(f"{name}: bad shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if window is not None and window < 1:
        raise ValueError(f"{name}: window {window} < 1")
    return kind


class FlashAttentionFn(torch.autograd.Function):
    """Flash attention with a gradient: the forward launch, saving q, k, v,
    the output and (on the tensor-core backward's route) each row's
    log-sum-exp, and ``flash_attention_bwd_cuda`` as its backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, scale):
        with_lse = q.dtype == torch.bfloat16   # bwd_route's wgmma calls
        out, lse = flash_attention_fwd_cuda(q, k, v, causal=causal, window=window,
                                            q_offset=q_offset, scale=scale,
                                            with_lse=with_lse)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = dict(causal=causal, window=window, q_offset=q_offset,
                      scale=scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_cuda(q, k, v, out, dout, lse=lse, **ctx.kw)
        return dq, dk, dv, None, None, None, None


def flash_attention_cuda(q, k, v, *, causal: bool = True,
                         window: int | None = None,
                         q_offset: int | None = None,
                         scale: float | None = None):
    """q: (B, Sq, Hq, D); k/v: (B, Sk, Hkv, D) -> (B, Sq, Hq, D), on the card.

    A call that autograd records (grad enabled and an input that requires
    it) goes through ``FlashAttentionFn``; the forward launch is the same.
    """
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttentionFn.apply(q, k, v, causal, window, q_offset, scale)
    return flash_attention_fwd_cuda(q, k, v, causal=causal, window=window,
                                    q_offset=q_offset, scale=scale)[0]


def flash_attention_fwd_cuda(q, k, v, *, causal: bool = True,
                             window: int | None = None,
                             q_offset: int | None = None,
                             scale: float | None = None,
                             with_lse: bool = False):
    """The forward launch: (out, lse).  ``lse`` is None, or with
    ``with_lse`` (the wgmma route alone) each row's log-sum-exp of the
    scaled, masked logits, fp32 (B, Hq, Sq) in natural-log units, -1e30
    for a row that sees no key; the output is the same either way."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    kind = _check("flash_attention_cuda", q, k, v, window, route)
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention_cuda: q, k, v must be contiguous")
    if kind == "wgmma" and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention_cuda: TMA needs 16-byte aligned q, k, v")
    if with_lse and kind != "wgmma":
        raise ValueError("flash_attention_cuda: only the wgmma route writes lse")
    if scale is None:
        scale = D ** -0.5
    if q_offset is None:
        q_offset = Sk - Sq
    out = torch.empty_like(q)
    lse = (torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if out.numel() == 0:
        return out, lse
    lib, symbol, argtypes = _LIBS[kind]
    fn = _build.function(lib, symbol, argtypes)
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr()]
    if kind == "wgmma":
        ptrs.append(lse.data_ptr() if with_lse else None)
    with torch.cuda.device(q.device):
        if kind == "wgmma":
            # never inside a capture: DecodeGraph's warm-up makes the first call
            _setup_once(lib, q.device)
        code = fn(*ptrs, B, Sq, Sk, Hq, Hkv, D, int(causal), window or 0,
                  int(q_offset), float(scale),
                  torch.cuda.current_stream().cuda_stream)
    _build.check(lib, code)
    flash_attention_cuda.launches += 1
    flash_attention_cuda.launches_by_route[kind] += 1
    return out, lse


flash_attention_cuda.launches = 0
flash_attention_cuda.launches_by_route = {"wgmma": 0, "simt": 0}


def flash_attention_bwd_cuda(q, k, v, o, do, *, lse=None, causal: bool = True,
                             window: int | None = None,
                             q_offset: int | None = None,
                             scale: float | None = None):
    """(dq, dk, dv) of flash attention on the card, in the inputs' dtype,
    on the route ``bwd_route`` names.

    q, o, do: (B, Sq, Hq, D); k/v: (B, Sk, Hkv, D); ``o`` is the forward's
    output and ``do`` its gradient (made contiguous here: it arrives as a
    view of the attention output's reshape).  ``lse``, on the wgmma route,
    is the forward's log-sum-exp (``flash_attention_fwd_cuda(...,
    with_lse=True)``); without it this call launches that forward to get
    it.  The simt route computes its own and takes none.  Same masks and
    defaults as ``flash_attention_cuda``; what ``ref.attention_bwd_ref``
    computes.
    """
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    name = "flash_attention_bwd_cuda"
    kind = _check(name, q, k, v, window, bwd_route)
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"{name}: o {tuple(o.shape)} and do "
                         f"{tuple(do.shape)} must have q's shape {tuple(q.shape)}")
    if any(t.dtype != q.dtype or t.device != q.device for t in (o, do)):
        raise TypeError(f"{name}: o and do must have q's dtype and device")
    if lse is not None and (kind != "wgmma" or lse.shape != (B, Hq, Sq)
                            or lse.dtype != torch.float32 or lse.device != q.device
                            or not lse.is_contiguous()):
        raise ValueError(f"{name}: lse must be the wgmma route's contiguous fp32 "
                         f"(B, Hq, Sq) = {(B, Hq, Sq)} on q's device")
    q, k, v, o, do = (t.contiguous() for t in (q, k, v, o, do))
    if kind == "wgmma" and any(t.data_ptr() % 16 for t in (q, k, v, o, do)):
        raise ValueError(f"{name}: TMA needs 16-byte aligned q, k, v, o, do")
    if scale is None:
        scale = D ** -0.5
    if q_offset is None:
        q_offset = Sk - Sq
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    delta = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    if kind == "simt":
        lse = torch.empty_like(delta)   # scratch: the kernel writes it
        flags = [int(q.dtype == torch.bfloat16)]
    else:
        if lse is None:
            _, lse = flash_attention_fwd_cuda(q, k, v, causal=causal, window=window,
                                              q_offset=q_offset, scale=scale,
                                              with_lse=True)
        flags = []
    lib, symbol, argtypes = _BWD_LIBS[kind]
    fn = _build.function(lib, symbol, argtypes)
    with torch.cuda.device(q.device):
        if kind == "wgmma":
            _setup_once(lib, q.device)
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                  do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                  lse.data_ptr(), delta.data_ptr(), *flags,
                  B, Sq, Sk, Hq, Hkv, D, int(causal), window or 0,
                  int(q_offset), float(scale),
                  torch.cuda.current_stream().cuda_stream)
    _build.check(lib, code)
    flash_attention_bwd_cuda.launches += 1
    flash_attention_bwd_cuda.launches_by_route[kind] += 1
    return dq, dk, dv


flash_attention_bwd_cuda.launches = 0
flash_attention_bwd_cuda.launches_by_route = {"wgmma": 0, "simt": 0}
