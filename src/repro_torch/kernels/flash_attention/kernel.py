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

The backward (``csrc/flash_attention_bwd.cu``, ``flash_attention_bwd_cuda``)
takes both dtypes on CUDA cores in fp32 and recomputes the softmax
statistics, so the forward kernels stay as they are.  A call that autograd
records goes through ``FlashAttentionFn``, whose forward is the forward
launch and whose backward is that kernel; any other call is the forward
launch alone (prefill, decode and their CUDA graphs).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
             + [ctypes.c_float, ctypes.c_void_p])
_BWD_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 10
                 + [ctypes.c_float, ctypes.c_void_p])
_BWD_LIB = ("flash_attention_bwd", "flash_attention_bwd_launch")
HEAD_DIMS = (32, 64, 128, 320)   # the head dims both sources compile
# route -> (library, C entry point)
_LIBS = {"wgmma": ("flash_attention_wgmma", "flash_attention_wgmma_launch"),
         "simt": ("flash_attention", "flash_attention_launch")}
_wgmma_ready: set[int] = set()   # devices whose shared-memory limit is set


def route(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel a call takes: ``"wgmma"`` for bfloat16, ``"simt"`` for
    float32.  Raises TypeError for another dtype and ValueError for a head
    dim outside ``HEAD_DIMS``."""
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"flash_attention_cuda: head dim {head_dim} not in {HEAD_DIMS}")
    if dtype == torch.bfloat16:
        return "wgmma"
    if dtype == torch.float32:
        return "simt"
    raise TypeError(f"flash_attention_cuda: dtype {dtype} not in (float32, bfloat16)")


def _check(name, q, k, v, window) -> str:
    """The route of a call; raises on what the kernels do not take."""
    B, Sq, Hq, D = q.shape
    Bk, Sk, Hkv, Dk = k.shape
    kind = route(q.dtype, D)
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
    """Flash attention with a gradient: the forward launch, saving q, k, v
    and the output, and ``flash_attention_bwd_cuda`` as its backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, scale):
        out = flash_attention_cuda(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset, scale=scale)
        ctx.save_for_backward(q, k, v, out)
        ctx.kw = dict(causal=causal, window=window, q_offset=q_offset,
                      scale=scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_cuda(q, k, v, out, dout, **ctx.kw)
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
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    kind = _check("flash_attention_cuda", q, k, v, window)
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention_cuda: q, k, v must be contiguous")
    if kind == "wgmma" and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention_cuda: TMA needs 16-byte aligned q, k, v")
    if scale is None:
        scale = D ** -0.5
    if q_offset is None:
        q_offset = Sk - Sq
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib, symbol = _LIBS[kind]
    fn = _build.function(lib, symbol, _ARGTYPES)
    with torch.cuda.device(q.device):
        if kind == "wgmma" and q.device.index not in _wgmma_ready:
            # once per device, at the first call, never inside a capture
            # (DecodeGraph's warm-up makes that first call)
            setup = _build.function(lib, "flash_attention_wgmma_setup", [])
            _build.check(lib, setup())
            _wgmma_ready.add(q.device.index)
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  B, Sq, Sk, Hq, Hkv, D, int(causal), window or 0,
                  int(q_offset), float(scale),
                  torch.cuda.current_stream().cuda_stream)
    _build.check(lib, code)
    flash_attention_cuda.launches += 1
    flash_attention_cuda.launches_by_route[kind] += 1
    return out


flash_attention_cuda.launches = 0
flash_attention_cuda.launches_by_route = {"wgmma": 0, "simt": 0}


def flash_attention_bwd_cuda(q, k, v, o, do, *, causal: bool = True,
                             window: int | None = None,
                             q_offset: int | None = None,
                             scale: float | None = None):
    """(dq, dk, dv) of flash attention on the card, in the inputs' dtype.

    q, o, do: (B, Sq, Hq, D); k/v: (B, Sk, Hkv, D); ``o`` is the forward's
    output and ``do`` its gradient (made contiguous here: it arrives as a
    view of the attention output's reshape).  Same masks and defaults as
    ``flash_attention_cuda``; what ``ref.attention_bwd_ref`` computes.
    """
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    _check("flash_attention_bwd_cuda", q, k, v, window)
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"flash_attention_bwd_cuda: o {tuple(o.shape)} and do "
                         f"{tuple(do.shape)} must have q's shape {tuple(q.shape)}")
    if any(t.dtype != q.dtype or t.device != q.device for t in (o, do)):
        raise TypeError("flash_attention_bwd_cuda: o and do must have q's dtype "
                        "and device")
    q, k, v, o, do = (t.contiguous() for t in (q, k, v, o, do))
    if scale is None:
        scale = D ** -0.5
    if q_offset is None:
        q_offset = Sk - Sq
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    delta = torch.empty_like(lse)
    lib, symbol = _BWD_LIB
    fn = _build.function(lib, symbol, _BWD_ARGTYPES)
    with torch.cuda.device(q.device):
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                  do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                  lse.data_ptr(), delta.data_ptr(), int(q.dtype == torch.bfloat16),
                  B, Sq, Sk, Hq, Hkv, D, int(causal), window or 0,
                  int(q_offset), float(scale),
                  torch.cuda.current_stream().cuda_stream)
    _build.check(lib, code)
    flash_attention_bwd_cuda.launches += 1
    return dq, dk, dv


flash_attention_bwd_cuda.launches = 0
