"""Hand-written CUDA flash attention, forward: two routes by dtype.

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
library is built or loaded.  No backward yet: a call that autograd would
record raises.  A launch sets nothing on the device, so a CUDA graph can
capture it: the wgmma kernel's shared-memory limit is raised once per
device by ``flash_attention_wgmma_setup`` at the first call.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
             + [ctypes.c_float, ctypes.c_void_p])
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


def flash_attention_cuda(q, k, v, *, causal: bool = True,
                         window: int | None = None,
                         q_offset: int | None = None,
                         scale: float | None = None):
    """q: (B, Sq, Hq, D); k/v: (B, Sk, Hkv, D) -> (B, Sq, Hq, D), on the card."""
    _build.refuse_grad("flash_attention_cuda", q, k, v)
    B, Sq, Hq, D = q.shape
    Bk, Sk, Hkv, Dk = k.shape
    kind = route(q.dtype, D)
    if not all(t.is_cuda and t.device == q.device for t in (q, k, v)):
        raise ValueError("flash_attention_cuda: q, k, v must be on one CUDA device")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention_cuda: q, k and v must share a dtype")
    if v.shape != k.shape or Bk != B or Dk != D or Hq % Hkv:
        raise ValueError(f"flash_attention_cuda: bad shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention_cuda: window {window} < 1")
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
