"""Hand-written CUDA flash attention, forward (``csrc/flash_attention.cu``).

Replaces ``flash_attention_pallas`` (src/repro/kernels/flash_attention/
kernel.py).  One block per (batch * kv head, query tile) stacks the G query
heads of its kv head into its rows, so each K/V tile is staged in shared
memory once for all of them; the online softmax runs in fp32 with the
finite mask value -1e30, and tiles wholly masked by the causal frontier or
the window are skipped.  Unlike the Pallas kernel it takes ragged ``Sq`` and
``Sk``.  At prefill shapes its bound is the bytes it must move; see the
source note for what limits this first version.  No backward yet.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
HEAD_DIMS = (32, 64, 128)   # the head dims the source compiles


def flash_attention_cuda(q, k, v, *, causal: bool = True,
                         window: int | None = None,
                         q_offset: int | None = None,
                         scale: float | None = None):
    """q: (B, Sq, Hq, D); k/v: (B, Sk, Hkv, D) -> (B, Sq, Hq, D), on the card."""
    B, Sq, Hq, D = q.shape
    Bk, Sk, Hkv, Dk = k.shape
    if not all(t.is_cuda and t.device == q.device for t in (q, k, v)):
        raise ValueError("flash_attention_cuda: q, k, v must be on one CUDA device")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash_attention_cuda: dtype {q.dtype} not in (float32, bfloat16)")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention_cuda: q, k and v must share a dtype")
    if v.shape != k.shape or Bk != B or Dk != D or Hq % Hkv:
        raise ValueError(f"flash_attention_cuda: bad shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention_cuda: head dim {D} not in {HEAD_DIMS}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention_cuda: window {window} < 1")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention_cuda: q, k, v must be contiguous")
    if scale is None:
        scale = D ** -0.5
    if q_offset is None:
        q_offset = Sk - Sq
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    fn = _build.function("flash_attention", "flash_attention_launch", _ARGTYPES)
    with torch.cuda.device(q.device):
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  B, Sq, Sk, Hq, Hkv, D, int(causal), window or 0,
                  int(q_offset), float(scale), int(q.dtype == torch.bfloat16),
                  torch.cuda.current_stream().cuda_stream)
    _build.check("flash_attention", code)
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0
