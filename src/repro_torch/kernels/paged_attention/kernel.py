"""Hand-written CUDA paged decode attention (``csrc/paged_attention.cu``).

Replaces ``paged_attention_pallas`` (src/repro/kernels/paged_attention/
kernel.py).  The kernel is bound by bytes: one block per (sequence, kv head)
walks the block table, reads each physical page it needs once, and serves
all G query heads of that kv head from the staged copy, with the online
softmax in fp32.  It stops at ``ceil(seq_len / page)`` and writes zeros for
``seq_len == 0``, as the Pallas kernel does.

Block-table entries and ``seq_lens`` are read on the device and are not
checked here (that would need a sync): entries must lie in ``[0, P)``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def paged_attention_cuda(q, k_pages, v_pages, block_table, seq_lens,
                         scale: float | None = None):
    """q: (B, Hq, D); pools: (P, page, Hkv, D) -> (B, Hq, D), on the card."""
    B, Hq, D = q.shape
    P, page, Hkv, Dk = k_pages.shape
    tensors = (q, k_pages, v_pages, block_table, seq_lens)
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError("paged_attention_cuda: all inputs must be on one CUDA device")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"paged_attention_cuda: q dtype {q.dtype} not in (float32, bfloat16)")
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError("paged_attention_cuda: q, k_pages and v_pages must share a dtype")
    if block_table.dtype != torch.int32 or seq_lens.dtype != torch.int32:
        raise TypeError("paged_attention_cuda: block_table and seq_lens must be int32")
    if (v_pages.shape != k_pages.shape or Dk != D or Hq % Hkv
            or block_table.dim() != 2 or block_table.shape[0] != B
            or tuple(seq_lens.shape) != (B,)):
        raise ValueError(
            f"paged_attention_cuda: bad shapes q {tuple(q.shape)}, pools "
            f"{tuple(k_pages.shape)}/{tuple(v_pages.shape)}, block_table "
            f"{tuple(block_table.shape)}, seq_lens {tuple(seq_lens.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_attention_cuda: inputs must be contiguous")
    if scale is None:
        scale = D ** -0.5
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    fn = _build.function("paged_attention", "paged_attention_launch", _ARGTYPES)
    with torch.cuda.device(q.device):
        code = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                  block_table.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
                  B, Hq, Hkv, D, page, block_table.shape[1], float(scale),
                  int(q.dtype == torch.bfloat16),
                  torch.cuda.current_stream().cuda_stream)
    _build.check("paged_attention", code)
    paged_attention_cuda.launches += 1
    return out


paged_attention_cuda.launches = 0
