"""Hand-written CUDA chunked gated-linear-attention scan (``csrc/gla_scan.cu``).

Replaces ``gla_scan_pallas`` (src/repro/kernels/ssm_scan/kernel.py).  One
block per (batch * head, V tile) walks the chunks of its sequence in order
and keeps the K x V state in shared memory, as the Pallas kernel keeps it in
VMEM across its sequential chunk axis.  The arithmetic is ``gla_scan_xla``'s
(clamp of w to [-30, 0], exp(-a) capped at e^60) in fp32 on CUDA cores.
Unlike the Pallas kernel it takes any S: positions past S act as the plain
version's zero padding.  q, k and v may be strided views (the models pass
head-transposed ones); w may have a stride-0 K axis (Mamba2's one decay per
head), which the kernel then reads once per position.  At the prefill shape
the kernel's bound is the bytes it must move; see the source note.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
             + [ctypes.c_longlong] * 16 + [ctypes.c_int, ctypes.c_void_p])
DIMS = (16, 32, 64, 128)    # the K and V sizes the source compiles
MAX_CHUNK = 128


def gla_scan_cuda(q, k, v, w, chunk: int = 128):
    """q, k, w: (B, H, S, K); v: (B, H, S, V) -> (o (B, H, S, V) in q's
    dtype, final state (B, H, K, V) fp32), on the card, from a zero state."""
    B, H, S, K = q.shape
    V = v.shape[-1]
    if not all(t.is_cuda and t.device == q.device for t in (q, k, v, w)):
        raise ValueError("gla_scan_cuda: q, k, v, w must be on one CUDA device")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"gla_scan_cuda: dtype {q.dtype} not in (float32, bfloat16)")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("gla_scan_cuda: q, k and v must share a dtype")
    if w.dtype != torch.float32:
        raise TypeError(f"gla_scan_cuda: w must be float32, not {w.dtype}")
    if k.shape != q.shape or w.shape != q.shape or v.shape[:3] != q.shape[:3]:
        raise ValueError(f"gla_scan_cuda: bad shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, w {tuple(w.shape)}")
    if K not in DIMS or V not in DIMS:
        raise ValueError(f"gla_scan_cuda: K {K} and V {V} must be in {DIMS}")
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"gla_scan_cuda: chunk {chunk} not in [1, {MAX_CHUNK}]")
    if any(t.stride(-1) != 1 for t in (q, k, v)) or w.stride(-1) not in (0, 1):
        raise ValueError("gla_scan_cuda: the last axis of q, k, v must be "
                         "contiguous and that of w contiguous or broadcast")
    o = torch.empty((B, H, S, V), dtype=q.dtype, device=q.device)
    if o.numel() == 0:
        return o, torch.zeros((B, H, K, V), dtype=torch.float32, device=q.device)
    state = torch.empty((B, H, K, V), dtype=torch.float32, device=q.device)
    fn = _build.function("gla_scan", "gla_scan_launch", _ARGTYPES)
    strides = [s for t in (q, k, v, w) for s in t.stride()]
    with torch.cuda.device(q.device):
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                  o.data_ptr(), state.data_ptr(), B, H, S, K, V,
                  min(chunk, S), *strides, int(q.dtype == torch.bfloat16),
                  torch.cuda.current_stream().cuda_stream)
    _build.check("gla_scan", code)
    gla_scan_cuda.launches += 1
    return o, state


gla_scan_cuda.launches = 0
