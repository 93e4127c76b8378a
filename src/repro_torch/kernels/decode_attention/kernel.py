"""Hand-written CUDA dense decode attention: one query token a sequence
over the live positions of the (B, S_cache, Hkv, D) cache.

``csrc/decode_attention_split.cu`` replaces no TPU kernel: the JAX
package's dense decode is plain jnp (``ref.decode_attention_ref``), which
casts the whole cache to fp32 and scores every position.  The kernel reads
each live K/V row once for all G query heads of its kv head, and no
position at or past ``valid``: the live length's 16-position units split
over the C = min(ceil(S_cache / 16), 8) blocks of a thread-block cluster,
bf16 products on the tensor cores (mma.sync, P split into bf16 hi and lo),
fp32 ones on CUDA cores, the blocks' partial softmaxes combined through
distributed shared memory in the same launch.  Its body is the paged split
kernel's (``csrc/split_decode.cuh``).

Under a CUDA graph (``serve.engine.DecodeGraph``): the wrapper launches on
the current stream, reads no device value on the host (``valid`` is read
by the kernel) and takes the cluster size from the cache's shape, so a
capture records it and a replay is right at any length.  The library's
build and load and ``decode_attention_split_setup`` run at the first
call, which must come before the capture (the graph's warm-up).
``launches`` and ``launches_by_route`` count launches, through the
checking wrapper or ``launch``: a capture adds one a call, a replay none.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

SPLIT_DIMS = (64, 128)      # the head dims the split source compiles
MAX_G = 9                   # query heads per kv head it compiles, 1..9
_LIB = "decode_attention_split"
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
_split_ready: set[int] = set()   # devices whose shared-memory limit is set


def rule(dtype: torch.dtype, G: int, D: int, alignment: int) -> str:
    """``"split"`` for a call the kernel compiles: bf16 or fp32, the head
    dim ``D`` in ``SPLIT_DIMS``, ``G`` query heads a kv head in
    1..``MAX_G``, and ``alignment``, the bytes that divide the addresses
    of q and both caches, a multiple of 16; ``"plain"`` otherwise."""
    if (dtype in (torch.float32, torch.bfloat16) and D in SPLIT_DIMS
            and 1 <= G <= MAX_G and alignment % 16 == 0):
        return "split"
    return "plain"


def decode_attention_cuda(q, k_cache, v_cache, valid, scale: float | None = None):
    """q: (B, Hq, D); caches: (B, S_cache, Hkv, D); valid: 0-d int32, the
    positions [0, valid) that attend (clamped to [0, S_cache] on the card)
    -> (B, Hq, D), on the card."""
    name = "decode_attention_cuda"
    _build.refuse_dtensor(name, q, k_cache, v_cache, valid)
    _build.refuse_grad(name, q, k_cache, v_cache)
    tensors = (q, k_cache, v_cache, valid)
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: q dtype {q.dtype} not in (float32, bfloat16)")
    if k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise TypeError(f"{name}: q, k_cache and v_cache must share a dtype")
    if valid.dtype != torch.int32 or valid.dim() != 0:
        raise TypeError(f"{name}: valid must be a 0-d int32 tensor")
    if (q.dim() != 3 or k_cache.dim() != 4 or v_cache.shape != k_cache.shape
            or k_cache.shape[0] != q.shape[0] or k_cache.shape[3] != q.shape[2]
            or k_cache.shape[1] < 1 or q.shape[1] % k_cache.shape[2]):
        raise ValueError(f"{name}: bad shapes q {tuple(q.shape)}, caches "
                         f"{tuple(k_cache.shape)}/{tuple(v_cache.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: inputs must be contiguous")
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError(f"{name}: all inputs must be on one CUDA device")
    B, Hq, D = q.shape
    Hkv = k_cache.shape[2]
    if rule(q.dtype, Hq // Hkv, D, math.gcd(q.data_ptr(), k_cache.data_ptr(),
                                             v_cache.data_ptr())) != "split":
        raise ValueError(f"{name}: no kernel takes D {D}, G {Hq // Hkv} or "
                         "inputs not 16-byte aligned")
    return launch(q, k_cache, v_cache, valid, scale)


def launch(q, k_cache, v_cache, valid, scale: float | None = None):
    """``decode_attention_cuda`` without its checks, for a caller that has
    already decided the call is the kernel's (``ops.route``): the same
    arguments, met as that wrapper requires them."""
    B, Hq, D = q.shape
    S_cache, Hkv = k_cache.shape[1], k_cache.shape[2]
    if scale is None:
        scale = D ** -0.5
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    fn = _build.function(_LIB, "decode_attention_split_launch", _ARGTYPES)
    with torch.cuda.device(q.device):
        if q.device.index not in _split_ready:
            setup = _build.function(_LIB, "decode_attention_split_setup", [])
            _build.check(_LIB, setup())
            _split_ready.add(q.device.index)
        code = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                  valid.data_ptr(), out.data_ptr(), B, Hq, Hkv, D, S_cache,
                  float(scale), int(q.dtype == torch.bfloat16),
                  torch.cuda.current_stream().cuda_stream)
    _build.check(_LIB, code)
    decode_attention_cuda.launches += 1
    decode_attention_cuda.launches_by_route["split"] += 1
    return out


decode_attention_cuda.launches = 0
decode_attention_cuda.launches_by_route = {"split": 0}
