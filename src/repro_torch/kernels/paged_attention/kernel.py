"""Hand-written CUDA paged decode attention: two routes by a rule of dtype,
shape and alignment.

Replaces ``paged_attention_pallas`` (src/repro/kernels/paged_attention/
kernel.py).  Both routes walk the block table, read each physical page they
need once for all G query heads of its kv head, run the online softmax in
fp32, stop at ``ceil(seq_len / page)`` and write zeros for ``seq_len == 0``,
as the Pallas kernel does:

  * ``split`` (``csrc/paged_attention_split.cu``) takes bf16 and fp32 calls
    with D in ``SPLIT_DIMS``, G = Hq / Hkv in 1..``MAX_G``, a page that is a
    multiple of ``PAGE_MULTIPLE`` positions and 16-byte aligned q and pools
    -- what the dense models' paged decode runs.  Each sequence's pages are
    split over the C = min(max_pages, 8) blocks of a thread-block cluster,
    rows come in with 16-byte cp.async copies, bf16 products run on the
    tensor cores (mma.sync) and fp32 ones on CUDA cores, and the blocks'
    partial softmaxes are combined through distributed shared memory in the
    same launch;
  * ``simt`` (``csrc/paged_attention.cu``) takes every other call: one block
    per (sequence, kv head) stages each page in shared memory.

A route is never chosen because a build or a launch failed.  Block-table
entries and ``seq_lens`` are read on the device and are not checked here
(that would need a sync): entries must lie in ``[0, P)``.  No backward
yet: a call that autograd would record raises.

Under a CUDA graph (``serve.engine.DecodeGraph``): the wrapper launches on
the current stream, reads no device value on the host and takes the
cluster size from the table's shape, so a capture records it and a replay
reads the table's and ``seq_lens``' current entries.  The library's build
and load and ``paged_attention_split_setup`` run at the first call, which
must come before the capture (the graph's warm-up).  ``launches`` and
``launches_by_route`` count wrapper calls: a capture adds one a call, a
replay none.  The simt launcher sets the kernel's shared-memory limit with
``cudaFuncSetAttribute`` on every launch that needs more than 48 KB; that
call is legal during a capture.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

SPLIT_DIMS = (64, 128)      # the head dims the split source compiles
MAX_G = 9                   # query heads per kv head it compiles, 1..9
PAGE_MULTIPLE = 16          # a warp step reads 8 or 16 positions of one page
# route -> (library, C entry point); both take the same arguments
_LIBS = {
    "split": ("paged_attention_split", "paged_attention_split_launch"),
    "simt": ("paged_attention", "paged_attention_launch"),
}
_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
_split_ready: set[int] = set()   # devices whose shared-memory limit is set


def route(dtype: torch.dtype, G: int, D: int, page: int, alignment: int) -> str:
    """The kernel a call takes, ``"split"`` or ``"simt"``, from the dtype,
    the query heads per kv head ``G``, the head dim ``D``, the page size
    and ``alignment``, the bytes that divide the addresses of q and both
    pools.  Raises TypeError for a dtype neither kernel takes."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"paged_attention_cuda: dtype {dtype} not in (float32, bfloat16)")
    if (D in SPLIT_DIMS and 1 <= G <= MAX_G and page % PAGE_MULTIPLE == 0
            and alignment % 16 == 0):
        return "split"
    return "simt"


def paged_attention_cuda(q, k_pages, v_pages, block_table, seq_lens,
                         scale: float | None = None):
    """q: (B, Hq, D); pools: (P, page, Hkv, D) -> (B, Hq, D), on the card."""
    _build.refuse_dtensor("paged_attention_cuda", q, k_pages, v_pages,
                          block_table, seq_lens)
    _build.refuse_grad("paged_attention_cuda", q, k_pages, v_pages)
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
    kind = route(q.dtype, Hq // Hkv, D, page,
                 math.gcd(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr()))
    if scale is None:
        scale = D ** -0.5
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib, symbol = _LIBS[kind]
    fn = _build.function(lib, symbol, _ARGTYPES)
    with torch.cuda.device(q.device):
        if kind == "split" and q.device.index not in _split_ready:
            setup = _build.function(lib, "paged_attention_split_setup", [])
            _build.check(lib, setup())
            _split_ready.add(q.device.index)
        code = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                  block_table.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
                  B, Hq, Hkv, D, page, block_table.shape[1], float(scale),
                  int(q.dtype == torch.bfloat16),
                  torch.cuda.current_stream().cuda_stream)
    _build.check(lib, code)
    paged_attention_cuda.launches += 1
    paged_attention_cuda.launches_by_route[kind] += 1
    return out


paged_attention_cuda.launches = 0
paged_attention_cuda.launches_by_route = {"split": 0, "simt": 0}
