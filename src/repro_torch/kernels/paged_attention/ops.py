"""Dispatching wrapper for paged decode attention.

  * ``cuda`` — the hand-written block-table-walking kernel (kernel.py);
    the default for CUDA tensors, which never take the plain path;
  * ``xla``  — gather pages then masked attention (ref.py), the plain
    version; the default for CPU tensors.  The name follows the JAX
    package's portable impl.
"""

from __future__ import annotations

from repro_torch.kernels.paged_attention.kernel import paged_attention_cuda
from repro_torch.kernels.paged_attention.ref import paged_attention_ref


def paged_attention(q, k_pages, v_pages, block_table, seq_lens,
                    scale: float | None = None, impl: str | None = None):
    if impl is None:
        impl = "cuda" if q.is_cuda else "xla"
    if impl == "cuda":
        return paged_attention_cuda(q, k_pages, v_pages, block_table,
                                    seq_lens, scale=scale)
    if impl == "xla":
        return paged_attention_ref(q, k_pages, v_pages, block_table, seq_lens,
                                   scale=scale)
    raise ValueError(f"unknown impl {impl}")
