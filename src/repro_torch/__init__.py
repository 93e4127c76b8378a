"""PyTorch/CUDA port of the DDS reproduction's compute stack.

The package mirrors ``repro`` module by module and keeps its public names.
It imports ``torch`` and never ``jax``, and nothing of ``repro``: the
storage substrate (``core``, ``storage``) and ``configs`` are verbatim
copies with the import prefix rewritten.  Entry points run on ``cuda``
unless the caller passes ``device="cpu"``.
"""
