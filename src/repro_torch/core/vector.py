"""Array-at-a-time kernels for the data plane (the vectorization PR).

Every hot structure grew a burst API over PRs 2-6 (``lookup_many``,
``consume_batch``, ``write_gather``, ``pop_many``) but still executed a
pure-Python per-item inner loop underneath — the per-request software
stall that a real DPU pipeline eliminates.  This module holds the shared
numpy kernels those burst APIs now call:

  * :func:`mix64` / :func:`hash_keys` — vectorized splitmix64 finalizer,
    bit-identical to ``cache_table._mix`` so scalar and batched probes
    agree on fingerprints and bucket choices.
  * :func:`uniform_stride` — detect that a framed byte stream is one
    fixed-stride run and prove it equals the sequential decode (see the
    function docstring for the argument), unlocking columnar header
    decode with zero per-frame Python work.
  * :func:`pack_frames` — batch header-fill for the encode side: one
    preallocated output buffer, length words scattered array-at-a-time.
  * :func:`checksum64` / :func:`block_checksums` — the position-salted
    integrity checksum for the writev path (computed batch-at-a-time over
    coalesced runs, verified on read and on journal replay).

Kernels operate on contiguous numpy backing stores and are
jnp-compatible by construction (gather / compare / reduce / cumsum only,
no data-dependent Python control flow inside a burst).
"""

from __future__ import annotations

import struct

import numpy as np

MASK64 = 0xFFFFFFFFFFFFFFFF
_M1 = 0xBF58476D1CE4E5B9
_M2 = 0x94D049BB133111EB

# Position salt for checksums: odd constant (golden-ratio conjugate) so
# ``i * GOLD`` is a bijection mod 2^64 — swapping two words of a payload
# changes the checksum even though the fold is a commutative XOR.
GOLD = 0x9E3779B97F4A7C15
# Final length-fold seed: distinguishes e.g. b"\x00" * 8 from b"\x00" * 16.
LEN_SEED = 0xD6E8FEB86659FD93

_U64 = np.uint64


def mix64(x: np.ndarray, seed: int = 0) -> np.ndarray:
    """Vectorized splitmix64 finalizer over a uint64 array.

    Bit-identical to ``cache_table._mix`` (the scalar hot-path version):
    property tests assert equality element-wise.
    """
    with np.errstate(over="ignore"):
        x = x.astype(np.uint64, copy=True)
        if seed:
            x ^= _U64(seed)
        x ^= x >> _U64(30)
        x *= _U64(_M1)
        x ^= x >> _U64(27)
        x *= _U64(_M2)
        x ^= x >> _U64(31)
    return x


def scalar_mix(x: int, seed: int = 0) -> int:
    """Pure-int splitmix64 (reference / tail path; mirrors cache_table)."""
    x ^= seed
    x ^= x >> 30
    x = (x * _M1) & MASK64
    x ^= x >> 27
    x = (x * _M2) & MASK64
    x ^= x >> 31
    return x


def hash_keys(keys: list) -> np.ndarray:
    """Burst equivalent of ``CacheTable._hash_key``: one uint64 per key.

    The pre-mix value (``key & MASK64`` for ints, ``hash(key) & MASK64``
    otherwise) is gathered per item — Python ``hash`` has no array form —
    but the avalanche mix runs once over the whole burst.
    """
    n = len(keys)
    try:
        # Hash values fit int64; the uint64 reinterpret IS the & MASK64
        # (two's complement), skipping a Python big-int mask per key.
        raw = np.fromiter(
            (k if isinstance(k, int) else hash(k) for k in keys),
            dtype=np.int64, count=n).view(np.uint64)
    except OverflowError:   # int key outside int64 — rare, mask per item
        raw = np.fromiter(
            ((k if isinstance(k, int) else hash(k)) & MASK64 for k in keys),
            dtype=np.uint64, count=n)
    return mix64(raw)


# ---------------------------------------------------------------------------
# Wire framing
# ---------------------------------------------------------------------------

def uniform_stride(buf, hdr: int, len_off: int = 0,
                   min_frames: int = 2) -> tuple[int, int, int] | None:
    """Detect a fixed-stride framed prefix of ``buf``; ``None`` if irregular.

    A frame is ``hdr`` header bytes (little-endian u32 payload length at
    ``len_off``) followed by the payload.  Returns ``(count, stride,
    payload_len)`` covering the maximal whole-frame prefix, or ``None``
    when the stream is not provably uniform — or shorter than
    ``min_frames`` frames, below which the caller's scalar walk is
    cheaper than the proof (the hot call sites pass the crossover
    measured by ``benchmarks/micro/kernels_ab.py``, ~20 frames; the
    default 2 keeps the proof itself exercisable at any size).

    Equivalence argument (why this is safe for ARBITRARY input, not just
    benchmark traffic): the sequential decoder is a greedy walk — read the
    length word at the current offset, step ``hdr + len``.  We read the
    FIRST length word, hypothesize that every frame has that length, and
    then verify the hypothesis by comparing the length-word bytes at every
    stride multiple.  If they all match, the greedy walk would have read
    exactly these words and taken exactly these steps, so the columnar
    decode is byte-identical to the scalar one.  Any mismatch (including
    payload bytes that merely sit where a header would be in a
    DIFFERENTLY-framed stream) fails the comparison and falls back to the
    scalar walk.  Bytes past ``count * stride`` are the caller's remainder
    (a trailing partial frame, or frames of a different size).
    """
    total = len(buf)
    if total <= hdr:
        return None
    first = int.from_bytes(buf[len_off:len_off + 4], "little")
    stride = hdr + first
    n = total // stride
    if n < max(min_frames, 2):
        # Too few frames: scalar decode is cheaper than proving
        # uniformity, and the proof needs a second length word anyway.
        return None
    a = np.frombuffer(buf, dtype=np.uint8, count=n * stride)
    words = a.reshape(n, stride)[:, len_off:len_off + 4]
    if not (words == words[0]).all():
        return None
    return n, stride, first


def pack_frames(msgs: list, hdr: int = 4) -> bytearray:
    """Batch frame-pack: ``[u32 len][payload]`` per message, one buffer.

    The scalar path packs one 4-byte header object per message and joins
    2n fragments; here the length column is scattered into a single
    preallocated buffer array-at-a-time and only payload memcpys remain.
    Returns a ``bytearray`` (equal to the ``bytes`` the scalar join
    produces; callers hand it to buffer-protocol consumers).
    """
    n = len(msgs)
    if not n:
        return bytearray()
    lens = np.fromiter((len(m) for m in msgs), dtype=np.int64, count=n)
    ln0 = int(lens[0])
    if n >= 8 and ln0 and (lens == ln0).all():
        # Uniform frames: ONE payload join + one strided scatter replaces
        # the per-message memcpy loop entirely.
        stride = hdr + ln0
        out = bytearray(n * stride)
        a = np.frombuffer(out, dtype=np.uint8).reshape(n, stride)
        hb = ln0.to_bytes(4, "little") + b"\x00" * (hdr - 4)
        a[:, :hdr] = np.frombuffer(hb, dtype=np.uint8)
        a[:, hdr:] = np.frombuffer(b"".join(
            m if isinstance(m, (bytes, bytearray, memoryview)) else bytes(m)
            for m in msgs), dtype=np.uint8).reshape(n, ln0)
        return out
    starts = np.empty(n, dtype=np.int64)
    starts[0] = 0
    np.cumsum(lens[:-1] + hdr, out=starts[1:])
    out = bytearray(int(starts[-1] + hdr + lens[-1]))
    a = np.frombuffer(out, dtype=np.uint8)
    for b in range(4):
        a[starts + b] = (lens >> (8 * b)) & 0xFF
    mv = memoryview(out)
    for i, m in enumerate(msgs):
        s = int(starts[i]) + hdr
        mv[s:s + len(m)] = m if isinstance(m, (bytes, bytearray, memoryview)) \
            else bytes(m)
    return out


# ---------------------------------------------------------------------------
# Integrity checksums (batch CRC for the writev path)
# ---------------------------------------------------------------------------

def checksum64(data) -> int:
    """Position-salted 64-bit integrity checksum, one vectorized pass.

    Layout: the payload is read as little-endian u64 words; word ``i`` is
    salted with ``i * GOLD`` (bijective, so transpositions change the
    sum), avalanche-mixed, and XOR-folded.  A sub-8-byte tail is
    zero-padded into one final word, and the total length is folded in
    under ``LEN_SEED`` so runs of zeros of different lengths differ.
    Detects bit flips, transposed words, truncation and extension — the
    CRC32C role on the writev path, in one numpy pass per coalesced run.
    """
    mv = memoryview(data)
    if mv.ndim != 1 or mv.itemsize != 1:
        mv = mv.cast("B")
    n = len(mv)
    nwords = n >> 3
    acc = 0
    if nwords:
        words = np.frombuffer(mv, dtype="<u8", count=nwords)
        with np.errstate(over="ignore"):
            salted = words ^ (np.arange(nwords, dtype=np.uint64) * _U64(GOLD))
        acc = int(np.bitwise_xor.reduce(mix64(salted)))
    tail = n & 7
    if tail:
        last = int.from_bytes(bytes(mv[n - tail:]), "little")
        acc ^= scalar_mix(last ^ ((nwords * GOLD) & MASK64))
    return scalar_mix(acc ^ n, LEN_SEED)


def checksum64_scalar(data) -> int:
    """Pure-Python reference for :func:`checksum64` (property tests)."""
    mv = memoryview(data)
    if mv.ndim != 1 or mv.itemsize != 1:
        mv = mv.cast("B")
    n = len(mv)
    acc = 0
    for i in range(n >> 3):
        word = int.from_bytes(bytes(mv[i * 8:i * 8 + 8]), "little")
        acc ^= scalar_mix(word ^ ((i * GOLD) & MASK64))
    tail = n & 7
    if tail:
        last = int.from_bytes(bytes(mv[n - tail:]), "little")
        acc ^= scalar_mix(last ^ (((n >> 3) * GOLD) & MASK64))
    return scalar_mix(acc ^ n, LEN_SEED)


def block_checksums(mem: np.ndarray, lba: int, nblocks: int,
                    block: int) -> np.ndarray:
    """:func:`checksum64` of ``nblocks`` device blocks, batch-at-a-time.

    ``mem`` is the device's uint8 media array; blocks are ``block`` bytes
    (a multiple of 8), so the whole span folds as one (nblocks, words)
    matrix — per-column salts, one mix, one XOR-reduce per row.  Matches
    ``checksum64(mem[i*block:(i+1)*block].tobytes())`` element-wise.
    """
    span = mem[lba * block:(lba + nblocks) * block]
    wpb = block >> 3
    words = np.frombuffer(span, dtype="<u8").reshape(nblocks, wpb)
    with np.errstate(over="ignore"):
        salts = np.arange(wpb, dtype=np.uint64) * _U64(GOLD)
        rows = np.bitwise_xor.reduce(mix64(words ^ salts), axis=1)
    return mix64(rows ^ _U64(block), seed=LEN_SEED)


__all__ = [
    "MASK64", "GOLD", "LEN_SEED",
    "mix64", "scalar_mix", "hash_keys",
    "uniform_stride", "pack_frames",
    "checksum64", "checksum64_scalar", "block_checksums",
]
