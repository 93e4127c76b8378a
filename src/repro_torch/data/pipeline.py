"""Training data pipeline with DDS-ring prefetch.

Deterministic synthetic token streams (seeded counter-based PCG) stand in for
a tokenized corpus — fully reproducible across restarts and elastic reshapes:
batch ``step`` for data-parallel rank ``r`` is a pure function of
``(seed, step, r)``, so a restarted or re-scaled job never replays or skips
examples.

``RingPrefetcher`` stages serialized batches through a DDS progressive ring
(§4.1) — the same lock-free MPSC discipline the storage path uses — so the
host training thread never blocks on the loader: it polls the ring
(non-blocking PollWait semantics) while the producer thread stays ahead.
"""

from __future__ import annotations

import struct
import threading
from dataclasses import dataclass

import numpy as np

from repro_torch.core.ring import DMAEngine, ProgressiveRing, frame, unframe_batch


@dataclass
class BatchSpec:
    global_batch: int
    seq_len: int
    vocab_size: int


class TokenPipeline:
    """Deterministic sharded token stream.

    ``structured=True`` produces learnable sequences (noisy affine
    next-token process) so training demos show real loss descent; the
    default uniform stream has an irreducible loss floor of ln(vocab).
    """

    def __init__(self, spec: BatchSpec, seed: int = 0,
                 rank: int = 0, world: int = 1, structured: bool = False,
                 noise: float = 0.05):
        if spec.global_batch % world != 0:
            raise ValueError("global batch must divide by world size")
        self.spec = spec
        self.seed = seed
        self.rank = rank
        self.world = world
        self.structured = structured
        self.noise = noise
        self.local_batch = spec.global_batch // world

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        """Pure function of (seed, step, rank): elastic-restart safe."""
        s = self.spec
        rng = np.random.Generator(np.random.PCG64(
            (self.seed * 1_000_003 + step) * 65_537 + self.rank))
        if not self.structured:
            tokens = rng.integers(0, s.vocab_size,
                                  size=(self.local_batch, s.seq_len + 1),
                                  dtype=np.int32)
            return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
        # Learnable process: each sequence repeats a random motif (copy task
        # — induction heads pick this up within tens of steps), plus noise.
        B, S, V = self.local_batch, s.seq_len + 1, s.vocab_size
        m = int(rng.choice([8, 16, 32]))
        motifs = rng.integers(0, V, size=(B, m))
        reps = -(-S // m)
        toks = np.tile(motifs, (1, reps))[:, :S]
        flip = rng.random((B, S)) < self.noise
        toks[flip] = rng.integers(0, V, size=int(flip.sum()))
        toks = toks.astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


_PF_HDR = struct.Struct("<QII")  # step, batch, seq


class RingPrefetcher:
    """Producer thread serializes batches into a progressive ring."""

    def __init__(self, pipeline: TokenPipeline, depth: int = 4):
        self.pipeline = pipeline
        s = pipeline.spec
        per_batch = (_PF_HDR.size + 4
                     + 2 * pipeline.local_batch * s.seq_len * 4 + 64)
        cap = 1 << max(12, (depth * per_batch).bit_length())
        self.ring = ProgressiveRing(cap, max_progress=cap // 2,
                                    name="data-prefetch")
        self.dma = DMAEngine()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._produced = 0
        self._carry = b""

    def _serialize(self, step: int, batch: dict[str, np.ndarray]) -> bytes:
        t, l = batch["tokens"], batch["labels"]
        hdr = _PF_HDR.pack(step, t.shape[0], t.shape[1])
        return hdr + t.tobytes() + l.tobytes()

    @staticmethod
    def deserialize(raw: bytes) -> tuple[int, dict[str, np.ndarray]]:
        step, b, s = _PF_HDR.unpack_from(raw, 0)
        n = b * s * 4
        off = _PF_HDR.size
        tokens = np.frombuffer(raw, np.int32, b * s, off).reshape(b, s)
        labels = np.frombuffer(raw, np.int32, b * s, off + n).reshape(b, s)
        return step, {"tokens": tokens, "labels": labels}

    def start(self) -> None:
        self._stop.clear()
        self._thread = threading.Thread(target=self._produce, daemon=True,
                                        name="data-prefetch")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)
            self._thread = None

    def _produce(self) -> None:
        step = 0
        while not self._stop.is_set():
            msg = frame(self._serialize(step, self.pipeline.batch_at(step)))
            while not self._stop.is_set():
                if self.ring.try_insert(msg) == "OK":
                    step += 1
                    self._produced += 1
                    break
                self._stop.wait(1e-4)  # ring full: training is behind

    def produce_one(self, step: int) -> bool:
        """Cooperative (threadless) production for deterministic tests."""
        msg = frame(self._serialize(step, self.pipeline.batch_at(step)))
        return self.ring.try_insert(msg) == "OK"

    def next_batch(self, spin: int = 2_000_000) -> tuple[int, dict[str, np.ndarray]]:
        """Non-blocking poll loop over the ring consumer side."""
        for _ in range(spin):
            msgs = unframe_batch(self._carry) if self._carry else []
            if msgs:
                first, rest = msgs[0], msgs[1:]
                # unframe_batch returns views over _carry; materialize the
                # re-framed remainder before _carry is rebound.
                self._carry = b"".join(
                    struct.pack("<I", len(m)) + bytes(m) for m in rest)
                return self.deserialize(first)
            got = self.ring.consume(self.dma)
            if got is not None:
                self._carry = got
        raise TimeoutError("prefetch ring starved")
