"""Set-up and the measured window: closed-loop waves through the program's
two serve entry points.

A wave is ``batch`` requests of one prompt length.  It runs
``ModelAPI.prefill`` (the bf16 flash kernel) into a fresh cache, copies
that cache into the one cache a ``serve.engine.DecodeGraph`` captured at
set-up over ``ModelAPI.decode_step``, and replays the graph for each
further output token, the greedy token taken and fed back on the device.
The next wave starts when this one has been enqueued; waves start until the
window's seconds have passed, and each runs to its last token.  A CUDA event after
each token's sampling gives its time on the device's timeline; the host
stays at most ``LAG`` steps ahead of the device, so it never syncs a step
it does not have to.  On the CPU (the tests) the step is called eagerly,
as the program's own scheduler does there, and the marks are host times.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque

import numpy as np
import torch
from torch.profiler import record_function

from portbench import traffic as T
from portbench import weights

LAG = 4           # steps the host may enqueue ahead of the device
SCHEDULE = 10_000        # waves a window could start, at most
WARMUP_WAVE = SCHEDULE    # the warm-up prompt's draw: no window's wave


def port_config(config: dict):
    """The program's ModelConfig for a configuration file: the port's own
    config with every key of the file's ``model`` block that it has."""
    from repro_torch.configs import get_config

    base = get_config(config["port_config"])
    fields = {f.name for f in dataclasses.fields(base)}
    return dataclasses.replace(base, **{k: v for k, v in config["model"].items()
                                        if k in fields})


class Marks:
    """Timestamps on the device's timeline: CUDA events on a card, the
    host clock on the CPU, where every call has finished when it returns."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def mark(self):
        if not self.cuda:
            return time.perf_counter()
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def wait(self, m) -> None:
        if self.cuda:
            m.synchronize()

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    def seconds(self, a, b) -> float:
        return a.elapsed_time(b) / 1e3 if self.cuda else b - a


@dataclasses.dataclass
class Wave:
    index: int
    S: int
    prompts: torch.Tensor           # (B, S) int32
    out: torch.Tensor               # (B, n) int32: the served tokens
    rows: torch.Tensor | None = None    # the rows whose logits are kept
    kept: torch.Tensor | None = None    # (rows, n, vocab) logits, while held
    start: object = None            # mark before its prefill
    marks: list = dataclasses.field(default_factory=list)   # one per token
    t_start: float = 0.0            # seconds from the window's start
    t_tokens: list = dataclasses.field(default_factory=list)

    @property
    def B(self) -> int:
        return self.out.shape[0]

    @property
    def done(self) -> bool:
        return len(self.marks) == self.out.shape[1]


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """The served token of each row: (B, vocab) -> (B, 1) int32."""
    return logits.argmax(-1, keepdim=True).to(torch.int32)


def kept_rows(traffic: dict, seed: int, wave: int, device) -> torch.Tensor:
    """The rows of wave ``wave`` whose logits the check may read: one drawn
    from the seed in each of ``min(batch, check_requests)`` equal strata of
    the batch, drawn anew for each wave."""
    B = traffic["batch"]
    rng = np.random.default_rng(T.sub_seed(seed, T.SAMPLE, 2, wave))
    strata = np.array_split(np.arange(B), min(B, traffic["check_requests"]))
    return torch.tensor([int(rng.choice(s)) for s in strata], device=device)


class Server:
    """The program's model, weights, decode cache and captured step, and a
    ring of buffers that keeps the logits of some rows of recent waves for
    the check: those of each wave's ``rows`` (``kept_rows``), for the last
    ``len(ring)`` waves."""

    def __init__(self, api, params, traffic: dict):
        from repro_torch.serve.engine import DecodeGraph

        self.api, self.params = api, params
        self.B, self.cache_len = traffic["batch"], traffic["cache_len"]
        self.n_out = traffic["output_tokens"]
        self.cache = api.init_cache(self.B, self.cache_len)
        self.kv = torch.zeros((), dtype=torch.int32, device=api.device)
        self.step = (DecodeGraph(api.decode_step, params, self.cache)
                     if api.device.type == "cuda" else api.decode_step)
        self.n_rows = min(self.B, traffic["check_requests"])
        self.ring: list[torch.Tensor] = []
        self._held: list = [None] * (-(-traffic["check_requests"] // self.n_rows) + 2)

    def make_ring(self, dtype) -> None:
        shape = (self.n_rows, self.n_out, self.api.cfg.padded_vocab)
        self.ring = [torch.empty(shape, dtype=dtype, device=self.api.device)
                     for _ in self._held]

    def keep(self, wave) -> torch.Tensor:
        """The ring buffer ``wave`` writes its kept logits to; the wave that
        held it before loses them."""
        slot = wave.index % len(self.ring)
        if self._held[slot] is not None:
            self._held[slot].kept = None
        self._held[slot] = wave
        return self.ring[slot]

    def prefill(self, prompts):
        """(last-position logits, the prefill's cache)."""
        with record_function("portbench.prefill"):
            return self.api.prefill(self.params, {"tokens": prompts}, self.cache_len)

    def load(self, cache: dict, S: int) -> None:
        with record_function("portbench.cache_copy"):
            for name, dst in self.cache.items():
                dst.copy_(cache[name])
            self.kv.fill_(S)

    def decode(self, token):
        with record_function("portbench.decode_step"):
            logits, _ = self.step(self.params, self.cache, self.kv, token)
            self.kv.add_(1)
            return logits

    def emit(self, wave, j: int, logits):
        """Serve token ``j`` of every request of ``wave``: the greedy token,
        kept in ``wave.out``, its logits kept for the ring's rows."""
        with record_function("portbench.sample"):
            tok = greedy(logits)
            wave.out[:, j:j + 1].copy_(tok)
            if wave.kept is not None:
                wave.kept[:, j].copy_(logits.index_select(0, wave.rows))
            return tok


def setup(cell, seed: int, device: str = "cuda") -> Server:
    """Build the model, make the weights, and warm up: one prefill at the
    longest prompt, copied into the decode cache, and the graph's capture
    with a few replays."""
    from repro_torch.models.registry import build_model
    from repro_torch.train.loop import abstract_init

    api = build_model(port_config(cell.config), device)
    shapes, _ = abstract_init(api)
    _check_dtype(shapes, cell.config["dtype"])
    params = weights.make(shapes, seed, api.device)
    server = Server(api, params, cell.traffic)
    S = max(T.lengths(cell.traffic))
    prompts = T.prompts(cell.traffic, seed, WARMUP_WAVE, S, api.cfg.vocab_size,
                        api.device)
    logits, cache = server.prefill(prompts)
    server.make_ring(logits.dtype)
    server.load(cache, S)
    del cache
    for _ in range(3):
        logits = server.decode(greedy(logits))
    Marks(api.device).sync()
    return server


def _check_dtype(shapes: dict, dtype: str) -> None:
    """Refuse a model whose floating-point weights are not in the dtype the
    configuration file states."""
    want = getattr(torch, dtype)
    found = {t.dtype for t in weights.leaves(shapes) if t.is_floating_point()}
    if found != {want}:
        raise ValueError(f"weights in {sorted(map(str, found))}, the "
                         f"configuration states {dtype}")


@dataclasses.dataclass
class Stretch:
    """The traced part of a window: the profile and what ran in it."""
    profile: object
    prefills: list              # (B, S) of each prefill traced
    flash_routes: dict          # flash launches by route in the stretch
    decodes: list = dataclasses.field(default_factory=list)
    # (B, cached positions) of each decode step traced


def _flash_routes() -> dict:
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    return dict(flash_attention_cuda.launches_by_route)


class _Tracer:
    """Profiles ``trace_steps`` decode steps of the second wave (the first
    that follows another) from just before its decode step
    ``trace_from_step`` (0: before its prefill), with the device
    synchronised at both ends."""

    def __init__(self, marks: Marks, traffic: dict):
        self.marks = marks
        self.wave = 1
        self.from_step = traffic["trace_from_step"]
        self.steps = traffic["trace_steps"]
        self.stretch: Stretch | None = None
        self._range = None

    def start(self, wave: Wave, step: int) -> None:
        """Called before each prefill (step 0) and decode step."""
        if (wave.index, step) != (self.wave, self.from_step) or self.stretch:
            return
        from torch.profiler import ProfilerActivity, profile

        self.marks.sync()
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        prof.start()
        self._range = record_function("portbench.traced")
        self._range.__enter__()
        self.stretch = Stretch(prof, [], _flash_routes())

    def prefill(self, wave: Wave) -> None:
        if self._range is not None:
            self.stretch.prefills.append((wave.B, wave.S))

    def step(self, wave: Wave, j: int) -> None:
        """Called after decode step ``j`` of ``wave``."""
        if self._range is not None:
            self.stretch.decodes.append((wave.B, wave.S + j - 1))
            if len(self.stretch.decodes) >= self.steps:
                self.close()

    def close(self) -> None:
        if self._range is None:
            return
        self.marks.sync()
        self._range.__exit__(None, None, None)
        self._range = None
        after = _flash_routes()
        self.stretch.flash_routes = {k: after[k] - v
                                     for k, v in self.stretch.flash_routes.items()}
        self.stretch.profile.stop()


def window(server: Server, traffic: dict, seed: int, seconds: float,
           trace: bool = False) -> tuple[list[Wave], Stretch | None]:
    """Start waves until ``seconds`` have passed (on the host's clock, which
    runs at most ``LAG`` steps ahead of the device) and run every wave
    started to its last token, so that the window's work is whole waves.
    Returns the waves, their marks resolved to seconds from the window's
    start on the device's timeline, and the traced stretch (``trace``)."""
    device = server.api.device
    marks = Marks(device)
    vocab = server.api.cfg.vocab_size
    n_out = traffic["output_tokens"]
    lengths = T.schedule(traffic, seed, SCHEDULE)
    tracer = _Tracer(marks, traffic) if trace else None
    waves: list[Wave] = []
    pending: deque = deque()
    marks.sync()
    start, t0 = marks.mark(), time.perf_counter()

    def tick(m) -> None:
        """Keep the host within LAG marks of the device."""
        pending.append(m)
        if len(pending) > LAG:
            marks.wait(pending.popleft())

    while time.perf_counter() - t0 < seconds:
        i = len(waves)
        S = lengths[i]
        w = Wave(i, S, T.prompts(traffic, seed, i, S, vocab, device),
                 torch.empty((server.B, n_out), dtype=torch.int32, device=device),
                 kept_rows(traffic, seed, i, device))
        w.kept = server.keep(w)
        waves.append(w)
        if tracer:
            tracer.start(w, 0)
        w.start = marks.mark()
        logits, cache = server.prefill(w.prompts)
        tok = server.emit(w, 0, logits)
        w.marks.append(marks.mark())
        if tracer:
            tracer.prefill(w)
        tick(w.marks[-1])
        server.load(cache, S)
        del cache
        for j in range(1, n_out):
            if tracer:
                tracer.start(w, j)
            tok = server.emit(w, j, server.decode(tok))
            w.marks.append(marks.mark())
            if tracer:
                tracer.step(w, j)
            tick(w.marks[-1])
    if tracer:
        tracer.close()
    marks.sync()
    for w in waves:
        w.t_start = marks.seconds(start, w.start)
        w.t_tokens = [marks.seconds(start, m) for m in w.marks]
    return waves, tracer.stretch if tracer else None
