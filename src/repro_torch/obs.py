"""The port's spans: named stretches of a prefill and a decode step, for a
profiler to place on the device's timeline.  Off unless something reads
them.

``span(name)`` is a context manager that
- inside a capture opened by ``capture()`` (``serve.engine.DecodeGraph``)
  notes ``[name, first node, end node]`` of the graph being captured, from
  the number of nodes the graph holds when the span opens and when it
  closes.  A replay of a graph captured on one stream runs its nodes in the
  order they were made, so the k-th device activity of a traced replay is
  node k, and belongs to the innermost span whose range holds k;
- under a running ``torch.profiler`` enters
  ``record_function("repro_torch.<name>")``, on the profiler's own timeline
  beside the device intervals;
- otherwise is one shared null context.

The node counts come from the CUDA driver (``cuStreamGetCaptureInfo``,
``cuGraphGetNodes``) through ``ctypes``, loaded at the first capture.  ``maps`` keeps the
``NodeMap`` of every graph captured in the process, newest last, so that it
can be read after the graph is freed.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses

import torch

PREFIX = "repro_torch."
NULL = contextlib.nullcontext()
CAPTURE_ACTIVE = 1          # CU_STREAM_CAPTURE_STATUS_ACTIVE


@dataclasses.dataclass
class NodeMap:
    """The spans of one captured graph."""
    spans: list = dataclasses.field(default_factory=list)
    # [name, first node, end node] of each span, in the order they opened
    nodes: int = 0      # the graph's nodes when its capture ended


maps: list[NodeMap] = []
_open: tuple | None = None      # (graph handle, NodeMap) of the capture open
_driver: ctypes.CDLL | None = None


def span(name: str):
    """The span ``name`` as the module's docstring says: a node range, a
    profiler range or nothing."""
    if _open is not None:
        return _noted(name)
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(PREFIX + name)
    return NULL


@contextlib.contextmanager
def _noted(name: str):
    graph, m = _open
    entry = [name, _count(graph), None]
    m.spans.append(entry)
    yield
    entry[2] = _count(graph)


@contextlib.contextmanager
def capture():
    """Record the spans of the graph being captured on the current stream;
    yields its ``NodeMap``, which gets the graph's node count before the
    capture ends and is then appended to ``maps``."""
    global _open
    graph = _capturing_graph()
    m = NodeMap()
    _open = (graph, m)
    try:
        yield m
        m.nodes = _count(graph)
        maps.append(m)
    finally:
        _open = None


def _cuda() -> ctypes.CDLL:
    global _driver
    if _driver is None:
        lib = ctypes.CDLL("libcuda.so.1")
        p = ctypes.c_void_p
        ptr = ctypes.POINTER
        lib.cuStreamGetCaptureInfo_v2.argtypes = [
            p, ptr(ctypes.c_int), ptr(ctypes.c_uint64), ptr(p), ptr(p),
            ptr(ctypes.c_size_t)]
        lib.cuGraphGetNodes.argtypes = [p, p, ptr(ctypes.c_size_t)]
        for fn in (lib.cuStreamGetCaptureInfo_v2, lib.cuGraphGetNodes):
            fn.restype = ctypes.c_int
        _driver = lib
    return _driver


def _check(fn, *args) -> None:
    code = fn(*args)
    if code != 0:
        raise RuntimeError(f"{fn.__name__} failed: CUDA driver error {code}")


def _capturing_graph() -> ctypes.c_void_p:
    """The graph being captured on the current stream."""
    stream = torch.cuda.current_stream().cuda_stream
    status, graph = ctypes.c_int(), ctypes.c_void_p()
    _check(_cuda().cuStreamGetCaptureInfo_v2, stream, ctypes.byref(status),
           ctypes.byref(ctypes.c_uint64()), ctypes.byref(graph),
           ctypes.byref(ctypes.c_void_p()), ctypes.byref(ctypes.c_size_t()))
    if status.value != CAPTURE_ACTIVE:
        raise RuntimeError("obs.capture() outside a stream capture")
    return graph


def _count(graph) -> int:
    n = ctypes.c_size_t()
    _check(_cuda().cuGraphGetNodes, graph, None, ctypes.byref(n))
    return n.value


