"""The reading of a traced stretch: busy time as a union, and each
``portbench.*`` range's device time from the intervals it launched."""

import pytest

from portbench import trace
from portbench.trace import Event


def _host(name, s, e, corr):
    return Event(name, False, s, e, corr, 0)


def _kernel(name, s, e, launched_by, call=0):
    return Event(name, True, s, e, call, launched_by)


def _stretch():
    """Two decode steps and a prefill, launched ahead of the device: each
    step's kernels run after its host range has closed, with idle time
    between them."""
    return [
        _host(trace.STRETCH, 0, 1000, 1),
        _host("portbench.prefill", 10, 30, 2),
        _host("aten::mm", 12, 14, 3),
        _host("cudaLaunchKernel", 12, 13, 900),        # a runtime call: never a launcher
        _host("portbench.decode_step", 40, 50, 4),
        _host("cudaGraphLaunch", 42, 48, 901),         # its graph, captured earlier
        _host("portbench.sample", 50, 55, 5),
        _host("aten::argmax", 51, 53, 6),
        _host("portbench.decode_step", 60, 70, 7),
        _kernel("gemm", 100, 300, 3),
        _kernel("gemm", 250, 320, 3),                  # overlaps: counted once
        _kernel("step_a", 400, 450, 99, call=901),     # linked to the capture's op
        _kernel("step_b", 450, 480, 99, call=901),
        _kernel("argmax", 500, 510, 6),
        _kernel("step_a", 600, 660, 7),
        _kernel("step_b", 700, 740, 7),                # idle 660-700 is not the step's
        _kernel("stray", 800, 805, 900),               # linked to a runtime id: nobody's
    ]


def test_ranges_own_the_intervals_they_launched():
    t = trace.from_events(_stretch())
    assert t.spans["portbench.prefill"] == [pytest.approx(220e-9)]
    assert t.spans["portbench.decode_step"] == [pytest.approx(80e-9),
                                                pytest.approx(100e-9)]
    assert t.spans["portbench.sample"] == [pytest.approx(10e-9)]
    assert t.busy_s == pytest.approx((220 + 80 + 10 + 60 + 40 + 5) * 1e-9)
    assert t.window_s == pytest.approx(1000e-9)


def test_no_stretch_or_no_device_work_reads_nothing():
    events = _stretch()
    assert trace.from_events(events[1:]) is None
    assert trace.from_events([e for e in events if not e.dev]) is None
