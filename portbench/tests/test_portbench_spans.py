"""The device self time of the program's spans (``spans.py``) and the four
metrics that read it, on synthetic profiler events: an eager prefill placed
by its ``repro_torch.*`` host ranges, and replays of a captured step placed
through a node map."""

import pytest

from conftest import tiny_config
from portbench import serving, spans, spec, trace
from portbench.measure import Run
from portbench.trace import Event
from repro_torch import obs

NS = 1e-9
MODEL = tiny_config("qwen2p5_14b")["model"]     # 2 layers, d 128, 4/2 heads of 32
PREFILLS, DECODES = [(2, 16)], [(4, 10), (4, 11)]
# The captured step's nodes: its spans' node ranges, in the order they
# opened, and each node's device time (ns) in a replay.  Nodes 0 (the
# embedding) and 7 (the write-back's copy) lie in no span.
SPANS = [["layer", 1, 4], ["attend", 2, 3], ["layer", 4, 7], ["attend", 5, 6]]
NODE_NS = [10, 20, 200, 30, 40, 300, 50, 5]


def _host(name, s, e, corr, linked=0):
    return Event(name, False, s, e, corr, linked)


def _dev(name, s, e, corr=0, linked=0):
    return Event(name, True, s, e, corr, linked)


def _prefill():
    """A prefill of two layers, each launching a product and, inside its
    attend span, flash; the cache's fill in between, in no span."""
    return [
        _host("portbench.prefill", 10, 100, 2),
        _host("repro_torch.layer", 12, 40, 4),
        _host("aten::mm", 13, 14, 10),
        _host("repro_torch.attend", 20, 30, 5),
        _host("cudaLaunchKernel", 21, 22, 900),
        _host("cudaLaunchKernel", 41, 42, 901),
        _host("repro_torch.layer", 50, 80, 6),
        _host("cudaLaunchKernel", 51, 52, 902),
        _host("repro_torch.attend", 60, 70, 7),
        _host("cudaLaunchKernel", 61, 62, 903),
        _dev("qkv", 1000, 1100, linked=10),
        _dev("flash", 1100, 1300, corr=900),
        _dev("cache_fill", 1300, 1350, corr=901),
        _dev("mlp", 1400, 1500, corr=902),
        _dev("flash", 1500, 1600, corr=903),
    ]


def _replay(at, corr, nodes=NODE_NS):
    """A decode step's range at host time ``at``: the graph's launch, the
    activities of its nodes from device time 10 * at, and an eager kernel
    after it (the counter's update)."""
    out = [_host("portbench.decode_step", at, at + 100, corr - 1),
           _host("cudaGraphLaunch", at + 10, at + 20, corr),
           _host("cudaLaunchKernel", at + 30, at + 31, corr + 1)]
    t = 10 * at
    for k, d in enumerate(nodes):
        out.append(_dev(f"node{k}", t, t + d, corr=corr))
        t += d
    return out + [_dev("kv_add", t, t + 5, corr=corr + 1)]


def _events(first=NODE_NS, second=NODE_NS):
    return ([_host(trace.STRETCH, 0, 10_000, 1)] + _prefill()
            + _replay(200, 950, first) + _replay(400, 960, second))


@pytest.fixture
def program(monkeypatch):
    """The program's node map; ``_events`` reads synthetic events in place
    of a profile."""
    monkeypatch.setattr(obs, "maps", [obs.NodeMap([list(s) for s in SPANS],
                                                  len(NODE_NS))])
    monkeypatch.setattr(spans, "_events", lambda profile: profile)
    return obs.maps


def _run(events):
    stretch = serving.Stretch(events, PREFILLS, {}, DECODES)
    return Run(MODEL, 1.0, 1.0, [], stretch, trace.from_events(events))


def _reader(name):
    return spec.load_reader(name, spec.HERE)


def test_eager_spans_own_what_they_launched_innermost_first():
    (got,) = spans.eager(_events(), spans.PREFILL)
    assert got == pytest.approx({"layer": 200 * NS, "attend": 300 * NS})


WANT = {"layer": 140 * NS, "attend": 500 * NS}


def test_a_replays_activities_are_the_maps_nodes(program):
    got, why = spans.replays(_events(), program[-1])
    assert got == [pytest.approx(WANT)] * 2 and why == ""


def test_a_replay_unlike_the_map_is_left_out(program, capsys):
    """A replay with a record lost is not read, and said; where no replay
    is whole, the decode metrics read nothing."""
    events = _events(second=NODE_NS[:-1])
    got, why = spans.replays(events, program[-1])
    assert got == [pytest.approx(WANT), None]
    assert why.startswith("replays [2] of 2 not read: device activities [7]")
    assert _reader("decode_attn_ms")(_run(events)) == pytest.approx(500 * NS * 1e3)
    assert "replays [2] of 2 not read" in capsys.readouterr().err
    events = _events(first=NODE_NS[1:], second=NODE_NS[:-1])
    for name in ("decode_attn_ms", "decode_attn_roofline", "decode_dense_roofline"):
        assert _reader(name)(_run(events)) is None
    assert "replays [1, 2] of 2 not read" in capsys.readouterr().err
    assert _reader("prefill_dense_mfu")(_run(events)) is not None


def _least(flops, nbytes):
    return max(flops / 989e12, nbytes / 3.35e12)


def test_the_readers_on_a_synthetic_run(program, capsys):
    run = _run(_events())
    L, H, KV, hd, d, ff = 2, 4, 2, 32, 128, 256
    assert _reader("decode_attn_ms")(run) == pytest.approx(500 * NS * 1e3)
    attn = sum(_least(4.0 * B * H * hd * L * (kv + 1),
                      2 * L * B * hd * (2 * (kv + 1) * KV + 2 * H))
               for B, kv in DECODES)
    assert _reader("decode_attn_roofline")(run) == pytest.approx(
        100 * attn / (1000 * NS))
    matmul = d * (H + 2 * KV) * hd + H * hd * d + 3 * d * ff
    vector = 2 * d + (H + 2 * KV) * hd
    dense = sum(_least(2.0 * B * L * matmul,
                       2 * (L * (matmul + vector) + 2 * L * B * KV * hd))
                for B, _ in DECODES)
    assert _reader("decode_dense_roofline")(run) == pytest.approx(
        100 * dense / (280 * NS))
    # the layers and their attention: 640 of each step's 660 ns
    assert "cover 96.97-96.97% of the device time of each of 2 replays of 8 nodes" \
        in capsys.readouterr().err
    B, S = PREFILLS[0]
    assert _reader("prefill_dense_mfu")(run) == pytest.approx(
        100 * 2.0 * B * S * L * matmul / (200 * NS * 989e12))


def test_a_program_without_spans_reads_nothing(program, monkeypatch, capsys):
    program.clear()
    events = [e for e in _events() if not e.name.startswith(spans.PREFIX)]
    for name in ("decode_attn_ms", "decode_attn_roofline",
                 "decode_dense_roofline", "prefill_dense_mfu"):
        assert _reader(name)(_run(events)) is None
    err = capsys.readouterr().err
    assert "captured no graph" in err and "0 of 1 traced prefills" in err
