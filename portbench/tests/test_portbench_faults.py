"""The comparison that decides ``correct`` fails what it must.

Each test drives a whole run of a tiny cell on the CPU (the program's
eager step in place of its captured graph, as the program's own scheduler
does there), past the look for a card, and reads ``correct``.  A sound run
passes; so does nothing with the timed path broken underneath: a decode
step that leaves its cache as it was, half of the batch left out, or a
served token altered where it is sampled.  (One chip: no exchange between
chips to leave out.)  The float8 control, the reference in the program's
place one precision below bf16, fails the limit on the same sample.
"""

import time
from unittest import mock

import pytest
import torch

from conftest import TINY_LIMIT, WINDOW_S, add_cell
from portbench import check, faults, measure, serving, spec

SEEDS = (1, 2)


def _cell(bench_copy, arch):
    return spec.load_cell(add_cell(bench_copy, arch), folder=bench_copy / "portbench")


def _run(cell, seed):
    return measure.run_cell(cell, seed, WINDOW_S, False, time.perf_counter(), device="cpu")


@pytest.mark.parametrize("arch", ["starcoder2_7b", "qwen2p5_14b"])
@pytest.mark.parametrize("seed", SEEDS)
def test_sound_run_is_correct(bench_copy, arch, seed):
    r = _run(_cell(bench_copy, arch), seed)
    assert r["correct"], r["check"]
    assert r["failed"] == 0 and r["attempted"] >= 4
    assert list(r)[-1] == "check"


@pytest.mark.parametrize("arch", ["starcoder2_7b", "qwen2p5_14b"])
@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_broken_decode_step_is_not_correct(bench_copy, arch, fault):
    cell = _cell(bench_copy, arch)
    with faults.with_step(faults.FAULTS[fault]):
        r = _run(cell, SEEDS[0])
    assert not r["correct"], r["check"]


@pytest.mark.parametrize("arch", ["starcoder2_7b", "qwen2p5_14b"])
def test_altered_token_is_not_correct(bench_copy, arch):
    greedy = serving.greedy
    calls = []

    def altered(logits):
        tok = greedy(logits)
        calls.append(1)
        if len(calls) % 5 == 0:          # every fifth step
            tok = (tok + 1) % logits.shape[-1]
        return tok

    cell = _cell(bench_copy, arch)
    with mock.patch.object(serving, "greedy", altered):
        r = _run(cell, SEEDS[0])
    assert not r["correct"], r["check"]


@pytest.mark.parametrize("arch", ["starcoder2_7b", "qwen2p5_14b"])
@pytest.mark.parametrize("seed", SEEDS)
def test_float8_control_fails_the_limit(bench_copy, arch, seed):
    cell = _cell(bench_copy, arch)
    with torch.inference_mode():
        server = serving.setup(cell, seed, "cpu")
        waves, _ = serving.window(server, cell.traffic, seed, WINDOW_S)
        picked = check.sample(waves, cell.traffic, seed)
        got = check.readings(picked, server.params, cell.config["model"], control=True)
    assert sum(len(w.rows) for w in picked) >= cell.traffic["check_requests"]
    assert got["logits_rel_err"] > TINY_LIMIT


def test_kept_rows_are_drawn_for_each_wave():
    traffic = {"batch": 32, "check_requests": 8}
    rows = [serving.kept_rows(traffic, 2**31 + 9, i, "cpu").tolist() for i in range(6)]
    assert all(len(r) == 8 and len(set(r)) == 8 for r in rows)
    assert all(4 * k <= r[k] < 4 * (k + 1) for r in rows for k in range(8))
    assert len({tuple(r) for r in rows}) > 1
    assert rows == [serving.kept_rows(traffic, 2**31 + 9, i, "cpu").tolist()
                    for i in range(6)]
