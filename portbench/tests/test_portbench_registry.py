"""The harness finds a cell, its configuration, its traffic and its
metrics by name, from files alone; what it cannot find fails before any
work; and the measuring command refuses to run without a card."""

import json
import subprocess
import sys
import time

import pytest
import torch

from conftest import ROOT, WINDOW_S, add_cell
from portbench import measure, spec

READER = '''"""Waves the window started: a metric added as a file."""


def read(run):
    return float(len(run.waves))
'''
NEW_METRIC = {"name": "waves_started", "unit": "waves", "better": "higher",
              "source": "program_counter", "layer": "test", "moves": "out_tok_s"}


def test_every_cell_of_the_benchmark_loads():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"])
        assert cell.config["name"] == w["config"]
        assert {m.name for m in cell.end_to_end} >= {"setup_s", "out_tok_s"}
        assert cell.per_layer


def test_added_files_are_found_by_name(bench_copy):
    (bench_copy / "portbench" / "metrics" / "waves_started.py").write_text(READER)
    name = add_cell(bench_copy, "qwen2p5_14b",
                    metrics=[dict(NEW_METRIC, workloads=["tiny_qwen2p5_14b.chat"])])
    cell = spec.load_cell(name, folder=bench_copy / "portbench")
    assert cell.config["model"]["d_model"] == 128
    assert "waves_started" in [m.name for m in cell.per_layer]
    r = measure.run_cell(cell, 3, WINDOW_S, True, time.perf_counter(), device="cpu")
    assert r["metrics"]["waves_started"]["value"] >= 1
    assert r["correct"], r["check"]
    # the other cells do not report a metric listed for this cell alone
    other = spec.load_cell("starcoder2_7b.repo_decode", folder=bench_copy / "portbench")
    assert "waves_started" not in [m.name for m in other.per_layer]


def _edit(bench_copy, fn):
    path = bench_copy / "BENCHMARK.json"
    bench = json.loads(path.read_text())
    fn(bench)
    path.write_text(json.dumps(bench))


def test_unknown_configuration_fails_before_any_work(bench_copy):
    name = add_cell(bench_copy, "starcoder2_7b")

    def rename(bench):
        next(w for w in bench["workloads"] if w["name"] == name)["config"] = "nope"

    _edit(bench_copy, rename)
    with pytest.raises(spec.SpecError, match="unknown configuration"):
        spec.load_cell(name, folder=bench_copy / "portbench")


def test_unknown_metric_fails_before_any_work(bench_copy):
    name = add_cell(bench_copy, "starcoder2_7b",
                    metrics=[dict(NEW_METRIC, name="not_written")])
    with pytest.raises(spec.SpecError, match="no reader"):
        spec.load_cell(name, folder=bench_copy / "portbench")


def test_missing_traffic_or_cell_fails(bench_copy):
    name = add_cell(bench_copy, "starcoder2_7b")
    (bench_copy / "portbench" / "workloads" / f"{name}.json").unlink()
    with pytest.raises(spec.SpecError, match="not there"):
        spec.load_cell(name, folder=bench_copy / "portbench")
    with pytest.raises(spec.SpecError, match="no cell"):
        spec.load_cell("starcoder2_7b.nope", folder=bench_copy / "portbench")


def _command(*args, cwd=ROOT):
    return subprocess.run([sys.executable, "portbench/run.py", *args], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the refusal without one")


def test_command_refuses_without_a_card(no_card):
    p = _command("--workload", "starcoder2_7b.repo_decode", "--seed", str(2**31 + 5),
                 "--seconds", "1", "--trace", "0")
    assert p.returncode == 3, p.stderr
    assert p.stdout == ""
    assert "CUDA" in p.stderr


def test_command_refuses_an_unknown_cell():
    p = _command("--workload", "starcoder2_7b.nope", "--seed", "1", "--seconds", "1")
    assert p.returncode == 2 and p.stdout == ""
