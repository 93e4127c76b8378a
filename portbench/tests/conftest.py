"""Shared fixtures of the benchmark's own tests, which run on the CPU.

``tiny_bench`` is a copy of ``portbench/`` and ``BENCHMARK.json`` in a
temporary folder with one more configuration and cell added as files: the
StarCoder2 or Qwen2.5 file cut to two layers of width 128, and a cell of
small waves.  Only the benchmark's tests use it; the measured cells are
untouched.
"""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

TINY = dict(num_layers=2, d_model=128, num_heads=4, head_dim=32, d_ff=256,
            vocab_size=512)
TINY_KV = {"starcoder2_7b": 1, "qwen2p5_14b": 2}
TINY_TRAFFIC = {"batch": 4, "prompt_len": {"from": 16, "to": 40, "step": 8},
                "output_tokens": 16, "cache_len": 56, "check_requests": 8,
                "trace_from_step": 0, "trace_steps": 10}
# The tiny cells' limit on the logits' relative error, from CPU readings
# over seeds 1-6 (two waves of four kept rows, 16 positions each): sound
# runs 0.0106-0.0125 (StarCoder2 cut as above) and 0.0166-0.0213 (Qwen2.5),
# the float8 control 0.0913-0.1064 and 0.1480-0.2112.
TINY_LIMIT = 0.05
WINDOW_S = 4.0    # long enough for several tiny waves on the CPU


def tiny_config(arch: str) -> dict:
    cfg = json.loads((ROOT / "portbench" / "configs" / f"{arch}.json").read_text())
    cfg["model"].update(TINY, num_kv_heads=TINY_KV[arch])
    return cfg


def add_cell(folder: Path, arch: str, limit: float = TINY_LIMIT, metrics=()) -> str:
    """Add ``tiny_<arch>`` and its cell ``tiny_<arch>.chat`` to the copy at
    ``folder`` as new files; ``metrics`` are per-layer entries to add."""
    name = f"tiny_{arch}"
    cfg = tiny_config(arch)
    cfg["name"] = name
    (folder / "portbench" / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    cell = f"{name}.chat"
    traffic = dict(TINY_TRAFFIC, config=name, limit={"logits_rel_err": limit, "served_not_argmax": 0})
    (folder / "portbench" / "workloads" / f"{cell}.json").write_text(json.dumps(traffic))
    bench = json.loads((folder / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": name, "source": "test", "reduced": [],
                             "file": f"portbench/configs/{name}.json", "why": "test"})
    bench["workloads"].append({"name": cell, "config": name, "traffic": "chat",
                               "chips": 1, "why": "test"})
    for m in bench["per_layer"]:
        m.get("workloads", []).append(cell)
    bench["per_layer"].extend(metrics)
    (folder / "BENCHMARK.json").write_text(json.dumps(bench))
    return cell


@pytest.fixture
def bench_copy(tmp_path) -> Path:
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    return tmp_path
