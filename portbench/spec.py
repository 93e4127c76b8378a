"""Find a cell, its configuration, its traffic and its metrics by name.

``BENCHMARK.json`` at the root names the cells and metrics; each cell's
traffic is ``workloads/<cell>.json``, each configuration
``configs/<config>.json`` and each metric's reader ``metrics/<metric>.py``
under this folder.  A cell that names a file that is not there fails here,
before any work.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


class SpecError(ValueError):
    """A cell, configuration or metric that cannot be found or read."""


@dataclasses.dataclass(frozen=True)
class Metric:
    name: str
    unit: str
    read: object          # the reader: (Run) -> float | None


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict          # configs/<config>.json
    traffic: dict         # workloads/<cell>.json
    end_to_end: list      # [Metric] this cell reports with --trace 0
    per_layer: list       # [Metric] this cell reports with --trace 1


def _json(path: Path) -> dict:
    try:
        return json.loads(path.read_text())
    except FileNotFoundError:
        raise SpecError(f"{path} is not there") from None


def load_reader(name: str, folder: Path):
    """``read`` of ``metrics/<name>.py``, loaded from its file."""
    path = folder / "metrics" / f"{name}.py"
    if not path.is_file():
        raise SpecError(f"metric {name!r} has no reader {path}")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if not callable(getattr(mod, "read", None)):
        raise SpecError(f"{path} defines no read(run)")
    return mod.read


def _metrics(entries: list, cell: str, folder: Path) -> list[Metric]:
    return [Metric(m["name"], m["unit"], load_reader(m["name"], folder))
            for m in entries if cell in m.get("workloads", [cell])]


def load_cell(name: str, folder: Path = HERE) -> Cell:
    """The cell ``name`` of the ``BENCHMARK.json`` beside ``folder``, with its
    configuration, traffic and metric readers."""
    bench = _json(folder.parent / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SpecError(f"no cell {name!r} in BENCHMARK.json")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    if w["config"] not in configs:
        raise SpecError(f"cell {name!r} names an unknown configuration {w['config']!r}")
    config = _json(folder.parent / configs[w["config"]]["file"])
    traffic = _json(folder / "workloads" / f"{name}.json")
    if traffic.get("config") != w["config"]:
        raise SpecError(f"workloads/{name}.json is for {traffic.get('config')!r}, "
                        f"the cell for {w['config']!r}")
    return Cell(name, w["chips"], config, traffic,
                _metrics(bench["end_to_end"], name, folder),
                _metrics(bench["per_layer"], name, folder))
