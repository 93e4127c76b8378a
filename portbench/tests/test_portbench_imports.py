"""What the benchmark loads and opens.

No module that the harness, the program it drives or the reference loads
has the top-level name ``jax``, ``jaxlib``, ``flax`` or ``repro`` (each
module's name up to its first dot, compared whole: ``repro_torch`` is the
program, ``repro`` the JAX package); the reference loads nothing of the
program; and nothing opens the JAX-era ``benchmarks/`` or ``BENCH_*.json``.
"""

import json
import subprocess
import sys

from conftest import ROOT, add_cell

FOREIGN = {"jax", "jaxlib", "flax", "repro"}

RUN = r'''
import json, sys, time
from pathlib import Path
opened = []
sys.addaudithook(lambda ev, args: opened.append(str(args[0]))
                 if ev == "open" and isinstance(args[0], (str, Path)) else None)
sys.path[:0] = [{root!r}, {root!r} + "/src"]
from portbench import measure, spec
cell = spec.load_cell({cell!r}, folder=Path({folder!r}))
r = measure.run_cell(cell, 4, 4.0, False, time.perf_counter(), device="cpu")
print(json.dumps({{"modules": sorted(sys.modules), "opened": opened,
                   "correct": r["correct"]}}))
'''

REFERENCE = r'''
import json, sys
sys.path[:0] = [{root!r}]
import portbench.reference.decoder, portbench.reference.counts
print(json.dumps(sorted(sys.modules)))
'''


def _top(names):
    return {n.split(".")[0] for n in names}


def _python(code):
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=600, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax_and_opens_no_jax_benchmark(bench_copy):
    cell = add_cell(bench_copy, "starcoder2_7b")
    out = _python(RUN.format(root=str(ROOT), cell=cell,
                             folder=str(bench_copy / "portbench")))
    assert out["correct"]
    assert not _top(out["modules"]) & FOREIGN
    assert "repro_torch" in _top(out["modules"])
    bad = [p for p in out["opened"]
           if "/benchmarks/" in p or p.rsplit("/", 1)[-1].startswith("BENCH_")]
    assert not bad


def test_the_reference_loads_nothing_of_the_program():
    mods = _top(_python(REFERENCE.format(root=str(ROOT))))
    assert not mods & (FOREIGN | {"repro_torch"})


def test_no_source_of_the_harness_names_the_jax_benchmark():
    for path in (ROOT / "portbench").rglob("*.py"):
        if path.parent.name == "tests":
            continue
        text = path.read_text()
        assert "BENCH_" not in text and "benchmarks/" not in text, path
        assert "import jax" not in text and "from repro." not in text, path
