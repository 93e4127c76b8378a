"""The port stands alone: it loads neither ``jax`` nor ``repro``, its copies
of the storage substrate and configs cannot drift from the originals, and
its entry points never run on the CPU unless asked to."""

import importlib
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
PORT = SRC / "repro_torch"

# Verbatim copies: the original under src/repro with "repro." rewritten.
COPIED = ([f"core/{m}.py" for m in (
    "__init__", "wire", "lifecycle", "qos", "vector", "ring", "cache_table",
    "file_service", "host_lib", "traffic", "offload", "client", "dds_server")]
    + [f"storage/{m}.py" for m in ("__init__", "blockdev", "pagestore")]
    + sorted(f"configs/{p.name}" for p in (SRC / "repro" / "configs").glob("*.py")))


def _port_modules() -> list[str]:
    import repro_torch
    return ["repro_torch"] + [
        m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]


def test_importing_every_port_module_loads_no_jax_or_repro():
    code = (
        "import importlib, sys\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'repro' or m.startswith('repro.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"},
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_no_file_imports_jax_or_repro():
    pat = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)", re.M)
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 30
    offenders = [str(f.relative_to(ROOT)) for f in files
                 if pat.search(f.read_text())]
    assert offenders == []


@pytest.mark.parametrize("rel", COPIED)
def test_copied_substrate_equals_original(rel):
    orig = (SRC / "repro" / rel).read_text()
    assert (PORT / rel).read_text() == re.sub(r"\brepro\.", "repro_torch.", orig)


def test_entry_points_refuse_the_cpu_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("checks a machine without CUDA")
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.device import resolve_device
    from repro_torch.interop import to_torch
    from repro_torch.launch import serve
    from repro_torch.models import transformer as TF
    from repro_torch.models.registry import build_model

    cfg = reduced_config(get_config("tinyllama_1p1b"))
    calls = [
        lambda: resolve_device(),
        lambda: TF.init_lm(cfg),
        lambda: TF.lm_init_cache(cfg, 1, 8),
        lambda: TF.lm_init_paged_cache(cfg, 1, 8),
        lambda: build_model(cfg),
        lambda: to_torch({"w": __import__("numpy").zeros(2)}),
        lambda: serve.main([]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="cuda"):
            call()
    assert resolve_device("cpu").type == "cpu"


def test_kernel_wrappers_refuse_cpu_tensors():
    """No kernel-to-plain fallback: the CUDA wrappers raise on CPU tensors."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch.kernels.paged_attention.kernel import paged_attention_cuda

    q = torch.zeros(1, 4, 2, 32)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, q, q)
    pool = torch.zeros(2, 4, 2, 32)
    with pytest.raises(ValueError, match="CUDA"):
        paged_attention_cuda(torch.zeros(1, 2, 32), pool, pool,
                             torch.zeros(1, 2, dtype=torch.int32),
                             torch.ones(1, dtype=torch.int32))
    assert importlib.import_module("repro_torch.kernels._build").BUILD_DIR \
        == ROOT / "build" / "torch_kernels"
