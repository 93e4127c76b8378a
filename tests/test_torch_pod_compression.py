"""The port's compressed pod train step (``make_compressed_pod_train_fn``,
``init_pod_compression``), held to the JAX package's.

  * 8 gloo ranks as (pod 2, data 2, model 2), in a subprocess under a time
    limit (``tests/_torch_pod_cases.py``), against the reference's own
    script run in another (``REFERENCE``: 8 host devices, reduced
    TinyLlama with 2 layers and a vocab of 256, 6 steps on one fixed
    batch).  The reference's mesh is built with ``Auto`` axes: JAX 0.9's
    ``jax.make_mesh`` makes ``Explicit`` ones, which its
    ``activation_sharding_scope`` refuses (the reason
    ``tests/test_dryrun_small.py``'s copy fails).  The port starts from the
    reference's params (``interop``).  Its losses are held to the
    reference's within ``TOL_LOSS`` and must fall; two planted faults (the
    residuals dropped, the int8 payloads gathered over ``data`` instead of
    ``pod``) must fail that check; one step's collectives must include
    int8 all-gathers on the ``pod`` group.
  * The exchange alone, on fixed fp32 gradients and residuals sharded over
    each pod's submesh, is bit-equal to numpy's recomputation of the
    reference's ``exchange`` (``src/repro/train/loop.py:168-176``).
  * On a gloo world of one, the (1, 1, 1) step is bit-equal to the
    single-device ``make_train_fn(compress_pod_grads=True)`` step with a
    ``CompressionState``.
"""

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced_config
from repro.models.registry import build_model as jax_build_model
from repro_torch.interop import to_torch
from repro_torch.models.registry import build_model
from repro_torch.optim import adamw_init
from repro_torch.train.loop import (init_pod_compression, init_train_state,
                                    make_compressed_pod_train_fn, make_train_fn)
from repro_torch.tree import leaves

sys.path.insert(0, str(Path(__file__).resolve().parent))
import _torch_pod_cases as cases  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# The port's losses against the reference's, largest |difference| over the
# 6 steps (losses fall from 6.13 to 2.85).  Measured on the CPU: 6.2e-4 (the
# two packages round their bf16 matmuls differently); the planted faults read
# 3.3e-3 (residuals dropped: the error feedback's effect over 5 updates) and
# 0.48 (payloads gathered over data: each pod steps on its own gradient).
TOL_LOSS = 2e-3

REFERENCE = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses, json, re
import jax, jax.numpy as jnp
import numpy as np
from repro.configs import get_config, reduced_config
from repro.distributed import sharding as sh
from repro.models.registry import build_model
from repro.optim import adamw_init
from repro.train.loop import (TrainConfig, make_compressed_pod_train_fn,
                              init_pod_compression)

mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 3)
cfg = dataclasses.replace(reduced_config(get_config("tinyllama_1p1b")),
                          num_layers=2, vocab_size=256)
api = build_model(cfg)
params, axes = api.init(jax.random.PRNGKey(0))
opt = adamw_init(params)
comp = init_pod_compression(params, 2)
step = make_compressed_pod_train_fn(api, TrainConfig(peak_lr=1e-3,
                                                     warmup_steps=1,
                                                     total_steps=10), mesh)
rng = np.random.default_rng(0)
batch = {"tokens": jnp.asarray(rng.integers(0, 256, (8, 32)), jnp.int32),
         "labels": jnp.asarray(rng.integers(0, 256, (8, 32)), jnp.int32)}
with mesh, sh.activation_sharding_scope(mesh):
    fn = jax.jit(step)
    losses, norms = [], []
    for i in range(6):
        params, opt, comp, metrics = fn(params, opt, comp, batch,
                                        jnp.asarray(i, jnp.int32))
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    hlo = fn.lower(params, opt, comp, batch,
                   jnp.asarray(0, jnp.int32)).compile().as_text()
n_s8 = len(re.findall(r"s8\[[\d,]+\][^=]*all-gather", hlo))
print(json.dumps({"losses": losses, "grad_norms": norms, "s8_allgathers": n_s8}))
"""


def _jax_params():
    cfg = dataclasses.replace(jax_reduced_config(jax_get_config("tinyllama_1p1b")),
                              num_layers=cases.LAYERS, vocab_size=cases.VOCAB)
    params, _ = jax_build_model(cfg).init(jax.random.PRNGKey(0))
    return to_torch(jax.device_get(params), device="cpu")


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", REFERENCE], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def port():
    with tempfile.TemporaryDirectory() as tmp:
        params, out = os.path.join(tmp, "params.pt"), os.path.join(tmp, "out.pt")
        torch.save(_jax_params(), params)
        proc = subprocess.run(
            [sys.executable, str(ROOT / "tests" / "_torch_pod_cases.py"), params, out],
            cwd=ROOT, capture_output=True, text=True, timeout=300,
            env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
                 "OMP_NUM_THREADS": "1"})
        assert proc.returncode == 0, proc.stderr[-4000:]
        return torch.load(out, weights_only=False)


def _loss_err(got, want) -> float:
    return max(abs(a - b) for a, b in zip(got["losses"], want["losses"]))


def test_losses_match_the_reference_and_fall(port, reference):
    err = _loss_err(port["step"], reference)
    assert err <= TOL_LOSS, (port["step"]["losses"], reference["losses"])
    assert port["step"]["losses"][-1] < port["step"]["losses"][0]
    assert reference["s8_allgathers"] > 0


@pytest.mark.parametrize("fault", ["no_residual", "data_gather"])
def test_planted_fault_fails_the_loss_check(port, reference, fault):
    assert _loss_err(port["step"], reference) <= TOL_LOSS
    assert _loss_err(port[fault], reference) > TOL_LOSS, port[fault]["losses"]


def test_int8_payloads_are_gathered_over_pod(port):
    seen, pod = port["int8"]["seen"], port["int8"]["pod_group"]
    int8 = [(op, group) for op, dtype, group in seen if dtype == "torch.int8"]
    assert int8 and all(op.startswith("all_gather") and group == pod
                        for op, group in int8), seen


def _numpy_exchange(g, e):
    """The reference's ``exchange`` (src/repro/train/loop.py:168-176) for
    every pod at once, in numpy fp32: (mean gradient, new residuals)."""
    x = g.astype(np.float32) + e
    amax = np.abs(x).reshape(len(x), -1).max(1)
    s = (np.maximum(amax, np.float32(1e-12)) / np.float32(127.0)).astype(np.float32)
    sb = s.reshape((-1,) + (1,) * (x.ndim - 1))
    q = np.clip(np.round(x / sb), -127, 127).astype(np.int8)
    deq = q.astype(np.float32) * sb
    return deq.mean(0), x - deq


def test_exchange_is_bit_equal_to_numpy(port):
    g, e = cases.exchange_inputs()
    mean, new_e = _numpy_exchange(g, e)
    got = port["exchange"]
    for m in got["mean"]:                       # every rank of every pod
        np.testing.assert_array_equal(m, mean)
    for pod in range(len(g)):
        np.testing.assert_array_equal(got["new_e"][pod], new_e[pod])


@pytest.fixture(scope="module")
def world_of_one():
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("gloo", store=dist.FileStore(f"{tmp}/store", 1),
                                rank=0, world_size=1)
        try:
            from torch.distributed.device_mesh import init_device_mesh
            yield init_device_mesh("cpu", (1, 1, 1), mesh_dim_names=cases.AXES)
        finally:
            dist.destroy_process_group()


def test_one_pod_step_equals_the_single_device_compressed_step(world_of_one):
    api = build_model(cases.config(), "cpu")
    params = _jax_params()
    tcfg = dataclasses.replace(cases.train_config(), compress_pod_grads=True)
    plain = make_train_fn(api, tcfg)
    p, o, c, _ = init_train_state(api, tcfg, params=params)
    pod = make_compressed_pod_train_fn(api, tcfg, world_of_one)
    q, r, d = params, adamw_init(params), init_pod_compression(params, 1)
    for i in range(3):
        p, o, c, m = plain(p, o, c, cases.batch(), i)
        q, r, d, n = pod(q, r, d, cases.batch(), i)
        assert float(n["loss"].full_tensor()) == float(m["loss"])
        assert float(n["grad_norm"].full_tensor()) == float(m["grad_norm"])
    for a, b in zip(leaves(q), leaves(p)):
        assert torch.equal(a.full_tensor(), b)
    for a, b in zip(leaves(d.error), leaves(c.error)):
        assert torch.equal(a.full_tensor()[0], b)
