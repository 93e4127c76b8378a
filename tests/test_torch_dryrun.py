"""The port's dry run (``repro_torch.launch.dryrun``) on a fake process
group, held to the JAX package's dry run on 8 host devices.

Two subprocesses, each under a time limit: ``PORT`` traces reduced
TinyLlama and granite-MoE train steps (64 x 8) and a reduced TinyLlama
decode step on a fake (data 2, model 4) world of 8, one reduced cell of
each family through ``run_cell`` (records written to disk), and one
known redistribute under the counting mode; ``REFERENCE`` lowers and
compiles the two train cells with the reference's own shardings and runs
its ``analyze``.  The reference's mesh is built with ``Auto`` axes: JAX
0.9's ``jax.make_mesh`` makes ``Explicit`` ones, which its
``activation_sharding_scope`` refuses (the reason the two
``tests/test_dryrun_small.py`` tests fail).

Per-rank argument bytes must equal the reference's
``argument_size_in_bytes`` and ``model_flops_global`` its own; the port's
step must issue collectives and no ``broadcast`` or ``scatter`` (inputs
arrive placed).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
TRAIN = ("tinyllama_1p1b", "granite_moe_3b_a800m")
# One reduced cell of each family, on the fake (2, 4) world.
FAMILY_CELLS = [("tinyllama_1p1b", "prefill"), ("granite_moe_3b_a800m", "decode"),
                ("rwkv6_7b", "decode"), ("zamba2_1p2b", "prefill"),
                ("seamless_m4t_medium", "prefill"), ("gemma3_4b", "decode"),
                ("qwen2_vl_72b", "prefill")]

PORT = r"""
import dataclasses, json, os, sys
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from repro_torch.configs import ShapeConfig, SHAPES, get_config, reduced_config
from repro_torch.launch import dryrun

out_dir, family_cells = sys.argv[1], json.loads(sys.argv[2])
SHAPES["t64x8"] = ShapeConfig("t64x8", "train", 64, 8)
SHAPES["d64x8"] = ShapeConfig("d64x8", "decode", 64, 8)
SHAPES["p64x8"] = ShapeConfig("p64x8", "prefill", 64, 8)
# TinyLlama with 2 K/V heads of 8 q heads: 8 q heads over model's 4 ranks
# do not split into 2 K/V groups, so decode gathers q's heads first.
KV2 = dataclasses.replace(reduced_config(get_config("tinyllama_1p1b")),
                          num_heads=8, num_kv_heads=2)
dryrun.get_config = lambda arch: (KV2 if arch == "tinyllama_kv2" else
                                  reduced_config(get_config(arch)))
out = {}
with dryrun.fake_world(8):
    try:
        with dryrun.fake_world(8):
            pass
    except RuntimeError as e:
        out["refused"] = str(e)
    mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    for arch in ("tinyllama_1p1b", "granite_moe_3b_a800m"):
        out[arch] = dryrun.run_cell(arch, "t64x8", "test", out_dir, mesh=mesh,
                                    verbose=False)
    out["decode"] = dryrun.run_cell("tinyllama_1p1b", "d64x8", "test", out_dir,
                                    mesh=mesh, verbose=False)
    out["decode_kv2"] = dryrun.run_cell("tinyllama_kv2", "d64x8", "test", out_dir,
                                        mesh=mesh, verbose=False)
    for arch, kind in family_cells:
        dryrun.run_cell(arch, kind[0] + "64x8", "family", out_dir, mesh=mesh,
                        verbose=False)
    # A known redistribute under the counting mode: an fp32 (8, 16) tensor
    # sharded (Shard(0) on data, Shard(1) on model) made whole, then a
    # Partial sum on model reduced.
    groups = {mesh.get_group(a).group_name: a for a in mesh.mesh_dim_names}
    with FakeTensorMode():
        x = DTensor.from_local(torch.empty(4, 4), mesh, [Shard(0), Shard(1)],
                               run_check=False, shape=(8, 16), stride=(16, 1))
        p = DTensor.from_local(torch.empty(8, 16), mesh, [Replicate(), Partial()],
                               run_check=False)
        x.redistribute(mesh, [Replicate(), Replicate()])   # plan it first
        p.redistribute(mesh, [Replicate(), Replicate()])
        counter = dryrun._RankCounter(groups)
        with counter:
            x.redistribute(mesh, [Replicate(), Replicate()])
            p.redistribute(mesh, [Replicate(), Replicate()])
    out["hand"] = {"collectives": dryrun.collective_bytes(counter),
                   "by_axis": counter.coll_by_axis}
print(json.dumps(out, default=str))
"""

REFERENCE = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import SHAPES, ShapeConfig, get_config, reduced_config
from repro.distributed import sharding as sh
from repro.launch.dryrun import analyze
from repro.models.registry import build_model
from repro.optim import AdamWState
from repro.train.loop import TrainConfig, abstract_init, make_train_fn

mesh = jax.make_mesh((2, 4), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
SHAPES["t64x8"] = ShapeConfig("t64x8", "train", 64, 8)
out = {}
for arch in ("tinyllama_1p1b", "granite_moe_3b_a800m"):
    cfg = reduced_config(get_config(arch))
    api = build_model(cfg)
    shape = SHAPES["t64x8"]
    specs = api.input_specs(shape)
    pshapes, axes = abstract_init(api)
    step = make_train_fn(api, TrainConfig())
    pspecs = sh.sanitize_tree(sh.param_specs(axes, mesh, cfg), pshapes, mesh)
    opt_specs = AdamWState(P(), pspecs, pspecs)
    bspecs = sh.batch_specs(mesh, shape, cfg)
    in_b = sh.sanitize_tree({k: bspecs.get(k, P(sh.dp_axes(mesh), None))
                             for k in specs}, specs, mesh)
    ns = lambda t: jax.tree_util.tree_map(
        lambda s: NamedSharding(mesh, s), t, is_leaf=lambda x: isinstance(x, P))
    f32 = lambda p: jax.ShapeDtypeStruct(p.shape, jnp.float32)
    opt_shapes = AdamWState(jax.ShapeDtypeStruct((), jnp.int32),
                            jax.tree_util.tree_map(f32, pshapes),
                            jax.tree_util.tree_map(f32, pshapes))
    with mesh, sh.activation_sharding_scope(mesh):
        fn = jax.jit(step, in_shardings=(ns(pspecs), ns(opt_specs), None,
                                         ns(in_b), NamedSharding(mesh, P())),
                     out_shardings=(ns(pspecs), ns(opt_specs), None,
                                    ns({"loss": P(), "grad_norm": P(), "lr": P()})))
        lowered = fn.lower(pshapes, opt_shapes, None, specs,
                           jax.ShapeDtypeStruct((), jnp.int32))
        compiled = lowered.compile()
    out[arch] = analyze(lowered, compiled, mesh, cfg, "t64x8")
print(json.dumps(out, default=str))
"""


def _run(script, *args, env_extra=None):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), **(env_extra or {}))
    proc = subprocess.run([sys.executable, "-c", script, *args], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=400)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun_torch")
    rec = _run(PORT, str(out), json.dumps(FAMILY_CELLS),
               env_extra={"OMP_NUM_THREADS": "1"})
    return rec, out


@pytest.fixture(scope="module")
def reference():
    return _run(REFERENCE)


@pytest.mark.parametrize("arch", TRAIN)
def test_argument_bytes_equal_the_reference(port, reference, arch):
    got = port[0][arch]
    assert got["status"] == "ok", got.get("traceback")
    assert (got["memory_analysis"]["argument_size_bytes"]
            == reference[arch]["memory_analysis"]["argument_size_bytes"])


@pytest.mark.parametrize("arch", TRAIN)
def test_model_flops_equal_the_reference(port, reference, arch):
    assert port[0][arch]["model_flops_global"] == reference[arch]["model_flops_global"]


@pytest.mark.parametrize("arch", TRAIN)
def test_step_collectives_only(port, arch):
    """The step issues collectives, and none that places an input."""
    rec = port[0][arch]
    coll = rec["collectives"]
    assert rec["collective_bytes_per_chip"] > 0
    assert coll["all-gather"] > 0 and coll["n_all-gather"] > 0
    assert not any(k for k, v in coll.items()
                   if ("broadcast" in k or "scatter" in k and "reduce" not in k) and v)
    assert set(rec["collective_links"]) == {"data", "model"}
    assert all(v["link"] == "nvlink" for v in rec["collective_links"].values())


def test_roofline_terms_use_the_h100_constants(port):
    from repro_torch.launch import mesh
    rec = port[0]["tinyllama_1p1b"]
    assert rec["compute_s"] == rec["hlo_flops_per_chip"] / mesh.PEAK_FLOPS_BF16
    assert rec["memory_s"] == rec["hlo_bytes_per_chip"] / mesh.HBM_BW
    assert rec["collective_s"] == pytest.approx(
        rec["collective_bytes_per_chip"] / mesh.NVLINK_BW)
    assert rec["memory_analysis"]["generated_code_size_bytes"] is None
    assert rec["memory_analysis"]["temp_size_bytes"] > 0


@pytest.mark.parametrize("cell", ["decode", "decode_kv2"])
def test_decode_cell_is_ok(port, cell):
    """Reduced TinyLlama's decode step, and one whose q heads' shards do
    not split into its K/V groups (``sharding.splittable``)."""
    rec = port[0][cell]
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["hlo_flops_per_chip"] > 0 and rec["collective_bytes_per_chip"] > 0


@pytest.mark.parametrize("arch,kind", FAMILY_CELLS)
def test_one_cell_of_each_family_writes_an_ok_record(port, arch, kind):
    path = port[1] / f"{arch}__{kind[0]}64x8__family.json"
    rec = json.loads(path.read_text())
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["memory_analysis"]["argument_size_bytes"] > 0


def test_collective_bytes_of_a_known_redistribute(port):
    """(8, 16) fp32 sharded over both axes made whole: an all-gather over
    model whose result is 4 x 16 fp32 (256 bytes), then one over data of
    8 x 16 (512 bytes); the Partial sum on model: one all-reduce of 8 x 16
    fp32 (512 bytes)."""
    hand = port[0]["hand"]
    coll = hand["collectives"]
    assert coll["n_all-gather"] == 2 and coll["all-gather"] == 4 * 16 * 4 + 8 * 16 * 4
    assert coll["n_all-reduce"] == 1 and coll["all-reduce"] == 8 * 16 * 4
    assert hand["by_axis"] == {"model": 4 * 16 * 4 + 8 * 16 * 4, "data": 8 * 16 * 4}


def test_a_second_fake_world_is_refused(port):
    assert "process of its own" in port[0]["refused"]
