"""``TrainSupervisor`` (a verbatim copy, ``repro_torch.distributed.
fault_tolerance``) over the port's ``Trainer``, on the CPU.

The three cases of ``tests/test_fault_tolerance.py`` on the port: a crash
after a checkpoint (the supervisor restores it from the DDS store and the
lost steps replay, each bit-equal to its first pass), a restart with no
checkpoint, and the data pipeline repartitioned over a shrunk world.

Parity: the JAX supervisor over the JAX ``Trainer`` and the port's over the
port's, from the same JAX-initialised fp32 parameters and the same token
stream, under one failure schedule.  Events, restarts, the surviving hosts
and the final step are equal; each step's loss, grad norm and lr within
1e-4 relative, the Trainer tolerance of ``tests/test_torch_train.py``.

The port's ``Trainer`` takes ``generator=`` and ``params=``, which the
reference's lacks.  With no checkpoint the supervisor re-inits through
``init_train_state(trainer.api, trainer.tcfg)``; the Trainer's ``api.init``
gives its starting params for that (``loop._init_from_start``), where the
bare ``api.init(None)`` would draw seed 0's.  The last cases hold a
restart with no checkpoint to the run that was not interrupted, for both.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced_config
from repro.core.dds_server import DDSStorageServer as JaxDDSStorageServer
from repro.core.dds_server import ServerConfig as JaxServerConfig
from repro.data.pipeline import BatchSpec as JaxBatchSpec
from repro.data.pipeline import TokenPipeline as JaxTokenPipeline
from repro.distributed.fault_tolerance import TrainSupervisor as JaxTrainSupervisor
from repro.models.registry import build_model as jax_build_model
from repro.optim import adamw_init as jax_adamw_init
from repro.storage.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.train.loop import TrainConfig as JaxTrainConfig
from repro.train.loop import Trainer as JaxTrainer
from repro_torch.configs import get_config, reduced_config
from repro_torch.core.dds_server import DDSStorageServer, ServerConfig
from repro_torch.data.pipeline import BatchSpec, TokenPipeline
from repro_torch.distributed.fault_tolerance import TrainSupervisor
from repro_torch.interop import to_torch
from repro_torch.models.registry import build_model
from repro_torch.storage.checkpoint import CheckpointManager
from repro_torch.train.loop import TrainConfig, Trainer
from repro_torch.tree import leaf_paths

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"
TINY = dict(num_layers=2, d_ff=64, vocab_size=256, d_model=64, num_heads=2,
            num_kv_heads=2, head_dim=32)
TCFG = dict(peak_lr=1e-3, warmup_steps=2, total_steps=50)
B, S = 2, 16
TOL = 1e-4


def _cfgs():
    return (dataclasses.replace(reduced_config(get_config("tinyllama_1p1b")), **TINY),
            dataclasses.replace(jax_reduced_config(jax_get_config("tinyllama_1p1b")),
                                **TINY))


def _tiny_trainer(ckpt=True, ckpt_every=4, **kw):
    cfg, _ = _cfgs()
    cm = (CheckpointManager(DDSStorageServer(ServerConfig()), keep=2)
          if ckpt else None)
    return Trainer(build_model(cfg, CPU), TrainConfig(**TCFG),
                   TokenPipeline(BatchSpec(B, S, cfg.vocab_size), seed=0),
                   checkpoint_mgr=cm, ckpt_every=ckpt_every, **kw)


def _first_passes(history) -> dict:
    """step -> the first record of that step."""
    first = {}
    for rec in history:
        first.setdefault(rec["step"], rec)
    return first


def _replays_equal_first_passes(history) -> int:
    """Every replayed step's record equals its first pass bit for bit;
    returns the number of replays."""
    first, n = _first_passes(history), 0
    for i, rec in enumerate(history):
        if first[rec["step"]] is not rec:
            assert rec == first[rec["step"]], (i, rec, first[rec["step"]])
            n += 1
    return n


def test_crash_restart_resumes_from_checkpoint():
    trainer = _tiny_trainer()
    failures = {6: "host3"}  # crash at step 6 (after the step-4 checkpoint)
    sup = TrainSupervisor(trainer, [f"host{i}" for i in range(4)],
                          inject_failure=lambda s: failures.pop(s, None))
    hist = sup.run(10)
    assert sup.restarts == 1
    assert sup.events[0].kind == "crash" and sup.events[0].step == 6
    assert sup.events[0].action == "restart_shrunk"
    assert "host3" not in sup.hosts and len(sup.hosts) == 3   # elastic shrink
    # steps 4 and 5 replayed from the step-4 checkpoint, the same bits
    assert [h["step"] for h in hist] == list(range(6)) + list(range(4, 10))
    assert _replays_equal_first_passes(hist) == 2
    assert trainer.step == 10
    assert trainer.ckpt.latest_step() == 8


def test_restart_without_checkpoint_restarts_clean():
    trainer = _tiny_trainer(ckpt=True, ckpt_every=100)  # never checkpoints
    failures = {2: "host1"}
    sup = TrainSupervisor(trainer, ["host0", "host1"],
                          inject_failure=lambda s: failures.pop(s, None))
    hist = sup.run(5)
    assert sup.restarts == 1
    assert sup.events[0].action == "restart_shrunk"
    assert sup.hosts == ["host0"]
    assert trainer.step == 5
    assert [h["step"] for h in hist] == [0, 1, 0, 1, 2, 3, 4]
    assert _replays_equal_first_passes(hist) == 2


def test_restart_of_the_last_host_is_a_plain_restart():
    trainer = _tiny_trainer()
    failures = {5: "host0"}
    sup = TrainSupervisor(trainer, ["host0"],
                          inject_failure=lambda s: failures.pop(s, None))
    sup.run(6)
    assert sup.hosts == [] and sup.events[0].action == "restart"
    assert _replays_equal_first_passes(trainer.history) == 1


def test_elastic_world_resharding_data_pipeline():
    """After shrinking the world, ranks repartition the same global batch."""
    spec = BatchSpec(8, 16, 100)
    before = [TokenPipeline(spec, seed=7, rank=r, world=4).batch_at(3)
              for r in range(4)]
    after = [TokenPipeline(spec, seed=7, rank=r, world=2).batch_at(3)
             for r in range(2)]
    tot_b = np.concatenate([b["tokens"] for b in before])
    tot_a = np.concatenate([a["tokens"] for a in after])
    assert tot_b.shape[0] == tot_a.shape[0] == 8  # same global batch size
    assert [b["tokens"].shape for b in before] == [(2, 16)] * 4
    assert [a["tokens"].shape for a in after] == [(4, 16)] * 2


# ---------------------------------------------------------------------------
# Parity with the JAX supervisor.
# ---------------------------------------------------------------------------


def _jax_and_port(failures: dict, hosts: int, ckpt_every: int):
    cfg, jcfg = _cfgs()
    jt = JaxTrainer(jax_build_model(jcfg), JaxTrainConfig(**TCFG),
                    JaxTokenPipeline(JaxBatchSpec(B, S, cfg.vocab_size), seed=0),
                    checkpoint_mgr=JaxCheckpointManager(
                        JaxDDSStorageServer(JaxServerConfig()), keep=2),
                    ckpt_every=ckpt_every)
    jt.params = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jt.params)
    jt.opt = jax_adamw_init(jt.params)
    tt = _tiny_trainer(ckpt_every=ckpt_every,
                       params=to_torch(jax.device_get(jt.params), device=CPU))
    names = [f"host{i}" for i in range(hosts)]
    jsched, tsched = dict(failures), dict(failures)
    jsup = JaxTrainSupervisor(jt, names, inject_failure=lambda s: jsched.pop(s, None))
    tsup = TrainSupervisor(tt, names, inject_failure=lambda s: tsched.pop(s, None))
    return jsup, tsup


@pytest.mark.parametrize("failures,target", [({6: "host3"}, 10),
                                             ({5: "host1", 9: "host2"}, 11)])
def test_supervisor_matches_jax_supervisor(failures, target):
    jsup, tsup = _jax_and_port(failures, hosts=4, ckpt_every=4)
    jh, th = jsup.run(target), tsup.run(target)
    assert [dataclasses.astuple(e) for e in tsup.events] == \
        [dataclasses.astuple(e) for e in jsup.events]
    assert tsup.restarts == jsup.restarts == len(failures)
    assert tsup.hosts == jsup.hosts
    assert tsup.trainer.step == jsup.trainer.step == target
    assert len(th) == len(jh)
    for t, j in zip(th, jh):
        assert t["step"] == j["step"]
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(t[key], j[key], rtol=TOL, err_msg=key)
    assert _replays_equal_first_passes(th) == _replays_equal_first_passes(jh) > 0


# ---------------------------------------------------------------------------
# A restart with no checkpoint re-inits to the Trainer's start.
# ---------------------------------------------------------------------------


def _jax_params():
    _, jcfg = _cfgs()
    jparams, _ = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    return to_torch(jax.device_get(
        jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jparams)), device=CPU)


@pytest.mark.parametrize("start", ["params", "generator"])
def test_restart_without_checkpoint_reinits_to_the_trainers_start(start):
    """A Trainer started from JAX-initialised params (as the parity tests
    start it) or from a generator of seed 7: the supervisor's restart with
    no checkpoint replays steps 0-2 with the losses of their first pass,
    where seed 0's draw (``api.init(None)`` of the api the Trainer was
    given) is another start."""
    kw = ({"params": _jax_params()} if start == "params"
          else {"generator": torch.Generator().manual_seed(7)})
    trainer = _tiny_trainer(ckpt=False, **kw)
    first = {p: t.clone() for p, t in leaf_paths(trainer.params)}
    seed0 = dict(leaf_paths(build_model(_cfgs()[0], CPU).init(None)[0]))
    assert any(not torch.equal(first[p], seed0[p]) for p in first)
    failures = {3: "host1"}
    sup = TrainSupervisor(trainer, ["host0", "host1"],
                          inject_failure=lambda s: failures.pop(s, None))
    hist = sup.run(5)
    assert sup.events[0].action == "restart_shrunk" and trainer.step == 5
    assert [h["step"] for h in hist] == [0, 1, 2, 0, 1, 2, 3, 4]
    assert _replays_equal_first_passes(hist) == 3
    # the kept start is not the storage the steps update in place
    again = dict(leaf_paths(trainer.api.init(None)[0]))
    assert all(torch.equal(first[p], again[p]) for p in first)


def test_trainer_api_init_with_a_generator_draws_from_it():
    trainer = _tiny_trainer(ckpt=False, params=_jax_params())
    api = build_model(_cfgs()[0], CPU)
    got = leaf_paths(trainer.api.init(torch.Generator().manual_seed(3))[0])
    want = leaf_paths(api.init(torch.Generator().manual_seed(3))[0])
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(got, want))


def test_example_runs_on_the_cpu():
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "ckpt_restart_elastic_torch.py"),
         "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=240,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
             "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = proc.stdout
    assert "crash of host2 at step 23: action=restart_shrunk" in out
    assert "finished at step 40, restarts=1" in out
    assert "replayed steps equal their first pass: True" in out
    assert "shards stitch exactly -> True" in out
