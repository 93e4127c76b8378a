"""Fault-tolerance example on the PyTorch port: crash mid-training, restore,
shrink the world.

Simulates a host failure at step 23 of a 40-step run with checkpoints every
10 steps: the supervisor restores step 20 from the DDS store, drops the
dead host (elastic shrink), and finishes; the replayed steps 20-22 give
their first pass's losses bit for bit.  Then an elastic RESTORE reshards
the final checkpoint onto a different data-parallel world size.

Run:  PYTHONPATH=src python examples/ckpt_restart_elastic_torch.py [--device cpu]
      (the card is the default device)
"""

import argparse
import dataclasses
import sys

sys.path.insert(0, "src")

import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.core.dds_server import DDSStorageServer, ServerConfig
from repro_torch.data.pipeline import BatchSpec, TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.distributed.fault_tolerance import TrainSupervisor
from repro_torch.models.registry import build_model
from repro_torch.storage.checkpoint import CheckpointManager
from repro_torch.train.loop import TrainConfig, Trainer


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = dataclasses.replace(reduced_config(get_config("tinyllama_1p1b")),
                              num_layers=2, d_model=64, num_heads=2,
                              num_kv_heads=2, head_dim=32, d_ff=128,
                              vocab_size=256)
    api = build_model(cfg, device)
    pipeline = TokenPipeline(BatchSpec(4, 32, cfg.vocab_size), seed=0)
    ckpt = CheckpointManager(DDSStorageServer(ServerConfig()), keep=3)
    trainer = Trainer(api, TrainConfig(peak_lr=1e-3, warmup_steps=4,
                                       total_steps=64),
                      pipeline, checkpoint_mgr=ckpt, ckpt_every=10,
                      generator=torch.Generator(device=device).manual_seed(0))

    failures = {23: "host2"}
    sup = TrainSupervisor(trainer, [f"host{i}" for i in range(4)],
                          inject_failure=lambda s: failures.pop(s, None))
    hist = sup.run(40)
    ev = sup.events[0]
    first = {}
    for rec in hist:
        first.setdefault(rec["step"], rec)
    replays = [rec for rec in hist if first[rec["step"]] is not rec]
    same = bool(replays) and all(rec == first[rec["step"]] for rec in replays)
    print(f"crash of {ev.host} at step {ev.step}: action={ev.action}")
    print(f"restored step {replays[0]['step']} from the DDS store, surviving "
          f"hosts={sup.hosts}")
    print(f"finished at step {trainer.step}, restarts={sup.restarts}")
    print(f"replayed steps {[rec['step'] for rec in replays]}: replayed steps "
          f"equal their first pass: {same}")

    # Elastic restore: re-shard the final checkpoint onto a 2-way world.
    latest = ckpt.latest_step()
    template = trainer.state()
    shard0 = ckpt.restore_elastic(latest, template, 0, 2)
    shard1 = ckpt.restore_elastic(latest, template, 1, 2)
    full = ckpt.restore(latest, template)
    w0 = shard0["params"]["embedding"]["embed"]
    w1 = shard1["params"]["embedding"]["embed"]
    wf = full["params"]["embedding"]["embed"]
    ok = torch.equal(torch.cat([w0, w1]), wf)
    print(f"elastic restore of step {latest} onto a 2-way FSDP world: shards "
          f"stitch exactly -> {ok}")
    if not (same and ok and sup.restarts == 1 and trainer.step == 40):
        raise SystemExit("the restart or the elastic restore went wrong")


if __name__ == "__main__":
    main()
