"""Training launcher: ``python -m repro_torch.launch.train --arch <id> ...``

Selects an architecture config and runs ``Trainer`` steps with DDS
checkpoints and the deterministic token pipeline, on one device: the card
unless ``--device cpu``.  ``--reduced`` trains the reduced same-family
config (CPU-runnable); the default is the architecture at full width, and
``--layers N`` keeps its first N layers (rwkv6_7b's 32 need about 90 GB
of bf16 weights and gradients and fp32 moments; 6 fit one 80 GB card).
The storage server is sized to hold ``keep`` + 1 checkpoints of the train
state (``{params, mu, nu}``), where the reference's holds 1 GiB.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

from repro_torch.configs import ARCH_IDS, get_config, reduced_config
from repro_torch.core.dds_server import DDSStorageServer, ServerConfig
from repro_torch.data.pipeline import BatchSpec, TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.models.registry import build_model
from repro_torch.storage.checkpoint import CheckpointManager
from repro_torch.train.loop import TrainConfig, Trainer
from repro_torch.tree import leaves

KEEP = 3


def server_for(state, keep: int = KEEP) -> DDSStorageServer:
    """A DDS storage server with room for ``keep`` + 1 checkpoints of
    ``state`` and 1 GiB of slack, in whole segments."""
    seg = ServerConfig().segment_size
    nbytes = sum(t.numel() * t.element_size() for t in leaves(state))
    cap = -(-((keep + 1) * nbytes + (1 << 30)) // seg) * seg
    return DDSStorageServer(ServerConfig(device_capacity=cap))


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="tinyllama_1p1b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--reduced", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--layers", type=int, default=None,
                    help="keep this many layers (depth cut; width unchanged)")
    ap.add_argument("--compress-pod-grads", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    api = build_model(cfg, device)
    print(f"arch={cfg.name} family={cfg.family} "
          f"params~{cfg.param_count() / 1e9:.2f}B device={device}")

    pipeline = TokenPipeline(BatchSpec(args.batch, args.seq, cfg.vocab_size),
                             seed=0)
    tcfg = TrainConfig(peak_lr=args.lr, warmup_steps=max(2, args.steps // 10),
                       total_steps=args.steps, microbatch=args.microbatch,
                       compress_pod_grads=args.compress_pod_grads)
    trainer = Trainer(api, tcfg, pipeline, ckpt_every=args.ckpt_every)
    trainer.ckpt = CheckpointManager(server_for(trainer.state()), keep=KEEP)
    if trainer.restore_latest():
        print(f"resumed at step {trainer.step}")
    t0 = time.time()
    hist = trainer.run(args.steps)
    dt = time.time() - t0
    print(f"{args.steps} steps in {dt:.1f}s; "
          f"loss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}")


if __name__ == "__main__":
    main()
