"""The flash backward alone: chip_smoke.py's build check of the tensor-core
backward (HGMMA in the SASS of its D 64, D 128 and D 320 instances,
ptxas's registers and spills) and its phase-3 rows (``check_flash_bwd``:
every ``FLASH_BWD`` case against attention_bwd_ref on the route the rule
names, two calls bit-equal, kernel, CUDA-core kernel, plain, SDPA-backward
times and the bound; at D 320 the per-tile gate and its planted faults),
without the model phases, then each of the backward's kernels' device
time (delta, dK/dV, dQ) at TinyLlama's training shape and at gemma3_4b's
two training calls (D 320, with the window and without) from a
torch.profiler trace.  It holds the same limits as chip_smoke.py and exits non-zero where
that would.  One card, about a minute with the build:

    python3 scripts/flash_bwd_bench.py [--seed N]

The last line is one JSON object of the rows.
"""
import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as CS  # noqa: E402


def kernel_split(B, Sq, Sk, Hq, Hkv, D, causal, window, q_offset, calls=5) -> dict:
    """Device ms a call of each kernel a bf16 backward launches, from a
    torch.profiler trace of ``calls`` calls (lse from the forward)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.flash_attention.kernel import (flash_attention_bwd_cuda,
                                                            flash_attention_fwd_cuda)

    g = torch.Generator(device="cuda").manual_seed(0)
    q, do = (torch.randn(B, Sq, Hq, D, generator=g, device="cuda").bfloat16()
             for _ in range(2))
    k, v = (torch.randn(B, Sk, Hkv, D, generator=g, device="cuda").bfloat16()
            for _ in range(2))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    o, lse = flash_attention_fwd_cuda(q, k, v, with_lse=True, **kw)
    flash_attention_bwd_cuda(q, k, v, o, do, lse=lse, **kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            flash_attention_bwd_cuda(q, k, v, o, do, lse=lse, **kw)
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            name = (re.search(r"::(\w+)[<(]", e.key) or re.match(r"(.{0,48})", e.key))[1]
            out[name] = out.get(name, 0.0) + e.self_device_time_total / 1e3 / calls
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.stderr.write("flash_bwd_bench.py: no CUDA card\n")
        return 1
    from repro_torch.kernels import _build

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip().splitlines()[0]
    CS.log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    CS.check_bwd_sass(_build.build(["flash_attention", "flash_attention_wgmma",
                                     "flash_attention_bwd", "flash_attention_bwd_wgmma"]))
    rows = CS.check_flash_bwd(CS.Timer(), args.seed)
    split = {}
    for case in CS.FLASH_BWD:
        if case[-1].startswith(("tinyllama_1p1b training", "gemma3_4b training")):
            split[case[-1]] = kernel_split(*case[:9])
            CS.log(f"backward kernels at {case[:9]} ({case[-1]}), ms a call: " + "; ".join(
                f"{name} {ms:.4f}" for name, ms in split[case[-1]].items()))
    print(json.dumps({"card": card, "rows": rows, "kernels": split}, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
