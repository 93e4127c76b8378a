"""The gla_scan backward alone: chip_smoke.py's build check of both backward
libraries (HMMA in the SASS of the tensor-core one, ptxas's registers and
spills of each) and its phase-3 rows (``check_gla_bwd``: every ``GLA_BWD``
case against gla_scan_bwd_ref on the route the rule names, two calls
bit-equal, kernel, CUDA-core kernel, plain times and the bound), without the
model phases, then each backward kernel's device time at RWKV6's training
shape from a torch.profiler trace.  It holds the same limits as
chip_smoke.py and exits non-zero where that would.  One card, about a
minute with the build:

    python3 scripts/gla_bwd_bench.py [--seed N]

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


def kernel_split(B, H, S, K, V, calls=5) -> dict:
    """Device ms a call of each kernel a bf16 backward launches at (B, H, S,
    K, V), RWKV6's decay and chunk 128, from a torch.profiler trace of
    ``calls`` calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.ssm_scan.kernel import gla_scan_bwd_cuda

    g = torch.Generator(device="cuda").manual_seed(0)
    q, k = ((torch.randn(B, H, S, K, generator=g, device="cuda") * 0.5).bfloat16()
            for _ in range(2))
    v, do = (torch.randn(B, H, S, V, generator=g, device="cuda").bfloat16()
             for _ in range(2))
    w = -0.05 * torch.exp(torch.randn(B, H, S, K, generator=g, device="cuda"))
    gla_scan_bwd_cuda(q, k, v, w, do, None, 128)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            gla_scan_bwd_cuda(q, k, v, w, do, None, 128)
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
        sys.stderr.write("gla_bwd_bench.py: no CUDA card\n")
        return 1
    from repro_torch.kernels import _build

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip().splitlines()[0]
    CS.log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    CS.gla_bwd_ptxas(_build.build(["gla_scan_bwd", "gla_scan_bwd_mma"]))
    hmma = CS.sass_count(_build.lib_path("gla_scan_bwd_mma"), "HMMA")
    CS.log(f"SASS of gla_scan_bwd_mma: {hmma} HMMA instructions")
    if hmma == 0:
        raise SystemExit("gla_scan_bwd_mma has no tensor-core (HMMA) instruction")
    rows = CS.check_gla_bwd(CS.Timer(), args.seed)
    split = kernel_split(*CS.GLA_BWD[0][:5])
    CS.log(f"backward kernels at {CS.GLA_BWD[0][:5]}, ms a call: " + "; ".join(
        f"{name} {ms:.4f}" for name, ms in split.items()))
    print(json.dumps({"card": card, "rows": rows, "kernels": split}, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
