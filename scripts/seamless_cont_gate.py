"""How far chip_smoke.py's continuation limit for seamless_m4t_medium
(TOL_CONT_LOGITS) sits from the model's own rounding and from a planted
fault.

For each seed, seamless_m4t_medium (full width and depth) gets fresh
random weights, frames and tokens at phase 11's sizes (chip_smoke.SEAMLESS:
8 x 512 frames, a 64-token prompt, 8 steps); prefill(64) + n eager decode
steps are held against the last logits of prefill(64 + n) over the same
frames, and so are the same steps with every sequence's cross K/V rolled
one along the batch axis (the planted fault).  It sets no gate; the last
line is one JSON object of the readings.  One card:

    python3 scripts/seamless_cont_gate.py --seeds 0 1 2 3
"""
import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as CS  # noqa: E402

ARCH = "seamless_m4t_medium"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.stderr.write("seamless_cont_gate.py: no CUDA card\n")
        return 1
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models.registry import build_model
    from repro_torch.serve.engine import tree_clone

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build(["flash_attention_wgmma"])
    B, S_enc, S, steps = (CS.SEAMLESS[k] for k in ("B", "S_enc", "S", "steps"))
    cache_len = S + steps + 1
    api = build_model(get_config(ARCH))
    rows = []
    for seed in args.seeds:
        gen = torch.Generator(device="cuda").manual_seed(seed)
        params, _ = api.init(gen)
        frames, tokens = CS.seamless_inputs(api.cfg, gen, B, S_enc, S + steps)
        with torch.inference_mode():
            _, cache = api.prefill(params, {"tokens": tokens[:, :S],
                                            "frames": frames}, cache_len=cache_len)
            bad = tree_clone(cache)
            CS.roll_cross(bad)
            decoded = CS.decode_logits(api.decode_step, params, cache, tokens, S, steps)
            faulted = CS.decode_logits(api.decode_step, params, bad, tokens, S, steps)
            full = CS.prefill_logits(api, params, {"frames": frames}, tokens, S,
                                     steps, cache_len)
        cont, fault = CS.near_tie(full, decoded), CS.near_tie(full, faulted)
        rows.append({"seed": seed, "cont_err": cont[0], "cont_gap": cont[3],
                     "cont_same": cont[1], "fault_err": fault[0],
                     "fault_same": fault[1], "tokens": cont[2],
                     "logit_abs": full.abs().mean().item(),
                     "logit_max": full.abs().max().item(),
                     "limit": CS.TOL_CONT_LOGITS[ARCH]})
        CS.log(json.dumps(rows[-1]))
        del params, cache, bad
        torch.cuda.empty_cache()
    CS.log(f"{ARCH}: continuation max|err| at most "
           f"{max(r['cont_err'] for r in rows):.4f}, planted fault at least "
           f"{min(r['fault_err'] for r in rows):.4f}, over seeds {args.seeds}")
    print(json.dumps({"rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
