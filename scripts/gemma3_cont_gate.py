"""How far chip_smoke.py's continuation limits for gemma3_4b
(TOL_CONT_LOGITS, TOL_CONT_CACHE) sit from the model's own rounding and
from a planted fault.

For each seed, gemma3_4b (full width and depth) gets fresh random weights
and tokens at phase 12's sizes (chip_smoke.GEMMA: B 8, a 1536-token prompt
into a 2048-position cache, 8 steps); prefill(1536) + n eager decode steps
are held against the last logits of prefill(1536 + n), and the cache they
leave against prefill(1544)'s (``chip_smoke.ring_readings``), and so are
the same steps from a cache whose first local ring is rolled one slot (the
planted fault).  It sets no gate; the last line is one JSON object of the
readings.  One card:

    python3 scripts/gemma3_cont_gate.py --seeds 0 1 2 3
"""
import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as CS  # noqa: E402

ARCH = "gemma3_4b"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.stderr.write("gemma3_cont_gate.py: no CUDA card\n")
        return 1
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models.registry import build_model
    from repro_torch.serve.engine import tree_clone

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build(["flash_attention_wgmma"])
    B, S, cache_len, steps = (CS.GEMMA[k] for k in ("B", "S", "cache_len", "steps"))
    api = build_model(get_config(ARCH))
    rows = []
    for seed in args.seeds:
        gen = torch.Generator(device="cuda").manual_seed(seed)
        params, _ = api.init(gen)
        tokens = torch.randint(0, api.cfg.vocab_size, (B, S + steps),
                               generator=gen, device="cuda")
        with torch.inference_mode():
            _, cache = api.prefill(params, {"tokens": tokens[:, :S]},
                                   cache_len=cache_len)
            bad = tree_clone(cache)
            CS.ring_fault(bad)
            cont = CS.ring_readings(api, params, cache, tokens, S, steps, cache_len)
            fault = CS.ring_readings(api, params, bad, tokens, S, steps, cache_len)
        rows.append({"seed": seed, "cont_err": cont["logits"][0],
                     "cont_gap": cont["logits"][3], "cont_same": cont["logits"][1],
                     "cont_cache": max(cont["cache"].values()),
                     "fault_err": fault["logits"][0], "fault_same": fault["logits"][1],
                     "fault_cache": max(fault["cache"].values()),
                     "fault_cache_by_tensor": fault["cache"],
                     "tokens": cont["logits"][2], "logit_abs": cont["logit_abs"],
                     "logit_max": cont["logit_max"],
                     "limits": [CS.TOL_CONT_LOGITS[ARCH], CS.TOL_CONT_CACHE[ARCH]]})
        CS.log(json.dumps(rows[-1]))
        del params, cache, bad, cont, fault
        torch.cuda.empty_cache()
    CS.log(f"{ARCH}: continuation max|err| at most "
           f"{max(r['cont_err'] for r in rows):.4f} (logits), "
           f"{max(r['cont_cache'] for r in rows):.4f} (cache); planted fault at "
           f"least {min(r['fault_err'] for r in rows):.4f} (logits), "
           f"{min(r['fault_cache'] for r in rows):.4f} (cache), over seeds {args.seeds}")
    print(json.dumps({"rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
