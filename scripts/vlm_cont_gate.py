"""How far chip_smoke.py's limits for qwen2_vl_72b (TOL_PAGED_LOGITS,
TOL_CONT_LOGITS) sit from the model's own rounding and from a planted
fault.

For each seed, qwen2_vl_72b (full width, chip_smoke.VLM_LAYERS of its 80
layers) gets fresh random weights, tokens and a bf16 embeds prefix at
phase 13's sizes (chip_smoke.VLM: B 8, a 2048-token prompt whose first 512
positions are the prefix, a 2304-position cache, 8 steps, page 128).  From
the prefill's cache, 8 eager dense decode steps and 8 eager paged steps
over a pool laid out under a shuffled block table are held against each
other, and the dense steps against the last logits of prefill(2048 + n)
over the same prefix (``chip_smoke.vlm_continuation``), as are the same
steps after a prefill whose prefixes are rolled one sequence (the planted
fault).  It sets no gate; the last line is one JSON object of the readings.
One card:

    python3 scripts/vlm_cont_gate.py --seeds 0 1 2 3
"""
import argparse
import dataclasses
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as CS  # noqa: E402

ARCH = "qwen2_vl_72b"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.stderr.write("vlm_cont_gate.py: no CUDA card\n")
        return 1
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models import transformer as TF
    from repro_torch.models.registry import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build(["flash_attention_wgmma", "paged_attention_split"])
    B, S, cache_len, steps, page = (CS.VLM[k] for k in
                                    ("B", "S", "cache_len", "steps", "page"))
    api = build_model(dataclasses.replace(get_config(ARCH),
                                          num_layers=CS.VLM_LAYERS))
    cfg = api.cfg

    def paged_step(p_, c_, n_, t_):
        return TF.lm_decode_step_paged(p_, cfg, c_, n_, t_)

    rows = []
    for seed in args.seeds:
        gen = torch.Generator(device="cuda").manual_seed(seed)
        params, _ = api.init(gen)
        embeds = CS.vlm_embeds(cfg, gen, B, S)
        tokens = torch.randint(0, cfg.vocab_size, (B, S + steps), generator=gen,
                               device="cuda")
        with torch.inference_mode():
            _, cache = api.prefill(params, {"tokens": tokens[:, :S], "embeds": embeds},
                                   cache_len=cache_len)
            paged = TF.lm_init_paged_cache(cfg, B, cache_len, page=page, device="cuda")
            CS.fill_paged_pool(cache, paged, torch.randperm(
                B * cache_len // page, generator=gen, device="cuda"))
            dense = CS.decode_logits(api.decode_step, params, cache, tokens, S, steps)
            paged_lg = CS.decode_logits(paged_step, params, paged, tokens, S, steps)
            del cache, paged
            c = CS.vlm_continuation(api, params, tokens, embeds, dense, S, steps,
                                    cache_len)
        pd = CS.near_tie(dense, paged_lg)
        rows.append({"seed": seed, "paged_err": pd[0], "paged_gap": pd[3],
                     "paged_same": pd[1], "cont_err": c["cont"][0],
                     "cont_gap": c["cont"][3], "cont_same": c["cont"][1],
                     "fault_err": c["fault"][0], "fault_same": c["fault"][1],
                     "tokens": pd[2], "logit_abs": c["logit_abs"],
                     "logit_max": c["logit_max"],
                     "limits": [CS.TOL_PAGED_LOGITS[ARCH], CS.TOL_CONT_LOGITS[ARCH]]})
        CS.log(json.dumps(rows[-1]))
        del params, embeds, tokens, dense, paged_lg, c
        torch.cuda.empty_cache()
    CS.log(f"{ARCH} ({CS.VLM_LAYERS} layers): paged vs dense max|err| at most "
           f"{max(r['paged_err'] for r in rows):.4f}; continuation at most "
           f"{max(r['cont_err'] for r in rows):.4f}; planted fault at least "
           f"{min(r['fault_err'] for r in rows):.4f}, over seeds {args.seeds}")
    print(json.dumps({"rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
