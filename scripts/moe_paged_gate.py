"""How far chip_smoke.py's pinned paged-vs-dense limit (TOL_PAGED_PINNED)
sits from the MoE family's own rounding and from a faulty paged kernel.

For each seed, granite-MoE-3B (full width and depth) and DBRX-132B (full
width, chip_smoke.DBRX_LAYERS layers) get fresh random weights and tokens,
a prefill of 8 x 512 and a paged pool under a shuffled block table; then
chip_smoke.moe_routing runs 8 dense and paged decode steps and reports the
paged-vs-dense logit difference with each layer's experts pinned to the
dense path's, the same with the first page of every sequence dropped from
the paged kernel's view (a planted fault), and the mean |logit|.  It sets
no gate; the last line is one JSON object of the readings.  One card:

    python3 scripts/moe_paged_gate.py --seeds 0 1 2 3
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.stderr.write("moe_paged_gate.py: no CUDA card\n")
        return 1
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models import transformer as TF
    from repro_torch.models.registry import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build(["flash_attention_wgmma", "paged_attention_split"])
    B, S, cache_len, steps, page = 8, 512, 1024, 8, 128
    rows = []
    for arch in CS.MOE_ARCHS:
        cfg = get_config(arch)
        if arch == "dbrx_132b":
            cfg = dataclasses.replace(cfg, num_layers=CS.DBRX_LAYERS)
        api = build_model(cfg)
        for seed in args.seeds:
            gen = torch.Generator(device="cuda").manual_seed(seed)
            params, _ = api.init(gen)
            tokens = torch.randint(0, cfg.vocab_size, (B, S + steps),
                                   generator=gen, device="cuda")
            with torch.inference_mode():
                _, cache = api.prefill(params, {"tokens": tokens[:, :S]},
                                       cache_len=cache_len)
                paged = TF.lm_init_paged_cache(cfg, B, cache_len, page=page,
                                               device="cuda")
                CS.fill_paged_pool(cache, paged, torch.randperm(
                    B * cache_len // page, generator=gen, device="cuda"))
            r = CS.moe_routing(api, params, cache, paged, tokens,
                               S, steps)
            rows.append({"arch": arch, "seed": seed, "flips": sum(r["flips"]),
                         "pinned_err": r["pinned"][0], "pinned_gap": r["pinned"][3],
                         "fault_err": r["fault"][0], "logit_abs": r["logit_abs"],
                         "limit": CS.TOL_PAGED_PINNED[arch]})
            CS.log(json.dumps(rows[-1]))
            del params, cache, paged, r
            torch.cuda.empty_cache()
        del api
    for arch in CS.MOE_ARCHS:
        mine = [r for r in rows if r["arch"] == arch]
        CS.log(f"{arch}: pinned max|err| at most "
               f"{max(r['pinned_err'] for r in mine):.4f}, planted fault at "
               f"least {min(r['fault_err'] for r in mine):.4f}, over seeds "
               f"{args.seeds}")
    print(json.dumps({"rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
