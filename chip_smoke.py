#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

Phases, each of which exits non-zero on failure:
  1. setup: the card's name and power limit, torch and CUDA versions, TF32
     off for matmuls and cuDNN;
  2. build both CUDA kernels from src/repro_torch/csrc (one nvcc each, all
     started together) into build/torch_kernels/;
  3. each kernel against its plain PyTorch version at the main path's
     shapes: max |err| beside the tolerance, and kernel, plain, library
     (where one call computes the same function) and bound times;
  4. the main path: full-width, full-depth TinyLlama (random weights from
     the seed) -- prefill of 8 x 512 tokens through the flash kernel, dense
     decode, then paged decode through the paged kernel from a pool laid
     out under a shuffled block table, held against the dense decode; a
     reduced model on the card is first held against the CPU path;
  5. BatchScheduler serving 16 requests over 4 slots at full width;
  6. PagedKVEngine: real K pages of the card's pool spill to the DDS page
     store (host path) and come back bit-exact through the DPU offload path.
The second-to-last line is a JSON object with one entry per kernel; the
last is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_BF16_FLOPS = 989e12        # dense tensor-core bf16, H100 SXM data sheet
TOL_BF16 = 2e-2                 # kernel vs plain version, bf16 in and out
TOL_FP32 = 1e-4                 # reduced model on the card vs the CPU path
# Paged against dense decode of the full model in bf16: the two attention
# paths round differently and the difference grows through 22 layers; an
# H100 measured 0.072 at seed 0, and this allows 3.5 times that.
TOL_PAGED_LOGITS = 0.25


def log(msg: str) -> None:
    print(msg, flush=True)


def tree_to(tree, device, dtype=None):
    if isinstance(tree, dict):
        return {k: tree_to(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        t = tree.to(device)
        return t.to(dtype) if dtype is not None and t.is_floating_point() else t
    return tree


class Timer:
    """Device time of one call, median over launches, with the 50 MB L2
    evicted before each launch as the main path finds it (every layer
    reads other weights and another layer's cache in between)."""

    def __init__(self):
        self.flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")

    def ms(self, fn, iters: int = 20, warmup: int = 3) -> float:
        for _ in range(warmup):
            fn()
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
        for start, end in ev:
            self.flush.zero_()
            start.record()
            fn()
            end.record()
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in ev)


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, flops / H100_BF16_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions.
# ---------------------------------------------------------------------------


def flash_pairs(Sq, Sk, causal, window, q_offset) -> int:
    """Unmasked (query, key) pairs: the work this call's masks leave."""
    q = np.arange(Sq)[:, None] + q_offset
    k = np.arange(Sk)[None, :]
    m = np.ones((Sq, Sk), bool)
    if causal:
        m &= k <= q
    if window is not None:
        m &= k > q - window
    return int(m.sum())


def check_flash(gen, timer) -> dict:
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch.kernels.flash_attention.ops import flash_attention_xla

    # B, Sq, Sk, Hq, Hkv, D, causal, window; the first is the prefill shape.
    cases = [(8, 512, 512, 32, 4, 64, True, None),
             (8, 500, 500, 32, 4, 64, True, None),
             (8, 512, 512, 32, 4, 64, True, 128),
             (8, 128, 512, 32, 4, 64, False, None)]
    rows = []
    for B, Sq, Sk, Hq, Hkv, D, causal, window in cases:
        q = torch.randn(B, Sq, Hq, D, generator=gen, device="cuda").bfloat16()
        k = torch.randn(B, Sk, Hkv, D, generator=gen, device="cuda").bfloat16()
        v = torch.randn(B, Sk, Hkv, D, generator=gen, device="cuda").bfloat16()
        kw = dict(causal=causal, window=window, q_offset=0 if causal else None)
        out = flash_attention_cuda(q, k, v, **kw)
        torch.cuda.synchronize()
        ref = flash_attention_xla(q, k, v, **kw)
        err = max_err(out, ref)
        ok = bool(torch.isfinite(out.float()).all()) and err <= TOL_BF16
        q_off = 0 if causal else Sk - Sq
        flops = 4 * D * B * Hq * flash_pairs(Sq, Sk, causal, window, q_off)
        nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
        bnd, by = bound_ms(nbytes, flops)
        row = dict(case=(B, Sq, Sk, Hq, Hkv, D, causal, window), err=err, ok=ok,
                   ms=timer.ms(lambda: flash_attention_cuda(q, k, v, **kw)),
                   plain_ms=timer.ms(lambda: flash_attention_xla(q, k, v, **kw),
                                     iters=5),
                   bound_ms=bnd, bound_by=by, library_ms=None)
        if not rows:  # SDPA as the yardstick at the prefill shape only
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            sdpa = torch.nn.functional.scaled_dot_product_attention
            row["library_ms"] = timer.ms(
                lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True))
        log(f"flash {row['case']}: max|err| {err:.3e} (tol {TOL_BF16}) "
            f"kernel {row['ms']:.4f} ms plain {row['plain_ms']:.4f} ms "
            f"library {row['library_ms']} ms bound {bnd:.4f} ms ({by})")
        rows.append(row)
    if not all(r["ok"] for r in rows):
        raise SystemExit("flash_attention kernel disagrees with its plain version")
    return rows[0]


def check_paged(gen, timer) -> dict:
    from repro_torch.kernels.paged_attention.kernel import paged_attention_cuda
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref

    B, Hq, Hkv, D, page, max_len = 8, 32, 4, 64, 128, 1024
    maxp = max_len // page
    P = B * maxp
    q = torch.randn(B, Hq, D, generator=gen, device="cuda").bfloat16()
    kp = torch.randn(P, page, Hkv, D, generator=gen, device="cuda").bfloat16()
    vp = torch.randn(P, page, Hkv, D, generator=gen, device="cuda").bfloat16()
    table = torch.randperm(P, generator=gen, device="cuda").int().view(B, maxp)
    seq_lens = torch.randint(1, max_len + 1, (B,), generator=gen,
                             device="cuda", dtype=torch.int32)
    seq_lens[0] = max_len
    out = paged_attention_cuda(q, kp, vp, table, seq_lens)
    torch.cuda.synchronize()
    ref = paged_attention_ref(q, kp, vp, table, seq_lens)
    err = max_err(out, ref)
    rows = int(seq_lens.sum().item())
    nbytes = (2 * rows * Hkv * D * 2 + 2 * 2 * q.numel()
              + 4 * (table.numel() + B))
    bnd, by = bound_ms(nbytes, 4 * rows * Hq * D)
    row = dict(err=err, ms=timer.ms(
        lambda: paged_attention_cuda(q, kp, vp, table, seq_lens)),
        plain_ms=timer.ms(
            lambda: paged_attention_ref(q, kp, vp, table, seq_lens), iters=5),
        bound_ms=bnd, bound_by=by, library_ms=None)
    log(f"paged B {B} Hq {Hq} Hkv {Hkv} D {D} page {page} seq_lens "
        f"{seq_lens.tolist()}: max|err| {err:.3e} (tol {TOL_BF16}) kernel "
        f"{row['ms']:.4f} ms plain {row['plain_ms']:.4f} ms bound "
        f"{bnd:.4f} ms ({by}); no single PyTorch call pages")
    if not (torch.isfinite(out.float()).all() and err <= TOL_BF16):
        raise SystemExit("paged_attention kernel disagrees with its plain version")
    return row


# ---------------------------------------------------------------------------
# Phase 4: the main path at full width.
# ---------------------------------------------------------------------------


def fill_paged_pool(cache: dict, paged: dict, perm: torch.Tensor) -> None:
    """Lay a dense cache (L, B, S, KV, hd) into the pool under a shuffled
    block table: logical page j of the flattened (sequence, page) grid goes
    to physical page perm[j]."""
    page = paged["page"]
    L, B, S, KV, hd = cache["k"].shape
    n = S // page
    paged["block_table"] = perm.int().view(B, n).contiguous()
    for name in ("k", "v"):
        paged[f"{name}_pool"][:, perm] = cache[name].reshape(L, B * n, page, KV, hd)


def check_reduced_against_cpu(seed: int) -> None:
    """A 2-layer reduced TinyLlama in fp32: the card (both kernels) against
    the CPU path (their plain versions) on the same weights and tokens."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models import transformer as TF

    cfg = dataclasses.replace(reduced_config(get_config("tinyllama_1p1b")),
                              num_layers=2)
    params, _ = TF.init_lm(cfg, torch.Generator().manual_seed(seed), "cpu")
    cpu_p = tree_to(params, "cpu", torch.float32)
    gpu_p = tree_to(params, "cuda", torch.float32)
    tok = torch.randint(0, cfg.vocab_size, (2, 20),
                        generator=torch.Generator().manual_seed(seed))
    worst = 0.0
    outs = {}
    for dev, p in (("cpu", cpu_p), ("cuda", gpu_p)):
        t = tok.to(dev)
        logits, cache = TF.lm_prefill(p, cfg, t[:, :16], cache_len=20)
        paged = TF.lm_init_paged_cache(cfg, 2, 20, page=4,
                                       dtype=torch.float32, device=dev)
        fill_paged_pool(cache, paged, torch.arange(10, device=dev).flip(0))
        seq = [logits]
        for s in range(16, 20):
            seq.append(TF.lm_decode_step_paged(p, cfg, paged, s,
                                               t[:, s:s + 1])[0])
        outs[dev] = [x.float().cpu() for x in seq]
    for a, b in zip(outs["cpu"], outs["cuda"]):
        worst = max(worst, max_err(a, b))
    log(f"reduced model, card vs CPU path (fp32, prefill + 4 paged steps): "
        f"max|err| {worst:.3e} (tol {TOL_FP32})")
    if worst > TOL_FP32:
        raise SystemExit("reduced model on the card disagrees with the CPU path")


def main_path(api, params, gen, flash_cuda, paged_cuda, B=8, S=512,
              cache_len=1024, steps=8, page=128) -> dict:
    from repro_torch.models import transformer as TF

    cfg, dev = api.cfg, api.device
    tokens = torch.randint(0, cfg.vocab_size, (B, S + steps), generator=gen,
                           device=dev)
    with torch.inference_mode():
        # Warm-up: the first call of each matmul shape pays one-time library
        # set-up that a serving process pays once.
        _, warm = api.prefill(params, {"tokens": tokens[:, :S]},
                              cache_len=cache_len)
        api.decode_step(params, warm, S, tokens[:, S:S + 1])
        del warm
        flash_cuda.launches = paged_cuda.launches = 0
        sync(dev)
        t0 = time.perf_counter()
        logits, cache = api.prefill(params, {"tokens": tokens[:, :S]},
                                    cache_len=cache_len)
        sync(dev)
        prefill_s = time.perf_counter() - t0
        if flash_cuda.launches != cfg.num_layers or paged_cuda.launches:
            raise SystemExit(f"prefill launched flash {flash_cuda.launches} and "
                             f"paged {paged_cuda.launches} times")
        if (tuple(logits.shape) != (B, cfg.padded_vocab)
                or not torch.isfinite(logits.float()).all()):
            raise SystemExit(f"prefill logits {tuple(logits.shape)} not finite")
        paged = TF.lm_init_paged_cache(cfg, B, cache_len, page=page,
                                       device=dev)
        perm = torch.randperm(B * cache_len // page, generator=gen, device=dev)
        fill_paged_pool(cache, paged, perm)

        dense_logits, paged_logits = [], []
        sync(dev)
        t0 = time.perf_counter()
        for t in range(S, S + steps):
            lg, cache = api.decode_step(params, cache, t, tokens[:, t:t + 1])
            dense_logits.append(lg.float())
        sync(dev)
        dense_s = (time.perf_counter() - t0) / steps
        t0 = time.perf_counter()
        for t in range(S, S + steps):
            lg, paged = TF.lm_decode_step_paged(params, cfg, paged, t,
                                                tokens[:, t:t + 1])
            paged_logits.append(lg.float())
        sync(dev)
        paged_s = (time.perf_counter() - t0) / steps
    counts = {"flash_attention": flash_cuda.launches,
              "paged_attention": paged_cuda.launches}
    if counts != {"flash_attention": cfg.num_layers,
                  "paged_attention": cfg.num_layers * steps}:
        raise SystemExit(f"main path launches {counts}")
    d, p = torch.stack(dense_logits), torch.stack(paged_logits)
    err = max_err(d, p)
    # A greedy token may differ only where the dense logits of the two
    # candidates are a near-tie, within the logits tolerance.
    td, tp = d.argmax(-1, keepdim=True), p.argmax(-1, keepdim=True)
    gap = (d.gather(-1, td) - d.gather(-1, tp)).abs()
    same = int((td == tp).sum().item())
    log(f"main path {cfg.name} L{cfg.num_layers} d{cfg.d_model}: prefill "
        f"{B}x{S} {prefill_s * 1e3:.3f} ms, dense decode {dense_s * 1e3:.3f} "
        f"ms/step, paged decode {paged_s * 1e3:.3f} ms/step, launches {counts}")
    log(f"paged vs dense decode logits over {steps} steps: max|err| {err:.4f} "
        f"(tol {TOL_PAGED_LOGITS}); greedy tokens equal {same}/{td.numel()}, "
        f"largest dense-logit gap where they differ {gap.max().item():.4f}")
    if not (torch.isfinite(p).all() and err <= TOL_PAGED_LOGITS
            and gap.max().item() <= TOL_PAGED_LOGITS):
        raise SystemExit("paged decode disagrees with dense decode")
    if dev.type == "cuda":
        with torch.inference_mode():
            for label, step in (
                    ("prefill", lambda t: api.prefill(
                        params, {"tokens": tokens[:, :S]}, cache_len=cache_len)),
                    ("dense decode", lambda t: api.decode_step(
                        params, cache, t, tokens[:, t:t + 1])),
                    ("paged decode", lambda t: TF.lm_decode_step_paged(
                        params, cfg, paged, t, tokens[:, t:t + 1]))):
                profile_steps(label, step, S + steps - 2, 2)
    return {"counts": counts, "paged": paged}


def profile_steps(label: str, step, t0: int, n: int) -> None:
    """Device busy share and kernel launches of ``n`` steps, from a
    torch.profiler trace (the positions rewrite what the steps wrote).
    Busy time sums the device's own events only: a CPU op's self device
    time repeats that of the kernels it launched."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    wall = time.perf_counter()
    for t in range(t0, t0 + n):
        step(t)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - wall) / n * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for t in range(t0, t0 + n):
            step(t)
        torch.cuda.synchronize()
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3 / n
    launches = sum(e.count for e in events
                   if e.key in ("cudaLaunchKernel", "cuLaunchKernelEx")) / n
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:4]
    log(f"{label} step: wall {wall:.3f} ms, device busy {busy:.3f} ms "
        f"(idle {100 * (1 - busy / wall):.1f}%), {launches:.0f} launches; top: "
        + "; ".join(f"{e.key[:48]} {e.self_device_time_total / 1e3 / n:.3f} ms"
                    for e in top))


# ---------------------------------------------------------------------------
# Phases 5 and 6: serving and DDS KV paging.
# ---------------------------------------------------------------------------


def serve_batch(api, params, name: str, cache_len: int = 256) -> None:
    from repro_torch.serve.engine import BatchScheduler, Request

    n_req, slots, max_new = 16, 4, 16
    sched = BatchScheduler(api, params, slots=slots, cache_len=cache_len)
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(0, api.cfg.vocab_size, size=4),
                    max_new=max_new) for i in range(n_req)]
    for r in reqs:
        sched.submit(r)
    sync(api.device)
    t0 = time.perf_counter()
    done = steps = 0
    while done < n_req and steps < 1000:
        done += sched.step()
        steps += 1
    sync(api.device)
    dt = time.perf_counter() - t0
    if done != n_req or any(len(r.generated) != max_new for r in reqs):
        raise SystemExit(f"BatchScheduler completed {done}/{n_req} requests")
    log(f"BatchScheduler: {n_req} requests x {max_new} tokens over {slots} "
        f"slots in {steps} steps, {n_req * max_new / dt:.1f} tok/s "
        f"({dt * 1e3 / steps:.3f} ms/step) on {name}")


def kv_paging(paged: dict, blocks: list[tuple[int, int]], hbm_blocks: int) -> dict:
    """Spill the K pages ``blocks`` (layer, physical page) of the pool to the
    DDS page store and fetch the cold ones back through the offload path;
    each must come back bit-exact."""
    from repro_torch.serve.engine import PagedKVEngine
    from repro_torch.storage.pagestore import PAGE_HDR, PageStore

    pool = paged["k_pool"]
    page_bytes = pool[0, 0].numel() * pool.element_size()
    store = PageStore(page_size=page_bytes + PAGE_HDR.size,
                      num_pages=len(blocks))
    eng = PagedKVEngine(store, block_bytes=page_bytes, hbm_blocks=hbm_blocks)
    for l, p in blocks:
        data = pool[l, p].contiguous().view(torch.uint8).cpu().numpy().tobytes()
        eng.put_block(0, l, p, data)
    before = store.server.offload.stats.completed
    cold = blocks[:len(blocks) - hbm_blocks]
    for l, p in cold:
        got = eng.get_block(0, l, p)
        if got is None or len(got) < page_bytes:
            raise SystemExit(f"cold block {(l, p)} did not come back")
        back = torch.frombuffer(bytearray(got[:page_bytes]), dtype=pool.dtype)
        if not torch.equal(back.view_as(pool[l, p]).to(pool.device), pool[l, p]):
            raise SystemExit(f"cold block {(l, p)} came back changed")
    offloaded = store.server.offload.stats.completed - before
    if (eng.spills != len(blocks) - hbm_blocks or eng.fetches != len(cold)
            or offloaded != len(cold) or store.host_served):
        raise SystemExit(f"kv paging: spills {eng.spills} fetches {eng.fetches} "
                         f"offloaded {offloaded} host-served {store.host_served}")
    return {"page_bytes": page_bytes, "spills": eng.spills,
            "fetches": eng.fetches, "offloaded": offloaded}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke.py: no CUDA card (torch.cuda.is_available() "
                         "is False)\n")
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        sys.stderr.write(f"chip_smoke.py: no src/repro_torch beside {ROOT}\n")
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch.kernels.paged_attention.kernel import paged_attention_cuda
    from repro_torch.models.registry import build_model

    t_start = time.perf_counter()
    # 1. setup
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    card = smi.splitlines()[0]
    log(card)
    name = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} CUDA {torch.version.cuda} on {name} "
        f"x{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, "
        "torch.backends.cudnn.allow_tf32 = False")

    # 2. build
    t0 = time.perf_counter()
    report = _build.build(["flash_attention", "paged_attention"])
    log(f"build: {time.perf_counter() - t0:.1f} s wall into {_build.BUILD_DIR} "
        + ", ".join(f"{k} {v['seconds']:.1f} s" for k, v in report.items()))
    for k, v in report.items():
        for line in v["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {k}: {line.strip()}")

    # 3. kernels against plain versions
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    timer = Timer()
    flash = check_flash(gen, timer)
    paged_row = check_paged(gen, timer)
    del timer
    check_reduced_against_cpu(args.seed)

    # 4. main path at full width
    cfg = get_config("tinyllama_1p1b")
    api = build_model(cfg)
    params, _ = api.init(gen)
    torch.cuda.reset_peak_memory_stats()
    main = main_path(api, params, gen, flash_attention_cuda, paged_attention_cuda)
    log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")

    # 5. serving
    serve_batch(api, params, f"{name} ({card})")

    # 6. DDS KV paging of real pool pages
    pool_pages = main["paged"]["block_table"][0].tolist()   # sequence 0
    kv = kv_paging(main["paged"], [(l, p) for l in range(3) for p in pool_pages],
                   hbm_blocks=8)
    log(f"kv paging: {kv['spills']} K pages of {kv['page_bytes']} bytes spilled "
        f"to the page store, {kv['fetches']} fetched back bit-exact, "
        f"{kv['offloaded']} offloaded reads")
    log(f"total {time.perf_counter() - t_start:.1f} s")

    entries = []
    for kname, row, counter, line in (
            ("flash_attention", flash, "flash_attention",
             "src/repro/kernels/flash_attention/kernel.py:96"),
            ("paged_attention", paged_row, "paged_attention",
             "src/repro/kernels/paged_attention/kernel.py:84")):
        entries.append({
            "name": kname, "route": "cuda",
            "source": f"src/repro_torch/csrc/{kname}.cu", "replaces": line,
            "launches": main["counts"][counter], "max_abs_err": row["err"],
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"]})
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
